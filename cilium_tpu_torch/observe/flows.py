# policyd: hot
"""Flow log ring for verdict attribution (policyd-flows).

Structured per-flow records — who talked to whom, what the verdict
was, WHICH rule decided it and why — sampled from the datapath
pipeline's completion half while the ``FlowAttribution`` runtime
option is on, held in a bounded ring, and served by ``GET /flows`` /
``cilium-tpu flows``. The reference analog is Hubble's flow buffer
over the perf ring (the observe/ side of cilium/hubble), reduced to
the policy-verdict fields this engine actually attributes.

Cost model mirrors observe/tracer.py: the pipeline reads ONE
attribute per batch — ``ring.active`` — and skips everything when
attribution is off. Records are only constructed for the sampled
subset (at most ``SAMPLE_CAP`` per batch, drops preferred), so the
per-batch host cost is O(sample), never O(B).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# Per-batch sampling bound: the completion half records at most this
# many flows per completed batch (drops first — they are the rare,
# interesting ones), so a 4M-flow batch costs the same host time as a
# 64-flow batch.
SAMPLE_CAP = 64


@dataclasses.dataclass
class FlowRecord:
    """One attributed flow. ``verdict`` uses the pipeline outcome codes
    (datapath/pipeline.py FORWARD/DROP_*); ``reason``/``reason_name``
    the stable policyd-flows taxonomy (ops/verdict.py ATTR_* mapped to
    monitor reason codes); ``rule_index``/``rule_origin`` the deciding
    repository rule (-1 / None when no rule matched)."""

    ts: float
    direction: str  # "ingress" | "egress"
    src_identity: int
    dst_identity: int
    src_labels: Tuple[str, ...]
    dst_labels: Tuple[str, ...]
    src_ip: str  # peer address for ingress flows ("" when unknown)
    dst_ip: str  # peer address for egress flows ("" when unknown)
    dport: int
    proto: int
    verdict: int
    verdict_name: str
    reason: int
    reason_name: str
    rule_index: int
    rule_origin: Optional[dict]

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["src_labels"] = list(self.src_labels)
        d["dst_labels"] = list(self.dst_labels)
        return d


class FlowRing:
    """Bounded ring of FlowRecords. ``active`` is a plain attribute
    (the hub/tracer pattern): the pipeline's attribution-off cost is
    one attribute read per batch."""

    def __init__(self, capacity: int = 1024) -> None:
        self.active = False
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.recorded = 0  # total records pushed (sampling visibility)

    def enable(self) -> None:
        self.active = True

    def disable(self) -> None:
        self.active = False

    def push(self, rec: FlowRecord) -> None:
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    def push_many(self, recs: List[FlowRecord]) -> None:
        with self._lock:
            self._ring.extend(recs)
            self.recorded += len(recs)

    def query(
        self,
        limit: int = 64,
        *,
        verdict: Optional[int] = None,
        from_identity: Optional[int] = None,
        reason: Optional[int] = None,
    ) -> List[Dict]:
        """Newest-last records matching every given filter, bounded by
        ``limit`` (filters apply BEFORE the limit, so asking for the
        last 10 drops scans the whole ring, not the last 10 records).
        ``verdict`` is an exact pipeline outcome code, or any negative
        value for "every drop outcome" (the `flows --verdict drop`
        filter; matched via verdict_name so this module stays free of
        pipeline imports)."""
        with self._lock:
            items = list(self._ring)
        if verdict is not None:
            if verdict < 0:
                items = [r for r in items
                         if r.verdict_name.startswith("dropped")]
            else:
                items = [r for r in items if r.verdict == verdict]
        if from_identity is not None:
            items = [r for r in items if r.src_identity == from_identity]
        if reason is not None:
            items = [r for r in items if r.reason == reason]
        if limit is not None and limit >= 0:
            items = items[-limit:]
        return [r.to_dict() for r in items]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def now() -> float:
    return time.time()
