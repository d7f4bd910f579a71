"""Per-flow verdict fast path — the enforcement front-end's hot loop.

The reference enforces per-packet verdicts with ≤3 hash lookups against
the per-endpoint BPF policymap the control plane wrote
(bpf/lib/policy.h:46-110: exact {id,dport,proto} → L3-only {id} →
L4-only). Here the TPU-materialized policymap snapshots
(ops/materialize.py) play the role of the pinned BPF map, and this
cache answers single-flow queries with the same probe order — two dict
probes, no device round trip. Batch/cold traffic takes the device
pipeline (datapath/pipeline.py) instead; this path is what keeps p99
per-flow latency inside the BASELINE.md budget (<50µs) the way
established-flow conntrack hits keep the reference's datapath cheap.

Snapshot dicts are shared by reference with the pipeline's materialized
state, so incremental row patches (identity churn) are visible here
without rebuilding the cache.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..ops.materialize import EndpointPolicySnapshot, PolicyKey, TRAFFIC_INGRESS

ALLOW = 1
DENY = 2


class VerdictFastpath:
    """Wraps realized per-endpoint policymaps for O(1) per-flow checks."""

    def __init__(
        self,
        snapshots: Sequence[EndpointPolicySnapshot],
        direction: int = TRAFFIC_INGRESS,
    ) -> None:
        self._entries: List[dict] = [s.entries for s in snapshots]
        self._direction = direction

    def lookup(
        self, ep_idx: int, identity: int, dport: int, proto: int
    ) -> Tuple[int, bool]:
        """→ (decision, redirect). Probe order mirrors
        __policy_can_access (bpf/lib/policy.h:46): exact key first so a
        redirecting L4 filter wins over a plain L3 allow."""
        entries = self._entries[ep_idx]
        e = entries.get(PolicyKey(identity, dport, proto, self._direction))
        if e is not None:
            return ALLOW, bool(e)
        if PolicyKey(identity, 0, 0, self._direction) in entries:
            return ALLOW, False
        return DENY, False
