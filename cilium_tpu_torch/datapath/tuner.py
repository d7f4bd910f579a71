# policyd: hot
"""Depth auto-tuner for the bounded in-flight dispatch queue
(policyd-autotune).

``verdict_pipeline_depth`` trades throughput for verdict latency: depth
1 is fully synchronous, deeper queues hide device execution behind host
prep of successor batches — but past the point where the device is
saturated, every extra slot only ages batches in flight (the completion
half IS the p99 verdict-latency proxy). The knob was static even
though the pipeline already measures both halves of every batch; this
controller closes the loop.

Control law — a small hill climber over EWMA-smoothed epoch stats:

- Batches are folded into fixed-size epochs (enqueue-half ns,
  completion-half ns, queue occupancy at admission, flows served).
- At each epoch boundary the current depth's throughput proxy
  (flows / busy-second) and completion-half latency are EWMA-updated.
- The controller PROBES one step up only while the queue is saturated
  (mean occupancy ≈ depth — the submitter is blocking on admission, so
  a deeper queue could actually be used), then judges the probe against
  the anchor depth one epoch later: the step is kept only if throughput
  improved by ``improve`` without the completion-half latency degrading
  past ``degrade``; otherwise it backs off and a cooldown stops it from
  re-probing the same losing step every other epoch.
- Independent of probing, a depth whose completion latency sits
  ``degrade`` above the next-lower depth's record steps back down.

The tuner never touches the pipeline itself: ``observe()`` returns the
new target depth (or None) and the pipeline applies it, so the OFF path
stays exactly one attribute read (``pipeline._tuner is None``).

Bounds are a stable contract (ROADMAP): depth moves in
[min_depth, max_depth] only, max_depth defaulting to
``DaemonConfig.verdict_pipeline_max_depth`` (4).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

# epochs a failed up-probe locks its target depth out of re-probing —
# without this the controller oscillates d ↔ d+1 forever on a saturated
# queue where deeper never helps (the common host-bound case)
PROBE_COOLDOWN_EPOCHS = 8


class DepthTuner:
    """EWMA hill-climbing controller for ``verdict_pipeline_depth``."""

    def __init__(
        self,
        min_depth: int = 1,
        max_depth: int = 4,
        *,
        epoch: int = 16,
        alpha: float = 0.3,
        improve: float = 0.03,
        degrade: float = 0.25,
    ) -> None:
        self.min_depth = max(1, int(min_depth))
        self.max_depth = max(self.min_depth, int(max_depth))
        self.epoch = max(2, int(epoch))
        self.alpha = float(alpha)
        self.improve = float(improve)
        self.degrade = float(degrade)
        self._lock = threading.Lock()
        # depth → [vps_ewma, complete_lat_ns_ewma, epochs_seen]
        self._stats: Dict[int, List[float]] = {}
        self._probing = False
        self._anchor: Optional[int] = None
        self._cooldown: Dict[int, int] = {}  # depth → epochs locked out
        self.ups = 0
        self.downs = 0
        self._epochs = 0
        self._n = 0
        self._flows = 0
        self._enq_ns = 0
        self._comp_ns = 0
        self._occ = 0.0

    # -- hot-path API ----------------------------------------------------
    def observe(
        self,
        depth: int,
        flows: int,
        enqueue_ns: int,
        complete_ns: int,
        occupancy: int,
    ) -> Optional[int]:
        """Fold one completed batch into the current epoch. Returns the
        new target depth when the epoch closed with a decision, else
        None. Called from the completion half only — never on the
        enqueue hot path."""
        with self._lock:
            self._n += 1
            self._flows += int(flows)
            self._enq_ns += int(enqueue_ns)
            self._comp_ns += int(complete_ns)
            self._occ += float(occupancy)
            if self._n < self.epoch:
                return None
            return self._close_epoch(int(depth))

    # -- epoch boundary (held lock) --------------------------------------
    def _close_epoch(self, depth: int) -> Optional[int]:
        busy_s = (self._enq_ns + self._comp_ns) / 1e9
        vps = self._flows / busy_s if busy_s > 0 else 0.0
        lat = self._comp_ns / self._n
        occ = self._occ / self._n
        self._n = 0
        self._flows = 0
        self._enq_ns = 0
        self._comp_ns = 0
        self._occ = 0.0
        self._epochs += 1
        for d in list(self._cooldown):
            self._cooldown[d] -= 1
            if self._cooldown[d] <= 0:
                del self._cooldown[d]

        st = self._stats.get(depth)
        if st is None:
            st = self._stats[depth] = [vps, lat, 1.0]
        else:
            a = self.alpha
            st[0] += a * (vps - st[0])
            st[1] += a * (lat - st[1])
            st[2] += 1.0

        target = depth
        if self._probing:
            anchor = self._anchor
            self._probing = False
            base = None if anchor is None else self._stats.get(anchor)
            if (
                anchor is not None
                and anchor != depth
                and base is not None
                and (
                    st[0] < base[0] * (1.0 + self.improve)
                    or st[1] > base[1] * (1.0 + self.degrade)
                )
            ):
                # probe failed: no real throughput win, or it aged the
                # completion half — back off and stop re-trying for a while
                target = anchor
                self._cooldown[depth] = PROBE_COOLDOWN_EPOCHS
            # probe kept: the new depth is simply the depth we are at
        elif (
            depth < self.max_depth
            and occ >= depth - 0.5
            and self._cooldown.get(depth + 1, 0) <= 0
        ):
            # queue saturated — the submitter blocks on admission, so a
            # deeper queue is actually usable; probe one step up
            self._probing = True
            self._anchor = depth
            target = depth + 1
        elif depth > self.min_depth:
            lower = self._stats.get(depth - 1)
            if (
                lower is not None
                and st[1] > lower[1] * (1.0 + self.degrade)
                and st[0] < lower[0] * (1.0 + self.improve)
            ):
                # the depth we sit at costs latency and buys nothing the
                # next-lower depth didn't deliver
                target = depth - 1
        if target == depth:
            return None
        if target > depth:
            self.ups += 1
        else:
            self.downs += 1
        return target

    # -- cold-path API ---------------------------------------------------
    def snapshot(self) -> Dict:
        """State for GET /traces and the ``cilium-tpu traces`` header."""
        with self._lock:
            return {
                "min_depth": self.min_depth,
                "max_depth": self.max_depth,
                "epoch": self.epoch,
                "epochs_seen": self._epochs,
                "probing": self._probing,
                "adjustments": {"up": self.ups, "down": self.downs},
                "stats": {
                    str(d): {
                        "vps": round(s[0], 1),
                        "complete_lat_us": round(s[1] / 1e3, 1),
                        "epochs": int(s[2]),
                    }
                    for d, s in sorted(self._stats.items())
                },
            }
