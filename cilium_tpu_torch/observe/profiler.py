# policyd: hot
"""Device-time profiler for the verdict path (policyd-prof).

The span tracer (tracer.py) attributes HOST wall time: under the
async dispatch discipline the ``dispatch`` phase measures enqueue cost
and ``host_sync`` absorbs everything the device did, so
``dispatch_rtt_ms`` is one opaque number. This module adds the device
side: every Nth dispatch (``profile_sample_every``) is sampled, and its
time splits into ``h2d`` / ``device_compute`` / ``d2h``, recorded
alongside the launch shapes (lanes, launches, pad lanes, flow shards).
On the card the split comes from CUDA events recorded on the stream
the batch runs on, before and after its copies in and after its last
launch and its copies out, read after the completion half's own wait:
a sampled batch adds no synchronization. On the CPU the same three
stretches are timed with ``time.perf_counter``. A second ledger
records the bytes each (site, launch shape) moves, once.

Cost model (the hub's ``active`` pattern): while ``DeviceProfiling``
is off the pipeline holds ``self.profiler = None`` and the hot path's
entire cost is that one attribute read — this module is never even
imported on the OFF path. While on, non-sampled batches pay one
attribute read plus one locked counter tick; only the 1-in-N sampled
batch builds a sample and its events.

Import-light like the rest of observe/: stdlib + metrics only.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .. import metrics as _metrics


def _nbytes(x) -> int:
    """Bytes of every tensor in ``x``: a tensor (anything with
    ``nbytes``), None, or a tuple, list or dataclass of those."""
    if x is None:
        return 0
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return sum(_nbytes(getattr(x, f.name)) for f in dataclasses.fields(x))
    n = getattr(x, "nbytes", None)
    return int(n) if isinstance(n, int) else 0


class _DispatchSample:
    """One sampled dispatch: the RTT decomposition accumulators plus
    occupancy notes. Built only on the 1-in-N sampled path — the
    disabled-overhead test monkeypatches this ctor to raise."""

    __slots__ = (
        "site", "batch", "ts", "h2d_s", "device_compute_s", "d2h_s",
        "notes",
    )

    def __init__(self, site: str, batch: int) -> None:
        self.site = site
        self.batch = int(batch)
        self.ts = time.time()
        self.h2d_s = 0.0
        self.device_compute_s = 0.0
        self.d2h_s = 0.0
        self.notes: Dict[str, object] = {}

    def add_h2d(self, seconds: float) -> None:
        self.h2d_s += seconds

    def add_compute(self, seconds: float) -> None:
        self.device_compute_s += seconds

    def add_d2h(self, seconds: float) -> None:
        self.d2h_s += seconds

    def mark(self, **notes) -> None:
        self.notes.update(notes)

    def to_dict(self) -> Dict:
        return {
            "site": self.site,
            "batch": self.batch,
            "ts": self.ts,
            "h2d_ms": self.h2d_s * 1e3,
            "device_compute_ms": self.device_compute_s * 1e3,
            "d2h_ms": self.d2h_s * 1e3,
            "notes": dict(self.notes),
        }


class DeviceProfiler:
    """Sampling profiler + launch-cost ledger. Disabled by default; the
    daemon toggles it through the ``DeviceProfiling`` runtime option
    (pipeline.set_profiling installs/clears the instance)."""

    def __init__(self, sample_every: int = 64, capacity: int = 256) -> None:
        # plain attribute, not a property: the ON-but-unsampled cost is
        # reading this once per batch (pipeline reads self.profiler)
        self.active = True
        self.sample_every = max(1, int(sample_every))
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._tick: Dict[str, int] = {}
        # (site, shape-key) → {"flops", "bytes_accessed"} — populated
        # once per launch shape, on a sampled batch
        self._jit_costs: Dict[str, Dict] = {}

    # -- hot-path API ---------------------------------------------------
    def begin_dispatch(self, site: str, batch: int) -> Optional[_DispatchSample]:
        """Tick the per-site sample counter; every ``sample_every``-th
        call returns a live sample, the rest return None. The caller
        gates every sandwich on that None."""
        with self._lock:
            t = self._tick.get(site, 0) + 1
            self._tick[site] = t
        if t % self.sample_every != 0:
            return None
        return _DispatchSample(site, batch)

    def complete(self, sample: _DispatchSample) -> None:
        """Retire a finished sample into the ring and the registry."""
        with self._lock:
            self._ring.append(sample)
        lbl_site = {"site": sample.site}
        _metrics.profile_samples_total.inc(lbl_site)
        _metrics.profile_phase_seconds.observe(
            sample.h2d_s, {"phase": "h2d"})
        _metrics.profile_phase_seconds.observe(
            sample.device_compute_s, {"phase": "device_compute"})
        _metrics.profile_phase_seconds.observe(
            sample.d2h_s, {"phase": "d2h"})

    # -- launch-cost ledger ----------------------------------------------
    def note_jit_cost(self, site: str, shape_key, tensors_in, tensors_out) -> None:
        """Record the cost of one (site, launch shape), once. There is
        no compiled program to ask, so ``bytes_accessed`` is the sum of
        ``nbytes`` of the tensors the dispatch's launches take and
        return (``tensors_in`` / ``tensors_out``: tensors, or tuples,
        lists and dataclasses of them; metadata only, no device sync),
        and ``flops`` stays None: the walks and lookups on this path do
        no arithmetic a flop count would describe. The entry is
        reserved before it is filled, as a racing sampler must not fill
        the same key twice."""
        key = f"{site}:{shape_key}"
        with self._lock:
            if key in self._jit_costs:
                return
            self._jit_costs[key] = {"flops": None, "bytes_accessed": None}
        entry = {"flops": None, "bytes_accessed": float(_nbytes(tensors_in) + _nbytes(tensors_out))}
        with self._lock:
            self._jit_costs[key] = entry

    # -- cold-path API --------------------------------------------------
    def samples(self, limit: Optional[int] = None) -> List[Dict]:
        with self._lock:
            items = list(self._ring)
        if limit is not None and limit >= 0:
            items = items[-limit:]
        return [s.to_dict() for s in items]

    def jit_costs(self) -> Dict[str, Dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._jit_costs.items()}

    def snapshot(self) -> Dict:
        """The /profile payload core: recent samples, per-site device
        time aggregates (the ``cilium-tpu top`` ranking), and the
        compile-time cost ledger."""
        samples = self.samples()
        sites: Dict[str, Dict] = {}
        for s in samples:
            agg = sites.setdefault(s["site"], {
                "samples": 0, "h2d_ms": 0.0, "device_compute_ms": 0.0,
                "d2h_ms": 0.0,
            })
            agg["samples"] += 1
            agg["h2d_ms"] += s["h2d_ms"]
            agg["device_compute_ms"] += s["device_compute_ms"]
            agg["d2h_ms"] += s["d2h_ms"]
        return {
            "enabled": self.active,
            "sample_every": self.sample_every,
            "capacity": self.capacity,
            "sites": sites,
            "samples": samples,
            "jit_costs": self.jit_costs(),
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._tick.clear()
