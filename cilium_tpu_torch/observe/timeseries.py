"""policyd-fleetobs: bounded time-series rings over the metrics layer.

A :class:`TimeSeriesRing` holds the last ``capacity`` snapshots of a
fixed field vocabulary in fixed-size numpy arrays — one row per
sampler tick, NaN for fields a tick could not produce (e.g. a phase
p99 before the first observed batch). The fleet sampler
(observe/fleet.py) appends one row per cadence tick; readers reduce a
field over a trailing window (``rate``/``mean``/``max`` over the
standard 10s/1m/5m windows) without ever copying more than the window.

Memory is bounded by construction: ``capacity × len(fields)`` float64
cells, allocated once at enable time and reused forever — wraparound
overwrites the oldest row. Nothing here imports torch; numpy only.

:class:`CounterDelta` is the reset-safe companion for turning
cumulative counter totals into per-tick deltas: a total that DECREASES
means the counter restarted from zero (process restart, registry
swap), so the new total IS the delta — the standard Prometheus
``rate()`` reset rule, which never produces negative rates.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# The standard reduction windows (label, seconds) every SLO objective
# and fleet surface quotes: short enough to catch a fast burn, long
# enough to smooth a single slow batch.
WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("10s", 10.0),
    ("1m", 60.0),
    ("5m", 300.0),
)

_REDUCERS = ("mean", "max", "rate", "last")


class CounterDelta:
    """Reset-safe delta over a monotonically-increasing total."""

    __slots__ = ("_prev",)

    def __init__(self) -> None:
        self._prev: Optional[float] = None

    def update(self, total: float) -> float:
        """Delta since the previous ``update``. First call returns 0
        (no interval yet); a decrease is a counter reset and the new
        total counts whole (it accumulated from zero)."""
        prev, self._prev = self._prev, float(total)
        if prev is None:
            return 0.0
        d = float(total) - prev
        return float(total) if d < 0 else d


class TimeSeriesRing:
    """Fixed-capacity ring of (timestamp, field-vector) samples."""

    def __init__(self, fields: Sequence[str], capacity: int = 512) -> None:
        if not fields:
            raise ValueError("TimeSeriesRing needs at least one field")
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (rate needs a pair)")
        self.fields: Tuple[str, ...] = tuple(fields)
        self.capacity = int(capacity)
        self._col = {f: i for i, f in enumerate(self.fields)}
        self._ts = np.full(self.capacity, np.nan)
        self._data = np.full((self.capacity, len(self.fields)), np.nan)
        self._n = 0  # total rows ever appended (wraps via modulo)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def appended(self) -> int:
        """Total rows ever appended (wraparound visibility)."""
        return self._n

    def append(self, ts: float, sample: Mapping[str, float]) -> None:
        """Write one snapshot row. Unknown fields are ignored; missing
        fields stay NaN for this row. ``ts`` must be monotonic in the
        caller's clock (the sampler uses time.monotonic())."""
        row = np.full(len(self.fields), np.nan)
        for name, value in sample.items():
            i = self._col.get(name)
            if i is not None and value is not None:
                row[i] = float(value)
        with self._lock:
            at = self._n % self.capacity
            self._ts[at] = float(ts)
            self._data[at] = row
            self._n += 1

    # -- readers --------------------------------------------------------
    def _ordered(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ts, data) oldest-first copies of the live rows."""
        with self._lock:
            n = min(self._n, self.capacity)
            if n == 0:
                return np.empty(0), np.empty((0, len(self.fields)))
            if self._n <= self.capacity:
                return self._ts[:n].copy(), self._data[:n].copy()
            at = self._n % self.capacity  # oldest row position
            order = np.r_[at:self.capacity, 0:at]
            return self._ts[order].copy(), self._data[order].copy()

    def last(self, field: str) -> Optional[float]:
        """Most recent non-NaN value of ``field`` (None when none)."""
        ts, vals = self.window(field, window_s=None)
        if vals.size == 0:
            return None
        return float(vals[-1])

    def window(
        self,
        field: str,
        window_s: Optional[float],
        now: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ts, values) of the non-NaN samples of ``field`` within the
        trailing ``window_s`` (None: the whole ring), oldest-first.
        ``now`` defaults to the newest sample's timestamp, so replayed
        rings reduce identically to live ones."""
        ts, data = self._ordered()
        if ts.size == 0:
            return ts, np.empty(0)
        vals = data[:, self._col[field]]
        keep = ~np.isnan(vals)
        if window_s is not None:
            ref = float(ts[-1]) if now is None else float(now)
            # both bounds: an explicit ``now`` in the past must not see
            # samples from its future, or replayed reductions diverge
            keep &= (ts >= ref - float(window_s)) & (ts <= ref)
        return ts[keep], vals[keep]

    def reduce(
        self,
        field: str,
        op: str,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """One scalar over the trailing window. ``op``:

        - ``mean`` / ``max``: over the sample values;
        - ``rate``: (last - first) / (t_last - t_first) — for fields
          that carry cumulative values; needs >= 2 samples spanning
          nonzero time;
        - ``last``: newest value in the window.

        None when the window holds no (or, for rate, fewer than 2)
        samples.
        """
        if op not in _REDUCERS:
            raise ValueError(f"unknown reduction {op!r}")
        ts, vals = self.window(field, window_s, now)
        if vals.size == 0:
            return None
        if op == "mean":
            return float(vals.mean())
        if op == "max":
            return float(vals.max())
        if op == "last":
            return float(vals[-1])
        if vals.size < 2:
            return None
        span = float(ts[-1] - ts[0])
        if span <= 0.0:
            return None
        return float(vals[-1] - vals[0]) / span

    def history(self, limit: Optional[int] = None) -> List[Dict]:
        """Newest-last rows as dicts (NaN fields omitted) — the
        ``fleet history`` CLI payload. Bounded by ``limit``."""
        ts, data = self._ordered()
        if limit is not None and limit >= 0:
            ts, data = ts[-limit:], data[-limit:]
        out: List[Dict] = []
        for i in range(ts.size):
            row: Dict = {"ts": float(ts[i])}
            for j, f in enumerate(self.fields):
                v = data[i, j]
                if not np.isnan(v):
                    row[f] = float(v)
            out.append(row)
        return out
