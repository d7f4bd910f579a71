"""policyd-fleetobs: SLO burn rates + the fleet telemetry exchange.

Three layers, bottom-up:

- :class:`SLOEvaluator` — multi-window burn rates over declared
  objectives (verdict latency p99, drop-mix ratio, epoch lag, restart
  downtime), read from a :class:`~.timeseries.TimeSeriesRing`. Burn
  ratio is observed/target per window; the state machine is the
  classic multi-window alert: *burning* only when both the shortest
  AND the longest window exceed budget (a sustained burn that is still
  happening), *warn* when any single window does, *ok* otherwise.
  Ratios surface as the ``cilium_tpu_slo_burn_ratio{objective,window}``
  gauge family.

- :class:`FleetSampler` — the cadence thread the ``FleetTelemetry``
  runtime option starts: every ``interval_s`` it snapshots the
  process-wide metric families into the ring (counter totals through
  reset-safe :class:`~.timeseries.CounterDelta`), re-evaluates the
  SLOs, and (when a :class:`TelemetryExchange` is attached) publishes
  one frame. This module is ONLY imported when the option turns on —
  the daemon's OFF path never touches it (the tripwire test pins
  that).

- :class:`TelemetryExchange` + :func:`aggregate` — each daemon
  publishes a compact versioned frame (counter-derived rates +
  quantiles + SLO states + policy_epoch + pipeline_mode, stamped with
  node id and a monotonic frame seq) through a federation
  :class:`~..kvstore.store.SharedStore` under
  ``CLUSTER_TELEMETRY_PATH`` — beside its epoch-exchange node
  descriptor. ``aggregate`` folds every live (non-stale,
  version-compatible) frame into one scoreboard: fleet vps, per-node
  health grid, epoch skew, worst burn. A killed node's frames age out
  by wall-clock ``ts`` long before its kvstore lease dies, so the
  scoreboard heals in seconds, not lease-TTLs.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from .. import metrics as _metrics
from ..kvstore.paths import CLUSTER_TELEMETRY_PATH
from ..kvstore.store import SharedStore
from .timeseries import WINDOWS, CounterDelta, TimeSeriesRing

log = logging.getLogger(__name__)

_KV_DOWN = (ConnectionError, TimeoutError, OSError, RuntimeError)

# -- SLO evaluation ---------------------------------------------------------

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_BURNING = "burning"
_STATE_RANK = {STATE_OK: 0, STATE_WARN: 1, STATE_BURNING: 2}


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declared objective: ``field`` of the sampler ring, reduced
    per window with ``reduce``, burning budget at ``target`` (same
    unit as the field). Burn ratio = reduced value / target."""

    name: str
    field: str
    target: float
    reduce: str = "mean"


# The declared objective set (ISSUE: verdict latency p99, drop-mix
# ratio, epoch lag, restart downtime). Targets are deliberately
# generous defaults — operators tune per deployment via the
# FleetSampler ctor; the STATES are the contract, not the numbers.
DEFAULT_OBJECTIVES: Tuple[SLObjective, ...] = (
    SLObjective("verdict_latency_p99", "verdict_p99_ms", 50.0, "max"),
    SLObjective("drop_mix_ratio", "drop_ratio", 0.5, "mean"),
    SLObjective("epoch_lag", "epoch_lag", 2.0, "max"),
    SLObjective("restart_downtime", "restart_downtime_s", 5.0, "max"),
)


class SLOEvaluator:
    """Multi-window burn-rate evaluation over one sampler ring."""

    def __init__(
        self,
        ring: TimeSeriesRing,
        objectives: Tuple[SLObjective, ...] = DEFAULT_OBJECTIVES,
        windows: Tuple[Tuple[str, float], ...] = WINDOWS,
    ) -> None:
        for obj in objectives:
            if obj.target <= 0:
                raise ValueError(f"objective {obj.name!r}: target must be > 0")
        self.ring = ring
        self.objectives = tuple(objectives)
        self.windows = tuple(windows)

    def evaluate(self, now: Optional[float] = None) -> Dict:
        """Evaluate every objective over every window; refresh the
        ``slo_burn_ratio`` gauge family; return the full result:
        ``{"objectives": {...}, "worst": {...}, "burning": bool}``."""
        short, long_ = self.windows[0][0], self.windows[-1][0]
        per: Dict[str, Dict] = {}
        for obj in self.objectives:
            ratios: Dict[str, float] = {}
            for label, secs in self.windows:
                v = self.ring.reduce(obj.field, obj.reduce, secs, now)
                r = 0.0 if v is None else max(0.0, float(v) / obj.target)
                ratios[label] = round(r, 6)
                _metrics.slo_burn_ratio.set(
                    ratios[label], {"objective": obj.name, "window": label}
                )
            if ratios[short] >= 1.0 and ratios[long_] >= 1.0:
                state = STATE_BURNING
            elif any(r >= 1.0 for r in ratios.values()):
                state = STATE_WARN
            else:
                state = STATE_OK
            per[obj.name] = {
                "state": state,
                "windows": ratios,
                "worst_ratio": max(ratios.values()),
            }
        worst_name = max(
            per,
            key=lambda n: (_STATE_RANK[per[n]["state"]], per[n]["worst_ratio"]),
        )
        worst = {
            "objective": worst_name,
            "state": per[worst_name]["state"],
            "ratio": per[worst_name]["worst_ratio"],
        }
        return {
            "objectives": per,
            "worst": worst,
            "burning": worst["state"] == STATE_BURNING,
        }


# -- telemetry frame codec --------------------------------------------------

FRAME_VERSION = 1


def encode_frame(
    node: str,
    seq: int,
    body: Mapping,
    *,
    cluster: str = "default",
    ts: Optional[float] = None,
) -> Dict:
    """One wire frame: version + identity stamp + the sampler body."""
    frame: Dict = dict(body)
    frame.update(
        {
            "v": FRAME_VERSION,
            "node": node,
            "cluster": cluster,
            "seq": int(seq),
            # wall clock on purpose: staleness must compare across
            # processes, which monotonic clocks never do
            "ts": time.time() if ts is None else float(ts),
        }
    )
    return frame


def decode_frame(rec) -> Optional[Dict]:
    """Validate one stored record back into a frame; None for version
    mismatches and malformed stamps (the aggregator counts these as
    ``telemetry_frames_total{result="rejected"}``)."""
    if not isinstance(rec, dict) or rec.get("v") != FRAME_VERSION:
        return None
    node = rec.get("node")
    if not isinstance(node, str) or not node:
        return None
    try:
        int(rec["seq"])
        float(rec["ts"])
    except (KeyError, TypeError, ValueError):
        return None
    return dict(rec)


# -- the exchange -----------------------------------------------------------


class TelemetryExchange:
    """One node's frame publication + its view of every peer's frames,
    over a SharedStore under ``CLUSTER_TELEMETRY_PATH`` (the sibling
    of the epoch exchange's node-descriptor records)."""

    def __init__(
        self,
        backend,
        node_name: str,
        *,
        cluster: str = "default",
        base_path: str = CLUSTER_TELEMETRY_PATH,
        stale_s: float = 15.0,
    ) -> None:
        self.node_name = node_name
        self.cluster = cluster
        self.stale_s = float(stale_s)
        self.key_name = f"{cluster}/{node_name}"
        self._seq = 0
        self.store = SharedStore(backend, base_path)

    def publish(self, body: Mapping, *, ts: Optional[float] = None) -> bool:
        """Publish one frame (lease-bound; dies with the node). False
        when the kvstore is down — the sampler keeps ticking locally
        and the next successful publish carries a later seq."""
        self._seq += 1
        frame = encode_frame(
            self.node_name, self._seq, body, cluster=self.cluster, ts=ts
        )
        try:
            self.store.update_local_key_sync(self.key_name, frame)
        except _KV_DOWN:
            _metrics.telemetry_frames_total.inc({"result": "publish_error"})
            return False
        _metrics.telemetry_frames_total.inc({"result": "published"})
        return True

    def pump(self) -> int:
        """Apply pending peer frame events; returns events applied."""
        return self.store.pump()

    def frames(
        self, *, now: Optional[float] = None, stale_s: Optional[float] = None
    ) -> Dict[str, Dict]:
        """node → live decoded frame. Rejects version mismatches and
        ages out frames older than ``stale_s`` — a kill -9'd node
        disappears here within seconds, while its lease-bound record
        lingers until the kvstore lease expires."""
        ref = time.time() if now is None else float(now)
        horizon = self.stale_s if stale_s is None else float(stale_s)
        out: Dict[str, Dict] = {}
        for rec in dict(self.store.shared).values():
            f = decode_frame(rec)
            if f is None:
                _metrics.telemetry_frames_total.inc({"result": "rejected"})
                continue
            if f.get("cluster") != self.cluster:
                continue
            if ref - f["ts"] > horizon:
                _metrics.telemetry_frames_total.inc({"result": "stale"})
                continue
            out[f["node"]] = f
        return out

    def sync(self) -> int:
        """Anti-entropy re-write of our frame (heartbeat path)."""
        return self.store.sync_local_keys()

    def close(self) -> None:
        try:
            self.store.delete_local_key(self.key_name)
        except _KV_DOWN:
            pass  # backend gone; the lease reaps our record
        self.store.close()


# -- fleet aggregation ------------------------------------------------------


def aggregate(frames: Mapping[str, Dict], *, now: Optional[float] = None) -> Dict:
    """Fold live frames into the fleet scoreboard (the GET /fleet body
    and the bench --fleetobs substrate). Refreshes the
    ``fleet_nodes_reporting`` gauge as a side effect."""
    ref = time.time() if now is None else float(now)
    rows: List[Dict] = []
    worst = {"objective": None, "state": STATE_OK, "ratio": 0.0, "node": None}
    fleet_vps = 0.0
    epochs: List[int] = []
    lag_max = 0.0
    for name in sorted(frames):
        f = frames[name]
        slo = f.get("slo") or {}
        w = slo.get("worst") or {}
        state = w.get("state", STATE_OK)
        ratio = float(w.get("ratio", 0.0))
        if (_STATE_RANK.get(state, 0), ratio) > (
            _STATE_RANK.get(worst["state"], 0),
            worst["ratio"],
        ):
            worst = {
                "objective": w.get("objective"),
                "state": state,
                "ratio": ratio,
                "node": name,
            }
        vps = float(f.get("vps", 0.0))
        fleet_vps += vps
        if "policy_epoch" in f:
            epochs.append(int(f["policy_epoch"]))
        lag_max = max(lag_max, float(f.get("epoch_lag", 0.0)))
        rows.append(
            {
                "node": name,
                "seq": int(f["seq"]),
                "age_s": round(max(0.0, ref - f["ts"]), 3),
                "vps": round(vps, 3),
                "drop_ratio": float(f.get("drop_ratio", 0.0)),
                "verdict_p99_ms": f.get("verdict_p99_ms"),
                "pipeline_mode": f.get("pipeline_mode"),
                "policy_epoch": f.get("policy_epoch"),
                "epoch_lag": f.get("epoch_lag"),
                "slo_state": state,
                "worst_objective": w.get("objective"),
            }
        )
    _metrics.fleet_nodes_reporting.set(float(len(rows)))
    return {
        "nodes_reporting": len(rows),
        "fleet_vps": round(fleet_vps, 3),
        "epoch_skew": (max(epochs) - min(epochs)) if epochs else 0,
        "epoch_lag_max": lag_max,
        "worst_burn": worst,
        "nodes": rows,
    }


# -- the sampler ------------------------------------------------------------

# The ring's field vocabulary: one column per sampled signal. Derived
# rates are computed at sample time (counter deltas / tick dt) so the
# ring holds directly-reducible values.
SAMPLE_FIELDS: Tuple[str, ...] = (
    "vps",
    "drop_ratio",
    "shed_ratio",
    "verdict_p50_ms",
    "verdict_p99_ms",
    "pipeline_mode",
    "epoch_lag",
    "transfer_bps",
    "restart_downtime_s",
)


def _series_sum(counter, pred: Optional[Callable[[Dict], bool]] = None) -> float:
    total = 0.0
    for key, v in counter.series().items():
        if pred is None or pred(dict(key)):
            total += v
    return total


class FleetSampler:
    """The ``FleetTelemetry`` cadence thread: snapshot → ring → SLO →
    (optionally) publish one frame. ``sample_once`` is the whole tick
    and is directly callable for deterministic tests."""

    def __init__(
        self,
        *,
        interval_s: float = 1.0,
        capacity: int = 600,
        objectives: Tuple[SLObjective, ...] = DEFAULT_OBJECTIVES,
        epoch_source: Optional[Callable[[], int]] = None,
    ) -> None:
        self.interval_s = float(interval_s)
        self.ring = TimeSeriesRing(SAMPLE_FIELDS, capacity)
        self.slo = SLOEvaluator(self.ring, objectives)
        self._epoch_source = epoch_source or (lambda: 0)
        self.exchange: Optional[TelemetryExchange] = None
        self._d_verdicts = CounterDelta()
        self._d_dropped = CounterDelta()
        self._d_shed = CounterDelta()
        self._d_xfer = CounterDelta()
        self._last_ts: Optional[float] = None
        self.last_slo: Optional[Dict] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # -- wiring ---------------------------------------------------------
    def attach_exchange(self, exchange: Optional[TelemetryExchange]) -> None:
        self.exchange = exchange

    # -- one tick -------------------------------------------------------
    def sample_once(self, now: Optional[float] = None) -> Dict:
        """Snapshot the metric families into the ring, re-evaluate the
        SLOs, publish a frame when an exchange is attached. Returns the
        appended sample (tests assert on it)."""
        with self._lock:
            ts = time.monotonic() if now is None else float(now)
            dt = (
                self.interval_s
                if self._last_ts is None
                else max(ts - self._last_ts, 1e-9)
            )
            self._last_ts = ts

            dv = self._d_verdicts.update(_series_sum(_metrics.verdicts_total))
            dd = self._d_dropped.update(
                _series_sum(
                    _metrics.verdicts_total,
                    lambda k: k.get("outcome", "").startswith("dropped"),
                )
            )
            ds = self._d_shed.update(_series_sum(_metrics.admission_shed_total))
            dx = self._d_xfer.update(
                _series_sum(_metrics.device_transfer_bytes_total)
            )
            p50 = _metrics.batch_total_seconds.quantile(0.5)
            p99 = _metrics.batch_total_seconds.quantile(0.99)
            sample = {
                "vps": dv / dt,
                "drop_ratio": (dd / dv) if dv > 0 else 0.0,
                "shed_ratio": (ds / (dv + ds)) if (dv + ds) > 0 else 0.0,
                "verdict_p50_ms": None if p50 is None else p50 * 1e3,
                "verdict_p99_ms": None if p99 is None else p99 * 1e3,
                "pipeline_mode": _metrics.pipeline_mode.get(),
                "epoch_lag": _metrics.cluster_epoch_lag.get(),
                "transfer_bps": dx / dt,
                "restart_downtime_s": _metrics.restart_downtime_seconds.get(),
            }
            self.ring.append(ts, sample)
            _metrics.timeseries_snapshots_total.inc()
            self.last_slo = self.slo.evaluate(now=ts)

            if self.exchange is not None:
                self.exchange.publish(self.frame_body())
                try:
                    self.exchange.pump()
                except _KV_DOWN:
                    pass  # partition: keep sampling; frames age out
            return sample

    def frame_body(self) -> Dict:
        """The compact per-node payload ``aggregate`` consumes."""
        r = self.ring

        def nz(v: Optional[float]) -> float:
            return 0.0 if v is None else round(float(v), 6)

        slo = self.last_slo or {}
        return {
            "vps": nz(r.reduce("vps", "mean", WINDOWS[0][1])),
            "drop_ratio": nz(r.reduce("drop_ratio", "mean", WINDOWS[0][1])),
            "shed_ratio": nz(r.reduce("shed_ratio", "mean", WINDOWS[0][1])),
            "verdict_p50_ms": r.last("verdict_p50_ms"),
            "verdict_p99_ms": r.last("verdict_p99_ms"),
            "pipeline_mode": nz(r.last("pipeline_mode")),
            "epoch_lag": nz(r.last("epoch_lag")),
            "policy_epoch": int(self._epoch_source()),
            "slo": {
                "worst": slo.get("worst"),
                "states": {
                    name: o["state"]
                    for name, o in (slo.get("objectives") or {}).items()
                },
            },
        }

    # -- surfaces -------------------------------------------------------
    def slo_summary(self) -> Dict:
        """The one-line /status block: worst objective + state."""
        slo = self.last_slo or self.slo.evaluate()
        w = slo["worst"]
        return {
            "worst_objective": w["objective"],
            "state": w["state"],
            "ratio": w["ratio"],
            "burning": slo["burning"],
        }

    def local_status(self) -> Dict:
        return {
            "interval_s": self.interval_s,
            "samples": self.ring.appended,
            "capacity": self.ring.capacity,
            "slo": self.slo_summary(),
        }

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-sampler", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                # a telemetry tick must never take the process down;
                # the next tick retries with fresh state
                log.exception("fleet sampler tick failed")

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)
        if self.exchange is not None:
            try:
                self.exchange.close()
            except _KV_DOWN:
                pass
            self.exchange = None
