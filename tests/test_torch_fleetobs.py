"""Port parity: the fleet plane (``observe/timeseries.py`` and
``observe/fleet.py``).

Both modules are host code copied from the JAX package. The reference's
``test_fleetobs.py`` runs here against both packages (the ``fo``
fixture): every test that builds no ``Daemon`` — ``TestCounterDelta``,
``TestTimeSeriesRing``, ``TestHistogramQuantile``, ``TestSLOEvaluator``,
``TestFrameCodec``, ``TestTelemetryExchange``, ``TestAggregate`` and
``TestFleetSampler``. Its ``TestFleetTelemetryOption`` builds a
``Daemon`` and comes with the port's daemon.

Sampler parity: the same batches go through both packages' pipelines
with the tracer (PhaseTracing) on, and each package's ``FleetSampler``
reads its own process-wide registry at the same ``now`` sequence. Other
tests in the same worker have moved both registries, so each sampler is
primed first and only the deltas of the counters are compared; the
gauges the sampler reads are set to the same values in both packages
first. Latency is wall clock: both latency fields must be present, not
equal.
"""

from __future__ import annotations

import importlib
import threading
import time
import types

import numpy as np
import pytest

from test_torch_harness import PKGS
from test_torch_submit import Pair


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _ns(pkg: str):
    """The names the reference's fleetobs tests import, from ``pkg``."""
    fleet = _mod(pkg, "observe.fleet")
    ts = _mod(pkg, "observe.timeseries")
    kv = _mod(pkg, "kvstore.backend")
    return types.SimpleNamespace(
        pkg=pkg,
        metrics=_mod(pkg, "metrics"),
        DEFAULT_OBJECTIVES=fleet.DEFAULT_OBJECTIVES,
        FRAME_VERSION=fleet.FRAME_VERSION,
        FleetSampler=fleet.FleetSampler,
        SLObjective=fleet.SLObjective,
        SLOEvaluator=fleet.SLOEvaluator,
        TelemetryExchange=fleet.TelemetryExchange,
        aggregate=fleet.aggregate,
        decode_frame=fleet.decode_frame,
        encode_frame=fleet.encode_frame,
        WINDOWS=ts.WINDOWS,
        CounterDelta=ts.CounterDelta,
        TimeSeriesRing=ts.TimeSeriesRing,
        InMemoryBackend=kv.InMemoryBackend,
        InMemoryStore=kv.InMemoryStore,
    )


@pytest.fixture(params=PKGS)
def fo(request):
    return _ns(request.param)


@pytest.mark.parametrize("name", ["observe.fleet", "observe.timeseries"])
def test_public_names_match(name):
    j, t = (_mod(pkg, name) for pkg in PKGS)
    assert sorted(n for n in vars(t) if not n.startswith("_")) == sorted(
        n for n in vars(j) if not n.startswith("_"))
    assert t.__doc__.replace("torch", "jax") == j.__doc__


# -- test_fleetobs.py ----------------------------------------------------------

class TestCounterDelta:
    def test_first_call_returns_zero(self, fo):
        d = fo.CounterDelta()
        assert d.update(100.0) == 0.0

    def test_monotonic_deltas(self, fo):
        d = fo.CounterDelta()
        d.update(100.0)
        assert d.update(150.0) == 50.0
        assert d.update(150.0) == 0.0
        assert d.update(151.5) == 1.5

    def test_counter_reset_counts_new_total_whole(self, fo):
        """A decrease means the counter restarted from zero: the new
        total IS the delta (Prometheus rate() reset rule) — never a
        negative rate."""
        d = fo.CounterDelta()
        d.update(1000.0)
        assert d.update(30.0) == 30.0
        assert d.update(40.0) == 10.0


class TestTimeSeriesRing:
    def test_ctor_validation(self, fo):
        with pytest.raises(ValueError, match="at least one field"):
            fo.TimeSeriesRing(())
        with pytest.raises(ValueError, match="capacity"):
            fo.TimeSeriesRing(("x",), capacity=1)

    def test_wraparound_keeps_newest_capacity_rows(self, fo):
        r = fo.TimeSeriesRing(("x",), capacity=4)
        for i in range(10):
            r.append(float(i), {"x": float(i)})
        assert len(r) == 4
        assert r.appended == 10
        ts, vals = r.window("x", None)
        # oldest-first, exactly the last `capacity` rows
        assert list(ts) == [6.0, 7.0, 8.0, 9.0]
        assert list(vals) == [6.0, 7.0, 8.0, 9.0]
        assert r.last("x") == 9.0

    def test_missing_and_unknown_fields(self, fo):
        r = fo.TimeSeriesRing(("x", "y"), capacity=8)
        r.append(1.0, {"x": 1.0, "zzz": 5.0})   # unknown ignored
        r.append(2.0, {"y": 2.0})                # x stays NaN this row
        r.append(3.0, {"x": 3.0, "y": None})     # None == missing
        _, xs = r.window("x", None)
        _, ys = r.window("y", None)
        assert list(xs) == [1.0, 3.0]
        assert list(ys) == [2.0]
        hist = r.history()
        assert hist[0] == {"ts": 1.0, "x": 1.0}
        assert hist[1] == {"ts": 2.0, "y": 2.0}
        assert r.history(limit=1) == [{"ts": 3.0, "x": 3.0}]

    def test_window_filtering_and_reductions(self, fo):
        r = fo.TimeSeriesRing(("v",), capacity=64)
        for i in range(20):
            r.append(float(i), {"v": float(i)})
        # trailing 5s from the newest sample (ts 19): rows 14..19
        _, vals = r.window("v", 5.0)
        assert list(vals) == [14.0, 15.0, 16.0, 17.0, 18.0, 19.0]
        assert r.reduce("v", "mean", 5.0) == pytest.approx(16.5)
        assert r.reduce("v", "max", 5.0) == 19.0
        assert r.reduce("v", "last", 5.0) == 19.0
        # cumulative field: (19 - 14) / (19 - 14) = 1/s
        assert r.reduce("v", "rate", 5.0) == pytest.approx(1.0)
        # explicit `now` reduces a replayed ring identically
        assert r.reduce("v", "max", 5.0, now=10.0) == 10.0

    def test_rate_needs_two_samples_spanning_time(self, fo):
        r = fo.TimeSeriesRing(("v",), capacity=8)
        assert r.reduce("v", "rate") is None
        r.append(1.0, {"v": 10.0})
        assert r.reduce("v", "rate") is None        # one sample
        r.append(1.0, {"v": 20.0})
        assert r.reduce("v", "rate") is None        # zero span
        r.append(3.0, {"v": 30.0})
        assert r.reduce("v", "rate") == pytest.approx(10.0)

    def test_unknown_reduction_raises(self, fo):
        r = fo.TimeSeriesRing(("v",), capacity=8)
        with pytest.raises(ValueError, match="unknown reduction"):
            r.reduce("v", "median")

    def test_wraparound_rate_is_reset_free(self, fo):
        """After wraparound the ring still reduces oldest-first: rate
        over a wrapped cumulative series never sees a seam."""
        r = fo.TimeSeriesRing(("c",), capacity=5)
        for i in range(12):
            r.append(float(i), {"c": 100.0 * i})
        assert r.reduce("c", "rate") == pytest.approx(100.0)


class TestHistogramQuantile:
    def test_unobserved_series_is_none(self, fo):
        h = fo.metrics.Histogram("t_fo_q0", "h", buckets=(0.1, 1.0))
        assert h.quantile(0.99) is None
        assert h.quantile(0.5, {"phase": "nope"}) is None

    def test_quantile_bounds_validated(self, fo):
        h = fo.metrics.Histogram("t_fo_q1", "h", buckets=(1.0,))
        h.observe(0.5)
        with pytest.raises(ValueError):
            h.quantile(0.0)
        with pytest.raises(ValueError):
            h.quantile(1.5)
        assert h.quantile(1.0) is not None

    def test_single_bucket_interpolates_from_zero(self, fo):
        h = fo.metrics.Histogram("t_fo_q2", "h", buckets=(10.0,))
        h.observe(4.0)
        # one sample in [0, 10]: p50 interpolates to rank*width = 5.0
        assert h.quantile(0.5) == pytest.approx(5.0)
        assert h.quantile(1.0) == pytest.approx(10.0)

    def test_overflow_only_observations_clamp_to_last_bucket(self, fo):
        """+Inf has no upper edge: values past the last finite bucket
        estimate AT that bound, never above it."""
        h = fo.metrics.Histogram("t_fo_q3", "h", buckets=(0.1, 1.0))
        h.observe(50.0)
        h.observe(500.0)
        assert h.quantile(0.5) == 1.0
        assert h.quantile(0.99) == 1.0

    def test_interpolation_within_landing_bucket(self, fo):
        h = fo.metrics.Histogram("t_fo_q4", "h", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 1.6, 3.0):
            h.observe(v)
        # rank(0.5) = 2 lands in bucket (1, 2] holding 2 of 4 samples:
        # 1 + (2-1) * (2-1)/2 = 1.5
        assert h.quantile(0.5) == pytest.approx(1.5)
        # per-label series stay independent
        h.observe(3.0, {"phase": "a"})
        assert h.quantile(0.5, {"phase": "a"}) == pytest.approx(3.0)


# ---------------------------------------------------------------------------
def _slo_ring(fo, values):
    """Ring with one objective field `x`: [(ts, value), ...]."""
    r = fo.TimeSeriesRing(("x",), capacity=512)
    for ts, v in values:
        r.append(float(ts), {"x": float(v)})
    return r


def _obj(fo):
    return (fo.SLObjective("lat", "x", 10.0, "max"),)


class TestSLOEvaluator:
    def test_target_must_be_positive(self, fo):
        with pytest.raises(ValueError, match="target"):
            fo.SLOEvaluator(_slo_ring(fo, []), (fo.SLObjective("z", "x", 0.0),))

    def test_ok_when_under_budget_everywhere(self, fo):
        ev = fo.SLOEvaluator(_slo_ring(fo, [(0, 5), (299, 5)]), _obj(fo))
        out = ev.evaluate(now=299.0)
        o = out["objectives"]["lat"]
        assert o["state"] == "ok" and not out["burning"]
        assert out["worst"]["objective"] == "lat"
        assert o["windows"] == {"10s": 0.5, "1m": 0.5, "5m": 0.5}

    def test_warn_on_single_window_burn(self, fo):
        """Old burn that already stopped: the 5m window is out of
        budget but the 10s window recovered — warn, not burning."""
        ev = fo.SLOEvaluator(_slo_ring(fo, [(0, 20), (299, 5)]), _obj(fo))
        out = ev.evaluate(now=299.0)
        o = out["objectives"]["lat"]
        assert o["state"] == "warn" and not out["burning"]
        assert o["windows"]["5m"] == 2.0 and o["windows"]["10s"] == 0.5

    def test_burning_needs_short_and_long_window(self, fo):
        ev = fo.SLOEvaluator(_slo_ring(fo, [(0, 20), (299, 20)]), _obj(fo))
        out = ev.evaluate(now=299.0)
        assert out["objectives"]["lat"]["state"] == "burning"
        assert out["burning"] and out["worst"]["state"] == "burning"
        assert out["worst"]["ratio"] == 2.0

    def test_gauge_family_refreshed(self, fo):
        ev = fo.SLOEvaluator(_slo_ring(fo, [(0, 20), (299, 20)]), _obj(fo))
        ev.evaluate(now=299.0)
        for label, _secs in fo.WINDOWS:
            got = fo.metrics.slo_burn_ratio.get(
                {"objective": "lat", "window": label}
            )
            assert got == 2.0, label

    def test_empty_window_burns_nothing(self, fo):
        ev = fo.SLOEvaluator(_slo_ring(fo, []), _obj(fo))
        out = ev.evaluate(now=0.0)
        assert out["objectives"]["lat"]["windows"] == {
            "10s": 0.0, "1m": 0.0, "5m": 0.0,
        }
        assert out["objectives"]["lat"]["state"] == "ok"

    def test_default_objectives_cover_issue_set(self, fo):
        assert {o.name for o in fo.DEFAULT_OBJECTIVES} == {
            "verdict_latency_p99", "drop_mix_ratio",
            "epoch_lag", "restart_downtime",
        }


# ---------------------------------------------------------------------------
class TestFrameCodec:
    def test_roundtrip(self, fo):
        f = fo.encode_frame("node-a", 3, {"vps": 100.0}, cluster="c1", ts=50.0)
        d = fo.decode_frame(f)
        assert d == {
            "v": fo.FRAME_VERSION, "node": "node-a", "cluster": "c1",
            "seq": 3, "ts": 50.0, "vps": 100.0,
        }

    def test_rejects_version_and_stamp_drift(self, fo):
        good = fo.encode_frame("n", 1, {}, ts=1.0)
        assert fo.decode_frame(good) is not None
        assert fo.decode_frame(None) is None
        assert fo.decode_frame("junk") is None
        assert fo.decode_frame({**good, "v": fo.FRAME_VERSION + 1}) is None
        assert fo.decode_frame({**good, "node": ""}) is None
        assert fo.decode_frame({**good, "node": 7}) is None
        assert fo.decode_frame({**good, "seq": "x"}) is None
        bad_ts = dict(good)
        del bad_ts["ts"]
        assert fo.decode_frame(bad_ts) is None


class TestTelemetryExchange:
    def _pair(self, fo, store=None):
        store = store or fo.InMemoryStore()
        a = fo.TelemetryExchange(
            fo.InMemoryBackend(store, "a"), "node-a", cluster="t")
        b = fo.TelemetryExchange(
            fo.InMemoryBackend(store, "b"), "node-b", cluster="t")
        return a, b

    def test_publish_and_peer_view(self, fo):
        a, b = self._pair(fo)
        assert a.publish({"vps": 10.0}, ts=100.0)
        assert b.publish({"vps": 20.0}, ts=100.0)
        a.pump()
        b.pump()
        fa = a.frames(now=101.0)
        fb = b.frames(now=101.0)
        assert set(fa) == set(fb) == {"node-a", "node-b"}
        assert fa["node-b"]["vps"] == 20.0 and fa["node-b"]["seq"] == 1
        a.close()
        b.close()

    def test_stale_frames_age_out_by_wall_clock(self, fo):
        """The kill -9 path: the record is still in the store (its
        lease is alive for another ~minute) but the frame's wall-clock
        ts is past the horizon — it must vanish from frames() now."""
        a, b = self._pair(fo)
        a.publish({"vps": 10.0}, ts=100.0)
        b.pump()
        stale0 = fo.metrics.telemetry_frames_total.get({"result": "stale"})
        assert set(b.frames(now=110.0)) == {"node-a"}     # inside 15s
        assert b.frames(now=200.0) == {}                  # aged out
        assert fo.metrics.telemetry_frames_total.get(
            {"result": "stale"}) == stale0 + 1
        # per-call override tightens the horizon
        assert b.frames(now=104.0, stale_s=3.0) == {}
        a.close()
        b.close()

    def test_version_mismatch_counted_rejected(self, fo):
        a, b = self._pair(fo)
        a.store.update_local_key_sync(
            "t/evil", {"v": fo.FRAME_VERSION + 1, "node": "evil",
                       "seq": 1, "ts": 100.0})
        b.pump()
        rej0 = fo.metrics.telemetry_frames_total.get({"result": "rejected"})
        assert b.frames(now=100.0) == {}
        assert fo.metrics.telemetry_frames_total.get(
            {"result": "rejected"}) == rej0 + 1
        a.close()
        b.close()

    def test_other_cluster_frames_invisible(self, fo):
        store = fo.InMemoryStore()
        a, _ = self._pair(fo, store)
        other = fo.TelemetryExchange(
            fo.InMemoryBackend(store, "o"), "node-o", cluster="other")
        other.publish({"vps": 5.0}, ts=100.0)
        a.pump()
        assert a.frames(now=100.0) == {}
        other.close()
        a.close()

    def test_publish_counts_and_seq_advance(self, fo):
        a, _b = self._pair(fo)
        pub0 = fo.metrics.telemetry_frames_total.get({"result": "published"})
        a.publish({}, ts=1.0)
        a.publish({}, ts=2.0)
        a.pump()
        assert a.frames(now=2.0)["node-a"]["seq"] == 2
        assert fo.metrics.telemetry_frames_total.get(
            {"result": "published"}) == pub0 + 2
        a.close()


class TestAggregate:
    def _frame(self, fo, node, **kw):
        body = {"vps": 0.0, "slo": {"worst": {
            "objective": "verdict_latency_p99", "state": "ok", "ratio": 0.1,
        }}}
        body.update(kw)
        return fo.encode_frame(node, 1, body, ts=kw.pop("ts", 100.0))

    def test_scoreboard_math(self, fo):
        frames = {
            "a": self._frame(fo, "a", vps=100.0, policy_epoch=7, epoch_lag=0.0),
            "b": self._frame(fo, "b", vps=50.0, policy_epoch=9, epoch_lag=2.0),
        }
        frames["b"]["slo"] = {"worst": {
            "objective": "epoch_lag", "state": "burning", "ratio": 1.5,
        }}
        out = fo.aggregate(frames, now=101.0)
        assert out["nodes_reporting"] == 2
        assert out["fleet_vps"] == 150.0
        assert out["epoch_skew"] == 2
        assert out["epoch_lag_max"] == 2.0
        assert out["worst_burn"] == {
            "objective": "epoch_lag", "state": "burning",
            "ratio": 1.5, "node": "b",
        }
        rows = {r["node"]: r for r in out["nodes"]}
        assert rows["a"]["vps"] == 100.0 and rows["a"]["slo_state"] == "ok"
        assert rows["b"]["age_s"] == 1.0
        assert fo.metrics.fleet_nodes_reporting.get() == 2.0

    def test_empty_fleet(self, fo):
        out = fo.aggregate({}, now=0.0)
        assert out["nodes_reporting"] == 0 and out["fleet_vps"] == 0.0
        assert out["epoch_skew"] == 0 and out["nodes"] == []
        assert out["worst_burn"]["state"] == "ok"
        assert fo.metrics.fleet_nodes_reporting.get() == 0.0


# ---------------------------------------------------------------------------
class TestFleetSampler:
    def test_sample_once_derives_rates_from_counters(self, fo):
        s = fo.FleetSampler(interval_s=1.0, capacity=16)
        s.sample_once(now=100.0)                  # priming tick
        fo.metrics.verdicts_total.inc({"outcome": "forwarded"}, 500.0)
        sample = s.sample_once(now=101.0)
        assert sample["vps"] == pytest.approx(500.0, rel=0.01)
        assert sample["drop_ratio"] == 0.0
        assert s.ring.appended == 2
        assert s.last_slo is not None

    def test_drop_mix_ratio(self, fo):
        s = fo.FleetSampler(interval_s=1.0, capacity=16)
        s.sample_once(now=100.0)
        fo.metrics.verdicts_total.inc({"outcome": "forwarded"}, 75.0)
        fo.metrics.verdicts_total.inc({"outcome": "dropped"}, 25.0)
        sample = s.sample_once(now=101.0)
        assert sample["drop_ratio"] == pytest.approx(0.25)

    def test_frame_body_and_publication(self, fo):
        store = fo.InMemoryStore()
        s = fo.FleetSampler(interval_s=1.0, capacity=16,
                            epoch_source=lambda: 42)
        s.attach_exchange(fo.TelemetryExchange(
            fo.InMemoryBackend(store, "x"), "node-x", cluster="t"))
        fo.metrics.verdicts_total.inc({"outcome": "forwarded"}, 10.0)
        s.sample_once(now=100.0)
        s.sample_once(now=101.0)
        body = s.frame_body()
        assert body["policy_epoch"] == 42
        assert set(body["slo"]["states"]) == {
            o.name for o in fo.DEFAULT_OBJECTIVES}
        frames = s.exchange.frames()
        assert frames["node-x"]["seq"] == 2
        agg = fo.aggregate(frames)
        assert agg["nodes_reporting"] == 1
        s.stop()
        assert s.exchange is None                 # stop() closed it

    def test_snapshot_counter_and_summary(self, fo):
        c0 = fo.metrics.timeseries_snapshots_total.get()
        s = fo.FleetSampler(interval_s=1.0, capacity=16)
        s.sample_once(now=1.0)
        assert fo.metrics.timeseries_snapshots_total.get() == c0 + 1
        summary = s.slo_summary()
        assert set(summary) == {"worst_objective", "state", "ratio",
                                "burning"}
        st = s.local_status()
        assert st["samples"] == 1 and st["capacity"] == 16


def _sampler_threads():
    return [t for t in threading.enumerate() if t.name == "fleet-sampler"]


def test_sampler_thread_stops_with_stop(fo):
    """The cadence thread (``fleet-sampler``) ticks on its own and never
    outlives ``stop()``."""
    s = fo.FleetSampler(interval_s=0.01, capacity=16)
    before = set(_sampler_threads())  # another test's daemon may hold one
    try:
        s.start()
        s.start()  # idempotent: one thread
        assert len(set(_sampler_threads()) - before) == 1
        deadline = time.monotonic() + 5.0
        while s.ring.appended < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert s.ring.appended >= 2
    finally:
        s.stop()
    assert not set(_sampler_threads()) - before


# -- sampler parity through both pipelines -------------------------------------

# the gauges the sampler reads, set alike in both packages first: earlier
# tests in the worker (the reference's daemon tests among them) may have
# left them apart
GAUGES = {"pipeline_mode": 0.0, "cluster_epoch_lag": 1.0, "restart_downtime_seconds": 0.25}
EQUAL_FIELDS = ("vps", "drop_ratio", "shed_ratio", "pipeline_mode", "epoch_lag",
                "transfer_bps", "restart_downtime_s")


def _keys(tree):
    """The nested key structure of an SLO state tree."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_sampler_parity_through_the_pipelines():
    """Both packages' pipelines, tracer on, serve the same v4 and v6
    batches between two ticks of their package's sampler at the same
    ``now``: the rates and ratios are equal, both latency quantiles are
    present, the SLO state trees have the same keys, and one frame of
    each package aggregates into a two-node scoreboard."""
    pr = Pair(3, depth=2)
    nss = {pkg: _ns(pkg) for pkg in PKGS}
    for pkg, p in pr.pipes.items():
        p.tracer.enable()
        p.rebuild()
        for name, v in GAUGES.items():
            getattr(nss[pkg].metrics, name).set(v)
    samplers = {pkg: nss[pkg].FleetSampler(interval_s=1.0, capacity=16,
                                          epoch_source=lambda p=p: p.policy_epoch)
                for pkg, p in pr.pipes.items()}
    for s in samplers.values():
        s.sample_once(now=100.0)
    batches = [(4, pr.flows(4, 512, 61)), (6, pr.flows(6, 256, 62)), (4, pr.flows(4, 300, 63))]
    n_flows = n_drop = 0
    for fam, bt in batches:
        call = "process" if fam == 4 else "process_v6"
        outs = [getattr(p, call)(*bt) for p in (pr.j, pr.t)]
        pr.equal(outs[1], tuple(np.asarray(x) for x in outs[0]))
        v = outs[1][0]
        n_flows += v.size
        n_drop += int((v != 1).sum())
    got = {pkg: s.sample_once(now=101.5) for pkg, s in samplers.items()}
    j, t = got[PKGS[0]], got[PKGS[1]]
    for f in EQUAL_FIELDS:
        assert t[f] == j[f], f
    assert t["vps"] * 1.5 == pytest.approx(n_flows, abs=1e-6)
    assert t["drop_ratio"] == pytest.approx(n_drop / n_flows) and 0 < n_drop < n_flows
    assert t["transfer_bps"] > 0
    assert (t["epoch_lag"], t["restart_downtime_s"]) == (1.0, 0.25)
    for s in got.values():
        assert s["verdict_p50_ms"] is not None and s["verdict_p99_ms"] is not None
        assert 0 < s["verdict_p50_ms"] <= s["verdict_p99_ms"]
    sj, st = (samplers[pkg] for pkg in PKGS)
    assert _keys(st.last_slo) == _keys(sj.last_slo)
    assert st.slo_summary().keys() == sj.slo_summary().keys()
    frames = {f"node-{pkg}": nss[pkg].encode_frame(f"node-{pkg}", 1, samplers[pkg].frame_body(),
                                                  ts=200.0) for pkg in PKGS}
    for pkg in PKGS:
        agg = nss[pkg].aggregate(frames, now=201.0)
        assert agg["nodes_reporting"] == 2 and agg["epoch_skew"] == 0
        assert agg["fleet_vps"] == round(sum(f["vps"] for f in frames.values()), 3)
        assert agg["fleet_vps"] > 0
