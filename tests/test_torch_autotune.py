"""Port parity: the depth tuner (policyd-autotune), the pinned staging,
and what the port holds in place of the reference's ladder chunking.

- Both packages' ``DepthTuner`` fed the same observations make the same
  decisions and give the same snapshots, over the reference's
  ``TestDepthTuner`` profiles (tests/test_autotune.py).
- ``DispatchAutoTune`` on is bit-identical to the static depth:
  verdicts, redirects, counters, CT entries, shape keys and phase
  names, also under VerdictSharding + CT replay + FlowAttribution on 8
  CPU records (the reference's 8 virtual CPU devices), and equal to the
  JAX package's.
- The reference pads every CT miss tail to ``BUCKET_LADDER`` rungs
  (``TestLadderChunker``, ``TestPadLaneAccounting``); the port launches
  each flow shard at its exact size and never moves
  ``dispatch_pad_lanes_total``, autotune on or off (ROADMAP queue C,
  *No padding*).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from cilium_tpu import metrics as jmetrics
from cilium_tpu.datapath.tuner import DepthTuner as JDepthTuner
from cilium_tpu_torch import contracts as tcontracts
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.datapath import placement as tplace
from cilium_tpu_torch.datapath.tuner import DepthTuner
from test_torch_submit import Pair

CPU = torch.device("cpu")


def _simulate(tuner, optimal, *, epochs=60, flat=False, noise=None):
    """The reference's synthetic timings: enqueue 1 ms; the completion
    half shrinks with depth up to ``optimal``, then degrades; ``flat``
    makes depth buy nothing. → (final depth, every decision)."""
    depth = tuner.min_depth
    decisions = []
    for i in range(epochs * tuner.epoch):
        if flat:
            comp = 1_000_000
        elif depth <= optimal:
            comp = 1_000_000 // depth
        else:
            comp = int(1_000_000 / optimal * (1 + 0.5 * (depth - optimal)))
        if noise is not None:
            comp = int(comp * noise[i % len(noise)])
        new = tuner.observe(depth, 1000, 1_000_000, comp, depth + 1)
        decisions.append(new)
        if new is not None:
            assert tuner.min_depth <= new <= tuner.max_depth
            assert abs(new - depth) == 1
            depth = new
    return depth, decisions


# -- DepthTuner: both packages, the same decisions --------------------------
PROFILES = [
    pytest.param(dict(lo=1, hi=4, epoch=4), dict(optimal=o), id=f"optimal{o}") for o in (1, 2, 3, 4)
] + [
    pytest.param(dict(lo=1, hi=3, epoch=4), dict(optimal=8), id="max_depth_bound"),
    pytest.param(dict(lo=1, hi=4, epoch=4), dict(optimal=1, flat=True), id="flat"),
    pytest.param(dict(lo=2, hi=6, epoch=3), dict(optimal=4), id="min_depth_2"),
    pytest.param(dict(lo=1, hi=4, epoch=2), dict(optimal=3, noise=(0.7, 1.3, 1.0, 0.9, 1.2)),
                 id="noisy"),
]


@pytest.mark.parametrize("cfg,profile", PROFILES)
def test_depth_tuner_decisions_match_jax(cfg, profile):
    port = DepthTuner(cfg["lo"], cfg["hi"], epoch=cfg["epoch"])
    ref = JDepthTuner(cfg["lo"], cfg["hi"], epoch=cfg["epoch"])
    got = _simulate(port, **profile)
    want = _simulate(ref, **profile)
    assert got == want
    assert port.snapshot() == ref.snapshot()
    assert (port.ups, port.downs) == (ref.ups, ref.downs)
    depth = got[0]
    if profile.get("flat"):
        assert depth == 1 and port.downs == port.ups <= 60 // 8 + 2
    elif profile["optimal"] == 8:
        assert depth == cfg["hi"]
    else:
        assert abs(depth - profile["optimal"]) <= 1


def test_depth_tuner_random_observations_match_jax():
    rng = np.random.default_rng(13)
    port, ref = DepthTuner(1, 5, epoch=3), JDepthTuner(1, 5, epoch=3)
    depth = 1
    for _ in range(600):
        obs = (int(rng.integers(1, 5000)), int(rng.integers(1, 10 ** 7)),
               int(rng.integers(1, 10 ** 7)), int(rng.integers(0, 7)))
        a, b = port.observe(depth, *obs), ref.observe(depth, *obs)
        assert a == b
        if a is not None:
            depth = a
    assert port.snapshot() == ref.snapshot()


def test_epoch_gates_decisions_and_snapshot_shape():
    tuner = DepthTuner(1, 4, epoch=16)
    for _ in range(15):
        assert tuner.observe(1, 100, 1000, 1000, 2) is None
    assert tuner.snapshot()["epochs_seen"] == 0
    tuner = DepthTuner(2, 4, epoch=2)
    tuner.observe(2, 100, 1000, 1000, 3)
    tuner.observe(2, 100, 1000, 1000, 3)
    snap = tuner.snapshot()
    assert snap["min_depth"] == 2 and snap["max_depth"] == 4
    assert snap["epochs_seen"] == 1 and "2" in snap["stats"]
    assert set(snap["adjustments"]) == {"up", "down"}


# -- the pipeline: autotune on == off == JAX --------------------------------
def _ct_batches(pr, n, count, seed):
    rng = np.random.default_rng(seed)
    batches = [pr.flows(4, n, seed + i) for i in range(count)]
    sports = [rng.integers(1024, 4096, n).astype(np.int32) for _ in batches]
    batches.append(batches[0])  # CT replay
    sports.append(sports[0])
    return batches, sports


def _submit_both(pr, batches, sports):
    """Every batch submitted to both packages back to back, then
    resolved in order → [(jax result, port result)]. The port's queue
    depth follows its tuner, so the two queues may differ in depth."""
    pend = [(pr.j.submit(*b, sports=sp), pr.t.submit(*b, sports=sp))
            for b, sp in zip(batches, sports)]
    return [(jh.result(), th.result()) for jh, th in pend]


class TestAutotuneParity:
    def test_off_path_is_static_and_tunerless(self, monkeypatch):
        """Off: no tuner is built and no batch carries observations."""
        def boom(*a, **k):
            raise AssertionError("DepthTuner built while autotune is off")

        monkeypatch.setattr(tpipe, "DepthTuner", boom)
        pr = Pair(3, depth=1, ct=True)
        p = pr.t
        assert p._tuner is None and p.pipeline_depth == 1
        h = p.submit(*pr.flows(4, 64, 2), sports=np.arange(64, dtype=np.int32) + 1024)
        h.result()
        assert p._tuner is None and p.autotune_state() is None

    def test_on_off_verdicts_and_programs_identical(self):
        """Autotune on (depth moving, epoch 2) against off and against
        the JAX package: verdicts, redirects, counters, CT entries and
        shape keys bit-identical."""
        pa = Pair(3, depth=1, ct=True)
        pa.t.set_autotune(True, max_depth=4, epoch=2)
        pb = Pair(3, depth=1, ct=True)
        for p in (pa.t, pb.t, pa.j):
            p.tracer.enable()
        batches, sports = _ct_batches(pa, 300, 10, 70)
        got = _submit_both(pa, batches, sports)
        for b, sp, (want_j, have) in zip(batches, sports, got):
            pa.equal(have, want_j)
            pa.equal(have, pb.t.process(*b, sports=sp))
        np.testing.assert_array_equal(pa.t.counters, pb.t.counters)
        pa.state_equal()
        assert pa.t._seen_shapes == pb.t._seen_shapes
        assert len(pa.t.conntrack) == len(pb.t.conntrack) == len(pa.j.conntrack)
        state = pa.t.autotune_state()
        assert state["epochs_seen"] == 5 and state["static_depth"] == 1
        assert 1 <= state["depth"] <= 4

    def test_sharded_ct_attribution_combo_parity(self, monkeypatch):
        """VerdictSharding + CT replay + FlowAttribution at once, on 8 CPU
        records (the JAX package's 8 virtual CPU devices): autotuned
        against static, and against the JAX package sharded alike."""
        assert len(jax.devices()) == 8
        monkeypatch.setattr(tplace, "visible_devices",
                            lambda: [tplace.DeviceRecord(i, 0, CPU) for i in range(8)])
        pa = Pair(3, depth=2, ct=True)
        pb = Pair(3, depth=1, ct=True)
        for p in (pa.t, pa.j, pb.t):
            p.set_sharding(True)
            p.set_attribution(True)
            p.rebuild()
        pa.t.set_autotune(True, max_depth=4, epoch=2)
        assert pa.t._placed is not None and len(pa.t._placed.rows) == 8
        batches, sports = _ct_batches(pa, 250, 6, 40)
        got = _submit_both(pa, batches, sports)
        for b, sp, (want_j, have) in zip(batches, sports, got):
            pa.equal(have, want_j)
            pa.equal(have, pb.t.process(*b, sports=sp))
        np.testing.assert_array_equal(pa.t.counters, pb.t.counters)
        pa.state_equal()

    def test_phase_names_stay_stable_under_autotune(self):
        pr = Pair(3, depth=1, ct=True)
        p = pr.t
        p.set_autotune(True, max_depth=4, epoch=2)
        p.tracer.enable()
        rng = np.random.default_rng(2)
        for i in range(6):
            p.process(*pr.flows(4, 200, 90 + i),
                      sports=rng.integers(1024, 4096, 200).astype(np.int32))
        p.tracer.disable()
        traces = p.tracer.traces(6)
        assert len(traces) == 6
        for t in traces:
            assert {ph[0] for ph in t["phases"]} <= set(tcontracts.TRACE_PHASES)

    def test_set_autotune_off_restores_static_depth(self):
        p = Pair(3, depth=2, ct=True).t
        p.set_autotune(True, max_depth=4, epoch=2)
        a0 = tmetrics.autotune_adjustments_total.get({"direction": "up"})
        p._apply_depth(4)
        assert p.pipeline_depth == 4
        assert tmetrics.autotune_adjustments_total.get({"direction": "up"}) == a0 + 1
        assert tmetrics.pipeline_depth_current.get() == 4.0
        p.set_autotune(False)
        assert p._tuner is None and p.pipeline_depth == 2
        assert p.autotune_state() is None

    def test_constructor_takes_autotune(self):
        pr = Pair(3, depth=1, autotune=True, pipeline_max_depth=3)
        p = pr.t
        assert p._tuner is not None and p._tuner.max_depth == 3
        assert pr.j._tuner is not None
        snap = p.autotune_state()
        assert snap["depth"] == 1 and snap["static_depth"] == 1 and snap["min_depth"] == 1

    def test_tuner_holds_back_while_the_gate_sheds(self, monkeypatch):
        """The armistice: while the admission gate shed recently, a
        decision to go deeper is not applied; one to go shallower is."""
        p = Pair(3, depth=2, admission=True).t
        p.set_autotune(True, max_depth=4, epoch=2)
        monkeypatch.setattr(p._admission, "shedding", lambda: True)
        asked = iter([3, 3, 1])
        monkeypatch.setattr(p._tuner, "observe", lambda *a: next(asked))
        pr_flows = Pair(3).flows(4, 32, 1)
        for want in (2, 2, 1):
            p.submit(*pr_flows).result()
            assert p.pipeline_depth == want


# -- pinned staging ---------------------------------------------------------
class TestStaging:
    def test_staging_recycles_and_verdicts_stay_clean(self):
        """Two miss tails under one staging key back to back: the second
        reuses the first's released tuple (its tail still holds the first
        batch's flows), and the verdicts equal a fresh pipeline's."""
        pr = Pair(3, depth=1, ct=True)
        p = pr.t
        rng = np.random.default_rng(31)
        b1, b2 = pr.flows(4, 1500, 11), pr.flows(4, 1200, 12)
        sp1 = rng.integers(1024, 4096, 1500).astype(np.int32)
        sp2 = rng.integers(8192, 16384, 1200).astype(np.int32)
        v1, _ = p.process(*b1, sports=sp1)
        key = ("in", 4, 2048)
        assert p._staging.get(key), "released tuple not pooled"
        pooled = p._staging[key][-1]
        v2, _ = p.process(*b2, sports=sp2)
        assert any(t is pooled for t in p._staging.get(key, ()))
        fresh = Pair(3, depth=1, ct=True)
        np.testing.assert_array_equal(v1, fresh.t.process(*b1, sports=sp1)[0])
        np.testing.assert_array_equal(v2, fresh.t.process(*b2, sports=sp2)[0])
        np.testing.assert_array_equal(v2, fresh.j.process(*b2, sports=sp2)[0])

    def test_free_list_is_bounded(self):
        pr = Pair(3, depth=1, ct=True)
        p = pr.t
        rng = np.random.default_rng(37)
        for i in range(12):
            n = 1100 + i
            p.process(*pr.flows(4, n, 100 + i),
                      sports=rng.integers(1024, 60000, n).astype(np.int32))
        for free in p._staging.values():
            assert len(free) <= p._STAGING_FREE_CAP


# -- no padding: the port's counterpart of the ladder tests -----------------
@pytest.mark.parametrize("n,ndev", [(1, 1), (1100, 1), (3000, 1), (9000, 1), (1, 3), (1100, 3),
                                    (3000, 8), (67, 8), (5, 8)])
def test_one_exact_span_per_flow_shard(n, ndev):
    """Where the reference pads a tail to ladder rungs rounded to the
    device count, the port gives each flow shard one span at its exact
    size: the spans tile [0, n) in order, no wider than ceil(n / ndev),
    only the last shorter."""
    spans = tpipe.DatapathPipeline._shard_spans(n, ndev)
    assert len(spans) == ndev
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    w = -(-n // ndev)
    assert all(hi - lo <= w for lo, hi in spans)
    assert all(hi - lo == w for lo, hi in spans[:-1] if hi < n)


@pytest.mark.parametrize("autotune", [False, True])
def test_no_pad_lanes_on_the_ct_miss_tail(autotune):
    """An all-miss 1 100-flow CT batch: the reference pads its tail to
    the 2 048 rung (TestPadLaneAccounting), the port launches 1 100
    lanes and never moves dispatch_pad_lanes_total, with autotune on
    too; the results are equal."""
    pr = Pair(3, depth=1, ct=True)
    if autotune:
        pr.t.set_autotune(True, max_depth=4, epoch=2)
        pr.j.set_autotune(True, max_depth=4, epoch=2)
    pr.t.set_profiling(True, sample_every=1)
    rng = np.random.default_rng(3)
    before = (jmetrics.dispatch_pad_lanes_total.get({"family": "v4"}),
              tmetrics.dispatch_pad_lanes_total.get({"family": "v4"}))
    for i in range(3):
        n = 1100
        flows = pr.flows(4, n, 9 + i)
        sp = rng.integers(1024, 4096, n).astype(np.int32)
        jh, th = pr.submit(4, flows, sports=sp)
        pr.equal(th.result(), jh.result())
    pr.state_equal()
    d_j = jmetrics.dispatch_pad_lanes_total.get({"family": "v4"}) - before[0]
    d_t = tmetrics.dispatch_pad_lanes_total.get({"family": "v4"}) - before[1]
    assert d_t == 0 and d_j > 0
    for s in pr.t.profiler.samples():
        assert s["notes"]["pad_lanes"] == 0 and s["notes"]["rungs"] == [s["notes"]["lanes"]]


def test_no_pad_lanes_when_sharded(monkeypatch):
    """A sharded no-CT batch of ndev × 8 + 3 flows: the reference pads
    to a multiple of the device count, the port launches the 8 shards
    at their exact sizes, one launch each."""
    monkeypatch.setattr(tplace, "visible_devices",
                        lambda: [tplace.DeviceRecord(i, 0, CPU) for i in range(8)])
    pr = Pair(3, depth=1)
    for p in pr.pipes.values():
        p.set_sharding(True)
        p.rebuild()
    pr.t.set_profiling(True, sample_every=1)
    b = 8 * 8 + 3
    before = (jmetrics.dispatch_pad_lanes_total.get({"family": "v4"}),
              tmetrics.dispatch_pad_lanes_total.get({"family": "v4"}))
    jh, th = pr.submit(4, pr.flows(4, b, 5))
    pr.equal(th.result(), jh.result())
    assert jmetrics.dispatch_pad_lanes_total.get({"family": "v4"}) - before[0] == (-b) % 8
    assert tmetrics.dispatch_pad_lanes_total.get({"family": "v4"}) == before[1]
    (s,) = pr.t.profiler.samples()
    assert s["notes"]["ndev"] == 8 and s["notes"]["chunks"] == 8
    assert s["notes"]["rungs"] == [9] * 7 + [4] and s["notes"]["pad_lanes"] == 0
