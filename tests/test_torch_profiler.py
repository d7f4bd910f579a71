"""Port parity: the device profiler (policyd-prof) and its two sites.

The reference's cost contract and sampled-path checks
(tests/test_profiler.py ``TestDisabledOverhead``, ``TestSampledPath``)
run against the port's ``DatapathPipeline.set_profiling``. On the CPU
(``device="cpu"``) a sample's h2d / device_compute / d2h come from
``time.perf_counter`` around the copies in, the launches and the copies
out; on the card from CUDA events (chip_smoke's observe phase). A
sampled batch's verdicts, counters and launch shapes equal an unsampled
one's and the JAX package's; its notes carry the reference's keys, with
the port's exact launch shapes (``pad_lanes`` 0). The launch-cost
ledger holds one entry per (site, shape) with ``flops`` None and the
bytes of the launch's tensors. The ``l7`` site samples
``L7Pipeline.submit`` as the reference's does.
"""

from __future__ import annotations

import numpy as np
import pytest

import cilium_tpu.datapath.l7_pipeline as jl7rt
import cilium_tpu_torch.datapath.l7_pipeline as tl7rt
from cilium_tpu import metrics as jmetrics
from cilium_tpu.observe import DeviceProfiler as JDeviceProfiler
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath.conntrack import FlowConntrack
from cilium_tpu_torch.observe import DeviceProfiler
from cilium_tpu_torch.observe import profiler as tprofiler_mod
from test_torch_l7 import _tables
from test_torch_observe import _batch, _pipeline
from test_torch_submit import B, Pair

NOTE_KEYS = {"rungs", "lanes", "pad_lanes", "chunks", "ndev", "depth", "family", "bucketed"}


@pytest.fixture(autouse=True)
def _l7_reset():
    for mod in (jl7rt, tl7rt):
        mod._reset_for_tests()
    yield
    for mod in (jl7rt, tl7rt):
        mod._reset_for_tests()


class TestDisabledOverhead:
    def test_off_builds_no_profiler_objects(self, monkeypatch):
        """Off: the pipeline holds profiler=None, and a batch builds
        neither a DeviceProfiler nor a _DispatchSample, on the no-CT,
        host-CT and device-CT paths."""
        pipe = _pipeline()
        assert pipe.profiler is None

        class _Boom:
            def __init__(self, *a, **k):
                raise AssertionError("profiler object built while off")

        monkeypatch.setattr(tprofiler_mod, "DeviceProfiler", _Boom)
        monkeypatch.setattr(tprofiler_mod, "_DispatchSample", _Boom)
        v, _red = pipe.process(*_batch())
        assert (v == 1).all()
        pipe.conntrack = FlowConntrack(capacity_bits=12)
        v, _red = pipe.process(*_batch(), sports=np.arange(8) + 30000)
        assert (v == 1).all()
        dct = type(pipe)(pipe.engine, pipe.ipcache, device_ct_bits=10, device="cpu")
        dct.set_endpoints([(7, pipe._endpoints[0])])
        v, _red = dct.process(*_batch(), sports=np.arange(8) + 30000)
        assert (v == 1).all()
        assert pipe.profiler is None and dct.profiler is None

    def test_on_unsampled_builds_no_sample(self, monkeypatch):
        """On, the unsampled batches tick a counter and build no sample."""
        pipe = _pipeline()
        pipe.set_profiling(True, sample_every=10 ** 6)

        class _Boom:
            def __init__(self, *a, **k):
                raise AssertionError("sample built on unsampled batch")

        monkeypatch.setattr(tprofiler_mod, "_DispatchSample", _Boom)
        for _ in range(3):
            v, _ = pipe.process(*_batch())
            assert (v == 1).all()
        assert pipe.profiler.samples() == []

    def test_off_path_program_unchanged(self):
        """Profiling toggled on and back off traces the phases (and
        verdicts) of a pipeline that never profiled."""
        a, b = _pipeline(), _pipeline()
        b.set_profiling(True, sample_every=1)
        b.process(*_batch())
        b.set_profiling(False)
        a.tracer.enable()
        b.tracer.enable()
        for _ in range(2):
            va, _ = a.process(*_batch())
            vb, _ = b.process(*_batch())
            np.testing.assert_array_equal(va, vb)
        names_a = [[p[0] for p in t["phases"]] for t in a.tracer.traces()]
        names_b = [[p[0] for p in t["phases"]] for t in b.tracer.traces()]
        assert names_a == names_b


class TestSampledPath:
    def test_sampled_verdicts_identical_and_decomposed(self):
        """sample_every=1: verdicts stay bit-identical and each sample
        carries the split and the launch-shape notes."""
        plain, prof = _pipeline(), _pipeline()
        prof.set_profiling(True, sample_every=1)
        n0 = tmetrics.profile_samples_total.get({"site": "dispatch"})
        for n in (8, 16):
            vp, rp = plain.process(*_batch(n))
            vq, rq = prof.process(*_batch(n))
            np.testing.assert_array_equal(vp, vq)
            np.testing.assert_array_equal(rp, rq)
        np.testing.assert_array_equal(plain.counters, prof.counters)
        samples = prof.profiler.samples()
        assert len(samples) == 2
        for s, n in zip(samples, (8, 16)):
            assert s["site"] == "dispatch" and s["batch"] == n
            assert s["h2d_ms"] >= 0.0
            assert s["device_compute_ms"] > 0.0
            assert s["d2h_ms"] >= 0.0
            notes = s["notes"]
            assert set(notes) == NOTE_KEYS
            assert notes["lanes"] == n and notes["rungs"] == [n]
            assert notes["chunks"] == len(notes["rungs"]) == 1
            assert notes["pad_lanes"] == 0 and notes["ndev"] == 1
        assert tmetrics.profile_samples_total.get({"site": "dispatch"}) == n0 + 2

    @pytest.mark.parametrize("ct", [False, True])
    def test_samples_and_results_match_jax(self, ct):
        """Both packages at sample_every=2 on the same batches: the same
        results and counters, the same number of samples, and notes that
        agree wherever the reference pads nothing (the no-CT path); on
        the CT miss tail the port's rung is the tail's exact size."""
        pr = Pair(3, depth=2, ct=ct)
        for p in pr.pipes.values():
            p.set_profiling(True, sample_every=2)
        rng = np.random.default_rng(5)
        for i in range(4):
            sp = rng.integers(1024, 4096, B).astype(np.int32) if ct else None
            jh, th = pr.submit(4, pr.flows(4, B, 30 + (i % 2)), sports=sp)
            pr.equal(th.result(), jh.result())
        pr.state_equal()
        got, want = pr.t.profiler.samples(), pr.j.profiler.samples()
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["site"] == w["site"] == "dispatch" and g["batch"] == w["batch"]
            assert set(g["notes"]) == set(w["notes"]) == NOTE_KEYS
            for k in ("lanes", "chunks", "ndev", "depth", "family", "bucketed"):
                assert g["notes"][k] == w["notes"][k], k
            if not ct:
                assert g["notes"]["rungs"] == w["notes"]["rungs"]
                assert g["notes"]["pad_lanes"] == w["notes"]["pad_lanes"] == 0
            else:
                assert g["notes"]["rungs"] == [g["notes"]["lanes"]]
                assert g["notes"]["pad_lanes"] == 0 <= w["notes"]["pad_lanes"]

    def test_device_ct_path_is_sampled(self, monkeypatch):
        """The device-CT batch is sampled too (a port addition: the
        reference's fused program has no sample), and its verdicts,
        counters and CT table equal an unsampled pipeline's."""
        import time

        monkeypatch.setattr(time, "monotonic", lambda: 50_000.25)
        pr = Pair(3, depth=2, device_ct_bits=10)
        twin = Pair(3, depth=2, device_ct_bits=10).t
        pr.t.set_profiling(True, sample_every=1)
        rng = np.random.default_rng(3)
        for i in range(2):
            sp = rng.integers(1024, 4096, B).astype(np.int32)
            flows = pr.flows(4, B, 40)
            got = pr.t.process(*flows, sports=sp)
            pr.equal(got, twin.process(*flows, sports=sp))
            pr.equal(got, pr.j.process(*flows, sports=sp))
        np.testing.assert_array_equal(pr.t.counters, twin.counters)
        for a, b in zip((pr.t._device_ct.exp, pr.t._device_ct.kc_lo, pr.t._device_ct.rec),
                        (twin._device_ct.exp, twin._device_ct.kc_lo, twin._device_ct.rec)):
            assert bool((a == b).all())
        samples = pr.t.profiler.samples()
        assert len(samples) == 2
        for s in samples:
            assert s["notes"]["device_ct"] is True and s["notes"]["rungs"] == [B]
            assert s["device_compute_ms"] > 0.0
        (key,) = pr.t.profiler.jit_costs()
        assert key.startswith("dispatch:('ct', 4, 300")

    def test_jit_cost_ledger_keyed_by_site_and_shape(self):
        pipe = _pipeline()
        pipe.set_profiling(True, sample_every=1)
        pipe.process(*_batch())
        pipe.process(*_batch())  # the same launch shape: no second entry
        costs = pipe.profiler.jit_costs()
        assert list(costs) == ["dispatch:(4, 8, False, 1, False, False, False, False)"]
        (entry,) = costs.values()
        assert set(entry) == {"flops", "bytes_accessed"}
        assert entry["flops"] is None
        # at least the flows in (4 int32 a flow) and the outputs
        assert entry["bytes_accessed"] >= 8 * 16 + 8 * 2 + 12
        pipe.process(*_batch(16))
        assert len(pipe.profiler.jit_costs()) == 2

    def test_note_jit_cost_counts_tensor_bytes_once(self):
        import torch

        prof = DeviceProfiler()
        a = torch.zeros(10, dtype=torch.int32)
        prof.note_jit_cost("s", (1,), (a, [a, None]), a)
        prof.note_jit_cost("s", (1,), (a,), None)  # the key is kept
        assert prof.jit_costs() == {"s:(1,)": {"flops": None, "bytes_accessed": 120.0}}

    def test_device_table_bytes_published_at_rebuild(self):
        pipe = _pipeline()
        pipe.process(*_batch())  # forces the first rebuild
        series = tmetrics.device_table_bytes.series()
        fams = {dict(k).get("family") for k in series}
        assert "policymap" in fams
        assert all(v >= 0 for v in series.values())

    def test_snapshot_aggregates_per_site(self):
        pipe = _pipeline()
        pipe.set_profiling(True, sample_every=1)
        pipe.process(*_batch())
        snap = pipe.profile_state()
        assert snap["enabled"] is True
        assert snap["sample_every"] == 1
        agg = snap["sites"]["dispatch"]
        assert agg["samples"] == 1
        assert agg["device_compute_ms"] > 0.0
        pipe.set_profiling(False)
        assert pipe.profile_state() == {"enabled": False, "sample_every": 1}

    def test_reenable_retunes_live_sample_rate(self):
        """set_profiling(True, sample_every=N) on a profiler that is
        already on retunes the live instance."""
        pipe = _pipeline()
        pipe.set_profiling(True, sample_every=64)
        live = pipe.profiler
        pipe.set_profiling(True, sample_every=1)
        assert pipe.profiler is live and pipe.profiler.sample_every == 1
        pipe.process(*_batch())
        assert len(pipe.profiler.samples()) == 1

    def test_constructor_takes_profiling(self):
        base = _pipeline()
        pipe = type(base)(base.engine, base.ipcache, profiling=True, profile_sample_every=3,
                          device="cpu")
        assert pipe.profiler is not None and pipe.profiler.sample_every == 3
        assert pipe.profile_state()["sample_every"] == 3


# -- the l7 site ------------------------------------------------------------
def _l7_batch():
    return [([b"/a", b"/abc", b"/b", b"/" + b"x" * 40] * 10, 16)]


def test_l7_site_samples_like_jax():
    """One L7Pipeline per package with a profiler at sample_every=1:
    the same masks as an unprofiled pipeline, and one ``l7`` sample
    each whose notes equal the reference's."""
    jt, tt = _tables([["/a.*"]])
    out = {}
    for name, rt, table, prof in (("jax", jl7rt, jt, JDeviceProfiler(sample_every=1)),
                                  ("torch", tl7rt, tt, DeviceProfiler(sample_every=1))):
        dev = {} if name == "jax" else {"device": "cpu"}
        pipe = rt.L7Pipeline(depth=2, **dev)
        pipe.profiler = prof
        plain = rt.L7Pipeline(depth=2, **dev)
        masks = pipe.submit(table, _l7_batch()).result()
        want = plain.submit(table, _l7_batch()).result()
        for m, w in zip(masks, want):
            np.testing.assert_array_equal(m, w)
        out[name] = (masks, prof.samples())
    for m, w in zip(out["torch"][0], out["jax"][0]):
        np.testing.assert_array_equal(m, w)
    (g,), (w,) = out["torch"][1], out["jax"][1]
    assert g["site"] == w["site"] == "l7" and g["batch"] == w["batch"] == 40
    assert g["notes"] == w["notes"]
    assert g["device_compute_ms"] > 0.0 and g["h2d_ms"] >= 0.0 and g["d2h_ms"] >= 0.0


def test_l7_gate_carries_the_profiler():
    """set_profiler before or after set_device_batch: the shared
    pipeline samples every Nth submit, and off again samples nothing."""
    prof = DeviceProfiler(sample_every=2)
    tl7rt.set_profiler(prof)
    tl7rt.set_device_batch(True, device="cpu")
    pipe = tl7rt.shared_pipeline()
    assert pipe.profiler is prof
    table = _tables([["/a"]])[1]
    n0 = tmetrics.profile_samples_total.get({"site": "l7"})
    for _ in range(4):
        pipe.submit(table, [([b"/a"] * 3, 16)]).result()
    assert len(prof.samples()) == 2
    assert tmetrics.profile_samples_total.get({"site": "l7"}) == n0 + 2
    tl7rt.set_profiler(None)
    assert pipe.profiler is None
    pipe.submit(table, [([b"/a"] * 3, 16)]).result()
    assert len(prof.samples()) == 2
    assert jmetrics.profile_samples_total is not tmetrics.profile_samples_total
