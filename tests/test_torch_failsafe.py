"""Port parity: the failsafe — the fault hub, the classified retry and
quarantine around every batch, the ladder sharded → single-device →
host, the fail policy, the epoch swap under faults, the ladder under
placement and the device-CT rescue — against the JAX package.

Both packages build the same world (``test_torch_harness.build_world``
through ``test_torch_submit.Pair``) and see the same calls, and the same
fault schedule goes into each package's own ``faults.hub``. After each
step the verdicts, redirects, revNAT ids, per-endpoint counters,
``failsafe_state()``, the deltas of the failsafe's metrics and the
``on_journal`` event lists are equal, bit for bit. The reference's
tests are the bar: ``tests/test_failsafe.py`` ``TestFaultHub``,
``TestClassifiedSites``, ``TestLadder``, ``TestFailPolicy``,
``TestOffPathParity`` (outputs only: the port compiles no shapes),
``tests/test_policyd_delta.py::TestEpochSwapUnderFaults``,
``tests/test_placement.py::TestLadderPlacement`` and
``tests/test_survive.py::TestQuarantineRescue``.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port's
device seam (``placement.visible_devices``) gives it 8 CPU records with
the same ids, so both ladders exclude the same devices.

One named divergence: the quarantine's device-CT rescue pulls the
reference's slot C-1 junk (ROADMAP queue C) into the JAX host table;
the port's K10 leaves none. ``test_rescue_through_the_pipelines``
excludes exactly that entry.
"""

from __future__ import annotations

import importlib
import threading
import time
import types

import numpy as np
import pytest
import torch

from cilium_tpu import faults as jfaults
from cilium_tpu import metrics as jmetrics
from cilium_tpu_torch import _kernels
from cilium_tpu_torch import faults as tfaults
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.datapath import placement as tplace
from test_torch_harness import PKGS
from test_torch_submit import Pair

DROP_DEGRADED, FORWARD = tpipe.DROP_DEGRADED, tpipe.FORWARD
T, P = "transient", "poisoned"
SITES3 = ("h2d", "dispatch", "complete")
HUBS = (jfaults.hub, tfaults.hub)
# the metrics the failsafe moves, compared as deltas between packages
FAIL_METRICS = ("pipeline_faults_total", "degradations_total", "drop_reasons_total",
                "verdicts_total", "rule_hits_total", "ct_restored_entries_total")


@pytest.fixture(autouse=True)
def _clean_hubs_and_seam(monkeypatch):
    for h in HUBS:
        h.reset()
    monkeypatch.setattr(tplace, "visible_devices",
                        lambda: [tplace.DeviceRecord(i, 0, torch.device("cpu")) for i in range(8)])
    yield
    for h in HUBS:
        h.reset()


def fail(site: str, kind: str, times: int = 1, after: int = 0) -> None:
    """The same rule into both packages' hubs."""
    for h in HUBS:
        h.fail(site, kind, times=times, after=after)


def _snap(m):
    out = {name: dict(getattr(m, name).series()) for name in FAIL_METRICS}
    out["pipeline_mode"] = m.pipeline_mode.get()
    return out


def _delta(before, after):
    out = {}
    for name, series in after.items():
        if name == "pipeline_mode":
            out[name] = series
            continue
        d = {k: v - before[name].get(k, 0.0) for k, v in series.items()
             if v != before[name].get(k, 0.0)}
        if d:
            out[name] = d
    return out


class FS(Pair):
    """A Pair with both pipelines rebuilt, journals on lists, backoffs
    shrunk to 1 ms; ``run`` makes one call on both and compares."""

    def __init__(self, seed: int = 3, **kw):
        kw.setdefault("depth", 1)
        super().__init__(seed, **kw)
        self.events = {pkg: [] for pkg in PKGS}
        for pkg, p in self.pipes.items():
            p.on_journal = lambda out=self.events[pkg], **e: out.append(e)
            p.retry_min_s = p.retry_max_s = 0.001
            p.rebuild()
        self._base = (_snap(jmetrics), _snap(tmetrics))

    def knobs(self, **kw):
        for p in self.pipes.values():
            for k, v in kw.items():
                setattr(p, k, v)

    def run(self, fam: int, flows, **kw):
        call = "process" if fam == 4 else "process_v6"
        want = getattr(self.j, call)(*flows, **kw)
        got = getattr(self.t, call)(*flows, **kw)
        self.equal(got, tuple(np.asarray(x) for x in want))
        return got

    def agree(self, metrics: bool = True):
        """failsafe_state, counters, journals and (unless another pair
        ran one package alone meanwhile) metric deltas equal."""
        assert self.t.failsafe_state() == self.j.failsafe_state()
        np.testing.assert_array_equal(self.t.counters, self.j.counters)
        assert self.events[PKGS[1]] == self.events[PKGS[0]]
        if not metrics:
            return
        dj = _delta(self._base[0], _snap(jmetrics))
        dt = _delta(self._base[1], _snap(tmetrics))
        assert dt == dj

    def kinds(self):
        return [e["kind"] for e in self.events[PKGS[1]]]


# ---------------------------------------------------------------------------
class TestFaultHub:
    """The hub is a verbatim copy: the same rules give the same visits."""

    @staticmethod
    def _seq(hub, site, n=200):
        out = []
        for _ in range(n):
            try:
                hub.check(site)
                out.append(0)
            except jfaults.FaultError as e:
                out.append(1 if e.kind == T else 2)
            except tfaults.FaultError as e:
                out.append(1 if e.kind == T else 2)
        return out

    def test_fail_rule_after_times(self):
        for f in (jfaults, tfaults):
            hub = f.FaultHub()
            hub.fail("x", T, times=2, after=1)
            assert self._seq(hub, "x", 4) == [0, 1, 1, 0]
            assert hub.injected[("x", T)] == 2

    def test_poisoned_rule_kind(self):
        hub = tfaults.FaultHub()
        hub.fail("y", P)
        with pytest.raises(tfaults.PoisonedFault):
            hub.check("y")
        with pytest.raises(ValueError):
            hub.fail("y", "bogus")

    @pytest.mark.parametrize("seed", [7, 8])
    def test_probabilistic_sequences_match_jax(self, seed):
        """Same seed, same per-site sequence in both packages, kinds
        included; visits to another site move only the kinds."""
        seqs = []
        for f in (jfaults, tfaults):
            hub = f.FaultHub()
            hub.arm(seed=seed, rate=0.25, poison_every=3)
            seqs.append(self._seq(hub, "h2d"))
        assert seqs[1] == seqs[0] and 1 in seqs[1] and 2 in seqs[1]
        c = tfaults.FaultHub()
        c.arm(seed=seed, rate=0.25, poison_every=3)
        inter = []
        for _ in range(200):
            self._seq(c, "dispatch", 1)
            inter += self._seq(c, "h2d", 1)
        assert [min(x, 1) for x in inter] == [min(x, 1) for x in seqs[1]]

    def test_disable_keeps_rules_reset_drops(self):
        hub = tfaults.FaultHub()
        hub.fail("z")
        assert hub.active
        hub.disable()
        assert not hub.active
        hub.enable()
        with pytest.raises(tfaults.TransientFault):
            hub.check("z")
        hub.fail("z")
        hub.reset()
        assert not hub.active and hub.snapshot()["pending_rules"] == {}

    def test_classify_and_the_kernel_error(self):
        """classify is the reference's; the pipeline's _classify also
        calls a KernelError (a RuntimeError) an error."""
        cases = [TimeoutError(), ConnectionResetError(), OSError(), RuntimeError("x"),
                 Exception("?"), TypeError(), KeyError(), ValueError(), AssertionError(),
                 KeyboardInterrupt(), MemoryError()]
        for e in cases:
            assert tfaults.classify(e) == jfaults.classify(e)
            assert tpipe._classify(e) == tfaults.classify(e)
        assert tfaults.classify(tfaults.TransientFault("s")) == T
        assert tfaults.classify(tfaults.PoisonedFault("s")) == P
        err = _kernels.KernelError("nvcc failed")
        assert isinstance(err, RuntimeError) and tfaults.classify(err) == P
        assert tpipe._classify(err) == "error"

    def test_injection_counts_metric_once(self):
        before = [m.pipeline_faults_total.get({"site": "h2d", "kind": T})
                  for m in (jmetrics, tmetrics)]
        fail("h2d", T, times=3)
        for f in (jfaults, tfaults):
            for _ in range(3):
                with pytest.raises(f.TransientFault):
                    f.hub.check("h2d")
        after = [m.pipeline_faults_total.get({"site": "h2d", "kind": T})
                 for m in (jmetrics, tmetrics)]
        assert [a - b for a, b in zip(after, before)] == [3.0, 3.0]


# ---------------------------------------------------------------------------
class TestClassifiedSites:
    """Every pipeline site x {transient, poisoned}, v4 and v6."""

    @pytest.mark.parametrize("fam", [4, 6])
    @pytest.mark.parametrize("site", SITES3)
    def test_transient_is_invisible(self, site, fam):
        fs = FS()
        bt = fs.flows(fam, 96, 5)
        ref = fs.run(fam, bt)
        fail(site, T)
        got = fs.run(fam, bt)
        fs.equal(got, ref)
        assert fs.t.pipeline_mode == "sharded"
        assert fs.t.failsafe_state()["quarantined_batches"] == 0
        assert fs.t.failsafe_state()["breaker_faults"] == 1
        fs.agree()

    @pytest.mark.parametrize("fam", [4, 6])
    @pytest.mark.parametrize("site", SITES3)
    def test_poisoned_quarantines_fail_closed(self, site, fam):
        fs = FS()
        bt = fs.flows(fam, 96, 5)
        ref = fs.run(fam, bt)
        fail(site, P)
        v, r = fs.run(fam, bt)
        assert (v == DROP_DEGRADED).all() and not r.any()
        assert fs.t.failsafe_state()["quarantined_batches"] == 1
        assert fs.t.pipeline_mode == "sharded"  # one of three
        assert fs.kinds()[-1] == "quarantine"
        fs.equal(fs.run(fam, bt), ref)  # the next batch is healthy
        fs.agree()

    def test_transient_exhaustion_quarantines(self):
        fs = FS()
        bt = fs.flows(4, 96, 5)
        fs.run(4, bt)
        fail("complete", T, times=3)  # retry_limit 2: three attempts
        v, _ = fs.run(4, bt)
        assert (v == DROP_DEGRADED).all()
        assert fs.t.failsafe_state()["quarantined_batches"] == 1
        fs.agree()

    def test_submit_queue_quarantine_keeps_fifo(self):
        """Depth 2: a poisoned completion in the middle of three queued
        batches resolves that one degraded; its neighbours verdict."""
        fs = FS(depth=4)
        bts = [fs.flows(4, 128, 20 + i) for i in range(3)]
        want = [fs.run(4, b) for b in bts]
        fail("complete", P, after=1)
        hs = [fs.submit(4, b) for b in bts]
        got = [(h[0].result(), h[1].result()) for h in hs]
        for k, ((jv, jr), (tv, tr)) in enumerate(got):
            fs.equal((tv, tr), (jv, jr))
            if k == 1:
                assert (tv == DROP_DEGRADED).all()
            else:
                fs.equal((tv, tr), want[k])
        fs.agree()

    def test_ct_epoch_site_transient_and_poisoned(self):
        """The publishing rebuild's CT flush: a transient fault retries
        the whole rebuild (the flush still runs), a poisoned one
        quarantines the batch. Host CT pipelines."""
        fs = FS(ct=True)
        bt = fs.flows(4, 96, 5)
        sports = np.arange(96, dtype=np.int32) + 1024
        ref = fs.run(4, bt, sports=sports)
        epochs = [p._ct_epoch for p in (fs.j, fs.t)]
        for p, w in ((fs.j, fs.w[PKGS[0]]), (fs.t, fs.w[PKGS[1]])):
            p.ipcache.upsert("10.99.0.0/16", w.idents[0].id, source="k8s")
        fail("ct_epoch", T)
        fs.equal(fs.run(4, bt, sports=sports), ref)
        assert fs.t._ct_epoch > epochs[1] and fs.t._ct_epoch - epochs[1] == fs.j._ct_epoch - epochs[0]
        assert not fs.t._ct_flush_pending
        for p, w in ((fs.j, fs.w[PKGS[0]]), (fs.t, fs.w[PKGS[1]])):
            p.ipcache.upsert("10.98.0.0/16", w.idents[0].id, source="k8s")
        fail("ct_epoch", P)
        v, _ = fs.run(4, bt, sports=sports)
        assert (v == DROP_DEGRADED).all()
        # the flush the poisoned rebuild never reached runs on the next
        assert fs.t._ct_flush_pending
        fs.run(4, bt, sports=sports)
        assert not fs.t._ct_flush_pending
        fs.state_equal()
        fs.agree()

    def test_programmer_error_still_raises_raw(self):
        fs = FS()
        bt = fs.flows(4, 96, 5)
        fs.run(4, bt)
        for p in (fs.j, fs.t):
            with pytest.raises((TypeError, ValueError)):
                p.process(np.asarray(bt[0]), "not-an-array", bt[2], bt[3])
        assert fs.t.failsafe_state()["quarantined_batches"] == 0
        fs.agree()


def _fake_failed_library():
    """A loaded library whose every entry returns an error code."""
    lib = types.SimpleNamespace(cilium_error_string=lambda _e: b"invalid configuration argument")
    for k in _kernels.KERNELS.values():
        setattr(lib, k.symbol, lambda *_a: 9)
    return lib


@pytest.mark.parametrize("half", ["enqueue", "complete"])
@pytest.mark.parametrize("how", ["build", "launch"])
def test_kernel_error_reaches_the_caller_raw(monkeypatch, how, half):
    """A kernel that fails to build (nvcc) or to launch (the C entry's
    error code) raises KernelError out of process(), from either half of
    the batch; nothing is retried or quarantined, the breaker and the
    ladder do not move, and no fault is counted — five times over, past
    any breaker threshold."""
    fs = FS()
    fs.knobs(breaker_threshold=2)
    bt = fs.flows(4, 96, 5)
    ref = fs.run(4, bt)
    if how == "build":
        def nvcc_failed():
            raise _kernels.KernelError("nvcc failed:\nlpm_wide.cu: error")

        monkeypatch.setattr(_kernels, "build", nvcc_failed)
        monkeypatch.setattr(_kernels, "_lib", None)
        match = "nvcc failed"
    else:
        monkeypatch.setattr(_kernels, "_lib", _fake_failed_library())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda *_a: types.SimpleNamespace(cuda_stream=0))
        match = "failed to launch"

    def a_card_launch(*_a, **_k):
        # what a wrapper does with a tensor on the card
        _kernels.KERNELS["lpm_wide"].launch(torch.device("cuda", 0))

    if half == "enqueue":
        monkeypatch.setattr(tpipe, "lpm_lookup_wide", a_card_launch)
    else:
        monkeypatch.setattr(fs.t, "_dispatch_complete", a_card_launch)
    faults0 = dict(tmetrics.pipeline_faults_total.series())
    for _ in range(5):
        with pytest.raises(_kernels.KernelError, match=match):
            fs.t.process(*bt)
    st = fs.t.failsafe_state()
    assert (st["level"], st["quarantined_batches"], st["breaker_faults"]) == (0, 0, 0)
    assert dict(tmetrics.pipeline_faults_total.series()) == faults0
    assert fs.t.inflight_depth == 0
    monkeypatch.undo()
    fs.equal(fs.t.process(*bt), ref)


# ---------------------------------------------------------------------------
class TestLadder:
    def _trippy(self, **kw):
        fs = FS(**kw)
        fs.knobs(breaker_threshold=2, recover_after_clean=3)
        return fs

    @pytest.mark.parametrize("fam", [4, 6])
    def test_descend_and_repromote_full_ladder(self, monkeypatch, fam):
        """sharded (8 records) → single-device on two poisoned
        completions, → host on two poisoned dispatches, then clean
        streaks climb back one level each; verdicts equal at every
        level, the plan re-forms each way, and the host level calls no
        device walk."""
        fs = self._trippy(sharding=True)
        bt = fs.flows(fam, 96, 5)
        ref = fs.run(fam, bt)
        assert fs.t.placement_state()["devices"] == list(range(8))
        for _ in range(2):
            fail("complete", P)
            fs.run(fam, bt)
        assert fs.t.pipeline_mode == "single-device"
        assert tmetrics.pipeline_mode.get() == 1.0
        assert fs.t.failsafe_state()["excluded_devices"] == list(range(1, 8))
        fs.equal(fs.run(fam, bt), ref)
        assert fs.t._plan.mesh is None and fs.j._mesh is None
        fs.agree()

        for _ in range(2):
            fail("dispatch", P)
            fs.run(fam, bt)
        assert fs.t.pipeline_mode == "host"
        walks = []
        for name in ("process_flows_wide", "process_flows", "process_flows_ct"):
            real = getattr(tpipe, name)
            monkeypatch.setattr(tpipe, name,
                                lambda *a, _r=real, _n=name, **k: walks.append(_n) or _r(*a, **k))
        fs.equal(fs.run(fam, bt), ref)
        assert walks == []  # the host rung walks no device trie
        fs.agree()

        rounds = 0
        while fs.t.pipeline_mode != "sharded" and rounds < 32:
            fs.run(fam, bt)
            rounds += 1
        assert fs.t.pipeline_mode == "sharded" and fs.j.pipeline_mode == "sharded"
        assert fs.t.failsafe_state()["excluded_devices"] == []
        assert tmetrics.pipeline_mode.get() == 0.0
        fs.equal(fs.run(fam, bt), ref)
        assert walks  # the device path again
        assert fs.t._plan.mesh is not None and len(fs.t._plan.device_ids) == 8
        assert [e["kind"] for e in fs.events[PKGS[1]] if e["kind"] == "ladder_move"] == \
            ["ladder_move"] * 4
        fs.agree()

    def test_clean_streak_clears_breaker_without_descent(self):
        fs = self._trippy()
        bt = fs.flows(4, 96, 5)
        fs.run(4, bt)
        fail("complete", P)
        fs.run(4, bt)
        assert fs.t.failsafe_state()["breaker_faults"] == 1
        for _ in range(2):
            fs.run(4, bt)
        assert fs.t.failsafe_state()["breaker_faults"] == 0
        fail("complete", P)
        fs.run(4, bt)
        assert fs.t.pipeline_mode == "sharded"
        fs.agree()

    @pytest.mark.parametrize("fam", [4, 6])
    def test_host_mode_ct_world_parity(self, fam):
        """The host rung under a host-CT pipeline with a live deny set:
        the same verdicts as level 0 in both packages, entries created
        alike, and the device-CT gate is off at level 2."""
        deny = ("172.16.0.0/30", "fd00::1:0/126")
        fs = self._trippy(ct=True, deny=deny)
        bt = fs.flows(fam, 160, 9)
        sports = np.arange(160, dtype=np.int32) + 2048
        ref = fs.run(fam, bt, sports=sports)
        for p in (fs.j, fs.t):
            p.conntrack.flush()
            p._set_level(2)
        assert fs.t.pipeline_mode == "host"
        got = fs.run(fam, bt, sports=sports)
        fs.equal(got, ref)
        fs.run(fam, bt, sports=sports, ingress=False)  # egress: no prefilter on the rung
        fs.state_equal()
        fs.agree()

    @pytest.mark.parametrize("fam", [4, 6])
    def test_host_rung_with_attribution_decides_no_rule(self, fam):
        """Attribution on at level 2: the verdicts of level 0, no rule
        hit counted, the drops under their reasons, in both packages."""
        fs = self._trippy()
        for p in fs.pipes.values():
            p.set_attribution(True)
            p.rebuild()
        bt = fs.flows(fam, 200, 11)
        ref = fs.run(fam, bt)
        for p in fs.pipes.values():
            p._set_level(2)
        hits0 = dict(tmetrics.rule_hits_total.series())
        fs.equal(fs.run(fam, bt), ref)
        assert dict(tmetrics.rule_hits_total.series()) == hits0
        fs.agree()

    def test_device_ct_gate_off_at_the_host_level(self):
        """A device-CT pipeline at level 2 takes the host CT and the
        host rung for a batch with sports; back at level 0 the device
        CT serves again."""
        fs = self._trippy(device_ct_bits=10)
        bt = fs.flows(4, 128, 13)
        sports = np.arange(128, dtype=np.int32) + 4000
        ref = fs.run(4, bt, sports=sports)
        for p in fs.pipes.values():
            p._set_level(2)
        fs.equal(fs.run(4, bt, sports=sports), ref)
        assert len(fs.t.conntrack) == len(fs.j.conntrack) > 0
        for p in fs.pipes.values():
            p._set_level(0)
        fs.run(4, bt, sports=sports)
        assert fs.t._device_ct is not None
        fs.agree()


# ---------------------------------------------------------------------------
class TestFailPolicy:
    def test_reason_155_stable(self):
        from cilium_tpu.monitor.events import REASON_PIPELINE_DEGRADED
        from cilium_tpu_torch import contracts

        assert DROP_DEGRADED == 5
        assert contracts.WIRE_REASONS["REASON_PIPELINE_DEGRADED"] == REASON_PIPELINE_DEGRADED == 155

    def test_fail_closed_counts_reason_155(self):
        fs = FS()
        bt = fs.flows(4, 64, 5)
        fs.run(4, bt)
        before = tmetrics.drop_reasons_total.get({"reason": "pipeline-degraded"})
        dd = tmetrics.verdicts_total.get({"outcome": "dropped_degraded"})
        fail("complete", P)
        v, _ = fs.run(4, bt)
        assert (v == DROP_DEGRADED).all()
        assert tmetrics.drop_reasons_total.get({"reason": "pipeline-degraded"}) == before + 64
        assert tmetrics.verdicts_total.get({"outcome": "dropped_degraded"}) == dd + 64
        fs.agree()

    def test_fail_open_forwards(self):
        fs = FS()
        bt = fs.flows(4, 64, 5)
        fs.run(4, bt)
        for p in fs.pipes.values():
            p.set_fail_open(True)
        before = tmetrics.drop_reasons_total.get({"reason": "pipeline-degraded"})
        fail("complete", P)
        v, _ = fs.run(4, bt)
        assert (v == FORWARD).all()
        assert tmetrics.drop_reasons_total.get({"reason": "pipeline-degraded"}) == before
        assert fs.t.failsafe_state()["fail_open"]
        fs.agree()

    def test_degraded_batch_never_touches_rule_hits(self):
        fs = FS()
        for p in fs.pipes.values():
            p.set_attribution(True)
            p.rebuild()
        bt = fs.flows(4, 96, 5)
        fs.run(4, bt)
        hits = dict(tmetrics.rule_hits_total.series())
        fail("complete", P)
        v, _ = fs.run(4, bt)
        assert (v == DROP_DEGRADED).all()
        assert dict(tmetrics.rule_hits_total.series()) == hits
        fs.agree()

    @pytest.mark.parametrize("site", ["complete", "dispatch"])
    def test_degraded_result_preserves_rev_nat_shape(self, site):
        fs = FS(ct=True)
        bt = fs.flows(4, 48, 5)
        sports = np.arange(48, dtype=np.int32) + 1024
        fs.run(4, bt, sports=sports, return_rev_nat=True)
        fail(site, P)
        v, red, rev = fs.run(4, fs.flows(4, 48, 6), sports=sports, return_rev_nat=True)
        assert v.shape == red.shape == rev.shape == (48,) and rev.dtype == np.uint16
        assert (v == DROP_DEGRADED).all()
        fs.agree()


# ---------------------------------------------------------------------------
class TestOffPathParity:
    def test_off_path_bit_identical(self):
        """Hub off: a failsafe pipeline equals an untouched one and the
        JAX package, batch for batch, counters included."""
        assert not tfaults.hub.active
        a, b = FS(), FS()
        for i in range(6):
            bt = a.flows(4 if i % 2 == 0 else 6, 300, 70 + i)
            got = a.run(4 if i % 2 == 0 else 6, bt)
            fam = 4 if i % 2 == 0 else 6
            b.equal(getattr(b.t, "process" if fam == 4 else "process_v6")(*bt), got)
        np.testing.assert_array_equal(a.t.counters, b.t.counters)
        assert a.t.pipeline_mode == "sharded"
        assert a.t.failsafe_state()["excluded_devices"] == []
        a.agree(metrics=False)  # b ran the port alone

    @pytest.mark.parametrize("fam", [4, 6])
    def test_hub_enabled_but_quiet_is_transparent(self, fam):
        a, b = FS(), FS()
        bt = a.flows(fam, 300, 5)
        ref = a.run(fam, bt)
        for h in HUBS:
            h.enable()
        b.equal(b.run(fam, bt), ref)
        np.testing.assert_array_equal(a.t.counters, b.t.counters)
        assert b.t.failsafe_state()["fault_injection"]
        b.agree()

    def test_recovered_pipeline_matches_untouched(self):
        a = FS()
        a.knobs(breaker_threshold=2, recover_after_clean=2)
        b = FS()
        bt = a.flows(4, 96, 5)
        a.run(4, bt)
        for _ in range(4):
            fail("complete", P)
            a.run(4, bt)
        assert a.t.pipeline_mode == "host"
        rounds = 0
        while a.t.pipeline_mode != "sharded" and rounds < 32:
            a.run(4, bt)
            rounds += 1
        assert a.t.pipeline_mode == "sharded"
        for h in HUBS:
            h.reset()
        for seed in (81, 82):
            bt2 = a.flows(4, 200, seed)
            b.equal(a.run(4, bt2), b.run(4, bt2))
        a.agree()


# ---------------------------------------------------------------------------
class TestEpochSwapUnderFaults:
    def _swapped(self, seed):
        fs = FS(seed, epoch_swap=True)
        for e in fs.pipes.values():
            e.engine.refresh(force=True)
            e.rebuild()
        return fs

    def test_publish_ct_flush_transient_retries(self):
        fs = self._swapped(29)
        for p in fs.pipes.values():
            assert p.wait_epoch_swap(5) and p.policy_epoch == 1
        fail("ct_epoch", T)
        fs.run(4, fs.flows(4, 150, 1))
        assert fs.t.failsafe_state()["quarantined_batches"] == 0
        assert "epoch_swap" in fs.kinds()
        fs.agree()

    def test_publish_ct_flush_poisoned_fail_closed(self):
        fs = self._swapped(31)
        for p in fs.pipes.values():
            assert p.wait_epoch_swap(5) and p.policy_epoch == 1
        fail("ct_epoch", P)
        bt = fs.flows(4, 150, 2)
        v, r = fs.run(4, bt)
        assert v.shape == (150,) and (v == DROP_DEGRADED).all() and not r.any()
        assert fs.t.failsafe_state()["quarantined_batches"] == 1
        fs.run(4, fs.flows(4, 150, 3))  # healthy, on the new generation
        fs.agree()

    def test_complete_fault_during_pending_swap(self):
        fs = FS(43, epoch_swap=True)
        gates = {}
        for pkg, p in fs.pipes.items():
            real = p._build_mats
            gate = gates[pkg] = threading.Event()

            def held(*a, _r=real, _g=gate):
                assert _g.wait(5)
                return _r(*a)

            p._build_mats = held
        gen0 = {pkg: p._swap_gen for pkg, p in fs.pipes.items()}
        for p in fs.pipes.values():
            p.engine.refresh(force=True)
            p.rebuild()  # the shadow waits on its gate
        fail("complete", P)
        v, _ = fs.run(4, fs.flows(4, 120, 4))
        assert (v == DROP_DEGRADED).all()
        for pkg, p in fs.pipes.items():
            assert p._swap_gen > gen0[pkg]
            gates[pkg].set()
            assert p.wait_epoch_swap(5)
            assert p.policy_epoch == 0  # the abandoned epoch never installs
        for p in fs.pipes.values():
            p.rebuild()  # a fresh shadow from the current basis
            assert p.wait_epoch_swap(5) and p.policy_epoch == 1
        fs.run(4, fs.flows(4, 150, 5))  # its publish serves
        assert fs.kinds().count("epoch_swap") == 1
        fs.agree()


# ---------------------------------------------------------------------------
class TestLadderPlacement:
    def _trippy(self, **kw):
        fs = FS(sharding=True, **kw)
        fs.knobs(breaker_threshold=2, recover_after_clean=3)
        return fs

    def test_single_device_demotion_respects_placement(self):
        """The exclusion derives from the active plan: a pipeline placed
        on devices (2, 3, 4, 5) demotes onto device 2."""
        fs = self._trippy(placement=tplace.PlacementConfig(device_ids=(2, 3, 4, 5)))
        # the JAX pipeline takes its own package's config
        from cilium_tpu.datapath import placement as jplace

        fs.j._placement = jplace.PlacementConfig(device_ids=(2, 3, 4, 5))
        for p in fs.pipes.values():
            p.rebuild()
        assert fs.t.placement_state()["devices"] == [2, 3, 4, 5]
        assert fs.t.placement_state() == fs.j.placement_state()
        bt = fs.flows(4, 96, 5)
        ref = fs.run(4, bt)
        for _ in range(2):
            fail("complete", P)
            fs.run(4, bt)
        assert fs.t.pipeline_mode == "single-device"
        assert fs.t.placement_state()["excluded_devices"] == [3, 4, 5]
        fs.equal(fs.run(4, bt), ref)
        assert fs.t.placement_state()["devices"] == [2]
        assert fs.t.placement_state() == fs.j.placement_state()
        fs.agree()

    def test_ladder_reforms_2d_plan_and_rekeys_caches(self):
        fs = self._trippy(mesh_2d=True)
        assert fs.t._plan.is_2d
        gen0 = fs.t._plan.generation
        bt = fs.flows(4, 96, 5)
        ref = fs.run(4, bt)
        assert all(g == gen0 for g, _s, _p in fs.t._placed_pm.values())
        for _ in range(2):
            fail("complete", P)
            fs.run(4, bt)
        assert fs.t.pipeline_mode == "single-device"
        fs.equal(fs.run(4, bt), ref)
        assert fs.t._plan.generation > gen0 and not fs.t._plan.is_2d
        gen1 = fs.t._plan.generation
        assert all(g == gen1 for g, _s, _p in fs.t._placed_pm.values())
        rounds = 0
        while fs.t.pipeline_mode != "sharded" and rounds < 32:
            fs.run(4, bt)
            rounds += 1
        fs.equal(fs.run(4, bt), ref)
        assert fs.t._plan.is_2d and fs.t._plan.generation > gen1
        gen2 = fs.t._plan.generation
        assert all(g == gen2 for g, _s, _p in fs.t._placed_pm.values())
        assert fs.t.placement_state() == fs.j.placement_state()
        fs.agree()


# ---------------------------------------------------------------------------
class TestQuarantineRescue:
    @staticmethod
    def _host_keys(pkg, n=32):
        pack_keys = importlib.import_module(f"{pkg}.datapath.conntrack").pack_keys
        rng = np.random.default_rng(5)
        return pack_keys(
            np.zeros(n, np.uint64), rng.integers(1, 1 << 32, n, dtype=np.uint64),
            (np.arange(n) % 8).astype(np.uint64), (2000 + np.arange(n)).astype(np.uint64),
            np.full(n, 443, np.uint64), np.full(n, 6, np.uint64), np.zeros(n, np.uint64),
        )

    def test_device_words_roundtrip_host_keys(self):
        from cilium_tpu.datapath import device_ct as jdct
        from cilium_tpu_torch.datapath import device_ct as tdct

        ka, kb, kc = self._host_keys("cilium_tpu_torch")
        ttl = np.full(len(ka), 30.0)
        pulled = {}
        for pkg, mod, dev in (("j", jdct, {}), ("t", tdct, {"device": "cpu"})):
            state = mod.seed_state_from_host(ka, kb, kc, ttl, 10, now_s=1000, **dev)
            pulled[pkg] = mod.pull_live_entries(state, now_s=1000)
        got = set(zip(*(pulled["t"][k].tolist() for k in ("ka", "kb", "kc"))))
        assert got == set(zip(ka.tolist(), kb.tolist(), kc.tolist()))
        for k in ("ka", "kb", "kc", "ttl"):
            np.testing.assert_array_equal(pulled["t"][k], pulled["j"][k])

    def _shell(self, pkg):
        ct = importlib.import_module(f"{pkg}.datapath.conntrack").FlowConntrack
        return types.SimpleNamespace(conntrack=ct(capacity_bits=10), device_ct_rescue_limit=1 << 16,
                                     _lock=threading.Lock(), _device_ct_seed=False)

    @pytest.mark.parametrize("faulted", [False, True])
    def test_rescue_into_a_shell(self, faulted):
        """Both packages' _rescue_device_ct on a shell: the pull lands in
        the host table and arms the seed; an injected fault at the
        completion site skips it cold, never raising."""
        from cilium_tpu.datapath import device_ct as jdct
        from cilium_tpu.datapath.pipeline import DatapathPipeline as JPipe
        from cilium_tpu_torch.datapath import device_ct as tdct

        ka, kb, kc = self._host_keys("cilium_tpu_torch")
        now = int(time.monotonic())
        shells = []
        for pkg, mod, cls, dev in (("cilium_tpu", jdct, JPipe, {}),
                                   ("cilium_tpu_torch", tdct, tpipe.DatapathPipeline,
                                    {"device": "cpu"})):
            state = mod.seed_state_from_host(ka, kb, kc, np.full(len(ka), 30.0), 10, now_s=now,
                                             **dev)
            shell = self._shell(pkg)
            if faulted:
                fail("complete", T)
            out = cls._rescue_device_ct(shell, state)
            shells.append((shell, out))
        (js, jo), (ts, to) = shells
        assert to == jo
        assert len(ts.conntrack) == len(js.conntrack) == (0 if faulted else len(ka))
        assert ts._device_ct_seed is js._device_ct_seed is (not faulted)

    def test_rescue_through_the_pipelines(self, monkeypatch):
        """Device-CT pipelines (2^10 slots) fill K10 with a pass, then a
        poisoned completion on a batch without sports quarantines: the
        rescue pulls the live entries into the host CT — the same keys
        in both packages but for the JAX slot C-1 entry, the named
        reference fault — and the next device-CT pass seeds its table
        from the host CT, so the rescued flows come back established."""
        from test_torch_pipeline_device_ct import small_flows, small_world

        now = [50_000.25]
        monkeypatch.setattr(time, "monotonic", lambda: now[0])
        pipes, events = {}, {}
        for pkg in PKGS:
            pipes[pkg], _repo = small_world(pkg)
            events[pkg] = []
            pipes[pkg].on_journal = lambda out=events[pkg], **e: out.append(e)
        j, t = pipes[PKGS[0]], pipes[PKGS[1]]
        ips, eps, dports, protos, sports = small_flows(1000, 4)
        out = [p.process(ips, eps, dports, protos, sports=sports) for p in (j, t)]
        for a, b in zip(out[0], out[1]):
            np.testing.assert_array_equal(np.asarray(a), b)
        c = 1 << 10
        jstate = j._device_ct
        junk = None
        if int(np.asarray(jstate.exp)[c - 1]) > int(now[0]):
            junk = c - 1  # the reference fault: a live entry at slot C-1
        fail("complete", P)
        res = [p.process(ips[:50], eps[:50], dports[:50], protos[:50]) for p in (j, t)]
        for v, _r in res:
            assert (np.asarray(v) == DROP_DEGRADED).all()
        assert j._device_ct is None and t._device_ct is None
        assert t._device_ct_seed and j._device_ct_seed

        def keys(ct):
            snap = ct.snapshot_arrays()
            return set(zip(snap["ka"].tolist(), snap["kb"].tolist(), snap["kc"].tolist()))

        kj, kt = keys(j.conntrack), keys(t.conntrack)
        if junk is not None:
            words = [int(np.asarray(getattr(jstate, f))[junk]) & 0xFFFFFFFF
                     for f in ("ka_hi", "ka_lo", "kb_hi", "kb_lo", "kc_hi", "kc_lo")]
            jk = ((words[0] << 32) | words[1], (words[2] << 32) | words[3],
                  (words[4] << 32) | words[5])
            assert jk in kj and jk not in kt
            kj = kj - {jk}
        assert kt == kj and len(kt) > 0
        # the quarantine event: equal but for the junk entry's count
        (ej,), (et,) = ([e for e in events[pkg] if e["kind"] == "quarantine"] for pkg in PKGS)
        kept_j = ej["attrs"]["ct_rescue"]["kept"] - (junk is not None)
        assert et["attrs"]["ct_rescue"] == {"kept": kept_j,
                                            "expired": ej["attrs"]["ct_rescue"]["expired"]}
        assert {k: v for k, v in et["attrs"].items() if k != "ct_rescue"} == \
            {k: v for k, v in ej["attrs"].items() if k != "ct_rescue"}
        # the next device-CT pass seeds K10's table from the host CT
        est = []
        real = tpipe.ct_step_verdict

        def spy(*a, **k):
            r = real(*a, **k)
            est.append(r[3].cpu().numpy())
            return r

        monkeypatch.setattr(tpipe, "ct_step_verdict", spy)
        out2 = [p.process(ips, eps, dports, protos, sports=sports) for p in (j, t)]
        for a, b in zip(out2[0], out2[1]):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert not t._device_ct_seed and t._device_ct is not None
        # a lane is established exactly when its key was rescued (an
        # admitted flow whose insert lost its probe window never was)
        from cilium_tpu_torch.datapath.conntrack import pack_keys

        n = ips.shape[0]
        ka, kb, kc = pack_keys(np.zeros(n, np.uint64), ips.astype(np.uint64),
                               eps.astype(np.uint64), sports.astype(np.int64),
                               dports.astype(np.uint64), protos.astype(np.uint64),
                               np.zeros(n, np.uint64))
        rescued = np.array([k in kt for k in zip(ka.tolist(), kb.tolist(), kc.tolist())])
        assert rescued.any() and (out[1][0][rescued] == FORWARD).all()
        np.testing.assert_array_equal(est[0], rescued)
        assert t.failsafe_state()["quarantined_batches"] == 1
