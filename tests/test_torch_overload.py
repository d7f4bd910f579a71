"""Port parity: the admission gate and the prefilter shed stage — the
reference's ``TestShedGate`` and ``TestOffPath`` (tests/test_overload.py)
run through both packages on the same world and calls.

- Under budget, a gated pipeline is bit-identical to an ungated one.
- A forced queue-full (``faults.hub.fail(SITE_QUEUE_FULL, ...)`` in each
  package) sheds the deny-for-sure lanes with DROP_PREFILTER and merges
  the kept lanes back, equal to the ungated run; no lane the full path
  forwards is shed; ``admission_shed_total{reason="prefilter"}`` and
  ``drop_reasons_total{reason="prefilter", producer="admission"}`` move
  by the shed count in both packages.
- A spent deadline resolves the rest DROP_DEGRADED, FORWARD under
  FailOpen. The clock is pinned (``time.monotonic`` patched for both
  packages' pipeline and admission modules) and steps 1 ms a read only
  inside the deferral, so no wall-clock bound is asserted.
- Off, tripwires prove that no gate code runs.

Where the reference asserts ``pipeline_mode == "sharded"`` (overload
must not move the ladder), so does the port, with its failsafe state
equal to the JAX pipeline's.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from cilium_tpu import faults as jfaults
from cilium_tpu import metrics as jmetrics
from cilium_tpu_torch import faults as tfaults
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.ops.lpm import ipv4_to_bytes
from test_torch_submit import Pair

DROP_DEGRADED, DROP_PREFILTER, FORWARD = tpipe.DROP_DEGRADED, tpipe.DROP_PREFILTER, tpipe.FORWARD
PREFILTER_ADMISSION = {"reason": "prefilter", "producer": "admission"}


@pytest.fixture(autouse=True)
def _clean_hubs():
    for f in (jfaults, tfaults):
        f.hub.reset()
    yield
    for f in (jfaults, tfaults):
        f.hub.reset()


@pytest.fixture
def clock(monkeypatch):
    """``time.monotonic`` pinned for both packages; ``clock.step`` > 0
    makes every read advance it by that many seconds."""

    class Clock:
        now = 10_000.0
        step = 0.0

        def __call__(self):
            self.now += self.step
            return self.now

    c = Clock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


def gated(**kw) -> Pair:
    """Both packages' pipelines with the overload options armed, rebuilt
    (the shed walk reads the tables of the last rebuild)."""
    pr = Pair(3, depth=2, admission=True, prefilter_shed=True, **kw)
    for p in (pr.j, pr.t):
        p.rebuild()
    return pr


def force_queue_full():
    for f in (jfaults, tfaults):
        f.hub.fail(f.SITE_QUEUE_FULL, f.KIND_TRANSIENT, times=1)


def shed_metrics():
    return {pkg: (m.admission_shed_total.get({"reason": "prefilter"}),
                  m.drop_reasons_total.get(PREFILTER_ADMISSION))
            for pkg, m in (("jax", jmetrics), ("port", tmetrics))}


# ---------------------------------------------------------------------------
class TestShedGate:
    def test_under_budget_bit_identical(self):
        gp, base = gated(), Pair(3, depth=2)
        for seed in (11, 12):
            bt = gp.flows(4, 128, seed)
            v = gp.t.process(*bt)
            gp.equal(v, base.t.process(*bt))
            gp.equal(v, gp.j.process(*bt))
        snap = gp.t.admission_state()
        assert snap["shed_ratio"] == 0.0 and snap["admitted_flows"] > 0
        assert snap["enabled"] and snap["prefilter"] and snap["watchdog"] is None
        assert set(snap) == set(gp.j.admission_state())

    @pytest.mark.parametrize("fam", [4, 6])
    def test_shed_walk_sound_against_full_path(self, fam):
        """No flow the full path forwards appears in the shed mask, and the
        port's mask equals JAX's (the table compile, the row mapping through
        the identity walk and the gather)."""
        gp, base = gated(), Pair(3, depth=2)
        peer, ep, dp, pr = bt = gp.flows(fam, 512, 21)
        v_b = (base.t.process if fam == 4 else base.t.process_v6)(*bt)[0]
        arg = ipv4_to_bytes(peer) if fam == 4 else peer
        mask = gp.t._shed_walk(arg, dp, pr, family=fam)
        assert mask is not None and mask.any()
        assert not np.any(mask & (v_b == FORWARD))
        np.testing.assert_array_equal(mask, np.asarray(gp.j._shed_walk(arg, dp, pr, family=fam)))
        if fam == 4:  # the gate passes the uint32 words as they are
            np.testing.assert_array_equal(gp.t._shed_walk(peer, dp, pr, family=4), mask)

    @pytest.mark.parametrize("fam", [4, 6])
    def test_forced_queue_full_sheds_and_merges(self, fam):
        """SITE_QUEUE_FULL forces the gate over budget: shed lanes carry
        DROP_PREFILTER and move the admission metrics by the shed count,
        kept lanes equal the unloaded run, in both packages alike."""
        gp, base = gated(), Pair(3, depth=2)
        peer, _ep, dp, pr = bt = gp.flows(fam, 128, 31)
        call = "process" if fam == 4 else "process_v6"
        v_b, _ = getattr(base.t, call)(*bt)
        mask = gp.t._shed_walk(peer, dp, pr, family=fam)
        assert mask.any() and not mask.all()  # a partial shed exercises the merge
        m0 = shed_metrics()
        limits0 = [p._admission.limit for p in (gp.j, gp.t)]
        force_queue_full()
        out = {pkg: getattr(p, call)(*bt) for pkg, p in (("jax", gp.j), ("port", gp.t))}
        gp.equal(out["port"], out["jax"])
        v, red = out["port"]
        n_shed = int(mask.sum())
        assert (v[mask] == DROP_PREFILTER).all()
        np.testing.assert_array_equal(v[~mask], v_b[~mask])
        assert not red[mask].any()
        m1 = shed_metrics()
        for pkg in m1:
            assert m1[pkg][0] - m0[pkg][0] == n_shed and m1[pkg][1] - m0[pkg][1] == n_shed, pkg
        # overload halved the limit; the kept part's completion regrew it
        # additively, so bound, not pin
        for limit0, p in zip(limits0, (gp.j, gp.t)):
            assert limit0 / 2.0 <= p._admission.limit < limit0
        assert gp.t._admission.limit == gp.j._admission.limit
        assert gp.t.pipeline_mode == gp.j.pipeline_mode == "sharded"
        assert gp.t.failsafe_state() == gp.j.failsafe_state()
        gp.state_equal()

    def test_gated_merge_with_rev_nat(self):
        gp = gated()
        bt = gp.flows(4, 96, 33)
        gp.equal(gp.t.process(*bt), gp.j.process(*bt))
        force_queue_full()
        jh, th = gp.submit(4, bt, return_rev_nat=True)
        out = th.result()
        assert len(out) == 3
        v, _red, rev = out
        assert v.shape[0] == bt[0].shape[0] and rev.dtype == np.uint16
        assert (v == DROP_PREFILTER).any() and not rev[v == DROP_PREFILTER].any()
        gp.equal(out, jh.result())

    def test_whole_batch_shed_is_resolved_without_queueing(self):
        """A batch whose every lane is deny-for-sure resolves at the gate:
        the handle is done and nothing enters the queue."""
        gp = gated()
        peer, ep, dp, pr = gp.flows(4, 512, 35)
        mask = gp.t._shed_walk(peer, dp, pr, family=4)
        bt = tuple(a[mask] for a in (peer, ep, dp, pr))
        force_queue_full()
        jh, th = gp.submit(4, bt)
        assert th.done and gp.t.inflight_depth == 0
        assert (th.result()[0] == DROP_PREFILTER).all()
        gp.equal(th.result(), jh.result())
        gp.state_equal()

    def test_deadline_deferral_fail_closed_then_open(self, clock, monkeypatch):
        """A spent deadline resolves the rest through the failsafe
        semantics: DROP_DEGRADED fail-closed, FORWARD under FailOpen —
        bounded by the budget on the pinned clock, never queued forever,
        never silently dropped."""
        gp = gated(deadline_ms=5.0)
        bt = gp.flows(4, 64, 41)
        gp.equal(gp.t.process(*bt), gp.j.process(*bt))  # warm
        p1 = gp.submit(4, bt)  # occupy the queue (an empty queue admits)
        calls = {"jax": 0, "port": 0}
        for pkg, p in (("jax", gp.j), ("port", gp.t)):
            p._admission._ewma_s = 10.0  # projection: nothing more can make it

            def pinned(pkg=pkg):
                # the queue depth is pinned: deferral must give up on the
                # budget, not on a conveniently fast completion
                calls[pkg] += 1
                return True

            monkeypatch.setattr(p, "_complete_oldest", pinned)
        r0 = {pkg: m.drop_reasons_total.get({"reason": "pipeline-degraded"})
              for pkg, m in (("jax", jmetrics), ("port", tmetrics))}
        clock.step = 0.001
        jh, th = gp.submit(4, bt)
        clock.step = 0.0
        v, _red = th.result()
        gp.equal((v, _red), jh.result())
        # the budget (5 ms at 1 ms a read) ended the wait, not the queue
        assert 1 <= calls["port"] <= 5
        shed = v == DROP_PREFILTER
        assert (v[~shed] == DROP_DEGRADED).all()
        n_deferred = int((~shed).sum())
        assert gp.t._admission.shed["deadline"] == gp.j._admission.shed["deadline"] == n_deferred
        for pkg, m in (("jax", jmetrics), ("port", tmetrics)):
            assert m.drop_reasons_total.get({"reason": "pipeline-degraded"}) - r0[pkg] == n_deferred
        for p in (gp.j, gp.t):
            p.set_fail_open(True)
        clock.step = 0.001
        jh, th = gp.submit(4, bt)
        clock.step = 0.0
        v2, _ = th.result()
        assert (v2[~shed] == FORWARD).all()
        gp.equal(th.result(), jh.result())
        for p in (gp.j, gp.t):
            p.set_fail_open(False)
        monkeypatch.undo()
        for h in p1:
            h.result()  # drain

    def test_shed_table_published_and_retracted(self):
        gp = gated()
        assert gp.t._shed_tab is not None and gp.j._dp_state[7] is not None
        for p in (gp.j, gp.t):
            p.set_prefilter_shed(False)
            p.rebuild()
        assert gp.t._shed_tab is None and gp.j._dp_state[7] is None
        args = (np.array([0x0A000001], np.uint32), np.array([80], np.int32),
                np.array([6], np.int32))
        assert gp.t._shed_walk(*args, family=4) is None
        assert gp.j._shed_walk(ipv4_to_bytes(args[0]), *args[1:], family=4) is None
        gp.t.set_prefilter_shed(True)
        gp.t.rebuild()  # no basis move: the table comes back all the same
        assert gp.t._shed_tab is not None

    def test_shed_guard_passes_injected_faults_and_raises_kernel_errors(self, monkeypatch):
        """The port's guard around the shed walk catches only the injected
        kind (a FaultError: the batch is admitted unshed, as in the
        reference); any other exception, such as a kernel that failed to
        build or launch, propagates instead of being hidden."""
        gp, base = gated(), Pair(3, depth=2)
        bt = gp.flows(4, 128, 51)

        def injected(*_a, **_k):
            raise tfaults.TransientFault(tfaults.SITE_QUEUE_FULL)

        monkeypatch.setattr(gp.t, "_shed_walk", injected)
        tfaults.hub.fail(tfaults.SITE_QUEUE_FULL, tfaults.KIND_TRANSIENT, times=1)
        gp.equal(gp.t.process(*bt), base.t.process(*bt))
        # the breaker counts it, the batch is not quarantined
        st = gp.t.failsafe_state()
        assert (st["breaker_faults"], st["quarantined_batches"], st["level"]) == (1, 0, 0)

        def kernel_failed(*_a, **_k):
            raise RuntimeError("CUDA kernel shed_walk_wide failed to launch")

        monkeypatch.setattr(gp.t, "_shed_walk", kernel_failed)
        tfaults.hub.fail(tfaults.SITE_QUEUE_FULL, tfaults.KIND_TRANSIENT, times=1)
        with pytest.raises(RuntimeError, match="shed_walk_wide"):
            gp.t.process(*bt)


# ---------------------------------------------------------------------------
class TestOffPath:
    def test_off_path_never_touches_gate_or_shed(self, monkeypatch):
        """Options toggled on and back off leave the exact pre-option
        submit path: tripwires on the gate, the shed walk and the table
        compile prove none of them runs."""
        a = Pair(3, depth=2)
        b = Pair(3, depth=2)
        p = b.t
        p.rebuild()
        p.set_admission(True)
        p.set_prefilter_shed(True)
        p.rebuild()
        assert p._shed_tab is not None
        p.set_admission(False)
        p.set_prefilter_shed(False)

        def boom(*_a, **_k):
            raise AssertionError("off path touched the admission code")

        monkeypatch.setattr(tpipe, "compile_shed_table", boom)
        p.rebuild()  # off: no shed compile
        assert p._shed_tab is None
        monkeypatch.setattr(p, "_admission_gate", boom)
        monkeypatch.setattr(p, "_shed_walk", boom)
        for seed in (51, 52):
            bt = a.flows(4, 160, seed)
            want = a.t.process(*bt)
            a.equal(p.process(*bt), want)
            a.equal(a.j.process(*bt), want)
        assert p.admission_state() == {"enabled": False, "prefilter": False, "queue_depth": 0,
                                       "deadline_ms": 0.0, "shed_ratio": 0.0, "watchdog": None}
