"""Port parity: the asynchronous entry point — ``submit`` / ``submit_v6``
and ``PendingBatch`` over the bounded in-flight queue — and the batch
metrics on every path.

Both packages build the same world and see the same calls in the same
order: the submits of a sequence, then the ``result()`` calls, at the
same ``pipeline_depth``. The JAX pipeline runs the same queue
(``pipeline.py`` ``_submit`` / ``_complete_oldest``), so the host-CT
pre-pass runs at enqueue and entries are created at completion in both:
a flow repeated in the next batch misses the CT in both alike. After
the sequence, verdicts, redirects, revNAT ids, the per-endpoint
counters, the live CT keys and the deltas of
``verdict_batches{path="pipeline"}`` / ``verdicts_total{outcome}`` must
be equal. The reference's ``TestPipelinedParity``
(tests/test_pipeline_async.py, without sharding, traces or the daemon)
runs here through both packages.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

from cilium_tpu import faults as jfaults
from cilium_tpu import metrics as jmetrics
from cilium_tpu_torch import faults as tfaults
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath import pipeline as tpipe
from test_torch_harness import PKGS, build_world, random_flows
from test_torch_pipeline_ct import _pack, _services, ct_equal, egress_flows
from test_torch_pipeline_v6 import add_v6, v6_flows

N_EPS = 6
B = 300


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _dev(pkg: str) -> dict:
    return {} if pkg == "cilium_tpu" else {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean_hubs():
    for hub in (jfaults.hub, tfaults.hub):
        hub.reset()
    yield
    for hub in (jfaults.hub, tfaults.hub):
        hub.reset()


class Pair:
    """One pipeline per package over the same world (with v6 peers and,
    with ``lb``, the same services), built with the same arguments."""

    def __init__(self, seed: int, *, depth: int = 2, ct: bool = False, lb: bool = False,
                 device_ct_bits=None, deny=(), **opts):
        self.w = {p: build_world(p, seed) for p in PKGS}
        self.peers6 = add_v6(self.w[PKGS[0]])
        assert add_v6(self.w[PKGS[1]]) == self.peers6
        self.lb, self.pipes = {}, {}
        for pkg, w in self.w.items():
            pf = _mod(pkg, "ipcache.prefilter").PreFilter()
            if deny:
                pf.insert(pf.revision, list(deny))
            ctab = _mod(pkg, "datapath.conntrack").FlowConntrack(capacity_bits=14) if ct else None
            self.lb[pkg] = _services(pkg, w, self.peers6, seed) if lb else None
            eng = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_dev(pkg))
            pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
                eng, w.ipcache, pf, ctab, self.lb[pkg], None, device_ct_bits,
                pipeline_depth=depth, **opts, **_dev(pkg))
            pipe.set_endpoints([(500 + 7 * k, i.id) for k, i in enumerate(w.idents[:N_EPS])])
            self.pipes[pkg] = pipe
        self.j, self.t = self.pipes[PKGS[0]], self.pipes[PKGS[1]]
        self.world = self.w[PKGS[0]]

    def flows(self, fam: int, n: int, seed: int):
        if fam == 4:
            return random_flows(self.world, n, N_EPS, seed)
        return v6_flows(self.peers6, n, seed)

    def submit(self, fam: int, flows, **kw):
        """The same submit on both → (jax handle, port handle); the
        in-flight depths stay equal and within the bound."""
        call = "submit" if fam == 4 else "submit_v6"
        out = tuple(getattr(p, call)(*flows, **kw) for p in (self.j, self.t))
        assert self.t.inflight_depth == self.j.inflight_depth <= self.t.pipeline_depth
        return out

    def equal(self, got, want):
        assert len(got) == len(want)
        for name, g, w_ in zip(("verdict", "redirect", "revnat"), got, want):
            assert g.dtype == w_.dtype, name
            np.testing.assert_array_equal(g, w_, err_msg=name)

    def state_equal(self):
        np.testing.assert_array_equal(self.t.counters, self.j.counters)
        ct_equal(self.t.conntrack, self.j.conntrack)


def metric_deltas(step):
    """Run ``step()`` → per package, the deltas of
    verdict_batches{path="pipeline"} and of every verdicts_total
    series it moved."""
    def snap(m):
        return (m.verdict_batches.get({"path": "pipeline"}), dict(m.verdicts_total.series()))

    before = {pkg: snap(m) for pkg, m in zip(PKGS, (jmetrics, tmetrics))}
    step()
    out = {}
    for pkg, m in zip(PKGS, (jmetrics, tmetrics)):
        nb, vt = snap(m)
        out[pkg] = (nb - before[pkg][0],
                    {k: v - before[pkg][1].get(k, 0.0) for k, v in vt.items()
                     if v != before[pkg][1].get(k, 0.0)})
    return out


# ---------------------------------------------------------------------------
class TestPipelinedParity:
    """The reference's TestPipelinedParity (tests/test_pipeline_async.py)
    through both packages at the same depth and call order."""

    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_depth_pipelined_matches_jax(self, depth):
        """N batches submitted back to back, then resolved in order, at the
        same depth in both packages; the port also equals its own depth-1
        run of the same batches."""
        pr = Pair(3, depth=depth)
        batches = [pr.flows(4, 384, 40 + i) for i in range(6)]
        pend = [pr.submit(4, b) for b in batches]
        got = [(h[0].result(), h[1].result()) for h in pend]
        assert pr.t.inflight_depth == pr.j.inflight_depth == 0
        for want, have in got:
            pr.equal(have, want)
        pr.state_equal()
        sync = Pair(3, depth=1)
        for b, (_w, have) in zip(batches, got):
            pr.equal(have, sync.t.process(*b))
        np.testing.assert_array_equal(pr.t.counters, sync.t.counters)

    @pytest.mark.parametrize("depth", [2, 4])
    def test_result_is_idempotent_and_fifo(self, depth):
        """Resolving the newest batch first completes the older ones (FIFO:
        counters land in submission order); result() again returns the
        same arrays."""
        pr = Pair(3, depth=depth)
        pend = [pr.submit(4, pr.flows(4, 256, 90 + i)) for i in range(3)]
        last = pend[-1][1].result()
        assert all(h[1].done for h in pend)
        pr.equal(pend[-1][1].result(), last)
        pr.equal(last, pend[-1][0].result())
        for jh, th in pend:
            pr.equal(th.result(), jh.result())
        pr.state_equal()

    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_ct_pipelined_matches_jax(self, depth):
        """The host-CT path at depth 1, 2 and 4 (CT creation deferred to the
        completion half), repeated flows included so later batches mix CT
        hits and misses: batch 0 again at the end, by when its allowed flows
        are established in both."""
        pr = Pair(3, depth=depth, ct=True)
        rng = np.random.default_rng(7)
        batches = [pr.flows(4, B, 60 + i) for i in range(5)]
        sports = [rng.integers(1024, 4096, B).astype(np.int32) for _ in batches]
        batches.append(batches[0])
        sports.append(sports[0])
        pend = [pr.submit(4, b, sports=sp) for b, sp in zip(batches, sports)]
        for jh, th in pend:
            pr.equal(th.result(), jh.result())
        pr.state_equal()
        assert len(pr.t.conntrack) == len(pr.j.conntrack) > 0

    def test_drain_completes_everything(self):
        pr = Pair(3, depth=8)
        pend = [pr.submit(4, pr.flows(4, 128, 70 + i)) for i in range(4)]
        assert pr.t.inflight_depth == 4
        assert pr.t.drain() == pr.j.drain() == {"completed": 4, "abandoned": 0}
        assert pr.t.inflight_depth == 0
        for jh, th in pend:
            assert th.done
            pr.equal(th.result(), jh.result())
        pr.state_equal()


def test_submit_v6_matches_jax():
    pr = Pair(1, depth=2, deny=("fd00::1:0/126",))
    pend = [pr.submit(6, pr.flows(6, B, 20 + i), ingress=bool(i % 2)) for i in range(4)]
    for jh, th in pend:
        pr.equal(th.result(), jh.result())
    pr.state_equal()


def test_egress_lb_batch_with_rev_nat_through_submit():
    """An egress batch through the LB stage and the host CT, submitted
    with return_rev_nat, then the replies from the backends: the revNAT
    ids come back through the handles."""
    pr = Pair(0, depth=2, ct=True, lb=True)
    stack = type("S", (), {"w": pr.w, "peers6": pr.peers6, "lb": pr.lb})()
    peer, ep, dp, proto, sp = egress_flows(stack, 4, B, 11)
    flows = (_pack(peer), ep, dp, proto)
    first = pr.submit(4, flows, ingress=False, sports=sp, return_rev_nat=True)
    again = pr.submit(4, flows, ingress=False, sports=sp, return_rev_nat=True)
    for jh, th in (first, again):
        out = th.result()
        assert len(out) == 3 and out[2].dtype == np.uint16
        pr.equal(out, jh.result())
    v1 = first[1].result()[0]
    assert (v1 == tpipe.DROP_NO_SERVICE).any() and (v1 == tpipe.FORWARD).any()
    pr.state_equal()


def test_device_ct_returns_a_done_handle(monkeypatch):
    """The device-CT path runs synchronously: submit() returns a handle
    that is already done, and nothing waits in the queue."""
    now = [50_000.25]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    pr = Pair(3, depth=2, device_ct_bits=10)
    flows = pr.flows(4, B, 5)
    sp = np.random.default_rng(5).integers(1024, 1100, B)
    for _ in range(2):
        jh, th = pr.submit(4, flows, sports=sp)
        assert th.done and jh.done
        assert pr.t.inflight_depth == 0
        pr.equal(th.result(), jh.result())
        now[0] += 1
    pr.state_equal()


def test_begin_drain_resolves_degraded_then_fail_open():
    pr = Pair(3, depth=2)
    flows = pr.flows(4, 64, 8)
    for p in (pr.j, pr.t):
        p.begin_drain()
    jh, th = pr.submit(4, flows, return_rev_nat=True)
    assert th.done
    out = th.result()
    assert (out[0] == tpipe.DROP_DEGRADED).all() and not out[1].any() and not out[2].any()
    pr.equal(out, jh.result())
    for p in (pr.j, pr.t):
        p.set_fail_open(True)
    jh, th = pr.submit(4, flows)
    assert (th.result()[0] == tpipe.FORWARD).all()
    pr.equal(th.result(), jh.result())
    for p in (pr.j, pr.t):
        p.end_drain()
    jh, th = pr.submit(4, flows)
    pr.equal(th.result(), jh.result())
    pr.state_equal()


def test_drain_with_spent_deadline_abandons_degraded():
    """drain(deadline_s=0) completes nothing and resolves every queued
    batch degraded, in both packages."""
    pr = Pair(3, depth=4)
    pend = [pr.submit(4, pr.flows(4, 64, 30 + i)) for i in range(3)]
    assert pr.t.drain(0.0) == pr.j.drain(0.0) == {"completed": 0, "abandoned": 3}
    for jh, th in pend:
        assert (th.result()[0] == tpipe.DROP_DEGRADED).all()
        pr.equal(th.result(), jh.result())


def test_finish_exception_is_raised_by_result():
    """An error in the completion half (a programmer error: the failsafe
    classifies a RuntimeError as a device fault and quarantines it)
    reaches result(), not the thread that happened to complete the
    batch."""
    pr = Pair(3, depth=4)
    h = pr.t.submit(*pr.flows(4, 64, 3))

    def boom(_enq):
        raise TypeError("pull failed")

    pr.t._dispatch_complete = boom
    later = pr.t.submit(*pr.flows(4, 64, 4))
    with pytest.raises(TypeError, match="pull failed"):
        later.result()
    assert h.done
    with pytest.raises(TypeError, match="pull failed"):
        h.result()
    assert pr.t.failsafe_state()["quarantined_batches"] == 0


def test_constructor_depth_bounds_and_alias():
    w = build_world("cilium_tpu_torch", 0)
    eng = _mod("cilium_tpu_torch", "engine").PolicyEngine(w.repo, w.reg, device="cpu")
    for depth, want in ((0, 1), (-3, 1), (3, 3), (10_000, 64)):
        pipe = tpipe.DatapathPipeline(eng, w.ipcache, pipeline_depth=depth, device="cpu")
        assert pipe.pipeline_depth == want
        assert pipe.pipeline_max_depth == max(want, 4)
    assert tpipe.process_ipv4 is tpipe.process_flows
    # the flow ring is ported: a ring passed in is the pipeline's, and
    # one is made when none is given
    ring = tpipe.FlowRing()
    assert tpipe.DatapathPipeline(eng, w.ipcache, device="cpu", flow_ring=ring).flow_ring is ring
    assert isinstance(tpipe.DatapathPipeline(eng, w.ipcache, device="cpu").flow_ring, tpipe.FlowRing)
    # the tracer, the tuner and the profiler are ported: taken as given
    tracer = tpipe.Tracer()
    pipe = tpipe.DatapathPipeline(eng, w.ipcache, device="cpu", tracer=tracer, autotune=True,
                                  profiling=True)
    assert pipe.tracer is tracer and pipe._tuner is not None and pipe.profiler is not None
    # placement is ported: the three arguments are taken as given
    pipe = tpipe.DatapathPipeline(eng, w.ipcache, device="cpu", sharding=True, mesh_2d=True,
                                  placement=tpipe.PlacementConfig(ident_axis=4))
    assert (pipe._sharding_requested, pipe._mesh2d_requested) == (True, True)
    assert pipe._placement == tpipe.PlacementConfig(ident_axis=4)


def test_batch_accounting_matches_jax(monkeypatch):
    """verdict_batches{path="pipeline"} and every verdicts_total{outcome}
    series move alike in both packages on every path: a v4 and a v6
    batch, a host-CT batch, a device-CT batch, an egress LB batch, a
    batch shed at the admission gate and a drained batch."""
    now = [50_000.25]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    pr = Pair(0, depth=2, ct=True, lb=True, admission=True, prefilter_shed=True)
    dct = Pair(0, depth=2, device_ct_bits=10)
    stack = type("S", (), {"w": pr.w, "peers6": pr.peers6, "lb": pr.lb})()
    sp = np.random.default_rng(2).integers(1024, 1100, B)

    def both(pair, fam, flows, **kw):
        def step():
            jh, th = pair.submit(fam, flows, **kw)
            pair.equal(th.result(), jh.result())
        return step

    def shed_step():
        for f in (jfaults, tfaults):
            f.hub.fail(f.SITE_QUEUE_FULL, f.KIND_TRANSIENT, times=1)
        jh, th = pr.submit(4, pr.flows(4, B, 31))
        v = th.result()[0]
        pr.equal((v, th.result()[1]), jh.result())
        assert (v == tpipe.DROP_PREFILTER).any() and (v != tpipe.DROP_PREFILTER).any()

    def drained_step():
        for p in (pr.j, pr.t):
            p.begin_drain()
        both(pr, 4, pr.flows(4, 64, 32))()
        for p in (pr.j, pr.t):
            p.end_drain()

    peer, ep, dp, proto, lsp = egress_flows(stack, 4, B, 11)
    steps = [
        ("v4", both(pr, 4, pr.flows(4, B, 1))),
        ("v6", both(pr, 6, pr.flows(6, B, 2))),
        ("host CT", both(pr, 4, pr.flows(4, B, 3), sports=sp)),
        ("host CT again", both(pr, 4, pr.flows(4, B, 3), sports=sp)),
        ("device CT", both(dct, 4, dct.flows(4, B, 4), sports=sp)),
        ("egress LB", both(pr, 4, (_pack(peer), ep, dp, proto), ingress=False, sports=lsp,
                           return_rev_nat=True)),
        ("shed", shed_step),
        ("drained", drained_step),
    ]
    for name, step in steps:
        d = metric_deltas(step)
        assert d[PKGS[1]] == d[PKGS[0]], name
        assert d[PKGS[0]][0] >= 1, name
    pr.state_equal()
    dct.state_equal()


def test_staging_is_reused_after_completion():
    """A batch's staging tuples leave their free-list at enqueue and come
    back only when it completes; the lists are capped."""
    pr = Pair(3, depth=64)
    flows = pr.flows(4, 300, 1)
    key = ("in", 4, 512)
    hs = [pr.t.submit(*flows) for _ in range(4)]
    assert not pr.t._staging.get(key)  # all four are in flight
    for h in hs:
        h.result()
    free = pr.t._staging[key]
    assert len(free) == 4
    held = set(map(id, free))
    pr.equal(pr.t.process(*flows), pr.j.process(*flows))
    assert set(map(id, pr.t._staging[key])) == held  # taken back, not made anew
    hs = [pr.t.submit(*flows) for _ in range(12)]
    for h in hs:
        h.result()
    assert len(pr.t._staging[key]) == pr.t._STAGING_FREE_CAP
