"""Port parity: verdict attribution (FlowAttribution) on both families.

Every layer that carries attribution is held against the JAX package
on the same harness world (deny, L4 and L7 rules, so every ATTR_* reason
occurs): ``verdict_batch(attrib=True)`` (Verdict, Attribution, hits)
with the ``first_rule`` reductions, the engine's ``verdicts`` and
``explain_one``, the materializer's rule table, ``lookup_batch`` and
the step functions with attribution (rule, l4_covered, hits), and the
pipeline's ``rule_hits_total`` / ``drop_reasons_total`` deltas. All
outputs are integers and bools: equality is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu import metrics as jmetrics
from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ops import lookup as jlookup
from cilium_tpu.ops import materialize as jmat
from cilium_tpu.ops import verdict as jverdict
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.convert import device_policy_from_numpy, policymap_from_numpy
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.engine import PolicyEngine as TorchEngine
from cilium_tpu_torch.ops import lookup as tlookup
from cilium_tpu_torch.ops import materialize as tmat
from cilium_tpu_torch.ops import verdict as tverdict
from test_torch_harness import build_world, random_flows
from test_torch_pipeline_v6 import DENY4, DENY6, pipelines, v6_flows

N_EPS = 6


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: JAX buffers are read-only


@pytest.fixture(scope="module", params=[0, 4])
def engines(request):
    """The same world through both engines; the port's device policy
    is its own (computed on the CPU), its origin tables its own."""
    wj = build_world("cilium_tpu", request.param)
    wt = build_world("cilium_tpu_torch", request.param)
    return wj, JaxEngine(wj.repo, wj.reg), TorchEngine(wt.repo, wt.reg, device="cpu")


def _flows(live_rows: np.ndarray, n: int, seed: int):
    rs = np.random.default_rng(seed)
    return (
        rs.choice(live_rows, n).astype(np.int32),
        rs.choice(live_rows, n).astype(np.int32),
        rs.choice(np.array([80, 443, 8080, 53, 22, 0], np.int32), n),
        rs.choice(np.array([6, 17], np.int32), n),
        rs.random(n) < 0.8,
    )


def test_origin_tables_match_jax(engines):
    _w, je, te = engines
    for ingress in (True, False):
        (jo, jn), (to, tn) = je.attribution(ingress), te.attribution(ingress)
        assert jn == tn == len(te.repo.rules)
        for f in ("deny_rule", "allow_rule", "combo_rule"):
            np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)))
    assert te.attribution(True, expect_revision=-1) is None


@pytest.mark.parametrize("n_rules", ["all", 0])
@pytest.mark.parametrize("ingress", [True, False])
def test_verdict_batch_attrib_matches_jax(engines, ingress, n_rules):
    _w, je, te = engines
    compiled, device = je.snapshot()
    origin, nr = je.attribution(ingress)
    torigin, _ = te.attribution(ingress)
    nr = nr if n_rules == "all" else 0
    flows = _flows(np.nonzero(compiled.row_live)[0], 6000, 3)
    jv, ja, jh = jverdict.verdict_batch(device, *(jnp.asarray(a) for a in flows),
                                        ingress=ingress, block=1024, attrib=True,
                                        origin=origin, n_rules=nr)
    port = device_policy_from_numpy(compiled, device="cpu", sel_match=np.asarray(device.sel_match))
    tv, ta, th = tverdict.verdict_batch(port, *(_t(a) for a in flows), ingress=ingress,
                                        block=1024, attrib=True, origin=torigin, n_rules=nr)
    for f in ("decision", "l3", "l7_redirect"):
        np.testing.assert_array_equal(getattr(tv, f).numpy(), np.asarray(getattr(jv, f)))
    np.testing.assert_array_equal(ta.rule.numpy(), np.asarray(ja.rule))
    np.testing.assert_array_equal(ta.reason.numpy(), np.asarray(ja.reason))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.shape == (nr,)
    if ingress:  # the world's deny and L7 rules are ingress rules
        assert set(np.unique(ta.reason.numpy())) == set(tverdict.ATTR_NAMES)
    assert (ta.rule.numpy() >= 0).any() and (ta.rule.numpy() == -1).any()


def test_first_rule_plain_matches_the_jax_reduction():
    rs = np.random.default_rng(5)
    mask = rs.random((300, 77)) < 0.05
    rule_of = rs.integers(0, 500, 77).astype(np.int32)
    rule_of[rs.random(77) < 0.2] = tverdict.NO_RULE
    want = np.where(mask, rule_of[None, :], tverdict.NO_RULE).min(axis=1)
    np.testing.assert_array_equal(tverdict.first_rule(_t(mask), _t(rule_of)).numpy(), want)
    empty = tverdict.first_rule(torch.zeros((4, 0), dtype=torch.bool), torch.zeros(0, dtype=torch.int32))
    assert (empty.numpy() == tverdict.NO_RULE).all()


def test_engine_verdicts_and_explain_match_jax(engines):
    w, je, te = engines
    rs = np.random.default_rng(9)
    ids = [i.id for i in w.idents]
    subj = rs.choice(ids, 400)
    peer = rs.choice(ids, 400)
    dp = rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), 400)
    pr = np.where(dp == 53, 17, 6).astype(np.int32)
    for ingress in (True, False):
        jv, ja, jh = je.verdicts(subj, peer, dp, pr, ingress=ingress, attrib=True)
        tv, ta, th = te.verdicts(subj, peer, dp, pr, ingress=ingress, attrib=True)
        np.testing.assert_array_equal(tv.decision.numpy(), np.asarray(jv.decision))
        np.testing.assert_array_equal(ta.rule.numpy(), np.asarray(ja.rule))
        np.testing.assert_array_equal(ta.reason.numpy(), np.asarray(ja.reason))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for k in range(25):
        args = (int(subj[k]), int(peer[k]), int(dp[k]), int(pr[k]))
        for ingress, l4 in ((True, True), (False, True), (True, False)):
            assert te.explain_one(*args, ingress=ingress, l4=l4) == je.explain_one(
                *args, ingress=ingress, l4=l4)


@pytest.mark.parametrize("ingress", [True, False])
def test_materialize_rule_table_matches_jax(engines, ingress):
    w, je, te = engines
    compiled, device = je.snapshot()
    eps = [i.id for i in w.idents[:N_EPS]]
    origin, nr = je.attribution(ingress)
    jst = jmat.materialize_endpoints_state(compiled, device, eps, ingress=ingress,
                                           attrib_origin=origin, n_rules=nr)
    tc, tdev = te.snapshot()
    torigin, _ = te.attribution(ingress)
    tst = tmat.materialize_endpoints_state(tc, tdev, eps, ingress=ingress,
                                           attrib_origin=torigin, n_rules=nr)
    np.testing.assert_array_equal(tst.rule_nc, jst.rule_nc)
    np.testing.assert_array_equal(tst.rule_tab.numpy(), np.asarray(jst.rule_tab))
    np.testing.assert_array_equal(tst.allow_nc, jst.allow_nc)
    assert (tst.rule_nc[:, tst.n_cols:] == -1).all()  # padded columns
    assert (tst.rule_nc >= 0).any()
    plain = tmat.materialize_endpoints_state(tc, tdev, eps, ingress=ingress)
    assert plain.rule_nc is None and plain.rule_tab is None


@pytest.fixture(scope="module")
def attributed_policymaps(engines):
    w, je, _te = engines
    compiled, device = je.snapshot()
    eps = [i.id for i in w.idents[:N_EPS]]
    out = {}
    for ingress in (True, False):
        origin, nr = je.attribution(ingress)
        st = jmat.materialize_endpoints_state(compiled, device, eps, ingress=ingress,
                                              attrib_origin=origin, n_rules=nr)
        jt = st.tables
        tt = policymap_from_numpy(jt.col_ep, jt.col_port, jt.col_proto, jt.col_is_l3,
                                  jt.id_bits, device="cpu")
        out[ingress] = (jt, tt, st.rule_tab, nr)
    return compiled, out


@pytest.mark.parametrize("ingress", [True, False])
def test_lookup_batch_attrib_matches_jax(attributed_policymaps, ingress):
    compiled, maps = attributed_policymaps
    jt, tt, rule_tab, _nr = maps[ingress]
    rs = np.random.default_rng(2)
    n = 5000
    ep = rs.integers(-1, N_EPS + 1, n).astype(np.int32)
    src = rs.choice(np.nonzero(compiled.row_live)[0], n).astype(np.int32)
    dp = rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), n)
    pr = rs.choice(np.array([6, 17], np.int32), n)
    want = jlookup.lookup_batch(jt, *(jnp.asarray(a) for a in (ep, src, dp, pr)), block=1024,
                                attrib=True, rule_tab=rule_tab)
    got = tlookup.lookup_batch(tt, *(_t(a) for a in (ep, src, dp, pr)), block=1024,
                               attrib=True, rule_tab=_t(np.asarray(rule_tab)))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    rule, l4x = got[2].numpy(), got[3].numpy()
    assert (rule >= 0).any() and (rule == -1).any() and l4x.any() and not l4x.all()


@pytest.mark.parametrize("with_prefilter", [False, True])
@pytest.mark.parametrize("ingress", [True, False])
def test_verdict_tail_attrib_matches_jax(attributed_policymaps, ingress, with_prefilter):
    """Rule masked to -1 for prefilter drops before the hits count; the
    [max(n_rules, 1)] hit shape of the pipeline tail."""
    compiled, maps = attributed_policymaps
    jt, tt, rule_tab, nr = maps[ingress]
    rs = np.random.default_rng(4)
    n = 5000
    ep = rs.integers(-1, N_EPS + 1, n).astype(np.int32)
    src = rs.choice(np.nonzero(compiled.row_live)[0], n).astype(np.int32)
    dp = rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), n)
    pr = rs.choice(np.array([6, 17], np.int32), n)
    denied = rs.random(n) < (0.2 if with_prefilter else 0.0)
    want = jpipe._verdict_tail(jt, jnp.asarray(denied), jnp.asarray(src), jnp.asarray(ep),
                               jnp.asarray(dp), jnp.asarray(pr), N_EPS, 1024, attrib=True,
                               rule_tab=rule_tab, n_rules=nr)
    got = tpipe._verdict_tail(tt, _t(denied) if with_prefilter else None, _t(src), _t(ep),
                              _t(dp), _t(pr), N_EPS, 1024, attrib=True,
                              rule_tab=_t(np.asarray(rule_tab)), n_rules=nr)
    assert len(got) == len(want) == 6
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[5].shape == (max(nr, 1),)
    if with_prefilter:
        assert (got[3].numpy()[denied] == -1).all()


def test_rule_hits_of_no_rules_is_one_cell():
    """n_rules = 0: the pipeline tail's hit vector keeps one cell."""
    rule = torch.tensor([-1, 0, 3, -1], dtype=torch.int32)
    assert tverdict.rule_hits(rule, 0).tolist() == [2]
    assert tverdict.rule_hits(rule, 2).tolist() == [1, 1]  # 3 clips to the last rule


@pytest.mark.parametrize("family", [4, 6])
@pytest.mark.parametrize("prefilter", [False, True])
def test_step_functions_attrib_match_jax(family, prefilter):
    """process_flows_wide (v4) / process_flows (v6) with attribution on
    the JAX pipeline's tables and rule table."""
    wj, peers, pj, pt = pipelines(4, tuple(DENY4 + DENY6) if prefilter else ())
    pj.set_attribution(True)
    pt.set_attribution(True)
    pj.rebuild()
    pt.rebuild()
    jt = pj._tables[(jpipe.TRAFFIC_INGRESS, family)]
    tt = pt._tables[(tpipe.TRAFFIC_INGRESS, family)]
    jrt = pj._dp_state[5][0][jpipe.TRAFFIC_INGRESS]
    trt = pt._rule_tabs[tpipe.TRAFFIC_INGRESS]
    np.testing.assert_array_equal(trt.numpy(), np.asarray(jrt))
    nr = pt._attrib_n_rules
    assert nr == pj._attrib_n_rules == len(wj.repo.rules)
    if family == 4:
        peer, ep, dp, pr = random_flows(wj, 4000, N_EPS, 21)
        want = jpipe.process_flows_wide(
            jt, jnp.asarray(peer), jnp.asarray(ep), jnp.asarray(dp), jnp.asarray(pr),
            ep_count=N_EPS, prefilter=prefilter, attrib=True, rule_tab=jrt, n_rules=nr)
        got = tpipe.process_flows_wide(
            tt, _t(peer.view(np.int32)), _t(ep), _t(dp), _t(pr), ep_count=N_EPS,
            prefilter=prefilter, attrib=True, rule_tab=trt, n_rules=nr)
    else:
        addr, ep, dp, pr = v6_flows(peers, 4000, 22)
        kw = dict(ep_count=N_EPS, levels=16, prefilter=prefilter, fused=pt._v6_fused,
                  attrib=True, n_rules=nr)
        want = jpipe.process_flows(jt, jnp.asarray(addr), jnp.asarray(ep), jnp.asarray(dp),
                                   jnp.asarray(pr), rule_tab=jrt, **kw)
        got = tpipe.process_flows(tt, _t(addr), _t(ep), _t(dp), _t(pr), rule_tab=trt, **kw)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (got[3].numpy() >= 0).any() and got[5].numpy().sum() > 0


def _series(m):
    return {(mt.name, k): v for mt in (m.rule_hits_total, m.drop_reasons_total)
            for k, v in mt.series().items()}


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


@pytest.mark.parametrize("seed", [0, 4])
def test_pipeline_attribution_metrics_match_jax(seed):
    """set_attribution(True) → process / process_v6, both directions,
    with a live deny set: the ported rule_hits_total and
    drop_reasons_total move by the JAX pipeline's amounts; verdicts and
    counters stay equal."""
    wj, peers, pj, pt = pipelines(seed, tuple(DENY4 + DENY6))
    for pipe in (pj, pt):
        pipe.set_attribution(True)
    jb, tb = _series(jmetrics), _series(tmetrics)
    for k, ingress in enumerate((True, False, True)):
        f4 = random_flows(wj, 2000, N_EPS, seed * 10 + k)
        f6 = v6_flows(peers, 2000, seed * 10 + k + 5)
        for call, flows in (("process", f4), ("process_v6", f6)):
            vj, rj = getattr(pj, call)(*flows, ingress=ingress)
            vt, rt = getattr(pt, call)(*flows, ingress=ingress)
            np.testing.assert_array_equal(vt, vj)
            np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(pt.counters, pj.counters)
    jd, td = _delta(jb, _series(jmetrics)), _delta(tb, _series(tmetrics))
    assert td == jd
    reasons = {dict(k[1])["reason"] for k in td if k[0].endswith("drop_reasons_total")}
    assert {"prefilter", "no-l3-match"} <= reasons
    assert any(k[0].endswith("rule_hits_total") for k in td)


def test_account_attribution_host_bincount_fallback():
    """hits=None: the rule-hit sums come from a host bincount of the
    rule array, as in the JAX pipeline."""
    wj, _peers, pj, pt = pipelines(0)
    for pipe in (pj, pt):
        pipe.set_attribution(True)
        pipe.process(*random_flows(wj, 10, N_EPS, 1))
    rs = np.random.default_rng(3)
    n = 500
    verdict = rs.choice(np.array([1, 2, 3, 4, 5], np.int8), n)
    rule = np.where(rs.random(n) < 0.6, rs.integers(0, len(wj.repo.rules), n), -1).astype(np.int32)
    l4x = rs.random(n) < 0.5
    jb, tb = _series(jmetrics), _series(tmetrics)
    pj._account_attribution(verdict, rule, l4x, None, ingress=False)
    pt._account_attribution(verdict, rule, l4x, None, ingress=False)
    td = _delta(tb, _series(tmetrics))
    assert td == _delta(jb, _series(jmetrics))
    reasons = {dict(k[1])["reason"] for k in td if k[0].endswith("drop_reasons_total")}
    assert reasons == {"deny-rule", "no-l4-match", "no-l3-match", "prefilter", "no-service",
                       "pipeline-degraded"}


def test_attribution_off_returns_to_the_plain_path(monkeypatch):
    """Switching attribution off drops the rule table: the next batch
    runs the plain policymap path and moves no attribution metric."""
    wj, _peers, _pj, pt = pipelines(0)
    flows = random_flows(wj, 800, N_EPS, 6)
    plain = pt.process(*flows)
    pt.set_attribution(True)
    on = pt.process(*flows)
    assert pt._rule_tabs is not None
    pt.set_attribution(False)
    seen = []
    real = tpipe.policymap_verdict

    def spy(*args, **kw):
        seen.append(kw.get("rule_tab"))
        return real(*args, **kw)

    monkeypatch.setattr(tpipe, "policymap_verdict", spy)
    before = _series(tmetrics)
    off = pt.process(*flows)
    assert pt._rule_tabs is None and pt._attrib_n_rules == 0 and seen == [None]
    assert _series(tmetrics) == before
    for a, b, c in zip(plain, on, off):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
