"""Port parity: ops/lookup.py — the policymap verdict.

The JAX materializer builds the policymap; convert.py carries its
arrays into the port. lookup_batch, and the pipeline tail that adds
the prefilter override and the per-endpoint counters, must return the
JAX values on the same flows (int8/bool/int32: equality is exact).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ops import lookup as jlookup
from cilium_tpu.ops.materialize import materialize_endpoints_state
from cilium_tpu_torch.convert import policymap_from_numpy
from cilium_tpu_torch.ops import lookup as tlookup
from test_torch_harness import build_world

N_EPS = 6


@pytest.fixture(scope="module", params=[0, 4])
def policymaps(request):
    w = build_world("cilium_tpu", request.param)
    compiled, device = JaxEngine(w.repo, w.reg).snapshot()
    eps = [i.id for i in w.idents[:N_EPS]]
    out = {}
    for ingress in (True, False):
        jt = materialize_endpoints_state(compiled, device, eps, ingress=ingress).tables
        tt = policymap_from_numpy(
            np.asarray(jt.col_ep), np.asarray(jt.col_port), np.asarray(jt.col_proto),
            np.asarray(jt.col_is_l3), np.asarray(jt.id_bits), device="cpu",
        )
        out[ingress] = (jt, tt)
    return compiled, out


def _flows(compiled, n: int, seed: int, ep_hi: int = N_EPS):
    rs = np.random.default_rng(seed)
    live = np.nonzero(compiled.row_live)[0]
    return (
        rs.integers(-1, ep_hi, n).astype(np.int32),  # -1 and ep_hi: no endpoint
        rs.choice(live, n).astype(np.int32),
        rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), n),
        rs.choice(np.array([6, 17], np.int32), n),
    )


@pytest.mark.parametrize("ingress", [True, False])
def test_lookup_batch_matches_jax(policymaps, ingress):
    compiled, maps = policymaps
    jt, tt = maps[ingress]
    ep, src, dp, pr = _flows(compiled, 5000, 1, ep_hi=N_EPS + 1)
    want_dec, want_red = jlookup.lookup_batch(
        jt, *(jnp.asarray(a) for a in (ep, src, dp, pr)), block=1024
    )
    got_dec, got_red = tlookup.lookup_batch(
        tt, *(torch.from_numpy(a) for a in (ep, src, dp, pr)), block=1024
    )
    np.testing.assert_array_equal(got_dec.numpy(), np.asarray(want_dec))
    np.testing.assert_array_equal(got_red.numpy(), np.asarray(want_red))
    assert (got_dec.numpy() == 1).any()


@pytest.mark.parametrize("ingress", [True, False])
@pytest.mark.parametrize("with_prefilter", [False, True])
def test_verdict_tail_matches_jax(policymaps, ingress, with_prefilter):
    """Prefilter override + counters, including flows whose endpoint
    index lies outside [0, EP) (they count nowhere)."""
    compiled, maps = policymaps
    jt, tt = maps[ingress]
    ep, src, dp, pr = _flows(compiled, 5000, 2, ep_hi=N_EPS + 1)
    denied = np.random.default_rng(3).random(ep.shape[0]) < (0.2 if with_prefilter else 0.0)
    want = jpipe._verdict_tail(
        jt, jnp.asarray(denied), jnp.asarray(src), jnp.asarray(ep), jnp.asarray(dp),
        jnp.asarray(pr), N_EPS, 1024,
    )
    got = tlookup.policymap_verdict(
        tt, *(torch.from_numpy(a) for a in (src, ep, dp, pr)),
        denied_pf=torch.from_numpy(denied) if with_prefilter else None,
        ep_count=N_EPS, block=1024,
    )
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert int(got[2].sum()) < ep.shape[0]  # out-of-range endpoints were not counted


def test_lookup_refuses_unported_options(policymaps):
    """``ident_gather=True`` is ported (it raised before): the
    contraction's row fetch == JAX's, rows outside [0, N) included."""
    compiled, maps = policymaps
    jt, tt = maps[True]
    ep, src, dp, pr = _flows(compiled, 3000, 5, ep_hi=N_EPS + 1)
    src[::97] = -1
    src[1::97] = compiled.id_bits.shape[0]
    want = jlookup.lookup_batch(jt, *(jnp.asarray(a) for a in (ep, src, dp, pr)), block=1024,
                                ident_gather=True)
    got = tlookup.lookup_batch(tt, *(torch.from_numpy(a) for a in (ep, src, dp, pr)),
                               block=1024, ident_gather=True)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


# -- out-of-range rows: the reference's take fill / wrap (ROADMAP queue C) ---

INT32_MIN = np.int32(-2**31)


@pytest.fixture(scope="module")
def attributed():
    """Ingress tables of a JAX materialization with attribution, its
    rule table, and the port's tables from the same arrays."""
    w = build_world("cilium_tpu", 4)
    eng = JaxEngine(w.repo, w.reg)
    compiled, device = eng.snapshot()
    origin, nr = eng.attribution(True)
    st = materialize_endpoints_state(compiled, device, [i.id for i in w.idents[:N_EPS]],
                                     ingress=True, attrib_origin=origin, n_rules=nr)
    jt = st.tables
    tt = policymap_from_numpy(
        np.asarray(jt.col_ep), np.asarray(jt.col_port), np.asarray(jt.col_proto),
        np.asarray(jt.col_is_l3), np.asarray(jt.id_bits), device="cpu")
    return compiled, jt, tt, np.array(st.rule_tab), nr


def _mixed_rows(compiled, n: int, seed: int):
    """Flows over live rows with -1, N and N + 7 mixed in (a quarter of
    the lanes), and which lanes are out of range."""
    ep, src, dp, pr = _flows(compiled, n, seed, ep_hi=N_EPS + 1)
    rows = compiled.id_bits.shape[0]
    bad = np.random.default_rng(seed + 1).random(n) < 0.25
    src = np.where(bad, np.array([-1, rows, rows + 7], np.int32)[np.arange(n) % 3], src)
    return (ep, src.astype(np.int32), dp, pr), bad


def _port_model(tt, rule_tab, src, rows_appended, rule_row):
    """The port's plain path on a table with one more row (``rows_appended``
    [1, 2W] and ``rule_row`` [1, C]) read by every lane of ``src``."""
    import dataclasses

    t2 = dataclasses.replace(tt, id_bits=torch.cat([tt.id_bits, torch.from_numpy(rows_appended)]))
    rt2 = torch.cat([torch.from_numpy(rule_tab), torch.from_numpy(rule_row)])
    return t2, rt2, torch.from_numpy(src)


@pytest.mark.parametrize("attrib", [False, True])
def test_out_of_range_rows_named_divergence(attributed, attrib):
    """The named divergence (ROADMAP queue C, fifth reference entry): on
    the direct lookup (ident_gather=False) a row outside [0, N) is
    ``jnp.take``'s business in JAX — a row past N reads the fill, all
    ones, so the flow is ALLOWED (and redirected) wherever a column
    covers it, with rule INT32_MIN; -1 wraps to row N - 1. The port
    reads no bits: DENY, no redirect, rule -1. Every in-range lane
    equals JAX, through lookup_batch and the verdict tail (prefilter
    override, counters, rule hits)."""
    compiled, jt, tt, rule_tab, nr = attributed
    n = compiled.id_bits.shape[0]
    (ep, src, dp, pr), bad = _mixed_rows(compiled, 3000, 11)
    denied = np.random.default_rng(12).random(src.shape[0]) < 0.1
    kw = dict(attrib=True, rule_tab=jnp.asarray(rule_tab)) if attrib else {}
    want = [np.asarray(x) for x in jlookup.lookup_batch(
        jt, *(jnp.asarray(a) for a in (ep, src, dp, pr)), block=1024, **kw)]
    got = [x.numpy() for x in tlookup.lookup_batch(
        tt, *(torch.from_numpy(a) for a in (ep, src, dp, pr)), block=1024,
        rule_tab=torch.from_numpy(rule_tab) if attrib else None, attrib=attrib)]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g[~bad], w_[~bad])

    # JAX's out-of-range lanes: -1 reads row N - 1, N and N + 7 the fill
    words = tt.id_bits.shape[1]
    ones = np.full((1, words), -1, np.int32)  # all-ones uint32 words
    fill = np.full((1, rule_tab.shape[1]), INT32_MIN, np.int32)
    t2, rt2, src_t = _port_model(tt, rule_tab, np.where(src == -1, n - 1, np.where(src >= n, n, src)),
                                 ones, fill)
    jax_model = [None if x is None else x.numpy() for x in tlookup.policymap_verdict_plain(
        t2, src_t, *(torch.from_numpy(a) for a in (ep, dp, pr)),
        rule_tab=rt2 if attrib else None, n_rules=nr)]
    keep = (0, 1, 3, 4) if attrib else (0, 1)
    for w_, m in zip(want, (jax_model[k] for k in keep)):
        np.testing.assert_array_equal(w_[bad], m[bad])
    past = src >= n
    assert (want[0][past] == 1).any() and (want[1][past]).any()
    if attrib:
        assert (want[2][past] == INT32_MIN).any()
    # the port's: no bits, so no allow, no redirect and no rule
    assert (got[0][bad] == 2).all() and not got[1][bad].any()
    if attrib:
        assert (got[2][bad] == -1).all()
        np.testing.assert_array_equal(got[3], want[3])  # coverage needs no row

    # the verdict tail: every in-range lane, and the counters / hits of
    # the in-range lanes alone
    jkw = dict(attrib=True, rule_tab=jnp.asarray(rule_tab), n_rules=nr) if attrib else {}
    tkw = dict(rule_tab=torch.from_numpy(rule_tab), n_rules=nr) if attrib else {}
    for lanes in (slice(None), ~bad):
        args = [a[lanes] for a in (denied, src, ep, dp, pr)]
        jw = [np.asarray(x) for x in jpipe._verdict_tail(
            jt, *(jnp.asarray(a) for a in args), N_EPS, 1024, **jkw)]
        tg = [x.numpy() for x in tlookup.policymap_verdict(
            tt, *(torch.from_numpy(a) for a in args[1:]), denied_pf=torch.from_numpy(args[0]),
            ep_count=N_EPS, block=1024, **tkw)]
        ok = ~bad[lanes]
        for k, (g, w_) in enumerate(zip(tg, jw)):
            if k in (2, 5):  # counters, rule hits: whole-batch sums
                if not isinstance(lanes, slice):
                    np.testing.assert_array_equal(g, w_)
            else:
                np.testing.assert_array_equal(g[ok], w_[ok])


def test_out_of_range_rows_gathered_equal_jax(attributed):
    """With ``ident_gather=True`` both packages read a row outside [0, N)
    as the one-hot contraction's zero row: every lane equals JAX, rule 0
    where a column covers the flow."""
    compiled, jt, tt, rule_tab, _nr = attributed
    (ep, src, dp, pr), bad = _mixed_rows(compiled, 3000, 13)
    want = [np.asarray(x) for x in jlookup.lookup_batch(
        jt, *(jnp.asarray(a) for a in (ep, src, dp, pr)), block=1024, attrib=True,
        rule_tab=jnp.asarray(rule_tab), ident_gather=True)]
    got = [x.numpy() for x in tlookup.lookup_batch(
        tt, *(torch.from_numpy(a) for a in (ep, src, dp, pr)), block=1024, attrib=True,
        rule_tab=torch.from_numpy(rule_tab), ident_gather=True)]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert (got[2][bad] == 0).any() and (got[0][bad] == 2).all()


def _shuffled(jt, rule_tab, perm):
    """The same policymap with its columns in the order ``perm``: the
    column metadata, the allow and redirect bits and the rule table."""
    bits = np.asarray(jt.id_bits)
    n, words = bits.shape
    w = words // 2
    un = ((bits[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(n, 2, w * 32)
    un = un[:, :, perm].reshape(n, words, 32).astype(np.uint64)
    packed = (un << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
    names = ("col_ep", "col_port", "col_proto", "col_is_l3")
    cols = [np.asarray(getattr(jt, f))[perm] for f in names]
    jt2 = jlookup.PolicymapTables(**{f: jnp.asarray(c) for f, c in zip(names, cols)},
                                  id_bits=jnp.asarray(packed))
    tt2 = policymap_from_numpy(*cols, packed, device="cpu")
    return jt2, tt2, rule_tab[:, perm]


@pytest.mark.parametrize("order", ["reversed", "random"])
def test_shuffled_columns_match_jax(attributed, order):
    """policymap_verdict_plain (the CPU path, and what the kernel's
    general path is held against on the card) on a policymap whose
    columns are not endpoint-major — the -1 padding among them — equals
    JAX lookup_batch with attribution, and the verdict tail."""
    compiled, jt, _tt, rule_tab, nr = attributed
    c = np.asarray(jt.col_ep).shape[0]
    perm = np.arange(c)[::-1] if order == "reversed" else np.random.default_rng(3).permutation(c)
    jt2, tt2, rt2 = _shuffled(jt, rule_tab, perm)
    assert (np.diff(np.asarray(jt2.col_ep).view(np.uint32).astype(np.int64)) < 0).any()
    ep, src, dp, pr = _flows(compiled, 4000, 14, ep_hi=N_EPS + 1)
    ep[::50] = -1
    dp[::50], pr[::50] = 0, 0  # -1 with port 0 / proto 0 selects the padding columns
    want = [np.asarray(x) for x in jlookup.lookup_batch(
        jt2, *(jnp.asarray(a) for a in (ep, src, dp, pr)), block=1024, attrib=True,
        rule_tab=jnp.asarray(rt2))]
    got = tlookup.policymap_verdict_plain(
        tt2, *(torch.from_numpy(a) for a in (src, ep, dp, pr)), ep_count=N_EPS,
        rule_tab=torch.from_numpy(rt2), n_rules=nr)
    for g, w_ in zip((got[0], got[1], got[3], got[4]), want):
        np.testing.assert_array_equal(g.numpy(), w_)
    assert (want[0] == 1).any() and (want[2] >= 0).any()
