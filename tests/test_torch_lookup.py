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
