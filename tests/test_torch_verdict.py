"""Port parity: ops/verdict.py and the engine's full-refresh path.

The JAX engine compiles the world; its numpy CompiledPolicy and packed
sel_match are carried into the port by convert.py, and the same flows
(numpy, from a seed) go through both verdict_batch functions. Decision,
l3 class and redirect are integers/bools: equality is exact.
"""

from __future__ import annotations

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ops import verdict as jverdict
from cilium_tpu_torch.convert import device_policy_from_numpy
from cilium_tpu_torch.engine import PolicyEngine as TorchEngine
from cilium_tpu_torch.ops import verdict as tverdict
from test_torch_harness import build_world


def _flows(live_rows: np.ndarray, n: int, seed: int):
    rs = np.random.default_rng(seed)
    return (
        rs.choice(live_rows, n).astype(np.int32),
        rs.choice(live_rows, n).astype(np.int32),
        rs.choice(np.array([80, 443, 8080, 53, 22, 0], np.int32), n),
        rs.choice(np.array([6, 17], np.int32), n),
        rs.random(n) < 0.8,
    )


@pytest.mark.parametrize("ingress", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_verdict_batch_matches_jax(seed, ingress):
    w = build_world("cilium_tpu", seed)
    eng = JaxEngine(w.repo, w.reg)
    compiled, device = eng.snapshot()
    flows = _flows(np.nonzero(compiled.row_live)[0], 3000, seed)
    want = jverdict.verdict_batch(device, *(jnp.asarray(f) for f in flows),
                                  ingress=ingress, block=1024)
    port_policy = device_policy_from_numpy(
        compiled, device="cpu", sel_match=np.asarray(device.sel_match)
    )
    got = tverdict.verdict_batch(port_policy, *(torch.from_numpy(f) for f in flows),
                                 ingress=ingress, block=1024)
    np.testing.assert_array_equal(got.decision.numpy(), np.asarray(want.decision))
    np.testing.assert_array_equal(got.l3.numpy(), np.asarray(want.l3))
    np.testing.assert_array_equal(got.l7_redirect.numpy(), np.asarray(want.l7_redirect))
    # the world exercises allows and denies
    assert set(np.unique(got.decision.numpy())) == {1, 2}


@pytest.mark.parametrize("complement", [False, True])
def test_bool_mm_plain_matches_jax_mm(complement):
    rs = np.random.default_rng(5)
    x = (rs.random((37, 50)) < 0.3).astype(np.int8)
    w = rs.integers(-2, 3, (50, 19)).astype(np.int8)
    xj = jnp.int8(1) - jnp.asarray(x) if complement else jnp.asarray(x)
    want = np.asarray(jverdict._mm(xj, jnp.asarray(w)))
    got = tverdict.bool_mm(torch.from_numpy(x), torch.from_numpy(w), complement_x=complement)
    np.testing.assert_array_equal(got.numpy(), want)


def _chip_smoke():
    """chip_smoke.py at the repository root, for K2's edge-shape list."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _chip_smoke()
_EDGE_GROUPS = sorted({(b, 129 if c == 129 else 0) for b, _, c in _SMOKE.k2_edge_shapes()})


@pytest.mark.parametrize("complement", [False, True])
@pytest.mark.parametrize("group", _EDGE_GROUPS, ids=lambda g: f"b{g[0]}-{'c129' if g[1] else 'cvar'}")
def test_bool_mm_plain_matches_jax_mm_at_k2_edges(group, complement):
    """bool_mm_plain (the plain version chip_smoke holds K2 against on
    the card) equals JAX's _mm at every tile-edge shape of chip_smoke's
    K2 edge check, on the same seeded signed operands; one group of
    shapes a case."""
    shapes = [(i, (b, a, c)) for i, (b, a, c) in enumerate(_SMOKE.k2_edge_shapes())
              if (b, 129 if c == 129 else 0) == group]
    assert shapes
    for i, (b, a, c) in shapes:
        x, w = _SMOKE.k2_edge_operands(b, a, c, i)
        xj = jnp.int8(1) - jnp.asarray(x) if complement else jnp.asarray(x)
        want = np.asarray(jverdict._mm(xj, jnp.asarray(w)))
        got = tverdict.bool_mm(torch.from_numpy(x), torch.from_numpy(w), complement_x=complement)
        assert got.shape == (b, c) and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"[{b},{a}] x [{a},{c}]")


@pytest.mark.parametrize("seed", [0, 2])
def test_engine_verdicts_match_jax_engine(seed):
    wj = build_world("cilium_tpu", seed)
    wt = build_world("cilium_tpu_torch", seed)
    je = JaxEngine(wj.repo, wj.reg)
    te = TorchEngine(wt.repo, wt.reg, device="cpu")
    ids = [i.id for i in wj.idents] + [2]  # + reserved:world
    rs = np.random.default_rng(seed)
    n = 500
    subj = rs.choice(ids, n)
    peer = rs.choice(ids, n)
    dports = rs.choice(np.array([80, 443, 53, 22], np.int32), n)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    for ingress in (True, False):
        want = je.verdicts(subj, peer, dports, protos, ingress=ingress)
        got = te.verdicts(subj, peer, dports, protos, ingress=ingress)
        np.testing.assert_array_equal(got.decision.numpy(), np.asarray(want.decision))
        np.testing.assert_array_equal(got.l3.numpy(), np.asarray(want.l3))
        np.testing.assert_array_equal(got.l7_redirect.numpy(), np.asarray(want.l7_redirect))
    np.testing.assert_array_equal(
        te.device_policy.sel_match.numpy().view(np.uint32), np.asarray(je.device_policy.sel_match)
    )
    for k in range(5):
        assert te.verdict_one(int(subj[k]), int(peer[k]), int(dports[k]), int(protos[k])) == \
            je.verdict_one(int(subj[k]), int(peer[k]), int(dports[k]), int(protos[k]))
    np.testing.assert_array_equal(te.rows(ids), je.rows(ids))
    probe = np.array(ids + [0, 99999, 1 << 24], np.int64)
    np.testing.assert_array_equal(te.rows_or_negative(probe), je.rows_or_negative(probe))


def test_engine_refreshes_when_identities_or_rules_move():
    w = build_world("cilium_tpu_torch", 4)
    te = TorchEngine(w.repo, w.reg, device="cpu")
    first = te.refresh()
    assert te.refresh() is first  # nothing moved
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.api import EndpointSelector, IngressRule, rule

    dev0 = te.device_policy
    ident = w.reg.allocate(parse_label_array(["k8s:app=a1", "k8s:uid=new"]))
    moved = te.refresh()
    assert moved.identity_version == w.reg.version and ident.id in moved.id_to_row
    assert te.device_policy is not dev0  # the row update published new tensors
    w.repo.add_list([rule(["k8s:app=a1"], ingress=[IngressRule(
        from_endpoints=(EndpointSelector.make(["k8s:app=a2"]),))])])
    assert te.refresh().revision == w.repo.revision



@pytest.mark.parametrize("n_terms", [1, 2, 3])
@pytest.mark.parametrize("width", [1, 15, 16, 17, 640])
def test_first_rule_terms_plain_matches_single_calls_and_jax(n_terms, width):
    """K6's multi-term entry (one launch for a sweep block's deny,
    pure-L3 allow and L4 combo terms) on the CPU: each term's result
    equals a one-term first_rule call and JAX's reduction
    (cilium_tpu/ops/verdict.py:224 ``_first``, the min of ``rule_of``
    over the set cells, NO_RULE for none) on the same masks; all-zero
    rows and NO_RULE entries included."""
    rs = np.random.default_rng(width * 3 + n_terms)
    b = 203
    widths = [width, *rs.choice([1, 15, 16, 17, 640], n_terms - 1)]
    terms = []
    for w in widths:
        mask = rs.random((b, w)) < 0.02
        mask[7] = False
        rule_of = rs.integers(0, 10**6, w).astype(np.int32)
        rule_of[rs.random(w) < 0.3] = tverdict.NO_RULE
        terms.append((torch.from_numpy(mask), torch.from_numpy(rule_of)))
    got = tverdict.first_rule_terms(terms)
    assert len(got) == n_terms
    np.testing.assert_array_equal(
        np.stack([g.numpy() for g in tverdict.first_rule_terms_plain(terms)]),
        np.stack([g.numpy() for g in got]))
    for (mask, rule_of), g in zip(terms, got):
        assert g.dtype == torch.int32 and g.shape == (b,)
        want = jnp.min(jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(rule_of.numpy())[None, :],
                                 jnp.int32(tverdict.NO_RULE)), axis=1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tverdict.first_rule(mask, rule_of).numpy(), g.numpy())
        assert g[7] == tverdict.NO_RULE


def test_first_rule_terms_refuses_more_than_the_kernel_takes():
    mask = torch.zeros((4, 3), dtype=torch.bool)
    rule_of = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="terms"):
        tverdict.first_rule_terms([(mask, rule_of)] * 4)
    with pytest.raises(ValueError, match="terms"):
        tverdict.first_rule_terms([])
