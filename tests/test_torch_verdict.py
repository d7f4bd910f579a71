"""Port parity: ops/verdict.py and the engine's full-refresh path.

The JAX engine compiles the world; its numpy CompiledPolicy and packed
sel_match are carried into the port by convert.py, and the same flows
(numpy, from a seed) go through both verdict_batch functions. Decision,
l3 class and redirect are integers/bools: equality is exact.
"""

from __future__ import annotations

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

    w.reg.allocate(parse_label_array(["k8s:app=a1", "k8s:uid=new"]))
    assert te.refresh() is not first

