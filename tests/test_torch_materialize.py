"""Port parity: ops/materialize.py — the policymap sweep.

Both routes of the port ("auto", the identity-major matrix sweep on
bool_mm, and "flow", the per-flow sweep through verdict_batch) are
held bit for bit against the JAX materializer on the same compiled
world, and against each other. Every output is packed words, bools or
ints: equality is exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ops import materialize as jmat
from cilium_tpu_torch.convert import device_policy_from_numpy
from cilium_tpu_torch.ops import materialize as tmat
from test_torch_harness import build_world


def _state_arrays(st):
    t = st.tables
    return {
        "col_ep": np.asarray(t.col_ep),
        "col_port": np.asarray(t.col_port),
        "col_proto": np.asarray(t.col_proto),
        "col_is_l3": np.asarray(t.col_is_l3),
        "id_bits": np.asarray(t.id_bits).view(np.uint32),
        "allow_nc": st.allow_nc,
        "red_nc": st.red_nc,
        "ep_rows": st.ep_rows,
    }


def _assert_same_state(got, want):
    ga, wa = _state_arrays(got), _state_arrays(want)
    for k in wa:
        np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
    assert got.n_cols == want.n_cols
    assert got.ep_slots == want.ep_slots
    assert len(got.snapshots) == len(want.snapshots)
    for gs, ws in zip(got.snapshots, want.snapshots):
        assert gs.slots == ws.slots
        assert {(k.identity, k.dport, k.nexthdr, k.direction): v for k, v in gs.entries.items()} == \
            {(k.identity, k.dport, k.nexthdr, k.direction): v for k, v in ws.entries.items()}


@pytest.fixture(scope="module", params=[0, 4])
def compiled_world(request):
    w = build_world("cilium_tpu", request.param)
    eng = JaxEngine(w.repo, w.reg)
    compiled, device = eng.snapshot()
    port = device_policy_from_numpy(compiled, device="cpu", sel_match=np.asarray(device.sel_match))
    return w, compiled, device, port


@pytest.mark.parametrize("ingress", [True, False])
@pytest.mark.parametrize("sweep", ["auto", "flow"])
def test_materialize_matches_jax(compiled_world, ingress, sweep):
    w, compiled, device, port = compiled_world
    eps = [i.id for i in w.idents[:8]]
    want = jmat.materialize_endpoints_state(compiled, device, eps, ingress=ingress, sweep=sweep)
    got = tmat.materialize_endpoints_state(compiled, port, eps, ingress=ingress, sweep=sweep,
                                           block=512)
    _assert_same_state(got, want)
    assert got.allow_nc.any()


@pytest.mark.parametrize("ingress", [True, False])
def test_auto_and_flow_sweeps_agree(compiled_world, ingress):
    """The matrix sweep against the per-flow sweep, word for word, with
    several identity blocks and segment chunks in play."""
    w, compiled, _device, port = compiled_world
    n = compiled.id_bits.shape[0]
    rs = np.random.default_rng(9)
    live = np.nonzero(compiled.row_live)[0]
    g = 21
    sr = rs.choice(live, g).astype(np.int32)
    sp = rs.choice(np.array([0, 80, 443, 53, 8080], np.int32), g)
    spr = np.where(sp == 53, 17, 6).astype(np.int32)
    sl = sp > 0
    old = tmat._MATRIX_NBLOCK
    tmat._MATRIX_NBLOCK = 48  # several ragged identity blocks
    try:
        auto = tmat._sweep_segments(port, sr, sp, spr, sl, n, ingress=ingress, block=256,
                                    sweep="auto")
    finally:
        tmat._MATRIX_NBLOCK = old
    flow = tmat._sweep_segments(port, sr, sp, spr, sl, n, ingress=ingress, block=256,
                                sweep="flow")
    for a, f in zip(auto, flow):
        np.testing.assert_array_equal(a, f)
    assert auto[0].any()


def test_unknown_sweep_is_refused(compiled_world):
    _w, compiled, _device, port = compiled_world
    with pytest.raises(ValueError):
        tmat._sweep_segments(port, np.zeros(1, np.int32), np.zeros(1, np.int32),
                             np.zeros(1, np.int32), np.zeros(1, bool),
                             compiled.id_bits.shape[0], ingress=True, block=64, sweep="bogus")
