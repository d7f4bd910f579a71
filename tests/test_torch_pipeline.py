"""Port parity: the datapath pipeline end to end.

The same world is built through each package; both DatapathPipelines
process the same numpy flows, in both directions, with and without a
prefilter. Verdicts, redirects and the accumulated per-endpoint
counters must be equal (integers: equality is exact). The wide-tables
step function is also held against the JAX one with a row_override.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ipcache.prefilter import PreFilter as JaxPreFilter
from cilium_tpu_torch.convert import policymap_from_numpy, wide_tables_from_numpy
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.engine import PolicyEngine as TorchEngine
from cilium_tpu_torch.ipcache.prefilter import PreFilter as TorchPreFilter
from test_torch_harness import build_world, random_flows

N_EPS = 6
DENY = ["172.16.0.0/28", "10.1.0.0/16", "8.8.0.0/16"]


def _pipelines(seed: int, prefilter: bool):
    wj = build_world("cilium_tpu", seed)
    wt = build_world("cilium_tpu_torch", seed)
    pfj, pft = JaxPreFilter(), TorchPreFilter()
    if prefilter:
        for pf in (pfj, pft):
            pf.insert(pf.revision, DENY)
    pj = jpipe.DatapathPipeline(JaxEngine(wj.repo, wj.reg), wj.ipcache, pfj)
    pt = tpipe.DatapathPipeline(TorchEngine(wt.repo, wt.reg, device="cpu"), wt.ipcache, pft,
                                device="cpu")
    eps = [i.id for i in wj.idents[:N_EPS]]
    pj.set_endpoints(eps)
    pt.set_endpoints(eps)
    return wj, pj, pt


@pytest.mark.parametrize("prefilter", [False, True])
@pytest.mark.parametrize("seed", [0, 4])
def test_process_matches_jax(seed, prefilter):
    wj, pj, pt = _pipelines(seed, prefilter)
    for k, ingress in enumerate((True, False, True)):
        flows = random_flows(wj, 3000, N_EPS, seed * 10 + k)
        vj, rj = pj.process(*flows, ingress=ingress)
        vt, rt = pt.process(*flows, ingress=ingress)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(rt, rj)
        expect = {1, 2, 3} if (prefilter and ingress) else {1, 2}
        assert set(np.unique(vt)) == expect
    np.testing.assert_array_equal(pt.counters, pj.counters)
    assert pt.counters.sum() == 9000
    fused = pt._tables[(tpipe.TRAFFIC_INGRESS, 4)].merged_sub_info.shape[-1] == 65536
    assert fused == prefilter


def test_rebuild_follows_ipcache_and_prefilter():
    """A moved ipcache entry or a new deny prefix rebuilds the tables
    before the next batch; nothing moved reuses them."""
    wj, pj, pt = _pipelines(0, False)
    flows = random_flows(wj, 500, N_EPS, 5)
    pt.process(*flows)
    tables = pt._tables
    pt.process(*flows)
    assert pt._tables is tables
    for pipe, pf in ((pj, pj.prefilter), (pt, pt.prefilter)):
        pf.insert(pf.revision, ["172.16.0.0/24"])
        pipe.ipcache.upsert("172.16.9.9/32", wj.idents[3].id, source="k8s")
    peers = np.array([0xAC100909, 0xAC100001, 0x08080808], np.uint32)
    args = (peers, np.array([0, 1, 2], np.int32), np.array([80, 80, 80], np.int32),
            np.array([6, 6, 6], np.int32))
    vj, rj = pj.process(*args)
    vt, rt = pt.process(*args)
    assert pt._tables is not tables
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(rt, rj)
    assert vt[1] == tpipe.DROP_PREFILTER


@pytest.mark.parametrize("prefilter", [False, True])
def test_process_flows_wide_row_override_matches_jax(prefilter):
    """The step function on tables carried across by convert.py, with
    some flows trusting an identity row over the LPM walk."""
    wj, pj, _pt = _pipelines(4, prefilter)
    pj.rebuild()
    jt = pj._tables[(jpipe.TRAFFIC_INGRESS, 4)]
    pm = jt.policymap
    tt = wide_tables_from_numpy(
        [np.asarray(getattr(jt, f)) for f in (
            "pf_root_info", "pf_root_child", "pf_sub_child", "pf_sub_info",
            "ip_root_info", "ip_root_child", "ip_sub_child", "ip_sub_info",
            "merged_root_info", "merged_root_child", "merged_sub_child", "merged_sub_info")],
        int(jt.world_row),
        policymap_from_numpy(pm.col_ep, pm.col_port, pm.col_proto, pm.col_is_l3, pm.id_bits,
                             device="cpu"),
        device="cpu",
    )
    peer, ep, dp, pr = random_flows(wj, 4000, N_EPS, 77)
    rs = np.random.default_rng(8)
    n_rows = pj.engine.snapshot()[0].id_bits.shape[0]
    override = np.where(rs.random(peer.shape[0]) < 0.3, rs.integers(0, n_rows, peer.shape[0]), -1)
    override = override.astype(np.int32)
    pf_stage = prefilter  # ingress with a live deny set
    want = jpipe.process_flows_wide(
        jt, jnp.asarray(peer), jnp.asarray(ep), jnp.asarray(dp), jnp.asarray(pr),
        ep_count=N_EPS, prefilter=pf_stage, row_override=jnp.asarray(override),
    )
    got = tpipe.process_flows_wide(
        tt, torch.from_numpy(peer.view(np.int32)), *(torch.from_numpy(a) for a in (ep, dp, pr)),
        ep_count=N_EPS, prefilter=pf_stage, row_override=torch.from_numpy(override),
    )
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_process_refuses_unported_arguments():
    """The monitor is the one argument of the reference's positional
    order that the port does not take: it raises rather than being
    ignored. ``device_ct_bits`` is ported and, as in the reference,
    brings a host conntrack of max(10, bits) slots for the batches the
    device CT cannot serve. ``sports``, ``return_rev_nat`` and
    ``tunnel_identities`` are ported and agree with the JAX package
    (without a conntrack, replies carry no revNAT id)."""
    wj, pj, pt = _pipelines(0, False)
    with pytest.raises(NotImplementedError):
        tpipe.DatapathPipeline(pt.engine, pt.ipcache, monitor=object(), device="cpu")
    for bits in (4, 12):
        dct = tpipe.DatapathPipeline(pt.engine, pt.ipcache, device="cpu", device_ct_bits=bits)
        ref = jpipe.DatapathPipeline(pj.engine, pj.ipcache, device_ct_bits=bits)
        assert dct.conntrack.capacity == ref.conntrack.capacity == 1 << max(10, bits)
    flows = random_flows(wj, 4, N_EPS, 1)
    flows6 = (np.zeros((4, 16), np.int32), *flows[1:])
    kw = dict(sports=np.arange(4), return_rev_nat=True,
              tunnel_identities=np.array([wj.idents[0].id, 0, 999999, 0], np.int64))
    for name, args in (("process", flows), ("process_v6", flows6)):
        got = getattr(pt, name)(*args, **kw)
        want = getattr(pj, name)(*args, **kw)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert not got[2].any()
