"""Port parity: the IPv6 datapath pipeline end to end.

The harness world gets one IPv6 /128 per identity (under fd00::1:0/112)
and one IPv6 CIDR entry; both packages' DatapathPipelines process the
same numpy [B, 16] address bytes, in both directions, with and without
an IPv6 deny set. Verdicts, redirects and the per-endpoint counters
(shared by both families) must be equal (integers: equality is exact).
The stride-8 step function ``process_flows`` is also held against the
JAX one on tables carried across by convert.py: prefilter on and off,
fused and split deny walks, and a row_override.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.engine import PolicyEngine as JaxEngine
from cilium_tpu.ipcache.prefilter import PreFilter as JaxPreFilter
from cilium_tpu_torch.convert import policymap_from_numpy, v6_tables_from_numpy
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.engine import PolicyEngine as TorchEngine
from cilium_tpu_torch.ipcache.prefilter import PreFilter as TorchPreFilter
from cilium_tpu_torch.ops.lpm import ipv6_to_bytes
from test_torch_harness import build_world, random_flows

N_EPS = 6
DENY4 = ["172.16.0.0/28", "8.8.0.0/16"]
DENY6 = ["fd00::1:0/124", "fd00::1:10/126"]
CIDR6 = "fd00:0:0:2::/64"
WORLD6 = ["2001:db8::1", "2001:db8::77", "fd00::3:1"]


def add_v6(world) -> list:
    """One /128 per endpoint-capable identity and one /64 for the first
    CIDR identity (or identity 0); returns the v6 peer addresses."""
    peers = []
    for i, ident in enumerate(world.idents):
        world.ipcache.upsert(f"fd00::1:{i:x}/128", ident.id, source="k8s")
        peers.append(f"fd00::1:{i:x}")
    cid = next((p for p in world.peer_idents if p is not None and p not in world.idents),
               world.idents[0])
    world.ipcache.upsert(CIDR6, cid.id, source="agent")
    return peers + ["fd00:0:0:2::99"] + WORLD6


def v6_flows(peers, n: int, seed: int):
    rs = np.random.default_rng(seed)
    addr = ipv6_to_bytes(peers)[rs.integers(0, len(peers), n)]
    dports = rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), n).astype(np.int32)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return addr, rs.integers(0, N_EPS, n).astype(np.int32), dports, protos


def pipelines(seed: int, deny=()):
    wj = build_world("cilium_tpu", seed)
    wt = build_world("cilium_tpu_torch", seed)
    peers = add_v6(wj)
    assert add_v6(wt) == peers
    pfj, pft = JaxPreFilter(), TorchPreFilter()
    if deny:
        for pf in (pfj, pft):
            pf.insert(pf.revision, list(deny))
    pj = jpipe.DatapathPipeline(JaxEngine(wj.repo, wj.reg), wj.ipcache, pfj)
    pt = tpipe.DatapathPipeline(TorchEngine(wt.repo, wt.reg, device="cpu"), wt.ipcache, pft,
                                device="cpu")
    eps = [i.id for i in wj.idents[:N_EPS]]
    pj.set_endpoints(eps)
    pt.set_endpoints(eps)
    return wj, peers, pj, pt


@pytest.mark.parametrize("deny", [(), tuple(DENY6), tuple(DENY4 + DENY6)])
@pytest.mark.parametrize("seed", [0, 4])
def test_process_v6_matches_jax(seed, deny):
    _wj, peers, pj, pt = pipelines(seed, deny)
    live6 = any(":" in c for c in deny)
    for k, ingress in enumerate((True, False, True)):
        flows = v6_flows(peers, 3000, seed * 10 + k)
        vj, rj = pj.process_v6(*flows, ingress=ingress)
        vt, rt = pt.process_v6(*flows, ingress=ingress)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(rt, rj)
        expect = {1, 2, 3} if (live6 and ingress) else {1, 2}
        assert set(np.unique(vt)) == expect
    np.testing.assert_array_equal(pt.counters, pj.counters)
    assert pt.counters.sum() == 9000
    assert pt._v6_fused == pj._v6_fused == live6
    assert pt._pf_empty == pj._pf_empty
    t6 = pt._tables[(tpipe.TRAFFIC_INGRESS, 6)]
    # fd00:0:0:2::/64 and fd00::1:x share 7 whole bytes: K = 7 for the
    # identity trie and, with a v6 deny set, for the fused one
    assert t6.ip_common.shape[0] == 7
    assert t6.merged_common.shape[0] == (7 if live6 else 0)


def test_v4_and_v6_batches_share_the_counters():
    wj, peers, pj, pt = pipelines(2, tuple(DENY4 + DENY6))
    for k in range(2):
        f4 = random_flows(wj, 1500, N_EPS, 40 + k)
        f6 = v6_flows(peers, 1500, 50 + k)
        for pipe in (pj, pt):
            pipe.process(*f4, ingress=bool(k))
            pipe.process_v6(*f6, ingress=not k)
    np.testing.assert_array_equal(pt.counters, pj.counters)
    assert pt.counters.sum() == 6000
    assert pt.counters[:, 2].sum() > 0  # prefilter drops from both families


def test_rebuild_follows_v6_ipcache_and_prefilter():
    """A moved v6 ipcache entry or a new v6 deny prefix rebuilds the
    tables before the next batch; nothing moved reuses them."""
    wj, peers, pj, pt = pipelines(0)
    flows = v6_flows(peers, 500, 5)
    pt.process_v6(*flows)
    pj.process_v6(*flows)
    tables = pt._tables
    pt.process_v6(*flows)
    assert pt._tables is tables and not pt._v6_fused
    for pipe in (pj, pt):
        pipe.prefilter.insert(pipe.prefilter.revision, ["fd00::1:0/126"])
        pipe.ipcache.upsert("fd00::9:9/128", wj.idents[3].id, source="k8s")
    args = (ipv6_to_bytes(["fd00::9:9", "fd00::1:1", "fd00::1:5", "2001:db8::5"]),
            np.arange(4, dtype=np.int32), np.full(4, 80, np.int32), np.full(4, 6, np.int32))
    vj, rj = pj.process_v6(*args)
    vt, rt = pt.process_v6(*args)
    assert pt._tables is not tables and pt._v6_fused
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(rt, rj)
    assert vt[1] == tpipe.DROP_PREFILTER and vt[2] != tpipe.DROP_PREFILTER


def _step_tables(pj, fused: bool):
    """The JAX pipeline's v6 ingress tables, and the port's from the
    same arrays; for the split walk the deny trie is built standalone."""
    from cilium_tpu.ops.lpm import build_trie_elided

    pj.rebuild()
    jt = pj._tables[(jpipe.TRAFFIC_INGRESS, 6)]
    if not fused:
        pf = build_trie_elided([(c, 0) for c in DENY6], ipv6=True)
        jt = jt.replace(pf_child=jnp.asarray(pf[0]), pf_info=jnp.asarray(pf[1]),
                        pf_common=jnp.asarray(pf[2]))
    pm = jt.policymap
    tt = v6_tables_from_numpy(
        [np.asarray(getattr(jt, f)) for f in (
            "pf_child", "pf_info", "pf_common", "ip_child", "ip_info", "ip_common",
            "merged_child", "merged_info", "merged_common")],
        int(jt.world_row),
        policymap_from_numpy(pm.col_ep, pm.col_port, pm.col_proto, pm.col_is_l3, pm.id_bits,
                             device="cpu"),
        device="cpu",
    )
    return jt, tt


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("mode", ["no-prefilter", "fused", "split"])
def test_process_flows_matches_jax(mode, override):
    _wj, peers, pj, _pt = pipelines(4, tuple(DENY6))
    jt, tt = _step_tables(pj, fused=mode != "split")
    addr, ep, dp, pr = v6_flows(peers, 4000, 77)
    rs = np.random.default_rng(8)
    n_rows = pj.engine.snapshot()[0].id_bits.shape[0]
    row = None
    if override:
        row = np.where(rs.random(addr.shape[0]) < 0.3, rs.integers(0, n_rows, addr.shape[0]), -1)
        row = row.astype(np.int32)
    kw = dict(ep_count=N_EPS, levels=16, prefilter=mode != "no-prefilter", fused=mode == "fused")
    want = jpipe.process_flows(
        jt, jnp.asarray(addr), jnp.asarray(ep), jnp.asarray(dp), jnp.asarray(pr),
        row_override=None if row is None else jnp.asarray(row), **kw,
    )
    got = tpipe.process_flows(
        tt, *(torch.from_numpy(a) for a in (addr, ep, dp, pr)),
        row_override=None if row is None else torch.from_numpy(row), **kw,
    )
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (got[0].numpy() == 3).any() == (mode != "no-prefilter")
