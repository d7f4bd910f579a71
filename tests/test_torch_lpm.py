"""Port parity: ops/lpm.py — the wide IPv4 tries and their walk.

The copied numpy builders must produce the JAX package's arrays, and
lpm_lookup_wide (plain PyTorch on the CPU) must return the JAX walk's
value+1 on every address, for the flat 16+16 layout, the 16-8-8 layout
(forced by 129 deep /16s) and the fused deny+identity table. Outputs
are int32: equality is exact.
"""

from __future__ import annotations

import ipaddress

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import pipeline as jpipe
from cilium_tpu.ops import lpm as jlpm
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.ops import lpm as tlpm


def _prefixes(kind: str, seed: int):
    rs = np.random.default_rng(seed)
    out = [("0.0.0.0/0", 1), ("10.0.0.0/8", 2), ("10.1.0.0/16", 3), ("10.1.2.0/24", 4),
           ("10.1.2.128/25", 5), ("10.1.2.130/31", 6), ("10.1.2.131/32", 7),
           ("192.168.16.0/20", 8), ("192.168.17.0/28", 9)]
    n_deep_hi16 = 129 if kind == "16-8-8" else 6
    for j in range(n_deep_hi16):
        hi = (172 << 8) | (16 + j % 16) if j < 16 else (100 << 8) | j
        for _ in range(4):
            addr = (hi << 16) | int(rs.integers(0, 1 << 16))
            plen = int(rs.choice([17, 20, 24, 27, 32]))
            net = ipaddress.ip_network((addr, plen), strict=False)
            out.append((str(net), 10 + len(out)))
    return out


def _addresses(prefixes, n: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    inside = []
    for cidr, _ in prefixes:
        net = ipaddress.ip_network(cidr)
        inside.append(int(net.network_address) + int(rs.integers(0, net.num_addresses)))
        inside.append(int(net.broadcast_address))
    rand = rs.integers(0, 1 << 32, n, dtype=np.uint64)
    return np.concatenate([np.array(inside, np.uint64), rand]).astype(np.uint32)


def _walk_both(arrays, addr):
    want = np.asarray(jlpm.lpm_lookup_wide(*(jnp.asarray(a) for a in arrays), jnp.asarray(addr)))
    got = tlpm.lpm_lookup_wide(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        torch.from_numpy(addr.view(np.int32)),
    ).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["flat", "16-8-8"])
def test_wide_trie_walk_matches_jax(kind, seed):
    prefixes = _prefixes(kind, seed)
    want_arrays = jlpm.build_wide_trie(prefixes)
    arrays = tlpm.build_wide_trie(prefixes)
    for a, b in zip(arrays, want_arrays):
        np.testing.assert_array_equal(a, b)
    flat = arrays[3].shape[-1] == 65536
    assert flat == (kind == "flat")
    addr = _addresses(prefixes, 4000, seed)
    got, want = _walk_both(arrays, addr)
    np.testing.assert_array_equal(got, want)
    assert (got > 1).mean() > 0.05  # deeper than the /0 default on many addresses


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_walk_matches_jax(seed):
    ip_prefixes = _prefixes("flat", seed)
    deny = [("10.1.2.0/26", 0), ("172.16.0.0/12", 0), ("8.8.8.8/32", 0), ("192.168.17.8/29", 0)]
    ip_arrays = tlpm.build_wide_trie(ip_prefixes)
    pf_arrays = tlpm.build_wide_trie(deny)
    merged = tlpm.merge_flat_tries(ip_arrays, pf_arrays)
    want_merged = jlpm.merge_flat_tries(jlpm.build_wide_trie(ip_prefixes), jlpm.build_wide_trie(deny))
    assert merged is not None
    for a, b in zip(merged, want_merged):
        np.testing.assert_array_equal(a, b)
    addr = _addresses(ip_prefixes + deny, 4000, seed)
    got, want = _walk_both(merged, addr)
    np.testing.assert_array_equal(got, want)

    # the pipeline's v4 stage over the same tables: fused, split, and off
    placeholder = (np.zeros(1, np.int32), np.zeros(1, np.int32),
                   np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32))
    for pf, mg, prefilter in ((placeholder, merged, True), (pf_arrays, placeholder, True),
                              (pf_arrays, placeholder, False)):
        arrays = (*pf, *ip_arrays, *mg)
        jt = jpipe.WideDatapathTables(
            **{name: jnp.asarray(a) for name, a in zip(_TRIE_FIELDS, arrays)},
            world_row=jnp.int32(0), policymap=None,
        )
        jd, jh = jpipe._v4_lpm_stage(jt, jnp.asarray(addr), prefilter)
        tt = tpipe.WideDatapathTables(
            **{name: torch.from_numpy(np.ascontiguousarray(a)) for name, a in zip(_TRIE_FIELDS, arrays)},
            world_row=0, policymap=None,
        )
        td, th = tpipe._v4_lpm_stage(tt, torch.from_numpy(addr.view(np.int32)), prefilter)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        if td is None:
            assert not np.asarray(jd).any()
        else:
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            assert td.any()


_TRIE_FIELDS = (
    "pf_root_info", "pf_root_child", "pf_sub_child", "pf_sub_info",
    "ip_root_info", "ip_root_child", "ip_sub_child", "ip_sub_info",
    "merged_root_info", "merged_root_child", "merged_sub_child", "merged_sub_info",
)


def test_merge_refuses_the_pointer_layout():
    deep = tlpm.build_wide_trie(_prefixes("16-8-8", 0))
    assert tlpm.merge_flat_tries(deep, tlpm.build_wide_trie([("8.8.8.0/24", 0)])) is None
