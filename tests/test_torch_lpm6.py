"""Port parity: the stride-8 tries and their walk (ops/lpm.py) and the
IPv6 LPM stage of the pipeline.

The port's copies of ``build_trie``, ``build_trie_elided`` and
``merge_trie_entries`` must build the JAX package's arrays from the
same prefixes; ``lpm_lookup`` / ``_elided_lpm`` / ``_v6_lpm_stage``
(plain versions of the ``lpm_stride8`` kernel on the CPU) must return
the JAX values on the same numpy addresses. Trie hits are integers:
equality is exact.

One divergence is named and held apart: a byte outside [0, 255] reads
nothing in the port (no hit, the walk ends), while the JAX walk's flat
index ``node * 256 + byte`` may land inside the table and read another
node's slot. Where the JAX index falls outside the table, ``jnp.take``
fills and the two agree; the tests check the port against JAX on the
same addresses with every out-of-range byte moved past any table.
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

FAR = 1 << 24  # a byte value past every table: jnp.take fills


def _random_prefixes(rs, ipv6: bool, n: int, base: str, plens):
    net = ipaddress.ip_network(base)
    out = []
    for i in range(n):
        plen = int(rs.choice(plens))
        span = net.max_prefixlen - net.prefixlen
        off = int(rs.integers(0, 1 << min(span, 62)))
        addr = ipaddress.ip_address(int(net.network_address) + off)
        out.append((str(ipaddress.ip_network((addr, plen), strict=False)), i))
    return out


def _prefix_sets(seed: int, ipv6: bool):
    """(identity prefixes, deny prefixes with one short CIDR)."""
    rs = np.random.default_rng(seed)
    if ipv6:
        ip = _random_prefixes(rs, True, 60, "fd00::/112", [128, 128, 124, 120, 116])
        ip += [("fd00::/64", 999)]
        deny = _random_prefixes(rs, True, 6, "fd00::/112", [124, 120]) + [("2001:db8::/32", 0)]
    else:
        ip = _random_prefixes(rs, False, 60, "10.0.0.0/16", [32, 32, 28, 24, 20])
        ip += [("10.0.0.0/8", 999), ("0.0.0.0/0", 998)]
        deny = _random_prefixes(rs, False, 6, "10.0.0.0/16", [28, 24]) + [("192.0.2.0/24", 0)]
    return ip, deny


def _addresses(seed: int, ip, deny, ipv6: bool, n: int = 3000) -> np.ndarray:
    """[n, 4|16] int32 bytes: addresses inside the prefixes plus
    random ones, all bytes in [0, 255]."""
    rs = np.random.default_rng(seed + 100)
    size = 16 if ipv6 else 4
    nets = [ipaddress.ip_network(c) for c, _ in ip + deny]
    out = np.empty((n, size), np.int32)
    for i in range(n):
        if rs.random() < 0.8:
            net = nets[int(rs.integers(0, len(nets)))]
            span = net.max_prefixlen - net.prefixlen
            a = int(net.network_address) + int(rs.integers(0, 1 << min(span, 62)))
        else:
            a = int(rs.integers(0, 1 << 62)) << (64 if ipv6 else 0) >> (0 if ipv6 else 30)
            a &= (1 << (size * 8)) - 1
        out[i] = list(a.to_bytes(size, "big"))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("ipv6", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_builders_match_jax(seed, ipv6):
    ip, deny = _prefix_sets(seed, ipv6)
    for prefixes in (ip, deny, ip + deny):
        for a, b in zip(tlpm.build_trie(prefixes, ipv6=ipv6), jlpm.build_trie(prefixes, ipv6=ipv6)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tlpm.build_trie_elided(prefixes, ipv6=ipv6),
                        jlpm.build_trie_elided(prefixes, ipv6=ipv6)):
            np.testing.assert_array_equal(a, b)
    merged = tlpm.merge_trie_entries(ip, deny, ipv6=ipv6)
    assert merged == jlpm.merge_trie_entries(ip, deny, ipv6=ipv6)
    # the short deny CIDR disables elision of the fused trie; the
    # identity trie alone keeps its shared bytes
    assert tlpm.build_trie_elided(merged, ipv6=ipv6)[2].shape[0] == 0
    assert tlpm.build_trie_elided(ip, ipv6=ipv6)[2].shape[0] > 0 or not ipv6


def test_empty_trie_and_address_helpers():
    child, info, common = tlpm.build_trie_elided([], ipv6=True)
    assert child.shape == info.shape == (1, 256) and common.shape == (0,)
    u32 = np.array([0x0A000001, 0xFFFFFFFF, 0], np.uint32)
    np.testing.assert_array_equal(tlpm.ipv4_to_bytes(u32), jlpm.ipv4_to_bytes(u32))
    ips = ["fd00::1", "2001:db8::ff:1", "::"]
    np.testing.assert_array_equal(tlpm.ipv6_to_bytes(ips), jlpm.ipv6_to_bytes(ips))


def _jax_lookup(child, info, addr, levels):
    return np.asarray(jlpm.lpm_lookup(jnp.asarray(child), jnp.asarray(info),
                                      jnp.asarray(addr), levels=levels))


@pytest.mark.parametrize("ipv6", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_lpm_lookup_matches_jax(seed, ipv6):
    """levels 4 (v4) and 16 (v6), in-range bytes: equal to JAX."""
    ip, deny = _prefix_sets(seed, ipv6)
    child, info = tlpm.build_trie(ip + deny, ipv6=ipv6)
    addr = _addresses(seed, ip, deny, ipv6)
    levels = 16 if ipv6 else 4
    got = tlpm.lpm_lookup(_t(child), _t(info), _t(addr), levels=levels).numpy()
    np.testing.assert_array_equal(got, _jax_lookup(child, info, addr, levels))
    assert (got > 0).mean() > 0.5 and len(np.unique(got)) > 10


@pytest.mark.parametrize("ipv6", [False, True])
def test_lpm_lookup_out_of_range_bytes(ipv6):
    """A byte outside [0, 255] (or a child id outside [1, M)) reads
    nothing and ends the walk: JAX's take-fill result. Equal to JAX on
    the raw addresses where JAX's index leaves the table, and on the
    addresses with every out-of-range byte moved to FAR."""
    ip, deny = _prefix_sets(5, ipv6)
    child, info = tlpm.build_trie(ip + deny, ipv6=ipv6)
    levels = 16 if ipv6 else 4
    addr = _addresses(5, ip, deny, ipv6, n=2000)
    rs = np.random.default_rng(11)
    bad = rs.random(addr.shape) < 0.08
    vals = rs.choice(np.array([-1, -7, 256, 300, 1 << 20, -(1 << 20)], np.int32), addr.shape)
    addr = np.where(bad, vals, addr).astype(np.int32)
    got = tlpm.lpm_lookup(_t(child), _t(info), _t(addr), levels=levels).numpy()
    far = np.where((addr < 0) | (addr > 255), FAR, addr).astype(np.int32)
    np.testing.assert_array_equal(got, _jax_lookup(child, info, far, levels))
    # raw out-of-range bytes JAX itself cannot wrap into the table
    huge = np.where(bad, np.where(vals < 0, -(1 << 20), 1 << 20), addr).astype(np.int32)
    got_huge = tlpm.lpm_lookup(_t(child), _t(info), _t(huge), levels=levels).numpy()
    np.testing.assert_array_equal(got_huge, _jax_lookup(child, info, huge, levels))
    np.testing.assert_array_equal(got_huge, got)
    # the named divergence: byte -1 below the root reads nothing in the
    # port, while JAX reads slot 255 of the node before
    c2, i2 = tlpm.build_trie([("10.0.0.0/8", 1), ("10.1.0.0/16", 2), ("0.0.0.0/0", 7)])
    a2 = np.array([[10, -1, 0, 0]], np.int32)
    assert int(tlpm.lpm_lookup(_t(c2), _t(i2), _t(a2), levels=4)[0]) == 2
    assert int(_jax_lookup(c2, i2, a2, 4)[0]) == 8


@pytest.mark.parametrize("kind", ["elided", "short-deny", "empty"])
def test_elided_lpm_matches_jax(kind):
    """K > 0 (shared fd00::/112 bytes compared, not walked), K = 0 (a
    short deny CIDR disables elision) and the empty [1, 256] trie."""
    ip, deny = _prefix_sets(7, True)
    prefixes = {"elided": ip[:-1], "short-deny": ip + deny, "empty": []}[kind]
    child, info, common = tlpm.build_trie_elided(prefixes, ipv6=True)
    assert (common.shape[0] > 0) == (kind == "elided")
    addr = _addresses(7, ip, deny, True)
    want = np.asarray(jpipe._elided_lpm(
        jnp.asarray(child), jnp.asarray(info), jnp.asarray(common), jnp.asarray(addr), 16))
    got = tpipe._elided_lpm(_t(child), _t(info), _t(common), _t(addr), 16).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "elided":
        # an address differing in the K elided bytes hits 0 (world row)
        off = addr.copy()
        off[:, 0] = 0x20
        assert not tpipe._elided_lpm(_t(child), _t(info), _t(common), _t(off), 16).any()
        assert (got > 0).any()


def _v6_tables(seed: int):
    """JAX and port DatapathTables over the same elided tries, with the
    standalone deny trie AND the fused one present."""
    rs = np.random.default_rng(seed)
    ip = [(f"fd00::1:{i:x}/128", int(r)) for i, r in enumerate(rs.integers(0, 40, 50))]
    ip += [("fd00::1:0/120", 41)]
    deny = ["fd00::1:10/124", "fd00::1:20/126"]
    pf = tlpm.build_trie_elided([(c, 0) for c in deny], ipv6=True)
    ipt = tlpm.build_trie_elided(ip, ipv6=True)
    merged = tlpm.build_trie_elided(tlpm.merge_trie_entries(ip, [(c, 0) for c in deny]), ipv6=True)
    arrays = (*pf, *ipt, *merged)
    names = ("pf_child", "pf_info", "pf_common", "ip_child", "ip_info", "ip_common",
             "merged_child", "merged_info", "merged_common")
    jt = jpipe.DatapathTables(
        **{k: jnp.asarray(a) for k, a in zip(names, arrays)},
        world_row=jnp.int32(42), policymap=None,
    )
    tt = tpipe.DatapathTables(
        **{k: _t(a) for k, a in zip(names, arrays)}, world_row=42, policymap=None,
    )
    peers = [f"fd00::1:{i:x}" for i in range(0, 80)] + ["2001:db8::1", "fd00::2:1"]
    addr = tlpm.ipv6_to_bytes([peers[int(i)] for i in rs.integers(0, len(peers), 2000)])
    return jt, tt, addr, merged[2].shape[0]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("prefilter", [False, True])
def test_v6_lpm_stage_matches_jax(prefilter, fused):
    jt, tt, addr, k = _v6_tables(3)
    assert k == 15  # the fused trie keeps the shared fd00::1:0/120 bytes
    jd, jh = jpipe._v6_lpm_stage(jt, jnp.asarray(addr), 16, prefilter, fused)
    td, th = tpipe._v6_lpm_stage(tt, _t(addr), 16, prefilter, fused)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    if prefilter:
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert td.any() and not td.all()
    else:
        assert td is None and not np.asarray(jd).any()
    assert (th.numpy() > 0).any() and (th.numpy() == 0).any()
