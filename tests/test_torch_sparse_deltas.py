"""Port parity: sparse trie deltas — the patchable identity-trie mirrors
(``ops/lpm.py`` ``PatchableElidedTrie`` / ``PatchableFlatTrie``), their
four scatter programs, and the pipeline's ``sparse_deltas`` path that
patches the tries on ipcache churn instead of rebuilding them.

The same seeded inputs and mutation sequences go through both packages.
After every step the port's mirror arrays equal the JAX package's, its
plain K3 / K5 walks equal JAX ``lpm_lookup_wide`` / ``lpm_lookup`` on
the same probes, its flushed tensors equal JAX's flushed arrays, and
its pipeline tries, verdicts, redirects and ``lpm_trie_patches_total``
movement equal the JAX pipeline's; both patch on the same steps and
fall back on the same ones. Tolerance 0: every value is an integer.
The port uploads the exact dirty rows (JAX pads them to a power of
two), so the h2d byte counts are held to what the port uploads.
"""

from __future__ import annotations

import importlib
import ipaddress
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu import metrics as jmetrics
from cilium_tpu.ops import lpm as jlpm
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.ops import lpm as tlpm

PKGS = ("cilium_tpu", "cilium_tpu_torch")
N_EPS = 6
V4_FIELDS = [f"{p}_{x}" for p in ("pf", "ip", "merged")
             for x in ("root_info", "root_child", "sub_child", "sub_info")]
V6_FIELDS = [f"{p}_{x}" for p in ("pf", "ip", "merged") for x in ("child", "info", "common")]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _canon(cidr: str) -> str:
    return ipaddress.ip_network(cidr, strict=False).with_prefixlen


def _u32(ips):
    return np.array([int(ipaddress.IPv4Address(ip)) for ip in ips], np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# -- the mirrors, in lockstep ------------------------------------------------

def _lookup6(arrs, ips):
    """JAX: the elided walk as the JAX package's tests run it (common
    bytes compared on the host, lpm_lookup over the rest)."""
    child, info, common = (np.asarray(a) for a in arrs)
    ab = jlpm.ipv6_to_bytes(ips)
    k = common.shape[0]
    ok = (ab[:, :k] == common[None, :]).all(axis=1) if k else np.ones(len(ips), bool)
    out = np.asarray(jlpm.lpm_lookup(jnp.asarray(child), jnp.asarray(info),
                                     jnp.asarray(ab[:, k:]), levels=16 - k))
    return np.where(ok, out, 0)


def _lookup6_port(arrs, ips):
    child, info, common = (_t(a) for a in arrs)
    return tlpm.elided_lookup(child, info, common, _t(tlpm.ipv6_to_bytes(ips)), 16).numpy()


def _lookup4(arrs, addrs):
    return np.asarray(jlpm.lpm_lookup_wide(*(jnp.asarray(np.asarray(a)) for a in arrs),
                                           jnp.asarray(addrs)))


def _lookup4_port(arrs, addrs):
    return tlpm.lpm_lookup_wide(*(_t(a) for a in arrs), _t(addrs.view(np.int32))).numpy()


class Mirrors:
    """One mirror per package over the same prefixes; every op goes to
    both and must return the same answer."""

    def __init__(self, fam: int, entries, flat_parsed=False):
        self.fam = fam
        if fam == 6:
            self.j = jlpm.PatchableElidedTrie(entries)
            self.t = tlpm.PatchableElidedTrie(entries)
        elif flat_parsed:
            self.j = jlpm.PatchableFlatTrie(entries)
            self.t = tlpm.PatchableFlatTrie(entries)
        else:
            self.j = jlpm.make_patchable_wide(entries)
            self.t = tlpm.make_patchable_wide(entries)
        self.check_arrays()
        self.dev_j = tuple(jnp.asarray(a) for a in self.dev_arrays(self.j))
        self.dev_t = tuple(_t(a) for a in self.dev_arrays(self.t))

    def dev_arrays(self, m):
        return m.arrays()[:2] if self.fam == 6 else m.arrays()

    def op(self, name, *args):
        a, b = getattr(self.j, name)(*args), getattr(self.t, name)(*args)
        assert a == b, (name, args, a, b)
        return b

    def check_arrays(self):
        for x, y in zip(self.j.arrays(), self.t.arrays()):
            np.testing.assert_array_equal(y, x)
        if self.fam == 6:
            np.testing.assert_array_equal(self.t.child_h, self.j.child_h)
            np.testing.assert_array_equal(self.t.info_h, self.j.info_h)
            assert self.t._k == self.j._k

    def expected_bytes(self) -> int:
        """The bytes the port's flush uploads: the exact dirty rows with
        int64 indices (v6); the root_child indices and values, and for
        root_info and sub_info a lone span's values or, for several
        spans, each distinct element's int64 index and value (v4)."""
        t = self.t
        if self.fam == 6:
            return len(t._dirty) * (8 + 2 * 256 * 4)

        def spans(cover):
            if len(cover) == 1:
                return 4 * cover[0][1]
            return 12 * len({i for s, w in cover for i in range(s, s + w)})
        return (spans(list(t._dirty_root)) + 12 * len(t._dirty_child)
                + spans([(n * 65536 + b, w) for n, b, w in t._dirty_sub]))

    def flush(self):
        """Flush both → the port's byte count; the flushed device copies
        must equal each other and the mirror arrays."""
        want = self.expected_bytes()
        dirty = self.t.dirty
        held = [x.clone() for x in self.dev_t]
        outj, outt = self.j.flush(*self.dev_j), self.t.flush(*self.dev_t)
        assert outt is not None and outj is not None
        self.dev_j, _ = outj
        new_t, nbytes = outt
        for h, old in zip(held, self.dev_t):
            assert torch.equal(h, old)  # out of place
        self.dev_t = new_t
        assert nbytes == want and (nbytes > 0) == dirty
        assert not self.t.dirty and not self.j.dirty
        for x, y, m in zip(self.dev_j, self.dev_t, self.dev_arrays(self.t)):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
            np.testing.assert_array_equal(y.numpy(), m)
        return nbytes

    def lookups(self, probes):
        """Port plain walk on the flushed tensors == JAX walk on JAX's."""
        if self.fam == 6:
            common = self.t.arrays()[2]
            got = _lookup6_port((*self.dev_t, common), probes)
            np.testing.assert_array_equal(got, _lookup6((*self.dev_j, common), probes))
        else:
            got = _lookup4_port(self.dev_t, probes)
            np.testing.assert_array_equal(got, _lookup4(self.dev_j, probes))
        return got


def _seed6():
    return ([(f"fd00:aa::{i:x}:0/112", i) for i in range(1, 5)]
            + [(f"fd00:aa::{i:x}/128", 16 + i) for i in range(1, 9)]
            + [("fd00:aa::/104", 99)])


def _probes6(entries, rng):
    ips = [c.split("/")[0] for c, _ in entries]
    ips += [f"fd00:aa::{rng.randrange(16):x}:{rng.randrange(512):x}" for _ in range(64)]
    return ips + ["fd00:bb::1", "::1"]


def _seed4():
    return ([(f"10.{i}.0.0/16", i) for i in range(3)]
            + [(f"10.0.{i}.0/24", 10 + i) for i in range(4)]
            + [(f"10.0.0.{i}/32", 20 + i) for i in range(1, 6)]
            + [("10.0.0.0/8", 99)])


def _probes4(rng):
    return _u32([f"10.{rng.randrange(4)}.{rng.randrange(5)}.{rng.randrange(8)}" for _ in range(96)]
                + ["10.0.0.1", "10.3.3.3", "192.168.1.1", "0.0.0.0"])


@pytest.mark.parametrize("fam", [4, 6])
def test_build_matches_classic(fam):
    rng = random.Random(2)
    if fam == 6:
        m = Mirrors(6, _seed6())
        probes = _probes6(_seed6(), rng)
        want = _lookup6_port(tlpm.build_trie_elided(_seed6()), probes)
    else:
        m = Mirrors(4, _seed4())
        probes = _probes4(rng)
        want = _lookup4_port(tlpm.build_wide_trie(_seed4()), probes)
    np.testing.assert_array_equal(m.lookups(probes), want)


@pytest.mark.parametrize("fam", [4, 6])
def test_incremental_fuzz_matches_classic_rebuild(fam):
    """Inserts and deletes in both packages' mirrors; after every flush
    the mirror arrays, the flushed tensors and the walks agree, and the
    walks equal a classic rebuild of the live set."""
    rng = random.Random(7 if fam == 6 else 11)
    if fam == 6:
        entries = _seed6() + [(_canon(f"fd00:aa::{a:x}:b0/128"), 50 + a) for a in range(4)]
        universe = [(_canon(f"fd00:aa::{a:x}:{b:x}/{p}"), rng.randrange(200))
                    for a in range(4) for b in range(4) for p in (112, 120, 128)]
        per_step = 6
    else:
        entries = _seed4()
        universe = [(_canon(f"10.{a}.{b}.{c}/{p}"), rng.randrange(200))
                    for a in range(3) for b in range(3) for c in (0, 64, 128) for p in (16, 24, 26, 32)]
        per_step = 5
    m = Mirrors(fam, entries)
    live = dict(entries)
    for step in range(12):
        for _ in range(per_step):
            if live and rng.random() < 0.4:
                victim = rng.choice(sorted(live))
                assert m.op("delete", victim)
                del live[victim]
            else:
                cidr, val = rng.choice(universe)
                assert m.op("insert", cidr, val), cidr
                live[cidr] = val
            m.check_arrays()
        assert m.flush() > 0
        items = sorted(live.items())
        if fam == 6:
            probes = _probes6(items, rng)
            want = _lookup6_port(tlpm.build_trie_elided(items), probes)
        else:
            probes = _probes4(rng)
            want = _lookup4_port(tlpm.build_wide_trie(items), probes)
        np.testing.assert_array_equal(m.lookups(probes), want, err_msg=f"step {step}")


def test_insert_outside_common_refuses():
    m = Mirrors(6, _seed6())
    assert not m.op("insert", "fd00:bb::1/128", 5)
    assert not m.op("insert", "fd00:aa::/64", 5)  # shorter than the elision


def test_upsert_overwrites_value():
    m = Mirrors(6, [("fd00:aa::1/128", 3)])
    assert m.op("insert", "fd00:aa::1/128", 8)
    m.flush()
    assert m.lookups(["fd00:aa::1"])[0] == 9


@pytest.mark.parametrize("fam", [4, 6])
def test_node_pool_exhaustion_returns_false(fam):
    if fam == 6:
        # K = 2 shared bytes, 27 nodes in a 32-row pool: the first new
        # deep path fits, a later one exhausts it
        m = Mirrors(6, [("fd00::1/128", 0), ("fd00:ff::1/128", 1)])
        oks = []
        for i in range(1, 64):
            oks.append(m.op("insert", f"fd00::{i:x}:0:{i:x}/128", i))
            if not oks[-1]:
                break
    else:
        m = Mirrors(4, [((10 << 24) | (1 << 16), 24, 0)], flat_parsed=True)
        oks = [m.op("insert", f"10.{i}.0.0/24", i) for i in range(2, 8)]
    assert any(oks) and not all(oks), oks
    m.check_arrays()
    m.flush()


def test_deep_node_budget_returns_none():
    entries = [(f"10.{i // 256}.{i % 256}.0/24", i)
               for i in range(0, (tlpm.FLAT_TRIE_MAX_NODES + 1) * 256, 256)]
    assert jlpm.make_patchable_wide(entries) is None
    assert tlpm.make_patchable_wide(entries) is None


def test_delete_reexposes_shorter_prefix():
    m = Mirrors(4, [("10.0.0.0/16", 1), ("10.0.7.0/24", 2)])
    probe = _u32(["10.0.7.9"])
    assert m.lookups(probe)[0] == 3
    assert m.op("delete", "10.0.7.0/24")
    m.flush()
    assert m.lookups(probe)[0] == 2


@pytest.mark.parametrize("fam", [4, 6])
def test_flush_clean_is_zero_byte_noop(fam):
    m = Mirrors(fam, _seed4() if fam == 4 else _seed6())
    out, nbytes = m.t.flush(*m.dev_t)
    assert nbytes == 0 and all(a is b for a, b in zip(out, m.dev_t))


@pytest.mark.parametrize("fam", [4, 6])
def test_flush_shape_mismatch_returns_none(fam):
    if fam == 6:
        m = Mirrors(6, _seed6())
        m.op("insert", "fd00:aa::77/128", 7)
        bad = (torch.zeros(2, 256, dtype=torch.int32),) * 2
        assert m.j.flush(jnp.zeros((2, 256), jnp.int32), jnp.zeros((2, 256), jnp.int32)) is None
    else:
        m = Mirrors(4, _seed4())
        m.op("insert", "10.0.0.77/32", 7)
        bad = (*m.dev_t[:3], torch.zeros(2, 65536, dtype=torch.int32))
        assert m.j.flush(*m.dev_j[:3], jnp.zeros((2, 65536), jnp.int32)) is None
    assert m.t.flush(*bad) is None


@pytest.mark.parametrize("helper", ["_patch_trie_rows", "_patch_span1", "_patch_span_row", "_patch_elems"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_helper_equals_jax_program(helper, seed):
    """Each out-of-place torch op equals its JAX program on random rows
    and spans, and leaves its input as it was."""
    rs = np.random.default_rng(seed)

    def ints(*shape):
        return rs.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)

    if helper == "_patch_trie_rows":
        m, k = 32, int(rs.integers(1, 20))
        a, b, cv, iv = ints(m, 256), ints(m, 256), ints(k, 256), ints(k, 256)
        idx = np.sort(rs.choice(m, k, replace=False))
        want = jlpm._patch_trie_rows(jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx.astype(np.int32)),
                                     jnp.asarray(cv), jnp.asarray(iv))
        ins = (_t(a), _t(b))
        got = tlpm._patch_trie_rows(*ins, _t(idx.astype(np.int64)), _t(cv), _t(iv))
    elif helper == "_patch_span1":
        span = 1 << int(rs.integers(0, 16))
        start = int(rs.integers(0, 65536 - span + 1))
        a, v = ints(65536), ints(span)
        want = (jlpm._patch_span1(jnp.asarray(a), jnp.int32(start), jnp.asarray(v)),)
        ins = (_t(a),)
        got = (tlpm._patch_span1(ins[0], start, _t(v)),)
    elif helper == "_patch_span_row":
        span = 1 << int(rs.integers(0, 16))
        row, start = int(rs.integers(0, 16)), int(rs.integers(0, 65536 - span + 1))
        a, v = ints(16, 65536), ints(span)
        want = (jlpm._patch_span_row(jnp.asarray(a), jnp.int32(row), jnp.int32(start), jnp.asarray(v)),)
        ins = (_t(a),)
        got = (tlpm._patch_span_row(ins[0], row, start, _t(v)),)
    else:
        k = int(rs.integers(1, 40))
        idx = np.sort(rs.choice(65536, k, replace=False))
        a, v = ints(65536), ints(k)
        want = (jlpm._patch_elems(jnp.asarray(a), jnp.asarray(idx.astype(np.int32)), jnp.asarray(v)),)
        ins = (_t(a),)
        got = (tlpm._patch_elems(ins[0], _t(idx.astype(np.int64)), _t(v)),)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    originals = (a, b) if helper == "_patch_trie_rows" else (a,)
    for t, o in zip(ins, originals):
        np.testing.assert_array_equal(t.numpy(), o)


# -- the pipeline, both packages ----------------------------------------------

def _world(pkg, seed, n_rules=24, n_idents=12):
    """The JAX package's sparse-delta test world through ``pkg``."""
    api = _mod(pkg, "policy.api")
    labels = _mod(pkg, "labels")
    rng = random.Random(seed)
    repo = _mod(pkg, "policy.repository").Repository()
    rules = []
    for i in range(n_rules):
        subject = [f"k8s:app=a{rng.randrange(8)}"]
        peer = api.EndpointSelector.make([f"k8s:app=a{rng.randrange(8)}"])
        to_ports = ((api.PortRule(ports=(api.PortProtocol(80, "TCP"),)),) if i % 3 == 0 else ())
        rules.append(api.rule(subject, ingress=[api.IngressRule(from_endpoints=(peer,),
                                                                to_ports=to_ports)]))
    repo.add_list(rules)
    reg = _mod(pkg, "identity").IdentityRegistry()
    idents = [reg.allocate(labels.parse_label_array(
        [f"k8s:app=a{rng.randrange(8)}", f"k8s:z=z{i % 3}"])) for i in range(n_idents)]
    cache = _mod(pkg, "ipcache").IPCache()
    for i, ident in enumerate(idents):
        cache.upsert(f"10.0.{i // 250}.{i % 250 + 1}", ident.id, "agent")
        cache.upsert(f"fd00:aa::{i + 1:x}", ident.id, "agent")
    return types.SimpleNamespace(repo=repo, reg=reg, cache=cache, idents=idents, api=api,
                                 labels=labels)


class Twin:
    """The same world, engine and pipeline in each package; ``kw`` and
    ``sparse_deltas`` go to both pipelines; ``deny`` fills both
    prefilters; ``ct`` gives each pipeline a FlowConntrack of its
    package."""

    def __init__(self, seed, *, sparse=True, deny=(), ct=False, **kw):
        self.w = {pkg: _world(pkg, seed) for pkg in PKGS}
        self.n = len(self.w["cilium_tpu"].idents)
        self.deny, self.ct, self.kw = list(deny), ct, kw
        self.eng = {pkg: self._engine(pkg) for pkg in PKGS}
        self.pipe = {pkg: self._pipe(pkg, self.eng[pkg], sparse) for pkg in PKGS}

    def _engine(self, pkg):
        w = self.w[pkg]
        dev = {} if pkg == "cilium_tpu" else {"device": "cpu"}
        return _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **dev)

    def _pipe(self, pkg, engine, sparse, **extra):
        w = self.w[pkg]
        dev = {} if pkg == "cilium_tpu" else {"device": "cpu"}
        pf = _mod(pkg, "ipcache").PreFilter()
        if self.deny:
            pf.insert(pf.revision, self.deny)
        kw = {**self.kw, **extra}
        if self.ct:
            kw["conntrack"] = _mod(pkg, "datapath.conntrack").FlowConntrack(capacity_bits=12)
        pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
            engine, w.cache, pf, sparse_deltas=sparse, **kw, **dev)
        pipe.set_endpoints([i.id for i in w.idents[:N_EPS]])
        return pipe

    @property
    def pt(self):
        return self.pipe["cilium_tpu_torch"]

    @property
    def pj(self):
        return self.pipe["cilium_tpu"]

    def each(self, fn):
        return {pkg: fn(pkg, self.w[pkg]) for pkg in PKGS}

    def upsert(self, ip, j):
        self.each(lambda pkg, w: w.cache.upsert(ip, w.idents[j].id, "agent"))

    def delete(self, ip):
        self.each(lambda pkg, w: w.cache.delete(ip, "agent"))

    def patches(self):
        return {pkg: {f: m.lpm_trie_patches_total.get({"family": str(f)}) for f in (4, 6)}
                for pkg, m in (("cilium_tpu", jmetrics), ("cilium_tpu_torch", tmetrics))}

    def rebuild(self):
        """Rebuild both → {family: mirror kept (patched)}, equal in both
        packages, with equal patch-metric movement and equal tries."""
        mirrors = {pkg: dict(p._trie_patch or {}) for pkg, p in self.pipe.items()}
        p0 = self.patches()
        for p in self.pipe.values():
            p.rebuild()
        p1 = self.patches()
        moved = {pkg: {f: p1[pkg][f] - p0[pkg][f] for f in (4, 6)} for pkg in PKGS}
        assert moved["cilium_tpu"] == moved["cilium_tpu_torch"], moved
        kept = {}
        for pkg, p in self.pipe.items():
            now = p._trie_patch or {}
            kept[pkg] = {f: mirrors[pkg].get(f) is not None and now.get(f) is mirrors[pkg][f]
                         for f in (4, 6)}
        assert kept["cilium_tpu"] == kept["cilium_tpu_torch"], kept
        self.check_tries()
        return kept["cilium_tpu_torch"]

    def check_tries(self):
        assert (self.pj._trie_patch is None) == (self.pt._trie_patch is None)
        if self.pt._trie_patch is not None:
            for f in (4, 6):
                mj, mt = self.pj._trie_patch[f], self.pt._trie_patch[f]
                assert (mj is None) == (mt is None), f
                if mt is not None:
                    for x, y in zip(mj.arrays(), mt.arrays()):
                        np.testing.assert_array_equal(y, x)
        jv4, jv6, jworld = self.pj._tries
        tv4, tv6 = self.pt._tries
        for name, a in zip(V4_FIELDS, jv4):
            np.testing.assert_array_equal(getattr(tv4, name).numpy(), np.asarray(a), err_msg=name)
        for name, a in zip(V6_FIELDS, jv6):
            np.testing.assert_array_equal(getattr(tv6, name).numpy(), np.asarray(a), err_msg=name)
        assert tv4.world_row == tv6.world_row == int(np.asarray(jworld))

    def flows(self, seed, extra=(), b=1024):
        rng = np.random.default_rng(seed)
        ips = [f"10.0.{j // 250}.{j % 250 + 1}" for j in rng.integers(0, self.n, b)] + list(extra)
        b = len(ips)
        return (_u32(ips), rng.integers(0, N_EPS, b).astype(np.int32),
                rng.choice(np.array([0, 80, 443], np.int32), b), np.full(b, 6, np.int32))

    def flows6(self, extra=()):
        peers = [f"fd00:aa::{i + 1:x}" for i in range(self.n)] + list(extra) + ["2001:db8::1"]
        addr = tlpm.ipv6_to_bytes(peers)
        b = addr.shape[0]
        return (addr, np.arange(b, dtype=np.int32) % N_EPS, np.full(b, 80, np.int32),
                np.full(b, 6, np.int32))

    def check(self, seed, extra=(), extra6=()):
        """Verdicts and redirects of a v4 and a v6 batch: the port ==
        the JAX pipeline == a fresh dense port pipeline."""
        fresh = self._pipe("cilium_tpu_torch", self._engine("cilium_tpu_torch"), False)
        for call, flows in (("process", self.flows(seed, extra)), ("process_v6", self.flows6(extra6))):
            got = getattr(self.pt, call)(*flows)
            want = getattr(self.pj, call)(*flows)
            dense = getattr(fresh, call)(*flows)
            for g, x, d in zip(got, want, dense):
                np.testing.assert_array_equal(g, np.asarray(x), err_msg=call)
                np.testing.assert_array_equal(g, d, err_msg=call)


def test_ipcache_churn_patches_not_rebuilds(monkeypatch):
    tw = Twin(0)
    tw.rebuild()
    assert all(tw.pt._trie_patch[f] is not None for f in (4, 6))
    builds = []
    real = tpipe.DatapathPipeline._build_tries_locked
    monkeypatch.setattr(tpipe.DatapathPipeline, "_build_tries_locked",
                        lambda self, c: (builds.append(1), real(self, c)))
    p0 = tw.patches()["cilium_tpu_torch"]
    tw.upsert("172.16.0.9", 3)
    tw.upsert("fd00:aa::77", 4)
    tw.delete(f"10.0.0.{tw.n}")
    assert tw.rebuild() == {4: True, 6: True}
    assert builds == []
    p1 = tw.patches()["cilium_tpu_torch"]
    assert (p1[4] - p0[4], p1[6] - p0[6]) == (2, 1)
    tw.check(3, extra=["172.16.0.9", "172.16.0.10"], extra6=["fd00:aa::77"])


def test_elision_violation_falls_back_to_full_rebuild():
    tw = Twin(1)
    tw.rebuild()
    tw.upsert("fd00:bb::1", 0)  # outside the elided fd00:aa:: common prefix
    assert tw.rebuild() == {4: False, 6: False}  # both mirrors made anew
    assert tw.pt._tables[(0, 6)].ip_common.shape[0] < 13
    tw.check(5, extra6=["fd00:bb::1"])


def test_fuzzed_mutation_stream_parity():
    tw = Twin(2)
    tw.rebuild()
    rng = random.Random(13)
    extra, new_idents = [], []
    kept_any = False
    for step in range(8):
        roll = rng.random()
        if roll < 0.3:  # ipcache-only churn: the patch path
            ip = f"172.16.{step}.{rng.randrange(1, 200)}"
            tw.upsert(ip, rng.randrange(tw.n))
            extra.append(ip)
        elif roll < 0.55:  # identity churn: a row event, the tries follow
            labels = [f"k8s:app=a{rng.randrange(8)}", f"k8s:fuzz=f{step}"]
            ip = f"172.17.0.{step + 1}"

            def alloc(pkg, w):
                ident = w.reg.allocate(w.labels.parse_label_array(labels))
                w.cache.upsert(ip, ident.id, "agent")
                return ident
            new_idents.append(tw.each(alloc))
            extra.append(ip)
        elif roll < 0.8:  # a rule append with a new selector
            app = f"k8s:app=a{rng.randrange(8)}"
            tw.each(lambda pkg, w: w.repo.add_list([w.api.rule(
                [app], ingress=[w.api.IngressRule(from_endpoints=(
                    w.api.EndpointSelector.make([f"k8s:fuzz=f{step}"]),))],
                labels=[f"k8s:policy=fuzz-{step}"])]))
        elif new_idents:  # an identity release
            idents = new_idents.pop(rng.randrange(len(new_idents)))
            tw.each(lambda pkg, w: w.reg.release(idents[pkg]))
        for e in tw.eng.values():
            e.refresh()
        kept = tw.rebuild()
        kept_any |= kept[4]
        tw.check(100 + step, extra=extra)
    assert kept_any


def test_kill_switch_off_never_touches_patch_paths(monkeypatch):
    tw = Twin(3, sparse=False)

    def boom(*a, **kw):
        raise AssertionError("sparse patch path reached while off")

    monkeypatch.setattr(tpipe.DatapathPipeline, "_patch_tries_locked", boom)
    for name in ("PatchableElidedTrie", "make_patchable_wide"):
        monkeypatch.setattr(tpipe, name, boom)
    for name in ("_patch_trie_rows", "_patch_span1", "_patch_span_row", "_patch_elems"):
        monkeypatch.setattr(tlpm, name, boom)
    tw.rebuild()
    assert tw.pt._trie_patch is None
    tw.upsert("172.16.0.9", 3)
    tw.each(lambda pkg, w: w.reg.allocate(w.labels.parse_label_array(["k8s:app=a1", "k8s:off=y"])))
    for e in tw.eng.values():
        e.refresh()
    tw.rebuild()
    assert tw.pt._trie_patch is None
    tw.check(7, extra=["172.16.0.9"])


def test_toggle_drops_and_rebuilds_patch_state():
    tw = Twin(4, sparse=False)
    tw.rebuild()
    for on in (True, False):
        for p in tw.pipe.values():
            p.set_sparse_deltas(on)
        assert tw.pt._tries is None and tw.pt._trie_patch is None
        tw.rebuild()
        assert (tw.pt._trie_patch is not None) == on
        if on:
            assert tw.pt._trie_patch[4] is not None
            assert tw.pt._tables[(0, 4)].ip_sub_info.shape[0] == tw.pt._trie_patch[4]._cap_rows
    tw.check(9)


@pytest.mark.parametrize("deny", [
    ["10.0.0.0/28", "fd00:aa::/124"],  # both families fused: nothing patched
    ["192.0.2.0/24"],  # a v4 deny set: only v6 patched
])
def test_live_deny_set_takes_the_full_rebuild(deny):
    tw = Twin(5, deny=deny)
    tw.rebuild()
    v6_only = not any(":" in c for c in deny)
    assert (tw.pt._trie_patch[4], tw.pt._trie_patch[6] is not None) == (None, v6_only)
    tw.upsert("fd00:aa::77", 2)
    assert tw.rebuild() == {4: False, 6: v6_only}
    tw.upsert("172.16.0.9", 3)
    assert tw.rebuild() == {4: False, 6: False}
    tw.check(11, extra=["172.16.0.9", "10.0.0.3"], extra6=["fd00:aa::77", "fd00:aa::3"])


def test_depth2_ct_replay_parity():
    """Sparse and dense pipelines (and the JAX sparse one) through the
    same batches and mutations at depth 2 with conntrack."""
    tw = Twin(6, ct=True, pipeline_depth=2)
    dense = tw._pipe("cilium_tpu_torch", tw.eng["cilium_tpu_torch"], False)
    pipes = [tw.pt, tw.pj, dense]
    tw.rebuild()
    dense.rebuild()
    rng = np.random.default_rng(21)

    def batch(seed, extra=()):
        f = tw.flows(seed, extra, b=512)
        return (*f, rng.integers(1024, 60000, f[0].shape[0]).astype(np.int32))

    first = batch(1)
    outs = [p.process(*first[:4], sports=first[4]) for p in pipes]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0][0], np.asarray(o[0]))
    tw.upsert("172.19.0.1", 2)

    def alloc(pkg, w):
        ident = w.reg.allocate(w.labels.parse_label_array(["k8s:app=a3", "k8s:ct=c1"]))
        w.cache.upsert("172.19.0.2", ident.id, "agent")
    tw.each(alloc)
    for e in tw.eng.values():
        e.refresh()
    tw.rebuild()
    dense.rebuild()
    for b in (first, batch(2, ["172.19.0.1", "172.19.0.2"])):
        outs = [p.process(*b[:4], sports=b[4]) for p in pipes]
        for o in outs[1:]:
            np.testing.assert_array_equal(outs[0][0], np.asarray(o[0]))
            np.testing.assert_array_equal(outs[0][1], np.asarray(o[1]))


# -- port-only ----------------------------------------------------------------

def test_tries_taken_before_a_churn_are_unchanged():
    tw = Twin(8)
    tw.rebuild()
    v4, v6 = tw.pt._tries
    held = [getattr(v4, f) for f in V4_FIELDS] + [getattr(v6, f) for f in V6_FIELDS]
    copies = [t.clone() for t in held]
    tw.upsert("10.0.0.200", 5)
    tw.upsert("fd00:aa::99", 5)
    tw.delete("10.0.0.1")
    assert tw.rebuild() == {4: True, 6: True}
    n4, n6 = tw.pt._tries
    assert n4.ip_sub_info is not v4.ip_sub_info and n6.ip_info is not v6.ip_info
    for t, c in zip(held, copies):
        assert torch.equal(t, c)


def test_batch_submitted_before_a_churn_keeps_its_verdicts():
    tw = Twin(9, pipeline_depth=2)
    tw.rebuild()
    flows = tw.flows(4, extra=["10.0.0.1", "10.0.0.2"] * 50)
    want = tw.pt.process(*flows)
    pend = tw.pt.submit(*flows)
    # remap every address of identity 0 and 1 onto identity 2 / 3
    tw.upsert("10.0.0.1", 7)
    tw.upsert("10.0.0.2", 8)
    assert tw.rebuild()[4]
    got = pend.result()
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert not np.array_equal(tw.pt.process(*flows)[0], want[0])
    tw.check(4, extra=["10.0.0.1", "10.0.0.2"] * 50)
