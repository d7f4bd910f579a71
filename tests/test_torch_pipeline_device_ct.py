"""Port parity: ``DatapathPipeline(device_ct_bits=...)`` — device-resident
conntrack inside ``process`` / ``process_v6``.

Both packages build the same worlds (the two-rule world of
``tests/test_device_ct.py`` and the harness world with IPv6 peers) and
see the same batch sequences, with ``time.monotonic`` pinned for both:
v4 and v6, ingress and egress, the replies of admitted flows, redirect
policies, a rule delete between batches, an overlay batch and an LB
family (both on the host CT fallback). After every batch the verdicts,
redirects and per-endpoint counters must be equal, with one named
exception.

The exception is the reference's slot C-1 fault (ROADMAP queue C). The
JAX step writes the key of the last lane it skips into slot C-1 with a
live expiry; in a batch that fills its shape bucket exactly (no pad
lanes) that is a real flow's key. When that flow comes back and its
probe window covers C-1, JAX finds it there and forwards it, where the
port, which writes nothing for skipped lanes, gives its policy verdict.
``Pair.run`` computes that case from JAX's slot C-1 before each batch
and asserts that every lane that differs is such a lane.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.datapath.conntrack import FlowConntrack, flip_kc, pack_keys
from cilium_tpu_torch.datapath.device_ct import _hash_tuple_np, split_u64
from test_torch_harness import PKGS, build_world, random_flows
from test_torch_pipeline_v6 import add_v6, v6_flows

BITS = 10
C = 1 << BITS
N_EPS = 6
FORWARD, DROP_POLICY, DROP_PREFILTER = tpipe.FORWARD, tpipe.DROP_POLICY, tpipe.DROP_PREFILTER


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _dev(pkg: str) -> dict:
    return {} if pkg == "cilium_tpu" else {"device": "cpu"}


@pytest.fixture
def clock(monkeypatch):
    """``time.monotonic`` pinned (both pipelines read it per batch);
    advance with ``clock[0] += s``."""
    now = [50_000.25]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


def u32(ips) -> np.ndarray:
    import ipaddress

    return np.array([int(ipaddress.IPv4Address(ip)) for ip in ips], np.uint32)


def small_world(pkg: str, *, device_ct: bool = True, redirect: bool = False):
    """The world of tests/test_device_ct.py through ``pkg``: web admits
    lb:80 (an HTTP rule on it with ``redirect``) and may reach db:5432;
    lb = 10.0.0.2 / fd00::2, db = 10.0.0.3, prefilter 192.0.2.0/24."""
    api = _mod(pkg, "policy.api")
    parse = _mod(pkg, "labels").parse_label_array
    repo = _mod(pkg, "policy.repository").Repository()
    l7 = api.L7Rules(http=(api.HTTPRule(path="/x"),)) if redirect else api.L7Rules()
    repo.add_list([api.rule(
        ["k8s:app=web"],
        ingress=[api.IngressRule(
            from_endpoints=(api.EndpointSelector.make(["k8s:app=lb"]),),
            to_ports=(api.PortRule(ports=(api.PortProtocol(80, "TCP"),), rules=l7),),
        )],
        egress=[api.EgressRule(
            to_endpoints=(api.EndpointSelector.make(["k8s:app=db"]),),
            to_ports=(api.PortRule(ports=(api.PortProtocol(5432, "TCP"),)),),
        )],
        labels=["k8s:policy=d0"],
    )])
    reg = _mod(pkg, "identity").IdentityRegistry()
    web, lb, db = (reg.allocate(parse([f"k8s:app={a}"])) for a in ("web", "lb", "db"))
    cache = _mod(pkg, "ipcache.ipcache").IPCache()
    cache.upsert("10.0.0.2/32", lb.id, source="k8s")
    cache.upsert("10.0.0.3/32", db.id, source="k8s")
    cache.upsert("fd00::2/128", lb.id, source="k8s")
    pf = _mod(pkg, "ipcache.prefilter").PreFilter()
    pf.insert(pf.revision, ["192.0.2.0/24"])
    ct = None if device_ct else _mod(pkg, "datapath.conntrack").FlowConntrack(capacity_bits=12)
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
        _mod(pkg, "engine").PolicyEngine(repo, reg, **_dev(pkg)), cache, pf, conntrack=ct,
        device_ct_bits=BITS if device_ct else None, **_dev(pkg))
    pipe.set_endpoints([web.id])
    return pipe, repo


def small_flows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    ips = u32(["10.0.0.2", "10.0.0.3", "192.0.2.7", "8.8.8.8"])[rng.integers(0, 4, n)]
    dports = rng.choice(np.array([80, 443, 5432], np.int32), n)
    return (ips, np.zeros(n, np.int32), dports, np.full(n, 6, np.int32),
            rng.integers(1024, 60000, n).astype(np.int32))


def lane_keys(fam, peer, ep, sports, dports, protos, ingress):
    """Each lane's forward and reply CT keys as six uint32 words, and
    the start slot of each probe window."""
    peer = np.asarray(peer)
    if fam == 4:
        hi, lo = np.zeros(peer.shape[0], np.uint64), peer.astype(np.uint64)
    else:
        shift = np.arange(7, -1, -1, dtype=np.uint64) * np.uint64(8)
        b = peer.astype(np.uint64)
        hi = (b[:, :8] << shift).sum(axis=1, dtype=np.uint64)
        lo = (b[:, 8:] << shift).sum(axis=1, dtype=np.uint64)
    n = peer.shape[0]
    ka, kb, kc = pack_keys(hi, lo, np.asarray(ep, np.uint64), np.asarray(sports, np.uint64),
                           np.asarray(dports, np.uint64), np.asarray(protos, np.uint64),
                           np.full(n, 0 if ingress else 1, np.uint64))
    out = []
    for k in (kc, flip_kc(kc)):
        words = np.stack([*split_u64(ka), *split_u64(kb), *split_u64(k)], 1)
        start = _hash_tuple_np(*words.T) & np.uint32(C - 1)
        out.append((words, start))
    return out


class Pair:
    """A JAX and a port pipeline over one world; ``run`` feeds both a
    batch and holds them equal outside the named slot C-1 case."""

    def __init__(self, pipes):
        self.j, self.t = pipes["cilium_tpu"], pipes["cilium_tpu_torch"]
        self.delta = None  # what the named lanes moved the port's counters by
        self.named = 0

    def _c1(self):
        st = self.j._device_ct
        if st is None:
            return None
        exp = int(np.asarray(st.exp)[C - 1])
        if exp <= int(time.monotonic()):
            return None
        return np.array([np.asarray(w)[C - 1] for w in st[:6]], np.uint32)

    def run(self, fam, peer, ep, dports, protos, *, ingress, sports=None, **kw):
        c1 = self._c1()
        call = "process" if fam == 4 else "process_v6"
        want = getattr(self.j, call)(peer, ep, dports, protos, ingress=ingress, sports=sports, **kw)
        got = getattr(self.t, call)(peer, ep, dports, protos, ingress=ingress, sports=sports, **kw)
        assert len(got) == len(want)
        diff = np.zeros(len(ep), bool)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            diff |= g != w
        if self.delta is None or self.delta.shape != self.t.counters.shape:
            self.delta = np.zeros_like(self.t.counters)
        if diff.any():
            assert c1 is not None and sports is not None, "lanes differ with slot C-1 free"
            named = np.zeros(len(ep), bool)
            for words, start in lane_keys(fam, peer, ep, sports, dports, protos, ingress):
                covers = ((C - 1 - start.astype(np.int64)) % C) < 8
                named |= covers & (words == c1).all(1)
            assert named[diff].all(), f"lanes {np.nonzero(diff & ~named)[0]} differ outside slot C-1"
            assert (want[0][diff] == FORWARD).all() and not want[1][diff].any()
            for i in np.nonzero(diff)[0]:
                self.delta[ep[i], got[0][i] - 1] += 1
                self.delta[ep[i], 0] -= 1
            self.named += int(diff.sum())
        np.testing.assert_array_equal(self.t.counters - self.j.counters, self.delta)
        return got


def small_pair(**kw):
    pipes, repos = {}, {}
    for pkg in PKGS:
        pipes[pkg], repos[pkg] = small_world(pkg, **kw)
    return Pair(pipes), repos


def test_small_world_sequences_match_jax(clock):
    """The tests/test_device_ct.py world: random ingress batches (every
    verdict code), an egress flow and its reply, v6 and its reply, the
    same flows after time moves on, and after a rule delete."""
    pair, repos = small_pair()
    seen = set()
    for seed in range(3):
        ips, eps, dports, protos, sports = small_flows(256, seed)
        v, _ = pair.run(4, ips, eps, dports, protos, ingress=True, sports=sports)
        seen |= set(v.tolist())
    assert {FORWARD, DROP_POLICY, DROP_PREFILTER} <= seen
    db = u32(["10.0.0.3"] * 8)
    one = (np.zeros(8, np.int32), np.full(8, 6, np.int32))
    sp = np.arange(8, dtype=np.int32) + 40000
    v, _ = pair.run(4, db, one[0], np.full(8, 5432, np.int32), one[1], ingress=False, sports=sp)
    assert (v == FORWARD).all()
    v, _ = pair.run(4, db, one[0], sp, one[1], ingress=True, sports=np.full(8, 5432, np.int32))
    assert (v == FORWARD).all(), "device CT missed the reply tuple"
    from cilium_tpu_torch.ops.lpm import ipv6_to_bytes

    p6 = ipv6_to_bytes(["fd00::2"] * 4).astype(np.int32)
    for ingress, dport, sport in ((True, 80, 5151), (True, 80, 5151), (False, 5151, 80)):
        v, _ = pair.run(6, p6, np.zeros(4, np.int32), np.full(4, dport, np.int32),
                        np.full(4, 6, np.int32), ingress=ingress, sports=np.full(4, sport, np.int32))
        assert (v == FORWARD).all()
    clock[0] += 120  # TCP entries outlive two minutes
    ips, eps, dports, protos, sports = small_flows(256, 0)
    pair.run(4, ips, eps, dports, protos, ingress=True, sports=sports)
    for pkg in PKGS:
        repos[pkg].delete_by_labels(_mod(pkg, "labels").parse_label_array(["k8s:policy=d0"]))
    v, _ = pair.run(4, ips, eps, dports, protos, ingress=True, sports=sports)
    assert not (v == FORWARD).any(), "an established bypass survived the rule delete"


def _window_covers_last(fam_args, want_cover=True, n_try=60000):
    """A sport for the flow ``fam_args`` = (peer u32, dport) ingress on
    endpoint 0 whose forward window covers slot C-1."""
    peer, dport = fam_args
    sports = np.arange(1024, 1024 + n_try, dtype=np.int64)
    (words, start), _ = lane_keys(4, np.full(n_try, peer, np.uint32), np.zeros(n_try, np.int64),
                                  sports, np.full(n_try, dport), np.full(n_try, 6), True)
    covers = ((C - 1 - start.astype(np.int64)) % C) < 8
    return int(sports[np.nonzero(covers == want_cover)[0][0]])


def test_named_case_slot_c_minus_1(clock):
    """The named divergence made on purpose: a batch of exactly C denied
    flows (no pad lanes) whose last lane's window covers slot C-1. JAX
    leaves that flow's key in slot C-1, live; when the flow returns JAX
    forwards it and the port drops it. A padded batch before it leaves
    only a pad lane's key there, which no flow matches."""
    pair, _ = small_pair()
    lb = int(u32(["10.0.0.2"])[0])
    ips, eps, dports, protos, sports = small_flows(1000, 4)  # padded to 1024
    pair.run(4, ips, eps, dports, protos, ingress=True, sports=sports)
    pair.run(4, ips, eps, dports, protos, ingress=True, sports=sports)
    assert pair.named == 0
    last = _window_covers_last((lb, 443))
    sp = np.arange(C, dtype=np.int32) + 20000
    sp[-1] = last
    denied = (np.full(C, lb, np.uint32), np.zeros(C, np.int32), np.full(C, 443, np.int32),
              np.full(C, 6, np.int32))
    v, _ = pair.run(4, *denied, ingress=True, sports=sp)
    assert (v == DROP_POLICY).all() and pair.named == 0
    back = (denied[0][:3], denied[1][:3], denied[2][:3], denied[3][:3])
    v, _ = pair.run(4, *back, ingress=True, sports=np.array([20000, last, 20001], np.int32))
    assert v.tolist() == [DROP_POLICY] * 3
    assert pair.named == 1, "the JAX slot C-1 fault did not show"


def harness_pair(seed: int, lb: bool = False):
    pipes, worlds, peers6 = {}, {}, None
    for pkg in PKGS:
        w = build_world(pkg, seed)
        p6 = add_v6(w)
        assert peers6 is None or p6 == peers6
        peers6 = p6
        pf = _mod(pkg, "ipcache.prefilter").PreFilter()
        pf.insert(pf.revision, ["172.16.0.0/30", "fd00::1:0/126"])
        pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
            _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_dev(pkg)), w.ipcache, pf,
            device_ct_bits=BITS, **_dev(pkg))
        pipe.set_endpoints([(300 + k, i.id) for k, i in enumerate(w.idents[:N_EPS])])
        pipes[pkg], worlds[pkg] = pipe, w
    return Pair(pipes), worlds, peers6


@pytest.mark.parametrize("seed", [0, 4, 5])  # worlds whose flows meet L7 (redirect) rules
def test_harness_world_sequences_match_jax(clock, seed):
    """The harness world (deny, L4, L7-redirect and egress-CIDR rules):
    per family an ingress batch (padded), an egress batch of exactly C
    flows and the same again, its replies, UDP entries expiring, the
    redirect hook, a rule delete, and an overlay batch on the host CT."""
    pair, worlds, peers6 = harness_pair(seed)
    hooks = {pkg: [] for pkg in PKGS}
    for pkg, pipe in ((PKGS[0], pair.j), (PKGS[1], pair.t)):
        pipe.on_redirect = lambda *a, out=hooks[pkg]: out.append(a)
    w = worlds["cilium_tpu"]
    rs = np.random.default_rng(seed + 50)
    n_fwd = n_red = 0
    for fam in (4, 6):
        def flows(n, s):
            if fam == 4:
                return random_flows(w, n, N_EPS, s)
            return v6_flows(peers6, n, s)

        peer, ep, dp, pr = flows(700, seed)
        v, r = pair.run(fam, peer, ep, dp, pr, ingress=True,
                        sports=rs.integers(1024, 60000, 700).astype(np.int32))
        n_red += int(r.sum())
        peer, ep, dp, pr = flows(C, seed + 7)
        sp = rs.integers(1024, 60000, C).astype(np.int32)
        for _ in range(2):
            v, r = pair.run(fam, peer, ep, dp, pr, ingress=False, sports=sp)
            n_fwd += int((v == FORWARD).sum())
            n_red += int(r.sum())
        v, _ = pair.run(fam, peer, ep, sp, pr, ingress=True, sports=dp)
        clock[0] += 90  # UDP entries (60 s) expire, TCP ones stay
        pair.run(fam, peer, ep, sp, pr, ingress=True, sports=dp)
    assert n_fwd and n_red
    assert hooks[PKGS[0]] == hooks[PKGS[1]] and hooks[PKGS[1]]
    # a rule delete flushes both device tables
    for pkg in PKGS:
        worlds[pkg].repo.delete_by_labels(_mod(pkg, "labels").parse_label_array(["k8s:policy=fz3"]))
    peer, ep, dp, pr = random_flows(w, 500, N_EPS, seed + 9)
    sp = rs.integers(1024, 60000, 500).astype(np.int32)
    pair.run(4, peer, ep, dp, pr, ingress=False, sports=sp)
    pair.run(4, peer, ep, sp, pr, ingress=True, sports=dp)
    # overlay flows fall back to the host CT in both packages
    tun = np.where(rs.random(500) < 0.5, np.array([i.id for i in w.idents])[ep], 0)
    for _ in range(2):
        pair.run(4, peer, ep, dp, pr, ingress=True, sports=sp, tunnel_identities=tun)
    assert len(pair.t.conntrack) == len(pair.j.conntrack) > 0


def test_matches_port_host_ct_pipeline(clock):
    """The port's device-CT pipeline equals its own host-CT pipeline on
    random batches (TestParityWithHostCT of the reference)."""
    hp, _ = small_world("cilium_tpu_torch", device_ct=False)
    dp, _ = small_world("cilium_tpu_torch")
    seen = set()
    for seed in range(3):
        ips, eps, dports, protos, sports = small_flows(256, seed)
        want = hp.process(ips, eps, dports, protos, ingress=True, sports=sports)
        got = dp.process(ips, eps, dports, protos, ingress=True, sports=sports)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)
        seen |= set(got[0].tolist())
    np.testing.assert_array_equal(dp.counters, hp.counters)
    assert {FORWARD, DROP_POLICY, DROP_PREFILTER} <= seen
    assert len(hp.conntrack) > 0 and len(dp.conntrack) == 0 and dp._device_ct is not None


def _one(ip, dport, sport, *, fam=4):
    from cilium_tpu_torch.ops.lpm import ipv6_to_bytes

    peer = u32([ip]) if fam == 4 else ipv6_to_bytes([ip]).astype(np.int32)
    return (peer, np.zeros(1, np.int32), np.array([dport], np.int32), np.full(1, 6, np.int32)), \
        np.array([sport], np.int32)


@pytest.mark.parametrize("case", ["established", "reply", "denied", "redirect", "rule_change",
                                  "v6", "endpoints"])
def test_port_device_ct_behaviour(clock, case):
    """The reference's device-CT checks, on the port: the established
    bypass across batches, the reply tuple, denied and redirected flows
    never cached, the flush on a rule change and on an endpoint change,
    and v6 with its reply."""
    dp, repo = small_world("cilium_tpu_torch", redirect=case == "redirect")
    if case == "established":
        args, sp = _one("10.0.0.2", 80, 7777)
        for _ in range(2):
            assert dp.process(*args, ingress=True, sports=sp)[0].tolist() == [FORWARD]
        assert dp.counters[0, 0] == 2
    elif case == "reply":
        args, sp = _one("10.0.0.3", 5432, 40000)
        assert dp.process(*args, ingress=False, sports=sp)[0].tolist() == [FORWARD]
        args, sp = _one("10.0.0.3", 40000, 5432)
        assert dp.process(*args, ingress=True, sports=sp)[0].tolist() == [FORWARD]
    elif case == "denied":
        args, _ = _one("8.8.8.8", 80, 0)
        for i in range(3):
            v, _ = dp.process(*args, ingress=True, sports=np.array([6000 + i], np.int32))
            assert v.tolist() == [DROP_POLICY]
        assert not bool((dp._device_ct.exp > 0).any())
    elif case == "redirect":
        args, sp = _one("10.0.0.2", 80, 9999)
        for _ in range(3):
            v, r = dp.process(*args, ingress=True, sports=sp)
            assert v.tolist() == [FORWARD] and r.tolist() == [True]
        assert not bool((dp._device_ct.exp > 0).any())
    elif case == "rule_change":
        args, sp = _one("10.0.0.2", 80, 4242)
        assert dp.process(*args, ingress=True, sports=sp)[0].tolist() == [FORWARD]
        repo.delete_by_labels(_mod("cilium_tpu_torch", "labels").parse_label_array(["k8s:policy=d0"]))
        assert dp.process(*args, ingress=True, sports=sp)[0].tolist() == [DROP_POLICY]
    elif case == "v6":
        args, sp = _one("fd00::2", 80, 5151, fam=6)
        for _ in range(2):
            assert dp.process_v6(*args, ingress=True, sports=sp)[0].tolist() == [FORWARD]
        args, sp = _one("fd00::2", 5151, 80, fam=6)
        assert dp.process_v6(*args, ingress=False, sports=sp)[0].tolist() == [FORWARD]
    else:
        args, sp = _one("10.0.0.2", 80, 4243)
        dp.process(*args, ingress=True, sports=sp)
        assert dp._device_ct is not None
        dp.set_endpoints(list(dp._endpoints))
        assert dp._device_ct is None


@pytest.mark.parametrize("ep", [1 << 23, -1])
def test_device_ct_refuses_ep_idx_past_kc_bits(clock, ep):
    """An endpoint index that the 23 bits of the kc word cannot hold is
    refused on the host before anything reaches the table."""
    dp, _ = small_world("cilium_tpu_torch")
    (peer, eps, dports, protos), sp = _one("10.0.0.2", 80, 7000)
    with pytest.raises(ValueError, match="23 bits"):
        dp.process(peer, eps + ep, dports, protos, ingress=True, sports=sp)
    assert dp._device_ct is None or not bool((dp._device_ct.exp > 0).any())


def test_lb_family_uses_one_host_ct_domain_both_directions(clock):
    """With an LB table for a family, BOTH directions take the host CT
    in both packages (the reference's TestLBFallback): the egress VIP
    flow and its reply share one CT domain, and the reply carries the
    revNAT id; the device table is never made."""
    out = {}
    for pkg in PKGS:
        api = _mod(pkg, "policy.api")
        lbmod = _mod(pkg, "lb")
        parse = _mod(pkg, "labels").parse_label_array
        repo = _mod(pkg, "policy.repository").Repository()
        repo.add_list([api.rule(["k8s:app=web"], egress=[api.EgressRule(
            to_endpoints=(api.EndpointSelector.make(["k8s:app=db"]),),
            to_ports=(api.PortRule(ports=(api.PortProtocol(8080, "TCP"),)),),
        )])])
        reg = _mod(pkg, "identity").IdentityRegistry()
        web, db = reg.allocate(parse(["k8s:app=web"])), reg.allocate(parse(["k8s:app=db"]))
        cache = _mod(pkg, "ipcache.ipcache").IPCache()
        cache.upsert("10.0.0.3/32", db.id, source="k8s")
        lbm = lbmod.ServiceManager()
        lbm.upsert(lbmod.L3n4Addr("10.96.0.10", 80, "TCP"), [lbmod.Backend("10.0.0.3", 8080)])
        dp = _mod(pkg, "datapath.pipeline").DatapathPipeline(
            _mod(pkg, "engine").PolicyEngine(repo, reg, **_dev(pkg)), cache,
            _mod(pkg, "ipcache.prefilter").PreFilter(), lb=lbm, device_ct_bits=BITS, **_dev(pkg))
        dp.set_endpoints([web.id])
        assert dp.conntrack is not None, "no host CT fallback for LB flows"
        args, sp = _one("10.96.0.10", 80, 4000)
        v1 = dp.process(*args, ingress=False, sports=sp, return_rev_nat=True)
        args, sp = _one("10.0.0.3", 4000, 8080)
        v2 = dp.process(*args, ingress=True, sports=sp, return_rev_nat=True)
        assert v1[0].tolist() == v2[0].tolist() == [FORWARD], "reply lost across CT domains"
        assert int(v2[2][0]) > 0 and dp.rev_nat_frontend(int(v2[2][0])).ip == "10.96.0.10"
        assert dp._device_ct is None and len(dp.conntrack) == 1
        out[pkg] = (v1, v2)
    for a, b in zip(out[PKGS[0]], out[PKGS[1]]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_positional_constructor_matches_reference(clock):
    """``DatapathPipeline(engine, ipcache, prefilter, conntrack)`` by
    position builds a host-CT pipeline in both packages (the port used
    to take ``device`` fourth); ``device_ct_bits`` is the seventh
    positional argument in both; the port refuses a monitor, and the
    rest of the reference's positional order follows (``tracer``
    eighth)."""
    out = {}
    for pkg in PKGS:
        w = build_world(pkg, 3)
        ct = _mod(pkg, "datapath.conntrack").FlowConntrack(capacity_bits=12)
        eng = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_dev(pkg))
        cls = _mod(pkg, "datapath.pipeline").DatapathPipeline
        pf = _mod(pkg, "ipcache.prefilter").PreFilter()
        pipe = cls(eng, w.ipcache, pf, ct, **_dev(pkg))
        assert pipe.conntrack is ct and pipe.prefilter is pf and pipe.lb is None
        pipe.set_endpoints([i.id for i in w.idents[:N_EPS]])
        flows = random_flows(w, 400, N_EPS, 2)
        out[pkg] = pipe.process(*flows, ingress=True, sports=np.arange(400) + 1000)
        assert len(ct) > 0
        dct = cls(eng, w.ipcache, None, None, None, None, 11, **_dev(pkg))
        assert dct._device_ct_bits == 11 and dct.conntrack.capacity == 1 << 11
    for g, w_ in zip(out[PKGS[1]], out[PKGS[0]]):
        np.testing.assert_array_equal(g, w_)
    # the sixth positional argument is the reference's ``monitor``: a hub
    # there is taken as the pipeline's
    from cilium_tpu_torch.monitor import MonitorHub

    hub = MonitorHub()
    assert tpipe.DatapathPipeline(eng, w.ipcache, None, None, None, hub,
                                  device="cpu").monitor is hub
    # the eighth positional argument is the reference's ``tracer``, not
    # the device: a Tracer there is taken as the pipeline's tracer
    t = tpipe.Tracer()
    assert tpipe.DatapathPipeline(eng, w.ipcache, None, None, None, None, None, t,
                                  device="cpu").tracer is t
    # ``device`` stays keyword-only: past the reference's 23 positional
    # parameters nothing more is taken
    reference_defaults = (None, None, None, None, None, None, 2, False, None, 4, False,
                          False, None, False, False, False, False, 0.0, 0.0, False, 64)
    assert isinstance(tpipe.DatapathPipeline(eng, w.ipcache, *reference_defaults, device="cpu"),
                      tpipe.DatapathPipeline)
    with pytest.raises(TypeError):
        tpipe.DatapathPipeline(eng, w.ipcache, *reference_defaults, "cpu")
