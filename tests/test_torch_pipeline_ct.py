"""Port parity: the stateful pipeline — services, connection tracking,
revNAT and overlay identities in ``process`` / ``process_v6``.

The harness world (plus one IPv6 /128 per identity) gets the same
services in both packages: ClusterIP frontends whose backends are the
world's identity addresses, a frontend with no backend, and an ANY
frontend beside a TCP one on the same VIP and port. The JAX pipeline
and the port each get their own ``FlowConntrack`` and see the same
batch sequences, both families and both directions: new flows through
the LB stage and the miss tail, the same flows again through the CT
bypass, the replies from the backends with ``return_rev_nat``, and the
control-plane moves that must flush the conntrack. After every batch
the verdicts, redirects, revNAT ids, the per-endpoint counters and the
live CT keys (``ka``, ``kb``, ``kc``, ``revnat``, ``packets``; liveness,
not expiry, since the clocks differ) must be equal.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from cilium_tpu import metrics as jmetrics
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.lb.device import flow_hash32, lb_translate
from cilium_tpu_torch.ops.lpm import ipv4_to_bytes, ipv6_to_bytes
from test_torch_harness import PKGS, build_world, random_flows
from test_torch_pipeline_v6 import add_v6, v6_flows

N_EPS = 6
B = 1500
FE_PORTS = [(80, "TCP"), (443, "TCP"), (8080, "TCP"), (5432, "TCP"), (53, "UDP")]
N_FE4, N_FE6 = 24, 12


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _services(pkg: str, world, peers6, seed: int):
    """The same ServiceManager through ``pkg``'s own modules."""
    lb = _mod(pkg, "lb")
    rs = np.random.default_rng(seed + 100)
    m = lb.ServiceManager()
    n_idents = len(world.idents)
    for fam, n in ((4, N_FE4), (6, N_FE6)):
        for i in range(n):
            port, proto = FE_PORTS[i % len(FE_PORTS)]
            vip = f"10.96.{i // 200}.{i % 200 + 1}" if fam == 4 else f"fd00:96::{i + 1:x}"
            n_back = 0 if i % 11 == 5 else int(rs.integers(1, 5))
            picks = rs.integers(0, n_idents, n_back)
            backs = [
                lb.Backend(world.peer_ips[j] if fam == 4 else peers6[j],
                           int(rs.choice([80, 443, 8080, 53])),
                           int(rs.integers(1, 5)) if i % 4 == 0 else 1)
                for j in picks
            ]
            m.upsert(lb.L3n4Addr(vip, port, proto), backs)
            if i % 7 == 2:
                # an ANY frontend on the same VIP and port
                m.upsert(lb.L3n4Addr(vip, port, "ANY"), backs[::-1])
    return m


class Stack:
    """Both pipelines over one world, with their own conntracks."""

    def __init__(self, seed: int, *, with_ct=True, with_lb=True, deny=()):
        self.w = {p: build_world(p, seed) for p in ("cilium_tpu", "cilium_tpu_torch")}
        self.peers6 = add_v6(self.w["cilium_tpu"])
        assert add_v6(self.w["cilium_tpu_torch"]) == self.peers6
        self.pipes = {}
        self.lb = {}
        for pkg, w in self.w.items():
            pf = _mod(pkg, "ipcache.prefilter").PreFilter()
            if deny:
                pf.insert(pf.revision, list(deny))
            ct = _mod(pkg, "datapath.conntrack").FlowConntrack(capacity_bits=14) if with_ct else None
            lbm = _services(pkg, w, self.peers6, seed) if with_lb else None
            self.lb[pkg] = lbm
            dev = {} if pkg == "cilium_tpu" else {"device": "cpu"}
            eng = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **dev)
            pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
                eng, w.ipcache, pf, conntrack=ct, lb=lbm, **dev)
            # stable endpoint ids differ from the identity ids
            pipe.set_endpoints([(500 + 7 * k, i.id) for k, i in enumerate(w.idents[:N_EPS])])
            self.pipes[pkg] = pipe
        self.j, self.t = self.pipes["cilium_tpu"], self.pipes["cilium_tpu_torch"]

    def both(self, fn):
        for pkg in self.pipes:
            fn(pkg, self.pipes[pkg], self.w[pkg])

    def run(self, fam: int, flows, **kw):
        """One batch through both; outputs, counters and CT keys equal."""
        peer, *rest = flows
        call = "process" if fam == 4 else "process_v6"
        arg = _pack(peer) if fam == 4 else peer
        want = getattr(self.j, call)(arg, *rest, **kw)
        got = getattr(self.t, call)(arg, *rest, **kw)
        assert len(got) == len(want)
        for name, g, w_ in zip(("verdict", "redirect", "revnat"), got, want):
            assert g.dtype == w_.dtype, name
            np.testing.assert_array_equal(g, w_, err_msg=name)
        np.testing.assert_array_equal(self.t.counters, self.j.counters)
        ct_equal(self.t.conntrack, self.j.conntrack)
        return got


def _pack(peer_bytes: np.ndarray) -> np.ndarray:
    b = peer_bytes.astype(np.uint32)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def ct_keys(ct):
    s = ct.snapshot_arrays()
    order = np.lexsort((s["kc"], s["kb"], s["ka"]))
    return {k: s[k][order] for k in ("ka", "kb", "kc", "revnat", "packets")}


def ct_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    ka, kb = ct_keys(a), ct_keys(b)
    for k in ka:
        np.testing.assert_array_equal(ka[k], kb[k], err_msg=f"ct {k}")


def egress_flows(st: Stack, fam: int, n: int, seed: int):
    """(peer bytes, ep, dport, proto, sports): 1/4 to the frontends
    (of either protocol where the frontend is ANY), 3/4 the harness's
    flows; sports from a small range, so some keys repeat."""
    rs = np.random.default_rng(seed)
    w = st.w["cilium_tpu"]
    if fam == 4:
        peer, ep, dp, pr = random_flows(w, n, N_EPS, seed)
        peer = ipv4_to_bytes(peer)
    else:
        peer, ep, dp, pr = v6_flows(st.peers6, n, seed)
    fes = [s.frontend for s in st.lb["cilium_tpu"].list() if s.frontend.family == fam]
    vip = rs.random(n) < 0.25
    pick = rs.integers(0, len(fes), n)
    fe_bytes = (ipv4_to_bytes(np.array([int(_ip4(f.ip)) for f in fes], np.uint32)) if fam == 4
                else ipv6_to_bytes([f.ip for f in fes]))
    fe_port = np.array([f.port for f in fes], np.int32)
    fe_proto = np.array([f.proto_num or rs.choice([6, 17]) for f in fes], np.int32)
    peer = np.where(vip[:, None], fe_bytes[pick], peer).astype(np.int32)
    dp = np.where(vip, fe_port[pick], dp).astype(np.int32)
    pr = np.where(vip, fe_proto[pick], pr).astype(np.int32)
    return peer, ep, dp, pr, rs.integers(1024, 1100, n)


def _ip4(s: str) -> int:
    import ipaddress

    return int(ipaddress.IPv4Address(s))


def translate(pipe, fam: int, peer, ep, dp, pr, sports):
    """The port's LB stage by hand: (backend bytes, backend port) of
    each flow, the flow itself where no frontend translated it."""
    lbt = pipe._lb_tables.get(fam)
    if lbt is None:
        return peer, dp
    ep_ids = np.asarray(pipe._endpoint_ids, np.int64)[ep]
    fh = flow_hash32(peer, sports, dp, pr, ep_ids)
    nb, npo, _rv, _ok, _nobk = lb_translate(
        lbt, *(torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (peer, dp, pr, fh)))
    return nb.numpy(), npo.numpy()


@pytest.mark.parametrize("fam", [4, 6])
@pytest.mark.parametrize("seed", [0, 3])
def test_new_established_reply_sequence_matches_jax(seed, fam):
    """Pass 1 (all new: LB, miss tail, CT creation), pass 2 (the same
    batch: allowed flows bypass, only the rest reach the device), the
    replies from each translated flow's backend with the ports flipped
    and return_rev_nat (REPLY hits carry the service's revNAT id),
    then a mixed batch and an ingress batch of the harness's flows."""
    st = Stack(seed)
    peer, ep, dp, pr, sp = egress_flows(st, fam, B, seed * 7 + fam)
    v1, r1 = st.run(fam, (peer, ep, dp, pr), ingress=False, sports=sp)
    assert len(st.t.conntrack) > 0
    assert (v1 == tpipe.DROP_NO_SERVICE).any() and (v1 == tpipe.FORWARD).any()

    tails = []
    real = st.t._dispatch
    st.t._dispatch = lambda s, fl, sel, *a, **k: tails.append(len(sel)) or real(s, fl, sel, *a, **k)
    v2, _r2 = st.run(fam, (peer, ep, dp, pr), ingress=False, sports=sp)
    st.t._dispatch = real
    created = (v1 == tpipe.FORWARD) & ~r1
    # pass 2 sends only the misses — the flows pass 1 did not admit
    assert tails == [int((~created).sum())]
    assert (v2[created] == tpipe.FORWARD).all()

    bb, bport = translate(st.t, fam, peer, ep, dp, pr, sp)
    vr, _rr, rev = st.run(fam, (bb, ep, sp.astype(np.int32), pr), ingress=True,
                          sports=bport.astype(np.int64), return_rev_nat=True)
    assert (vr[created] == tpipe.FORWARD).all()
    svc = (rev != 0)
    assert svc.any() and (svc <= created).all()
    for i in np.nonzero(svc)[0][:20]:
        fe = st.t.rev_nat_frontend(rev[i])
        assert str(fe) == str(st.j.rev_nat_frontend(rev[i]))
        assert fe is not None and fe.port == int(dp[i])

    peer3, ep3, dp3, pr3, sp3 = egress_flows(st, fam, B, seed * 7 + fam + 1)
    half = np.arange(B) < B // 2
    mixed = [np.where(half[:, None] if a.ndim == 2 else half, a, b)
             for a, b in zip((peer, ep, dp, pr, sp), (peer3, ep3, dp3, pr3, sp3))]
    st.run(fam, mixed[:4], ingress=False, sports=mixed[4])
    st.run(fam, (peer3, ep3, dp3, pr3), ingress=True, sports=sp3)
    st.run(fam, (peer3, ep3, dp3, pr3), ingress=True, sports=sp3, return_rev_nat=True)


@pytest.mark.parametrize("fam", [4, 6])
def test_denied_and_redirect_flows_create_no_state(fam):
    """Only FORWARD flows without an L7 redirect create entries: the
    live keys are exactly the admitted flows' (duplicates once)."""
    st = Stack(4, with_lb=False)
    w = st.w["cilium_tpu"]
    for k, ingress in enumerate((True, False)):
        if fam == 4:
            p, ep, dp, pr = random_flows(w, B, N_EPS, 3)
            peer = ipv4_to_bytes(p)
        else:
            peer, ep, dp, pr = v6_flows(st.peers6, B, 3)
        sp = np.random.default_rng(k).integers(1024, 1100, B)
        before = len(st.t.conntrack)
        v, r = st.run(fam, (peer, ep, dp, pr), ingress=ingress, sports=sp)
        assert (v == tpipe.DROP_POLICY).any()
        ok = (v == tpipe.FORWARD) & ~r
        keys = {(bytes(peer[i].astype(np.uint8)), ep[i], sp[i], dp[i], pr[i]) for i in np.nonzero(ok)[0]}
        assert len(st.t.conntrack) - before == len(keys)
        if ingress:
            assert r.any()  # the world's L7 rules redirect some ingress flows
            v2, r2 = st.run(fam, (peer, ep, dp, pr), ingress=ingress, sports=sp)
            assert (r2 == r).all()  # redirected flows stay on the policy path


@pytest.mark.parametrize("with_ct", [False, True])
@pytest.mark.parametrize("fam", [4, 6])
def test_no_backend_drops(fam, with_ct):
    """A frontend with no backend drops DROP_NO_SERVICE (counted as a
    drop, never in the CT), with and without conntrack; a reply asked
    for revNAT without conntrack gets zeros."""
    st = Stack(2, with_ct=with_ct)
    peer, ep, dp, pr, sp = egress_flows(st, fam, B, 90 + fam)
    kw = dict(sports=sp) if with_ct else {}
    v, _r = st.run(fam, (peer, ep, dp, pr), ingress=False, **kw)
    nosvc = v == tpipe.DROP_NO_SERVICE
    assert nosvc.any()
    v2, _r2, rev = st.run(fam, (peer, ep, dp, pr), ingress=False, return_rev_nat=True, **kw)
    assert (v2[nosvc] == tpipe.DROP_NO_SERVICE).all()
    if not with_ct:
        assert not rev.any()


def _delete_rule(pkg, pipe, w):
    n = w.repo.delete_by_labels(_mod(pkg, "labels").parse_label_array(["k8s:policy=fz1"]))[1]
    assert n == 1


def _remap_ipcache(pkg, pipe, w):
    for k in range(4):
        w.ipcache.upsert(f"{w.peer_ips[k]}/32", w.idents[k + 5].id, source="agent")
        w.ipcache.upsert(f"fd00::1:{k:x}/128", w.idents[k + 5].id, source="agent")


def _prefilter(pkg, pipe, w):
    pipe.prefilter.insert(pipe.prefilter.revision, ["172.16.0.0/29", "fd00::1:0/125"])


def _endpoints(pkg, pipe, w):
    pipe.set_endpoints([(900 + k, i.id) for k, i in enumerate(w.idents[N_EPS - 1::-1][:N_EPS])])


def _backend_churn(pkg, pipe, w):
    lb = _mod(pkg, "lb")
    for s in pipe.lb.list()[:6]:
        pipe.lb.upsert(s.frontend, [lb.Backend(w.peer_ips[3], 8080)] if s.frontend.family == 4
                       else [lb.Backend("fd00::1:3", 8080)])


@pytest.mark.parametrize("trigger", [_delete_rule, _remap_ipcache, _prefilter, _endpoints,
                                     _backend_churn], ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("fam", [4, 6])
def test_flush_triggers_match_jax(fam, trigger):
    """Established flows, then a basis move: both conntracks are empty
    after the next rebuild, and the re-verdicted batches stay equal; a
    batch with nothing moved keeps the entries."""
    st = Stack(0, deny=())
    peer, ep, dp, pr, sp = egress_flows(st, fam, B, 7 + fam)
    st.run(fam, (peer, ep, dp, pr), ingress=False, sports=sp)
    st.run(fam, (peer, ep, dp, pr), ingress=True, sports=sp)
    n = len(st.t.conntrack)
    assert n > 0
    st.t.rebuild()
    assert len(st.t.conntrack) == n  # nothing moved: no flush
    st.both(trigger)
    st.j.rebuild()
    st.t.rebuild()
    assert len(st.t.conntrack) == len(st.j.conntrack) == 0
    st.run(fam, (peer, ep, dp, pr), ingress=False, sports=sp)
    st.run(fam, (peer, ep, dp, pr), ingress=True, sports=sp)
    st.run(fam, (peer, ep, dp, pr), ingress=True, sports=sp)


@pytest.mark.parametrize("with_ct", [False, True])
@pytest.mark.parametrize("fam", [4, 6])
def test_tunnel_identities_match_jax(fam, with_ct):
    """1/8 of the lanes carry a tunnel identity, half of them unknown:
    a known one is trusted over the LPM and skips the prefilter, an
    unknown one (or 0) falls back to the LPM walk; with conntrack the
    overrides follow the miss tail."""
    st = Stack(5, with_ct=with_ct, deny=("172.16.0.0/28", "fd00::1:0/124"))
    w = st.w["cilium_tpu"]
    rs = np.random.default_rng(fam)
    if fam == 4:
        p, ep, dp, pr = random_flows(w, B, N_EPS, 60)
        peer = ipv4_to_bytes(p)
    else:
        peer, ep, dp, pr = v6_flows(st.peers6, B, 60)
    tun = np.zeros(B, np.int64)
    lanes = rs.random(B) < 1 / 8
    known = rs.random(B) < 0.5
    ids = np.array([i.id for i in w.idents], np.int64)
    tun[lanes & known] = ids[rs.integers(0, len(ids), int((lanes & known).sum()))]
    tun[lanes & ~known] = 999_000 + rs.integers(0, 100, int((lanes & ~known).sum()))
    kw = dict(sports=rs.integers(1024, 1100, B)) if with_ct else {}
    for ingress in (True, False, True):
        v, _r = st.run(fam, (peer, ep, dp, pr), ingress=ingress, tunnel_identities=tun, **kw)
        plain, _r = st.run(fam, (peer, ep, dp, pr), ingress=ingress)
        if ingress and not with_ct:
            # decapped flows with a trusted identity are never prefiltered
            assert (plain[lanes & known] == tpipe.DROP_PREFILTER).any()
            assert not (v[lanes & known] == tpipe.DROP_PREFILTER).any()
            assert (v[lanes & ~known] == plain[lanes & ~known]).all()


def _series(m):
    return {(mt.name, k): v for mt in (m.rule_hits_total, m.drop_reasons_total)
            for k, v in mt.series().items()}


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


@pytest.mark.parametrize("fam", [4, 6])
def test_attribution_with_ct_matches_jax(fam):
    """Attribution on with CT: bypassed flows take no decision (rule
    -1), so only the miss tail's rules are counted; no-backend flows
    count as "no-service" drops. The rule hits and drop reasons move by
    the JAX pipeline's amounts. The JAX pipeline pads the miss tail to
    its ladder rungs and counts the pad lanes in
    dispatch_pad_lanes_total; the port dispatches the tail at its
    exact shape and pads nothing — the one divergence, by design."""
    st = Stack(4, deny=("172.16.0.0/28", "fd00::1:0/124"))
    for pipe in st.pipes.values():
        pipe.set_attribution(True)
    jb, tb = _series(jmetrics), _series(tmetrics)
    jpad = dict(jmetrics.dispatch_pad_lanes_total.series())
    tpad = dict(tmetrics.dispatch_pad_lanes_total.series())
    peer, ep, dp, pr, sp = egress_flows(st, fam, B, 11 * fam)
    for ingress in (False, False, True):
        st.run(fam, (peer, ep, dp, pr), ingress=ingress, sports=sp)
    # no sports: no CT pre-pass; egress no-backend flows override the
    # device's counters and attribution on the host
    st.run(fam, (peer, ep, dp, pr), ingress=True)
    st.run(fam, (peer, ep, dp, pr), ingress=False)
    jd, td = _delta(jb, _series(jmetrics)), _delta(tb, _series(tmetrics))
    assert td == jd
    reasons = {dict(k[1])["reason"] for k in td if k[0].endswith("drop_reasons_total")}
    assert {"no-service", "prefilter"} <= reasons
    assert dict(jmetrics.dispatch_pad_lanes_total.series()) != jpad
    assert dict(tmetrics.dispatch_pad_lanes_total.series()) == tpad


def test_device_ct_is_refused():
    """The port no longer refuses ``device_ct_bits``: beside a given
    conntrack it keeps that table as the fallback domain, as the
    reference does, and a batch with sports and no LB table runs on the
    device CT in both packages (same verdicts, redirects and counters),
    leaving both host tables empty; the batch again is established."""
    st = Stack(0, with_lb=False)
    pipes = {}
    for pkg, pipe in st.pipes.items():
        dev = {} if pkg == "cilium_tpu" else {"device": "cpu"}
        p = _mod(pkg, "datapath.pipeline").DatapathPipeline(
            pipe.engine, pipe.ipcache, conntrack=pipe.conntrack, device_ct_bits=10, **dev)
        assert p.conntrack is pipe.conntrack
        p.set_endpoints([i.id for i in st.w[pkg].idents[:N_EPS]])
        pipes[pkg] = p
    p, ep, dp, pr = random_flows(st.w["cilium_tpu"], 300, N_EPS, 5)
    sp = np.arange(300) + 3000
    for _ in range(2):
        out = [pipes[k].process(p, ep, dp, pr, ingress=True, sports=sp) for k in PKGS]
        for g, w_ in zip(out[1], out[0]):
            np.testing.assert_array_equal(g, w_)
        np.testing.assert_array_equal(pipes[PKGS[1]].counters, pipes[PKGS[0]].counters)
        for pkg in PKGS:
            assert len(pipes[pkg].conntrack) == 0
    assert (out[1][0] == tpipe.FORWARD).any()


def test_on_redirect_hook_and_endpoint_ids():
    """The proxymap hook sees every redirected flow's 5-tuple in both
    packages; endpoint_index / endpoint_id_at follow set_endpoints."""
    st = Stack(4, with_lb=False)
    seen = {}
    for pkg, pipe in st.pipes.items():
        seen[pkg] = []
        pipe.on_redirect = lambda *a, out=seen[pkg]: out.append(a)
    w = st.w["cilium_tpu"]
    p, ep, dp, pr = random_flows(w, B, N_EPS, 3)
    sp = np.arange(B) + 2000
    _v, r = st.run(4, (ipv4_to_bytes(p), ep, dp, pr), ingress=True, sports=sp)
    assert r.any() and seen["cilium_tpu"] == seen["cilium_tpu_torch"]
    assert len(seen["cilium_tpu_torch"]) == int(r.sum())
    for pipe in st.pipes.values():
        assert pipe.endpoint_index(507) == 1 and pipe.endpoint_id_at(1) == 507
        assert pipe.endpoint_index(1) is None and pipe.endpoint_id_at(N_EPS) is None
