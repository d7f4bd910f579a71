"""Port parity: the flow events and the flow ring on every pipeline path.

Both packages' pipelines, over the same seeded world (the ``Pair`` of
tests/test_torch_submit.py), each with a monitor hub of its own package
and one subscriber, see the same batches with the same settings
(``trace_enabled``, ``verdict_notifications``, an ``endpoint_options``
resolver, each on and off). Per batch the drained event lists must be
equal element by element and in order (every field but the wall-clock
timestamp); after the sequence, ``flow_ring.query(limit=None)`` must be
equal with ``observe.flows.now`` pinned in both. The paths: v4, v6,
attribution, host CT, LB, device CT, a flows-axis plan over eight
virtual devices and the admission gate.

The one exclusion is named: the reference's device-CT slot C-1 fault
(ROADMAP queue C; tests/test_torch_pipeline_device_ct.py), where the
events follow each package's own verdict. The flows of the other two
named faults (an out-of-range policymap or shed row) need an endpoint
index outside the table, which these batches never carry.

The reference's flow-ring bars (tests/test_flow_attribution.py
``TestOnOffBitIdentical``, ``TestCountInvariants::
test_ring_records_agree_with_verdicts``) run against the port, and the
off path is held: with no listener and attribution off a v4 batch
builds no peer bytes, and a listener changes neither the phases nor the
transfers.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import pytest
import torch

from cilium_tpu import faults as jfaults
from cilium_tpu.observe import flows as jflows
from cilium_tpu_torch import faults as tfaults
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.datapath import pipeline as tpipe
from cilium_tpu_torch.datapath import placement as tplace
from cilium_tpu_torch.datapath.conntrack import FlowConntrack
from cilium_tpu_torch.observe import SAMPLE_CAP
from cilium_tpu_torch.observe import flows as tflows
from test_torch_harness import PKGS
from test_torch_pipeline_ct import _pack, egress_flows
from test_torch_pipeline_device_ct import C, lane_keys, small_flows, small_world
from test_torch_submit import B, Pair

TORCH = PKGS[1]
FORWARD, DROP_POLICY, DROP_PREFILTER = tpipe.FORWARD, tpipe.DROP_POLICY, tpipe.DROP_PREFILTER
PATHS = ["v4", "v6", "attribution", "host_ct", "lb", "device_ct", "sharded", "gate"]
# (trace_enabled, verdict_notifications, endpoint_options): each on and off
SETTINGS = [(False, False, False), (True, False, False), (False, True, False),
            (False, False, True), (True, True, True)]
PAIR_KW = {
    "v4": {}, "v6": {"deny": ("fd00::1:0/126",)}, "attribution": {}, "host_ct": {"ct": True},
    "lb": {"ct": True, "lb": True}, "device_ct": {"device_ct_bits": 10},
    "sharded": {"sharding": True}, "gate": {"admission": True, "prefilter_shed": True},
}
ATTRIBUTED = {"attribution", "host_ct", "device_ct", "sharded"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The flow ring's clock and the device CT's, pinned in both
    packages; fault hubs clean; eight virtual CPU devices for the port
    (JAX's test mesh has eight)."""
    monkeypatch.setattr(jflows, "now", lambda: 1_700_000_000.5)
    monkeypatch.setattr(tflows, "now", lambda: 1_700_000_000.5)
    monkeypatch.setattr(time, "monotonic", lambda: 50_000.25)
    monkeypatch.setattr(tplace, "visible_devices", lambda: [
        tplace.DeviceRecord(i, 0, torch.device("cpu")) for i in range(8)])
    for hub in (jfaults.hub, tfaults.hub):
        hub.reset()
    yield
    for hub in (jfaults.hub, tfaults.hub):
        hub.reset()


def resolver(ep: int, name: str, default: bool) -> bool:
    """Per-endpoint options: mixed answers, and a transient fault (the
    default then holds) for every fifth endpoint id."""
    if ep % 5 == 0:
        raise OSError("option store unreachable")
    return (ep * 7 + len(name)) % 3 != 0


def ev_key(ev):
    """An event as (class name, fields without the wall-clock stamp)."""
    d = dataclasses.asdict(ev)
    d.pop("timestamp")
    return type(ev).__name__, tuple(sorted(d.items()))


class Events:
    """A Pair whose pipelines each publish to a hub of their own package
    with one subscriber, set alike."""

    def __init__(self, path: str, settings=(False, False, False), seed: int = 3):
        self.path = path
        self.pr = Pair(seed, depth=2, **PAIR_KW[path])
        self.subs = {}
        trace, verdicts, opts = settings
        for pkg, pipe in self.pr.pipes.items():
            hub = _mod(pkg, "monitor").MonitorHub()
            pipe.monitor = hub
            self.subs[pkg] = hub.subscribe(capacity=1 << 16)
            pipe.trace_enabled = trace
            pipe.verdict_notifications = verdicts
            pipe.endpoint_options = resolver if opts else None
            labels = self.pr.w[pkg].ident_labels
            pipe.identity_labels = lambda ident, labels=labels: tuple(labels.get(ident, ()))
            if path in ATTRIBUTED:
                pipe.set_attribution(True)
        self.named = 0

    def c1_lanes(self, fam, flows, sports, ingress):
        """[B] lanes the reference's live slot C-1 key can answer (the
        named device-CT fault), from JAX's table before the batch."""
        n = len(flows[1])
        st = self.pr.j._device_ct
        if st is None or sports is None or int(np.asarray(st.exp)[C - 1]) <= int(time.monotonic()):
            return np.zeros(n, bool)
        c1 = np.array([np.asarray(w)[C - 1] for w in st[:6]], np.uint32)
        named = np.zeros(n, bool)
        for words, start in lane_keys(fam, flows[0], flows[1], sports, flows[2], flows[3],
                                      ingress):
            covers = ((C - 1 - start.astype(np.int64)) % C) < 8
            named |= covers & (words == c1).all(1)
        return named

    def batch(self, fam, flows, **kw):
        """One batch through both; results equal outside the named lanes,
        then the drained events equal, those of named lanes left out."""
        named = self.c1_lanes(fam, flows, kw.get("sports"), kw.get("ingress", True))
        jh, th = self.pr.submit(fam, flows, **kw)
        want, got = jh.result(), th.result()
        diff = np.zeros(len(flows[1]), bool)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            diff |= g != w
        assert named[diff].all(), f"lanes {np.nonzero(diff & ~named)[0]} differ outside slot C-1"
        self.named += int(diff.sum())
        ev_j, ev_t = (self.subs[p].drain() for p in PKGS)
        if diff.any():
            peers = flows[0] if fam == 6 else tpipe.ipv4_to_bytes(flows[0])
            skip = {(bytes(int(x) & 0xFF for x in peers[i]), int(flows[2][i]), int(flows[3][i]))
                    for i in np.nonzero(diff)[0]}

            def keep(evs):
                return [e for e in evs if (getattr(e, "peer_addr", None), getattr(e, "dport", None),
                                           getattr(e, "proto", None)) not in skip]

            ev_j, ev_t = keep(ev_j), keep(ev_t)
        assert [ev_key(e) for e in ev_t] == [ev_key(e) for e in ev_j]
        return got, ev_t

    def run(self):
        """The path's batch sequence → every port event, in order."""
        pr, path = self.pr, self.path
        out = []
        if path == "lb":
            stack = type("S", (), {"w": pr.w, "peers6": pr.peers6, "lb": pr.lb})()
            for fam, seed in ((4, 11), (6, 12), (4, 11)):
                peer, ep, dp, proto, sp = egress_flows(stack, fam, B, seed)
                flows = (_pack(peer) if fam == 4 else peer, ep, dp, proto)
                out += self.batch(fam, flows, ingress=False, sports=sp, return_rev_nat=True)[1]
            return out
        n = 256 if path == "device_ct" else B
        steps = [(4, 40, True), (6, 20, True), (4, 40, True), (4, 41, False), (6, 21, False)]
        for i, (fam, seed, ingress) in enumerate(steps):
            kw = {"ingress": ingress}
            if path in ("host_ct", "device_ct"):
                # the third batch repeats the first: CT hits
                kw["sports"] = np.random.default_rng(seed).integers(1024, 4096, n).astype(np.int32)
            if path == "gate" and i in (0, 1):
                for f in (jfaults, tfaults):
                    f.hub.fail(f.SITE_QUEUE_FULL, f.KIND_TRANSIENT, times=1)
            out += self.batch(fam, pr.flows(fam, n, seed), **kw)[1]
        return out


@pytest.mark.parametrize("settings", SETTINGS, ids=lambda s: "-".join(
    n for n, on in zip(("trace", "verdicts", "options"), s) if on) or "drops")
@pytest.mark.parametrize("path", PATHS)
def test_events_and_ring_match_jax(path, settings):
    ev = Events(path, settings)
    events = ev.run()
    kinds = {type(e).__name__ for e in events}
    assert "DropNotify" in kinds
    trace, verdicts, opts = settings
    if opts:
        # the resolver's answers decide, endpoint by endpoint
        assert kinds & {"TraceNotify", "PolicyVerdictNotify"}
    else:
        assert ("TraceNotify" in kinds) == trace
        assert ("PolicyVerdictNotify" in kinds) == verdicts
    if path == "gate":
        assert any(e.producer == "admission" for e in events if type(e).__name__ == "DropNotify")
    want, got = (p.flow_ring.query(limit=None) for p in (ev.pr.j, ev.pr.t))
    assert got == want
    if path in ATTRIBUTED and path != "device_ct":
        assert got and all(r["ts"] == 1_700_000_000.5 for r in got)
        assert any(r["src_labels"] or r["dst_labels"] for r in got)
    else:
        assert got == []  # no attribution, or the unattributed device-CT path


@pytest.mark.parametrize("ct", [False, True])
def test_redirect_events_match_jax(ct):
    """The L7 redirect: web admits lb:80 through an HTTP rule. A
    redirected flow's TraceNotify is to-proxy, its PolicyVerdictNotify
    action 2 with reason 154, its record reason 154, equal to JAX's, on
    the no-CT and the host-CT path."""
    pipes, evs = {}, {}
    for pkg in PKGS:
        pipe, _repo = small_world(pkg, device_ct=False, redirect=True)
        hub = _mod(pkg, "monitor").MonitorHub()
        pipe.monitor = hub
        evs[pkg] = hub.subscribe(capacity=1 << 16)
        pipe.trace_enabled = pipe.verdict_notifications = True
        pipe.set_attribution(True)
        pipes[pkg] = pipe
    # 60 flows: the sample (64) holds every flow, redirected ones included
    ips, eps, dports, protos, sports = small_flows(60, 7)
    for pkg, pipe in pipes.items():
        out = pipe.process(ips, eps, dports, protos, sports=sports if ct else None)
        assert out[1].any()  # some flows redirected
        pipes[pkg] = (pipe, out)
    (pj, oj), (pt, ot) = pipes[PKGS[0]], pipes[PKGS[1]]
    for g, w in zip(ot, oj):
        np.testing.assert_array_equal(g, w)
    ev_j, ev_t = (evs[p].drain() for p in PKGS)
    assert [ev_key(e) for e in ev_t] == [ev_key(e) for e in ev_j]
    assert any(type(e).__name__ == "TraceNotify" and e.obs_point == 3 for e in ev_t)
    assert any(type(e).__name__ == "PolicyVerdictNotify" and (e.action, e.reason) == (2, 154)
               for e in ev_t)
    want, got = (p.flow_ring.query(limit=None) for p in (pj, pt))
    assert got == want and any(r["reason"] == 154 for r in got)


def test_ring_origins_follow_the_repository():
    """A rule deleted between two attributed batches shifts every later
    rule's index: both packages' records name the origins of the
    repository their batch ran against. (48 flows a batch: the sample
    holds the forwarded flows too, which carry a rule.)"""
    ev = Events("attribution")
    flows = ev.pr.flows(4, 48, 40)
    ev.batch(4, flows)
    first = ev.pr.t.flow_ring.query(limit=None)
    for pkg in PKGS:
        ev.pr.w[pkg].repo.delete_by_labels(
            _mod(pkg, "labels").parse_label_array(["k8s:policy=fz0"]))
    ev.batch(4, flows)
    want, got = (p.flow_ring.query(limit=None) for p in (ev.pr.j, ev.pr.t))
    assert got == want and len(got) == 2 * 48
    assert got[:48] == first
    origins = ev.pr.w[TORCH].repo.rule_origins()
    named = [r for r in got[48:] if r["rule_index"] >= 0]
    assert named and all(r["rule_origin"] == origins[r["rule_index"]] for r in named)
    assert all("k8s:policy=fz0" not in r["rule_origin"]["labels"] for r in named)


# -- the reference's flow-ring bars (tests/test_flow_attribution.py) --------
def datapath_world(seed: int):
    """The graft world of the reference's test (``__graft_entry__.
    _build_datapath_world``) through the port: 64 rules over 16 apps,
    32 identities, a /32 each, a broad /16, a prefiltered /24, four
    endpoints."""
    import random

    api = _mod(TORCH, "policy.api")
    parse = _mod(TORCH, "labels").parse_label_array
    rng = random.Random(seed)
    repo = _mod(TORCH, "policy.repository").Repository()
    rules = []
    for i in range(64):
        subject = [f"k8s:app=a{rng.randrange(16)}"]
        peer = api.EndpointSelector.make([f"k8s:app=a{rng.randrange(16)}"])
        if i % 3 == 0:
            ing = api.IngressRule(from_endpoints=(peer,), to_ports=(
                api.PortRule(ports=(api.PortProtocol(80, "TCP"),)),))
        else:
            ing = api.IngressRule(from_endpoints=(peer,))
        rules.append(api.rule(subject, ingress=[ing]))
    repo.add_list(rules)
    reg = _mod(TORCH, "identity").IdentityRegistry()
    idents = [reg.allocate(parse([f"k8s:app=a{rng.randrange(16)}", f"k8s:z=z{i % 4}"]))
              for i in range(32)]
    engine = _mod(TORCH, "engine").PolicyEngine(repo, reg, device="cpu")
    engine.refresh()
    cache = _mod(TORCH, "ipcache.ipcache").IPCache()
    for i, ident in enumerate(idents):
        cache.upsert(f"10.0.{i >> 8}.{i & 255}/32", ident.id, source="k8s")
    cache.upsert("10.7.0.0/16", idents[0].id, source="k8s")
    pf = _mod(TORCH, "ipcache.prefilter").PreFilter()
    pf.insert(pf.revision, ["192.0.2.0/24"])
    pipe = tpipe.DatapathPipeline(engine, cache, pf, device="cpu")
    pipe.set_endpoints([i.id for i in idents[:4]])
    pipe.rebuild()
    return pipe, engine, idents


def ip_flows(idents, b: int, seed: int):
    """``__graft_entry__._make_ip_flows``: endpoint addresses, the broad
    prefix, a prefiltered source and a world address."""
    rng = np.random.default_rng(seed)
    known = [(10 << 24) | ((i >> 8) << 8) | (i & 255) for i in range(len(idents))]
    pool = np.asarray(known + [(10 << 24) | (7 << 16) | 99, (192 << 24) | (2 << 8) | 5,
                               (8 << 24) | (8 << 16) | (8 << 8) | 8], np.uint32)
    peer = pool[rng.integers(0, len(pool), b)].astype(np.uint32)
    return (peer, rng.integers(0, 4, b).astype(np.int32),
            rng.choice(np.array([0, 80, 443], np.int32), b), np.full(b, 6, np.int32))


def batches(idents, k: int, b: int, seed0: int):
    return [ip_flows(idents, b, seed0 + i) for i in range(k)]


class TestOnOffBitIdentical:
    def test_plain_pipeline(self):
        """Attribution ON tracks OFF verdict-, redirect- and
        counter-exactly (no CT, depth 1)."""
        pipe_off, _, idents = datapath_world(3)
        pipe_on, _, _ = datapath_world(3)
        pipe_on.set_attribution(True)
        for p, e, d, pr in batches(idents, 3, 384, 40):
            v0, r0 = pipe_off.process(p, e, d, pr)
            v1, r1 = pipe_on.process(p, e, d, pr)
            np.testing.assert_array_equal(v0, v1)
            np.testing.assert_array_equal(r0, r1)
        np.testing.assert_array_equal(pipe_off.counters, pipe_on.counters)
        assert pipe_on.flow_ring.recorded > 0 and pipe_off.flow_ring.recorded == 0

    def test_sharded_and_pipelined(self):
        """A flows-axis plan over the eight virtual devices and depth-2
        submit with a conntrack attached: the widest variant matches the
        plain synchronous one flow for flow, and the ring records."""
        _, engine, idents = datapath_world(5)
        base, _, _ = datapath_world(5)
        wide = tpipe.DatapathPipeline(engine, base.ipcache, base.prefilter,
                                      conntrack=FlowConntrack(capacity_bits=12),
                                      pipeline_depth=2, device="cpu")
        wide.set_endpoints([i.id for i in idents[:4]])
        wide.set_sharding(True)
        wide.set_attribution(True)
        wide.rebuild()
        assert wide.placement_state()["flows_size"] == 8
        plain = tpipe.DatapathPipeline(engine, base.ipcache, base.prefilter,
                                       conntrack=FlowConntrack(capacity_bits=12),
                                       pipeline_depth=1, device="cpu")
        plain.set_endpoints([i.id for i in idents[:4]])
        plain.rebuild()
        rng = np.random.default_rng(7)
        bs = batches(idents, 4, 512, 60)
        bs.append(bs[0])  # the first again: the CT-hit path runs attributed
        sports = [rng.integers(1024, 4096, 512).astype(np.int32) for _ in bs]
        sports[-1] = sports[0]
        pend = [wide.submit(p, e, d, pr, sports=s) for (p, e, d, pr), s in zip(bs, sports)]
        got = [pb.result() for pb in pend]
        for (p, e, d, pr), s, (v1, r1) in zip(bs, sports, got):
            v0, r0 = plain.process(p, e, d, pr, sports=s)
            np.testing.assert_array_equal(v0, v1)
            np.testing.assert_array_equal(r0, r1)
        assert wide.flow_ring.recorded > 0

    def test_toggle_off_restores_parity(self):
        pipe, _, idents = datapath_world(3)
        ref, _, _ = datapath_world(3)
        pipe.set_attribution(True)
        assert pipe.flow_ring.active
        pipe.set_attribution(False)
        for p, e, d, pr in batches(idents, 2, 256, 80):
            v0, r0 = ref.process(p, e, d, pr)
            v1, r1 = pipe.process(p, e, d, pr)
            np.testing.assert_array_equal(v0, v1)
            np.testing.assert_array_equal(r0, r1)
        assert not pipe.flow_ring.active and pipe.flow_ring.recorded == 0


class TestCountInvariants:
    def test_ring_records_agree_with_verdicts(self):
        pipe, _, idents = datapath_world(3)
        pipe.set_attribution(True)
        v, _r = pipe.process(*ip_flows(idents, 512, 40))
        recs = pipe.flow_ring.query(limit=None)
        assert recs
        for f in recs:
            # each sampled record restates its batch verdict
            assert f["verdict_name"].startswith(
                "forwarded" if f["verdict"] == FORWARD else "dropped")
            if f["verdict"] == FORWARD:
                assert f["rule_index"] >= 0
                assert f["rule_origin"] is not None
            elif f["verdict"] == DROP_POLICY:
                assert f["reason"] in (151, 152, 153)
        n_drops_rec = sum(1 for f in recs if f["verdict_name"].startswith("dropped"))
        # drops are sampled first: all of them land until the cap
        assert n_drops_rec == min(int((v != FORWARD).sum()), SAMPLE_CAP)
        assert len(recs) == SAMPLE_CAP

    def test_ring_query_filters(self):
        """``query`` filters before its limit: the drops of a batch, one
        identity's flows, one reason."""
        pipe, _, idents = datapath_world(3)
        pipe.set_attribution(True)
        pipe.process(*ip_flows(idents, 512, 41))
        recs = pipe.flow_ring.query(limit=None)
        drops = pipe.flow_ring.query(limit=None, verdict=-1)
        assert drops == [r for r in recs if r["verdict"] != FORWARD]
        assert pipe.flow_ring.query(limit=3, verdict=-1) == drops[-3:]
        ident = recs[0]["src_identity"]
        assert pipe.flow_ring.query(limit=None, from_identity=ident) == [
            r for r in recs if r["src_identity"] == ident]
        assert pipe.flow_ring.query(limit=None, reason=144) == [
            r for r in recs if r["reason"] == 144]


# -- the off path ------------------------------------------------------------
def _capture_batches(monkeypatch, pipe):
    """Every _Batch the enqueue half of ``pipe`` receives."""
    seen = []
    inner = pipe._submit_inner

    def spy(fl, *a, **kw):
        seen.append(fl)
        return inner(fl, *a, **kw)

    monkeypatch.setattr(pipe, "_submit_inner", spy)
    return seen


@pytest.mark.parametrize("path", ["v4", "host_ct", "device_ct", "gate"])
@pytest.mark.parametrize("listener", ["none", "unwatched"])
def test_off_path_builds_no_peer_bytes(path, listener, monkeypatch):
    """No monitor (or a hub nobody watches) and attribution off: a v4
    batch's address bytes are never built, on any path; a subscriber
    makes the events build them."""
    pr = Pair(3, depth=2, **PAIR_KW[path])
    pipe = pr.t
    hub = _mod(TORCH, "monitor").MonitorHub() if listener == "unwatched" else None
    pipe.monitor = hub
    pipe.rebuild()  # publishes the shed table the gate walks
    seen = _capture_batches(monkeypatch, pipe)
    made = []
    real = tpipe.ipv4_to_bytes
    monkeypatch.setattr(tpipe, "ipv4_to_bytes", lambda a: made.append(len(a)) or real(a))
    kw = {"sports": np.arange(B, dtype=np.int32) + 2000} if path in ("host_ct", "device_ct") else {}
    if path == "gate":
        tfaults.hub.fail(tfaults.SITE_QUEUE_FULL, tfaults.KIND_TRANSIENT, times=1)
    v, _ = pipe.process(*pr.flows(4, B, 40), **kw)
    if path == "gate":
        assert (v == DROP_PREFILTER).any()
    assert seen and all(fl.peer_bytes is None for fl in seen)
    assert made == []
    if hub is not None:
        sub = hub.subscribe()
        pipe.process(*pr.flows(4, B, 41), **kw)
        assert sub.drain() and made


def _phases_and_transfers(listener: bool):
    """A v4, a v6 and a host-CT batch with the tracer on → (the phase
    names of each trace, the transfer counters' deltas)."""
    pr = Pair(3, depth=1, ct=True)
    pipe = pr.t
    if listener:
        pipe.monitor = _mod(TORCH, "monitor").MonitorHub()
        sub = pipe.monitor.subscribe(capacity=1 << 16)
        pipe.trace_enabled = pipe.verdict_notifications = True
    pipe.tracer.enable()

    def snap():
        return {(m, d): getattr(tmetrics, m).get({"direction": d})
                for m in ("device_transfers_total", "device_transfer_bytes_total")
                for d in ("h2d", "d2h")}

    before = snap()
    pipe.process(*pr.flows(4, B, 40))
    pipe.process_v6(*pr.flows(6, B, 20))
    pipe.process(*pr.flows(4, B, 41), sports=np.arange(B, dtype=np.int32) + 3000)
    after = snap()
    if listener:
        assert len(sub.drain()) >= 3 * B
    names = [[p[0] for p in t["phases"]] for t in pipe.tracer.traces()]
    return names, {k: after[k] - before[k] for k in after}


def test_listener_changes_no_phase_and_no_transfer():
    """The same batches with a subscriber (every event kind on) and
    without: the same phase sequence, with ``emit_events`` where it was,
    and the same h2d / d2h transfer counts and bytes."""
    names_off, moved_off = _phases_and_transfers(False)
    names_on, moved_on = _phases_and_transfers(True)
    assert names_on == names_off and len(names_on) == 3
    assert all("emit_events" in n for n in names_on)
    assert moved_on == moved_off and moved_on[("device_transfers_total", "d2h")] > 0
