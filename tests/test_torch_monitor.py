"""Port parity: the monitor (``cilium_tpu_torch/monitor/``) and the
pipeline's events.

The reference's bars (tests/test_monitor.py ``TestCodec``, ``TestHub``,
``TestDissect``, ``TestMonitorSocket``, ``TestPipelineEmission`` and
``TestStandaloneMonitorProcess::test_events_flow_through_real_process``;
tests/test_observe.py ``TestEnabledTracing::
test_trace_summary_published_and_roundtrips``) run against the port's
modules and its pipeline on the CPU. The wire check holds the two
packages' codecs to the same bytes for every event class, both ways.
"""

from __future__ import annotations

import dataclasses
import importlib
import ipaddress
import os
import pathlib
import select
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from cilium_tpu.monitor import events as jevents
from cilium_tpu_torch import contracts as tcontracts
from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
from cilium_tpu_torch.engine import PolicyEngine
from cilium_tpu_torch.identity import IdentityRegistry
from cilium_tpu_torch.ipcache.ipcache import IPCache
from cilium_tpu_torch.ipcache.prefilter import PreFilter
from cilium_tpu_torch.labels import parse_label_array
from cilium_tpu_torch.monitor import (
    EVENT_DROP,
    REASON_POLICY,
    REASON_PREFILTER,
    AgentNotify,
    DebugCapture,
    DropNotify,
    L7Notify,
    MonitorHub,
    MonitorServer,
    PolicyVerdictNotify,
    TraceNotify,
    TraceSummary,
    decode,
    dissect,
    encode,
    monitor_stream,
)
from cilium_tpu_torch.monitor import events as tevents
from cilium_tpu_torch.ops.lpm import ip_strings_to_u32
from cilium_tpu_torch.policy.api import (
    EndpointSelector,
    IngressRule,
    PortProtocol,
    PortRule,
    rule,
)
from cilium_tpu_torch.policy.repository import Repository

REPO = pathlib.Path(__file__).resolve().parent.parent


class TestCodec:
    def test_drop_roundtrip(self):
        ev = DropNotify(
            reason=REASON_POLICY, endpoint=7, src_identity=1002, family=4,
            peer_addr=bytes([10, 0, 0, 9]), dport=443, proto=6, ingress=True,
        )
        out = decode(encode(ev))
        assert out == ev
        assert "Policy denied" in out.summary() and "10.0.0.9" in out.summary()

    def test_trace_roundtrip_v6(self):
        ev = TraceNotify(
            obs_point=1, endpoint=3, src_identity=5, family=6,
            peer_addr=bytes(range(16)), dport=80, proto=6, ingress=False,
        )
        assert decode(encode(ev)) == ev

    def test_agent_and_l7_roundtrip(self):
        a = AgentNotify(kind="policy-updated", message="rev 7")
        assert decode(encode(a)) == a
        l7 = L7Notify(verdict="Denied", detail='{"path": "/admin"}')
        assert decode(encode(l7)) == l7

    def test_policy_verdict_roundtrip(self):
        ev = PolicyVerdictNotify(
            action=0, reason=REASON_POLICY, endpoint=7, src_identity=1002,
            family=4, peer_addr=bytes([10, 0, 0, 9]), dport=443, proto=6,
            ingress=True, rule_index=3,
        )
        out = decode(encode(ev))
        assert out == ev
        assert "denied" in out.summary() and "rule 3" in out.summary()
        # allowed flows report too, and rule_index=-1 (attribution off)
        # survives the signed field
        allowed = PolicyVerdictNotify(
            action=1, reason=0, endpoint=3, src_identity=5, family=6,
            peer_addr=bytes(range(16)), dport=80, proto=6, ingress=False,
        )
        back = decode(encode(allowed))
        assert back == allowed and back.rule_index == -1
        assert "allowed" in back.summary() and "rule" not in back.summary()

    def test_reason_codes_are_the_contract(self):
        """Every int ``REASON_*`` of the port's events module is the
        wire code ``contracts.WIRE_REASONS`` fixes, and each of those is
        defined there."""
        got = {k: v for k, v in vars(tevents).items()
               if k.startswith("REASON_") and isinstance(v, int)}
        assert got == tcontracts.WIRE_REASONS


# -- the wire: both packages' codecs, byte for byte -------------------------
def _samples(ev_mod):
    """One event of every class (drops with each producer, both
    families, both directions), with fixed timestamps."""
    ts = 1_700_000_000.25
    flow = dict(endpoint=7, src_identity=1002, dport=443, proto=6, timestamp=ts)
    v4, v6 = bytes([10, 0, 0, 9]), bytes(range(16))
    out = []
    for producer in ("", "admission", "prefilter"):
        out.append(ev_mod.DropNotify(reason=ev_mod.REASON_PREFILTER, family=4, peer_addr=v4,
                                     ingress=True, producer=producer, **flow))
    for reason in (133, 135, 146, 151, 152, 153, 155):
        out.append(ev_mod.DropNotify(reason=reason, family=6, peer_addr=v6, ingress=False,
                                     **flow))
    for obs in (1, 2, 3):
        out.append(ev_mod.TraceNotify(obs_point=obs, family=4, peer_addr=v4, ingress=obs != 2,
                                      **flow))
    for action, reason, ri in ((0, 151, 4), (1, 0, -1), (2, 154, 32767), (0, 152, -32768)):
        out.append(ev_mod.PolicyVerdictNotify(action=action, reason=reason, family=6,
                                              peer_addr=v6, ingress=True, rule_index=ri, **flow))
    out.append(ev_mod.AgentNotify(kind="policy-updated", message="rev 7 ✓", timestamp=ts))
    out.append(ev_mod.L7Notify(verdict="Denied", detail='{"path": "/admin"}', timestamp=ts))
    out.append(ev_mod.DebugCapture(endpoint=9, data=bytes(range(60)), orig_len=1500,
                                   timestamp=ts))
    out.append(ev_mod.TraceSummary(
        kind="v4-ingress", batch=1024, total_ns=123_456_789,
        phases=(("rebuild", 0, 1000), ("dispatch", 1000, 50_000), ("emit_events", 60_000, 7)),
        timestamp=ts))
    return out


def _fields(ev):
    return type(ev).__name__, dataclasses.astuple(ev)


def test_wire_bytes_equal_both_ways():
    """An event encoded by the port's codec decodes with the JAX
    package's ``decode`` to an equal event, and the other way round;
    the two encodings are the same bytes, for every event class."""
    mine, theirs = _samples(tevents), _samples(jevents)
    assert {type(e).__name__ for e in mine} == {
        "DropNotify", "TraceNotify", "PolicyVerdictNotify", "AgentNotify", "L7Notify",
        "DebugCapture", "TraceSummary"}
    for t, j in zip(mine, theirs):
        assert _fields(t) == _fields(j)
        wire = tevents.encode(t)
        assert wire == jevents.encode(j), type(t).__name__
        assert _fields(jevents.decode(wire)) == _fields(t)
        assert _fields(tevents.decode(jevents.encode(j))) == _fields(j)
        assert tevents.decode(wire) == t


class TestHub:
    def test_fanout_and_loss(self):
        hub = MonitorHub()
        assert not hub.active
        s1 = hub.subscribe(capacity=4)
        s2 = hub.subscribe(capacity=100)
        assert hub.active
        for i in range(10):
            hub.publish(AgentNotify(kind="k", message=str(i)))
        assert s1.lost == 6 and len(s1.drain()) == 4
        assert s2.lost == 0 and len(s2.drain()) == 10
        s1.close()
        s2.close()
        assert not hub.active

    def test_next_blocking(self):
        hub = MonitorHub()
        sub = hub.subscribe()
        out = []
        t = threading.Thread(target=lambda: out.append(sub.next(timeout=5)))
        t.start()
        hub.publish(AgentNotify(kind="x", message="y"))
        t.join(timeout=5)
        assert out and out[0].kind == "x"


def _pipeline(with_monitor=True):
    """The reference test's world on the port: web behind 80/TCP from
    lb, a third identity, and a prefiltered /24."""
    repo = Repository()
    repo.add_list([
        rule(
            ["k8s:app=web"],
            ingress=[IngressRule(
                from_endpoints=(EndpointSelector.make(["k8s:app=lb"]),),
                to_ports=(PortRule(ports=(PortProtocol(80, "TCP"),)),),
            )],
            labels=["k8s:policy=m0"],
        ),
    ])
    reg = IdentityRegistry()
    web = reg.allocate(parse_label_array(["k8s:app=web"]))
    lb = reg.allocate(parse_label_array(["k8s:app=lb"]))
    other = reg.allocate(parse_label_array(["k8s:app=other"]))
    cache = IPCache()
    cache.upsert("10.0.0.2/32", lb.id, source="k8s")
    cache.upsert("10.0.0.4/32", other.id, source="k8s")
    hub = MonitorHub() if with_monitor else None
    pf = PreFilter()
    pf.insert(pf.revision, ["192.0.2.0/24"])
    pipe = DatapathPipeline(PolicyEngine(repo, reg, device="cpu"), cache, pf, monitor=hub,
                            device="cpu")
    pipe.set_endpoints([(7, web.id)])
    return pipe, hub, dict(web=web, lb=lb, other=other)


class TestPipelineEmission:
    def test_drop_events_with_reasons_and_identity(self):
        pipe, hub, ids = _pipeline()
        sub = hub.subscribe()
        src = ip_strings_to_u32(["10.0.0.2", "10.0.0.4", "192.0.2.7"])
        pipe.process(src, np.zeros(3, np.int32), np.array([80, 80, 80]), np.array([6, 6, 6]))
        events = sub.drain()
        # two drops: policy (identity 'other') and prefilter
        assert len(events) == 2
        by_reason = {e.reason: e for e in events}
        pol = by_reason[REASON_POLICY]
        assert pol.endpoint == 7  # endpoint ID, not index
        assert pol.src_identity == ids["other"].id
        assert pol.peer_addr == bytes([10, 0, 0, 4])
        assert REASON_PREFILTER in by_reason
        assert by_reason[REASON_PREFILTER].producer == "prefilter"

    def test_trace_events_opt_in(self):
        pipe, hub, ids = _pipeline()
        sub = hub.subscribe()
        src = ip_strings_to_u32(["10.0.0.2"])
        args = (src, np.zeros(1, np.int32), np.array([80]), np.array([6]))
        pipe.process(*args)
        assert sub.drain() == []  # forwarded + trace off ⇒ silence
        pipe.trace_enabled = True
        pipe.process(*args)
        evs = sub.drain()
        assert len(evs) == 1 and isinstance(evs[0], TraceNotify)
        assert evs[0].src_identity == ids["lb"].id
        assert "to-endpoint" in evs[0].summary()

    def test_no_subscriber_no_events(self):
        pipe, hub, _ = _pipeline()
        src = ip_strings_to_u32(["10.0.0.4"])
        pipe.process(src, np.zeros(1, np.int32), np.array([80]), np.array([6]))
        assert hub.published == 0  # hub.active gate short-circuits

    def test_policy_verdict_events_option_gated(self):
        """OFF emits no verdict events at all; ON reports EVERY flow's
        decision — allowed included — with the wire reason that decided
        it."""
        pipe, hub, ids = _pipeline()
        sub = hub.subscribe()
        src = ip_strings_to_u32(["10.0.0.2", "10.0.0.4"])
        args = (src, np.zeros(2, np.int32), np.array([80, 80]), np.array([6, 6]))
        pipe.process(*args)
        off = [e for e in sub.drain() if isinstance(e, PolicyVerdictNotify)]
        assert off == []
        pipe.verdict_notifications = True
        pipe.process(*args)
        evs = [e for e in sub.drain() if isinstance(e, PolicyVerdictNotify)]
        assert len(evs) == 2
        by_action = {e.action: e for e in evs}
        allowed, denied = by_action[1], by_action[0]
        assert allowed.src_identity == ids["lb"].id
        assert allowed.reason == 0  # plain allow carries REASON_UNKNOWN
        assert denied.reason == REASON_POLICY
        assert denied.src_identity == ids["other"].id
        assert denied.rule_index == -1  # FlowAttribution off
        assert denied.endpoint == 7  # endpoint ID, not index

    def test_drop_notifications_off_and_per_endpoint(self):
        """The DropNotification switch turns drops off; an
        ``endpoint_options`` resolver overrides it per endpoint."""
        pipe, hub, _ = _pipeline()
        sub = hub.subscribe()
        args = (ip_strings_to_u32(["10.0.0.4"]), np.zeros(1, np.int32), np.array([80]),
                np.array([6]))
        pipe.drop_notifications = False
        pipe.process(*args)
        assert sub.drain() == []
        asked = []

        def opts(ep, name, default):
            asked.append((ep, name, default))
            return name == "DropNotification"

        pipe.endpoint_options = opts
        pipe.process(*args)
        evs = sub.drain()
        assert [type(e) for e in evs] == [DropNotify]
        assert asked == [(7, "DropNotification", False), (7, "PolicyVerdictNotification", False)]

    def test_resolver_faults(self):
        """A resolver's environmental fault gives the default; a
        programmer error in it reaches the caller."""
        pipe, hub, _ = _pipeline()
        sub = hub.subscribe()
        args = (ip_strings_to_u32(["10.0.0.4"]), np.zeros(1, np.int32), np.array([80]),
                np.array([6]))

        def flaky(ep, name, default):
            raise OSError("option store unreachable")

        pipe.endpoint_options = flaky
        pipe.process(*args)
        assert [type(e) for e in sub.drain()] == [DropNotify]

        def buggy(ep, name, default):
            raise TypeError("resolver bug")

        pipe.endpoint_options = buggy
        with pytest.raises(TypeError, match="resolver bug"):
            pipe.process(*args)
        assert sub.drain() == []


class TestMonitorSocket:
    def test_stream_over_unix_socket(self, tmp_path):
        hub = MonitorHub()
        srv = MonitorServer(hub, str(tmp_path / "mon.sock"))
        srv.start()
        try:
            got = []
            done = threading.Event()

            def reader():
                for ev in monitor_stream(str(tmp_path / "mon.sock"), timeout=3.0):
                    got.append(ev)
                    if len(got) == 3:
                        break
                done.set()

            t = threading.Thread(target=reader)
            t.start()
            # wait until the server registered the subscription
            deadline = time.monotonic() + 5
            while not hub.active and time.monotonic() < deadline:
                time.sleep(0.02)
            hub.publish(AgentNotify(kind="policy-updated", message="rev 3"))
            hub.publish(DropNotify(
                reason=REASON_POLICY, endpoint=1, src_identity=2, family=4,
                peer_addr=b"\x0a\x00\x00\x01", dport=80, proto=6, ingress=True,
            ))
            hub.publish(L7Notify(verdict="Denied", detail="GET /admin"))
            assert done.wait(5)
            t.join(timeout=5)
            assert [e.type for e in got] == [3, EVENT_DROP, 4]
            assert got[1].peer_addr == b"\x0a\x00\x00\x01"
        finally:
            srv.stop()

    def test_pipeline_events_stream_to_a_client(self, tmp_path):
        """A batch's events reach a ``monitor_stream`` client through the
        server: as many as the hub published, the same events."""
        pipe, hub, _ = _pipeline()
        path = str(tmp_path / "mon.sock")
        srv = MonitorServer(hub, path)
        srv.start()
        try:
            got = []
            done = threading.Event()
            n_want = []

            def reader():
                for ev in monitor_stream(path, timeout=3.0):
                    got.append(ev)
                    if n_want and len(got) >= n_want[0]:
                        break
                done.set()

            t = threading.Thread(target=reader)
            t.start()
            deadline = time.monotonic() + 5
            while not hub.active and time.monotonic() < deadline:
                time.sleep(0.02)
            sub = hub.subscribe(capacity=1 << 12)
            rs = np.random.default_rng(3)
            src = ip_strings_to_u32(["10.0.0.2", "10.0.0.4", "192.0.2.7", "8.8.8.8"])[
                rs.integers(0, 4, 200)]
            pipe.trace_enabled = True
            pipe.process(src, np.zeros(200, np.int32), rs.choice([80, 443], 200),
                         np.full(200, 6))
            want = sub.drain()
            n_want.append(hub.published)
            assert len(want) == hub.published == 200
            assert done.wait(10)
            t.join(timeout=5)
            assert got == want
        finally:
            srv.stop()


class TestDissect:
    """Packet dissection: raw frames → per-layer summary lines,
    resilient to truncation."""

    @staticmethod
    def _eth(payload, etype, vlan=None):
        hdr = bytes(range(6)) + bytes(range(6, 12))
        if vlan is not None:
            return hdr + struct.pack(">HHH", 0x8100, vlan, etype) + payload
        return hdr + struct.pack(">H", etype) + payload

    @staticmethod
    def _ipv4(proto, payload, src="10.1.0.5", dst="10.1.0.7"):
        return (
            struct.pack(">BBHHHBBH", 0x45, 0, 20 + len(payload), 1, 0, 64, proto, 0)
            + ipaddress.IPv4Address(src).packed
            + ipaddress.IPv4Address(dst).packed
            + payload
        )

    def test_tcp_syn(self):
        tcp = struct.pack(">HHIIBBHHH", 3380, 80, 1, 0, 5 << 4, 0x02, 512, 0, 0)
        d = dissect(self._eth(self._ipv4(6, tcp), 0x0800))
        assert d.summary() == "IP 10.1.0.5:3380 -> 10.1.0.7:80 tcp SYN"
        assert d.ttl == 64

    def test_udp_with_vlan(self):
        udp = struct.pack(">HHHH", 53530, 53, 8, 0)
        d = dissect(self._eth(self._ipv4(17, udp), 0x0800, vlan=7))
        assert d.vlan == 7
        assert "udp" in d.summary() and ":53 " in d.summary() + " "

    def test_icmp_and_arp(self):
        icmp = bytes([8, 0, 0, 0])
        d = dissect(self._eth(self._ipv4(1, icmp), 0x0800))
        assert "icmp EchoRequest" in d.summary()
        arp = (
            struct.pack(">HHBBH", 1, 0x0800, 6, 4, 1)
            + bytes(6) + ipaddress.IPv4Address("10.0.0.2").packed
            + bytes(6) + ipaddress.IPv4Address("10.0.0.1").packed
        )
        d = dissect(self._eth(arp, 0x0806))
        assert d.summary() == "ARP request 10.0.0.1 tell 10.0.0.2"

    def test_ipv6_tcp_with_ext_header(self):
        tcp = struct.pack(">HHIIBBHHH", 1000, 443, 0, 0, 5 << 4, 0x12, 512, 0, 0)
        # hop-by-hop ext header (next=6, len=0 → 8 bytes)
        ext = bytes([6, 0, 0, 0, 0, 0, 0, 0])
        ip6 = (
            struct.pack(">IHBB", 6 << 28, len(ext) + len(tcp), 0, 64)
            + ipaddress.IPv6Address("fd00::1").packed
            + ipaddress.IPv6Address("fd00::2").packed
            + ext + tcp
        )
        d = dissect(self._eth(ip6, 0x86DD))
        assert d.summary() == "IPv6 fd00::1:1000 -> fd00::2:443 tcp SYN, ACK"

    def test_truncation_never_raises(self):
        frame = self._eth(self._ipv4(6, b"\x00\x01"), 0x0800)
        for cut in range(len(frame)):
            d = dissect(frame[:cut])  # every prefix must decode safely
            assert isinstance(d.summary(), str)

    def test_capture_event_roundtrip(self):
        tcp = struct.pack(">HHIIBBHHH", 1, 2, 0, 0, 5 << 4, 0x10, 0, 0, 0)
        frame = self._eth(self._ipv4(6, tcp), 0x0800)
        ev = DebugCapture(endpoint=7, data=frame, orig_len=1500)
        back = decode(encode(ev))
        assert back.endpoint == 7 and back.data == frame
        assert back.orig_len == 1500
        assert "** capture ep 7 (1500 bytes): IP" in back.summary()

    @pytest.mark.parametrize("cut", [0, 14, 30, 54])
    def test_same_summary_as_jax(self, cut):
        from cilium_tpu.monitor import dissect as jdissect

        tcp = struct.pack(">HHIIBBHHH", 3380, 80, 1, 0, 5 << 4, 0x18, 512, 0, 0)
        frame = self._eth(self._ipv4(6, tcp), 0x0800, vlan=3)[:cut or None]
        assert dissect(frame).summary() == jdissect(frame).summary()


def _read_line(proc, deadline: float) -> str:
    """The child's first stdout line, waiting no later than
    ``deadline`` (monotonic); '' when it does not come in time."""
    fd = proc.stdout.fileno()
    buf = b""
    while b"\n" not in buf:
        left = deadline - time.monotonic()
        if left <= 0:
            return ""
        ready, _, _ = select.select([fd], [], [], left)
        if not ready:
            return ""
        chunk = os.read(fd, 256)
        if not chunk:
            return ""
        buf += chunk
    return buf.split(b"\n", 1)[0].decode()


class TestStandaloneMonitorProcess:
    """The monitor as its own process owning the client socket; the
    agent only feeds events. Client streams survive the agent dying."""

    def test_events_flow_through_real_process(self, tmp_path):
        from cilium_tpu_torch.monitor.standalone import MonitorFeeder

        def _drop(reason, ep):
            return DropNotify(
                reason=reason, endpoint=ep, src_identity=9, family=4,
                peer_addr=b"\x08\x08\x08\x08", dport=80, proto=6, ingress=True,
            )

        def wait_for(cond, seconds):
            deadline = time.monotonic() + seconds
            while not cond() and time.monotonic() < deadline:
                time.sleep(0.05)
            return cond()

        listen = str(tmp_path / "mon.sock")
        feed = str(tmp_path / "mon.feed")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cilium_tpu_torch.monitor", "--listen", listen,
             "--feed", feed],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=str(REPO),
        )
        feeders = []
        try:
            assert _read_line(proc, time.monotonic() + 60) == "READY"
            got = []
            done = threading.Event()

            def client():
                for ev in monitor_stream(listen, timeout=20.0):
                    got.append(ev)
                    if len(got) >= 3:
                        done.set()
                        return

            t = threading.Thread(target=client, daemon=True)
            t.start()

            # "agent" #1: hub + feeder; the client's attach reaches the
            # agent as demand (the feeder's subscription turns active)
            hub = MonitorHub()
            feeders.append(MonitorFeeder(hub, feed, retry_s=0.1).start())
            assert wait_for(lambda: feeders[0].reconnects > 0, 20)
            assert wait_for(lambda: hub.active, 20), "the client's attach never reached the agent"
            hub.publish(_drop(1, 7))
            hub.publish(_drop(2, 7))

            # agent "restart": the feeder dies, the CLIENT stays up
            assert wait_for(lambda: len(got) >= 2, 20)
            feeders[0].stop()
            hub2 = MonitorHub()
            feeders.append(MonitorFeeder(hub2, feed, retry_s=0.1).start())
            assert wait_for(lambda: feeders[1].reconnects > 0, 20)
            assert wait_for(lambda: hub2.active, 20)
            hub2.publish(_drop(3, 8))

            assert done.wait(20), f"client saw only {len(got)} events"
            assert [e.reason for e in got] == [1, 2, 3]
            assert got[2].endpoint == 8  # post-"restart" event arrived
        finally:
            for f in feeders:
                f.stop()
            proc.kill()
            proc.wait(timeout=10)
            proc.stdout.close()


def test_module_entry_point_usage():
    """``python -m cilium_tpu_torch.monitor`` names itself in its usage
    and refuses a call without its two sockets."""
    out = subprocess.run([sys.executable, "-m", "cilium_tpu_torch.monitor"], cwd=str(REPO),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 2
    assert "python -m cilium_tpu_torch.monitor" in out.stderr and "--listen" in out.stderr


class TestTraceSummary:
    def test_trace_summary_published_and_roundtrips(self):
        pipe, hub, _ = _pipeline()
        pipe.tracer.enable()
        sub = hub.subscribe()
        pipe.process(ip_strings_to_u32(["10.0.0.2"] * 8), np.zeros(8, np.int32),
                     np.full(8, 80), np.full(8, 6))
        events = [e for e in sub.drain() if isinstance(e, TraceSummary)]
        assert len(events) == 1
        ev = events[0]
        assert ev.kind == "v4-ingress" and ev.batch == 8
        assert decode(encode(ev)) == ev
        assert "## trace v4-ingress" in ev.summary()
        assert [p[0] for p in ev.phases] == [p[0] for p in pipe.tracer.traces()[-1]["phases"]]
        sub.close()

    def test_no_trace_event_without_hub_subscriber(self):
        pipe, hub, _ = _pipeline()
        pipe.tracer.enable()
        pipe.process(ip_strings_to_u32(["10.0.0.2"] * 8), np.zeros(8, np.int32),
                     np.full(8, 80), np.full(8, 6))
        assert len(pipe.tracer.traces()) == 1
        sub = hub.subscribe()
        assert sub.drain() == [] and hub.published == 0
        sub.close()


def test_monitor_modules_copy_the_reference():
    """The stdlib host modules of this slice are the JAX package's own,
    with only the lines that name the package changed."""
    changed = {
        "monitor/__main__.py": 1, "monitor/standalone.py": 2, "utils/procutil.py": 1,
    }
    for rel in ("monitor/__init__.py", "monitor/__main__.py", "monitor/dissect.py",
                "monitor/events.py", "monitor/hub.py", "monitor/server.py",
                "monitor/standalone.py", "observe/flows.py", "utils/framing.py",
                "utils/logging.py", "utils/procutil.py"):
        a = (REPO / "cilium_tpu" / rel).read_text().splitlines()
        b = (REPO / "cilium_tpu_torch" / rel).read_text().splitlines()
        assert len(a) == len(b), rel
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        assert len(diff) == changed.get(rel, 0), (rel, diff)
        for x, y in diff:
            assert "cilium_tpu_torch." in y and "cilium_tpu." in x, (rel, x, y)
    importlib.import_module("cilium_tpu_torch.monitor.__main__")
