"""Datapath event model + binary codecs.

Reference: pkg/monitor/datapath_drop.go:28 (DropNotify), pkg/monitor/
datapath_trace.go:28 (TraceNotify), pkg/monitor/agent.go (agent
notifications), and the notify event types of bpf/lib/common.h:209.
The kernel emits fixed-layout C structs into the perf ring; here the
pipeline emits typed events whose wire form is a fixed-layout struct
too (monitor/server.py frames them onto the monitor socket), so
external consumers get the same "binary payload protocol" boundary
the reference's monitor daemon speaks (monitor/monitor.go:184,301).
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional, Tuple

# event types (common.h:209 CILIUM_NOTIFY_*)
EVENT_DROP = 1
EVENT_TRACE = 2
EVENT_AGENT = 3
EVENT_L7 = 4
EVENT_CAPTURE = 5  # DebugCapture (datapath_debug.go:368)
EVENT_TRACE_SUMMARY = 6  # policyd-trace per-batch phase breakdown
EVENT_POLICY_VERDICT = 7  # PolicyVerdictNotify (datapath_policy.go:21)

# drop reasons (bpf/lib/common.h DROP_* / pkg/monitor/api errors)
REASON_POLICY = 133  # DROP_POLICY (generic / attribution off)
REASON_PREFILTER = 144  # prefilter deny (XDP)
REASON_NO_SERVICE = 146  # lb4_local: frontend without backends
REASON_CT_MAP_FULL = 135
REASON_UNKNOWN = 0
# policyd-flows attribution taxonomy (FlowAttribution=true): DROP_POLICY
# refined by WHICH term decided the flow. Codes picked from the unused
# 150s of the u8 reason space (the codec carries reasons in the u8
# "sub" field). STABLE API — ROADMAP lists them; renumbering breaks
# stored flow logs and monitor consumers.
REASON_POLICY_DENY = 151  # an explicit deny rule matched
REASON_POLICY_NO_L3 = 152  # no L3 allow covered the peer
REASON_POLICY_NO_L4 = 153  # L4 coverage existed, peer not allowed
REASON_PROXY_REDIRECT = 154  # allowed, but diverted to the L7 proxy
# policyd-failsafe: the pipeline could not verdict the batch (device
# fault exhausted its retries) and FailOpen is off — fail-closed deny
REASON_PIPELINE_DEGRADED = 155

_REASON_NAMES = {
    REASON_POLICY: "Policy denied",
    REASON_PREFILTER: "Prefilter denied",
    REASON_NO_SERVICE: "No service backend",
    REASON_CT_MAP_FULL: "CT map insertion failed",
    REASON_UNKNOWN: "Unknown",
    REASON_POLICY_DENY: "Policy denied (deny rule)",
    REASON_POLICY_NO_L3: "Policy denied (no L3 allow)",
    REASON_POLICY_NO_L4: "Policy denied (no L4 allow)",
    REASON_PROXY_REDIRECT: "Proxy redirect (L7)",
    REASON_PIPELINE_DEGRADED: "Pipeline degraded (fail-closed)",
}

# trace observation points (pkg/monitor/datapath_trace.go TraceTo*)
TRACE_TO_ENDPOINT = 1
TRACE_FROM_ENDPOINT = 2
TRACE_TO_PROXY = 3

_TRACE_NAMES = {
    TRACE_TO_ENDPOINT: "to-endpoint",
    TRACE_FROM_ENDPOINT: "from-endpoint",
    TRACE_TO_PROXY: "to-proxy",
}


def reason_name(code: int) -> str:
    return _REASON_NAMES.get(code, f"reason-{code}")


@dataclasses.dataclass(frozen=True)
class DropNotify:
    """One dropped flow (DropNotify, datapath_drop.go:28)."""

    reason: int
    endpoint: int  # local endpoint id
    src_identity: int  # peer identity row's identity (0 if unknown)
    family: int  # 4 | 6
    peer_addr: bytes  # 4 or 16 address bytes (the REMOTE address)
    dport: int
    proto: int
    ingress: bool
    # reason-144 disambiguation: WHICH of the two prefilter producers
    # dropped the flow — "admission" (host admission gate) or
    # "prefilter" (device shed kernel). Empty for every other reason
    # (those have a single producer each). Bounded by construction:
    # contracts.METRIC_BOUNDED_LABEL_KEYS lists "producer".
    producer: str = ""
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def type(self) -> int:
        return EVENT_DROP

    def summary(self) -> str:
        d = "ingress" if self.ingress else "egress"
        import ipaddress

        ip = ipaddress.ip_address(self.peer_addr)
        via = f" via {self.producer}" if self.producer else ""
        return (
            f"xx drop ({reason_name(self.reason)}){via} {d} "
            f"ep {self.endpoint} peer {ip} identity {self.src_identity} "
            f"dport {self.dport} proto {self.proto}"
        )


@dataclasses.dataclass(frozen=True)
class TraceNotify:
    """One forwarded flow (TraceNotify, datapath_trace.go:28)."""

    obs_point: int
    endpoint: int
    src_identity: int
    family: int
    peer_addr: bytes
    dport: int
    proto: int
    ingress: bool
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def type(self) -> int:
        return EVENT_TRACE

    def summary(self) -> str:
        import ipaddress

        ip = ipaddress.ip_address(self.peer_addr)
        return (
            f"-> {_TRACE_NAMES.get(self.obs_point, self.obs_point)} "
            f"ep {self.endpoint} peer {ip} identity {self.src_identity} "
            f"dport {self.dport} proto {self.proto}"
        )


@dataclasses.dataclass(frozen=True)
class PolicyVerdictNotify:
    """One policy verdict (PolicyVerdictNotify, pkg/monitor/
    datapath_policy.go:21), emitted per sampled flow while the
    PolicyVerdictNotification option is on — unlike DropNotify/
    TraceNotify it reports ALLOWED flows too, with the wire reason
    that decided them."""

    action: int  # 0 = denied, 1 = allowed, 2 = redirected (L7)
    reason: int  # REASON_* wire code (REASON_UNKNOWN for plain allow)
    endpoint: int
    src_identity: int
    family: int
    peer_addr: bytes
    dport: int
    proto: int
    ingress: bool
    # matched rule position from the attribution kernel's origin
    # output; -1 while FlowAttribution is off (no recompile either way)
    rule_index: int = -1
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def type(self) -> int:
        return EVENT_POLICY_VERDICT

    def summary(self) -> str:
        import ipaddress

        verdict = {0: "denied", 1: "allowed", 2: "redirected"}.get(
            self.action, f"action-{self.action}"
        )
        ip = ipaddress.ip_address(self.peer_addr)
        rule = f" rule {self.rule_index}" if self.rule_index >= 0 else ""
        return (
            f"policy-verdict {verdict} ({reason_name(self.reason)})"
            f"{rule} ep {self.endpoint} peer {ip} "
            f"identity {self.src_identity} dport {self.dport} "
            f"proto {self.proto}"
        )


@dataclasses.dataclass(frozen=True)
class AgentNotify:
    """Control-plane event (pkg/monitor/agent.go AgentNotify):
    policy imports, endpoint lifecycle, regenerations."""

    kind: str  # "policy-updated" | "endpoint-created" | ...
    message: str
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def type(self) -> int:
        return EVENT_AGENT

    def summary(self) -> str:
        return f">> agent {self.kind}: {self.message}"


@dataclasses.dataclass(frozen=True)
class L7Notify:
    """L7 access-log record surfaced on the monitor stream
    (pkg/proxy/logger → monitor agent events)."""

    verdict: str
    detail: str
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def type(self) -> int:
        return EVENT_L7

    def summary(self) -> str:
        return f"L7 {self.verdict}: {self.detail}"


# ---------------------------------------------------------------------
# Binary wire codec — fixed little-endian layouts, one per event type.
# Flow events: type u8, sub u8 (reason/obs), flags u8 (bit0 ingress,
# bit1 family==6), proto u8, endpoint u32, identity u32, dport u16,
# pad u16, timestamp f64, addr 16s (v4 left-aligned, zero-padded).
@dataclasses.dataclass(frozen=True)
class DebugCapture:
    """A raw packet capture from the datapath (DebugCapture,
    pkg/monitor/datapath_debug.go:368): the monitor dissects the
    payload into a per-layer summary (dissect.py — the gopacket role
    of pkg/monitor/dissect.go)."""

    endpoint: int
    data: bytes  # raw Ethernet frame (possibly truncated by the capture)
    orig_len: int = 0  # pre-truncation length (0 = len(data))
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def type(self) -> int:
        return EVENT_CAPTURE

    def summary(self) -> str:
        from .dissect import dissect

        n = self.orig_len or len(self.data)
        return (
            f"** capture ep {self.endpoint} ({n} bytes): "
            f"{dissect(self.data).summary()}"
        )


@dataclasses.dataclass(frozen=True)
class TraceSummary:
    """One completed verdict-batch trace (policyd-trace): total wall
    time plus the (name, start-offset-ns, duration-ns) phase list. The
    tracer publishes these only while a monitor listener is attached
    (hub.active), same cost contract as flow events."""

    kind: str  # e.g. "v4-ingress"
    batch: int  # flow count of the batch
    total_ns: int
    phases: Tuple[Tuple[str, int, int], ...]
    timestamp: float = dataclasses.field(default_factory=time.time)

    @property
    def type(self) -> int:
        return EVENT_TRACE_SUMMARY

    def summary(self) -> str:
        top = sorted(self.phases, key=lambda p: -p[2])[:3]
        parts = ", ".join(f"{n} {d / 1e6:.2f}ms" for n, _r, d in top)
        return (
            f"## trace {self.kind} batch={self.batch} "
            f"total={self.total_ns / 1e6:.2f}ms [{parts}]"
        )


_FLOW_FMT = "<BBBBIIHHd16s"
_FLOW_LEN = struct.calcsize(_FLOW_FMT)
# DropNotify producer rides the flow layout's previously-zero pad u16
# (same frame length, old decoders read it as pad): the wire stays
# layout-stable while reason-144 frames carry WHICH producer shed.
_PRODUCER_CODES = {"": 0, "admission": 1, "prefilter": 2}
_PRODUCER_NAMES = {v: k for k, v in _PRODUCER_CODES.items()}
# verdict events: the flow layout (sub = reason) with action u8 and
# rule index i16 appended
_VERDICT_FMT = "<BBBBIIHHd16sBh"
_VERDICT_LEN = struct.calcsize(_VERDICT_FMT)


def encode(ev) -> bytes:
    t = ev.type
    if t in (EVENT_DROP, EVENT_TRACE):
        sub = ev.reason if t == EVENT_DROP else ev.obs_point
        flags = (1 if ev.ingress else 0) | (2 if ev.family == 6 else 0)
        pad = (
            _PRODUCER_CODES.get(ev.producer, 0) if t == EVENT_DROP else 0
        )
        return struct.pack(
            _FLOW_FMT, t, sub, flags, ev.proto, ev.endpoint,
            ev.src_identity, ev.dport, pad, ev.timestamp,
            bytes(ev.peer_addr).ljust(16, b"\x00"),
        )
    if t == EVENT_POLICY_VERDICT:
        flags = (1 if ev.ingress else 0) | (2 if ev.family == 6 else 0)
        return struct.pack(
            _VERDICT_FMT, t, ev.reason, flags, ev.proto, ev.endpoint,
            ev.src_identity, ev.dport, 0, ev.timestamp,
            bytes(ev.peer_addr).ljust(16, b"\x00"),
            ev.action, ev.rule_index,
        )
    if t == EVENT_AGENT:
        kind = ev.kind.encode()
        msg = ev.message.encode()
        return struct.pack("<BHH", t, len(kind), len(msg)) + kind + msg + struct.pack("<d", ev.timestamp)
    if t == EVENT_L7:
        v = ev.verdict.encode()
        d = ev.detail.encode()
        return struct.pack("<BHH", t, len(v), len(d)) + v + d + struct.pack("<d", ev.timestamp)
    if t == EVENT_CAPTURE:
        # the wire length field is u16: oversized aggregates (GRO/
        # jumbo) ship their head + the true length — never a codec
        # crash inside the publish path
        data = ev.data[:65535]
        return (
            struct.pack("<BIIHd", t, ev.endpoint,
                        ev.orig_len or len(ev.data), len(data),
                        ev.timestamp)
            + data
        )
    if t == EVENT_TRACE_SUMMARY:
        kind = ev.kind.encode()[:255]
        out = [struct.pack(
            "<BBHIQd", t, len(kind), len(ev.phases), ev.batch,
            ev.total_ns, ev.timestamp,
        ), kind]
        for name, rel, dur in ev.phases:
            nb = name.encode()[:255]
            out.append(struct.pack("<B", len(nb)))
            out.append(nb)
            out.append(struct.pack("<QQ", rel, dur))
        return b"".join(out)
    raise ValueError(f"unknown event type {t}")


def decode(buf: bytes):
    t = buf[0]
    if t in (EVENT_DROP, EVENT_TRACE):
        (t, sub, flags, proto, ep, ident, dport, _pad, ts, addr) = struct.unpack(
            _FLOW_FMT, buf[:_FLOW_LEN]
        )
        family = 6 if flags & 2 else 4
        peer = addr[:16] if family == 6 else addr[:4]
        cls = DropNotify if t == EVENT_DROP else TraceNotify
        kw = dict(
            endpoint=ep, src_identity=ident, family=family, peer_addr=peer,
            dport=dport, proto=proto, ingress=bool(flags & 1), timestamp=ts,
        )
        if t == EVENT_DROP:
            return DropNotify(
                reason=sub, producer=_PRODUCER_NAMES.get(_pad, ""), **kw
            )
        return TraceNotify(obs_point=sub, **kw)
    if t == EVENT_POLICY_VERDICT:
        (
            t, reason, flags, proto, ep, ident, dport, _pad, ts, addr,
            action, rule_index,
        ) = struct.unpack(_VERDICT_FMT, buf[:_VERDICT_LEN])
        family = 6 if flags & 2 else 4
        return PolicyVerdictNotify(
            action=action, reason=reason, endpoint=ep,
            src_identity=ident, family=family,
            peer_addr=addr[:16] if family == 6 else addr[:4],
            dport=dport, proto=proto, ingress=bool(flags & 1),
            rule_index=rule_index, timestamp=ts,
        )
    if t in (EVENT_AGENT, EVENT_L7):
        _, la, lb = struct.unpack("<BHH", buf[:5])
        a = buf[5:5 + la].decode()
        b = buf[5 + la:5 + la + lb].decode()
        (ts,) = struct.unpack("<d", buf[5 + la + lb:5 + la + lb + 8])
        if t == EVENT_AGENT:
            return AgentNotify(kind=a, message=b, timestamp=ts)
        return L7Notify(verdict=a, detail=b, timestamp=ts)
    if t == EVENT_CAPTURE:
        hdr = struct.calcsize("<BIIHd")
        _, ep, orig, dlen, ts = struct.unpack("<BIIHd", buf[:hdr])
        return DebugCapture(
            endpoint=ep, data=buf[hdr:hdr + dlen], orig_len=orig,
            timestamp=ts,
        )
    if t == EVENT_TRACE_SUMMARY:
        hdr = struct.calcsize("<BBHIQd")
        _, klen, n_phases, batch, total_ns, ts = struct.unpack(
            "<BBHIQd", buf[:hdr]
        )
        off = hdr
        kind = buf[off:off + klen].decode()
        off += klen
        phases = []
        for _ in range(n_phases):
            nlen = buf[off]
            off += 1
            name = buf[off:off + nlen].decode()
            off += nlen
            rel, dur = struct.unpack("<QQ", buf[off:off + 16])
            off += 16
            phases.append((name, rel, dur))
        return TraceSummary(
            kind=kind, batch=batch, total_ns=total_ns,
            phases=tuple(phases), timestamp=ts,
        )
    raise ValueError(f"unknown event type {t}")
