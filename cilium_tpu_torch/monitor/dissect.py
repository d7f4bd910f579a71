"""Packet dissection for monitor output.

Reference: pkg/monitor/dissect.go — the monitor decodes the raw packet
bytes a DebugCapture/TraceNotify payload carries (gopacket layers:
Ethernet, ARP, IPv4, IPv6, TCP, UDP, ICMPv4, ICMPv6) into one summary
line per packet. Same layers here, hand-decoded (no scapy in the
image), producing reference-shaped summaries like::

    IP 10.1.0.5:3380 -> 10.1.0.7:80 tcp SYN
    IPv6 fd00::1 -> fd00::2 icmpv6 EchoRequest
    ARP request 10.0.0.1 tell 10.0.0.2
"""

from __future__ import annotations

import dataclasses
import ipaddress
import struct
from typing import Optional

ETH_P_IPV4 = 0x0800
ETH_P_ARP = 0x0806
ETH_P_IPV6 = 0x86DD
ETH_P_8021Q = 0x8100

_TCP_FLAG_NAMES = (
    (0x01, "FIN"), (0x02, "SYN"), (0x04, "RST"), (0x08, "PSH"),
    (0x10, "ACK"), (0x20, "URG"), (0x40, "ECE"), (0x80, "CWR"),
)

_ICMP4_TYPES = {0: "EchoReply", 3: "DestinationUnreachable", 5: "Redirect",
                8: "EchoRequest", 11: "TimeExceeded"}
_ICMP6_TYPES = {1: "DestinationUnreachable", 3: "TimeExceeded",
                128: "EchoRequest", 129: "EchoReply",
                135: "NeighborSolicitation", 136: "NeighborAdvertisement"}

# IPv6 extension headers skipped while hunting the upper-layer proto.
# ESP (50) is NOT here: past it everything is encrypted, so the walk
# stops and reports proto 50. AH (51) has its own 4*(len+2) sizing and
# is handled separately in _ipv6.
_V6_EXT = {0, 43, 44, 60}


@dataclasses.dataclass
class Dissection:
    """Decoded layers of one packet (None = layer absent/truncated)."""

    src_mac: str = ""
    dst_mac: str = ""
    ethertype: int = 0
    vlan: Optional[int] = None
    src_ip: str = ""
    dst_ip: str = ""
    proto: int = 0  # upper-layer protocol number (6/17/1/58/...)
    ttl: int = 0
    sport: Optional[int] = None
    dport: Optional[int] = None
    tcp_flags: str = ""
    icmp_type: str = ""
    arp_op: str = ""
    truncated: bool = False

    def summary(self) -> str:
        if self.arp_op:
            return f"ARP {self.arp_op} {self.dst_ip} tell {self.src_ip}"
        if not self.src_ip:
            return (
                f"Ethernet {self.src_mac} -> {self.dst_mac} "
                f"ethertype 0x{self.ethertype:04x}"
            )
        fam = "IP" if self.ethertype == ETH_P_IPV4 else "IPv6"
        if self.proto == 6 and self.sport is not None:
            return (
                f"{fam} {self.src_ip}:{self.sport} -> {self.dst_ip}:"
                f"{self.dport} tcp {self.tcp_flags or '-'}"
            )
        if self.proto == 17 and self.sport is not None:
            return (
                f"{fam} {self.src_ip}:{self.sport} -> {self.dst_ip}:"
                f"{self.dport} udp"
            )
        if self.proto in (1, 58):
            name = "icmp" if self.proto == 1 else "icmpv6"
            return (
                f"{fam} {self.src_ip} -> {self.dst_ip} {name} "
                f"{self.icmp_type or '?'}"
            )
        tail = " (truncated)" if self.truncated else ""
        return f"{fam} {self.src_ip} -> {self.dst_ip} proto {self.proto}{tail}"


def _mac(b: bytes) -> str:
    return ":".join(f"{x:02x}" for x in b)


def l2_offsets(data: bytes):
    """Shared L2 framing rules: Ethernet frame → (ethertype, l3_offset,
    vlan_id_or_None), or None when the frame is cut before the payload
    ethertype is knowable. ONE definition of the ethertype/802.1Q/
    truncation handling — both the human-facing dissector below and the
    hot-path tuple extractor (datapath/wire.py) build on it, so a
    framing fix lands in exactly one place."""
    if len(data) < 14:
        return None
    (etype,) = struct.unpack_from(">H", data, 12)  # _from: no slice
    off = 14  # allocations on the wire front-end's per-packet path
    vlan = None
    if etype == ETH_P_8021Q:
        if len(data) < 18:
            return None  # cut inside the VLAN tag
        (tci, etype) = struct.unpack_from(">HH", data, 14)
        vlan = tci & 0x0FFF
        off = 18
    return etype, off, vlan


def dissect(data: bytes) -> Dissection:
    """Decode one Ethernet frame, best-effort: truncated packets keep
    whatever layers fit (the monitor must never crash on a capture)."""
    d = Dissection()
    if len(data) < 14:
        d.truncated = True
        return d
    d.dst_mac = _mac(data[0:6])
    d.src_mac = _mac(data[6:12])
    l2 = l2_offsets(data)
    if l2 is None:
        # cut inside the VLAN tag: the payload ethertype is gone
        (d.ethertype,) = struct.unpack(">H", data[12:14])
        d.truncated = True
        return d
    etype, off, vlan = l2
    if vlan is not None:
        d.vlan = vlan
    d.ethertype = etype
    if etype == ETH_P_ARP:
        return _arp(d, data[off:])
    if etype == ETH_P_IPV4:
        return _ipv4(d, data[off:])
    if etype == ETH_P_IPV6:
        return _ipv6(d, data[off:])
    return d


def _arp(d: Dissection, p: bytes) -> Dissection:
    if len(p) < 28:
        d.truncated = True
        return d
    (op,) = struct.unpack(">H", p[6:8])
    d.arp_op = {1: "request", 2: "reply"}.get(op, f"op-{op}")
    d.src_ip = str(ipaddress.IPv4Address(p[14:18]))  # sender
    d.dst_ip = str(ipaddress.IPv4Address(p[24:28]))  # target
    return d


def _ipv4(d: Dissection, p: bytes) -> Dissection:
    if len(p) < 20:
        d.truncated = True
        return d
    ihl = (p[0] & 0x0F) * 4
    d.ttl = p[8]
    d.proto = p[9]
    d.src_ip = str(ipaddress.IPv4Address(p[12:16]))
    d.dst_ip = str(ipaddress.IPv4Address(p[16:20]))
    if len(p) < ihl:
        d.truncated = True
        return d
    return _l4(d, p[ihl:])


def _ipv6(d: Dissection, p: bytes) -> Dissection:
    if len(p) < 40:
        d.truncated = True
        return d
    nxt = p[6]
    d.ttl = p[7]  # hop limit
    d.src_ip = str(ipaddress.IPv6Address(p[8:24]))
    d.dst_ip = str(ipaddress.IPv6Address(p[24:40]))
    off = 40
    # walk common extension headers (fixed 8*(len+1) sizing; AH uses
    # 4*(len+2) per RFC 4302)
    while nxt in _V6_EXT or nxt == 51:
        if len(p) < off + 8:
            d.truncated = True
            d.proto = nxt
            return d
        is_ah = nxt == 51
        nxt, hlen = p[off], p[off + 1]
        off += (hlen + 2) * 4 if is_ah else (hlen + 1) * 8
    d.proto = nxt
    return _l4(d, p[off:])


def _l4(d: Dissection, p: bytes) -> Dissection:
    if d.proto == 6:
        if len(p) < 14:
            d.truncated = True
            return d
        d.sport, d.dport = struct.unpack(">HH", p[0:4])
        flags = p[13]
        d.tcp_flags = ", ".join(n for bit, n in _TCP_FLAG_NAMES if flags & bit)
    elif d.proto == 17:
        if len(p) < 8:
            d.truncated = True
            return d
        d.sport, d.dport = struct.unpack(">HH", p[0:4])
    elif d.proto == 1:
        if len(p) < 2:
            d.truncated = True
            return d
        d.icmp_type = _ICMP4_TYPES.get(p[0], f"type-{p[0]}")
    elif d.proto == 58:
        if len(p) < 2:
            d.truncated = True
            return d
        d.icmp_type = _ICMP6_TYPES.get(p[0], f"type-{p[0]}")
    return d


# ---------------------------------------------------------------------
# policyd-trace waterfall rendering (the trace-summary analogue of a
# packet dissection: turn one TraceSummary's phase list into a human
# view). Lives here so the CLI and monitor share one renderer.

def _fmt_ns(ns: int) -> str:
    if ns >= 1_000_000:
        return f"{ns / 1e6:.2f}ms"
    if ns >= 1_000:
        return f"{ns / 1e3:.1f}µs"
    return f"{ns}ns"


def render_waterfall(
    kind: str,
    batch: int,
    total_ns: int,
    phases,
    width: int = 40,
) -> str:
    """Render one trace as a phase waterfall::

        v4-ingress batch=1024 total=1.20ms
          rebuild      |#                   |   12.0µs   1.0%
          dispatch     |   ########        |  480.0µs  40.0%

    ``phases`` is the trace's ordered (name, rel_start_ns, dur_ns)
    list; bars are positioned by start offset so overlap/ordering is
    visible at a glance. Phase names are a stable API (observe/
    README.md) — bench rounds diff these waterfalls across commits.
    """
    total = max(1, int(total_ns))
    name_w = max((len(p[0]) for p in phases), default=4)
    lines = [f"{kind} batch={batch} total={_fmt_ns(int(total_ns))}"]
    for name, rel, dur in phases:
        start = min(width, int(rel * width / total))
        span = max(1, int(dur * width / total))
        span = min(span, width - start) or 1
        bar = " " * start + "#" * span
        pct = 100.0 * dur / total
        lines.append(
            f"  {name:<{name_w}} |{bar:<{width}}| "
            f"{_fmt_ns(int(dur)):>9} {pct:5.1f}%"
        )
    return "\n".join(lines)
