"""IANA protocol numbers ↔ names (reference: pkg/u8proto/u8proto.go).

The single source of truth for the nexthdr encoding used across the
compiler tables, verdict kernels, and policymap keys
(bpf/lib/common.h:180 policy_key.nexthdr).
"""

from __future__ import annotations

ICMP = 1
TCP = 6
UDP = 17
ICMPV6 = 58

_NAMES = {ICMP: "ICMP", TCP: "TCP", UDP: "UDP", ICMPV6: "ICMPv6"}
_NUMBERS = {v.upper(): k for k, v in _NAMES.items()}


def to_name(proto: int) -> str:
    return _NAMES.get(proto, str(proto))


def from_name(name: str) -> int:
    try:
        return _NUMBERS[name.upper()]
    except KeyError:
        raise ValueError(f"unknown protocol {name!r}") from None
