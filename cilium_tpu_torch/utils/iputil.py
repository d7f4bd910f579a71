"""CIDR math utilities.

Reference: pkg/ip (ip.go): coalescing adjacent/contained CIDRs,
ip-range → minimal CIDR cover, prefix arithmetic. Used by policy
translation and prefilter programming.
"""

from __future__ import annotations

import ipaddress
from typing import Iterable, List, Tuple, Union

_Net = Union[ipaddress.IPv4Network, ipaddress.IPv6Network]


def coalesce_cidrs(cidrs: Iterable[str]) -> List[str]:
    """Minimal equivalent CIDR set: drops contained prefixes and
    merges adjacent siblings (ip.go CoalesceCIDRs)."""
    v4: List[_Net] = []
    v6: List[_Net] = []
    for c in cidrs:
        net = ipaddress.ip_network(c, strict=False)
        (v4 if net.version == 4 else v6).append(net)
    out: List[str] = []
    for nets in (v4, v6):
        out.extend(str(n) for n in ipaddress.collapse_addresses(nets))
    return out


def range_to_cidrs(first: str, last: str) -> List[str]:
    """Inclusive IP range → minimal CIDR cover (ip.go ipNetToRange
    inverse / summarize_address_range)."""
    a = ipaddress.ip_address(first)
    b = ipaddress.ip_address(last)
    if a.version != b.version:
        raise ValueError("range endpoints must share a family")
    if int(b) < int(a):
        raise ValueError("range end precedes start")
    return [str(n) for n in ipaddress.summarize_address_range(a, b)]


def remove_cidrs(allow: Iterable[str], remove: Iterable[str]) -> List[str]:
    """Allow-set minus remove-set as CIDRs (ip.go RemoveCIDRs — the
    CIDRRule ExceptCIDRs expansion)."""
    removed = [ipaddress.ip_network(c, strict=False) for c in remove]
    out: List[_Net] = []
    for c in allow:
        nets: List[_Net] = [ipaddress.ip_network(c, strict=False)]
        for ex in removed:
            nxt: List[_Net] = []
            for net in nets:
                if net.version != ex.version or not (
                    ex.subnet_of(net) or net.subnet_of(ex) or ex == net
                ):
                    nxt.append(net)
                elif net.subnet_of(ex):
                    continue  # fully removed
                else:
                    nxt.extend(net.address_exclude(ex))
            nets = nxt
        out.extend(nets)
    return [str(n) for n in ipaddress.collapse_addresses(
        [n for n in out if n.version == 4]
    )] + [str(n) for n in ipaddress.collapse_addresses(
        [n for n in out if n.version == 6]
    )]


def prefix_lengths_of(cidrs: Iterable[str]) -> List[Tuple[int, int]]:
    """→ [(family, prefixlen)] for the PrefixLengthCounter."""
    out = []
    for c in cidrs:
        net = ipaddress.ip_network(c, strict=False)
        out.append((net.version, net.prefixlen))
    return out
