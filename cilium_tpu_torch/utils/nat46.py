"""NAT46/64 address embedding.

Reference: bpf/lib/nat46.h — IPv4 addresses embedded in IPv6 per the
configured prefix (RFC 6052 /96 style: the v4 address occupies the
low 32 bits). Pure address math; the packet-rewrite half of the
reference collapses into the datapath simulator's address handling.
"""

from __future__ import annotations

import ipaddress

DEFAULT_PREFIX = "64:ff9b::/96"  # RFC 6052 well-known prefix


def embed_v4(v4: str, prefix: str = DEFAULT_PREFIX) -> str:
    """IPv4 → IPv6 inside ``prefix`` (nat46.h ipv4 to ipv6)."""
    net = ipaddress.ip_network(prefix, strict=False)
    if net.version != 6 or net.prefixlen > 96:
        raise ValueError(f"NAT46 prefix must be IPv6 /96 or shorter: {prefix}")
    v4_int = int(ipaddress.IPv4Address(v4))
    return str(ipaddress.IPv6Address(int(net.network_address) | v4_int))


def extract_v4(v6: str, prefix: str = DEFAULT_PREFIX) -> str:
    """IPv6 inside ``prefix`` → the embedded IPv4 (nat46.h ipv6 to
    ipv4); raises if the address is outside the prefix."""
    net = ipaddress.ip_network(prefix, strict=False)
    addr = ipaddress.IPv6Address(v6)
    if addr not in net:
        raise ValueError(f"{v6} not inside NAT46 prefix {prefix}")
    return str(ipaddress.IPv4Address(int(addr) & 0xFFFFFFFF))


def is_nat46(v6: str, prefix: str = DEFAULT_PREFIX) -> bool:
    """True when ``v6`` lies inside the NAT46 prefix. The prefix is
    parsed with strict=False like embed/extract — the predicate must
    accept every address those functions produce — and only a
    malformed ADDRESS yields False."""
    net = ipaddress.ip_network(prefix, strict=False)
    try:
        addr = ipaddress.IPv6Address(v6)
    except ValueError:
        return False
    return addr in net
