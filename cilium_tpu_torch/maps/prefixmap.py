"""Shared longest-prefix map machinery.

TunnelMap and RouteTable are both "remote prefix → something" tables
programmed from node-registry events; this base keeps the prefix
normalization, the LPM lookup (parsed networks cached at insert — no
re-parsing per lookup), and the per-node programmed-set diffing in
ONE place so the two cannot drift.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Dict, List, Optional, Set, Tuple


def norm_prefix(prefix: str) -> str:
    return str(ipaddress.ip_network(prefix, strict=False))


class PrefixMap:
    """prefix (CIDR) → value with longest-prefix lookup."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # prefix → (parsed network, value)
        self._entries: Dict[str, Tuple[object, object]] = {}

    def upsert_value(self, prefix: str, value) -> None:
        net = ipaddress.ip_network(prefix, strict=False)
        with self._lock:
            self._entries[str(net)] = (net, value)

    def delete(self, prefix: str) -> bool:
        with self._lock:
            return self._entries.pop(norm_prefix(prefix), None) is not None

    def lookup_value(self, ip: str):
        addr = ipaddress.ip_address(ip)
        best, best_len = None, -1
        with self._lock:
            for net, value in self._entries.values():
                if net.version == addr.version and addr in net:
                    if net.prefixlen > best_len:
                        best, best_len = value, net.prefixlen
        return best

    def value_items(self) -> List[Tuple[str, object]]:
        with self._lock:
            return sorted(
                (prefix, value)
                for prefix, (_net, value) in self._entries.items()
            )

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def observe_node_cidrs(registry, on_change) -> None:
    """Subscribe ``on_change(node, host_ip, new_cidrs, stale_cidrs)``
    to a NodeRegistry with the shared semantics both maps need:

    - the LOCAL node is skipped (its prefixes deliver locally),
    - a node with alloc CIDRs but NO address yet (partial
      registration) programs nothing — a half-registered peer must
      not install entries claiming reachability,
    - a changed CIDR set reports the removed prefixes as stale.
    """
    local_key = registry.local.key_name
    programmed: Dict[str, Set[str]] = {}

    def on_node(node, live: bool) -> None:
        if node.key_name == local_key:
            return
        host = node.ipv4 or node.ipv6
        new = (
            {
                norm_prefix(c)
                for c in (node.ipv4_alloc_cidr, node.ipv6_alloc_cidr)
                if c
            }
            if live and host else set()
        )
        old = programmed.get(node.key_name, set())
        on_change(node, host, new, old - new)
        if new:
            programmed[node.key_name] = new
        else:
            programmed.pop(node.key_name, None)

    registry.observe(on_node, replay=True)
