"""Tunnel map: remote prefix → tunnel endpoint (node host IP).

Reference: pkg/maps/tunnel (cilium_tunnel_map) + the per-remote-node
programming of pkg/node/manager.go:94-195 (each node's allocation
CIDRs map to its host IP for encap). Fed by a node-registry observer;
the datapath's encap stage consults it for non-local destinations.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .prefixmap import PrefixMap, observe_node_cidrs


class TunnelMap(PrefixMap):
    def upsert(self, prefix: str, endpoint_ip: str) -> None:
        self.upsert_value(prefix, endpoint_ip)

    def lookup(self, ip: str) -> Optional[str]:
        """Longest-prefix match → tunnel endpoint for a destination."""
        return self.lookup_value(ip)

    def items(self) -> List[Tuple[str, str]]:
        return self.value_items()

    def observe_nodes(self, registry) -> None:
        """Wire to a NodeRegistry: REMOTE nodes' alloc CIDRs → their
        node IP (node/manager.go nodeUpdated/nodeDeleted). Shared
        semantics (local-node skip, partial-registration guard, stale
        CIDR removal) live in prefixmap.observe_node_cidrs."""

        def on_change(node, host, new, stale) -> None:
            for prefix in stale:
                self.delete(prefix)
            for prefix in new:
                self.upsert(prefix, host)

        observe_node_cidrs(registry, on_change)
