"""Node route table.

Reference: pkg/datapath/route (route.go) + the per-remote-node route
installation of pkg/node/manager.go — each remote node's allocation
CIDR gets a route via the tunnel device (encap) or the node's address
(direct routing). Here the "kernel table" is a host map the datapath
simulator and debuginfo read; fed by the same node-registry observer
machinery as the tunnel map (maps/prefixmap.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .prefixmap import PrefixMap, observe_node_cidrs


@dataclasses.dataclass(frozen=True)
class Route:
    prefix: str
    nexthop: Optional[str]  # None = on-link / via tunnel device
    device: str
    mtu: int = 0


class RouteTable(PrefixMap):
    def upsert(self, route: Route) -> None:
        self.upsert_value(route.prefix, route)

    def lookup(self, ip: str) -> Optional[Route]:
        """Longest-prefix route for a destination."""
        return self.lookup_value(ip)

    def items(self) -> List[Route]:
        return [route for _prefix, route in self.value_items()]

    def observe_nodes(self, registry, *, tunnel_device: str = "cilium_vxlan",
                      route_mtu: int = 0) -> None:
        """Remote nodes' alloc CIDRs → routes (node/manager.go
        nodeUpdated route install); shared node-event semantics in
        prefixmap.observe_node_cidrs."""

        def on_change(node, host, new, stale) -> None:
            for prefix in stale:
                self.delete(prefix)
            for prefix in new:
                self.upsert(Route(
                    prefix=prefix,
                    nexthop=host,
                    device=tunnel_device,
                    mtu=route_mtu,
                ))

        observe_node_cidrs(registry, on_change)
