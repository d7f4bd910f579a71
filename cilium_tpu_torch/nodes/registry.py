"""Cluster node registry over the shared store.

Re-design of pkg/node (store.go:60 registerNode,
manager.go:62 cluster node manager): the local node registers itself —
name, cluster, addresses, per-family allocation CIDRs — as a
lease-bound shared-store key, and observes every other node. Observers
get add/update/delete callbacks; the datapath consumer uses them to
maintain tunnel-endpoint state (the tunnel-map role) so remote-node
prefixes resolve to a host IP.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

from ..kvstore.backend import BackendOperations
from ..kvstore.store import SharedStore

from ..kvstore.paths import NODES_PATH


@dataclasses.dataclass(frozen=True)
class Node:
    """node.Node (pkg/node/node.go): addressing facts other nodes need."""

    name: str
    cluster: str = "default"
    ipv4: Optional[str] = None
    ipv6: Optional[str] = None
    health_ip: Optional[str] = None
    # port of the node's cilium-health responder; None = the default
    # 4240 (single-host test clusters need per-node ports)
    health_port: Optional[int] = None
    ipv4_alloc_cidr: Optional[str] = None
    ipv6_alloc_cidr: Optional[str] = None

    @property
    def key_name(self) -> str:
        # store.go GetKeyName: cluster/name — STABLE API in the reference
        return f"{self.cluster}/{self.name}"

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(**{f.name: d.get(f.name) for f in dataclasses.fields(cls)
                      if f.name in d})


# fn(node, present)  — present=False on delete
NodeObserver = Callable[[Node, bool], None]


class NodeRegistry:
    """One node's membership + view of the cluster."""

    def __init__(
        self,
        backend: BackendOperations,
        local: Node,
        *,
        base_path: str = NODES_PATH,
    ) -> None:
        self.local = local
        self._lock = threading.RLock()
        self._observers: List[NodeObserver] = []
        self.nodes: Dict[str, Node] = {}
        self.store = SharedStore(
            backend,
            base_path,
            on_update=self._on_update,
            on_delete=self._on_delete,
        )
        self.store.update_local_key_sync(local.key_name, local.to_dict())
        self.pump()

    # ------------------------------------------------------------------
    def _on_update(self, name: str, value: dict) -> None:
        node = Node.from_dict(value)
        with self._lock:
            self.nodes[name] = node
            obs = list(self._observers)
        for fn in obs:
            fn(node, True)

    def _on_delete(self, name: str, old: Optional[dict]) -> None:
        with self._lock:
            node = self.nodes.pop(name, None)
            obs = list(self._observers)
        if node is None and old is not None:
            node = Node.from_dict(old)
        if node is not None:
            for fn in obs:
                fn(node, False)

    def observe(self, fn: NodeObserver, replay: bool = True) -> None:
        with self._lock:
            self._observers.append(fn)
            current = list(self.nodes.values()) if replay else []
        for node in current:
            fn(node, True)

    def pump(self) -> int:
        return self.store.pump()

    def remote_nodes(self) -> List[Node]:
        with self._lock:
            return [n for n in self.nodes.values() if n.name != self.local.name]

    def get(self, cluster: str, name: str) -> Optional[Node]:
        with self._lock:
            return self.nodes.get(f"{cluster}/{name}")

    def announce_local(self, node: Node) -> None:
        """Replace this node's cluster announcement (store.go
        registerNode re-announce — e.g. once the health sidecar's port
        is known)."""
        self.local = node
        self.store.update_local_key_sync(node.key_name, node.to_dict())

    def unregister(self) -> None:
        self.store.delete_local_key(self.local.key_name)

    def resync(self) -> int:
        return self.store.sync_local_keys()

    def close(self) -> None:
        self.store.close()
