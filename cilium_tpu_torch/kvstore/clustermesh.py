"""ClusterMesh: merge remote clusters' state into the local caches.

Re-design of pkg/clustermesh/clustermesh.go:49 +
remote_cluster.go: each remote cluster is reached through its OWN
kvstore backend; per cluster we subscribe nodes, identities, and the
ip→identity table, and merge them into the local registries. Identity
rows for remote identities land in the local IdentityRegistry, so
device policy tensors grow rows for remote workloads exactly like
local ones — the verdict kernel never knows a flow's peer lives in
another cluster.

The reference discovers clusters from a config directory (fsnotify);
here clusters are added/removed programmatically — the config-watch
loop belongs to the daemon layer.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional

from typing import TYPE_CHECKING

from ..identity.registry import IdentityRegistry
from ..ipcache.ipcache import IPCache, SOURCE_KVSTORE

if TYPE_CHECKING:  # runtime import is lazy — nodes.registry depends on
    from ..nodes.registry import Node  # kvstore, so a top-level import
    # here would make `import cilium_tpu_torch.nodes` order-dependent
from ..labels import parse_label_array
from .backend import (
    BackendOperations,
    EventTypeDelete,
    EventTypeListDone,
    Watcher,
)
from .paths import (
    IDENTITIES_PATH,
    IP_IDENTITIES_PATH,
    NODES_PATH,
    key_to_label_strings,
)


def _key_to_labels(key: str):
    return parse_label_array(key_to_label_strings(key))


class RemoteCluster:
    """Subscriptions into one remote cluster's kvstore
    (remote_cluster.go): nodes + identities + ipcache + exported
    services (the global-service backend merge)."""

    def __init__(
        self,
        name: str,
        backend: BackendOperations,
        registry: IdentityRegistry,
        ipcache: IPCache,
        on_node: Optional[Callable[[str, Node, bool], None]] = None,
        services=None,  # Optional[lb.service.ServiceManager]
    ) -> None:
        self.name = name
        self.backend = backend
        self.registry = registry
        self.ipcache = ipcache
        self.services = services
        self._on_node = on_node
        self._id_prefix = f"{IDENTITIES_PATH}/id/"
        self._ip_prefix = f"{IP_IDENTITIES_PATH}/{name}/"
        self._node_prefix = f"{NODES_PATH}/"
        from ..lb.service import SERVICES_EXPORT_PATH

        self._svc_prefix = f"{SERVICES_EXPORT_PATH}/{name}/"
        self._w_ids: Watcher = backend.list_and_watch(
            f"mesh-{name}-identities", self._id_prefix
        )
        self._w_ips: Watcher = backend.list_and_watch(
            f"mesh-{name}-ip", self._ip_prefix
        )
        self._w_nodes: Watcher = backend.list_and_watch(
            f"mesh-{name}-nodes", self._node_prefix
        )
        self._w_svcs: Optional[Watcher] = (
            backend.list_and_watch(f"mesh-{name}-services", self._svc_prefix)
            if services is not None else None
        )
        self._held_ids: Dict[int, bool] = {}
        self._ip_entries: set = set()
        self._svc_frontends: set = set()
        self.nodes: Dict[str, Node] = {}
        self.pump()

    # ------------------------------------------------------------------
    def pump(self) -> int:
        """Apply pending remote events (the RemoteCache merge of
        allocator.go + ipcache kvstore watcher, scoped to this
        cluster)."""
        from ..nodes.registry import Node  # lazy: breaks import cycle

        n = 0
        for ev in self._w_ids.drain():
            n += 1
            if ev.typ == EventTypeListDone:
                continue
            try:
                id_ = int(ev.key[len(self._id_prefix):])
            except ValueError:
                continue
            if ev.typ == EventTypeDelete:
                if self._held_ids.pop(id_, None):
                    self.registry.release_by_id(id_)
            else:
                if id_ in self._held_ids or self.registry.get(id_) is not None:
                    continue
                try:
                    self.registry.insert_global(
                        id_, _key_to_labels((ev.value or b"").decode())
                    )
                    self._held_ids[id_] = True
                except ValueError:
                    # conflicting binding: local cluster wins; the
                    # reference logs and skips (cache.go invalidKey)
                    continue
        for ev in self._w_ips.drain():
            n += 1
            if ev.typ == EventTypeListDone:
                continue
            cidr = ev.key[len(self._ip_prefix):]
            if ev.typ == EventTypeDelete:
                self.ipcache.delete(cidr, SOURCE_KVSTORE)
                self._ip_entries.discard(cidr)
            else:
                try:
                    payload = json.loads((ev.value or b"{}").decode())
                except ValueError:
                    continue
                self.ipcache.upsert(
                    cidr,
                    int(payload.get("identity", 0)),
                    source=SOURCE_KVSTORE,
                    host_ip=payload.get("host_ip"),
                )
                self._ip_entries.add(cidr)
        for ev in self._w_nodes.drain():
            n += 1
            if ev.typ == EventTypeListDone:
                continue
            name = ev.key[len(self._node_prefix):]
            if ev.typ == EventTypeDelete:
                node = self.nodes.pop(name, None)
                if node is not None and self._on_node:
                    self._on_node(self.name, node, False)
            else:
                try:
                    node = Node.from_dict(json.loads((ev.value or b"{}").decode()))
                except ValueError:
                    continue
                self.nodes[name] = node
                if self._on_node:
                    self._on_node(self.name, node, True)
        if self._w_svcs is not None:
            from ..lb.service import Backend, L3n4Addr

            for ev in self._w_svcs.drain():
                n += 1
                if ev.typ == EventTypeListDone:
                    continue
                fe_str = ev.key[len(self._svc_prefix):]
                if ev.typ == EventTypeDelete:
                    fe = self._parse_frontend(fe_str)
                    if fe is not None:
                        self.services.set_remote_backends(fe, self.name, [])
                        self._svc_frontends.discard(fe)
                    continue
                try:
                    payload = json.loads((ev.value or b"{}").decode())
                    f = payload["frontend"]
                    fe = L3n4Addr(f["ip"], int(f["port"]),
                                  str(f.get("protocol", "TCP")))
                    backs = [
                        Backend(b["ip"], int(b["port"]),
                                int(b.get("weight", 1)))
                        for b in payload.get("backends", [])
                    ]
                    # set_remote_backends validates addresses — a
                    # remote cluster's malformed export must be
                    # skipped, not crash this pump loop
                    self.services.set_remote_backends(fe, self.name, backs)
                except (ValueError, KeyError, TypeError):
                    continue
                self._svc_frontends.add(fe)
        return n

    @staticmethod
    def _parse_frontend(text: str):
        from ..lb.service import L3n4Addr

        try:
            return L3n4Addr.from_string(text)
        except ValueError:
            return None

    def on_remove(self) -> None:
        """Withdraw everything this cluster contributed (clustermesh
        cluster.onRemove): release mirrored identities, drop merged
        ipcache entries, stop watchers."""
        for id_ in list(self._held_ids):
            self.registry.release_by_id(id_)
        self._held_ids.clear()
        for cidr in list(self._ip_entries):
            self.ipcache.delete(cidr, SOURCE_KVSTORE)
        self._ip_entries.clear()
        if self.services is not None:
            for fe in list(self._svc_frontends):
                self.services.set_remote_backends(fe, self.name, [])
            self._svc_frontends.clear()
        watchers = [self._w_ids, self._w_ips, self._w_nodes]
        if self._w_svcs is not None:
            watchers.append(self._w_svcs)
        for w in watchers:
            self.backend.stop_watcher(w)


class ClusterMesh:
    """The local node's cache of remote clusters
    (clustermesh.go:49)."""

    def __init__(
        self,
        registry: IdentityRegistry,
        ipcache: IPCache,
        *,
        on_node: Optional[Callable[[str, Node, bool], None]] = None,
        services=None,  # Optional[lb.service.ServiceManager]
    ) -> None:
        self.registry = registry
        self.ipcache = ipcache
        self._on_node = on_node
        self._services = services
        self._lock = threading.RLock()
        self.clusters: Dict[str, RemoteCluster] = {}

    def add_cluster(self, name: str, backend: BackendOperations) -> RemoteCluster:
        with self._lock:
            if name in self.clusters:
                return self.clusters[name]
            rc = RemoteCluster(
                name, backend, self.registry, self.ipcache, self._on_node,
                services=self._services,
            )
            self.clusters[name] = rc
            return rc

    def remove_cluster(self, name: str) -> bool:
        with self._lock:
            rc = self.clusters.pop(name, None)
        if rc is None:
            return False
        rc.on_remove()
        return True

    def pump(self) -> int:
        with self._lock:
            clusters = list(self.clusters.values())
        return sum(rc.pump() for rc in clusters)

    def num_clusters(self) -> int:
        with self._lock:
            return len(self.clusters)

    def close(self) -> None:
        with self._lock:
            names = list(self.clusters)
        for n in names:
            self.remove_cluster(n)
