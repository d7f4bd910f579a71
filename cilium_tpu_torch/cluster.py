"""Clustered-agent assembly: one Daemon joined to the kvstore fabric.

The runDaemon wiring of the reference (daemon/main.go:818 →
kvstore.Setup, InitIdentityAllocator, node registration,
InitIPIdentityWatcher, clustermesh) as one composable object: given a
Daemon and a kvstore backend, ClusterNode

- swaps the daemon's identity allocation onto the cluster-wide CAS
  allocator (every node numbers identities identically — which is
  what keeps compiled policy tensor ROWS compatible across nodes),
- registers the node and attaches the registry to the daemon (health
  probing + tunnel/route programming ride the same observer),
- announces local endpoint IPs on the ip→identity prefix and merges
  every other node's announcements into the local ipcache,
- exports the node's services and (optionally) merges remote
  clusters' identities/ipcache/services via clustermesh.

Convergence is pump()-driven (deterministic for tests, a controller
loop in daemons), matching the rest of the kvstore layer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .identity.distributed import DistributedIdentityAllocator
from .ipcache.ipcache import SOURCE_AGENT
from .ipcache.kvstore_sync import IPIdentitySync
from .kvstore.backend import BackendOperations
from .kvstore.clustermesh import ClusterMesh
from .nodes.registry import Node, NodeRegistry
from .utils.logging import get_logger

log = get_logger("cluster")

# a backend that died mid-operation (kvstore outage) raises these;
# teardown paths treat them as "the server's lease expiry will finish
# the job"
_KV_DOWN = (ConnectionError, TimeoutError, RuntimeError, OSError)


class ClusterNode:
    def __init__(
        self,
        daemon,
        backend: BackendOperations,
        node: Node,
        *,
        cluster: str = "default",
        probe_interval: float = 60.0,
    ) -> None:
        self.daemon = daemon
        self.backend = backend
        self.cluster = cluster
        self.probe_interval = probe_interval
        self._closed = False
        # name → (backend, factory) for every add_remote_cluster call,
        # so rejoin() can re-establish clustermesh subscriptions
        self._remote_clusters: Dict[str, Tuple] = {}
        # cluster-wide identity numbering (InitIdentityAllocator)
        self.identities = DistributedIdentityAllocator(
            backend, daemon.registry, node.name
        )
        daemon.allocate_identity = self.identities.allocate
        daemon.release_identity = self.identities.release
        # endpoints created BEFORE the join (standalone run, snapshot
        # restore) carry local-cursor identity numbers the cluster
        # never agreed on — re-allocate them through the CAS so their
        # numbers (and the announcements below) are cluster-valid
        self._adopt_existing_endpoints()
        # node membership + health/tunnel/route programming
        self.nodes = NodeRegistry(backend, node)
        daemon.attach_node_registry(self.nodes, probe_interval=probe_interval)
        # ip→identity announcements (InitIPIdentityWatcher)
        self.ipsync = IPIdentitySync(backend, daemon.ipcache, cluster=cluster)
        daemon.ipcache.add_listener(self._on_ipcache_change, replay=True)
        # remote-cluster merge (identities + ipcache + services)
        self.mesh = ClusterMesh(
            daemon.registry, daemon.ipcache, services=daemon.services
        )
        log.info("joined cluster", fields={
            "cluster": cluster, "nodeName": node.name,
        })

    def _adopt_existing_endpoints(self) -> None:
        from collections import defaultdict

        from .identity.model import MIN_USER_IDENTITY

        daemon = self.daemon
        by_ident = defaultdict(list)
        for ep in daemon.endpoint_manager.endpoints():
            if ep.identity is not None:
                by_ident[ep.identity.id].append(ep)
        renumbered = 0
        for _ident_id, eps in by_ident.items():
            old = eps[0].identity
            # reserved (host/world/…) and local CIDR identities keep
            # their fixed/local numbering — only user-range globals
            # need cluster agreement
            if old.id < MIN_USER_IDENTITY or old.is_local:
                continue
            # the local standalone binding must go FIRST: the registry
            # (rightly) refuses the same labels under two numbers
            for _ in eps:
                daemon.registry.release(old)
            new = self.identities.allocate(old.labels)
            for _ in eps[1:]:
                self.identities.allocate(old.labels)  # one ref per ep
            for ep in eps:
                ep.identity = new
                if new.id != old.id:
                    for ip, plen in ((ep.ipv4, 32), (ep.ipv6, 128)):
                        if ip:
                            daemon.ipcache.upsert(
                                f"{ip}/{plen}", new.id, source=SOURCE_AGENT
                            )
            if new.id != old.id:
                renumbered += len(eps)
        if renumbered:
            daemon._sync_pipeline_endpoints()
            daemon._regenerate("cluster join renumbering")
            log.info("renumbered endpoints at cluster join",
                     fields={"count": renumbered})

    # -- local endpoint announcements -----------------------------------
    def _on_ipcache_change(self, cidr, old, new) -> None:
        """Announce ONLY agent-sourced entries (this node's endpoints).
        kvstore-sourced entries are other nodes' announcements echoed
        back — re-announcing them would loop; the ipcache's source
        priority (agent > kvstore) already keeps our local truth from
        being clobbered by our own echo."""
        host = self.nodes.local.ipv4 or self.nodes.local.ipv6
        if new is not None and new.source == SOURCE_AGENT:
            self.ipsync.announce(cidr, new.identity, host_ip=host)
        elif new is None and old is not None and old.source == SOURCE_AGENT:
            self.ipsync.withdraw(cidr)

    # -- services -------------------------------------------------------
    def export_services(self) -> int:
        """Publish this node's service table for remote clusters
        (the clustermesh services export)."""
        return self.daemon.services.export_to_store(self.backend, self.cluster)

    def add_remote_cluster(self, name: str, backend: BackendOperations,
                           factory=None):
        """Subscribe a remote cluster's state (clustermesh). ``factory``
        (→ a fresh BackendOperations) lets rejoin() re-establish the
        subscription after an outage; without one a rejoin re-uses
        ``backend`` if it is still alive and otherwise drops the
        cluster with a warning."""
        self._remote_clusters[name] = (backend, factory)
        return self.mesh.add_cluster(name, backend)

    # -- convergence ----------------------------------------------------
    def pump(self) -> int:
        """Drain every subscription (identities, ipcache, nodes,
        remote clusters); the next pipeline rebuild picks up the new
        state. Returns events applied."""
        n = self.identities.pump()
        n += self.ipsync.pump()
        n += self.nodes.pump()
        n += self.mesh.pump()
        return n

    def close(self) -> None:
        """Leave the cluster SYMMETRICALLY to __init__ (idempotent):
        the daemon keeps serving standalone afterwards — allocation
        falls back to the local registry, this node's announcements
        are WITHDRAWN (not left to lease expiry: peers must stop
        routing here immediately), learned tunnel/route state is
        flushed, and the prober is halted rather than probing a
        frozen node list forever.

        Tolerates a DEAD backend (kvstore outage): the remote
        withdrawals are skipped — the server-side lease expiry is
        already doing that job — while every local teardown still
        runs, so a rejoin can follow."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        daemon = self.daemon
        daemon.allocate_identity = daemon.registry.allocate
        daemon.release_identity = daemon.registry.release
        daemon.ipcache.remove_listener(self._on_ipcache_change)
        daemon.health.stop()
        daemon.health.nodes = None
        try:
            self.ipsync.withdraw_all()
        except _KV_DOWN:
            log.warning("kvstore unreachable; leaving withdrawals to lease expiry")
        # learned state must not outlive the membership: encap tables
        # AND the kvstore-sourced ip→identity entries (with the
        # watcher gone they would never update again — a reused peer
        # IP would keep the departed cluster's identity forever)
        daemon.tunnel.clear()
        daemon.routes.clear()
        from .ipcache.ipcache import SOURCE_KVSTORE

        for cidr, e in daemon.ipcache.items():
            if e.source == SOURCE_KVSTORE:
                daemon.ipcache.delete(cidr, SOURCE_KVSTORE)
        self.mesh.close()
        self.ipsync.close()
        try:
            self.nodes.unregister()
        except _KV_DOWN:
            pass  # lease expiry withdraws the registration
        self.nodes.close()
        self.identities.close()

    # -- failure recovery ------------------------------------------------
    def rejoin(self, backend: BackendOperations) -> "ClusterNode":
        """Recover from a kvstore outage: tear this membership down
        (tolerating the dead backend) and rebuild it on a fresh one.
        Everything __init__ does runs again — identities re-CAS
        (endpoints keep or re-agree their numbers), this node
        re-registers, and every agent-sourced ip→identity entry
        re-announces via the replaying ipcache listener. The reference
        analog: the etcd session-loss → reconnect → re-create path of
        pkg/kvstore/allocator + node store. Returns self."""
        # under the daemon lock (an RLock — the constructors re-enter
        # it): an endpoint PUT landing between close() and the
        # adoption snapshot would otherwise keep a local-cursor
        # identity number the new cluster never CAS-agreed, and two
        # nodes could map one id to different label sets
        remotes = dict(self._remote_clusters)
        # Held across the rebuild on purpose: API calls stall for the
        # duration (bounded by the backend's op timeout per CAS), but
        # an endpoint created mid-rebuild with an un-agreed identity
        # number would poison cross-node enforcement — correctness
        # over availability, and the controller only retries on the
        # backoff schedule. Callers can hand rejoin a backend with a
        # short op_timeout to bound the worst case.
        with self.daemon._lock:
            self.close()
            try:
                self.__init__(
                    self.daemon, backend, self.nodes.local,
                    cluster=self.cluster, probe_interval=self.probe_interval,
                )
            except Exception:
                # the server died AGAIN mid-rebuild: restore the
                # standalone fallbacks a half-run __init__ may have
                # rebound (allocation must keep working locally) and
                # leave the node closed so the next controller tick
                # retries the whole rejoin
                d = self.daemon
                d.allocate_identity = d.registry.allocate
                d.release_identity = d.registry.release
                try:
                    d.ipcache.remove_listener(self._on_ipcache_change)
                except Exception:
                    pass
                d.health.stop()
                d.health.nodes = None
                self._closed = True
                try:
                    backend.close()
                except Exception:
                    pass
                # the partial __init__ reset _remote_clusters: keep the
                # snapshot so the NEXT successful rejoin still re-adds
                # every clustermesh subscription
                self._remote_clusters = remotes
                raise
        # clustermesh subscriptions are per-remote-backend: re-add each
        # (fresh backend from its factory when given; else reuse the
        # old one if it survived the outage)
        for cname, (rbe, factory) in remotes.items():
            try:
                fresh = factory() if factory is not None else rbe
                if not fresh.alive():
                    raise ConnectionError("remote backend not alive")
                self.add_remote_cluster(cname, fresh, factory)
            except Exception as e:
                log.warning("remote cluster dropped at rejoin", fields={
                    "cluster": cname, "err": f"{type(e).__name__}: {e}",
                })
        # no export_services() here: the cluster-sync controller runs
        # one right after every successful rejoin anyway
        return self

    def joined(self) -> bool:
        """True while this membership is live (backend reachable and
        not torn down) — the cluster-sync controller's rejoin gate."""
        return not self._closed and self.backend.alive()
