"""FederationMember: one daemon's membership in the federated plane.

# policyd: hot

Composes the two kvstore planes — the reserve/confirm identity
allocator (identity_plane.py) on the SAME ``IDENTITIES_PATH`` the
pre-federation cluster code uses, and the policy-epoch exchange
(epochs.py) — and bridges them into the daemon:

- ``allocate``/``release`` are the pluggable identity source the
  ``ClusterFederation`` runtime option swaps onto
  ``daemon.allocate_identity`` (OFF restores ``registry.allocate`` —
  numbering is the only difference, compiled programs are identical);
- remote allocations observed on the watch mirror into the local
  :class:`IdentityRegistry` (insert_global) so device rows exist
  before the first flow from that node arrives — the same contract
  :class:`DistributedIdentityAllocator` keeps;
- ``pump()`` is controller-driven (the embedder's cluster-sync
  controller or tests), folding watch delivery, epoch publication, and
  periodic lease heartbeats into one deterministic tick.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..identity.distributed import key_to_labels, labels_to_key
from ..identity.model import (
    Identity,
    MAX_USER_IDENTITY,
    MIN_USER_IDENTITY,
)
from ..kvstore.backend import BackendOperations
from ..kvstore.paths import IDENTITIES_PATH
from ..labels import LabelArray
from .epochs import EpochExchange
from .identity_plane import ClusterIdentityAllocator

_KV_DOWN = (ConnectionError, TimeoutError, OSError, RuntimeError)


class FederationMember:
    """One daemon process's seat in the cluster policy plane."""

    def __init__(
        self,
        daemon,
        backend: BackendOperations,
        node_name: str,
        *,
        cluster: str = "default",
        descriptor: Optional[dict] = None,
        heartbeat_interval: float = 15.0,
        backoff_factory=None,
        identities_path: str = IDENTITIES_PATH,
    ) -> None:
        self.daemon = daemon
        self.backend = backend
        self.node_name = node_name
        self.cluster = cluster
        self.heartbeat_interval = heartbeat_interval
        # lifecycle-journal hook (policyd-journal): the daemon points
        # this at EventJournal.emit while LifecycleJournal is on; None
        # keeps heartbeat/GC at one attribute read (module is hot —
        # pump() rides the cluster-sync controller)
        self.on_journal = None
        self._lock = threading.RLock()
        # ids inserted into the registry on behalf of REMOTE
        # allocations (remote deletes release exactly one ref)
        self._remote_held: Dict[int, str] = {}
        self._closed = False
        # a nodes.registry.Node works directly as the descriptor — the
        # epoch record then carries the same addressing facts the node
        # registry announces (name/cluster/CIDRs/health port)
        if descriptor is not None and hasattr(descriptor, "to_dict"):
            descriptor = descriptor.to_dict()
        self.identities = ClusterIdentityAllocator(
            backend,
            identities_path,
            node_name=node_name,
            min_id=MIN_USER_IDENTITY,
            max_id=MAX_USER_IDENTITY,
            on_event=self._on_identity_event,
            backoff_factory=backoff_factory,
        )
        self.epochs = EpochExchange(
            backend,
            node_name,
            cluster=cluster,
            descriptor=descriptor,
            epoch_source=lambda: daemon.pipeline.policy_epoch,
        )
        self._last_heartbeat = time.monotonic()
        self.epochs.publish(force=True)
        self.pump()

    # -- identity source (daemon.allocate_identity contract) ------------
    def _on_identity_event(self, op: str, id_: int, key: Optional[str]) -> None:
        if op == "upsert":
            assert key is not None
            with self._lock:
                if id_ in self._remote_held:
                    return
                if self.daemon.registry.get(id_) is not None:
                    return  # locally held — allocate() keeps its own ref
                try:
                    self.daemon.registry.insert_global(id_, key_to_labels(key))
                except ValueError:
                    # conflicting binding from outside the kvstore path:
                    # log-and-skip semantics (allocator cache.go
                    # invalidKey) — crashing the watch pump is worse
                    return
                self._remote_held[id_] = key
        elif op == "delete":
            with self._lock:
                if id_ in self._remote_held:
                    del self._remote_held[id_]
                    self.daemon.registry.release_by_id(id_)

    def allocate(self, labels: LabelArray) -> Identity:
        """Cluster-consistent identity allocation through the
        reserve/confirm CAS; the registry row lands under the number
        the whole fleet agreed on."""
        num, _is_new = self.identities.allocate(labels_to_key(labels))
        with self._lock:
            return self.daemon.registry.insert_global(num, labels)

    def release(self, ident: Identity) -> bool:
        """Release the local use; GC reaps the number once no node's
        slave key holds it."""
        key = labels_to_key(ident.labels)
        self.identities.release(key)
        freed = self.daemon.registry.release(ident)
        if freed:
            # still live cluster-wide? re-mirror as a remote hold so
            # local policy rows keep covering it until the master-key
            # delete event arrives (DistributedIdentityAllocator's
            # release contract)
            with self._lock:
                if (
                    ident.id not in self._remote_held
                    and self.backend.get(
                        self.identities._master_key(ident.id)
                    ) is not None
                ):
                    try:
                        self.daemon.registry.insert_global(
                            ident.id, ident.labels
                        )
                        self._remote_held[ident.id] = key
                        freed = False
                    except ValueError:
                        pass
        return freed

    # -- controller tick -------------------------------------------------
    def pump(self) -> int:
        """One deterministic tick: watch delivery (identities + epochs),
        epoch publication when the local epoch moved, and the periodic
        lease heartbeat. Returns events applied."""
        n = self.identities.pump()
        self.epochs.publish()
        n += self.epochs.pump()
        now = time.monotonic()
        if now - self._last_heartbeat >= self.heartbeat_interval:
            self._last_heartbeat = now
            self.heartbeat()
        return n

    def heartbeat(self) -> int:
        """Lease renewal: repair this node's slave/master keys after a
        lease loss and re-write the epoch record (anti-entropy).
        Returns keys repaired."""
        fixed = self.identities.heartbeat()
        self.epochs.sync()
        oj = self.on_journal
        if fixed and oj is not None:
            # keys repaired means a lease EXPIRED out from under us —
            # the fleet timeline wants the loss, not the routine renew
            oj(
                kind="lease_lost",
                severity="warning",
                attrs={"repaired": int(fixed)},
            )
        return fixed

    def run_gc(self):
        reaped = self.identities.run_gc()
        oj = self.on_journal
        if reaped and oj is not None:
            oj(
                kind="identity_reap",
                attrs={"reaped": [int(i) for i in reaped],
                       "count": len(reaped)},
            )
        return reaped

    def wait_cluster_epoch(
        self, epoch: Optional[int] = None, timeout: float = 10.0, **kw
    ) -> bool:
        """Convergence barrier (see EpochExchange.wait_cluster_epoch):
        True once every publishing node enforces at least ``epoch``
        (default: this node's current policy epoch)."""
        return self.epochs.wait_cluster_epoch(epoch, timeout, **kw)

    # -- surfaces --------------------------------------------------------
    def joined(self) -> bool:
        if self._closed:
            return False
        try:
            return bool(self.backend.alive())
        except _KV_DOWN:
            return False

    def status(self) -> Dict:
        """The GET /cluster payload body."""
        view = self.epochs.view()
        return {
            "cluster": self.cluster,
            "node": self.node_name,
            "joined": self.joined(),
            "node_count": len(view),
            "nodes": [view[k] for k in sorted(view)],
            "local_epoch": self.epochs.local_epoch(),
            "cluster_epoch": self.epochs.cluster_epoch(view),
            "epoch_lag": self.epochs.epoch_lag(view),
            "identities": self.identities.state(),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.epochs.close()
        except _KV_DOWN:
            pass
        try:
            self.identities.close()
        except _KV_DOWN:
            pass
