"""Cluster-wide identity allocator: reserve/confirm CAS over the kvstore.

# policyd: hot

Extends the master/slave scheme of :mod:`cilium_tpu_torch.kvstore.allocator`
(allocator.go:80-106) with the federation protocol it needs to hold
its no-double-assign guarantee under partitions and node death:

    <base>/id/<id>              = key   (master: THE allocation, durable)
    <base>/value/<key>/<node>   = id    (slave: per-node use, lease-bound)
    <base>/reserve/<id>         = node  (reserve: candidate claim, lease-bound)
    <base>/locks/<key>          =       (per-key CAS lock)

Reserve/confirm: before CAS-creating the durable master key, a node
CAS-creates a *lease-bound* reserve key on its candidate id. Two
federated nodes that both computed the same smallest-unused id diverge
at the reserve instead of burning a master-CAS round, and a node that
crashes between picking an id and confirming it leaks nothing — the
reserve evaporates with its lease. The master ``create_only`` remains
the single arbiter, so the protocol stays wire-compatible with
pre-federation nodes running the plain :class:`Allocator` on the same
path: a legacy node racing on the same id simply wins or loses at the
master CAS.

Partitions: every kvstore round-trip may raise ``ConnectionError``
(FlakyBackend, a real etcd outage). ``allocate`` folds both CAS races
and partitions into one retry loop riding ``utils/backoff`` with FULL
jitter (decorrelates the post-partition thundering herd) and a
``max_elapsed_s`` cap so callers get a :class:`FederationError` instead
of an unbounded stall. Nothing is retried *inside* a CAS — an attempt
either fully confirms or changes nothing durable, so a retry after a
mid-attempt partition converges onto the adopt path.

Lease expiry: slave keys (and reserves) die with the node's lease.
``heartbeat()`` is the renewal side — it re-creates this node's
slave/master keys after a lease loss (so GC cannot reap identities
still in local use) and reaps any of this node's orphaned reserves.
The release-on-lease-expiry side needs no code here: a dead node's
slave keys vanish, and ``run_gc`` reaps masters with no slaves left.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Set, Tuple

from .. import metrics as _metrics
from ..kvstore.allocator import Allocator, AllocatorError
from ..kvstore.backend import BackendOperations
from ..utils.backoff import Backoff

# what a kvstore partition looks like from here: FlakyBackend raises
# ConnectionError, a real client surfaces timeouts/socket errors, and
# a lease-expired write raises RuntimeError (transient under the
# FileBackend keepalive; permanent loss exhausts the backoff into a
# FederationError instead of leaking a raw backend error)
_KV_DOWN = (ConnectionError, TimeoutError, OSError, RuntimeError)


class FederationError(Exception):
    """Allocation failed after the backoff budget (partition outlasted
    ``max_elapsed_s``) — the caller decides whether to degrade."""


def _default_backoff() -> Backoff:
    # ms-scale floors: identity allocation sits on the endpoint-create
    # path, and the contended case is CAS races between a handful of
    # nodes, not a 60s-class outage ladder
    return Backoff(
        min_s=0.005, max_s=0.25, full_jitter=True, max_elapsed_s=2.0
    )


class ClusterIdentityAllocator(Allocator):
    """Federated id↔key allocation with reserve/confirm + heartbeats.

    Drop-in for :class:`Allocator` (same ``allocate(key) -> (id,
    is_new)`` contract and key scheme); ``node_name`` takes the slave
    suffix role and names this node in reserve keys.
    """

    def __init__(
        self,
        backend: BackendOperations,
        base_path: str,
        *,
        node_name: str,
        min_id: int = 1,
        max_id: int = 1 << 16,
        on_event: Optional[Callable[[str, int, Optional[str]], None]] = None,
        backoff_factory: Optional[Callable[[], Backoff]] = None,
    ) -> None:
        self.node_name = node_name
        self.reserve_prefix = base_path.rstrip("/") + "/reserve/"
        self._backoff_factory = backoff_factory or _default_backoff
        # reserves this node holds for allocations in flight RIGHT NOW
        # (API threads) — heartbeat's orphan sweep must not reap them
        self._inflight_reserves: Set[int] = set()
        # per-instance outcome counts: the metric family is process-
        # global, but in-process multi-node tests/bench want per-node
        self._counts: dict = {}
        super().__init__(
            backend,
            base_path,
            suffix=node_name,
            min_id=min_id,
            max_id=max_id,
            on_event=on_event,
        )

    # ------------------------------------------------------------------
    def _reserve_key(self, id_: int) -> str:
        return f"{self.reserve_prefix}{id_}"

    def _account(self, result: str) -> None:
        with self._lock:
            self._counts[result] = self._counts.get(result, 0) + 1
        _metrics.cluster_identity_allocations_total.inc({"result": result})

    def _select_candidate(self) -> int:
        """Smallest id unused by both the master list AND live reserves
        (a peer mid-confirm holds only a reserve; skipping it saves the
        master-CAS round both would otherwise burn)."""
        used = set(self._cache)
        for k in self.backend.list_prefix(self.id_prefix):
            try:
                used.add(int(k[len(self.id_prefix):]))
            except ValueError:
                pass
        for k in self.backend.list_prefix(self.reserve_prefix):
            try:
                used.add(int(k[len(self.reserve_prefix):]))
            except ValueError:
                pass
        for cand in range(self.min_id, self.max_id + 1):
            if cand not in used:
                return cand
        return 0

    # -- allocation -----------------------------------------------------
    def _allocate_once(self, key: str) -> Optional[Tuple[int, bool]]:
        """One adopt-or-reserve/confirm attempt. Returns (id, is_new),
        or None when a CAS race demands a retry; kvstore partitions
        surface as ``_KV_DOWN`` to the caller's backoff loop."""
        self.pump()
        value = self.get_no_cache(key)
        if value == 0:
            # a peer may have confirmed the master without our watch
            # having delivered a slave key yet
            for id_, k in self.cache_items().items():
                if k == key:
                    value = id_
                    break
        if value != 0:
            # adopt: serialize with GC via the per-key lock, slave write
            # conditioned on the master still existing
            lock = self.backend.lock_path(self.lock_prefix + key)
            try:
                if not self._create_slave(key, value):
                    return None  # master reaped mid-adopt; re-resolve
            finally:
                lock.unlock()
            self._local_ref(key, value)
            return value, False

        id_ = self._select_candidate()
        if id_ == 0:
            self._account("error")
            raise AllocatorError("no more available IDs in configured space")
        # reserve: lease-bound claim on the candidate. Loss here means a
        # federated peer is mid-confirm on this id — re-select, nothing
        # durable happened.
        if not self.backend.create_only(
            self._reserve_key(id_), self.node_name.encode(), lease=True
        ):
            return None
        with self._lock:
            self._inflight_reserves.add(id_)
        try:
            lock = self.backend.lock_path(self.lock_prefix + key)
            try:
                if self.get_no_cache(key) != 0:
                    return None  # lost the key race; adopt on retry
                if not self.backend.create_only(
                    self._master_key(id_), key.encode(), lease=False
                ):
                    # a legacy (non-reserving) node won the master CAS
                    return None
                self._create_slave(key, id_)
            finally:
                lock.unlock()
        finally:
            with self._lock:
                self._inflight_reserves.discard(id_)
            # confirm (or abandon): the reserve's job is done either
            # way; if THIS delete rides a partition, the lease reaps it
            self.backend.delete(self._reserve_key(id_))
        with self._lock:
            self._cache[id_] = key
        self._local_ref(key, id_)
        if self._on_event:
            self._on_event("upsert", id_, key)
        return id_, True

    def allocate(self, key: str) -> Tuple[int, bool]:
        """→ (id, is_new). Local-refcount fast path, then the
        adopt-or-reserve/confirm loop riding full-jitter backoff across
        both CAS races and kvstore partitions."""
        with self._lock:
            held = self._local.get(key)
            if held is not None:
                self._local[key] = (held[0], held[1] + 1)
                self._account("cached")
                return held[0], False

        backoff = self._backoff_factory()
        last_err: Optional[str] = None
        while True:
            try:
                got = self._allocate_once(key)
            except _KV_DOWN as e:
                last_err = f"{type(e).__name__}: {e}"
                got = None
            if got is not None:
                self._account("new" if got[1] else "adopted")
                return got
            d = backoff.duration()
            if backoff.exhausted:
                self._account("error")
                raise FederationError(
                    f"allocation of {key!r} failed after backoff budget: "
                    f"{last_err or 'CAS contention'}"
                )
            self._account("retry")
            if d > 0.0:
                time.sleep(d)

    # -- lease renewal ---------------------------------------------------
    def heartbeat(self) -> int:
        """Lease renewal + lease-loss recovery: re-create this node's
        missing slave/master keys (resync_local_keys) and reap our own
        orphaned reserve keys (a crashed confirm's leftovers — the
        lease would reap them too; this just does it sooner). Returns
        the number of keys repaired."""
        fixed = self.resync_local_keys()
        with self._lock:
            inflight = set(self._inflight_reserves)
        for k, raw in self.backend.list_prefix(self.reserve_prefix).items():
            if (raw or b"").decode() != self.node_name:
                continue
            try:
                id_ = int(k[len(self.reserve_prefix):])
            except ValueError:
                continue
            if id_ not in inflight:
                self.backend.delete(k)
        return fixed

    def state(self) -> dict:
        """Status snapshot for GET /cluster."""
        with self._lock:
            return {
                "held": len(self._local),
                "cached": len(self._cache),
                "allocations": dict(self._counts),
            }
