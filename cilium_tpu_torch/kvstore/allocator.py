"""Distributed ID allocator over the kvstore (CAS master/slave keys).

Re-design of pkg/kvstore/allocator/allocator.go for the
framework: multiple nodes requesting an ID for the same key must
converge on one number, because identity numbers index device tensor
rows — every card in the fleet has to agree on the row basis.

Key scheme (allocator.go:80-106):

    <base>/id/<id>              = key        (master key: id → key)
    <base>/value/<key>/<node>   = id         (slave key, lease-bound)

- The master key is the allocation: as long as it exists the ID is in
  use. Created with CreateOnly (CAS) so two racing nodes cannot claim
  the same ID.
- Slave keys are per-node use counts, protected by the node's lease:
  when a node dies, its slave keys evaporate and the GC can reap master
  keys that no longer have any slave (allocator.go runGC:659).
- Lookup of key→id goes local cache → GetPrefix on the slave prefix
  (allocator.go:100-106), so a node can adopt another node's
  allocation without ever seeing a watch event.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from .backend import (
    BackendOperations,
    EventTypeCreate,
    EventTypeDelete,
    EventTypeListDone,
    EventTypeModify,
    KVEvent,
    Watcher,
)

MAX_ALLOC_ATTEMPTS = 16


class AllocatorError(Exception):
    pass


class Allocator:
    """id↔key allocation over a kvstore backend.

    ``suffix`` identifies this node in slave keys (the reference uses
    the node name / a uuid, allocator.go WithSuffix:308).
    """

    def __init__(
        self,
        backend: BackendOperations,
        base_path: str,
        *,
        suffix: str,
        min_id: int = 1,
        max_id: int = 1 << 16,
        on_event: Optional[Callable[[str, int, Optional[str]], None]] = None,
    ) -> None:
        self.backend = backend
        self.base_path = base_path.rstrip("/")
        self.id_prefix = self.base_path + "/id/"
        self.value_prefix = self.base_path + "/value/"
        self.lock_prefix = self.base_path + "/locks/"
        self.suffix = suffix
        self.min_id = min_id
        self.max_id = max_id
        self._lock = threading.RLock()
        # local refcounts: key -> (id, refcount)  (localkeys.go role)
        self._local: Dict[str, Tuple[int, int]] = {}
        # remote cache fed by the watcher: id -> key (cache.go role)
        self._cache: Dict[int, str] = {}
        self._on_event = on_event
        self._watcher: Watcher = backend.list_and_watch(
            f"allocator-{base_path}", self.id_prefix
        )
        self.pump()  # consume the initial list

    # ------------------------------------------------------------------
    def _master_key(self, id_: int) -> str:
        return f"{self.id_prefix}{id_}"

    def _slave_key(self, key: str) -> str:
        return f"{self.value_prefix}{key}/{self.suffix}"

    def _slave_prefix(self, key: str) -> str:
        return f"{self.value_prefix}{key}/"

    # -- watch-driven cache --------------------------------------------
    def pump(self) -> int:
        """Apply pending watch events to the id→key cache; returns the
        number applied. Called by the controller loop (or tests) — the
        allocator stays correct without pumping because allocation paths
        read through to the store, but the cache is what makes repeated
        lookups and remote-identity resolution cheap."""
        n = 0
        # mutate the cache under the lock (get()/cache_items() readers
        # hold it); fire callbacks only after release — an observer that
        # re-enters the allocator or takes its own lock must not do so
        # under ours. pump() runs on one controller thread, so the
        # deferred events still reach observers in watch order.
        events: List[Tuple[str, int, Optional[str]]] = []
        with self._lock:
            for ev in self._watcher.drain():
                n += 1
                if ev.typ == EventTypeListDone:
                    continue
                try:
                    id_ = int(ev.key[len(self.id_prefix):])
                except ValueError:
                    continue
                if ev.typ in (EventTypeCreate, EventTypeModify):
                    key = (ev.value or b"").decode()
                    self._cache[id_] = key
                    events.append(("upsert", id_, key))
                elif ev.typ == EventTypeDelete:
                    self._cache.pop(id_, None)
                    events.append(("delete", id_, None))
        if self._on_event:
            for typ, id_, key in events:
                self._on_event(typ, id_, key)
        return n

    # -- lookups --------------------------------------------------------
    def get_no_cache(self, key: str) -> int:
        """key → id via the first slave key found (allocator.go:600)."""
        hit = self.backend.get_prefix(self._slave_prefix(key))
        if hit is None:
            return 0
        try:
            return int(hit[1].decode())
        except ValueError:
            return 0

    def get(self, key: str) -> int:
        with self._lock:
            held = self._local.get(key)
            if held is not None:
                return held[0]
            for id_, k in self._cache.items():
                if k == key:
                    return id_
        return self.get_no_cache(key)

    def get_by_id(self, id_: int) -> Optional[str]:
        with self._lock:
            if id_ in self._cache:
                return self._cache[id_]
        raw = self.backend.get(self._master_key(id_))
        return raw.decode() if raw is not None else None

    def cache_items(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._cache)

    # -- allocation -----------------------------------------------------
    def _select_available_id(self) -> int:
        """Smallest unused id in [min, max] judged by the live master
        list (the reference uses a random idpool; smallest-first keeps
        device rows dense, which matters for tensor packing)."""
        used = set(self._cache)
        for k in self.backend.list_prefix(self.id_prefix):
            try:
                used.add(int(k[len(self.id_prefix):]))
            except ValueError:
                pass
        for cand in range(self.min_id, self.max_id + 1):
            if cand not in used:
                return cand
        return 0

    def _local_ref(self, key: str, id_: int) -> int:
        """Record one local use of (key → id) under the lock; returns
        the new refcount. Tolerates a concurrent same-node allocation
        having landed first (refcounts instead of overwriting)."""
        with self._lock:
            held = self._local.get(key)
            if held is not None:
                self._local[key] = (held[0], held[1] + 1)
                return held[1] + 1
            self._local[key] = (id_, 1)
            return 1

    def _create_slave(self, key: str, id_: int) -> bool:
        """Write our slave key *conditioned on the master key existing*
        (the reference's CreateIfExists guard, allocator.go
        createValueNodeKey:398) so adoption can't race GC into reaping
        an id we just started using. False → master is gone, retry."""
        cond = self._master_key(id_)
        slave = self._slave_key(key)
        val = str(id_).encode()
        if self.backend.create_if_exists(cond, slave, val, lease=True):
            return True
        # Slave may already exist (ours, e.g. after resync) — refresh it
        # under our lease as long as the master is still live.
        if self.backend.get(cond) is not None:
            self.backend.update(slave, val, lease=True)
            return True
        return False

    def allocate(self, key: str) -> Tuple[int, bool]:
        """→ (id, is_new). Mirrors allocator.go Allocate/lockedAllocate:
        local refcount fast path, adopt an existing allocation, else
        lock + CAS-create a fresh master key, retrying on races."""
        with self._lock:
            held = self._local.get(key)
            if held is not None:
                self._local[key] = (held[0], held[1] + 1)
                return held[0], False

        last_err: Optional[str] = None
        for _attempt in range(MAX_ALLOC_ATTEMPTS):
            self.pump()
            value = self.get_no_cache(key)
            if value == 0:
                # maybe another node allocated but wrote no slave key yet
                for id_, k in self.cache_items().items():
                    if k == key:
                        value = id_
                        break
            if value != 0:
                # adopt: serialize with GC via the per-key lock, then
                # write our slave key conditioned on the master key
                lock = self.backend.lock_path(self.lock_prefix + key)
                try:
                    if not self._create_slave(key, value):
                        last_err = f"master key {value} reaped during adopt"
                        continue
                finally:
                    lock.unlock()
                self._local_ref(key, value)
                return value, False

            id_ = self._select_available_id()
            if id_ == 0:
                raise AllocatorError("no more available IDs in configured space")
            lock = self.backend.lock_path(self.lock_prefix + key)
            try:
                if self.get_no_cache(key) != 0:
                    last_err = "lost create race (slave key appeared)"
                    continue  # retry loop adopts it
                if not self.backend.create_only(
                    self._master_key(id_), key.encode(), lease=False
                ):
                    last_err = f"master key {id_} taken"
                    continue  # another node claimed this id; retry
                self._create_slave(key, id_)
            finally:
                lock.unlock()
            with self._lock:
                self._cache[id_] = key
            self._local_ref(key, id_)
            if self._on_event:
                self._on_event("upsert", id_, key)
            return id_, True
        raise AllocatorError(f"allocation of '{key}' failed: {last_err}")

    def release(self, key: str) -> bool:
        """Drop one local reference; on the last one, delete our slave
        key (allocator.go Release:634). True when the local node no
        longer uses the key. Master-key reaping is GC's job."""
        with self._lock:
            held = self._local.get(key)
            if held is None:
                return False
            id_, rc = held
            if rc > 1:
                self._local[key] = (id_, rc - 1)
                return False
            del self._local[key]
        self.backend.delete(self._slave_key(key))
        return True

    # -- maintenance ----------------------------------------------------
    def run_gc(self) -> List[int]:
        """Reap master keys with no remaining slave keys
        (allocator.go runGC:659). Returns the ids released."""
        reaped: List[int] = []
        for mk, raw in sorted(self.backend.list_prefix(self.id_prefix).items()):
            key = raw.decode()
            if self.backend.get_prefix(self._slave_prefix(key)) is None:
                lock = self.backend.lock_path(self.lock_prefix + key)
                try:
                    # re-check under lock: a node may have re-adopted
                    if self.backend.get_prefix(self._slave_prefix(key)) is None:
                        self.backend.delete(mk)
                        try:
                            reaped.append(int(mk[len(self.id_prefix):]))
                        except ValueError:
                            pass
                finally:
                    lock.unlock()
        return reaped

    def resync_local_keys(self) -> int:
        """Re-create missing master/slave keys for every locally-held
        allocation (the localKeySyncInterval job + recreateMasterKey,
        allocator.go:58,706): after a lease loss wiped our slave keys,
        this re-establishes them so GC cannot reap identities still in
        use here. Returns the number of keys repaired."""
        fixed = 0
        with self._lock:
            held = dict(self._local)
        for key, (id_, _rc) in held.items():
            if self.backend.get(self._slave_key(key)) is None:
                self.backend.update(self._slave_key(key), str(id_).encode(), lease=True)
                fixed += 1
            if self.backend.get(self._master_key(id_)) is None:
                self.backend.create_only(self._master_key(id_), key.encode())
                fixed += 1
        return fixed

    def close(self) -> None:
        self.backend.stop_watcher(self._watcher)
