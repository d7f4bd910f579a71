"""kvstore backend: the distributed-state fabric of the framework.

Re-designs the reference's kvstore abstraction
(pkg/kvstore/backend.go:92-164 BackendOperations:
Get/GetPrefix/Set/Delete/Update/CreateOnly/CreateIfExists/ListPrefix/
LockPath/ListAndWatch + lease semantics) for the framework's
control plane. Everything device-side stays derived: watch events feed
the IdentityRegistry / IPCache observers, which the PolicyEngine turns
into device row patches — the kvstore itself is pure host state.

Two pieces:

- ``BackendOperations``: the abstract client interface. Any real
  backend (etcd, consul) would implement it; the in-process
  ``InMemoryStore`` + ``InMemoryBackend`` mirror the reference's
  test/dev backend (pkg/kvstore/dummy.go:18) while
  keeping **real** CAS, lease, lock, and watch semantics so multi-node
  convergence is actually exercised.

- Leases: every backend client holds a lease; keys written with
  ``lease=True`` die with it (etcd lease expiry analog). Revoking a
  lease deletes its keys and emits delete events to watchers — that is
  the node-death signal the allocator GC and the shared store rely on.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

EventTypeCreate = "create"
EventTypeModify = "modify"
EventTypeDelete = "delete"
EventTypeListDone = "list-done"


@dataclasses.dataclass(frozen=True)
class KVEvent:
    """One watch event (the KeyValueEvent of pkg/kvstore/events.go)."""

    typ: str
    key: str
    value: Optional[bytes]


class Watcher:
    """Event stream for one prefix (pkg/kvstore/events.go Watcher).

    Events arrive on a thread-safe queue; consumers either block on
    :meth:`next` or drain pending events synchronously with
    :meth:`drain` (the deterministic path used by pump()-style
    consumers in tests and single-threaded controllers).
    """

    def __init__(self, name: str, prefix: str, chan_size: int = 0) -> None:
        # Unbounded queue: _emit runs under the store lock, so it must
        # never block — a slow consumer would otherwise deadlock every
        # other client of the store. (chan_size kept for API parity
        # with the reference; 0 = unbounded.)
        self.name = name
        self.prefix = prefix
        self.events: "queue.Queue[KVEvent]" = queue.Queue(maxsize=0)
        self._stopped = threading.Event()

    def _emit(self, ev: KVEvent) -> None:
        if not self._stopped.is_set():
            self.events.put(ev)

    def next(self, timeout: Optional[float] = None) -> Optional[KVEvent]:
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> List[KVEvent]:
        out: List[KVEvent] = []
        while True:
            try:
                out.append(self.events.get_nowait())
            except queue.Empty:
                return out

    def stop(self) -> None:
        self._stopped.set()

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()


class BackendOperations:
    """Abstract kvstore client surface (backend.go:92-164)."""

    #: retry sleep for the CAS-spin lock; network backends override
    #: (each attempt is a round trip there)
    _lock_retry_s = 0.002
    name = "client"

    def status(self) -> str:
        raise NotImplementedError

    def alive(self) -> bool:
        """False once the backend can no longer reach the store (a
        network client whose connection died). Local backends are
        alive until closed."""
        return True

    def lock_path(self, path: str, timeout: float = 10.0) -> "KVLock":
        """Distributed lock by CAS-creating a lease-bound lock key,
        retried until acquired (etcd-style, pkg/kvstore/lock.go). The
        lease binding means a dead holder's lock auto-releases when
        its session dies. Always makes at least one attempt, even at
        timeout=0."""
        lock_key = path + "/.lock"
        deadline = time.monotonic() + timeout
        while True:
            if self.create_only(lock_key, self.name.encode(), lease=True):
                return KVLock(self, lock_key)
            if time.monotonic() >= deadline:
                raise LockTimeout(f"lock {path} not acquired within {timeout}s")
            time.sleep(self._lock_retry_s)

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_prefix(self, prefix: str) -> Optional[Tuple[str, bytes]]:
        raise NotImplementedError

    def set(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError

    def update(self, key: str, value: bytes, lease: bool = False) -> None:
        raise NotImplementedError

    def create_only(self, key: str, value: bytes, lease: bool = False) -> bool:
        raise NotImplementedError

    def create_if_exists(
        self, cond_key: str, key: str, value: bytes, lease: bool = False
    ) -> bool:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        raise NotImplementedError

    def list_and_watch(self, name: str, prefix: str, chan_size: int = 1024) -> Watcher:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    # base64 key encoding for binary payloads (backend.go Encode/Decode)
    @staticmethod
    def encode(raw: bytes) -> str:
        return base64.urlsafe_b64encode(raw).decode("ascii")

    @staticmethod
    def decode(text: str) -> bytes:
        return base64.urlsafe_b64decode(text.encode("ascii"))


class LockTimeout(Exception):
    pass


class KVLock:
    """A held distributed lock (pkg/kvstore/lock.go). Context-manager;
    unlocking deletes the lock key. The key is lease-bound, so a dead
    owner's lock auto-releases when its lease is revoked."""

    def __init__(self, backend: "InMemoryBackend", lock_key: str) -> None:
        self._backend = backend
        self._key = lock_key

    def unlock(self) -> None:
        self._backend.delete(self._key)

    def __enter__(self) -> "KVLock":
        return self

    def __exit__(self, *exc) -> None:
        self.unlock()


@dataclasses.dataclass
class _Entry:
    value: bytes
    lease_id: Optional[int]
    create_rev: int
    mod_rev: int


class InMemoryStore:
    """The shared "etcd cluster": one instance backs many node clients.

    Provides revisioned keys, leases, and watch fan-out. All mutations
    emit events synchronously into matching watcher queues, so tests
    drive convergence deterministically (drain → apply → assert).
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._data: Dict[str, _Entry] = {}
        self._rev = 0
        # bumps whenever the DURABLE (non-lease) key set or its values
        # change — including deletes, which leave no surviving mod_rev
        # to witness them — so snapshot dirty-checks can't miss a
        # deletion or churn on pure lease traffic
        self._durable_rev = 0
        self._next_lease = 1
        self._leases: Dict[int, set] = {}  # lease id -> set of keys
        self._watchers: List[Tuple[str, Watcher]] = []

    # -- lease management ----------------------------------------------
    def grant_lease(self) -> int:
        with self._lock:
            lid = self._next_lease
            self._next_lease += 1
            self._leases[lid] = set()
            return lid

    def revoke_lease(self, lease_id: int) -> None:
        """Expire a lease: all keys attached to it are deleted (with
        delete events) — the etcd node-death behavior that makes slave
        keys and shared-store entries disappear when an agent dies."""
        with self._lock:
            keys = sorted(self._leases.pop(lease_id, set()))
            for k in keys:
                self._delete_locked(k)

    def lease_alive(self, lease_id: int) -> bool:
        with self._lock:
            return lease_id in self._leases

    # -- internals ------------------------------------------------------
    def _emit(self, ev: KVEvent) -> None:
        for prefix, w in list(self._watchers):
            if ev.key.startswith(prefix) and not w.stopped:
                w._emit(ev)

    def _put_locked(
        self, key: str, value: bytes, lease_id: Optional[int]
    ) -> None:
        was_durable = (
            self._data.get(key) is not None
            and self._data[key].lease_id is None
        )
        # a write racing its own lease's revocation must fail, not
        # resurrect the popped lease entry: nothing would ever revoke
        # that id again, so the key (e.g. a '/.lock') would be orphaned
        # forever (etcd likewise rejects puts on a revoked lease)
        if lease_id is not None and lease_id not in self._leases:
            raise RuntimeError(f"lease {lease_id} revoked")
        self._rev += 1
        old = self._data.get(key)
        if old is not None and old.lease_id is not None and old.lease_id != lease_id:
            self._leases.get(old.lease_id, set()).discard(key)
        if old is None:
            self._data[key] = _Entry(value, lease_id, self._rev, self._rev)
        else:
            old.value = value
            old.lease_id = lease_id
            old.mod_rev = self._rev
        if lease_id is not None:
            self._leases.setdefault(lease_id, set()).add(key)
        if lease_id is None or was_durable:
            # a durable write, or a key leaving the durable set
            # (was_durable is captured BEFORE old.lease_id is
            # overwritten above — the post-mutation value would make
            # durable->leased transitions invisible to snapshots)
            self._durable_rev = self._rev
        self._emit(
            KVEvent(EventTypeCreate if old is None else EventTypeModify, key, value)
        )

    def _delete_locked(self, key: str) -> None:
        entry = self._data.pop(key, None)
        if entry is None:
            return
        self._rev += 1
        if entry.lease_id is None:
            self._durable_rev = self._rev  # durable deletion
        else:
            self._leases.get(entry.lease_id, set()).discard(key)
        self._emit(KVEvent(EventTypeDelete, key, entry.value))

    # -- operations used by backends ------------------------------------
    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            e = self._data.get(key)
            return e.value if e is not None else None

    def get_prefix(self, prefix: str) -> Optional[Tuple[str, bytes]]:
        with self._lock:
            for k in sorted(self._data):
                if k.startswith(prefix):
                    return k, self._data[k].value
            return None

    def put(self, key: str, value: bytes, lease_id: Optional[int]) -> None:
        with self._lock:
            self._put_locked(key, value, lease_id)

    def create_only(self, key: str, value: bytes, lease_id: Optional[int]) -> bool:
        with self._lock:
            if key in self._data:
                return False
            self._put_locked(key, value, lease_id)
            return True

    def create_if_exists(
        self, cond_key: str, key: str, value: bytes, lease_id: Optional[int]
    ) -> bool:
        with self._lock:
            if cond_key not in self._data:
                return False
            if key in self._data:
                return False
            self._put_locked(key, value, lease_id)
            return True

    def delete(self, key: str) -> None:
        with self._lock:
            self._delete_locked(key)

    def delete_prefix(self, prefix: str) -> None:
        with self._lock:
            for k in [k for k in self._data if k.startswith(prefix)]:
                self._delete_locked(k)

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        with self._lock:
            return {
                k: e.value for k, e in self._data.items() if k.startswith(prefix)
            }

    def snapshot_non_lease(self) -> Tuple[int, int, Dict[str, bytes]]:
        """(durable_rev, global_rev, {key: value}) for every key NOT
        bound to a lease — the durable subset a server snapshot
        persists (lease-bound state dies with its sessions by design).
        durable_rev witnesses every durable put AND delete, so pure
        lease churn never dirties a snapshot and a deletion always
        does; global_rev is what a restart restores so client-visible
        revisions stay monotonic."""
        with self._lock:
            return self._durable_rev, self._rev, {
                k: e.value for k, e in self._data.items()
                if e.lease_id is None
            }

    def attach_watcher(self, prefix: str, watcher: Watcher) -> None:
        with self._lock:
            self._watchers.append((prefix, watcher))

    def snapshot_and_attach(self, prefix: str, watcher: Watcher) -> None:
        """List-then-watch without a gap OR a reorder: snapshot, attach,
        AND emit under one hold of the store lock. Mutations take the
        same lock, so no event can land between the listing and the
        live stream — and none can be queued ahead of the snapshot
        (a delete racing the attach must arrive after the stale create
        it supersedes, or the consumer resurrects the key). Emitting
        under the lock is safe: Watcher queues are unbounded, _emit
        never blocks."""
        with self._lock:
            snapshot = sorted(
                (k, e.value) for k, e in self._data.items()
                if k.startswith(prefix)
            )
            for k, v in snapshot:
                watcher._emit(KVEvent(EventTypeCreate, k, v))
            watcher._emit(KVEvent(EventTypeListDone, "", None))
            self._watchers.append((prefix, watcher))

    def detach_watcher(self, watcher: Watcher) -> None:
        with self._lock:
            self._watchers = [(p, w) for p, w in self._watchers if w is not watcher]


class InMemoryBackend(BackendOperations):
    """One node's kvstore client bound to its own lease."""

    def __init__(self, store: InMemoryStore, name: str = "client") -> None:
        self.store = store
        self.name = name
        self.lease_id = store.grant_lease()
        self._watchers: List[Watcher] = []
        self._closed = False

    # ------------------------------------------------------------------
    def status(self) -> str:
        return "in-memory: %d leases live" % len(self.store._leases)

    def alive(self) -> bool:
        return not self._closed

    def _lease(self, lease: bool) -> Optional[int]:
        if not lease:
            return None
        if not self.store.lease_alive(self.lease_id):
            raise RuntimeError(f"lease of client {self.name} has expired")
        return self.lease_id

    def get(self, key: str) -> Optional[bytes]:
        return self.store.get(key)

    def get_prefix(self, prefix: str) -> Optional[Tuple[str, bytes]]:
        return self.store.get_prefix(prefix)

    def set(self, key: str, value: bytes) -> None:
        self.store.put(key, value, None)

    def delete(self, key: str) -> None:
        self.store.delete(key)

    def delete_prefix(self, prefix: str) -> None:
        self.store.delete_prefix(prefix)

    def update(self, key: str, value: bytes, lease: bool = False) -> None:
        self.store.put(key, value, self._lease(lease))

    def create_only(self, key: str, value: bytes, lease: bool = False) -> bool:
        return self.store.create_only(key, value, self._lease(lease))

    def create_if_exists(
        self, cond_key: str, key: str, value: bytes, lease: bool = False
    ) -> bool:
        return self.store.create_if_exists(cond_key, key, value, self._lease(lease))

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        return self.store.list_prefix(prefix)

    def list_and_watch(self, name: str, prefix: str, chan_size: int = 1024) -> Watcher:
        """List current keys (as create events), mark list-done, then
        stream live events (backend.go ListAndWatch)."""
        w = Watcher(name, prefix, chan_size)
        self.store.snapshot_and_attach(prefix, w)
        self._watchers.append(w)
        return w

    def stop_watcher(self, w: Watcher) -> None:
        w.stop()
        self.store.detach_watcher(w)

    def close(self, revoke_lease: bool = True) -> None:
        """Close the client. ``revoke_lease=True`` models clean shutdown
        AND ungraceful death alike: lease-bound keys vanish."""
        if self._closed:
            return
        self._closed = True
        for w in self._watchers:
            self.stop_watcher(w)
        if revoke_lease:
            self.store.revoke_lease(self.lease_id)
