"""File-backed kvstore: a cross-process BackendOperations.

The in-memory store (backend.py) covers single-process tests the way
the reference's dummy backend does (pkg/kvstore/dummy.go); this
backend is the standing-in for a real etcd: multiple PROCESSES share
one SQLite database file (WAL mode — SQLite's locking provides the
strong consistency), with revisioned keys, TTL leases kept alive by a
background thread, an append-only event log that watchers poll, and
lease-bound distributed locks. The BackendOperations surface and
event semantics match the in-memory backend, so every layer built on
it (allocator, shared store, node registry, clustermesh) runs
unchanged across processes.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Dict, List, Optional, Tuple

from .backend import (
    BackendOperations,
    EventTypeCreate,
    EventTypeDelete,
    EventTypeListDone,
    EventTypeModify,
    KVEvent,
    Watcher,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS kv (
    key TEXT PRIMARY KEY, value BLOB NOT NULL, lease_id INTEGER
);
CREATE TABLE IF NOT EXISTS leases (
    id INTEGER PRIMARY KEY AUTOINCREMENT, expires REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS events (
    rev INTEGER PRIMARY KEY AUTOINCREMENT,
    typ INTEGER NOT NULL, key TEXT NOT NULL, value BLOB
);
"""


class FileBackend(BackendOperations):
    def __init__(
        self,
        path: str,
        name: str = "client",
        *,
        lease_ttl: float = 15.0,
        poll_interval: float = 0.05,
    ) -> None:
        self.path = path
        self.name = name
        self.lease_ttl = lease_ttl
        self.poll_interval = poll_interval
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(
            path, timeout=10.0, check_same_thread=False
        )
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)
        self._closed = threading.Event()
        with self._tx() as cur:
            cur.execute(
                "INSERT INTO leases (expires) VALUES (?)",
                (time.time() + lease_ttl,),
            )
            self.lease_id = cur.lastrowid
        self._watch_threads: List[threading.Thread] = []
        self._keepalive = threading.Thread(
            target=self._keepalive_loop, daemon=True
        )
        self._keepalive.start()

    # -- transactions ---------------------------------------------------
    def _tx(self):
        """IMMEDIATE transaction with the expired-lease sweep run
        first: any client observing an expired lease deletes its keys
        (with delete events) — the etcd lease-expiry behavior."""
        backend = self

        class _Tx:
            def __enter__(tx):
                backend._lock.acquire()
                try:
                    backend._conn.execute("BEGIN IMMEDIATE")
                    cur = backend._conn.cursor()
                    backend._sweep(cur)
                except BaseException:
                    # a busy-timeout here must NOT leak the RLock — a
                    # held lock with no __exit__ coming wedges every
                    # other thread's kvstore op in this process
                    try:
                        backend._conn.rollback()
                    except sqlite3.Error:
                        pass
                    backend._lock.release()
                    raise
                tx._cur = cur
                return cur

            def __exit__(tx, exc_type, *_):
                try:
                    if exc_type is None:
                        backend._conn.commit()
                    else:
                        backend._conn.rollback()
                finally:
                    backend._lock.release()

        return _Tx()

    def _read(self):
        """Read path: plain autocommit SELECTs (WAL readers never
        block on writers — a BEGIN IMMEDIATE here would serialize all
        readers across processes). Lease expiry is honored by
        filtering in the query, not by sweeping."""
        backend = self

        class _Rd:
            def __enter__(rd):
                backend._lock.acquire()
                return backend._conn.cursor()

            def __exit__(rd, *_):
                backend._lock.release()

        return _Rd()

    # WHERE fragment excluding keys whose lease has expired (sweeps
    # happen on the write path; reads must not see zombie keys)
    _LIVE = (
        "(kv.lease_id IS NULL OR EXISTS ("
        "SELECT 1 FROM leases WHERE leases.id = kv.lease_id "
        "AND leases.expires >= ?))"
    )

    def _sweep(self, cur) -> None:
        now = time.time()
        dead = [r[0] for r in cur.execute(
            "SELECT id FROM leases WHERE expires < ?", (now,)
        )]
        for lid in dead:
            for key, value in list(cur.execute(
                "SELECT key, value FROM kv WHERE lease_id = ?", (lid,)
            )):
                cur.execute("DELETE FROM kv WHERE key = ?", (key,))
                cur.execute(
                    "INSERT INTO events (typ, key, value) VALUES (?, ?, ?)",
                    (EventTypeDelete, key, value),
                )
            cur.execute("DELETE FROM leases WHERE id = ?", (lid,))

    def _keepalive_loop(self) -> None:
        while not self._closed.wait(self.lease_ttl / 3):
            try:
                with self._tx() as cur:
                    cur.execute(
                        "UPDATE leases SET expires = ? WHERE id = ?",
                        (time.time() + self.lease_ttl, self.lease_id),
                    )
            except sqlite3.Error:
                continue  # transient contention: retry next tick

    def _put(self, cur, key: str, value: bytes, lease: bool) -> None:
        row = cur.execute(
            "SELECT key FROM kv WHERE key = ?", (key,)
        ).fetchone()
        lid = self.lease_id if lease else None
        cur.execute(
            "INSERT INTO kv (key, value, lease_id) VALUES (?, ?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value=excluded.value, "
            "lease_id=excluded.lease_id",
            (key, value, lid),
        )
        cur.execute(
            "INSERT INTO events (typ, key, value) VALUES (?, ?, ?)",
            (EventTypeModify if row else EventTypeCreate, key, value),
        )

    # -- BackendOperations ----------------------------------------------
    def alive(self) -> bool:
        return not self._closed.is_set()

    def status(self) -> str:
        with self._read() as cur:
            n = cur.execute(
                f"SELECT COUNT(*) FROM kv WHERE {self._LIVE}",
                (time.time(),),
            ).fetchone()[0]
        return f"file:{self.path}: {n} keys"

    def get(self, key: str) -> Optional[bytes]:
        with self._read() as cur:
            row = cur.execute(
                f"SELECT value FROM kv WHERE key = ? AND {self._LIVE}",
                (key, time.time()),
            ).fetchone()
            return row[0] if row else None

    def get_prefix(self, prefix: str) -> Optional[Tuple[str, bytes]]:
        with self._read() as cur:
            row = cur.execute(
                f"SELECT key, value FROM kv WHERE key >= ? AND key < ? "
                f"AND {self._LIVE} ORDER BY key LIMIT 1",
                (prefix, prefix + "\uffff", time.time()),
            ).fetchone()
            return (row[0], row[1]) if row else None

    def set(self, key: str, value: bytes) -> None:
        with self._tx() as cur:
            self._put(cur, key, value, lease=False)

    def update(self, key: str, value: bytes, lease: bool = False) -> None:
        with self._tx() as cur:
            self._put(cur, key, value, lease)

    def create_only(self, key: str, value: bytes, lease: bool = False) -> bool:
        with self._tx() as cur:
            if cur.execute(
                "SELECT 1 FROM kv WHERE key = ?", (key,)
            ).fetchone():
                return False
            self._put(cur, key, value, lease)
            return True

    def create_if_exists(
        self, cond_key: str, key: str, value: bytes, lease: bool = False
    ) -> bool:
        with self._tx() as cur:
            if not cur.execute(
                "SELECT 1 FROM kv WHERE key = ?", (cond_key,)
            ).fetchone():
                return False
            if cur.execute(
                "SELECT 1 FROM kv WHERE key = ?", (key,)
            ).fetchone():
                return False
            self._put(cur, key, value, lease)
            return True

    def delete(self, key: str) -> None:
        with self._tx() as cur:
            row = cur.execute(
                "SELECT value FROM kv WHERE key = ?", (key,)
            ).fetchone()
            if row:
                cur.execute("DELETE FROM kv WHERE key = ?", (key,))
                cur.execute(
                    "INSERT INTO events (typ, key, value) VALUES (?, ?, ?)",
                    (EventTypeDelete, key, row[0]),
                )

    def delete_prefix(self, prefix: str) -> None:
        with self._tx() as cur:
            rows = list(cur.execute(
                "SELECT key, value FROM kv WHERE key >= ? AND key < ?",
                (prefix, prefix + "\uffff"),
            ))
            for key, value in rows:
                cur.execute("DELETE FROM kv WHERE key = ?", (key,))
                cur.execute(
                    "INSERT INTO events (typ, key, value) VALUES (?, ?, ?)",
                    (EventTypeDelete, key, value),
                )

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        with self._read() as cur:
            return {
                k: v for k, v in cur.execute(
                    f"SELECT key, value FROM kv WHERE key >= ? AND key < ? "
                    f"AND {self._LIVE}",
                    (prefix, prefix + "\uffff", time.time()),
                )
            }

    # lock_path: inherited CAS-spin (backend.py); SQLite round trips
    # make tight spinning counterproductive
    _lock_retry_s = 0.02

    # -- watch ----------------------------------------------------------
    def list_and_watch(
        self, name: str, prefix: str, chan_size: int = 1024
    ) -> Watcher:
        """Initial snapshot + ListDone, then a poll thread follows the
        event log. The cursor is captured BEFORE the snapshot, so an
        event racing the snapshot is delivered (possibly twice — the
        consumers' upsert semantics absorb duplicates) rather than
        lost."""
        w = Watcher(name, prefix, chan_size)
        with self._read() as cur:
            start_rev = cur.execute(
                "SELECT COALESCE(MAX(rev), 0) FROM events"
            ).fetchone()[0]
            snapshot = list(cur.execute(
                f"SELECT key, value FROM kv WHERE key >= ? AND key < ? "
                f"AND {self._LIVE} ORDER BY key",
                (prefix, prefix + "\uffff", time.time()),
            ))
        for key, value in snapshot:
            w._emit(KVEvent(EventTypeCreate, key, value))
        w._emit(KVEvent(EventTypeListDone, prefix, None))

        def poll():
            # a dedicated connection: sqlite connections are not safe
            # for cross-thread interleaving
            conn = sqlite3.connect(self.path, timeout=10.0)
            last = start_rev
            try:
                while not self._closed.is_set() and not w.stopped:
                    try:
                        rows = list(conn.execute(
                            "SELECT rev, typ, key, value FROM events "
                            "WHERE rev > ? ORDER BY rev", (last,)
                        ))
                    except sqlite3.Error:
                        # transient contention (SQLITE_BUSY under
                        # cross-process write load) must NOT kill the
                        # poller — a dead watcher starves every layer
                        # above it silently
                        time.sleep(self.poll_interval)
                        continue
                    for rev, typ, key, value in rows:
                        last = rev
                        if key.startswith(prefix):
                            w._emit(KVEvent(typ, key, value))
                    if not rows:
                        time.sleep(self.poll_interval)
            finally:
                conn.close()

        t = threading.Thread(target=poll, daemon=True)
        t.start()
        self._watch_threads.append(t)
        return w

    def stop_watcher(self, w: Watcher) -> None:
        w.stop()

    def close(self) -> None:
        self._closed.set()
        try:
            with self._tx() as cur:
                # revoke our lease now (keys die with it via the sweep)
                cur.execute(
                    "UPDATE leases SET expires = 0 WHERE id = ?",
                    (self.lease_id,),
                )
                self._sweep(cur)
        except sqlite3.Error:
            pass
        for t in self._watch_threads:
            t.join(timeout=1.0)
        self._conn.close()


class FlakyBackend:
    """Failure-injection wrapper (the kvstore-outage chaos affordance,
    test/runtime/kvstore.go): while failing, every operation raises;
    recovery restores the inner backend untouched."""

    def __init__(self, inner: BackendOperations) -> None:
        self.inner = inner
        self.failing = False
        self.op_errors = 0

    def fail(self, on: bool = True) -> None:
        self.failing = on

    def _guard(self):
        if self.failing:
            self.op_errors += 1
            raise ConnectionError("kvstore unavailable (injected)")

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if callable(attr) and not name.startswith("_"):
            def wrapped(*a, **kw):
                self._guard()
                return attr(*a, **kw)
            return wrapped
        return attr
