"""Networked kvstore: the etcd-role TCP fabric for multi-host clusters.

The file/SQLite backend (filestore.py) covers multi-process on ONE
host; this module covers the reference's actual deployment shape — a
kvstore SERVER processes on any host connect to over the network
(pkg/kvstore/etcd.go: client sessions, leases with
keepalive, watch streams; version-gated connect) — so identity
allocation, node registry, ipcache sync, and clustermesh all run
across machines.

Two halves:

- :class:`KVStoreServer` — hosts one :class:`InMemoryStore` behind a
  TCP listener. Each connection is one client session: it gets a TTL
  lease (kept alive by client pings, revoked on disconnect or TTL
  expiry — the node-death signal), serialized request/response ops,
  and server-push watch streams (snapshot → list-done → live events,
  attached under the store lock so no event can fall in the gap).

- :class:`NetBackend` — a :class:`BackendOperations` client. One
  socket; a reader thread demuxes responses (by request id) to
  blocking callers and watch events (by watch id) into
  :class:`Watcher` queues; a keepalive thread renews the lease.

Wire protocol: 4-byte little-endian length + one JSON object
(utils/framing.py — the repo-wide socket convention). Binary
values ride base64. Requests carry ``id``; responses echo it; watch
events carry ``watch`` instead. The first frame from the server is the
hello: ``{"lease": <id>, "ttl": <seconds>, "rev": <revision>}``.

No transparent reconnect by design: a lost connection kills the lease
and with it every lease-bound key this client owned — exactly the
state the layers above must re-create through their own resync paths
(allocator re-CAS, shared-store re-sync, node re-announce), matching
the reference's session-loss semantics.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import threading
import time
from typing import Dict, Optional, Tuple

from ..utils.framing import recv_json as _recv_frame
from ..utils.framing import send_json
from ..utils.logging import get_logger
from .backend import (
    BackendOperations,
    EventTypeListDone,
    InMemoryStore,
    KVEvent,
    Watcher,
)

log = get_logger("kvstore-net")


def parse_hostport(text: str) -> Tuple[str, int]:
    """``host:port`` / ``[v6literal]:port`` → (host, port).

    An empty host (``:4240``) is allowed — callers supply their own
    default. Raises ValueError on anything else — including a bare v6
    literal like ``::1:4240``, which is ambiguous without brackets
    (RFC 3986 requires them for exactly this reason)."""
    if text.startswith("["):
        host, sep, port = text.rpartition("]:")
        if not sep or len(host) < 2 or not port.isdigit():
            raise ValueError(f"{text!r} must be [host]:port")
        host = host[1:]
    else:
        host, sep, port = text.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"{text!r} must be host:port")
        if ":" in host:
            raise ValueError(
                f"{text!r}: IPv6 literals need brackets — [{host}]:{port}"
            )
    if int(port) > 65535:
        raise ValueError(f"{text!r}: port must be 0-65535")
    return host, int(port)


def _send_frame(sock: socket.socket, wlock: threading.Lock, obj: dict) -> None:
    send_json(sock, obj, wlock)


def _b64(v: Optional[bytes]) -> Optional[str]:
    return None if v is None else base64.b64encode(v).decode("ascii")


def _unb64(v: Optional[str]) -> Optional[bytes]:
    return None if v is None else base64.b64decode(v)


# ---------------------------------------------------------------------------
# server


class _ClientSession:
    """One connected client: its lease, socket, and watch pumps."""

    def __init__(self, server: "KVStoreServer", sock: socket.socket, peer) -> None:
        self.server = server
        self.sock = sock
        self.peer = peer
        self.wlock = threading.Lock()
        self.lease_id = server.store.grant_lease()
        self.deadline = time.monotonic() + server.lease_ttl
        self.watches: Dict[int, Watcher] = {}
        self.closed = threading.Event()

    def close(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        for w in list(self.watches.values()):
            w.stop()
            self.server.store.detach_watcher(w)
        self.watches.clear()
        # lease revocation IS the death signal: every key this client
        # wrote with lease=True vanishes, with delete events fanning
        # out to every other session's watchers
        self.server.store.revoke_lease(self.lease_id)
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._drop(self)


class KVStoreServer:
    """TCP kvstore server — run one per cluster (or per failure
    domain), like the reference's etcd endpoint."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        lease_ttl: float = 15.0,
        state_path: Optional[str] = None,
        snapshot_interval: float = 5.0,
    ) -> None:
        self.store = InMemoryStore()
        self.lease_ttl = lease_ttl
        # durability (the etcd WAL role, snapshot-grained): non-lease
        # keys persist across server restarts via a periodically (and
        # on stop) rewritten JSON snapshot. Lease-bound keys are
        # DELIBERATELY excluded — their owners' sessions died with the
        # old server, so restoring them would resurrect state whose
        # death signal (the lease) already fired; owners re-create
        # them through their normal resync paths on reconnect.
        self.state_path = state_path
        self.snapshot_interval = snapshot_interval
        self._dirty_rev = -1
        self._snap_lock = threading.Lock()  # serializes writers
        if state_path:
            self._load_snapshot()
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        self._listener = socket.socket(family, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self._sessions: Dict[int, _ClientSession] = {}
        self._slock = threading.Lock()
        self._threads: list = []

    @property
    def url(self) -> str:
        if ":" in self.host:  # v6 literal needs brackets
            return f"tcp://[{self.host}]:{self.port}"
        return f"tcp://{self.host}:{self.port}"

    def start(self) -> "KVStoreServer":
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        s = threading.Thread(target=self._sweep_loop, daemon=True)
        s.start()
        self._threads += [t, s]
        if self.state_path:
            p = threading.Thread(target=self._snapshot_loop, daemon=True)
            p.start()
            self._threads.append(p)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._slock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            sess.close()
        if self.state_path:
            try:
                self._write_snapshot()
            except OSError as e:
                # a failing disk must not turn shutdown into a crash
                log.warning("final kvstore snapshot failed",
                            fields={"err": str(e)})

    # -- durability -----------------------------------------------------
    def _load_snapshot(self) -> None:
        try:
            with open(self.state_path, "rb") as f:
                data = json.loads(f.read())
            kv = data["kv"] if isinstance(data, dict) else None
            if not isinstance(kv, dict):
                raise ValueError("snapshot is not a {rev, kv} object")
            decoded = {
                key: base64.b64decode(v64) for key, v64 in kv.items()
            }
        except FileNotFoundError:
            return
        except Exception as e:  # half-damaged disks produce ANY shape
            log.warning("kvstore snapshot unreadable; starting empty",
                        fields={"path": self.state_path, "err": str(e)})
            return
        for key, value in decoded.items():
            self.store.put(key, value, None)
        # keep revisions monotonic across restarts (etcd-like): the
        # hello advertises the GLOBAL rev persisted at snapshot time,
        # and a reconnecting client must not see it move backwards
        try:
            self.store._rev = max(self.store._rev, int(data.get("rev", 0)))
        except (TypeError, ValueError):
            pass
        # the restore itself is not "dirt": skip the first periodic
        # write unless something actually changes. Bare write is safe:
        # _load_snapshot runs during start(), before the accept/sweep/
        # snapshot threads exist — nothing else can hold _snap_lock yet
        self._dirty_rev = self.store._durable_rev  # policyd-lint: disable=LOCK004
        log.info("kvstore snapshot restored", fields={
            "path": self.state_path, "keys": len(decoded),
        })

    def _write_snapshot(self) -> None:
        # _snap_lock exists solely to serialize stop() against the
        # periodic snapshot loop over one tmp file; the fsync+rename
        # under it is the lock's entire purpose and no request path
        # takes it — every blocking call below is the design
        with self._snap_lock:  # stop() vs periodic loop share one tmp
            durable_rev, global_rev, data = self.store.snapshot_non_lease()
            if durable_rev == self._dirty_rev:
                return  # no durable put OR delete since the last write
            kv = {
                k: base64.b64encode(v).decode("ascii")
                for k, v in data.items()
            }
            tmp = f"{self.state_path}.tmp"
            with open(tmp, "w") as f:  # policyd-lint: disable=LOCK002
                f.write(json.dumps({"rev": global_rev, "kv": kv}))
                f.flush()
                os.fsync(f.fileno())  # rename must not outlive the data  # policyd-lint: disable=LOCK002
            os.replace(tmp, self.state_path)  # atomic: never torn  # policyd-lint: disable=LOCK002
            try:  # make the rename itself durable
                dfd = os.open(os.path.dirname(self.state_path) or ".",  # policyd-lint: disable=LOCK002
                              os.O_RDONLY)
                try:
                    os.fsync(dfd)  # policyd-lint: disable=LOCK002
                finally:
                    os.close(dfd)
            except OSError:
                pass
            self._dirty_rev = durable_rev

    def _snapshot_loop(self) -> None:
        while not self._stop.wait(self.snapshot_interval):
            try:
                self._write_snapshot()
            except OSError as e:
                log.warning("kvstore snapshot write failed",
                            fields={"err": str(e)})

    # -- internals ------------------------------------------------------
    def _drop(self, sess: _ClientSession) -> None:
        with self._slock:
            self._sessions.pop(id(sess), None)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, peer = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sess = _ClientSession(self, sock, peer)
            with self._slock:
                self._sessions[id(sess)] = sess
            threading.Thread(
                target=self._serve, args=(sess,), daemon=True
            ).start()

    def _sweep_loop(self) -> None:
        """Revoke leases whose keepalive went silent — the TTL expiry
        an etcd lease has even while the TCP connection lingers
        half-open."""
        while not self._stop.wait(min(self.lease_ttl / 3.0, 1.0)):
            now = time.monotonic()
            with self._slock:
                stale = [
                    s for s in self._sessions.values() if s.deadline < now
                ]
            for sess in stale:
                log.info("lease expired; closing session", fields={
                    "peer": str(sess.peer), "lease": sess.lease_id,
                })
                sess.close()

    def _serve(self, sess: _ClientSession) -> None:
        try:
            _send_frame(sess.sock, sess.wlock, {
                "lease": sess.lease_id,
                "ttl": self.lease_ttl,
                "rev": self.store._rev,
            })
            while not self._stop.is_set():
                req = _recv_frame(sess.sock)
                if req is None:
                    return
                try:
                    resp = self._dispatch(sess, req)
                except Exception as e:  # op error → error response
                    resp = {"err": f"{type(e).__name__}: {e}"}
                resp["id"] = req.get("id")
                _send_frame(sess.sock, sess.wlock, resp)
        except OSError:
            pass
        finally:
            sess.close()

    def _dispatch(self, sess: _ClientSession, req: dict) -> dict:
        op = req.get("op")
        st = self.store
        key = req.get("key", "")
        val = _unb64(req.get("value"))
        lease = sess.lease_id if req.get("lease") else None
        if op == "keepalive":
            sess.deadline = time.monotonic() + self.lease_ttl
            return {"ok": True}
        if op == "get":
            return {"value": _b64(st.get(key))}
        if op == "get_prefix":
            kv = st.get_prefix(key)
            if kv is None:
                return {"kv": None}
            return {"kv": [kv[0], _b64(kv[1])]}
        if op == "set":
            st.put(key, val or b"", None)
            return {"ok": True}
        if op == "update":
            st.put(key, val or b"", lease)
            return {"ok": True}
        if op == "create_only":
            return {"ok": st.create_only(key, val or b"", lease)}
        if op == "create_if_exists":
            return {"ok": st.create_if_exists(
                req["cond"], key, val or b"", lease
            )}
        if op == "delete":
            st.delete(key)
            return {"ok": True}
        if op == "delete_prefix":
            st.delete_prefix(key)
            return {"ok": True}
        if op == "list_prefix":
            return {"kvs": {
                k: _b64(v) for k, v in st.list_prefix(key).items()
            }}
        if op == "watch":
            return self._start_watch(sess, int(req["wid"]), key)
        if op == "unwatch":
            w = sess.watches.pop(int(req["wid"]), None)
            if w is not None:
                w.stop()
                st.detach_watcher(w)
            return {"ok": True}
        if op == "status":
            with self._slock:
                n = len(self._sessions)
            return {"status": f"net: {n} sessions, rev {st._rev}"}
        raise ValueError(f"unknown op {op!r}")

    def _start_watch(self, sess: _ClientSession, wid: int, prefix: str) -> dict:
        w = Watcher(f"net-{wid}", prefix)
        self.store.snapshot_and_attach(prefix, w)
        sess.watches[wid] = w
        if sess.closed.is_set():
            # raced the session teardown: close() may have swept
            # sess.watches before our insert — detach here so the
            # store never scans a dead watcher (and its unbounded
            # queue never accumulates) for the server's lifetime
            sess.watches.pop(wid, None)
            w.stop()
            self.store.detach_watcher(w)
            raise ConnectionError("session closed")

        def pump() -> None:
            while not (w.stopped or sess.closed.is_set()):
                ev = w.next(timeout=0.5)
                if ev is None:
                    continue
                try:
                    _send_frame(sess.sock, sess.wlock, {
                        "watch": wid, "typ": ev.typ,
                        "key": ev.key, "value": _b64(ev.value),
                    })
                except OSError:
                    sess.close()
                    return

        threading.Thread(target=pump, daemon=True).start()
        return {"ok": True}


# ---------------------------------------------------------------------------
# client


class NetBackend(BackendOperations):
    """kvstore client over TCP (the etcd client session analog)."""

    def __init__(
        self,
        target: str,
        name: str = "client",
        *,
        op_timeout: float = 30.0,
    ) -> None:
        if target.startswith("tcp://"):
            target = target[len("tcp://"):]
        try:
            host, port = parse_hostport(target)
            if not host:
                raise ValueError(f"{target!r}: host is required")
        except ValueError as e:
            raise ValueError(f"kvstore target: {e}") from None
        self.name = name
        self.op_timeout = op_timeout
        self._sock = socket.create_connection((host, port), timeout=10.0)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._pending: Dict[int, Tuple[threading.Event, list]] = {}
        self._plock = threading.Lock()
        self._next_id = 1
        self._watchers: Dict[int, Watcher] = {}
        self._closed = threading.Event()
        try:
            # the connect timeout still arms the socket here, so a peer
            # that accepts but never speaks (firewall blackhole, wrong
            # service) fails the probe instead of hanging forever
            hello = _recv_frame(self._sock)
            if hello is None or "lease" not in hello:
                raise ConnectionError(
                    "kvstore server hello missing (timeout or wrong service)"
                )
            self.lease_id = int(hello["lease"])
            self.lease_ttl = float(hello.get("ttl", 15.0))
        except Exception:
            # a peer speaking some other protocol must not leak the fd
            # (a supervisor retry loop would bleed one per attempt)
            self._sock.close()
            raise
        self._sock.settimeout(None)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        self._ka = threading.Thread(target=self._keepalive_loop, daemon=True)
        self._ka.start()

    # -- plumbing -------------------------------------------------------
    def _read_loop(self) -> None:
        while not self._closed.is_set():
            try:
                frame = _recv_frame(self._sock)
            except (OSError, ValueError):
                frame = None
            if frame is None:
                break
            if "watch" in frame:
                w = self._watchers.get(int(frame["watch"]))
                if w is not None:
                    w._emit(KVEvent(
                        frame["typ"], frame["key"], _unb64(frame.get("value"))
                    ))
                    if frame["typ"] == EventTypeListDone:
                        w._net_list_done.set()
                continue
            rid = frame.get("id")
            with self._plock:
                slot = self._pending.pop(rid, None)
            if slot is not None:
                slot[1].append(frame)
                slot[0].set()
        # connection died: unblock every caller, stop watchers, and
        # release the fd (a later explicit close() early-returns, so
        # this is the socket's last owner)
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._plock:
            pending = list(self._pending.values())
            self._pending.clear()
        for ev, out in pending:
            out.append({"err": "connection closed"})
            ev.set()
        for w in list(self._watchers.values()):
            w.stop()
            done = getattr(w, "_net_list_done", None)
            if done is not None:
                w._net_dead = True
                done.set()  # unblock a list_and_watch waiting on the snapshot

    def _keepalive_loop(self) -> None:
        interval = max(self.lease_ttl / 3.0, 0.05)
        while not self._closed.wait(interval):
            try:
                self._call({"op": "keepalive"})
            except (ConnectionError, OSError):
                return

    def _call(self, req: dict, *, nowait: bool = False) -> dict:
        if self._closed.is_set():
            raise ConnectionError("kvstore connection closed")
        ev = threading.Event()
        out: list = []
        with self._plock:
            rid = self._next_id
            self._next_id += 1
            if not nowait:
                self._pending[rid] = (ev, out)
        req["id"] = rid
        try:
            _send_frame(self._sock, self._wlock, req)
        except OSError as e:
            with self._plock:
                self._pending.pop(rid, None)
            raise ConnectionError(f"kvstore send failed: {e}") from None
        if nowait:  # fire-and-forget: the reader drops the stray reply
            return {}
        if not ev.wait(self.op_timeout):
            with self._plock:
                self._pending.pop(rid, None)
            raise TimeoutError(f"kvstore op {req.get('op')} timed out")
        resp = out[0]
        err = resp.get("err")
        if err == "connection closed":
            raise ConnectionError("kvstore connection closed")
        if err:
            raise RuntimeError(err)
        return resp

    # -- BackendOperations ---------------------------------------------
    def alive(self) -> bool:
        return not self._closed.is_set()

    def status(self) -> str:
        try:
            return self._call({"op": "status"})["status"]
        except (ConnectionError, TimeoutError) as e:
            return f"net: unreachable ({e})"

    def get(self, key: str) -> Optional[bytes]:
        return _unb64(self._call({"op": "get", "key": key}).get("value"))

    def get_prefix(self, prefix: str) -> Optional[Tuple[str, bytes]]:
        kv = self._call({"op": "get_prefix", "key": prefix}).get("kv")
        if kv is None:
            return None
        return kv[0], _unb64(kv[1])

    def set(self, key: str, value: bytes) -> None:
        self._call({"op": "set", "key": key, "value": _b64(value)})

    def delete(self, key: str) -> None:
        self._call({"op": "delete", "key": key})

    def delete_prefix(self, prefix: str) -> None:
        self._call({"op": "delete_prefix", "key": prefix})

    def update(self, key: str, value: bytes, lease: bool = False) -> None:
        self._call({
            "op": "update", "key": key, "value": _b64(value), "lease": lease,
        })

    def create_only(self, key: str, value: bytes, lease: bool = False) -> bool:
        return bool(self._call({
            "op": "create_only", "key": key,
            "value": _b64(value), "lease": lease,
        })["ok"])

    def create_if_exists(
        self, cond_key: str, key: str, value: bytes, lease: bool = False
    ) -> bool:
        return bool(self._call({
            "op": "create_if_exists", "cond": cond_key, "key": key,
            "value": _b64(value), "lease": lease,
        })["ok"])

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        kvs = self._call({"op": "list_prefix", "key": prefix})["kvs"]
        return {k: _unb64(v) for k, v in kvs.items()}

    # lock_path: inherited CAS-spin (backend.py); every attempt is a
    # network round trip, so back off harder between them
    _lock_retry_s = 0.01

    def list_and_watch(self, name: str, prefix: str, chan_size: int = 1024) -> Watcher:
        w = Watcher(name, prefix, chan_size)
        with self._plock:
            wid = self._next_id
            self._next_id += 1
        # register BEFORE the request: the server streams snapshot
        # events immediately after acking and the reader thread must
        # already know where to put them
        self._watchers[wid] = w
        w._net_wid = wid  # for stop_watcher
        w._net_list_done = threading.Event()
        try:
            self._call({"op": "watch", "wid": wid, "key": prefix})
            # every other backend returns with the initial snapshot
            # already IN the watcher queue (callers do `list_and_watch`
            # then immediately pump it); hold that contract over the
            # network by blocking until the list-done frame lands
            if not w._net_list_done.wait(self.op_timeout):
                raise TimeoutError(f"watch {prefix!r}: initial list timed out")
            if getattr(w, "_net_dead", False):
                raise ConnectionError("kvstore connection closed")
        except Exception:
            self._watchers.pop(wid, None)
            w.stop()
            try:  # the server still has the watch attached; detach it so
                # its pump thread stops streaming frames nobody reads.
                # Fire-and-forget (no reply wait): this path only runs
                # when the server is already misbehaving, and a blocking
                # _call here would double the caller's failure latency
                self._call({"op": "unwatch", "wid": wid}, nowait=True)
            except (ConnectionError, TimeoutError, RuntimeError, OSError):
                pass
            raise
        return w

    def stop_watcher(self, w: Watcher) -> None:
        w.stop()
        wid = getattr(w, "_net_wid", None)
        if wid is not None:
            self._watchers.pop(wid, None)
            try:
                self._call({"op": "unwatch", "wid": wid})
            except (ConnectionError, TimeoutError, RuntimeError):
                pass

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        for w in list(self._watchers.values()):
            w.stop()
        self._watchers.clear()
        try:
            self._sock.close()
        except OSError:
            pass


def backend_from_target(target: str, name: str) -> BackendOperations:
    """``tcp://host:port[,tcp://host2:port2,...]`` → :class:`NetBackend`
    connected to the first reachable endpoint (the etcd client's
    endpoint-list failover); anything else is a path for the SQLite
    :class:`FileBackend` (single-host fabric)."""
    if target.startswith("tcp://"):
        endpoints = [e.strip() for e in target.split(",")]
        for ep in endpoints:  # malformed syntax fails FAST (ValueError),
            t = ep[len("tcp://"):] if ep.startswith("tcp://") else ep
            try:  # not as "unreachable"
                h, _ = parse_hostport(t)
                if not h:
                    raise ValueError(f"{t!r}: host is required")
            except ValueError as e:
                raise ValueError(f"kvstore endpoint: {e}") from None
        last: Optional[Exception] = None
        for ep in endpoints:
            try:
                return NetBackend(ep, name)
            except (OSError, ConnectionError) as e:
                last = e
        raise ConnectionError(
            f"no kvstore endpoint reachable in {target!r}: {last}"
        )
    from .filestore import FileBackend

    return FileBackend(target, name)
