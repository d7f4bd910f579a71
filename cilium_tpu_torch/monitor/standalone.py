"""Standalone node monitor — its own PROCESS.

Reference: cilium-node-monitor (monitor/monitor.go:184) runs apart
from the agent so event streaming survives agent stalls and restarts:
the monitor owns the client socket; the agent is just the event
SOURCE. Same split here:

- the monitor process listens on the ``cilium monitor`` client socket
  (monitor/server.py protocol, unchanged — clients can't tell the
  difference from the in-process server),
- the agent connects to the monitor's FEED socket (the perf-ring
  analog) and streams encoded events through
  :class:`MonitorFeeder`; a dropped feed (agent crash/restart) leaves
  every client stream attached — events simply resume when the agent
  reconnects,
- the agent launches/supervises it like the proxy and health sidecars
  (pkg/launcher).

Run as ``python -m cilium_tpu_torch.monitor --listen <sock> --feed <sock>``.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import List, Optional

from ..utils.logging import get_logger
from .events import encode
from .hub import MonitorHub
from .server import MonitorServer

log = get_logger("monitor-standalone")


class StandaloneMonitor:
    """The monitor process assembly: client server + feed ingestion."""

    def __init__(self, listen_path: str, feed_path: str) -> None:
        self.hub = MonitorHub()
        self.server = MonitorServer(self.hub, listen_path)
        # client-count feedback: every attach/detach is pushed to the
        # connected agents so their datapaths only build events while
        # someone is actually watching (hub.active gate round trip)
        self.server.on_clients = self._broadcast_clients
        self.feed_path = feed_path
        self._stop = threading.Event()
        self.feeds_accepted = 0
        self._feed_conns: List[socket.socket] = []
        self._feed_lock = threading.Lock()
        if os.path.exists(feed_path):
            os.unlink(feed_path)
        self._feed_sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._feed_sock.bind(feed_path)
        self._feed_sock.listen(4)
        self._feed_sock.settimeout(0.2)

    def _broadcast_clients(self, count: int) -> None:
        """Push a demand frame to every feed. Runs under the server's
        client lock (ordering guarantee), so sends must never block: a
        stalled agent — the exact failure this process isolates — must
        not wedge client attach/detach handling. An unwritable or
        partially-written feed is closed; the feeder reconnects and
        receives the then-current count."""
        frame = struct.pack("<I", count)
        with self._feed_lock:
            conns = list(self._feed_conns)
        for c in conns:
            try:
                n = c.send(frame, socket.MSG_DONTWAIT)
            except (BlockingIOError, OSError):
                n = -1
            if n != len(frame):
                # full buffer (dead agent) or torn frame (desync):
                # drop the feed; its pump thread reaps it on read
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def start(self) -> "StandaloneMonitor":
        self.server.start()
        threading.Thread(target=self._feed_accept, daemon=True).start()
        return self

    def _feed_accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._feed_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self.feeds_accepted += 1
            # register + send the initial demand under the SERVER's
            # client lock: a concurrent attach/detach broadcast must
            # order strictly after this frame, or the feeder could end
            # up trusting a stale count forever
            with self.server._clients_lock:
                with self._feed_lock:
                    self._feed_conns.append(conn)
                try:
                    # one 4-byte frame to a just-accepted local socket;
                    # the lock hold is the ordering invariant documented
                    # above, not an accidental I/O convoy
                    conn.sendall(struct.pack("<I", self.server.clients))  # policyd-lint: disable=LOCK002
                except OSError:
                    pass
            threading.Thread(
                target=self._pump_feed, args=(conn,), daemon=True
            ).start()

    def _pump_feed(self, conn: socket.socket) -> None:
        """One agent feed connection: frames in → hub fan-out. The
        frames are already wire-encoded; publish the RAW payloads so
        the per-client path doesn't pay a decode/re-encode round trip
        (monitor/server.py passes bytes through encode())."""
        from ..utils.framing import recv_exact

        try:
            while not self._stop.is_set():
                hdr = recv_exact(conn, 4)
                if hdr is None:
                    return
                (n,) = struct.unpack("<I", hdr)
                if n > (1 << 20):
                    return  # corrupt frame: drop the feed, keep clients
                payload = recv_exact(conn, n)
                if payload is None:
                    return
                self.hub.publish(payload)
        except OSError:
            pass
        finally:
            with self._feed_lock:
                try:
                    self._feed_conns.remove(conn)
                except ValueError:
                    pass
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._feed_sock.close()
        except OSError:
            pass
        self.server.stop()


class MonitorFeeder:
    """Agent side: forwards the in-process hub's events to the external
    monitor's feed socket. Lossy by design (the hub subscription is a
    bounded ring) and self-healing: a dead monitor is retried with
    backoff while the agent keeps running untouched."""

    def __init__(
        self, hub: MonitorHub, feed_path: str,
        retry_s: float = 0.5, max_retry_s: float = 10.0,
    ) -> None:
        self.hub = hub
        self.feed_path = feed_path
        self.retry_s = retry_s
        self.max_retry_s = max_retry_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reconnects = 0
        self._demand_gen = 0  # bumps per feed connection
        # makes the gen-check + passivity flip atomic: a stale demand
        # thread must not overwrite the new connection's state between
        # its check and its set
        self._demand_lock = threading.Lock()

    def start(self) -> "MonitorFeeder":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        backoff = self.retry_s
        sub = self.hub.subscribe()
        # passive until the monitor reports a watching client: the
        # agent's datapath keeps its "nobody's listening" fast path
        # (hub.active False) even though this subscription is permanent
        sub.passive = True
        try:
            while not self._stop.is_set():
                conn = None
                try:
                    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    conn.connect(self.feed_path)
                except OSError:
                    if conn is not None:  # socket() itself may raise
                        conn.close()
                    if self._stop.wait(backoff):
                        return
                    backoff = min(backoff * 2, self.max_retry_s)
                    continue
                backoff = self.retry_s
                self.reconnects += 1
                # generation token: a STALE demand thread from the
                # previous connection must never flip passivity after
                # this connection took over
                with self._demand_lock:
                    self._demand_gen += 1
                    gen = self._demand_gen
                threading.Thread(
                    target=self._read_demand,
                    args=(conn, sub, gen), daemon=True,
                ).start()
                try:
                    while not self._stop.is_set():
                        ev = sub.next(timeout=0.2)
                        if ev is None:
                            continue
                        payload = encode(ev)
                        conn.sendall(
                            struct.pack("<I", len(payload)) + payload
                        )
                    # graceful stop: flush what is still queued — only
                    # a CRASH may lose events, never a clean shutdown
                    for ev in sub.drain():
                        payload = encode(ev)
                        conn.sendall(
                            struct.pack("<I", len(payload)) + payload
                        )
                except OSError:
                    pass  # monitor died/restarted: reconnect loop
                finally:
                    try:
                        conn.close()
                    except OSError:
                        pass
        finally:
            sub.close()

    def _read_demand(self, conn: socket.socket, sub, gen: int) -> None:
        """Consume the monitor's client-count frames on this feed
        connection, flipping the subscription's passivity with demand.
        A dead connection leaves the sub passive (no clients known) —
        unless a NEWER connection's demand thread already took over
        (``gen`` mismatch: this thread must not touch the sub)."""
        from ..utils.framing import recv_exact

        try:
            while not self._stop.is_set():
                frame = recv_exact(conn, 4)
                if frame is None:
                    return
                (count,) = struct.unpack("<I", frame)
                with self._demand_lock:  # atomic gen-check + flip
                    if gen == self._demand_gen:
                        sub.passive = count == 0
        except OSError:
            pass
        finally:
            with self._demand_lock:
                if gen == self._demand_gen:
                    sub.passive = True

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="python -m cilium_tpu_torch.monitor",
        description="standalone node monitor (cilium-node-monitor)",
    )
    ap.add_argument("--listen", required=True,
                    help="client socket (`cilium monitor` connects here)")
    ap.add_argument("--feed", required=True,
                    help="agent feed socket (event source)")
    args = ap.parse_args(argv)
    from ..utils.procutil import die_with_parent

    die_with_parent()
    mon = StandaloneMonitor(args.listen, args.feed).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    print("READY", flush=True)
    stop.wait()
    mon.stop()
    return 0
