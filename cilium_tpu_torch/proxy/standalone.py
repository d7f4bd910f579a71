"""Out-of-process L7 proxy: NPDS/NPHDS subscriber + wire enforcement.

The role of the external cilium-envoy process (pkg/envoy/envoy.go:76-143
bootstrap/lifecycle): a SEPARATE process that

- subscribes NPDS (per-endpoint L7 policy) and NPHDS (identity → host
  addresses) from the agent's xDS socket (xds/client.py — the
  subscription side of envoy/cilium_network_policy.cc and
  envoy/cilium_host_map.cc),
- listens on every redirect's proxy port, codec-sniffs each TCP
  connection (HTTP/1.1 incl. chunked bodies, HTTP/2 + gRPC via
  proxy/http2.py, or Kafka frames), resolves the peer's identity from
  the NPHDS map (the cilium_host_map.cc role; the reference's
  bpf_metadata recovers it from the proxymap), and enforces the
  per-port rules: 403 / grpc-status PERMISSION_DENIED / Kafka reject
  on deny, forward to the upstream (or synthesize a 200 when
  terminating) on allow (envoy/cilium_l7policy.cc
  AccessFilter::decodeHeaders — codec-independent like Envoy's),
- streams one access-log record per request back to the agent over the
  accesslog unix socket (envoy/accesslog.cc → accesslog_server.go:50).

Run as ``python -m cilium_tpu_torch.proxy --xds <sock> --accesslog <sock>``;
the agent supervises it with proxy/launcher.py (pkg/launcher restart
semantics).
"""

from __future__ import annotations

import ipaddress
import json
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..l7.http_policy import HTTPPolicy, HTTPRequest
from ..l7.kafka_policy import KafkaACL, KafkaRequest
from ..utils.logging import get_logger
from .http2 import PREFACE as H2_PREFACE
from ..xds.cache import NETWORK_POLICY_HOSTS_TYPE, NETWORK_POLICY_TYPE
from ..xds.client import XDSClient
from ..xds.server import _send_msg

log = get_logger("proxy-standalone")

ID_WORLD = 2


class NPHDSMap:
    """identity ← longest-prefix-match over the NPHDS host addresses
    (the in-proxy mirror of envoy/cilium_host_map.cc)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # prefixlen-descending list of (network, identity)
        self._nets: List[Tuple[ipaddress._BaseNetwork, int]] = []

    def replace(self, resources: Dict[str, dict]) -> None:
        nets = []
        for _name, res in resources.items():
            ident = int(res.get("policy", 0))
            for prefix in res.get("host_addresses", ()):
                try:
                    nets.append((ipaddress.ip_network(prefix, strict=False), ident))
                except ValueError:
                    continue
        nets.sort(key=lambda t: t[0].prefixlen, reverse=True)
        with self._lock:
            self._nets = nets

    def identity_of(self, addr: str) -> int:
        try:
            ip = ipaddress.ip_address(addr)
        except ValueError:
            return ID_WORLD
        with self._lock:
            for net, ident in self._nets:
                if ip.version == net.version and ip in net:
                    return ident
        return ID_WORLD


class _PortPolicy:
    """Enforcement state for one redirect (one proxy port)."""

    def __init__(self, entry: dict, device=None) -> None:
        self.endpoint_id = int(entry.get("endpoint_id", 0))
        self.port = int(entry["port"])
        self.ingress = bool(entry.get("ingress", True))
        self.parser = entry.get("parser", "http")
        self.proxy_port = int(entry["proxy_port"])
        self.http: Optional[HTTPPolicy] = (
            HTTPPolicy.from_model(entry["http_rules"], device=device)
            if "http_rules" in entry
            else None
        )
        self.kafka: Optional[KafkaACL] = (
            KafkaACL.from_model(entry["kafka_rules"], device=device)
            if "kafka_rules" in entry
            else None
        )


from ..utils.framing import recv_exact as _recv_exact  # shared framing


def _read_http_head(
    conn: socket.socket, carry: bytes = b"", limit: int = 65536
) -> Optional[bytes]:
    """Read up to and past one request head. ``carry`` holds bytes a
    previous request on this keep-alive connection already pulled off
    the socket (pipelined requests / over-read body tails)."""
    buf = carry
    while b"\r\n\r\n" not in buf:
        if len(buf) > limit:
            return None
        chunk = conn.recv(4096)
        if not chunk:
            return None
        buf += chunk
    return buf


class StandaloneProxy:
    """One process-wide proxy: listeners keyed by proxy port, policies
    swapped atomically on every NPDS push."""

    def __init__(
        self,
        xds_socket: str,
        accesslog_socket: Optional[str] = None,
        node: str = "external-proxy",
        listen_host: str = "127.0.0.1",
        upstream: Optional[Tuple[str, int]] = None,
        device=None,
    ) -> None:
        self.listen_host = listen_host
        self.device = device
        self.upstream = upstream
        self.hosts = NPHDSMap()
        self._lock = threading.Lock()
        self._policies: Dict[int, _PortPolicy] = {}  # proxy_port → policy
        self._listeners: Dict[int, socket.socket] = {}
        self._stop = threading.Event()
        self._accesslog_path = accesslog_socket
        self._accesslog_sock: Optional[socket.socket] = None
        self._al_lock = threading.Lock()
        self.client = XDSClient(xds_socket, node)
        self.client.subscribe(NETWORK_POLICY_TYPE, self._on_npds)
        self.client.subscribe(NETWORK_POLICY_HOSTS_TYPE, self._on_nphds)

    # -- subscriptions --------------------------------------------------
    def _on_nphds(self, version: int, resources: Dict[str, dict]) -> None:
        self.hosts.replace(resources)

    def _on_npds(self, version: int, resources: Dict[str, dict]) -> None:
        desired: Dict[int, _PortPolicy] = {}
        for name, res in resources.items():
            for entry in res.get("l7_ports", ()):
                e = dict(entry)
                e["endpoint_id"] = res.get("endpoint_id", name)
                pp = _PortPolicy(e, device=self.device)
                desired[pp.proxy_port] = pp
        with self._lock:
            self._policies = desired
            live = set(self._listeners)
        for port in set(desired) - live:
            self._start_listener(port)
        for port in live - set(desired):
            self._stop_listener(port)

    # -- listeners ------------------------------------------------------
    def _start_listener(self, port: int) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((self.listen_host, port))
        except OSError as e:
            log.warning("proxy port bind failed", fields={"port": port, "err": str(e)})
            srv.close()
            return
        srv.listen(64)
        srv.settimeout(0.2)
        with self._lock:
            self._listeners[port] = srv
        threading.Thread(
            target=self._accept_loop, args=(srv, port), daemon=True
        ).start()

    def _stop_listener(self, port: int) -> None:
        with self._lock:
            srv = self._listeners.pop(port, None)
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass

    def _accept_loop(self, srv: socket.socket, port: int) -> None:
        while not self._stop.is_set():
            try:
                conn, peer = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn, peer, port), daemon=True
            ).start()

    # -- enforcement ----------------------------------------------------
    def _policy(self, port: int) -> Optional[_PortPolicy]:
        with self._lock:
            return self._policies.get(port)

    # idle keep-alive connections are reaped after this long; also
    # bounds a stalled mid-request body (Envoy's idle_timeout role)
    IDLE_TIMEOUT_S = 60.0

    def _serve_conn(self, conn: socket.socket, peer, port: int) -> None:
        try:
            conn.settimeout(self.IDLE_TIMEOUT_S)
            pol = self._policy(port)
            if pol is None:
                return
            src_identity = self.hosts.identity_of(peer[0])
            if pol.parser == "kafka":
                self._serve_kafka(conn, pol, src_identity)
                return
            # Codec sniff on one port (Envoy's codec auto-detect): the
            # H2 connection preface starts "PRI * HTTP/2.0" — no
            # HTTP/1.1 method collides with it, so read until the bytes
            # either diverge (HTTP/1.1, sniffed bytes become carry) or
            # complete the preface (HTTP/2).
            PREFACE = H2_PREFACE
            buf = b""
            while len(buf) < len(PREFACE) and PREFACE.startswith(buf):
                chunk = conn.recv(len(PREFACE) - len(buf))
                if not chunk:
                    return
                buf += chunk
            if buf == PREFACE:
                self._serve_http2(conn, pol, src_identity)
            else:
                self._serve_http(conn, pol, src_identity, carry=buf)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_http(
        self, conn: socket.socket, pol: _PortPolicy, src_identity: int,
        carry: bytes = b"",
    ) -> None:
        """HTTP/1.1 keep-alive: requests are served off this connection
        until the client closes or asks for Connection: close (the
        reference's Envoy terminates/keeps connections the same way).
        Each request is policy-checked independently."""
        port = pol.proxy_port
        while not self._stop.is_set():
            # re-resolve per request: an NPDS push mid-connection must
            # apply to the NEXT request, not only to new connections
            pol = self._policy(port)
            if pol is None:
                return  # redirect removed: stop serving this port
            carry = self._serve_one_http(conn, pol, src_identity, carry)
            if carry is None:
                return

    def _serve_http2(
        self, conn: socket.socket, pol: _PortPolicy, src_identity: int
    ) -> None:
        """HTTP/2 (and gRPC-over-H2) enforcement on the same proxy
        port. Each stream's request HEADERS are the policy decision
        point — the codec-independence of the reference's Envoy filter
        (envoy/cilium_l7policy.cc:193 works per-stream, any codec).
        Deny: 403 for plain HTTP, 200 + grpc-status PERMISSION_DENIED
        trailers for gRPC (status rides trailers in gRPC). Allow:
        terminate with 200, or relay the stream over an upstream H2
        connection (one per downstream connection, ids reused)."""
        from .http2 import (
            GRPC_PERMISSION_DENIED,
            H2ClientConnection,
            H2ServerConnection,
        )

        port = pol.proxy_port
        # sid → ("deny"|"terminate", None) or ("forward", pinned
        # upstream conn). The pin matters: after an upstream re-dial a
        # mid-body stream must keep talking to the connection its
        # HEADERS went to — DATA on a fresh connection's idle stream id
        # is a connection error that would kill every relayed stream.
        actions: Dict[int, Tuple[str, Optional[H2ClientConnection]]] = {}
        up_holder: Dict[str, H2ClientConnection] = {}
        # forward-mode access logs are deferred until the upstream's
        # response status is known (the h1 path logs the real upstream
        # code; this keeps the h2 path's observability equivalent)
        pending_logs: Dict[int, dict] = {}
        plock = threading.Lock()

        def emit_log(sid: int, code: Optional[int]) -> None:
            with plock:
                rec = pending_logs.pop(sid, None)
            if rec is not None:
                if code is not None:
                    rec["http"]["code"] = code
                self._log_record(rec)

        def upstream_conn(h2) -> Optional[H2ClientConnection]:
            up = up_holder.get("c")
            if up is not None and not up.closed:
                return up
            # first use, or the previous upstream connection died
            # (GOAWAY / restart) — dial a fresh one
            try:
                s = socket.create_connection(self.upstream, timeout=5.0)
            except OSError:
                return None
            # the 5s connect timeout must not become the read timeout:
            # a quiet upstream (slow gRPC handler, idle gaps between
            # responses) would otherwise kill every in-flight stream
            s.settimeout(self.IDLE_TIMEOUT_S)

            def resp_headers(sid, headers, trailers, end):
                if headers is not None:
                    try:
                        code = int(dict(headers).get(b":status", b"0"))
                    except ValueError:
                        code = 0
                    if not 100 <= code < 200:  # interim ≠ final status
                        emit_log(sid, code)
                try:
                    if trailers is not None:
                        h2.send_headers(sid, trailers, True)
                    else:
                        h2.send_headers(sid, headers, end)
                except OSError:
                    pass

            def resp_data(sid, chunk, end):
                try:
                    h2.send_data(sid, chunk, end_stream=end)
                except OSError:
                    pass

            def resp_reset(sid):
                emit_log(sid, 502)
                try:
                    h2.reset(sid)
                except OSError:
                    pass

            up = H2ClientConnection(s)
            up.on_response_headers = resp_headers
            up.on_response_data = resp_data
            up.on_response_reset = resp_reset
            up.handshake()
            threading.Thread(target=up.serve, daemon=True).start()
            up_holder["c"] = up
            return up

        def on_request(h2, st) -> None:
            # fresh policy per stream: an NPDS push mid-connection must
            # apply to the NEXT stream (same rule as the h1 path)
            p = self._policy(port)
            if p is None:
                h2.reset(st.id)  # prunes the stream; late DATA is dropped
                return
            req = HTTPRequest(
                method=st.method, path=st.path, host=st.authority,
                headers=tuple(st.plain_headers()),
                src_identity=src_identity,
            )
            allowed = p.http is None or bool(p.http.check(req))
            code = 200 if allowed else 403
            record = {
                "type": "Request",
                "verdict": "Forwarded" if allowed else "Denied",
                "timestamp": time.time(),
                "src_identity": src_identity,
                "dst_port": pol.port,
                "proto": "http",
                "codec": "h2",
                "http": {
                    "method": st.method, "path": st.path,
                    "host": st.authority, "code": code,
                },
            }
            deferred = False
            if not allowed:
                if not st.closed_remote:  # DATA may still arrive: drop it
                    actions[st.id] = ("deny", None)
                if st.is_grpc:
                    record["http"]["code"] = 200  # denial rides grpc-status
                    h2.respond_grpc_status(
                        st.id, GRPC_PERMISSION_DENIED, "access denied"
                    )
                else:
                    h2.respond(st.id, 403, body=b"Access denied\r\n")
            elif self.upstream is None:
                if st.closed_remote:
                    h2.respond(st.id, 200, body=b"OK\n")
                    actions.pop(st.id, None)
                else:
                    actions[st.id] = ("terminate", None)
            else:
                up = upstream_conn(h2)
                if up is None:
                    if not st.closed_remote:
                        actions[st.id] = ("deny", None)
                    record["http"]["code"] = 502
                    h2.respond(st.id, 502, body=b"")
                else:
                    fields = [
                        (b":method", st.method.encode("latin1")),
                        (b":scheme", b"http"),
                        (b":path", st.path.encode("latin1")),
                    ]
                    if st.authority:
                        fields.append(
                            (b":authority", st.authority.encode("latin1"))
                        )
                    fields += [
                        (k, v) for k, v in st.headers
                        if not k.startswith(b":")
                    ]
                    try:
                        up.request_headers(
                            st.id, fields, end_stream=st.closed_remote
                        )
                        if not st.closed_remote:  # body still to relay
                            actions[st.id] = ("forward", up)
                        # log when the upstream's status is known
                        with plock:
                            pending_logs[st.id] = record
                        deferred = True
                    except OSError:
                        actions.pop(st.id, None)
                        record["http"]["code"] = 502
                        h2.respond(st.id, 502, body=b"")
            if not deferred:
                self._log_record(record)

        def on_data(h2, st, chunk, end) -> None:
            action, up = actions.get(st.id, (None, None))
            if action == "forward":
                if up is not None and (chunk or end):
                    try:
                        up.send_data(st.id, chunk, end_stream=end)
                    except OSError:
                        pass
                if end:
                    actions.pop(st.id, None)
            elif action == "terminate":
                # body bytes are not used by the synthesized response —
                # drop them rather than buffer (a long stream would
                # otherwise grow memory without bound)
                if end:
                    h2.respond(st.id, 200, body=b"OK\n")
                    actions.pop(st.id, None)
            elif action == "deny" and end:
                actions.pop(st.id, None)
            # deny: drop the lane's bytes (client may still be sending
            # against the window we granted before the verdict)

        def on_reset(h2, st) -> None:
            # downstream cancelled (gRPC cancellation): cancel the
            # pinned upstream stream, log the request as cancelled
            action, up = actions.pop(st.id, (None, None))
            if action == "forward" and up is not None:
                up.responses.pop(st.id, None)  # stop relaying its frames
                try:
                    up.send_frame(
                        0x3, 0, st.id, struct.pack(">I", 0x8)  # CANCEL
                    )
                except OSError:
                    pass
            emit_log(st.id, 499)  # client closed request (nginx idiom)

        from .http2 import PREFACE

        server = H2ServerConnection(
            conn, on_request, on_data=on_data, on_reset=on_reset
        )
        if not server.handshake(consumed=PREFACE):  # sniffer read it all
            return
        try:
            server.serve()
        finally:
            up = up_holder.get("c")
            if up is not None:
                try:
                    up.sock.close()
                except OSError:
                    pass
            # forwarded streams whose response never arrived: log them
            # as 502 so no request vanishes from the access log
            with plock:
                leftover = list(pending_logs.values())
                pending_logs.clear()
            for rec in leftover:
                rec["http"]["code"] = 502
                self._log_record(rec)

    @staticmethod
    def _drain(conn: socket.socket, n: int) -> bool:
        """Consume n body bytes still on the socket; False on EOF."""
        while n > 0:
            chunk = conn.recv(min(65536, n))
            if not chunk:
                return False
            n -= len(chunk)
        return True

    def _tunnel_raw(
        self, a: socket.socket, b: socket.socket, b_carry: bytes = b""
    ) -> None:
        """Bidirectional byte tunnel (post-101 upgraded connections —
        WebSocket etc. — leave HTTP framing entirely). Returns when
        either side closes."""
        if b_carry:
            a.sendall(b_carry)

        def pump(src, dst):
            try:
                src.settimeout(self.IDLE_TIMEOUT_S)
                while True:
                    chunk = src.recv(65536)
                    if not chunk:
                        break
                    dst.sendall(chunk)
            except OSError:
                pass
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        t = threading.Thread(target=pump, args=(b, a), daemon=True)
        t.start()
        pump(a, b)
        t.join(timeout=5)

    # chunked REQUEST bodies larger than this are rejected — they must
    # be buffered whole to preserve the policy/pipelining guarantees.
    # Responses are never capped: they stream through _pump_chunked.
    CHUNKED_BODY_LIMIT = 1 << 22

    @staticmethod
    def _chunked_final(te: str) -> bool:
        """True when the FINAL transfer coding is chunked (RFC 7230
        §3.3.3 — only then is the body chunk-framed)."""
        codings = [t.strip().lower() for t in te.split(",") if t.strip()]
        return bool(codings) and codings[-1] == "chunked"

    @staticmethod
    def _pump_chunked(src: socket.socket, buf: bytes, sink, limit=None):
        """Incrementally parse one RFC 7230 §4.1 chunked body from
        carry+socket, passing each VALIDATED wire byte run to ``sink``
        (the bytes re-forward as-is: size lines, data, CRLFs, trailer
        section). → (ok, leftover). ``limit`` caps total WIRE bytes —
        data, chunk-extension lines, AND trailers all count, so neither
        oversized extensions nor an endless trailer section can grow
        memory past the cap (None = stream unbounded — the response
        relay path, which forwards instead of buffering)."""
        total = 0

        class _Overflow(Exception):
            pass

        raw_sink = sink

        def sink(b):  # noqa: F811 - deliberate wrap
            nonlocal total
            total += len(b)
            if limit is not None and total > limit:
                raise _Overflow
            raw_sink(b)

        def read_line():
            nonlocal buf
            while True:
                idx = buf.find(b"\r\n")
                if idx >= 0:
                    line, buf = buf[:idx], buf[idx + 2:]
                    return line, True
                if len(buf) > 16384:
                    return None, False
                chunk = src.recv(65536)
                if not chunk:
                    return None, False
                buf += chunk

        try:
            while True:
                line, ok = read_line()
                if not ok:
                    return False, b""
                try:
                    size = int(line.split(b";")[0].strip(), 16)
                except ValueError:
                    return False, b""
                if size < 0:
                    return False, b""
                sink(line + b"\r\n")
                if size == 0:
                    # trailer section: header lines until the blank one
                    while True:
                        t, ok = read_line()
                        if not ok:
                            return False, b""
                        sink(t + b"\r\n")
                        if t == b"":
                            return True, buf
                remaining = size
                while remaining > 0:
                    if not buf:
                        buf = src.recv(min(65536, remaining))
                        if not buf:
                            return False, b""
                    take = min(len(buf), remaining)
                    sink(buf[:take])
                    buf = buf[take:]
                    remaining -= take
                while len(buf) < 2:
                    chunk = src.recv(2 - len(buf))
                    if not chunk:
                        return False, b""
                    buf += chunk
                if buf[:2] != b"\r\n":
                    return False, b""
                sink(b"\r\n")
                buf = buf[2:]
        except _Overflow:
            return False, b""

    @classmethod
    def _read_chunked(cls, conn: socket.socket, buf: bytes, limit=None):
        """Buffering wrapper over _pump_chunked (request path). →
        (raw, leftover) or (None, None) on error/EOF/cap."""
        parts: List[bytes] = []
        ok, leftover = cls._pump_chunked(
            conn, buf, parts.append,
            limit=cls.CHUNKED_BODY_LIMIT if limit is None else limit,
        )
        if not ok:
            return None, None
        return b"".join(parts), leftover

    def _serve_one_http(
        self, conn: socket.socket, pol: _PortPolicy, src_identity: int,
        carry: bytes,
    ) -> Optional[bytes]:
        """One request/response exchange → leftover bytes for the next
        request, or None to close the connection."""
        head = _read_http_head(conn, carry)
        if head is None:
            return None
        try:
            head_text, _, body_rest = head.partition(b"\r\n\r\n")
            lines = head_text.decode("latin1").split("\r\n")
            method, path, _version = lines[0].split(" ", 2)
            headers: List[Tuple[str, str]] = []
            host = ""
            for ln in lines[1:]:
                if not ln:
                    continue
                name, _, value = ln.partition(":")
                headers.append((name.strip(), value.strip()))
                if name.strip().lower() == "host":
                    host = value.strip()
        except (ValueError, IndexError):
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n\r\n")
            return None  # can't re-sync a malformed stream
        req = HTTPRequest(
            method=method, path=path, host=host,
            headers=tuple(headers), src_identity=src_identity,
        )
        hdr_map = {k.lower(): v for k, v in headers}
        te = hdr_map.get("transfer-encoding", "").strip().lower()
        chunked = self._chunked_final(te) if te else False
        # RFC 7230: repeated Content-Length with differing values, a
        # non-numeric value, or a negative one is a framing attack
        # (CL.CL smuggling / parser desync) — reject and close, never
        # guess
        cl_values = {
            v.strip() for k, v in headers if k.lower() == "content-length"
        }
        if te and not chunked:
            # unknown final transfer coding: body framing is undefined
            conn.sendall(
                b"HTTP/1.1 501 Not Implemented\r\ncontent-length: 0\r\n\r\n"
            )
            return None
        if chunked and cl_values:
            # TE.CL conflict is the classic smuggling vector — RFC 7230
            # §3.3.3 requires treating it as an error here
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n\r\n")
            return None
        if len(cl_values) > 1:
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n\r\n")
            return None
        try:
            content_length = int(next(iter(cl_values), "0"))
        except ValueError:
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n\r\n")
            return None
        if content_length < 0:
            conn.sendall(b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n\r\n")
            return None
        # split what we over-read into this request's body vs the next
        # request's head (pipelining); drain any body still in flight
        if chunked:
            # buffer the whole chunked body up front: its extent is
            # only knowable by parsing, and both the deny path and the
            # pipelining guarantee need the exact boundary
            raw_body, leftover = self._read_chunked(conn, body_rest)
            if raw_body is None:
                conn.sendall(
                    b"HTTP/1.1 400 Bad Request\r\ncontent-length: 0\r\n\r\n"
                )
                return None
            body_pending = 0
            this_body = raw_body
        else:
            body_pending = max(0, content_length - len(body_rest))
            leftover = (
                body_rest[content_length:]
                if content_length < len(body_rest)
                else b""
            )
            this_body = body_rest[:content_length]
        wants_close = "close" in hdr_map.get("connection", "").lower()
        allowed = pol.http is None or bool(pol.http.check(req))
        code = 200 if allowed else 403
        if allowed:
            if self.upstream is not None:
                # forward ONLY this request's bytes: the over-read tail
                # may hold a pipelined next request that must be
                # policy-checked here, never smuggled upstream
                this_request = head_text + b"\r\n\r\n" + this_body
                code, reusable = self._forward_http(
                    conn, this_request, body_pending, method,
                )
                if not reusable:
                    leftover = None
                else:
                    conn.settimeout(self.IDLE_TIMEOUT_S)
            else:
                if not self._drain(conn, body_pending):
                    return None
                body = b"OK\n"
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\ncontent-length: "
                    + str(len(body)).encode() + b"\r\n\r\n" + body
                )
        else:
            if not self._drain(conn, body_pending):  # denied: eat body
                return None
            body = b"Access denied\r\n"
            conn.sendall(
                b"HTTP/1.1 403 Forbidden\r\ncontent-length: "
                + str(len(body)).encode() + b"\r\n\r\n" + body
            )
        self._log_record({
            "type": "Request",
            "verdict": "Forwarded" if allowed else "Denied",
            "timestamp": time.time(),
            "src_identity": src_identity,
            "dst_port": pol.port,
            "proto": "http",
            "http": {"method": method, "path": path, "host": host, "code": code},
        })
        return None if wants_close else leftover

    def _forward_http(
        self, conn: socket.socket, request_bytes: bytes, body_pending: int,
        method: str,
    ) -> Tuple[int, bool]:
        """Relay the buffered request (plus any request body still in
        flight from the client) to the upstream, then relay the reply
        honoring ITS OWN framing (Content-Length / chunked / 204/304 /
        until-close). → (status code, downstream_reusable): parsing the
        response's extent is what lets the keep-alive connection — and
        any pipelined tail — survive a forwarded request."""
        assert self.upstream is not None
        try:
            up = socket.create_connection(self.upstream, timeout=5.0)
        except OSError:
            conn.sendall(b"HTTP/1.1 502 Bad Gateway\r\ncontent-length: 0\r\n\r\n")
            # body_pending request bytes are still inbound — drain them
            # or the next head-parse reads body as a "request" (desync)
            reusable = self._drain(conn, body_pending)
            return 502, reusable
        try:
            up.sendall(request_bytes)
            conn.settimeout(5.0)
            while body_pending > 0:
                chunk = conn.recv(min(65536, body_pending))
                if not chunk:
                    return 502, False
                up.sendall(chunk)
                body_pending -= len(chunk)
            up.settimeout(self.IDLE_TIMEOUT_S)
            carry = b""
            while True:  # 1xx interim responses precede the final one
                rhead = _read_http_head(up, carry)
                if rhead is None:
                    conn.sendall(
                        b"HTTP/1.1 502 Bad Gateway\r\ncontent-length: 0\r\n\r\n"
                    )
                    return 502, True
                rtext, _, rbody = rhead.partition(b"\r\n\r\n")
                rlines = rtext.decode("latin1").split("\r\n")
                try:
                    code = int(rlines[0].split(" ", 2)[1])
                except (ValueError, IndexError):
                    code = 502
                conn.sendall(rtext + b"\r\n\r\n")  # interim heads relay too
                if code == 101:
                    # Switching Protocols: the connection leaves HTTP —
                    # tunnel raw bytes both ways until either side closes
                    self._tunnel_raw(conn, up, rbody)
                    return 101, False
                if not 100 <= code < 200:
                    break
                carry = rbody  # next head may already be buffered
            rmap: Dict[str, str] = {}
            for ln in rlines[1:]:
                name, _, value = ln.partition(":")
                rmap[name.strip().lower()] = value.strip()
            reusable = "close" not in rmap.get("connection", "").lower()
            if method == "HEAD" or code in (204, 304):
                return code, reusable
            rte = rmap.get("transfer-encoding", "").strip().lower()
            if self._chunked_final(rte):
                # stream chunk-by-chunk (no size cap on responses)
                ok, _left = self._pump_chunked(up, rbody, conn.sendall)
                if not ok:
                    return code, False  # upstream framing broke mid-body
                return code, reusable
            if "content-length" in rmap:
                try:
                    cl = int(rmap["content-length"])
                except ValueError:
                    return code, False
                conn.sendall(rbody[:cl])
                remaining = cl - len(rbody)
                while remaining > 0:
                    chunk = up.recv(min(65536, remaining))
                    if not chunk:
                        return code, False
                    conn.sendall(chunk)
                    remaining -= len(chunk)
                return code, reusable
            # no framing header: body extends to upstream close
            conn.sendall(rbody)
            while True:
                try:
                    chunk = up.recv(65536)
                except socket.timeout:
                    break
                if not chunk:
                    break
                conn.sendall(chunk)
            return code, False
        finally:
            up.close()

    def _serve_kafka(
        self, conn: socket.socket, pol: _PortPolicy, src_identity: int
    ) -> None:
        """Transparent Kafka request/response proxy with per-request
        ACL (pkg/proxy/kafka.go handleRequest): denied requests get a
        synthesized reject frame, allowed ones are forwarded upstream
        (when configured) and the broker reply relayed back."""
        from ..l7.kafka_wire import (
            KafkaParseError,
            parse_request,
            reject_response,
        )

        up: Optional[socket.socket] = None
        try:
            while not self._stop.is_set():
                hdr = _recv_exact(conn, 4)
                if hdr is None:
                    return
                (size,) = struct.unpack(">i", hdr)
                if size <= 0 or size > (64 << 20):
                    return
                body = _recv_exact(conn, size)
                if body is None:
                    return
                try:
                    parsed = parse_request(hdr + body)
                except KafkaParseError:
                    return
                reqs = [
                    KafkaRequest(
                        api_key=parsed.api_key,
                        api_version=parsed.api_version,
                        client_id=parsed.client_id,
                        topic=t,
                        src_identity=src_identity,
                    )
                    for t in (parsed.topics or ("",))
                ]
                allows = (
                    pol.kafka.check_batch(reqs)
                    if pol.kafka is not None
                    else [True] * len(reqs)
                )
                allowed = all(bool(a) for a in allows)
                self._log_record({
                    "type": "Request",
                    "verdict": "Forwarded" if allowed else "Denied",
                    "timestamp": time.time(),
                    "src_identity": src_identity,
                    "dst_port": pol.port,
                    "proto": "kafka",
                    "kafka": {
                        "api_key": parsed.api_key,
                        "topic": parsed.topics[0] if parsed.topics else "",
                        "error_code": 0 if allowed else 29,
                    },
                })
                if not allowed:
                    # Produce acks=0 clients expect NO frame — a
                    # synthesized reject would desync their correlation
                    # matching (pkg/kafka handles acks=0 the same way)
                    if parsed.expect_response:
                        conn.sendall(reject_response(parsed))
                    continue
                if self.upstream is None:
                    # terminating mode: ack with an empty-body frame so
                    # the client unblocks (when it expects one)
                    if parsed.expect_response:
                        conn.sendall(
                            struct.pack(">ii", 4, parsed.correlation_id)
                        )
                    continue
                if up is None:
                    up = socket.create_connection(self.upstream, timeout=5.0)
                up.sendall(parsed.raw)
                if not parsed.expect_response:
                    continue  # acks=0: fire-and-forget upstream
                rhdr = _recv_exact(up, 4)
                if rhdr is None:
                    return
                (rsize,) = struct.unpack(">i", rhdr)
                rbody = _recv_exact(up, rsize)
                if rbody is None:
                    return
                conn.sendall(rhdr + rbody)
        finally:
            if up is not None:
                try:
                    up.close()
                except OSError:
                    pass

    # -- access log streaming ------------------------------------------
    def _log_record(self, record: dict) -> None:
        if self._accesslog_path is None:
            return
        # _al_lock serializes access-log frames onto one unix socket;
        # the lazy connect under it happens once per collector
        # (re)start and the framed sendall (via _send_msg) is the
        # lock's entire purpose — accepted hold
        with self._al_lock:
            for _attempt in (0, 1):
                if self._accesslog_sock is None:
                    try:
                        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)  # policyd-lint: disable=LOCK002
                        s.connect(self._accesslog_path)  # policyd-lint: disable=LOCK002
                        self._accesslog_sock = s
                    except OSError:
                        self._accesslog_sock = None
                        return
                try:
                    _send_msg(self._accesslog_sock, record)  # policyd-lint: disable=LOCK002
                    return
                except OSError:
                    try:
                        self._accesslog_sock.close()
                    except OSError:
                        pass
                    self._accesslog_sock = None  # reconnect once

    # -- lifecycle ------------------------------------------------------
    def wait_ready(self, timeout: float = 5.0) -> bool:
        """Block until the first NPDS version is applied and every
        advertised proxy port has a bound listener."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                have = set(self._listeners)
                want = set(self._policies)
            if self.client.applied.get(NETWORK_POLICY_TYPE, -1) >= 0 and want <= have:
                return True
            time.sleep(0.02)
        return False

    def ports(self) -> List[int]:
        with self._lock:
            return sorted(self._listeners)

    def close(self) -> None:
        self._stop.set()
        self.client.close()
        with self._lock:
            listeners = list(self._listeners.values())
            self._listeners.clear()
        for srv in listeners:
            try:
                srv.close()
            except OSError:
                pass
        with self._al_lock:
            if self._accesslog_sock is not None:
                try:
                    self._accesslog_sock.close()
                except OSError:
                    pass
                self._accesslog_sock = None


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="python -m cilium_tpu_torch.proxy",
        description="standalone L7 proxy (NPDS/NPHDS subscriber)",
    )
    ap.add_argument("--xds", required=True, help="agent xDS unix socket")
    ap.add_argument("--accesslog", default=None, help="agent accesslog unix socket")
    ap.add_argument("--node", default="external-proxy")
    ap.add_argument("--listen-host", default="127.0.0.1")
    ap.add_argument("--upstream", default=None, help="host:port to forward allowed traffic to")
    ap.add_argument("--device", default=None, help="the policies' device (default: the card)")
    args = ap.parse_args(argv)
    from .._kernels import resolve_device

    device = resolve_device(args.device)  # no card: fail before READY
    from ..utils.procutil import die_with_parent

    die_with_parent()  # a SIGKILLed agent must not leak this sidecar
    upstream = None
    if args.upstream:
        host, _, port = args.upstream.rpartition(":")
        upstream = (host, int(port))
    proxy = StandaloneProxy(
        args.xds, args.accesslog, node=args.node,
        listen_host=args.listen_host, upstream=upstream, device=device,
    )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    proxy.wait_ready()
    print("READY", flush=True)
    stop.wait()
    proxy.close()
    return 0
