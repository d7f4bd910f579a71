"""Port parity: HTTP/2, gRPC and chunked HTTP/1.1 in the external proxy
(``proxy/hpack.py``, ``proxy/http2.py``, ``proxy/standalone.py``).

The 16 tests of the reference's ``test_proxy_http2.py`` run once a
package with the reference's own assertions: an in-process
``StandaloneProxy`` of that package (the port's with ``device="cpu"``)
behind that package's ``XDSServer`` and ``AccessLogSocketServer``,
driven with the same wire bytes. The two runs must return equal
statuses, response frames (headers, bodies, trailers) and access-log
records (every field but the timestamp). Tolerance 0: every value
compared is an integer, a string, bytes or a bool.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import socket
import threading
import time
import types

import pytest

from test_torch_harness import PKGS

CLIENT_IDENTITY = 1001


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def ns(pkg: str):
    hpack, http2 = _mod(pkg, "proxy.hpack"), _mod(pkg, "proxy.http2")
    cache, accesslog = _mod(pkg, "xds.cache"), _mod(pkg, "proxy.accesslog")
    return types.SimpleNamespace(
        pkg=pkg,
        cpu={"device": "cpu"} if pkg == "cilium_tpu_torch" else {},
        hpack=hpack,
        h2=http2,
        StandaloneProxy=_mod(pkg, "proxy.standalone").StandaloneProxy,
        NETWORK_POLICY_TYPE=cache.NETWORK_POLICY_TYPE,
        NETWORK_POLICY_HOSTS_TYPE=cache.NETWORK_POLICY_HOSTS_TYPE,
        ResourceCache=cache.ResourceCache,
        XDSServer=_mod(pkg, "xds.server").XDSServer,
        AccessLogServer=accesslog.AccessLogServer,
        AccessLogSocketServer=accesslog.AccessLogSocketServer,
    )


def both(scenario):
    """Run ``scenario(m)`` on each package; the two results must be equal."""
    outs = [scenario(ns(pkg)) for pkg in PKGS]
    assert outs[0] == outs[1]
    return outs[0]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_for(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


@contextlib.contextmanager
def control_plane(m, tmp_path):
    """The reference's fixture, for package ``m``."""
    xds_path = str(tmp_path / f"xds-{m.pkg}.sock")
    al_path = str(tmp_path / f"accesslog-{m.pkg}.sock")
    cache = m.ResourceCache()
    server = m.XDSServer(cache, xds_path)
    server.start()
    sink = m.AccessLogServer()
    rx = m.AccessLogSocketServer(sink, al_path).start()
    try:
        yield cache, xds_path, al_path, sink
    finally:
        rx.stop()
        server.stop()


def _proxy(m, xds_path, al_path, **kw):
    return m.StandaloneProxy(xds_path, al_path, **kw, **m.cpu)


def _publish(m, cache, proxy_port: int, rules):
    cache.upsert(m.NETWORK_POLICY_TYPE, "7", {
        "endpoint_id": 7,
        "l7_ports": [{
            "port": 80, "ingress": True, "parser": "http",
            "proxy_port": proxy_port, "http_rules": rules,
        }],
    })
    cache.upsert(
        m.NETWORK_POLICY_HOSTS_TYPE, str(CLIENT_IDENTITY),
        {"policy": CLIENT_IDENTITY, "host_addresses": ["127.0.0.1/32"]},
    )


def _records(sink, n: int):
    """The first ``n`` records once ``n`` have arrived, without their
    timestamps."""
    assert _wait_for(lambda: len(sink.recent(10_000)) >= n)
    out = []
    for r in sink.recent(10_000)[:n]:
        d = dataclasses.asdict(r)
        del d["timestamp"]
        out.append(d)
    return out


# -- TestHpack -----------------------------------------------------------------


def test_rfc7541_c4_huffman_request():
    """RFC 7541 Appendix C.4.1: the canonical Huffman-coded first
    request."""
    def run(m):
        wire = bytes.fromhex("828684418cf1e3c2e5f23a6ba0ab90f4ff")
        d = m.hpack.HpackDecoder()
        first = d.decode(wire)
        assert first == [
            (b":method", b"GET"),
            (b":scheme", b"http"),
            (b":path", b"/"),
            (b":authority", b"www.example.com"),
        ]
        # C.4.2 second request: dynamic-table hit for :authority
        wire2 = bytes.fromhex("828684be5886a8eb10649cbf")
        second = d.decode(wire2)
        assert second == [
            (b":method", b"GET"),
            (b":scheme", b"http"),
            (b":path", b"/"),
            (b":authority", b"www.example.com"),
            (b"cache-control", b"no-cache"),
        ]
        return first, second

    both(run)


def test_huffman_roundtrip():
    def run(m):
        out = []
        for s in (b"", b"a", b"www.example.com", b"no-cache", bytes(range(256))):
            enc = m.hpack.huffman_encode(s)
            assert m.hpack.huffman_decode(enc) == s
            out.append(enc)
        return out

    both(run)


def test_encoder_decoder_roundtrip():
    def run(m):
        headers = [
            (b":status", b"200"),
            (b"content-type", b"application/grpc"),
            (b"x-custom-header", b"some value with spaces"),
            (b"grpc-status", b"7"),
        ]
        wire = m.hpack.HpackEncoder().encode(headers)
        assert m.hpack.HpackDecoder().decode(wire) == headers
        return wire

    both(run)


class _H2TestClient:
    """Minimal hand-rolled H2 client for driving the proxy's server
    codec with exact wire bytes (the reference's, over package ``m``'s
    codec)."""

    def __init__(self, m, port: int) -> None:
        self.m = m
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=15)
        self.sock.settimeout(15)
        self.enc = m.hpack.HpackEncoder()
        self.dec = m.hpack.HpackDecoder()
        self.sock.sendall(m.h2.PREFACE + m.h2.pack_frame(m.h2.FRAME_SETTINGS, 0, 0, b""))
        self._next_sid = 1

    def request(self, method: str, path: str, headers=(), body: bytes = b"",
                grpc: bool = False):
        h2 = self.m.h2
        sid = self._next_sid
        self._next_sid += 2
        fields = [
            (b":method", method.encode()), (b":scheme", b"http"),
            (b":path", path.encode()), (b":authority", b"svc.local"),
        ]
        if grpc:
            fields.append((b"content-type", b"application/grpc"))
            fields.append((b"te", b"trailers"))
        fields += list(headers)
        flags = h2.FLAG_END_HEADERS | (0 if body else h2.FLAG_END_STREAM)
        self.sock.sendall(h2.pack_frame(h2.FRAME_HEADERS, flags, sid, self.enc.encode(fields)))
        if body:
            self.sock.sendall(h2.pack_frame(h2.FRAME_DATA, h2.FLAG_END_STREAM, sid, body))
        return sid

    def read_response(self, sid: int):
        """→ (headers, body, trailers) for one stream (ignoring other
        frame traffic)."""
        h2 = self.m.h2
        headers = None
        trailers = None
        body = b""
        while True:
            fr = h2.read_frame(self.sock)
            assert fr is not None, "connection closed mid-response"
            ftype, flags, fsid, payload = fr
            if ftype == h2.FRAME_SETTINGS and not flags & h2.FLAG_ACK:
                self.sock.sendall(h2.pack_frame(h2.FRAME_SETTINGS, h2.FLAG_ACK, 0))
                continue
            if fsid != sid:
                continue
            if ftype == h2.FRAME_HEADERS:
                fields = self.dec.decode(payload)
                if headers is None:
                    headers = fields
                else:
                    trailers = fields
                if flags & h2.FLAG_END_STREAM:
                    return headers, body, trailers
            elif ftype == h2.FRAME_DATA:
                body += payload
                if flags & h2.FLAG_END_STREAM:
                    return headers, body, trailers

    def close(self):
        self.sock.close()


def _status(headers) -> int:
    return int(dict(headers)[b":status"])


# -- TestHTTP2Enforcement --------------------------------------------------------


def test_h2_allow_deny_and_accesslog(tmp_path):
    """Terminating mode: allowed path → 200, denied → 403, wrong
    identity → 403; all three logged with the h2 codec marker."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/public/.*", "remote_policies": [CLIENT_IDENTITY]}
            ])
            proxy = _proxy(m, xds_path, al_path)
            try:
                assert proxy.wait_ready()
                c = _H2TestClient(m, proxy_port)
                frames = []
                sid = c.request("GET", "/public/ok")
                frames.append(c.read_response(sid))
                h, body, _t = frames[-1]
                assert _status(h) == 200 and body == b"OK\n"
                sid = c.request("GET", "/secret")
                frames.append(c.read_response(sid))
                assert _status(frames[-1][0]) == 403
                # several streams on ONE connection, policy-checked each
                sid = c.request("POST", "/public/with-body", body=b"x" * 5000)
                frames.append(c.read_response(sid))
                assert _status(frames[-1][0]) == 200
                c.close()
                assert _wait_for(lambda: len(sink.recent()) >= 3)
                recs = sink.recent()[-3:]
                assert [r.verdict for r in recs] == ["Forwarded", "Denied", "Forwarded"]
                assert recs[0].http["code"] == 200
                assert recs[1].http["code"] == 403
                return frames, _records(sink, 3)
            finally:
                proxy.close()

    both(run)


def test_grpc_deny_is_grpc_status_trailers(tmp_path):
    """A denied gRPC stream must answer 200 + grpc-status 7 in trailers
    (transport-level 403 would surface as UNAVAILABLE, not
    PERMISSION_DENIED)."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/echo.Echo/Allowed", "remote_policies": [CLIENT_IDENTITY]}
            ])
            proxy = _proxy(m, xds_path, al_path)
            try:
                assert proxy.wait_ready()
                c = _H2TestClient(m, proxy_port)
                sid = c.request("POST", "/echo.Echo/Secret", grpc=True,
                                body=b"\x00\x00\x00\x00\x00")
                h, body, t = c.read_response(sid)
                assert _status(h) == 200
                tmap = dict(t)
                assert tmap[b"grpc-status"] == b"7"  # PERMISSION_DENIED
                c.close()
                return (h, body, t), _records(sink, 1)
            finally:
                proxy.close()

    both(run)


def test_h2_forwarding_streams_upstream(tmp_path):
    """Forward mode: allowed streams relay to an upstream H2 server
    (request body upstream, response headers+body+trailers back); denied
    streams never reach it."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/public/.*", "remote_policies": [CLIENT_IDENTITY]}
            ])
            seen_paths = []
            up_srv = socket.socket()
            up_srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            up_srv.bind(("127.0.0.1", 0))
            up_srv.listen(4)
            up_srv.settimeout(15)

            def upstream():
                try:
                    conn, _ = up_srv.accept()
                except OSError:
                    return

                def on_request(h2, st):
                    if st.closed_remote:
                        finish(h2, st)

                def on_data(h2, st, chunk, end):
                    st.body += chunk
                    if end:
                        finish(h2, st)

                def finish(h2, st):
                    seen_paths.append(st.path)
                    h2.respond(
                        st.id, 200,
                        headers=[(b"x-upstream", b"yes")],
                        body=b"echo:" + bytes(st.body),
                        trailers=[(b"x-trailer", b"tail")],
                    )

                srv = m.h2.H2ServerConnection(conn, on_request, on_data=on_data)
                if srv.handshake():
                    srv.serve()

            t = threading.Thread(target=upstream, daemon=True)
            t.start()
            proxy = _proxy(m, xds_path, al_path, upstream=up_srv.getsockname())
            try:
                assert proxy.wait_ready()
                c = _H2TestClient(m, proxy_port)
                sid = c.request("POST", "/public/fwd", body=b"payload")
                fwd = c.read_response(sid)
                h, body, trailers = fwd
                assert _status(h) == 200
                assert dict(h).get(b"x-upstream") == b"yes"
                assert body == b"echo:payload"
                assert trailers is not None and dict(trailers)[b"x-trailer"] == b"tail"
                # denied stream on the same connection: 403 locally
                sid = c.request("GET", "/blocked")
                denied = c.read_response(sid)
                assert _status(denied[0]) == 403
                c.close()
                assert seen_paths == ["/public/fwd"], seen_paths
                return fwd, denied, seen_paths, _records(sink, 2)
            finally:
                proxy.close()
                up_srv.close()

    both(run)


# -- TestGrpcEndToEnd ------------------------------------------------------------


def test_real_grpc_client_through_proxy(tmp_path):
    """A real grpcio client + server: the allowed method round-trips
    through the proxy; the denied method gets PERMISSION_DENIED from the
    proxy (never reaching the server)."""
    grpc = pytest.importorskip("grpc")
    from concurrent.futures import ThreadPoolExecutor

    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/echo.Echo/Allowed", "remote_policies": [CLIENT_IDENTITY]}
            ])
            served = []

            def allowed(request, context):
                served.append(("Allowed", request))
                return b"pong:" + request

            def secret(request, context):
                served.append(("Secret", request))
                return b"leak:" + request

            handler = grpc.method_handlers_generic_handler("echo.Echo", {
                "Allowed": grpc.unary_unary_rpc_method_handler(
                    allowed, request_deserializer=lambda b: b, response_serializer=lambda b: b,
                ),
                "Secret": grpc.unary_unary_rpc_method_handler(
                    secret, request_deserializer=lambda b: b, response_serializer=lambda b: b,
                ),
            })
            server = grpc.server(ThreadPoolExecutor(max_workers=2))
            server.add_generic_rpc_handlers((handler,))
            upstream_port = server.add_insecure_port("127.0.0.1:0")
            server.start()
            proxy = _proxy(m, xds_path, al_path, upstream=("127.0.0.1", upstream_port))
            try:
                assert proxy.wait_ready()
                channel = grpc.insecure_channel(f"127.0.0.1:{proxy_port}")
                call = channel.unary_unary(
                    "/echo.Echo/Allowed",
                    request_serializer=lambda b: b, response_deserializer=lambda b: b,
                )
                pong = call(b"ping", timeout=15)
                assert pong == b"pong:ping"
                denied = channel.unary_unary(
                    "/echo.Echo/Secret",
                    request_serializer=lambda b: b, response_deserializer=lambda b: b,
                )
                with pytest.raises(grpc.RpcError) as exc:
                    denied(b"ping", timeout=15)
                assert exc.value.code() == grpc.StatusCode.PERMISSION_DENIED
                assert [m_ for m_, _ in served] == ["Allowed"]
                channel.close()
                assert _wait_for(lambda: len(sink.recent()) >= 2)
                assert [r.verdict for r in sink.recent()[-2:]] == ["Forwarded", "Denied"]
                recs = _records(sink, 2)
                for r in recs:  # the client's authority names this run's port
                    r["http"]["host"] = r["http"]["host"].replace(str(proxy_port), "PORT")
                return pong, str(exc.value.code()), served, recs
            finally:
                proxy.close()
                server.stop(0)

    both(run)


# -- TestChunkedTransferEncoding ---------------------------------------------------


def _roundtrip(sock, raw: bytes) -> bytes:
    sock.sendall(raw)
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            return data
        data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    for ln in head.split(b"\r\n"):
        if ln.lower().startswith(b"content-length"):
            clen = int(ln.split(b":")[1])
            while len(rest) < clen:
                rest += sock.recv(4096)
    return head + b"\r\n\r\n" + rest


def test_chunked_request_terminating(tmp_path):
    """A chunked request body is consumed correctly; the keep-alive
    request after it still parses (boundary found by chunk framing)."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/public/.*", "remote_policies": [CLIENT_IDENTITY]}
            ])
            proxy = _proxy(m, xds_path, al_path)
            try:
                assert proxy.wait_ready()
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
                c.settimeout(10)
                first = _roundtrip(
                    c,
                    b"POST /public/up HTTP/1.1\r\nHost: h\r\n"
                    b"transfer-encoding: chunked\r\n\r\n"
                    b"4\r\nwiki\r\n5\r\npedia\r\n0\r\n\r\n",
                )
                assert b" 200 " in first
                # pipelined next request rides the same connection
                second = _roundtrip(c, b"GET /secret HTTP/1.1\r\nHost: h\r\n\r\n")
                assert b" 403 " in second
                c.close()
                return first, second, _records(sink, 2)
            finally:
                proxy.close()

    both(run)


def test_te_cl_conflict_rejected(tmp_path):
    """Transfer-Encoding + Content-Length together is the TE.CL
    smuggling shape → 400 and close (RFC 7230 §3.3.3)."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [{"path": "/.*", "remote_policies": [CLIENT_IDENTITY]}])
            proxy = _proxy(m, xds_path, al_path)
            try:
                assert proxy.wait_ready()
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
                c.settimeout(10)
                c.sendall(
                    b"POST /x HTTP/1.1\r\nHost: h\r\n"
                    b"transfer-encoding: chunked\r\ncontent-length: 4\r\n\r\n"
                    b"0\r\n\r\n"
                )
                d = b""
                while b"\r\n\r\n" not in d:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    d += chunk
                assert b" 400 " in d
                tail = c.recv(4096)
                assert tail == b""
                c.close()
                return d, tail, len(sink.recent())
            finally:
                proxy.close()

    both(run)


def test_chunked_both_directions_through_upstream(tmp_path):
    """Forward mode: a chunked request body reaches the upstream intact,
    a chunked upstream response relays back intact, and the keep-alive
    connection survives for a second request."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/public/.*", "remote_policies": [CLIENT_IDENTITY]}
            ])
            got = []
            up_srv = socket.socket()
            up_srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            up_srv.bind(("127.0.0.1", 0))
            up_srv.listen(4)
            up_srv.settimeout(15)

            def upstream():
                while True:
                    try:
                        conn, _ = up_srv.accept()
                    except OSError:
                        return
                    conn.settimeout(5)
                    buf = b""
                    try:
                        # one request per connection (proxy dials per request)
                        while b"0\r\n\r\n" not in buf:
                            chunk = conn.recv(4096)
                            if not chunk:
                                break
                            buf += chunk
                        got.append(buf)
                        conn.sendall(
                            b"HTTP/1.1 200 OK\r\n"
                            b"transfer-encoding: chunked\r\n\r\n"
                            b"7\r\nreply-a\r\n7\r\nreply-b\r\n0\r\n\r\n"
                        )
                    except OSError:
                        pass
                    finally:
                        conn.close()

            t = threading.Thread(target=upstream, daemon=True)
            t.start()
            proxy = _proxy(m, xds_path, al_path, upstream=up_srv.getsockname())
            try:
                assert proxy.wait_ready()
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
                c.settimeout(10)
                c.sendall(
                    b"POST /public/ch HTTP/1.1\r\nHost: h\r\n"
                    b"transfer-encoding: chunked\r\n\r\n"
                    b"3\r\nabc\r\n3\r\ndef\r\n0\r\n\r\n"
                )
                d = b""
                while b"0\r\n\r\n" not in d:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    d += chunk
                assert b" 200 " in d
                assert b"reply-a" in d and b"reply-b" in d
                assert got and b"3\r\nabc\r\n3\r\ndef\r\n0\r\n\r\n" in got[0]
                # keep-alive survived the forwarded exchange: next request
                # on the SAME downstream connection works
                c.sendall(
                    b"POST /public/ch2 HTTP/1.1\r\nHost: h\r\n"
                    b"transfer-encoding: chunked\r\n\r\n"
                    b"2\r\nhi\r\n0\r\n\r\n"
                )
                d2 = b""
                while b"0\r\n\r\n" not in d2:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    d2 += chunk
                assert b" 200 " in d2
                c.close()
                return d, d2, list(got), _records(sink, 2)
            finally:
                proxy.close()
                up_srv.close()

    both(run)


# -- TestReviewRegressions ---------------------------------------------------------


def test_large_chunked_response_streams_through(tmp_path):
    """A chunked upstream response far beyond the request-side cap must
    relay in full (responses stream; only requests buffer)."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/public/.*", "remote_policies": [CLIENT_IDENTITY]}
            ])
            total = 6 * (1 << 20)  # 6 MiB > CHUNKED_BODY_LIMIT (4 MiB)
            chunk = b"z" * 65536
            up_srv = socket.socket()
            up_srv.bind(("127.0.0.1", 0))
            up_srv.listen(1)
            up_srv.settimeout(15)

            def upstream():
                try:
                    conn, _ = up_srv.accept()
                except OSError:
                    return
                conn.settimeout(5)
                buf = b""
                try:
                    while b"\r\n\r\n" not in buf:
                        buf += conn.recv(4096)
                    conn.sendall(b"HTTP/1.1 200 OK\r\ntransfer-encoding: chunked\r\n\r\n")
                    sent = 0
                    while sent < total:
                        conn.sendall(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                        sent += len(chunk)
                    conn.sendall(b"0\r\n\r\n")
                except OSError:
                    pass
                finally:
                    conn.close()

            t = threading.Thread(target=upstream, daemon=True)
            t.start()
            proxy = _proxy(m, xds_path, al_path, upstream=up_srv.getsockname())
            try:
                assert proxy.wait_ready()
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=30)
                c.settimeout(30)
                c.sendall(b"GET /public/big HTTP/1.1\r\nHost: h\r\n\r\n")
                got = 0
                data = b""
                while b"0\r\n\r\n" not in data[-16:] if data else True:
                    chunk_in = c.recv(1 << 16)
                    if not chunk_in:
                        break
                    got += len(chunk_in)
                    data = data[-16:] + chunk_in  # keep only the tail
                assert got > total, f"only {got} bytes relayed of >{total}"
                c.close()
                return got, _records(sink, 1)
            finally:
                proxy.close()
                up_srv.close()

    both(run)


def test_unknown_transfer_coding_rejected(tmp_path):
    """'Transfer-Encoding: notchunked' must get 501, not be parsed as
    chunked (token comparison, not suffix match)."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [{"path": "/.*", "remote_policies": [CLIENT_IDENTITY]}])
            proxy = _proxy(m, xds_path, al_path)
            try:
                assert proxy.wait_ready()
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
                c.settimeout(10)
                c.sendall(
                    b"POST /x HTTP/1.1\r\nHost: h\r\n"
                    b"transfer-encoding: notchunked\r\n\r\n"
                )
                d = b""
                while b"\r\n\r\n" not in d:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    d += chunk
                assert b" 501 " in d, d
                c.close()
                return d, len(sink.recent())
            finally:
                proxy.close()

    both(run)


def test_h2_forward_logs_upstream_status(tmp_path):
    """The access log for a forwarded H2 stream must carry the
    UPSTREAM's status code (not a synthesized 200)."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/public/.*", "remote_policies": [CLIENT_IDENTITY]}
            ])
            up_srv = socket.socket()
            up_srv.bind(("127.0.0.1", 0))
            up_srv.listen(1)
            up_srv.settimeout(15)

            def upstream():
                try:
                    conn, _ = up_srv.accept()
                except OSError:
                    return

                def on_request(h2, st):
                    h2.respond(st.id, 418, body=b"teapot")

                srv = m.h2.H2ServerConnection(conn, on_request)
                if srv.handshake():
                    srv.serve()

            t = threading.Thread(target=upstream, daemon=True)
            t.start()
            proxy = _proxy(m, xds_path, al_path, upstream=up_srv.getsockname())
            try:
                assert proxy.wait_ready()
                c = _H2TestClient(m, proxy_port)
                sid = c.request("GET", "/public/tea")
                resp = c.read_response(sid)
                h, body, _t = resp
                assert _status(h) == 418 and body == b"teapot"
                c.close()
                assert _wait_for(lambda: len(sink.recent()) >= 1)
                assert sink.recent()[-1].http["code"] == 418
                return resp, _records(sink, 1)
            finally:
                proxy.close()
                up_srv.close()

    both(run)


def test_502_with_pending_body_does_not_desync(tmp_path):
    """Upstream down + POST body still inbound: the proxy must not parse
    the body bytes as the next request head."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [
                {"path": "/public/.*", "remote_policies": [CLIENT_IDENTITY]}
            ])
            dead_port = _free_port()  # nothing listens here
            proxy = _proxy(m, xds_path, al_path, upstream=("127.0.0.1", dead_port))
            try:
                assert proxy.wait_ready()
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
                c.settimeout(10)
                body = b"GET /smuggled HTTP/1.1\r\nHost: h\r\n\r\n"  # 37 bytes
                c.sendall(
                    b"POST /public/a HTTP/1.1\r\nHost: h\r\n"
                    + f"content-length: {len(body)}\r\n\r\n".encode()
                )
                time.sleep(0.1)  # head parsed; body not yet sent
                c.sendall(body)
                d = b""
                while b"\r\n\r\n" not in d:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    d += chunk
                assert b" 502 " in d
                # a real second request must still work (connection either
                # drained-and-reusable or closed — never desynced)
                d2 = b""
                try:
                    c.sendall(b"GET /public/b HTTP/1.1\r\nHost: h\r\n\r\n")
                    while b"\r\n\r\n" not in d2:
                        chunk = c.recv(4096)
                        if not chunk:
                            break
                        d2 += chunk
                    if d2:
                        assert b" 502 " in d2  # parsed as /public/b, not /smuggled
                except OSError:
                    pass  # closed connection is also a valid non-desync outcome
                # the smuggled path must never appear in the access log:
                # both requests' records are in once the second is
                recs = _records(sink, 2 if d2 else 1)
                assert not any(r.http.get("path") == "/smuggled" for r in sink.recent()), [
                    r.http for r in sink.recent()]
                c.close()
                return d, d2, recs
            finally:
                proxy.close()

    both(run)


# -- TestUpgradeTunnel -------------------------------------------------------------


def test_101_switching_protocols_tunnels_raw_bytes(tmp_path):
    """An allowed Upgrade exchange: the upstream's 101 hands the
    connection to a raw bidirectional tunnel (WebSocket shape); bytes
    flow both ways with no HTTP framing."""
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [{"path": "/ws/.*", "remote_policies": [CLIENT_IDENTITY]}])
            up_srv = socket.socket()
            up_srv.bind(("127.0.0.1", 0))
            up_srv.listen(1)
            up_srv.settimeout(15)
            served = []

            def upstream():
                try:
                    conn, _ = up_srv.accept()
                except OSError:
                    return
                conn.settimeout(10)
                buf = b""
                try:
                    while b"\r\n\r\n" not in buf:
                        buf += conn.recv(4096)
                    served.append(buf)
                    conn.sendall(
                        b"HTTP/1.1 101 Switching Protocols\r\n"
                        b"Upgrade: websocket\r\nConnection: Upgrade\r\n\r\n"
                    )
                    # post-upgrade: echo frames with a marker, then push one
                    # unsolicited server->client message
                    data = conn.recv(4096)
                    conn.sendall(b"echo:" + data)
                    conn.sendall(b"server-push")
                    conn.recv(4096)  # wait for client close
                except OSError:
                    pass
                finally:
                    conn.close()

            t = threading.Thread(target=upstream, daemon=True)
            t.start()
            proxy = _proxy(m, xds_path, al_path, upstream=up_srv.getsockname())
            try:
                assert proxy.wait_ready()
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=15)
                c.settimeout(15)
                c.sendall(
                    b"GET /ws/chat HTTP/1.1\r\nHost: h\r\n"
                    b"Upgrade: websocket\r\nConnection: Upgrade\r\n\r\n"
                )
                head = b""
                while b"\r\n\r\n" not in head:
                    head += c.recv(4096)
                assert b" 101 " in head
                # raw bytes AFTER the upgrade: no HTTP parsing in the way
                c.sendall(b"\x81\x05hello")  # arbitrary non-HTTP bytes
                got = b""
                while b"server-push" not in got:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    got += chunk
                assert got.startswith(b"echo:\x81\x05hello"), got
                assert b"server-push" in got
                c.close()
                assert served and b"/ws/chat" in served[0]
                return head, got, served, _records(sink, 1)
            finally:
                proxy.close()
                up_srv.close()

    both(run)


def test_denied_upgrade_never_reaches_upstream(tmp_path):
    def run(m):
        with control_plane(m, tmp_path) as (cache, xds_path, al_path, sink):
            proxy_port = _free_port()
            _publish(m, cache, proxy_port, [{"path": "/ws/.*", "remote_policies": [CLIENT_IDENTITY]}])
            reached = []
            up_srv = socket.socket()
            up_srv.bind(("127.0.0.1", 0))
            up_srv.listen(1)
            up_srv.settimeout(3)

            def upstream():
                try:
                    conn, _ = up_srv.accept()
                    reached.append(True)
                    conn.close()
                except OSError:
                    pass

            t = threading.Thread(target=upstream, daemon=True)
            t.start()
            proxy = _proxy(m, xds_path, al_path, upstream=up_srv.getsockname())
            try:
                assert proxy.wait_ready()
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
                c.settimeout(10)
                c.sendall(
                    b"GET /admin/socket HTTP/1.1\r\nHost: h\r\n"
                    b"Upgrade: websocket\r\nConnection: Upgrade\r\n\r\n"
                )
                d = b""
                while b"\r\n\r\n" not in d:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    d += chunk
                assert b" 403 " in d
                c.close()
                recs = _records(sink, 1)
                time.sleep(0.5)  # what the upstream may still accept
                assert not reached, "denied upgrade reached the upstream"
                return d, recs
            finally:
                proxy.close()
                up_srv.close()

    both(run)
