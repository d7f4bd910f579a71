"""The port's external proxy process: a second process
(``python -m cilium_tpu_torch.proxy``) subscribes NPDS / NPHDS over the
xDS socket, enforces HTTP and Kafka on real TCP connections and streams
its access log back over the access-log socket.

The 9 tests of the reference's ``test_external_proxy.py`` run against
the port with the reference's assertions: its child with ``--device
cpu``, ``ProxyLauncher(..., extra_args=["--device", "cpu"])`` and an
in-process ``StandaloneProxy(..., device="cpu")``, each behind the port's
``XDSServer`` and ``AccessLogSocketServer``. Where the reference waits
on a fixed sleep, these copies wait on ``READY``, on a completion or on
a ``_wait_for`` poll. One test sends the same request sequence through
the JAX package's child and the port's (allowed, denied, an unmapped
source, Kafka reject and ack, a policy swap): equal statuses, Kafka
answers and access-log records (every field but the timestamp). Without
``--device`` the port's child asks for the card, and where there is none
it exits non-zero before ``READY``. Tolerance 0: every value compared is
an integer, a string, bytes or a bool.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest
import torch

from cilium_tpu_torch.proxy.accesslog import AccessLogServer, AccessLogSocketServer
from cilium_tpu_torch.proxy.launcher import ProxyLauncher
from cilium_tpu_torch.proxy.standalone import StandaloneProxy
from cilium_tpu_torch.xds.cache import (
    NETWORK_POLICY_HOSTS_TYPE,
    NETWORK_POLICY_TYPE,
    ResourceCache,
)
from cilium_tpu_torch.xds.server import XDSServer
from test_torch_harness import PKGS, REPO

CLIENT_IDENTITY = 1001
CPU = ["--device", "cpu"]
START_S = 60.0  # a child's interpreter start and imports on a loaded host


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http_get(port: int, path: str, source: str = "127.0.0.1") -> int:
    """One HTTP/1.1 GET over a raw socket → status code. ``source``
    selects the loopback alias to bind (the NPHDS identity input)."""
    c = socket.socket()
    c.bind((source, 0))
    c.settimeout(60.0)
    c.connect(("127.0.0.1", port))
    c.sendall(f"GET {path} HTTP/1.1\r\nHost: svc.local\r\n\r\n".encode())
    data = b""
    while b"\r\n" not in data:
        chunk = c.recv(4096)
        if not chunk:
            break
        data += chunk
    c.close()
    return int(data.split(b" ", 2)[1])


def _try_get(port: int, path: str, source: str = "127.0.0.1"):
    """_http_get, but None while the listener isn't up yet (poll-safe
    for _wait_for conditions)."""
    try:
        return _http_get(port, path, source)
    except OSError:
        return None


def _world_ports(proxy_port: int, kafka_port: int = 0):
    """NPDS: endpoint 7 allows only /public/* from CLIENT_IDENTITY on
    port 80 (and only topic "allowed" on 9092)."""
    l7_ports = [{
        "port": 80, "ingress": True, "parser": "http", "proxy_port": proxy_port,
        "http_rules": [{"path": "/public/.*", "remote_policies": [CLIENT_IDENTITY]}],
    }]
    if kafka_port:
        l7_ports.append({
            "port": 9092, "ingress": True, "parser": "kafka", "proxy_port": kafka_port,
            "kafka_rules": [{"topic": "allowed", "remote_policies": [CLIENT_IDENTITY]}],
        })
    return l7_ports


def _publish_world(cache, proxy_port: int, kafka_port: int = 0, types=None):
    """NPDS as above; NPHDS: 127.0.0.1 = client identity, 127.0.0.2
    stays unmapped (world)."""
    npds, nphds = types or (NETWORK_POLICY_TYPE, NETWORK_POLICY_HOSTS_TYPE)
    cache.upsert(npds, "7", {"endpoint_id": 7, "l7_ports": _world_ports(proxy_port, kafka_port)})
    cache.upsert(nphds, str(CLIENT_IDENTITY),
                 {"policy": CLIENT_IDENTITY, "host_addresses": ["127.0.0.1/32"]})


def _widen(cache, proxy_port: int, npds=NETWORK_POLICY_TYPE) -> int:
    """Allow every path on the HTTP port."""
    return cache.upsert(npds, "7", {
        "endpoint_id": 7,
        "l7_ports": [{
            "port": 80, "ingress": True, "parser": "http", "proxy_port": proxy_port,
            "http_rules": [{"path": "/.*", "remote_policies": [CLIENT_IDENTITY]}],
        }],
    })


@pytest.fixture
def control_plane(tmp_path):
    """Agent-side xDS server + access-log receiver."""
    xds_path = str(tmp_path / "xds.sock")
    al_path = str(tmp_path / "accesslog.sock")
    cache = ResourceCache()
    server = XDSServer(cache, xds_path)
    server.start()
    sink = AccessLogServer()
    rx = AccessLogSocketServer(sink, al_path).start()
    yield cache, xds_path, al_path, sink
    rx.stop()
    server.stop()


def _wait_for(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _child(xds_path: str, al_path: str, pkg: str = "cilium_tpu_torch", env=None):
    argv = [sys.executable, "-m", f"{pkg}.proxy", "--xds", xds_path, "--accesslog", al_path]
    if pkg == "cilium_tpu_torch":
        argv += CPU
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                            cwd=REPO, env=env)


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def _produce(topic: str, cid: int) -> bytes:
    body = struct.pack(">hhi", 0, 0, cid)
    body += struct.pack(">h", 1) + b"c"  # client id
    body += struct.pack(">hi", 1, 30000)  # acks, timeout
    body += struct.pack(">i", 1)
    body += struct.pack(">h", len(topic)) + topic.encode()
    body += struct.pack(">i", 1)
    body += struct.pack(">ii", 0, 4) + b"\x00" * 4
    return struct.pack(">i", len(body)) + body


def _kafka_answer(c) -> bytes:
    hdr = c.recv(4)
    (size,) = struct.unpack(">i", hdr)
    body = b""
    while len(body) < size:
        body += c.recv(size - len(body))
    return body


# -- TestExternalProcess -------------------------------------------------------


class TestExternalProcess:
    def test_second_process_enforces_403_and_streams_logs(self, control_plane):
        cache, xds_path, al_path, sink = control_plane
        proxy_port = _free_port()
        _publish_world(cache, proxy_port)
        proc = _child(xds_path, al_path)
        try:
            assert proc.stdout.readline().strip() == "READY"
            # Each request's record is awaited before the next request:
            # records from concurrent connections have no defined order.
            # allowed: client identity + allowed path
            assert _http_get(proxy_port, "/public/index") == 200
            assert _wait_for(lambda: len(sink.recent()) >= 1, timeout=30)
            # denied path → 403 from the OTHER process
            assert _http_get(proxy_port, "/secret") == 403
            assert _wait_for(lambda: len(sink.recent()) >= 2, timeout=30)
            # denied identity (unmapped 127.0.0.2 → world) → 403
            assert _http_get(proxy_port, "/public/index", source="127.0.0.2") == 403
            # access logs crossed the process boundary
            assert _wait_for(lambda: len(sink.recent()) >= 3, timeout=30)
            recs = sink.recent()
            verdicts = [r.verdict for r in recs[-3:]]
            assert verdicts == ["Forwarded", "Denied", "Denied"]
            assert recs[-3].src_identity == CLIENT_IDENTITY
            assert recs[-3].http["code"] == 200
            assert recs[-2].http["code"] == 403
        finally:
            _stop(proc)

    def test_policy_update_swaps_enforcement_live(self, control_plane):
        """An NPDS push while the child runs changes its verdicts without
        a restart (the ACK'd dynamic-update contract)."""
        cache, xds_path, al_path, sink = control_plane
        proxy_port = _free_port()
        _publish_world(cache, proxy_port)
        proc = _child(xds_path, al_path)
        try:
            assert proc.stdout.readline().strip() == "READY"
            assert _http_get(proxy_port, "/secret") == 403
            # widen the policy: allow everything on the port
            _widen(cache, proxy_port)
            assert _wait_for(lambda: _try_get(proxy_port, "/secret") == 200, timeout=5.0)
        finally:
            _stop(proc)


# -- TestLauncher --------------------------------------------------------------


class TestLauncher:
    def test_launcher_restarts_killed_child(self, control_plane):
        cache, xds_path, al_path, _sink = control_plane
        proxy_port = _free_port()
        _publish_world(cache, proxy_port)
        launcher = ProxyLauncher(xds_path, al_path, extra_args=CPU, restart_backoff_s=0.1).start()
        try:
            assert _wait_for(lambda: launcher.pid() is not None)
            pid1 = launcher.pid()
            assert _wait_for(lambda: _try_get(proxy_port, "/public/x") == 200, timeout=START_S)
            os.kill(pid1, signal.SIGKILL)
            assert _wait_for(lambda: launcher.pid() not in (None, pid1), timeout=10.0), (
                "launcher did not respawn the proxy")
            assert launcher.restarts >= 1
            # the respawned child re-subscribes and enforces again
            assert _wait_for(lambda: _try_get(proxy_port, "/public/x") == 200, timeout=START_S)
        finally:
            launcher.stop()


# -- TestKafkaWire -------------------------------------------------------------


class TestKafkaWire:
    def test_kafka_reject_and_upstream_relay(self, control_plane):
        """Kafka over real sockets: a denied topic gets a synthesized
        reject frame; an allowed topic is forwarded to the upstream broker
        and its response relayed back (pkg/proxy/kafka.go)."""
        cache, xds_path, al_path, sink = control_plane
        kafka_port = _free_port()
        _publish_world(cache, _free_port(), kafka_port=kafka_port)
        # fake broker, listening before the proxy can dial it: echo a
        # fixed response frame per request
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(4)
        srv.settimeout(START_S)
        upstream_port = srv.getsockname()[1]

        def broker():
            try:
                conn, _ = srv.accept()
                while True:
                    hdr = conn.recv(4)
                    if len(hdr) < 4:
                        return
                    (size,) = struct.unpack(">i", hdr)
                    body = b""
                    while len(body) < size:
                        chunk = conn.recv(size - len(body))
                        if not chunk:
                            return
                        body += chunk
                    cid = struct.unpack(">i", body[4:8])[0]
                    resp = struct.pack(">i", cid) + b"BROKER"
                    conn.sendall(struct.pack(">i", len(resp)) + resp)
            except OSError:
                pass
            finally:
                srv.close()

        t = threading.Thread(target=broker, daemon=True)
        t.start()
        proxy = StandaloneProxy(xds_path, al_path, upstream=("127.0.0.1", upstream_port),
                                device="cpu")
        try:
            assert proxy.wait_ready()
            c = socket.create_connection(("127.0.0.1", kafka_port), timeout=START_S)
            # denied topic → reject frame with correlation id + error 29
            c.sendall(_produce("forbidden", 42))
            body = _kafka_answer(c)
            assert struct.unpack(">i", body[:4])[0] == 42
            assert struct.pack(">h", 29) in body  # authorization failed
            # allowed topic → relayed broker response
            c.sendall(_produce("allowed", 43))
            body = _kafka_answer(c)
            assert struct.unpack(">i", body[:4])[0] == 43
            assert body[4:] == b"BROKER"
            c.close()
            assert _wait_for(lambda: len(sink.recent()) >= 2)
            v = [r.verdict for r in sink.recent()[-2:]]
            assert v == ["Denied", "Forwarded"]
        finally:
            proxy.close()
            srv.close()


# -- TestKeepAlive -------------------------------------------------------------


class TestKeepAlive:
    def test_multiple_requests_one_connection(self, control_plane):
        """HTTP/1.1 keep-alive: one TCP connection carries several
        requests, each policy-checked independently; Connection: close
        ends it."""
        cache, xds_path, al_path, sink = control_plane
        proxy_port = _free_port()
        _publish_world(cache, proxy_port)
        proxy = StandaloneProxy(xds_path, al_path, device="cpu")
        try:
            assert proxy.wait_ready()
            c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
            c.settimeout(10)

            def roundtrip(path, body=b"", close=False):
                hdrs = f"POST {path} HTTP/1.1\r\nHost: h\r\ncontent-length: {len(body)}\r\n"
                if close:
                    hdrs += "Connection: close\r\n"
                c.sendall(hdrs.encode() + b"\r\n" + body)
                data = b""
                while b"\r\n\r\n" not in data:
                    data += c.recv(4096)
                head, _, rest = data.partition(b"\r\n\r\n")
                clen = int([ln for ln in head.split(b"\r\n")
                            if ln.lower().startswith(b"content-length")][0].split(b":")[1])
                while len(rest) < clen:
                    rest += c.recv(4096)
                return int(head.split(b" ")[1])

            assert roundtrip("/public/a", body=b"xyz") == 200
            assert roundtrip("/secret") == 403  # same connection
            assert roundtrip("/public/b") == 200  # still alive after a 403
            assert roundtrip("/public/c", close=True) == 200
            # server honors Connection: close
            assert c.recv(4096) == b""
            c.close()
        finally:
            proxy.close()

    def test_pipelined_requests(self, control_plane):
        """Two requests sent back-to-back before reading: the carry
        buffer must hand request 2's head to the next iteration."""
        cache, xds_path, al_path, sink = control_plane
        proxy_port = _free_port()
        _publish_world(cache, proxy_port)
        proxy = StandaloneProxy(xds_path, al_path, device="cpu")
        try:
            assert proxy.wait_ready()
            c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
            c.settimeout(10)
            c.sendall(b"GET /public/1 HTTP/1.1\r\nHost: h\r\n\r\n"
                      b"GET /secret HTTP/1.1\r\nHost: h\r\n\r\n")
            data = b""
            deadline = time.monotonic() + 10
            while data.count(b"HTTP/1.1") < 2 and time.monotonic() < deadline:
                data += c.recv(4096)
            codes = [int(seg.split(b" ")[0]) for seg in data.split(b"HTTP/1.1 ")[1:]]
            assert codes == [200, 403], codes
            c.close()
        finally:
            proxy.close()


def test_pipelined_bytes_never_smuggled_upstream(control_plane):
    """With an upstream configured, the over-read tail of an allowed
    request (a pipelined second request policy would deny) must not be
    relayed upstream unchecked: only the current request's bytes go."""
    cache, xds_path, al_path, sink = control_plane
    proxy_port = _free_port()
    _publish_world(cache, proxy_port)
    # capture-everything upstream
    up_srv = socket.socket()
    up_srv.bind(("127.0.0.1", 0))
    up_srv.listen(1)
    got = []

    def upstream():
        conn, _ = up_srv.accept()
        conn.settimeout(2)
        buf = b""
        try:
            while True:
                chunk = conn.recv(4096)
                if not chunk:
                    break
                buf += chunk
                conn.sendall(b"HTTP/1.1 200 OK\r\ncontent-length: 0\r\n\r\n")
        except socket.timeout:
            pass
        got.append(buf)
        conn.close()

    t = threading.Thread(target=upstream, daemon=True)
    t.start()
    proxy = StandaloneProxy(xds_path, al_path, upstream=up_srv.getsockname(), device="cpu")
    try:
        assert proxy.wait_ready()
        c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
        c.settimeout(10)
        body = b"xy"
        c.sendall(
            b"POST /public/a HTTP/1.1\r\nHost: h\r\ncontent-length: 2\r\n\r\n"
            + body
            + b"GET /secret HTTP/1.1\r\nHost: h\r\n\r\n"  # pipelined, denied
        )
        # the reference sleeps 1 s here; both answers (the relayed 200,
        # the local 403) show the proxy has handled both requests
        data = b""
        while data.count(b"HTTP/1.1 ") < 2:
            chunk = c.recv(4096)
            if not chunk:
                break
            data += chunk
        assert b" 403 " in data
        c.close()
        t.join(timeout=5)
        assert got, "upstream saw nothing"
        assert b"/public/a" in got[0]
        assert b"/secret" not in got[0], "pipelined request smuggled upstream"
    finally:
        proxy.close()
        up_srv.close()


# -- TestFramingStrictness -----------------------------------------------------


class TestFramingStrictness:
    def test_policy_update_applies_to_live_keepalive_connection(self, control_plane):
        """An NPDS push must change verdicts for the NEXT request on an
        ALREADY-OPEN keep-alive connection (stale-policy regression)."""
        cache, xds_path, al_path, sink = control_plane
        proxy_port = _free_port()
        _publish_world(cache, proxy_port)
        proxy = StandaloneProxy(xds_path, al_path, device="cpu")
        try:
            assert proxy.wait_ready()
            c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
            c.settimeout(10)

            def get(path):
                c.sendall(f"GET {path} HTTP/1.1\r\nHost: h\r\n\r\n".encode())
                d = b""
                while b"\r\n\r\n" not in d:
                    d += c.recv(4096)
                while not (b"OK\n" in d or b"denied" in d):
                    d += c.recv(4096)
                return int(d.split(b" ")[1])

            assert get("/secret") == 403
            # widen the policy while the connection stays open
            _widen(cache, proxy_port)
            # a request already waiting on the connection holds the
            # policy it read before the push: poll
            assert _wait_for(lambda: get("/secret") == 200, timeout=10)  # same connection
            c.close()
        finally:
            proxy.close()

    def test_duplicate_and_invalid_content_length_rejected(self, control_plane):
        """CL.CL smuggling / parser-desync inputs get 400 + close."""
        cache, xds_path, al_path, sink = control_plane
        proxy_port = _free_port()
        _publish_world(cache, proxy_port)
        proxy = StandaloneProxy(xds_path, al_path, device="cpu")
        try:
            assert proxy.wait_ready()
            for bad in (
                b"POST /public/a HTTP/1.1\r\nHost: h\r\n"
                b"content-length: 0\r\ncontent-length: 60\r\n\r\n",
                b"POST /public/a HTTP/1.1\r\nHost: h\r\n"
                b"content-length: -5\r\n\r\n",
                b"POST /public/a HTTP/1.1\r\nHost: h\r\n"
                b"content-length: 5, 5\r\n\r\n",
            ):
                c = socket.create_connection(("127.0.0.1", proxy_port), timeout=10)
                c.settimeout(10)
                c.sendall(bad)
                d = b""
                while b"\r\n\r\n" not in d:
                    chunk = c.recv(4096)
                    if not chunk:
                        break
                    d += chunk
                assert b" 400 " in d, (bad, d)
                assert c.recv(4096) == b""  # connection closed
                c.close()
        finally:
            proxy.close()


# -- the JAX package's child and the port's, on one sequence -------------------


def _sequence(pkg: str, tmp_path):
    """Spawn ``pkg``'s child behind ``pkg``'s control plane and send it:
    an allowed GET, a denied path, an unmapped source, a denied and an
    allowed Kafka produce, then (after the widened policy's ACK) the
    denied path again and the unmapped source again. → (statuses, Kafka
    answers, access-log records without timestamps)."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    cache_mod, al_mod = mod("xds.cache"), mod("proxy.accesslog")
    types = (cache_mod.NETWORK_POLICY_TYPE, cache_mod.NETWORK_POLICY_HOSTS_TYPE)
    xds_path, al_path = str(tmp_path / f"x-{pkg}.sock"), str(tmp_path / f"a-{pkg}.sock")
    cache = cache_mod.ResourceCache()
    server = mod("xds.server").XDSServer(cache, xds_path)
    server.start()
    sink = al_mod.AccessLogServer()
    rx = al_mod.AccessLogSocketServer(sink, al_path).start()
    http_port, kafka_port = _free_port(), _free_port()
    _publish_world(cache, http_port, kafka_port, types)
    proc = _child(xds_path, al_path, pkg)
    statuses, answers = [], []

    def logged(n):
        assert _wait_for(lambda: len(sink.recent()) >= n, timeout=30)

    try:
        assert proc.stdout.readline().strip() == "READY"
        for path, src in (("/public/index", "127.0.0.1"), ("/secret", "127.0.0.1"),
                          ("/public/index", "127.0.0.2")):
            statuses.append(_http_get(http_port, path, src))
            logged(len(statuses))
        c = socket.create_connection(("127.0.0.1", kafka_port), timeout=30)
        for topic, cid in (("forbidden", 42), ("allowed", 43)):
            c.sendall(_produce(topic, cid))
            answers.append(_kafka_answer(c))
            logged(len(statuses) + len(answers))
        c.close()
        version = _widen(cache, http_port, types[0])
        wg = mod("utils.completion").WaitGroup()
        server.wait_for_ack(types[0], version, "external-proxy", wg.add())
        assert wg.wait(timeout=30)
        for path, src in (("/secret", "127.0.0.1"), ("/public/index", "127.0.0.2")):
            statuses.append(_http_get(http_port, path, src))
            logged(len(statuses) + len(answers))
        recs = []
        for r in sink.recent():
            d = dataclasses.asdict(r)
            del d["timestamp"]
            recs.append(d)
        return statuses, answers, recs
    finally:
        _stop(proc)
        rx.stop()
        server.stop()


def test_jax_child_and_port_child_answer_alike(tmp_path):
    j, t = (_sequence(pkg, tmp_path) for pkg in PKGS)
    assert t == j
    statuses, answers, recs = t
    assert statuses == [200, 403, 403, 200, 403]
    assert struct.pack(">h", 29) in answers[0] and answers[1] == struct.pack(">i", 43)
    assert [r["verdict"] for r in recs] == ["Forwarded", "Denied", "Denied", "Denied",
                                            "Forwarded", "Forwarded", "Denied"]
    assert [r["src_identity"] for r in recs] == [CLIENT_IDENTITY] * 2 + [2] + [
        CLIENT_IDENTITY] * 3 + [2]


# -- the device ----------------------------------------------------------------


def test_child_without_a_card_exits_before_ready(control_plane):
    """No ``--device``: the child asks for the card; with no CUDA device
    visible it exits non-zero and never prints READY (it does not wait
    for an NPDS push, nor carry on on the CPU)."""
    cache, xds_path, al_path, _sink = control_plane
    _publish_world(cache, _free_port())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cilium_tpu_torch.proxy", "--xds", xds_path, "--accesslog", al_path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
    )
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0
    assert "READY" not in out
    assert "CUDA" in err


def test_main_resolves_the_device_before_subscribing(monkeypatch, tmp_path):
    """``main()`` resolves the device before it connects to the xDS
    socket: with no card, it raises with no agent listening at all."""
    from cilium_tpu_torch.proxy import standalone

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(standalone, "StandaloneProxy", lambda *a, **kw: called.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        standalone.main(["--xds", str(tmp_path / "nobody.sock")])
    assert not called


# -- test_proxy_integration.py, and on to the proxy process --------------------


def _full_l7_slice(pkg: str, tmp_path):
    """The reference's ``test_full_l7_slice`` through ``pkg``, then the
    regenerated endpoint's NPDS resource through ``pkg``'s XDSServer
    into an in-process StandaloneProxy, and the same three requests
    over sockets (NPHDS maps 127.0.0.1 to the client, 127.0.0.3 to the
    other identity)."""
    import importlib

    import numpy as np

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if pkg == "cilium_tpu_torch" else {}
    api, labels = mod("policy.api"), mod("labels")
    datapath, xds = mod("datapath"), mod("xds")
    repo = mod("policy.repository").Repository()
    http = api.L7Rules(http=(api.HTTPRule(method="GET", path="/api/.*"),))
    repo.add_list([
        api.rule(["k8s:app=web"], ingress=[api.IngressRule(
            from_endpoints=(api.EndpointSelector.make(["k8s:app=client"]),),
            to_ports=(api.PortRule(ports=(api.PortProtocol(80, "TCP"),), rules=http),),
        )]),
    ])
    reg = mod("identity").IdentityRegistry()
    client = reg.allocate(labels.parse_label_array(["k8s:app=client"]))
    other = reg.allocate(labels.parse_label_array(["k8s:app=other"]))
    web = reg.allocate(labels.parse_label_array(["k8s:app=web"]))
    ipc = mod("ipcache")
    cache = ipc.IPCache()
    cache.upsert("10.0.0.1", client.id, ipc.SOURCE_AGENT)
    pipe = datapath.DatapathPipeline(mod("engine").PolicyEngine(repo, reg, **kw), cache, **kw)
    proxy = mod("proxy").Proxy()
    ep = mod("endpoint").Endpoint(1, labels.parse_label_array(["k8s:app=web"]))
    ep.set_identity(web)
    pipe.set_endpoints([(ep.id, web.id)])
    assert ep.regenerate(pipe, proxy=proxy)
    # the redirect exists for 80/ingress with the compiled policy
    r = proxy.lookup(1, 80, ingress=True)
    assert r is not None and r.parser == "http"
    # the datapath redirects flows from the client on port 80
    v, red = pipe.process(
        mod("ops.lpm").ip_strings_to_u32(["10.0.0.1"]), np.zeros(1, np.int32),
        np.array([80], np.int32), np.array([6], np.int32),
    )
    assert int(v[0]) == datapath.FORWARD and bool(red[0])
    # L7 enforcement through the redirect
    l7 = mod("l7")
    allows = proxy.check_http(r, [
        l7.HTTPRequest("GET", "/api/x", src_identity=client.id),
        l7.HTTPRequest("POST", "/api/x", src_identity=client.id),
        l7.HTTPRequest("GET", "/api/x", src_identity=other.id),
    ])
    assert list(allows) == [True, False, False]
    # the same policy through xDS to the proxy process's code
    res = xds.endpoint_policy_resource(ep.id, proxy)
    port = _free_port()
    res["l7_ports"][0]["proxy_port"] = port
    xcache = xds.ResourceCache()
    server = xds.XDSServer(xcache, str(tmp_path / f"l7-{pkg}.sock"))
    server.start()
    sp = None
    try:
        xcache.upsert(xds.NETWORK_POLICY_TYPE, str(ep.id), res)
        for ident, addr in ((client.id, "127.0.0.1/32"), (other.id, "127.0.0.3/32")):
            xcache.upsert(xds.NETWORK_POLICY_HOSTS_TYPE, str(ident),
                          {"policy": ident, "host_addresses": [addr]})
        sp = mod("proxy.standalone").StandaloneProxy(server.socket_path, **kw)
        assert sp.wait_ready()
        assert sp.client.wait_applied(xds.NETWORK_POLICY_HOSTS_TYPE,
                                      xcache.version(xds.NETWORK_POLICY_HOSTS_TYPE))
        statuses = []
        for method, source in (("GET", "127.0.0.1"), ("POST", "127.0.0.1"), ("GET", "127.0.0.3")):
            c = socket.socket()
            c.bind((source, 0))
            c.settimeout(30)
            c.connect(("127.0.0.1", port))
            c.sendall(f"{method} /api/x HTTP/1.1\r\nHost: web\r\n\r\n".encode())
            data = b""
            while b"\r\n" not in data:
                data += c.recv(4096)
            c.close()
            statuses.append(int(data.split(b" ", 2)[1]))
        assert statuses == [200, 403, 403]
    finally:
        if sp is not None:
            sp.close()
        server.stop()
    # a policy change removes the L7 rule: the redirect goes
    repo.rules.clear()
    repo.add_list([api.rule(["k8s:app=web"], ingress=[
        api.IngressRule(from_endpoints=(api.EndpointSelector.make(["k8s:app=client"]),)),
    ])])
    assert ep.regenerate(pipe, proxy=proxy)
    assert proxy.lookup(1, 80, ingress=True) is None
    del res["l7_ports"][0]["proxy_port"]
    return list(allows), res, statuses, xds.endpoint_policy_resource(ep.id, proxy)


def test_full_l7_slice_through_the_proxy_process(tmp_path):
    j, t = (_full_l7_slice(pkg, tmp_path) for pkg in PKGS)
    assert t == j
