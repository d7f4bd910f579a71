"""Port parity: node health probing (``health/``: ``HealthProber``, the
standalone endpoint process and its launcher).

``test_health_bugtool.py``'s 4 ``TestProber`` tests that build no
``Daemon`` run through both packages with equal reports. Then the port's
health child, ``python -m cilium_tpu_torch.health``, against a stub
agent (the port's ``api/unixhttp.UnixHTTPServer`` answering
``APIClient.node_list`` with two nodes: one whose health port is a live
``HealthResponder``, one on a closed port): it prints ``READY <port>``,
``/healthz`` answers, one ``/probe`` makes ``/status`` report one node
reachable and one not, equal to the JAX child's report against the same
stub; and the port's ``HealthLauncher`` (``proxy/launcher.py``) starts it
again after a SIGKILL. The ``Daemon`` tests move to A7c's bar:
``TestProber::test_attach_registry_starts_prober`` and
``test_cluster.py::TestStandaloneHealthProcess``. Every wait is a poll
or a READY line; sockets live under ``tmp_path``, the responder on port 0.
"""

from __future__ import annotations

import importlib
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from test_torch_harness import PKGS, REPO


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class FakeRegistry:
    def __init__(self, nodes):
        self.nodes = nodes

    def remote_nodes(self):
        return list(self.nodes)


def both(scenario):
    outs = [scenario(pkg) for pkg in PKGS]
    assert outs[0] == outs[1]
    return outs[0]


def _stable(rep):
    """A report without its clock readings."""
    return {**rep, "nodes": [{k: v for k, v in n.items() if k not in ("last_probe", "latency_s")}
                             for n in rep["nodes"]]}


# -- TestProber ------------------------------------------------------------------------


def test_probe_sweep_and_failures():
    def run(pkg):
        Node, HealthProber = _mod(pkg, "nodes.registry").Node, _mod(pkg, "health").HealthProber
        reg = FakeRegistry([Node(name="n1", ipv4="10.0.1.1", health_ip="10.0.1.100"),
                            Node(name="n2", ipv4="10.0.2.1")])
        up = {"10.0.1.100"}

        def probe(addr, port):
            if addr in up:
                return 0.0012
            raise OSError("connection refused")

        p = HealthProber(nodes=reg, probe=probe)
        p.probe_once()
        rep = p.report()
        assert rep["total"] == 2 and rep["reachable"] == 1
        by = {n["name"]: n for n in rep["nodes"]}
        assert by["n1"]["reachable"] and by["n1"]["latency_s"] > 0
        assert by["n1"]["address"] == "10.0.1.100"
        assert not by["n2"]["reachable"] and by["n2"]["failures"] == 1
        p.probe_once()
        assert p.report()["nodes"][1]["failures"] == 2
        second = p.report()
        up.add("10.0.2.1")
        p.probe_once()
        by = {n["name"]: n for n in p.report()["nodes"]}
        assert by["n2"]["reachable"] and by["n2"]["failures"] == 0
        return [_stable(rep), _stable(second), _stable(p.report())]

    both(run)


def test_departed_nodes_forgotten():
    def run(pkg):
        Node, HealthProber = _mod(pkg, "nodes.registry").Node, _mod(pkg, "health").HealthProber
        reg = FakeRegistry([Node(name="n1", ipv4="10.0.1.1")])
        p = HealthProber(nodes=reg, probe=lambda a, q: 0.001)
        p.probe_once()
        assert p.report()["total"] == 1
        first = _stable(p.report())
        reg.nodes = []
        p.probe_once()
        assert p.report()["total"] == 0
        return [first, p.report()]

    both(run)


def test_standalone_empty():
    def run(pkg):
        p = _mod(pkg, "health").HealthProber()
        p.probe_once()
        assert p.report() == {"nodes": [], "reachable": 0, "total": 0}
        return p.report()

    both(run)


def test_restartable_after_stop():
    def run(pkg):
        Node, HealthProber = _mod(pkg, "nodes.registry").Node, _mod(pkg, "health").HealthProber
        reg = FakeRegistry([Node(name="n1", ipv4="10.0.1.1")])
        fired = threading.Event()

        def probe(a, q):
            fired.set()
            return 0.001

        p = HealthProber(nodes=reg, probe=probe)
        p.start(interval=30)
        assert fired.wait(5)
        p.stop()
        fired.clear()
        p.start(interval=30)
        assert fired.wait(5)
        p.stop()
        return _stable(p.report())

    both(run)


# -- the health child -------------------------------------------------------------------


@pytest.fixture
def stub_agent(tmp_path):
    """The agent a health child asks for the topology: node "up" on a live
    HealthResponder, node "down" on a port nothing listens on → (agent
    socket, responder)."""
    unixhttp = _mod("cilium_tpu_torch", "api.unixhttp")
    responder = _mod("cilium_tpu_torch", "health.standalone").HealthResponder(
        "127.0.0.1", 0).start()
    with socket.socket() as s:  # a port that was free: nothing listens on it
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    nodes = [{"name": "up", "cluster": "default", "ipv4": "127.0.0.1", "health_ip": "127.0.0.1",
              "health_port": responder.port},
             {"name": "down", "cluster": "default", "ipv4": "127.0.0.1",
              "health_ip": "127.0.0.1", "health_port": closed}]

    class Handler(unixhttp.UnixHandler):
        def do_GET(self):
            if self.path == "/node":
                self._json(200, nodes)
            else:
                self._json(404, {"error": "not found"})

    sock = str(tmp_path / "agent.sock")
    srv = unixhttp.UnixHTTPServer(sock, Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield sock, responder
    srv.shutdown()
    srv.server_close()
    responder.stop()


def _wait(fn, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            out = fn()
            if out:
                return out
        except OSError:
            pass
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.05)


def _child_report(pkg, agent_sock, api_sock):
    """Spawn ``python -m <pkg>.health``, read its READY line, then
    /healthz, one /probe and /status → (READY port, healthz, probed,
    status)."""
    p = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.health", "--agent", agent_sock, "--api", api_sock,
         "--listen-ip", "127.0.0.1", "--port", "0", "--interval", "3600"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        line = p.stdout.readline().split()
        assert line and line[0] == "READY", p.stderr.read()
        c = _mod("cilium_tpu_torch", "health.standalone").HealthAPIClient(api_sock)
        healthz = _mod("cilium_tpu_torch", "api.client").APIClient(api_sock)._request(
            "GET", "/healthz")
        probed = c.probe()
        status = c.status()
        assert status["port"] == int(line[1])
        return int(line[1]), healthz, probed, status
    finally:
        p.terminate()
        p.wait(timeout=10)


def test_health_child_ready_status_and_parity(stub_agent, tmp_path):
    """The port's child and the JAX child against the same stub agent:
    READY, /healthz, and after one /probe one node reachable and one not,
    equal reports."""
    agent_sock, responder = stub_agent
    reps = []
    for pkg in PKGS:
        port, healthz, probed, status = _child_report(pkg, agent_sock,
                                                      str(tmp_path / f"{pkg}.sock"))
        assert port > 0 and healthz == {"ok": True} and probed == {"probed": 2}
        assert status["total"] == 2 and status["reachable"] == 1
        by = {n["name"]: n for n in status["nodes"]}
        assert by["up"]["reachable"] and not by["down"]["reachable"]
        assert by["down"]["failures"] >= 1 and by["down"]["error"]
        reps.append({k: v for k, v in _stable(status).items()
                     if k not in ("uptime_s", "port", "probes_answered")})
    assert reps[0] == reps[1]
    assert responder.accepted >= 2


def test_health_launcher_restarts_the_child(stub_agent, tmp_path):
    """``HealthLauncher`` spawns ``python -m cilium_tpu_torch.health`` (its
    stdout goes nowhere, so the API socket answering is its READY); after
    a SIGKILL the launcher starts it again and the new child serves."""
    agent_sock, _responder = stub_agent
    api_sock = str(tmp_path / "health.sock")
    launcher_mod = _mod("cilium_tpu_torch", "proxy.launcher")
    c = _mod("cilium_tpu_torch", "health.standalone").HealthAPIClient(api_sock, timeout=5)
    healthz = _mod("cilium_tpu_torch", "api.client").APIClient(api_sock, timeout=5)
    hl = launcher_mod.HealthLauncher(agent_sock, api_sock, restart_backoff_s=0.2).start()
    try:
        assert _wait(lambda: healthz._request("GET", "/healthz")) == {"ok": True}
        first = hl.pid()
        assert c.probe() == {"probed": 2}
        st = c.status()
        assert (st["total"], st["reachable"]) == (2, 1)
        os.kill(first, signal.SIGKILL)
        _wait(lambda: hl.restarts == 1 and hl.pid() not in (None, first))
        assert _wait(lambda: healthz._request("GET", "/healthz")) == {"ok": True}
        assert c.probe() == {"probed": 2}
        st = c.status()
        assert (st["total"], st["reachable"]) == (2, 1)
        assert hl.restarts == 1
    finally:
        hl.stop()
    assert hl.pid() is None
