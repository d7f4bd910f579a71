"""Standalone per-node health endpoint — its own PROCESS.

Reference: cilium-health (cilium-health/main.go + cmd/) and
pkg/health/server/prober.go:40,229,262 — a separate daemon per node
that

- ANSWERS other nodes' connectivity probes on the node health port
  (the TCP side of prober.go:262; ICMP is the kernel's job),
- PROBES every node it learns about from its local agent's API
  (prober.go runProbe over the agent-provided topology),
- serves its results over its OWN unix-socket REST API
  (GET /status, POST /probe — the cilium-health CLI surface),

and is launched/supervised by the agent exactly like the external
proxy (pkg/launcher). Run as::

    python -m cilium_tpu_torch.health --agent <agent.sock> \
        --api <health.sock> [--listen-ip IP] [--port 4240]
"""

from __future__ import annotations

import socket
import threading
import time
from typing import List, Optional

from ..api.unixhttp import UnixHandler, UnixHTTPServer
from ..utils.logging import get_logger
from .prober import DEFAULT_HEALTH_PORT, HealthProber, tcp_probe

log = get_logger("health-endpoint")


class HealthResponder:
    """The probe TARGET: a TCP listener on the node health port. A
    remote prober's connect() completing IS the signal; a one-line
    banner is written so humans poking the port see who answered."""

    def __init__(self, host: str = "0.0.0.0", port: int = DEFAULT_HEALTH_PORT):
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        self._srv = socket.socket(family, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self.accepted = 0  # probes answered (telemetry)

    def start(self) -> "HealthResponder":
        threading.Thread(target=self._loop, daemon=True).start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _peer = self._srv.accept()
            except OSError:
                if self._stop.is_set():
                    return
                # transient accept failure (ECONNABORTED, fd pressure):
                # the port is still advertised — keep serving. A closed
                # listener raises continuously; the stop flag (set by
                # stop(), which closes it) breaks the loop then.
                if self._srv.fileno() < 0:
                    return  # socket gone without stop(): nothing to serve
                time.sleep(0.05)
                continue
            self.accepted += 1
            try:
                conn.sendall(b"cilium-health ok\n")
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass


class _AgentNodeView:
    """Adapter: the agent's ``node list`` API → the ``remote_nodes()``
    shape HealthProber consumes (the reference's health server pulls
    topology from its local agent the same way)."""

    class _Node:
        def __init__(self, d: dict) -> None:
            self.name = d.get("name", "")
            self.cluster = d.get("cluster", "default")
            self.ipv4 = d.get("ipv4")
            self.ipv6 = d.get("ipv6")
            self.health_ip = d.get("health_ip") or None
            self.health_port = d.get("health_port") or None

    def __init__(self, agent_socket: str) -> None:
        self._path = agent_socket
        self._cached: List[dict] = []

    def remote_nodes(self):
        from ..api.client import APIClient, APIError

        try:
            self._cached = APIClient(self._path, timeout=5.0).node_list()
        except (OSError, APIError, ValueError):
            pass  # agent briefly down: keep probing the last topology
        return [self._Node(d) for d in self._cached]


class HealthEndpoint:
    """The in-process assembly (responder + prober + REST); main()
    wraps it as the standalone process."""

    def __init__(
        self,
        agent_socket: str,
        api_socket: str,
        listen_ip: str = "0.0.0.0",
        port: int = DEFAULT_HEALTH_PORT,
        probe_interval: float = 60.0,
    ) -> None:
        self.responder = HealthResponder(listen_ip, port)
        # Fallback probe port for peers that haven't advertised one:
        # the configured cluster convention, NEVER our own ephemeral
        # responder port (on one host that would self-connect and
        # report an unstarted peer as reachable).
        self.prober = HealthProber(
            nodes=_AgentNodeView(agent_socket),
            probe=tcp_probe,
            port=port or DEFAULT_HEALTH_PORT,
        )
        self.probe_interval = probe_interval
        self.started = time.time()
        endpoint = self

        class Handler(UnixHandler):
            def do_GET(self):
                if self.path == "/status":
                    rep = endpoint.prober.report()
                    rep["probes_answered"] = endpoint.responder.accepted
                    rep["uptime_s"] = round(time.time() - endpoint.started, 1)
                    rep["port"] = endpoint.responder.port
                    self._json(200, rep)
                elif self.path == "/healthz":
                    self._json(200, {"ok": True})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/probe":
                    out = endpoint.prober.probe_once()
                    self._json(200, {"probed": len(out)})
                else:
                    self._json(404, {"error": "not found"})

        self._api = UnixHTTPServer(api_socket, Handler)

    def start(self) -> "HealthEndpoint":
        self.responder.start()
        self.prober.start(interval=self.probe_interval)
        threading.Thread(target=self._api.serve_forever, daemon=True).start()
        return self

    def stop(self) -> None:
        self.prober.stop()
        self.responder.stop()
        self._api.shutdown()
        self._api.server_close()


class HealthAPIClient:
    """Client for the health endpoint's unix-socket API (the
    cilium-health CLI role)."""

    def __init__(self, api_socket: str, timeout: float = 10.0) -> None:
        from ..api.client import APIClient

        self._c = APIClient(api_socket, timeout=timeout)

    def status(self) -> dict:
        return self._c._request("GET", "/status")

    def probe(self) -> dict:
        return self._c._request("POST", "/probe")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="python -m cilium_tpu_torch.health",
        description="standalone per-node health endpoint (cilium-health)",
    )
    ap.add_argument("--agent", required=True, help="agent API unix socket")
    ap.add_argument("--api", required=True, help="this endpoint's unix socket")
    ap.add_argument("--listen-ip", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=DEFAULT_HEALTH_PORT)
    ap.add_argument("--interval", type=float, default=60.0)
    args = ap.parse_args(argv)
    from ..utils.procutil import die_with_parent

    die_with_parent()  # a SIGKILLed agent must not leak this sidecar
    ep = HealthEndpoint(
        args.agent, args.api, listen_ip=args.listen_ip, port=args.port,
        probe_interval=args.interval,
    ).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    print(f"READY {ep.responder.port}", flush=True)
    stop.wait()
    ep.stop()
    return 0
