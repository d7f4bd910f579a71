"""Node connectivity prober.

Reference: pkg/health/server/prober.go — the cilium-health daemon
probes every known node (ICMP echo :229 + TCP connect to the node's
health endpoint :262) on an interval, keeps per-node status with
latency, and serves the results over its REST API; the agent launches
it at boot (daemon/main.go:927-945).

Here the probe transport is pluggable: the default TCP probe measures
a real connect() round trip; tests (and single-process clusters)
inject a fake. Results feed `cilium-tpu health` and the /health REST
route.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

DEFAULT_INTERVAL = 60.0  # prober.go ProbeInterval
DEFAULT_HEALTH_PORT = 4240  # cilium-health's node port

# probe signature: (address, port) → latency seconds, raising OSError
# on unreachable
ProbeFn = Callable[[str, int], float]


def tcp_probe(addr: str, port: int, timeout: float = 2.0) -> float:
    """Connect-based probe (prober.go TCP dial)."""
    t0 = time.monotonic()
    family = socket.AF_INET6 if ":" in addr else socket.AF_INET
    with socket.socket(family, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect((addr, port))
    return time.monotonic() - t0


@dataclasses.dataclass
class NodeStatus:
    """Per-node probe outcome (healthModels.NodeStatus)."""

    name: str
    cluster: str
    address: Optional[str]
    reachable: bool = False
    latency_s: float = 0.0
    last_probe: float = 0.0
    failures: int = 0  # consecutive
    error: str = ""

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class HealthProber:
    """Probes every node the registry knows about. ``nodes`` is any
    object with remote_nodes() → [Node] (nodes/registry.py), or None
    for a standalone single-node daemon (only self-status then)."""

    def __init__(
        self,
        nodes=None,
        probe: ProbeFn = tcp_probe,
        port: int = DEFAULT_HEALTH_PORT,
    ) -> None:
        self.nodes = nodes
        self.probe = probe
        self.port = port
        self._lock = threading.Lock()
        self._sweep_lock = threading.Lock()
        self._status: Dict[str, NodeStatus] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def probe_once(self) -> List[NodeStatus]:
        """One sweep over all known nodes (prober.go runProbe).

        Sweeps are serialized by ``_sweep_lock`` — the background loop
        and POST /health/probe must not interleave, or a sweep that
        blocked in a connect timeout could overwrite a newer sweep's
        result with stale state and corrupt consecutive-failure
        counts. Within a sweep, nodes are probed CONCURRENTLY (the
        reference fans out too, prober.go), bounding sweep time to
        roughly one transport timeout instead of timeouts × down
        nodes. Fresh NodeStatus objects are swapped in whole so
        report() never sees torn state."""
        with self._sweep_lock:
            nodes = list(self.nodes.remote_nodes()) if self.nodes else []

            def probe_node(n) -> NodeStatus:
                addr = n.health_ip or n.ipv4 or n.ipv6
                key = f"{n.cluster}/{n.name}"
                with self._lock:
                    prev = self._status.get(key)
                    prev_failures = prev.failures if prev else 0
                st = NodeStatus(
                    name=n.name, cluster=n.cluster, address=addr,
                    last_probe=time.time(),
                )
                if addr is None:
                    st.error = "no address"
                    st.failures = prev_failures + 1
                else:
                    # nodes may advertise their responder's port (one
                    # host running several test nodes); default 4240
                    port = getattr(n, "health_port", None) or self.port
                    try:
                        st.latency_s = self.probe(addr, port)
                        st.reachable = True
                    except OSError as e:
                        st.failures = prev_failures + 1
                        st.error = str(e) or type(e).__name__
                return st

            if not nodes:
                out: List[NodeStatus] = []
            elif len(nodes) == 1:
                out = [probe_node(nodes[0])]
            else:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                    max_workers=min(32, len(nodes))
                ) as pool:
                    out = list(pool.map(probe_node, nodes))
            with self._lock:
                for st in out:
                    self._status[f"{st.cluster}/{st.name}"] = st
                # forget nodes that left the cluster
                live = {f"{n.cluster}/{n.name}" for n in nodes}
                for key in list(self._status):
                    if key not in live:
                        del self._status[key]
            return out

    def report(self) -> Dict:
        """The GET /health payload (health server Status)."""
        with self._lock:
            # statuses are replaced whole per sweep, never mutated in
            # place — snapshotting under the lock is consistent
            nodes = [st.to_dict() for st in self._status.values()]
        reachable = sum(1 for n in nodes if n["reachable"])
        return {
            "nodes": sorted(nodes, key=lambda n: (n["cluster"], n["name"])),
            "reachable": reachable,
            "total": len(nodes),
        }

    def start(self, interval: float = DEFAULT_INTERVAL) -> None:
        if self._thread is not None:
            return
        # fresh Event per loop: restart after a timed-out join must
        # not revive the old thread (it keeps watching ITS event,
        # which stays set forever, and exits at its next check)
        self._stop = stop_ev = threading.Event()

        def loop():
            # initial sweep at launch (the reference probes immediately,
            # prober.go RunLoop) — health isn't empty for the first
            # interval after boot
            while True:
                try:
                    self.probe_once()
                except Exception:
                    pass  # a registry hiccup must not kill the prober
                if stop_ev.wait(interval):
                    return

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
