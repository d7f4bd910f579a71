"""Container runtime watcher.

Reference: pkg/workloads (docker.go + watcher_state.go): subscribes to
the container runtime's event stream, turns container start/die into
endpoint create/delete through the CNI-shaped flow, and periodically
full-syncs so missed events heal. The runtime is pluggable (the
reference supports docker/containerd/cri-o behind one interface);
tests inject a fake.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Protocol

from .plugins.cni import cni_add, cni_del, endpoint_id_for
from .utils.logging import get_logger

log = get_logger("workloads")

IGNORE_LABEL = "io.cilium.ignore"  # ignore.go IgnoreRunningWorkloads


@dataclasses.dataclass(frozen=True)
class ContainerInfo:
    """The runtime-agnostic container view (docker.go inspect subset)."""

    id: str
    name: str = ""
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    running: bool = True


class Runtime(Protocol):
    def containers(self) -> Iterable[ContainerInfo]: ...


def container_labels(info: ContainerInfo) -> List[str]:
    """Container labels → `container:` source labels (the labels the
    identity is allocated from, docker.go fetchK8sLabels fallback)."""
    out = [f"container:id={info.id[:12]}"]
    for k, v in sorted(info.labels.items()):
        if k == IGNORE_LABEL:
            continue
        out.append(f"container:{k}={v}")
    return out


class WorkloadWatcher:
    """Keeps daemon endpoints in sync with a container runtime."""

    def __init__(self, daemon, runtime: Runtime) -> None:
        self.daemon = daemon
        self.runtime = runtime
        self._lock = threading.Lock()
        self._known: Dict[str, int] = {}  # container id → endpoint id

    # -- event path (EnableEventListener, docker.go) --------------------
    def on_start(self, info: ContainerInfo) -> Optional[int]:
        if info.labels.get(IGNORE_LABEL):
            return None
        with self._lock:
            if info.id in self._known:
                return self._known[info.id]
        # adopt endpoints that already exist (snapshot restore
        # recreated them before the watcher came up) instead of
        # failing the create every sync
        ep_id = endpoint_id_for(info.id)
        if self.daemon.endpoint_manager.lookup(ep_id) is not None:
            with self._lock:
                self._known[info.id] = ep_id
            return ep_id
        try:
            result = cni_add(
                self.daemon, info.id, labels=container_labels(info)
            )
        except Exception:
            log.warning("workload endpoint create failed",
                        fields={"container": info.id[:12]})
            return None
        with self._lock:
            self._known[info.id] = result.endpoint_id
        return result.endpoint_id

    def on_die(self, container_id: str) -> bool:
        with self._lock:
            self._known.pop(container_id, None)
        return cni_del(self.daemon, container_id)

    # -- periodic reconciliation (watcher_state.go reapContainers) ------
    def sync(self) -> int:
        """Full resync: create endpoints for unseen running containers,
        delete endpoints whose containers are gone. Returns the number
        of changes applied."""
        live = {
            c.id: c
            for c in self.runtime.containers()
            if c.running and not c.labels.get(IGNORE_LABEL)
        }
        changes = 0
        with self._lock:
            known = dict(self._known)
        for cid in known:
            if cid not in live:
                self.on_die(cid)
                changes += 1
        for cid, info in live.items():
            if cid not in known:
                if self.on_start(info) is not None:
                    changes += 1
        return changes

    def endpoint_of(self, container_id: str) -> Optional[int]:
        with self._lock:
            return self._known.get(container_id)
