"""Endpoint registry + regeneration fan-out.

Reference: pkg/endpointmanager/manager.go — global registry with
lookups by cilium ID / container ID / pod name / IPv4 (:78-143),
`RegenerateAllEndpoints` (:271) fanning out to the builder worker pool
(daemon/daemon.go:235 StartEndpointBuilders, default #CPUs), and the
conntrack GC driver (EnableConntrackGC).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Dict, List, Optional

from .._kernels import KernelError
from ..maps.ctmap import ConntrackMap
from ..utils.controller import ControllerManager
from .endpoint import Endpoint


class EndpointManager:
    def __init__(self, workers: Optional[int] = None,
                 controllers: Optional[ControllerManager] = None) -> None:
        self._lock = threading.RLock()
        self._by_id: Dict[int, Endpoint] = {}
        self._by_container: Dict[str, Endpoint] = {}
        self._by_pod: Dict[str, Endpoint] = {}
        self._by_ipv4: Dict[str, Endpoint] = {}
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers or os.cpu_count() or 4,
            thread_name_prefix="ep-builder",
        )
        # shared with the daemon when embedded (one status registry);
        # standalone managers own their own
        self._controllers = controllers or ControllerManager()

    # -- registry -------------------------------------------------------
    def insert(self, ep: Endpoint) -> None:
        with self._lock:
            self._by_id[ep.id] = ep
            if ep.container_id:
                self._by_container[ep.container_id] = ep
            if ep.pod_name:
                self._by_pod[ep.pod_name] = ep
            if ep.ipv4:
                self._by_ipv4[ep.ipv4] = ep

    def remove(self, ep: Endpoint) -> None:
        with self._lock:
            self._by_id.pop(ep.id, None)
            if ep.container_id:
                self._by_container.pop(ep.container_id, None)
            if ep.pod_name:
                self._by_pod.pop(ep.pod_name, None)
            if ep.ipv4:
                self._by_ipv4.pop(ep.ipv4, None)

    def lookup(self, endpoint_id: int) -> Optional[Endpoint]:
        return self._by_id.get(endpoint_id)

    def lookup_container(self, container_id: str) -> Optional[Endpoint]:
        return self._by_container.get(container_id)

    def lookup_pod(self, pod_name: str) -> Optional[Endpoint]:
        return self._by_pod.get(pod_name)

    def lookup_ipv4(self, ip: str) -> Optional[Endpoint]:
        return self._by_ipv4.get(ip)

    def endpoints(self) -> List[Endpoint]:
        with self._lock:
            return list(self._by_id.values())

    def __len__(self) -> int:
        return len(self._by_id)

    # -- regeneration fan-out ------------------------------------------
    def regenerate_all(self, pipeline, reason: str = "", proxy=None) -> int:
        """Queue every endpoint to the builder pool; returns the count
        that regenerated successfully (RegenerateAllEndpoints). A
        failing endpoint counts as unsuccessful, it never aborts the
        fan-out. Passing ``proxy`` reconciles L7 redirects per
        endpoint (without it, policy changes would never refresh the
        redirects' identity scoping). A ``_kernels.KernelError`` (a
        kernel that could not be built, loaded or launched) is no
        endpoint's failure: it reaches the caller once every endpoint's
        regeneration has ended."""
        eps = self.endpoints()
        futures = [
            self._pool.submit(ep.regenerate, pipeline, reason, proxy)
            for ep in eps
        ]
        ok = 0
        kernel_error = None
        for f in futures:
            try:
                ok += 1 if f.result() else 0
            except KernelError as e:
                kernel_error = kernel_error or e
            except Exception:  # noqa: BLE001 — per-endpoint failure isolated
                pass
        if kernel_error is not None:
            raise kernel_error
        return ok

    # -- conntrack GC ---------------------------------------------------
    def enable_conntrack_gc(self, ctmap, interval: float = 60.0) -> None:
        """Periodic CT reaping; accepts any table with a gc() method
        (maps.ctmap.ConntrackMap or datapath.conntrack.FlowConntrack)."""
        self._controllers.update_controller(
            "ct-gc", lambda: ctmap.gc(), run_interval=interval
        )

    def shutdown(self) -> None:
        self._controllers.remove_all()
        self._pool.shutdown(wait=False)
