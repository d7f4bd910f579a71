"""Versioned xDS resource cache.

Reference: pkg/envoy/xds/cache.go + set.go — resources live under a
type URL, keyed by name; every mutation bumps the per-type version,
and watchers blocked on "newer than version V" wake when it moves.
Resources here are plain JSON-able dicts (the reference uses protos;
the protocol semantics — versioning, subsets, wildcard subscriptions —
are what matter).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

# type URLs (pkg/envoy/resources.go:32-38)
NETWORK_POLICY_TYPE = "type.cilium.io/NetworkPolicy"  # NPDS
NETWORK_POLICY_HOSTS_TYPE = "type.cilium.io/NetworkPolicyHosts"  # NPHDS


class ResourceCache:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # type URL → (version, {name: resource})
        self._types: Dict[str, Tuple[int, Dict[str, dict]]] = {}

    def upsert(self, type_url: str, name: str, resource: dict) -> int:
        """→ new version (cache.go tx: no-op writes don't bump)."""
        with self._cond:
            version, res = self._types.get(type_url, (0, {}))
            if res.get(name) == resource:
                return version
            res = dict(res)
            res[name] = resource
            version += 1
            self._types[type_url] = (version, res)
            self._cond.notify_all()
            return version

    def delete(self, type_url: str, name: str) -> int:
        with self._cond:
            version, res = self._types.get(type_url, (0, {}))
            if name not in res:
                return version
            res = dict(res)
            del res[name]
            version += 1
            self._types[type_url] = (version, res)
            self._cond.notify_all()
            return version

    def version(self, type_url: str) -> int:
        """Current version only — the stream poll reads this 5×/s per
        client, so it must not copy the resource dict."""
        with self._lock:
            return self._types.get(type_url, (0, {}))[0]

    def get(
        self, type_url: str, names: Optional[List[str]] = None
    ) -> Tuple[int, Dict[str, dict]]:
        """→ (version, resources) — names=None is the wildcard
        subscription (all resources of the type)."""
        with self._lock:
            version, res = self._types.get(type_url, (0, {}))
            if names is None:
                return version, dict(res)
            return version, {n: res[n] for n in names if n in res}

    def wait_newer(
        self, type_url: str, than_version: int, timeout: float = 5.0
    ) -> Optional[int]:
        """Block until the type's version exceeds ``than_version``
        (the watcher role, xds/watcher.go). None on timeout."""
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._types.get(type_url, (0, {}))[0] > than_version,
                timeout=deadline,
            )
            if not ok:
                return None
            return self._types[type_url][0]
