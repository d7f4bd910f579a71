"""k8s apiserver client: LIST + WATCH over the real HTTP wire protocol.

Reference: pkg/k8s/client.go + daemon/k8s_watcher.go:340 — the agent
connects to the apiserver, LISTs each resource kind, then WATCHes from
the returned resourceVersion, dispatching ADDED/MODIFIED/DELETED
events; on a dropped or expired watch (410 Gone) it re-LISTs and
reconciles (the client-go reflector/informer contract).

This client speaks that exact protocol over HTTP(S):

    GET  {base}/{prefix}?limit=...            → {"items": [...],
                                                  "metadata": {"resourceVersion": rv}}
    GET  {base}/{prefix}?watch=1&resourceVersion=rv
         → newline-delimited JSON: {"type": "ADDED|MODIFIED|DELETED",
                                     "object": {...}}

and drives a K8sWatcher: list results go through ``watcher.resync``
(healing deletes missed while disconnected), watch events through
``apply``/``delete``. Authentication is a bearer token header (the
in-cluster ServiceAccount pattern); TLS is the caller's http layer.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.backoff import Backoff
from ..utils.logging import get_logger

log = get_logger("k8s-client")

# resource kind → collection path (all-namespaces LIST/WATCH form)
RESOURCES: Dict[str, str] = {
    "NetworkPolicy": "apis/networking.k8s.io/v1/networkpolicies",
    "CiliumNetworkPolicy": "apis/cilium.io/v2/ciliumnetworkpolicies",
    "Service": "api/v1/services",
    "Endpoints": "api/v1/endpoints",
    "Pod": "api/v1/pods",
    "Namespace": "api/v1/namespaces",
    "Ingress": "apis/extensions/v1beta1/ingresses",
    "Node": "api/v1/nodes",
}

# kind → (group-version path, plural, namespaced) for per-OBJECT writes
# (status subresources, annotation patches — collection paths above
# cannot address a single namespaced object)
_OBJECT_PATHS: Dict[str, Tuple[str, str, bool]] = {
    "CiliumNetworkPolicy": ("apis/cilium.io/v2", "ciliumnetworkpolicies", True),
    "Ingress": ("apis/extensions/v1beta1", "ingresses", True),
    "Node": ("api/v1", "nodes", False),
    "Pod": ("api/v1", "pods", True),
}

# The CNP CustomResourceDefinition the reference registers at startup
# (pkg/k8s/apis/cilium.io/v2/register.go createCustomResourceDefinitions)
CNP_CRD: Dict = {
    "apiVersion": "apiextensions.k8s.io/v1beta1",
    "kind": "CustomResourceDefinition",
    "metadata": {"name": "ciliumnetworkpolicies.cilium.io"},
    "spec": {
        "group": "cilium.io",
        "version": "v2",
        "scope": "Namespaced",
        "names": {
            "plural": "ciliumnetworkpolicies",
            "singular": "ciliumnetworkpolicy",
            "kind": "CiliumNetworkPolicy",
            "shortNames": ["cnp", "ciliumnp"],
        },
        "subresources": {"status": {}},
    },
}


class APIServerClient:
    """Minimal list/watch client over one apiserver base URL."""

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        timeout: float = 10.0,
        watch_read_timeout: float = 60.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout
        # a watch stream with no traffic for this long is treated as a
        # dead connection (half-open TCP after a partition would
        # otherwise block the watch thread forever); real apiservers
        # are additionally asked to end the watch server-side first
        # via timeoutSeconds, so a healthy-but-idle watch ends cleanly
        self.watch_read_timeout = watch_read_timeout

    def _open(self, path: str, query: Dict[str, str], stream: bool = False):
        url = f"{self.base_url}/{path}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(url)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        # stream sockets get slack past timeoutSeconds so a healthy
        # server ends the watch before the client's deadline fires
        return urllib.request.urlopen(
            req,
            timeout=self.watch_read_timeout * 1.5 + 1.0
            if stream
            else self.timeout,
        )

    # -- writes ---------------------------------------------------------
    def _object_path(self, kind: str, namespace: str, name: str) -> str:
        gv, plural, namespaced = _OBJECT_PATHS[kind]
        if namespaced:
            return f"{gv}/namespaces/{namespace or 'default'}/{plural}/{name}"
        return f"{gv}/{plural}/{name}"

    def _request(
        self, method: str, path: str, body: Optional[Dict] = None,
        content_type: str = "application/json",
    ) -> Dict:
        url = f"{self.base_url}/{path}"
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            raw = resp.read()
        return json.loads(raw.decode()) if raw else {}

    def update_status(
        self, kind: str, namespace: str, name: str, obj: Dict
    ) -> Dict:
        """PUT the object's /status subresource (the CNP per-node
        status ack and Ingress loadBalancer status writeback paths —
        daemon/k8s_watcher.go:1240 UpdateStatus)."""
        path = self._object_path(kind, namespace, name) + "/status"
        return self._request("PUT", path, obj)

    def patch_annotations(
        self, kind: str, namespace: str, name: str, annotations: Dict[str, str]
    ) -> Dict:
        """Merge-patch metadata.annotations (pkg/k8s/client.go
        AnnotateNode — CIDR/health-IP writeback)."""
        path = self._object_path(kind, namespace, name)
        return self._request(
            "PATCH", path,
            {"metadata": {"annotations": dict(annotations)}},
            content_type="application/merge-patch+json",
        )

    def ensure_cnp_crd(self) -> bool:
        """Register the CNP CRD if the apiserver doesn't have it yet
        (pkg/k8s/apis/cilium.io/v2/register.go). → True if it exists
        or was created."""
        base = "apis/apiextensions.k8s.io/v1beta1/customresourcedefinitions"
        try:
            self._request("GET", f"{base}/{CNP_CRD['metadata']['name']}")
            return True
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        try:
            self._request("POST", base, CNP_CRD)
            return True
        except urllib.error.HTTPError as e:
            if e.code == 409:  # someone else registered it concurrently
                return True
            raise

    def list(self, kind: str) -> Tuple[List[Dict], str]:
        """LIST one kind → (objects with kind injected, resourceVersion)."""
        prefix = RESOURCES[kind]
        with self._open(prefix, {}) as resp:
            data = json.loads(resp.read().decode())
        items = data.get("items") or []
        for obj in items:
            obj.setdefault("kind", kind)
        rv = str((data.get("metadata") or {}).get("resourceVersion", "0"))
        return items, rv

    def watch(self, kind: str, resource_version: str, stop: threading.Event):
        """WATCH one kind from ``resource_version`` — yields
        (event_type, object) until the stream ends, ``stop`` is set, or
        the server expires the version (raises WatchExpired → caller
        re-LISTs)."""
        prefix = RESOURCES[kind]
        try:
            resp = self._open(
                prefix,
                {
                    "watch": "1",
                    "resourceVersion": resource_version,
                    # ask the server to end the watch before our socket
                    # deadline so an idle-but-healthy stream terminates
                    # cleanly rather than tripping the read timeout
                    "timeoutSeconds": str(int(self.watch_read_timeout)),
                },
                stream=True,
            )
        except urllib.error.HTTPError as e:
            if e.code == 410:  # Gone: re-list required
                raise WatchExpired(kind) from None
            raise
        with resp:
            buf = b""
            while not stop.is_set():
                try:
                    chunk = resp.read1(65536)
                except TimeoutError:
                    # no bytes within the deadline: connection presumed
                    # half-open — end the stream; the caller reconnects
                    # from the tracked rv (no re-list needed)
                    return
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, _, buf = buf.partition(b"\n")
                    if not line.strip():
                        continue
                    evt = json.loads(line)
                    if evt.get("type") == "ERROR":
                        status = evt.get("object") or {}
                        if status.get("code") == 410:
                            raise WatchExpired(kind)
                        raise RuntimeError(f"watch error: {status}")
                    obj = evt.get("object") or {}
                    obj.setdefault("kind", kind)
                    yield evt.get("type", ""), obj


class WatchExpired(Exception):
    """The watch resourceVersion is too old — re-LIST and reconcile."""


class Informer:
    """The reflector/informer loop: LIST → resync → WATCH → events,
    with reconnect + re-list on any failure (daemon/k8s_watcher.go:340
    wires the same handlers through client-go informers)."""

    def __init__(
        self,
        client: APIServerClient,
        watcher,  # K8sWatcher
        kinds: Optional[Iterable[str]] = None,
        relist_backoff_s: float = 1.0,
        max_backoff_s: float = 30.0,
    ) -> None:
        self.client = client
        self.watcher = watcher
        self.kinds = list(kinds or RESOURCES)
        self.relist_backoff_s = relist_backoff_s
        self.max_backoff_s = max_backoff_s
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._synced = threading.Event()
        self._relist_mu = threading.Lock()
        self._relist_gen = 0  # bumps on every completed re-list
        self._last_versions: Dict[str, str] = {}
        self.relists = 0  # observability: how many re-list cycles ran

    def _backoff(self) -> Backoff:
        return Backoff(min_s=self.relist_backoff_s, max_s=self.max_backoff_s)

    # -- one full LIST across kinds → one resync --------------------------
    def _list_all(self) -> Dict[str, str]:
        objects: List[Dict] = []
        versions: Dict[str, str] = {}
        for kind in self.kinds:
            items, rv = self.client.list(kind)
            objects.extend(items)
            versions[kind] = rv
        # ONE reconciliation over the combined snapshot: adds applied,
        # absent objects deleted (watcher.resync heals both)
        self.watcher.resync(objects)
        return versions

    def _watch_kind(self, kind: str, rv: str) -> None:
        backoff = self._backoff()
        while not self._stop.is_set():
            clean_end = False
            try:
                for etype, obj in self.client.watch(kind, rv, self._stop):
                    rv = str(
                        (obj.get("metadata") or {}).get("resourceVersion", rv)
                    )
                    try:
                        if etype in ("ADDED", "MODIFIED"):
                            self.watcher.apply(obj)
                        elif etype == "DELETED":
                            self.watcher.delete(obj)
                    except Exception as e:
                        # one malformed object must not kill the stream
                        log.warning("event apply failed", fields={
                            "kind": kind, "type": etype,
                            "err": f"{type(e).__name__}: {e}",
                        })
                clean_end = True
            except WatchExpired:
                log.info("watch expired; re-listing", fields={"kind": kind})
            except Exception as e:
                log.warning(
                    "watch failed; re-listing",
                    fields={"kind": kind, "err": f"{type(e).__name__}: {e}"},
                )
            if self._stop.is_set():
                return
            if clean_end:
                # apiservers time watches out by design: reconnect
                # from the tracked rv, no O(cluster) re-list needed
                backoff.reset()
                continue
            # failure path: ONE full re-list across all kinds (a
            # single combined resync needs no placeholder snapshots
            # and can't race partial views of other kinds). A re-list
            # that completed after THIS failure was observed — during
            # the backoff sleep or while queued on the mutex — already
            # reconciled every kind, so piggyback on its versions
            # instead of hammering the apiserver with N redundant full
            # re-lists when all watches drop at once.
            gen = self._relist_gen
            if backoff.wait(self._stop):
                return
            with self._relist_mu:
                if self._relist_gen != gen:
                    rv = self._last_versions.get(kind, rv)
                    backoff.reset()
                    continue
                try:
                    versions = self._list_all()
                    self._last_versions = versions
                    self._relist_gen += 1
                    rv = versions.get(kind, rv)
                    self.relists += 1
                    backoff.reset()
                except Exception as e:
                    log.warning(
                        "re-list failed",
                        fields={"err": f"{type(e).__name__}: {e}"},
                    )

    def start(self) -> "Informer":
        def boot():
            backoff = self._backoff()
            while not self._stop.is_set():
                try:
                    versions = self._list_all()
                    break
                except Exception as e:
                    log.warning(
                        "initial list failed; retrying",
                        fields={"err": f"{type(e).__name__}: {e}"},
                    )
                    if backoff.wait(self._stop):
                        return
            else:
                return
            self._synced.set()
            for kind in self.kinds:
                t = threading.Thread(
                    target=self._watch_kind,
                    args=(kind, versions.get(kind, "0")),
                    daemon=True,
                )
                t.start()
                self._threads.append(t)

        t = threading.Thread(target=boot, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def wait_synced(self, timeout: float = 10.0) -> bool:
        """Block until the initial LIST landed (daemon/main.go:843-856
        waits for cache sync before regenerating restored endpoints)."""
        return self._synced.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
