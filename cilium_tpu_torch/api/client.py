"""Client for the unix-socket REST API (pkg/client analog)."""

from __future__ import annotations

import http.client
import json
import socket
from typing import Optional


class APIError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class _UnixConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: float = 30.0) -> None:
        super().__init__("localhost", timeout=timeout)
        self._path = path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self._path)
        self.sock = s


class APIClient:
    def __init__(self, socket_path: str, timeout: float = 30.0) -> None:
        self.socket_path = socket_path
        self.timeout = timeout

    def _request(self, method: str, path: str, body: Optional[dict] = None):
        conn = _UnixConnection(self.socket_path, self.timeout)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"} if payload else {}
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            raw = resp.read().decode()
            ctype = resp.headers.get("Content-Type", "")
            data = json.loads(raw) if "json" in ctype else raw
            if resp.status >= 400:
                msg = data.get("error", raw) if isinstance(data, dict) else raw
                raise APIError(resp.status, msg)
            return data
        finally:
            conn.close()

    # -- typed wrappers -------------------------------------------------
    def status(self):
        return self._request("GET", "/status")

    def metrics(self) -> str:
        return self._request("GET", "/metrics")

    def policy_get(self):
        return self._request("GET", "/policy")

    def policy_put(self, rules: list):
        return self._request("PUT", "/policy", {"rules": rules})

    def policy_delete(self, labels: list):
        return self._request("DELETE", "/policy", {"labels": labels})

    def policy_resolve(self, src, dst, dports=(), *, ingress=True, verbose=False):
        return self._request("POST", "/policy/resolve", {
            "src": list(src), "dst": list(dst), "dports": list(dports),
            "ingress": ingress, "verbose": verbose,
        })

    def endpoint_list(self):
        return self._request("GET", "/endpoint")

    def endpoint_put(self, ep_id: int, labels, ipv4=None, ipv6=None):
        return self._request("PUT", f"/endpoint/{ep_id}", {
            "labels": list(labels), "ipv4": ipv4, "ipv6": ipv6,
        })

    def endpoint_delete(self, ep_id: int):
        return self._request("DELETE", f"/endpoint/{ep_id}")

    def policymap_get(self, ep_id: int, *, egress: bool = False):
        d = "egress" if egress else "ingress"
        return self._request("GET", f"/endpoint/{ep_id}/policymap?direction={d}")

    def identity_list(self):
        return self._request("GET", "/identity")

    def identity_get(self, num: int):
        return self._request("GET", f"/identity/{num}")

    def config_get(self):
        return self._request("GET", "/config")

    def config_patch(self, options: dict):
        return self._request("PATCH", "/config", {"options": options})

    def endpoint_config(self, ep_id: int, options: dict):
        return self._request(
            "PATCH", f"/endpoint/{ep_id}/config", {"options": options}
        )

    def map_dump(self, name: str):
        return self._request("GET", f"/map/{name}")

    def ipam_allocate(self, owner: str = ""):
        return self._request("POST", "/ipam", {"owner": owner})

    def ipam_release(self, ip: str):
        return self._request("DELETE", f"/ipam/{ip}")

    def health(self):
        return self._request("GET", "/health")

    def health_probe(self):
        return self._request("POST", "/health/probe")

    def debuginfo(self):
        return self._request("GET", "/debuginfo")

    def traces_get(self, limit: int = 16):
        return self._request("GET", f"/traces?limit={limit}")

    def profile_get(self):
        return self._request("GET", "/profile")

    def flows_get(self, limit: int = 64, *, verdict=None,
                  from_identity=None, reason=None):
        params = [f"limit={limit}"]
        if verdict is not None:
            params.append(f"verdict={verdict}")
        if from_identity is not None:
            params.append(f"from_identity={from_identity}")
        if reason is not None:
            params.append(f"reason={reason}")
        return self._request("GET", "/flows?" + "&".join(params))

    def policy_explain(self, src, dst, dport="", *, ingress=True):
        return self._request("POST", "/policy/explain", {
            "src": list(src), "dst": list(dst), "dport": dport,
            "ingress": ingress,
        })

    def fqdn_poll(self):
        return self._request("POST", "/fqdn/poll")

    def service_list(self):
        return self._request("GET", "/service")

    def service_put(self, frontend: dict, backends: list):
        return self._request(
            "PUT", "/service", {"frontend": frontend, "backends": backends}
        )

    def service_delete(self, frontend: dict):
        return self._request("DELETE", "/service", {"frontend": frontend})

    def prefilter_get(self):
        return self._request("GET", "/prefilter")

    def prefilter_patch(self, cidrs, revision=None):
        body = {"cidrs": list(cidrs)}
        if revision is not None:
            body["revision"] = revision
        return self._request("PATCH", "/prefilter", body)

    def prefilter_delete(self, cidrs, revision=None):
        body = {"cidrs": list(cidrs)}
        if revision is not None:
            body["revision"] = revision
        return self._request("DELETE", "/prefilter", body)

    def endpoint_get(self, ep_id: int):
        return self._request("GET", f"/endpoint/{ep_id}")

    def endpoint_regenerate(self, ep_id: Optional[int] = None):
        path = (f"/endpoint/{ep_id}/regenerate" if ep_id is not None
                else "/endpoint/regenerate")
        return self._request("POST", path)

    def endpoint_log(self, ep_id: int):
        return self._request("GET", f"/endpoint/{ep_id}/log")

    def endpoint_labels(self, ep_id: int, add=(), delete=()):
        return self._request("PATCH", f"/endpoint/{ep_id}/labels",
                             {"add": list(add), "delete": list(delete)})

    def map_list(self):
        return self._request("GET", "/map")

    def ct_flush(self):
        return self._request("POST", "/map/ct/flush")

    def node_list(self):
        return self._request("GET", "/node")

    def cluster_status(self):
        return self._request("GET", "/cluster")

    def fleet_status(self):
        return self._request("GET", "/fleet")

    def fleet_history(self, limit: int = 64):
        return self._request("GET", f"/fleet/history?limit={limit}")

    def fleet_timeline(self, limit: int = 256):
        return self._request("GET", f"/fleet/timeline?limit={limit}")

    def events_get(self, limit: int = 64, *, kind=None, severity=None,
                   since=None):
        params = [f"limit={limit}"]
        if kind is not None:
            params.append(f"kind={kind}")
        if severity is not None:
            params.append(f"severity={severity}")
        if since is not None:
            params.append(f"since={since}")
        return self._request("GET", "/events?" + "&".join(params))
