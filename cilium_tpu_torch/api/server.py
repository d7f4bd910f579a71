"""REST API over a unix socket — the daemon's wire surface.

Re-design of the reference's swagger REST API
(api/v1/openapi.yaml, handler wiring
daemon/main.go:963-1035): same resource layout
(/healthz /policy /policy/resolve /endpoint /identity /metrics
/prefilter /status), JSON bodies, served over an AF_UNIX socket like
the reference's cilium.sock. Implemented on http.server — the daemon
is the backend, this layer only routes.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import urllib.parse
from typing import Optional

from ..daemon import Daemon
from .unixhttp import UnixHandler, UnixHTTPServer

_UnixHTTPServer = UnixHTTPServer  # serving scaffold shared with sidecars


class _Handler(UnixHandler):
    # -- helpers --------------------------------------------------------
    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw.decode()) if raw else {}

    @property
    def d(self) -> Daemon:
        return self.server.daemon_obj  # type: ignore[attr-defined]

    def _route(self, method: str) -> None:
        parsed = urllib.parse.urlsplit(self.path)
        path = parsed.path.rstrip("/") or "/"
        q = urllib.parse.parse_qs(parsed.query)
        try:
            handled = self._dispatch(method, path, q)
        except (ValueError, KeyError) as e:
            self._json(400, {"error": str(e)})
            return
        except Exception as e:  # surface daemon errors as 500s
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if not handled:
            self._json(404, {"error": f"no route {method} {path}"})

    def _dispatch(self, method: str, path: str, q) -> bool:
        d = self.d
        if method == "GET" and path == "/healthz":
            self._json(200, d.status())
        elif method == "GET" and path == "/status":
            self._json(200, d.status())
        elif method == "GET" and path == "/metrics":
            self._text(200, d.metrics_text())
        elif path == "/policy" and method == "GET":
            self._json(200, d.policy_get(q.get("labels")))
        elif path == "/policy" and method == "PUT":
            body = self._body()
            self._json(200, d.policy_add(json.dumps(body["rules"])))
        elif path == "/policy" and method == "DELETE":
            body = self._body()
            self._json(200, d.policy_delete(body.get("labels", [])))
        elif path == "/policy/resolve" and method == "POST":
            body = self._body()
            self._json(200, d.policy_resolve(
                body.get("src", []), body.get("dst", []),
                body.get("dports", []),
                ingress=body.get("ingress", True),
                verbose=body.get("verbose", False),
            ))
        elif path == "/endpoint" and method == "GET":
            self._json(200, d.endpoint_list())
        elif (m := re.fullmatch(r"/endpoint/(\d+)", path)):
            ep_id = int(m.group(1))
            if method == "PUT":
                body = self._body()
                self._json(201, d.endpoint_add(
                    ep_id, body.get("labels", []),
                    ipv4=body.get("ipv4"), ipv6=body.get("ipv6"),
                    pod_name=body.get("pod_name", ""),
                ))
            elif method == "GET":
                model = d.endpoint_get(ep_id)
                if model is None:
                    self._json(404, {"error": f"endpoint {ep_id} not found"})
                else:
                    self._json(200, model)
            elif method == "DELETE":
                ok = d.endpoint_delete(ep_id)
                self._json(200 if ok else 404, {"deleted": ok})
            else:
                return False
        elif (m := re.fullmatch(r"/endpoint/(\d+)/regenerate", path)) and method == "POST":
            self._json(200, d.endpoint_regenerate(int(m.group(1))))
        elif path == "/endpoint/regenerate" and method == "POST":
            self._json(200, d.endpoint_regenerate())
        elif (m := re.fullmatch(r"/endpoint/(\d+)/log", path)) and method == "GET":
            ep_id = int(m.group(1))
            if d.endpoint_manager.lookup(ep_id) is None:
                self._json(404, {"error": f"endpoint {ep_id} not found"})
            else:
                self._json(200, d.endpoint_log(ep_id))
        elif (m := re.fullmatch(r"/endpoint/(\d+)/labels", path)) and method == "PATCH":
            body = self._body()
            self._json(200, d.endpoint_labels(
                int(m.group(1)),
                add=body.get("add", []), delete=body.get("delete", []),
            ))
        elif (m := re.fullmatch(r"/endpoint/(\d+)/policymap", path)) and method == "GET":
            ingress = q.get("direction", ["ingress"])[0] != "egress"
            self._json(200, d.policymap_dump(int(m.group(1)), ingress=ingress))
        elif path == "/identity" and method == "GET":
            self._json(200, d.identity_list())
        elif (m := re.fullmatch(r"/identity/(\d+)", path)) and method == "GET":
            ident = d.identity_get(int(m.group(1)))
            if ident is None:
                self._json(404, {"error": "identity not found"})
            else:
                self._json(200, ident)
        elif path == "/config" and method == "GET":
            self._json(200, d.config_get())
        elif path == "/config" and method == "PATCH":
            body = self._body()
            self._json(200, d.config_patch(body.get("options", {})))
        elif (m := re.fullmatch(r"/endpoint/(\d+)/config", path)) and method == "PATCH":
            ep_id = int(m.group(1))
            if d.endpoint_manager.lookup(ep_id) is None:
                self._json(404, {"error": f"endpoint {ep_id} not found"})
            else:
                body = self._body()
                self._json(200, d.endpoint_config(
                    ep_id, body.get("options", {})
                ))
        elif path == "/map" and method == "GET":
            self._json(200, d.map_list())
        elif path == "/map/ct/flush" and method == "POST":
            self._json(200, d.ct_flush())
        elif path == "/node" and method == "GET":
            self._json(200, d.node_list())
        elif path == "/cluster" and method == "GET":
            self._json(200, d.cluster_status())
        elif path == "/fleet" and method == "GET":
            self._json(200, d.fleet_status())
        elif path == "/fleet/history" and method == "GET":
            limit = int(q.get("limit", ["64"])[0])
            self._json(200, d.fleet_history(limit=limit))
        elif path == "/fleet/timeline" and method == "GET":
            limit = int(q.get("limit", ["256"])[0])
            self._json(200, d.fleet_timeline(limit=limit))
        elif path == "/events" and method == "GET":
            since = q.get("since", [None])[0]
            self._json(200, d.events(
                limit=int(q.get("limit", ["64"])[0]),
                kind=q.get("kind", [None])[0],
                severity=q.get("severity", [None])[0],
                since=float(since) if since is not None else None,
            ))
        elif (m := re.fullmatch(r"/map/(\w+)", path)) and method == "GET":
            self._json(200, d.map_dump(m.group(1)))
        elif path == "/ipam" and method == "POST":
            body = self._body() if self.headers.get("Content-Length") else {}
            ip = d.ipam.allocate_next(owner=body.get("owner", ""))
            self._json(201, {"ip": ip, "cidr": str(d.ipam.net)})
        elif (m := re.fullmatch(r"/ipam/(.+)", path)) and method == "DELETE":
            ok = d.ipam.release(m.group(1))
            self._json(200 if ok else 404, {"released": ok})
        elif path == "/health" and method == "GET":
            self._json(200, d.health_report())
        elif path == "/health/probe" and method == "POST":
            self._json(200, d.health_probe_now())
        elif path == "/debuginfo" and method == "GET":
            self._json(200, d.debuginfo())
        elif path == "/traces" and method == "GET":
            limit = int(q.get("limit", ["16"])[0])
            self._json(200, d.traces(limit=limit))
        elif path == "/profile" and method == "GET":
            self._json(200, d.profile())
        elif path == "/flows" and method == "GET":
            def _opt(name):
                return int(q[name][0]) if name in q else None
            self._json(200, d.flows(
                limit=int(q.get("limit", ["64"])[0]),
                verdict=_opt("verdict"),
                from_identity=_opt("from_identity"),
                reason=_opt("reason"),
            ))
        elif path == "/policy/explain" and method == "POST":
            body = self._body()
            self._json(200, d.policy_explain(
                body.get("src", []), body.get("dst", []),
                body.get("dport", ""),
                ingress=body.get("ingress", True),
            ))
        elif path == "/fqdn/poll" and method == "POST":
            self._json(200, d.fqdn_poll())
        elif path == "/service" and method == "GET":
            self._json(200, d.service_list())
        elif path == "/service" and method == "PUT":
            body = self._body()
            self._json(201, d.service_upsert(
                body["frontend"], body.get("backends", [])
            ))
        elif path == "/service" and method == "DELETE":
            body = self._body()
            ok = d.service_delete(body["frontend"])
            self._json(200 if ok else 404, {"deleted": ok})
        elif path == "/prefilter" and method == "GET":
            rev, cidrs = d.prefilter.dump()
            self._json(200, {"revision": rev, "cidrs": cidrs})
        elif path == "/prefilter" and method == "PATCH":
            body = self._body()
            rev = d.prefilter.insert(
                body.get("revision", d.prefilter.revision),
                body.get("cidrs", []),
            )
            self._json(200, {"revision": rev})
        elif path == "/prefilter" and method == "DELETE":
            body = self._body()
            rev = d.prefilter.delete(
                body.get("revision", d.prefilter.revision),
                body.get("cidrs", []),
            )
            self._json(200, {"revision": rev})
        else:
            return False
        return True

    def do_GET(self):
        self._route("GET")

    def do_PUT(self):
        self._route("PUT")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")

    def do_PATCH(self):
        self._route("PATCH")


class APIServer:
    """Serves a Daemon on a unix socket (cilium.sock role)."""

    def __init__(self, daemon: Daemon, socket_path: str) -> None:
        self.daemon = daemon
        self.socket_path = socket_path
        self._server = _UnixHTTPServer(socket_path, _Handler)
        self._server.daemon_obj = daemon  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
