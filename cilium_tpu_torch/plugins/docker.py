"""Docker libnetwork remote driver + IPAM driver.

Reference: plugins/cilium-docker/driver/{driver,ipam}.go
— a plugin process serving the libnetwork plugin protocol (JSON POSTs
over a unix socket under /run/docker/plugins/) and fronting the agent:
``NetworkDriver`` endpoints create/join/leave endpoints via the daemon
(endpoint registration + identity allocation), ``IpamDriver``
endpoints allocate addresses from the daemon's pool.

Protocol notes (docker/libnetwork remote + ipam driver specs):
every call is ``POST /<Driver>.<Method>`` with a JSON body; errors are
``{"Err": "..."}`` with HTTP 200 (libnetwork reads Err, not status).
"""

from __future__ import annotations

import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..utils.logging import get_logger

log = get_logger("docker-plugin")

POOL_V4 = "CiliumPoolv4"
ADDRESS_SPACE_LOCAL = "CiliumLocal"
ADDRESS_SPACE_GLOBAL = "CiliumGlobal"
CONTAINER_IF_PREFIX = "eth"


class _UnixHTTPServer(ThreadingHTTPServer):
    address_family = socket.AF_UNIX
    daemon_threads = True
    allow_reuse_address = False

    def server_bind(self):
        path = self.server_address
        if isinstance(path, str) and os.path.exists(path):
            os.unlink(path)
        self.socket.bind(path)

    def server_activate(self):
        self.socket.listen(16)


class _Handler(BaseHTTPRequestHandler):
    def address_string(self) -> str:
        return "unix"

    def log_message(self, fmt, *args):
        pass

    def _reply(self, payload: Dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/vnd.docker.plugins.v1+json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> Dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        return json.loads(raw.decode()) if raw else {}

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        plugin = self.server.plugin_obj  # type: ignore[attr-defined]
        method = self.path.lstrip("/")
        # ALWAYS drain the request body before replying: an early
        # error response with unread bytes in the socket makes the
        # close send RST and the client sees a broken pipe mid-request
        try:
            body = self._body()
        except (ValueError, OSError):
            body = {}
        fn = plugin.routes.get(method)
        if fn is None:
            self._reply({"Err": f"unknown method {method}"})
            return
        try:
            self._reply(fn(body))
        except Exception as e:  # protocol: errors ride the Err field
            self._reply({"Err": f"{type(e).__name__}: {e}"})


class DockerPlugin:
    """The libnetwork plugin endpoint set over a daemon instance."""

    def __init__(self, daemon, socket_path: str) -> None:
        self.daemon = daemon
        self.socket_path = socket_path
        # libnetwork EndpointID → allocated state
        self._lock = threading.Lock()
        self._endpoints: Dict[str, Dict] = {}
        self.routes = {
            "Plugin.Activate": self.activate,
            "NetworkDriver.GetCapabilities": self.get_capabilities,
            "NetworkDriver.CreateNetwork": self.create_network,
            "NetworkDriver.DeleteNetwork": self.delete_network,
            "NetworkDriver.CreateEndpoint": self.create_endpoint,
            "NetworkDriver.DeleteEndpoint": self.delete_endpoint,
            "NetworkDriver.EndpointOperInfo": self.endpoint_info,
            "NetworkDriver.Join": self.join,
            "NetworkDriver.Leave": self.leave,
            "IpamDriver.GetCapabilities": self.ipam_capabilities,
            "IpamDriver.GetDefaultAddressSpaces": self.address_spaces,
            "IpamDriver.RequestPool": self.request_pool,
            "IpamDriver.ReleasePool": self.release_pool,
            "IpamDriver.RequestAddress": self.request_address,
            "IpamDriver.ReleaseAddress": self.release_address,
        }
        self._server: Optional[_UnixHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- plugin handshake ----------------------------------------------
    def activate(self, _req: Dict) -> Dict:
        return {"Implements": ["NetworkDriver", "IpamDriver"]}

    def get_capabilities(self, _req: Dict) -> Dict:
        return {"Scope": "local"}  # driver.go:238

    # -- NetworkDriver --------------------------------------------------
    def create_network(self, req: Dict) -> Dict:
        log.info("docker network created",
                 fields={"network": req.get("NetworkID", "")[:12]})
        return {}

    def delete_network(self, _req: Dict) -> Dict:
        return {}

    def create_endpoint(self, req: Dict) -> Dict:
        """CreateEndpoint: libnetwork hands the address the IPAM driver
        allocated; register the endpoint with the daemon (the reference
        defers daemon registration to Join, but carries the address
        from here)."""
        eid = req["EndpointID"]
        iface = req.get("Interface") or {}
        address = (iface.get("Address") or "").split("/")[0]
        with self._lock:
            if eid in self._endpoints:
                raise ValueError(f"endpoint {eid[:12]} exists")
            self._endpoints[eid] = {"ipv4": address, "joined": False}
        # respond with an empty Interface: we accepted theirs
        return {"Interface": {}}

    def delete_endpoint(self, req: Dict) -> Dict:
        eid = req["EndpointID"]
        with self._lock:
            st = self._endpoints.pop(eid, None)
        if st and st.get("ep_id") is not None:
            self.daemon.endpoint_delete(st["ep_id"])
        return {}

    def endpoint_info(self, req: Dict) -> Dict:
        eid = req["EndpointID"]
        with self._lock:
            st = self._endpoints.get(eid)
        return {"Value": dict(st or {})}

    def join(self, req: Dict) -> Dict:
        """Join: the sandbox attaches — register with the daemon
        (identity allocation + ipcache + regeneration; the reference
        PUTs /endpoint/{id} here) and describe the veth interface."""
        eid = req["EndpointID"]
        from .cni import endpoint_id_for

        ep_id = endpoint_id_for(eid)
        with self._lock:
            st = self._endpoints.get(eid)
            if st is None:
                raise ValueError(f"unknown endpoint {eid[:12]}")
            ipv4 = st.get("ipv4") or None
        labels = [f"container:io.docker.network.endpoint={eid[:12]}"]
        self.daemon.endpoint_add(ep_id, labels=labels, ipv4=ipv4)
        with self._lock:
            st["ep_id"] = ep_id
            st["joined"] = True
        return {
            "InterfaceName": {
                "SrcName": f"tmp{ep_id % 100000}",
                "DstPrefix": CONTAINER_IF_PREFIX,  # driver.go:414
            },
            "Gateway": "",
        }

    def leave(self, req: Dict) -> Dict:
        eid = req["EndpointID"]
        with self._lock:
            st = self._endpoints.get(eid)
            ep_id = st.get("ep_id") if st else None
            if st:
                st["joined"] = False
                st["ep_id"] = None
        if ep_id is not None:
            self.daemon.endpoint_delete(ep_id)
        return {}

    # -- IpamDriver -----------------------------------------------------
    def ipam_capabilities(self, _req: Dict) -> Dict:
        return {"RequiresMACAddress": False}

    def address_spaces(self, _req: Dict) -> Dict:
        return {
            "LocalDefaultAddressSpace": ADDRESS_SPACE_LOCAL,
            "GlobalDefaultAddressSpace": ADDRESS_SPACE_GLOBAL,
        }

    def request_pool(self, req: Dict) -> Dict:
        if req.get("V6"):
            raise ValueError("IPv6 pools not provided by this node")
        return {
            "PoolID": POOL_V4,
            "Pool": str(self.daemon.ipam.net),
            "Data": {},
        }

    def release_pool(self, _req: Dict) -> Dict:
        return {}

    def request_address(self, req: Dict) -> Dict:
        if req.get("PoolID") not in (POOL_V4, "", None):
            raise ValueError(f"unknown pool {req.get('PoolID')}")
        want = req.get("Address") or ""
        if want:
            ip = self.daemon.ipam.allocate(want, owner="docker")
        else:
            ip = self.daemon.ipam.allocate_next(owner="docker")
        prefixlen = self.daemon.ipam.net.prefixlen
        return {"Address": f"{ip}/{prefixlen}", "Data": {}}

    def release_address(self, req: Dict) -> Dict:
        addr = (req.get("Address") or "").split("/")[0]
        if addr:
            self.daemon.ipam.release(addr)
        return {}

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "DockerPlugin":
        self._server = _UnixHTTPServer(self.socket_path, _Handler)
        self._server.plugin_obj = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
