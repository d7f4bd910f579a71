"""k8s Service / Endpoints registry.

Reference: pkg/loadbalancer/loadbalancer.go (K8sServiceNamespace,
K8sServiceInfo, K8sServiceEndpoint) and daemon/k8s_watcher.go service
caches. One registry instance is shared by the ToServices rule
translator (k8s/rule_translate.py) and the LB frontend programming
(lb/ service manager): services define frontends, endpoints define
backends.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class ServiceID:
    """Namespaced service name (loadbalancer.go K8sServiceNamespace)."""

    namespace: str
    name: str

    def __str__(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class ServicePort:
    """One exposed port (loadbalancer.go K8sServicePort + L4Addr)."""

    name: str
    port: int
    protocol: str = "TCP"
    node_port: int = 0


@dataclasses.dataclass
class ServiceInfo:
    """Service frontend side (loadbalancer.go K8sServiceInfo)."""

    cluster_ip: str = ""
    ports: Dict[str, ServicePort] = dataclasses.field(default_factory=dict)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    is_headless: bool = False

    @property
    def is_external(self) -> bool:
        """Headless/selector-less services resolve to external IPs the
        cluster does not manage (K8sServiceInfo.IsExternal: no selector)."""
        return not self.selector


@dataclasses.dataclass
class ServiceEndpoint:
    """Backend side (loadbalancer.go K8sServiceEndpoint): the union of
    ready addresses and the port name → L4 mapping."""

    backend_ips: Tuple[str, ...] = ()
    ports: Dict[str, ServicePort] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class IngressInfo:
    """Single-service Ingress backend (daemon/k8s_watcher.go:1181
    addIngressV1beta1 — the reference supports exactly this shape:
    spec.backend.{serviceName, servicePort})."""

    service_name: str
    service_port: int  # the frontend port number (IntValue of the spec)
    port_name: str = ""  # named servicePort, "" when numeric


class ServiceRegistry:
    """Thread-safe cache of Service + Endpoints objects, with observers
    so policy translation and LB programming react to churn."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.services: Dict[ServiceID, ServiceInfo] = {}
        self.endpoints: Dict[ServiceID, ServiceEndpoint] = {}
        # keyed by the INGRESS object's own (namespace, name)
        self.ingresses: Dict[ServiceID, IngressInfo] = {}
        self._observers: List = []  # callables (event, ServiceID)

    # -- mutation ------------------------------------------------------
    def upsert_service(self, sid: ServiceID, info: ServiceInfo) -> None:
        with self._lock:
            self.services[sid] = info
        self._notify("service-upsert", sid)

    def delete_service(self, sid: ServiceID) -> None:
        with self._lock:
            self.services.pop(sid, None)
        self._notify("service-delete", sid)

    def upsert_endpoints(self, sid: ServiceID, ep: ServiceEndpoint) -> None:
        with self._lock:
            self.endpoints[sid] = ep
        self._notify("endpoints-upsert", sid)

    def delete_endpoints(self, sid: ServiceID) -> None:
        with self._lock:
            self.endpoints.pop(sid, None)
        self._notify("endpoints-delete", sid)

    # -- object-shaped ingestion ---------------------------------------
    def apply_service_object(self, obj: dict) -> ServiceID:
        """Decode a v1 Service dict (k8s_watcher.go serviceAddFn)."""
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        sid = ServiceID(meta.get("namespace") or "default", meta.get("name", ""))
        cluster_ip = spec.get("clusterIP") or ""
        ports = {}
        for p in spec.get("ports") or ():
            name = p.get("name") or str(p.get("port", 0))
            ports[name] = ServicePort(
                name=name,
                port=int(p.get("port", 0) or 0),
                protocol=str(p.get("protocol") or "TCP").upper(),
                node_port=int(p.get("nodePort", 0) or 0),
            )
        self.upsert_service(
            sid,
            ServiceInfo(
                cluster_ip="" if cluster_ip in ("None", "") else cluster_ip,
                ports=ports,
                labels=dict(meta.get("labels") or {}),
                selector=dict(spec.get("selector") or {}),
                is_headless=cluster_ip in ("None", ""),
            ),
        )
        return sid

    def apply_endpoints_object(self, obj: dict) -> ServiceID:
        """Decode a v1 Endpoints dict (k8s_watcher.go endpointAddFn)."""
        meta = obj.get("metadata") or {}
        sid = ServiceID(meta.get("namespace") or "default", meta.get("name", ""))
        ips: List[str] = []
        ports: Dict[str, ServicePort] = {}
        for subset in obj.get("subsets") or ():
            for addr in subset.get("addresses") or ():
                if addr.get("ip"):
                    ips.append(addr["ip"])
            for p in subset.get("ports") or ():
                name = p.get("name") or str(p.get("port", 0))
                ports[name] = ServicePort(
                    name=name,
                    port=int(p.get("port", 0) or 0),
                    protocol=str(p.get("protocol") or "TCP").upper(),
                )
        self.upsert_endpoints(
            sid, ServiceEndpoint(backend_ips=tuple(dict.fromkeys(ips)), ports=ports)
        )
        return sid

    def apply_ingress_object(self, obj: dict) -> Optional[ServiceID]:
        """Decode a v1beta1 Ingress dict. Only the single-service shape
        (spec.backend) is supported — same restriction as the reference
        (k8s_watcher.go:1188 'Single Service Ingress'). → the ingress's
        own id, or None when the shape is unsupported."""
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        backend = spec.get("backend")
        if not backend or not backend.get("serviceName"):
            return None
        iid = ServiceID(meta.get("namespace") or "default", meta.get("name", ""))
        raw_port = backend.get("servicePort", 0)
        try:
            port_int = int(raw_port)
            port_name = ""
        except (TypeError, ValueError):
            port_int = 0
            port_name = str(raw_port)
        with self._lock:
            self.ingresses[iid] = IngressInfo(
                service_name=backend["serviceName"],
                service_port=port_int,
                port_name=port_name,
            )
        self._notify("ingress-upsert", iid)
        return iid

    def delete_ingress(self, iid: ServiceID) -> None:
        with self._lock:
            self.ingresses.pop(iid, None)
        self._notify("ingress-delete", iid)

    def known_ingress_ids(self) -> List[ServiceID]:
        with self._lock:
            return sorted(self.ingresses, key=lambda s: (s.namespace, s.name))

    # -- queries -------------------------------------------------------
    def get(self, sid: ServiceID) -> Tuple[Optional[ServiceInfo], Optional[ServiceEndpoint]]:
        with self._lock:
            return self.services.get(sid), self.endpoints.get(sid)

    def external_services(self) -> Iterable[Tuple[ServiceID, ServiceInfo, ServiceEndpoint]]:
        """Services eligible for ToServices CIDR translation
        (rule_translate.go PreprocessRules: external only)."""
        with self._lock:
            items = list(self.endpoints.items())
            for sid, ep in items:
                svc = self.services.get(sid)
                if svc is not None and svc.is_external:
                    yield sid, svc, ep

    # -- observers -----------------------------------------------------
    def observe(self, fn) -> None:
        self._observers.append(fn)

    def service_ids(self) -> List[ServiceID]:
        """All currently-known service ids (the resync reconciliation
        input: ids absent from a re-list snapshot are stale)."""
        with self._lock:
            return sorted(
                set(self.services) | set(self.endpoints),
                key=lambda s: (s.namespace, s.name),
            )

    def known_service_ids(self) -> List[ServiceID]:
        """Ids with a Service object (resync compares these against
        the snapshot's Service kinds)."""
        with self._lock:
            return sorted(self.services, key=lambda s: (s.namespace, s.name))

    def known_endpoints_ids(self) -> List[ServiceID]:
        """Ids with an Endpoints object (resync compares these against
        the snapshot's Endpoints kinds — Service and Endpoints are
        separate k8s objects deleted independently)."""
        with self._lock:
            return sorted(self.endpoints, key=lambda s: (s.namespace, s.name))

    def _notify(self, event: str, sid: ServiceID) -> None:
        for fn in list(self._observers):
            fn(event, sid)
