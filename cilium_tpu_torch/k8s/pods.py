"""Pod → endpoint translation (the CNI ADD/DEL shape).

Reference: plugins/cilium-cni/cilium-cni.go (endpoint creation from a
sandbox attach) and pkg/k8s/factory_functions.go + pkg/labels
(k8s-sourced security labels). The CNI plugin's job decomposes into:
derive the pod's security-relevant labels (own labels + namespace
label + mirrored namespace-object labels), pick addresses, and drive
Daemon.endpoint_add — which here replaces the agent's REST PUT
/endpoint/{id}.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .constants import (
    POD_NAMESPACE_LABEL,
    POD_NAMESPACE_META_LABELS,
    SOURCE_K8S,
    extract_namespace,
)


def pod_labels(
    pod: dict, namespace_labels: Optional[Dict[str, str]] = None
) -> List[str]:
    """Security labels for a pod object: every pod label under the
    ``k8s:`` source, the namespace label, and the namespace object's
    own labels mirrored under the meta prefix (so namespaceSelector
    policies can match them)."""
    meta = pod.get("metadata") or {}
    ns = extract_namespace(meta)
    out = [
        f"{SOURCE_K8S}:{k}={v}" for k, v in sorted((meta.get("labels") or {}).items())
    ]
    out.append(f"{SOURCE_K8S}:{POD_NAMESPACE_LABEL}={ns}")
    for k, v in sorted((namespace_labels or {}).items()):
        out.append(f"{SOURCE_K8S}:{POD_NAMESPACE_META_LABELS}.{k}={v}")
    sa = (pod.get("spec") or {}).get("serviceAccountName")
    if sa:
        out.append(f"{SOURCE_K8S}:io.cilium.k8s.policy.serviceaccount={sa}")
    return out


def pod_addresses(pod: dict) -> Dict[str, str]:
    """{"ipv4": ..., "ipv6": ...} from pod status."""
    status = pod.get("status") or {}
    ips = [e.get("ip") for e in status.get("podIPs") or () if e.get("ip")]
    if status.get("podIP"):
        ips.insert(0, status["podIP"])
    out: Dict[str, str] = {}
    for ip in ips:
        key = "ipv6" if ":" in ip else "ipv4"
        out.setdefault(key, ip)
    return out


class PodOrchestrator:
    """Applies pod add/delete events to a Daemon — the CNI-shaped
    endpoint lifecycle. Endpoint ids are allocated from the pod UID
    hash so re-adds are stable."""

    def __init__(self, daemon, namespace_labels: Optional[Dict[str, Dict[str, str]]] = None):
        self.daemon = daemon
        self.namespace_labels = namespace_labels or {}
        self._pod_to_ep: Dict[str, int] = {}
        self._next_id = 10000

    def pod_key(self, pod: dict) -> str:
        meta = pod.get("metadata") or {}
        return f"{extract_namespace(meta)}/{meta.get('name', '')}"

    def add_pod(self, pod: dict) -> int:
        key = self.pod_key(pod)
        if key in self._pod_to_ep:
            return self._pod_to_ep[key]
        ns = extract_namespace(pod.get("metadata") or {})
        lbls = pod_labels(pod, self.namespace_labels.get(ns))
        addrs = pod_addresses(pod)
        ep_id = self._next_id
        self._next_id += 1
        self.daemon.endpoint_add(
            ep_id,
            labels=lbls,
            ipv4=addrs.get("ipv4"),
            ipv6=addrs.get("ipv6"),
            pod_name=key,
        )
        self._pod_to_ep[key] = ep_id
        return ep_id

    def known_pods(self) -> List[Tuple[str, str]]:
        """(namespace, name) of every pod with a live endpoint — the
        resync reconciliation input."""
        return sorted(
            tuple(key.split("/", 1)) for key in self._pod_to_ep
        )

    def delete_pod(self, pod: dict) -> bool:
        ep_id = self._pod_to_ep.pop(self.pod_key(pod), None)
        if ep_id is None:
            return False
        return self.daemon.endpoint_delete(ep_id)
