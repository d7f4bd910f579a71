"""k8s object watcher / dispatcher.

Reference: daemon/k8s_watcher.go — the agent's single ingestion point
for NetworkPolicy, CiliumNetworkPolicy, Service, Endpoints, Pod and
Namespace events. There is no API server here; the watcher consumes
decoded objects (dicts) pushed by whatever transport the deployment
uses (file loads, tests, an external informer bridge) and applies them
to the daemon: policies into the repository (keyed by provenance
labels for deletion), services/endpoints into the ServiceRegistry
(which re-triggers ToServices translation), pods into endpoints.
"""

from __future__ import annotations

import json
import pathlib
import threading
from typing import Any, Dict, Iterable, List

from ..labels import parse_label_array
from ..policy.api.serialization import rule_from_dict, rules_to_json
from ..utils.logging import get_logger
from .cnp import parse_cnp
from .constants import extract_namespace, policy_labels
from .network_policy import parse_network_policy
from .pods import PodOrchestrator
from .rule_translate import preprocess_rules
from .service_registry import ServiceRegistry

log = get_logger("k8s-watcher")

KIND_NETWORK_POLICY = "NetworkPolicy"
KIND_CNP = "CiliumNetworkPolicy"
KIND_SERVICE = "Service"
KIND_ENDPOINTS = "Endpoints"
KIND_POD = "Pod"
KIND_NAMESPACE = "Namespace"
KIND_INGRESS = "Ingress"
KIND_NODE = "Node"

# node annotation keys the reference writes back (pkg/annotation/k8s.go)
ANNOTATION_V4_CIDR = "io.cilium.network.ipv4-pod-cidr"
ANNOTATION_V6_CIDR = "io.cilium.network.ipv6-pod-cidr"
ANNOTATION_V4_HEALTH = "io.cilium.network.ipv4-health-ip"


def load_objects(path: str) -> List[Dict[str, Any]]:
    """Decode a JSON or YAML file into a list of objects. YAML files
    may hold multiple ``---`` documents; JSON may hold a list. A bare
    rule list (no ``kind``) is returned as-is for `policy import`."""
    p = pathlib.Path(path)
    text = p.read_text()
    if p.suffix in (".yaml", ".yml"):
        import yaml

        docs = [d for d in yaml.safe_load_all(text) if d]
    else:
        data = json.loads(text)
        docs = data if isinstance(data, list) else [data]
    # A document may itself be a list (a YAML/JSON rule array).
    flat: List[Dict[str, Any]] = []
    for d in docs:
        flat.extend(d) if isinstance(d, list) else flat.append(d)
    return flat


def objects_to_rules(docs: Iterable[Dict[str, Any]]) -> list:
    """Translate a mixed list of decoded objects into policy rules.
    Bare rule dicts (no kind) pass through the native parser."""
    rules = []
    for obj in docs:
        kind = obj.get("kind", "")
        if kind == KIND_NETWORK_POLICY:
            rules.extend(parse_network_policy(obj))
        elif kind == KIND_CNP:
            rules.extend(parse_cnp(obj))
        elif kind in ("", None) or "endpointSelector" in obj:
            r = rule_from_dict(obj)
            r.sanitize()
            rules.append(r)
        # Non-policy kinds are skipped by this helper.
    return rules


class K8sWatcher:
    """Applies k8s object events to a running Daemon."""

    def __init__(self, daemon) -> None:
        self.daemon = daemon
        self.services = ServiceRegistry()
        self.pods = PodOrchestrator(daemon)
        self._namespace_labels: Dict[str, Dict[str, str]] = {}
        self.pods.namespace_labels = self._namespace_labels
        # k8s Node objects: name → {"pod_cidr", "internal_ip", ...}
        # (daemon/k8s_watcher.go node informer; feeds node routes and
        # the annotation writeback)
        self.nodes: Dict[str, Dict[str, Any]] = {}
        # Optional APIServerClient for writebacks (CNP status acks,
        # Ingress LB status, node CIDR annotations). Absent in
        # file-driven or test deployments — writebacks are skipped.
        self.status_client = None
        self.node_name = ""  # this agent's node (CNP status key)
        # (ns, name) → (spec fingerprint, revision) of applied policy
        # objects. Status-only MODIFIED events (including our OWN status
        # writebacks echoing back through the watch) must not re-import:
        # re-importing bumps the repository revision, which would change
        # the status we write, which would echo again — an infinite
        # write/regenerate loop. Spec-compare is the client-go
        # Generation-check idiom.
        self._applied_specs: Dict[Tuple[str, str], Tuple[str, int]] = {}
        # One lock serializes apply/delete/resync: the informer runs a
        # watch thread per kind, and a resync's stale scan must not
        # interleave with another kind's live applies (an object added
        # between the scan's snapshot and its deletes would be reaped)
        self._apply_lock = threading.RLock()
        # Service churn retriggers ToServices translation of rules that
        # are already imported (k8s_watcher.go serviceModFn →
        # RuleTranslator over the repository) AND reprograms the LB
        # frontends (addK8sSVCs/syncExternalLB).
        self.services.observe(self._on_service_event)

    # -- policy --------------------------------------------------------
    def add_policy_object(self, obj: Dict[str, Any]) -> int:
        """Upsert semantics (k8s_watcher.go updates re-import under the
        same provenance labels): a MODIFIED event or a re-list after
        reconnect must replace the object's previous rules, never
        accumulate duplicates. The replace is atomic (one repository
        lock hold, one regeneration) — no window with the object's
        rules absent. CNP imports additionally write a per-node status
        ack back to the apiserver when a status client is configured
        (the CNPStatus nodes map of pkg/k8s/apis/cilium.io/v2)."""
        meta = obj.get("metadata") or {}
        key = (extract_namespace(meta), meta.get("name", ""))
        fingerprint = json.dumps(
            {"spec": obj.get("spec"), "specs": obj.get("specs"),
             "labels": meta.get("labels"),
             # bare-rule objects carry the policy at top level
             "rules": {k: v for k, v in obj.items()
                       if k not in ("metadata", "status", "kind")}},
            sort_keys=True, default=str,
        )
        prev = self._applied_specs.get(key)
        if prev is not None and prev[0] == fingerprint:
            return prev[1]  # status-only change: nothing to re-import
        lbls = policy_labels(*key)
        try:
            rules = objects_to_rules([obj])
            rules = preprocess_rules(rules, self.services)
            rev = self.daemon.policy_replace(lbls, rules_to_json(rules))[
                "revision"
            ]
        except Exception as e:
            self._applied_specs.pop(key, None)
            if obj.get("kind") == KIND_CNP:
                self._write_cnp_status(obj, ok=False, error=str(e))
            raise
        self._applied_specs[key] = (fingerprint, rev)
        if obj.get("kind") == KIND_CNP:
            self._write_cnp_status(obj, ok=True, revision=rev)
        return rev

    def _write_cnp_status(
        self, obj: Dict[str, Any], *, ok: bool, revision: int = 0,
        error: str = "",
    ) -> None:
        """Per-node CNP enforcement ack (the status.nodes[nodeName]
        entry of CiliumNetworkPolicyNodeStatus)."""
        if self.status_client is None or not self.node_name:
            return
        import time as _time

        meta = obj.get("metadata") or {}
        status = dict(obj.get("status") or {})
        nodes = dict(status.get("nodes") or {})
        entry: Dict[str, Any] = {
            "ok": ok,
            "enforcing": ok,
            "lastUpdated": _time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", _time.gmtime()
            ),
        }
        if ok:
            entry["localPolicyRevision"] = revision
        else:
            entry["error"] = error
        nodes[self.node_name] = entry
        status["nodes"] = nodes
        updated = dict(obj)
        updated["status"] = status
        try:
            self.status_client.update_status(
                KIND_CNP, extract_namespace(meta), meta.get("name", ""),
                updated,
            )
        except Exception as e:
            log.warning("CNP status writeback failed", fields={
                "name": meta.get("name"), "err": f"{type(e).__name__}: {e}",
            })

    def delete_policy_object(self, obj: Dict[str, Any]) -> int:
        meta = obj.get("metadata") or {}
        key = (extract_namespace(meta), meta.get("name", ""))
        self._applied_specs.pop(key, None)
        lbls = policy_labels(*key)
        return self.daemon.policy_delete(lbls)["revision"]

    # -- services ------------------------------------------------------
    def _on_service_event(self, event: str, sid) -> None:
        from .rule_translate import RegistryTranslator

        self.daemon.policy_translate(RegistryTranslator(self.services))
        # reprogram LB frontends from the registry (the syncExternalLB
        # position: Service/Endpoints/Ingress churn all land here)
        lb = getattr(self.daemon, "services", None)
        if lb is not None and hasattr(lb, "sync_from_registry"):
            try:
                lb.sync_from_registry(self.services)
            except Exception as e:
                log.warning("LB sync failed", fields={
                    "err": f"{type(e).__name__}: {e}",
                })

    # -- ingress -------------------------------------------------------
    def _apply_ingress(self, obj: Dict[str, Any]) -> None:
        iid = self.services.apply_ingress_object(obj)
        if iid is None:
            return  # unsupported shape (no single-service backend)
        # status writeback: report the node host address as the LB
        # ingress point (k8s_watcher.go:1231-1240)
        lb = getattr(self.daemon, "services", None)
        host_ip = getattr(lb, "host_ip", "") if lb is not None else ""
        if self.status_client is not None and host_ip:
            meta = obj.get("metadata") or {}
            updated = dict(obj)
            updated["status"] = {
                "loadBalancer": {"ingress": [
                    {"ip": host_ip, "hostname": self.node_name}
                ]}
            }
            try:
                self.status_client.update_status(
                    KIND_INGRESS, meta.get("namespace") or "default",
                    meta.get("name", ""), updated,
                )
            except Exception as e:
                log.warning("ingress status writeback failed", fields={
                    "name": meta.get("name"),
                    "err": f"{type(e).__name__}: {e}",
                })

    # -- nodes ---------------------------------------------------------
    def _apply_node(self, obj: Dict[str, Any]) -> None:
        """Track k8s Node objects (podCIDR + addresses) and annotate
        OUR node with its CIDR (pkg/k8s/client.go AnnotateNode)."""
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        status = obj.get("status") or {}
        name = meta.get("name", "")
        internal_ip = ""
        for addr in status.get("addresses") or ():
            if addr.get("type") == "InternalIP":
                internal_ip = addr.get("address", "")
                break
        self.nodes[name] = {
            "name": name,
            "pod_cidr": spec.get("podCIDR", ""),
            "internal_ip": internal_ip,
            "labels": dict(meta.get("labels") or {}),
        }
        if (
            self.status_client is not None
            and name == self.node_name
        ):
            cidr = str(
                getattr(getattr(self.daemon, "ipam", None), "net", "") or ""
            )
            annotations = {}
            if cidr:
                key = ANNOTATION_V6_CIDR if ":" in cidr else ANNOTATION_V4_CIDR
                annotations[key] = cidr
            existing = dict(meta.get("annotations") or {})
            if annotations and any(
                existing.get(k) != v for k, v in annotations.items()
            ):
                try:
                    self.status_client.patch_annotations(
                        KIND_NODE, "", name, annotations
                    )
                except Exception as e:
                    log.warning("node annotation failed", fields={
                        "node": name, "err": f"{type(e).__name__}: {e}",
                    })

    # -- dispatch ------------------------------------------------------
    def apply(self, obj: Dict[str, Any]) -> None:
        with self._apply_lock:
            self._apply_locked(obj)

    def _apply_locked(self, obj: Dict[str, Any]) -> None:
        kind = obj.get("kind", "")
        if kind in (KIND_NETWORK_POLICY, KIND_CNP):
            self.add_policy_object(obj)
        elif kind == KIND_SERVICE:
            self.services.apply_service_object(obj)
        elif kind == KIND_ENDPOINTS:
            self.services.apply_endpoints_object(obj)
        elif kind == KIND_POD:
            self.pods.add_pod(obj)
        elif kind == KIND_NAMESPACE:
            meta = obj.get("metadata") or {}
            self._namespace_labels[meta.get("name", "")] = dict(meta.get("labels") or {})
        elif kind == KIND_INGRESS:
            self._apply_ingress(obj)
        elif kind == KIND_NODE:
            self._apply_node(obj)
        else:
            raise ValueError(f"unsupported object kind {kind!r}")

    def resync(self, objects: Iterable[Dict[str, Any]]) -> None:
        """Full-state reconciliation after a watch reconnect: the
        informer re-lists and hands the COMPLETE current object set;
        everything present is (re-)applied (upserts are idempotent)
        and previously-known objects absent from the snapshot are
        deleted — healing adds AND deletes missed while disconnected
        (the cache-resync contract daemon/k8s_watcher.go relies on
        client-go for). Serialized against live applies; one malformed
        object is logged and skipped, never allowed to abort the whole
        reconciliation (client-go isolates handler errors the same
        way)."""
        with self._apply_lock:
            self._resync_locked(list(objects))

    def _resync_locked(self, objects: List[Dict[str, Any]]) -> None:

        def key(o: Dict[str, Any]):
            meta = o.get("metadata") or {}
            kind = o.get("kind", "")
            # cluster-scoped kinds carry no namespace: pin the key's
            # namespace slot so lookups need exactly one form
            ns = "" if kind in (KIND_NAMESPACE, KIND_NODE) else (
                meta.get("namespace") or "default"
            )
            return (kind, ns, meta.get("name", ""))

        seen = {key(o) for o in objects}
        # collect currently-known objects per kind
        stale: List[Dict[str, Any]] = []
        for r_labels in self._known_policy_labels():
            if (
                (KIND_CNP, r_labels[1], r_labels[0]) not in seen
                and (KIND_NETWORK_POLICY, r_labels[1], r_labels[0]) not in seen
            ):
                stale.append({
                    "kind": KIND_CNP,
                    "metadata": {"name": r_labels[0], "namespace": r_labels[1]},
                })
        for sid in self.services.known_service_ids():
            if (KIND_SERVICE, sid.namespace, sid.name) not in seen:
                stale.append({
                    "kind": KIND_SERVICE,
                    "metadata": {"name": sid.name, "namespace": sid.namespace},
                })
        # Endpoints are deleted independently of their Service: a
        # snapshot holding the Service but not its Endpoints means the
        # backend set was removed while disconnected
        for sid in self.services.known_endpoints_ids():
            if (KIND_ENDPOINTS, sid.namespace, sid.name) not in seen:
                stale.append({
                    "kind": KIND_ENDPOINTS,
                    "metadata": {"name": sid.name, "namespace": sid.namespace},
                })
        for pod in list(self.pods.known_pods()):
            if (KIND_POD, pod[0], pod[1]) not in seen:
                stale.append({
                    "kind": KIND_POD,
                    "metadata": {"name": pod[1], "namespace": pod[0]},
                })
        for iid in self.services.known_ingress_ids():
            if (KIND_INGRESS, iid.namespace, iid.name) not in seen:
                stale.append({
                    "kind": KIND_INGRESS,
                    "metadata": {"name": iid.name, "namespace": iid.namespace},
                })
        # nodes are cluster-scoped like namespaces: reaped only when
        # the snapshot covers the kind
        if any(o.get("kind") == KIND_NODE for o in objects):
            for node_name in list(self.nodes):
                if (KIND_NODE, "", node_name) not in seen:
                    stale.append({
                        "kind": KIND_NODE,
                        "metadata": {"name": node_name},
                    })
        # namespaces: reaped only when the snapshot covers the kind at
        # all (a snapshot from an informer not watching Namespace must
        # not wipe the label cache)
        if any(o.get("kind") == KIND_NAMESPACE for o in objects):
            for ns_name in list(self._namespace_labels):
                if (KIND_NAMESPACE, "", ns_name) not in seen:
                    stale.append({
                        "kind": KIND_NAMESPACE,
                        "metadata": {"name": ns_name},
                    })
        for obj in stale:
            try:
                self._delete_locked(obj)
            except Exception:
                log.warning("resync delete failed", fields={
                    "kind": obj.get("kind"),
                    "name": (obj.get("metadata") or {}).get("name"),
                })
        for obj in objects:
            # placeholders assert presence only — applying one would
            # wipe the real spec
            if obj.get("__placeholder__"):
                continue
            try:
                self._apply_locked(obj)
            except Exception as e:
                # one poisoned object must not block ingestion of the
                # rest (or the initial sync would never complete)
                log.warning("resync apply failed", fields={
                    "kind": obj.get("kind"),
                    "name": (obj.get("metadata") or {}).get("name"),
                    "err": f"{type(e).__name__}: {e}",
                })

    def _known_policy_labels(self) -> List[tuple]:
        """(name, namespace) pairs of k8s-sourced rules currently in
        the repository (by provenance labels)."""
        from .constants import POLICY_LABEL_NAME, POLICY_LABEL_NAMESPACE, SOURCE_K8S

        out = set()
        with self.daemon.repo._lock:
            for r in self.daemon.repo.rules:
                name = ns = None
                for l in r.labels.to_strings():
                    if l.startswith(f"{SOURCE_K8S}:{POLICY_LABEL_NAME}="):
                        name = l.split("=", 1)[1]
                    elif l.startswith(f"{SOURCE_K8S}:{POLICY_LABEL_NAMESPACE}="):
                        ns = l.split("=", 1)[1]
                if name is not None and ns is not None:
                    out.add((name, ns))
        return sorted(out)

    def delete(self, obj: Dict[str, Any]) -> None:
        with self._apply_lock:
            self._delete_locked(obj)

    def _delete_locked(self, obj: Dict[str, Any]) -> None:
        kind = obj.get("kind", "")
        if kind in (KIND_NETWORK_POLICY, KIND_CNP):
            self.delete_policy_object(obj)
        elif kind == KIND_SERVICE:
            from .service_registry import ServiceID

            meta = obj.get("metadata") or {}
            self.services.delete_service(
                ServiceID(meta.get("namespace") or "default", meta.get("name", ""))
            )
        elif kind == KIND_ENDPOINTS:
            from .service_registry import ServiceID

            meta = obj.get("metadata") or {}
            self.services.delete_endpoints(
                ServiceID(meta.get("namespace") or "default", meta.get("name", ""))
            )
        elif kind == KIND_POD:
            self.pods.delete_pod(obj)
        elif kind == KIND_NAMESPACE:
            meta = obj.get("metadata") or {}
            self._namespace_labels.pop(meta.get("name", ""), None)
        elif kind == KIND_INGRESS:
            from .service_registry import ServiceID

            meta = obj.get("metadata") or {}
            self.services.delete_ingress(
                ServiceID(meta.get("namespace") or "default", meta.get("name", ""))
            )
        elif kind == KIND_NODE:
            meta = obj.get("metadata") or {}
            self.nodes.pop(meta.get("name", ""), None)
        else:
            raise ValueError(f"unsupported object kind {kind!r}")
