"""k8s NetworkPolicy (networking.k8s.io/v1) → policy Rule translation.

Reference: pkg/k8s/network_policy.go ParseNetworkPolicy. Input is the
decoded object (a dict, from JSON or YAML) rather than a typed client
struct — this framework has no k8s client dependency; the watcher layer
feeds raw objects.

Semantics preserved:
- podSelector keys get the ``k8s:`` source prefix and the policy's
  namespace is injected as an extra matchLabel
  (network_policy.go:234-240);
- namespaceSelector keys are rewritten under the
  ``io.cilium.k8s.namespace.labels.`` prefix; an *empty*
  namespaceSelector becomes an Exists match on the pod-namespace label
  (selects all namespaces, network_policy.go:85-89);
- a peer podSelector is scoped to the policy's namespace
  (network_policy.go:98-101);
- empty ``from``/``to`` lists wildcard the peer
  (network_policy.go:156-165);
- the k8s default-deny idiom (empty ingress + policyTypes) becomes an
  empty IngressRule/EgressRule (network_policy.go:212-232).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..labels import parse_label_array
from ..policy.api import (
    CIDRRule,
    EgressRule,
    EndpointSelector,
    IngressRule,
    MatchExpression,
    PortProtocol,
    PortRule,
    Rule,
)
from ..policy.api.selector import EXISTS
from .constants import (
    ANNOTATION_NAME,
    POD_NAMESPACE_LABEL,
    POD_NAMESPACE_META_LABELS,
    extract_namespace,
    policy_labels,
)

POLICY_TYPE_INGRESS = "Ingress"
POLICY_TYPE_EGRESS = "Egress"


def _k8s_selector(
    label_selector: Optional[Dict[str, Any]],
    key_prefix: str = "k8s:",
    extra_labels: Optional[Dict[str, str]] = None,
) -> EndpointSelector:
    """Build an EndpointSelector from a k8s LabelSelector dict, with
    every key source-prefixed (api.NewESFromK8sLabelSelector)."""
    sel = label_selector or {}
    match: Dict[str, str] = {
        key_prefix + k: v for k, v in (sel.get("matchLabels") or {}).items()
    }
    for k, v in (extra_labels or {}).items():
        match[key_prefix + k] = v
    exprs: Tuple[MatchExpression, ...] = tuple(
        MatchExpression(
            key=key_prefix + e["key"],
            operator=e["operator"],
            values=tuple(e.get("values") or ()),
        )
        for e in sel.get("matchExpressions") or ()
    )
    return EndpointSelector.make(match, exprs)


def _parse_peer(namespace: str, peer: Dict[str, Any]) -> Optional[EndpointSelector]:
    """NetworkPolicyPeer → selector (network_policy.go:61-108);
    ipBlock handled separately by the caller."""
    ns_sel = peer.get("namespaceSelector")
    pod_sel = peer.get("podSelector")
    if ns_sel is not None:
        # Rewrite namespace-object keys under the meta-labels prefix.
        rewritten: Dict[str, Any] = {
            "matchLabels": {
                f"{POD_NAMESPACE_META_LABELS}.{k}": v
                for k, v in (ns_sel.get("matchLabels") or {}).items()
            },
            "matchExpressions": [
                dict(e, key=f"{POD_NAMESPACE_META_LABELS}.{e['key']}")
                for e in ns_sel.get("matchExpressions") or ()
            ],
        }
        if not rewritten["matchLabels"] and not rewritten["matchExpressions"]:
            # Empty namespaceSelector selects every namespace: the pod
            # namespace label must merely exist (network_policy.go:87-89).
            rewritten["matchExpressions"] = [
                {"key": POD_NAMESPACE_LABEL, "operator": EXISTS}
            ]
        combined = _k8s_selector(rewritten)
        if pod_sel is not None:
            pod_part = _k8s_selector(pod_sel)
            combined = EndpointSelector(
                tuple(sorted(set(combined.match_labels) | set(pod_part.match_labels))),
                combined.match_expressions + pod_part.match_expressions,
            )
        return combined
    if pod_sel is not None:
        # Peer pods are implicitly in the policy's own namespace.
        return _k8s_selector(pod_sel, extra_labels={POD_NAMESPACE_LABEL: namespace})
    return None


def _ip_block(block: Dict[str, Any]) -> CIDRRule:
    return CIDRRule(
        cidr=block["cidr"], except_cidrs=tuple(block.get("except") or ())
    )


def _parse_ports(ports: List[Dict[str, Any]]) -> Tuple[PortRule, ...]:
    """NetworkPolicyPort list → PortRules (network_policy.go:265-292).
    Named (string, non-numeric) ports need pod-spec knowledge this layer
    doesn't have; they are rejected at parse time rather than silently
    never matching."""
    out: List[PortRule] = []
    for port in ports:
        if port.get("protocol") is None and port.get("port") is None:
            continue
        proto = str(port.get("protocol") or "TCP").upper()
        raw = port.get("port", 0)
        try:
            num = int(raw or 0)
        except (TypeError, ValueError):
            raise ValueError(f"named port {raw!r} is not supported") from None
        out.append(PortRule(ports=(PortProtocol(port=num, protocol=proto),)))
    return tuple(out)


def parse_network_policy(obj: Dict[str, Any]) -> List[Rule]:
    """Translate one networking/v1 NetworkPolicy object. Returns the
    (sanitized) rule list to import (network_policy.go:122-251)."""
    if not obj:
        raise ValueError("cannot parse empty NetworkPolicy")
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    namespace = extract_namespace(meta)
    name = (meta.get("annotations") or {}).get(ANNOTATION_NAME) or meta.get("name", "")

    ingresses: List[IngressRule] = []
    for i_rule in spec.get("ingress") or ():
        to_ports = _parse_ports(i_rule.get("ports") or [])
        from_eps: List[EndpointSelector] = []
        from_cidr_set: List[CIDRRule] = []
        peers = i_rule.get("from") or []
        if peers:
            for peer in peers:
                sel = _parse_peer(namespace, peer)
                if sel is not None:
                    from_eps.append(sel)
                if peer.get("ipBlock"):
                    from_cidr_set.append(_ip_block(peer["ipBlock"]))
        else:
            # Empty/missing `from` matches all sources.
            from_eps.append(EndpointSelector.wildcard())
        ingresses.append(
            IngressRule(
                from_endpoints=tuple(from_eps),
                from_cidr_set=tuple(from_cidr_set),
                to_ports=to_ports,
            )
        )

    egresses: List[EgressRule] = []
    for e_rule in spec.get("egress") or ():
        to_eps: List[EndpointSelector] = []
        to_cidr_set: List[CIDRRule] = []
        peers = e_rule.get("to") or []
        if peers:
            for peer in peers:
                sel = _parse_peer(namespace, peer)
                if sel is not None:
                    to_eps.append(sel)
                if peer.get("ipBlock"):
                    to_cidr_set.append(_ip_block(peer["ipBlock"]))
        else:
            to_eps.append(EndpointSelector.wildcard())
        to_ports = _parse_ports(e_rule.get("ports") or [])
        if not to_ports and not peers:
            # Fully-empty egress rule wildcards the destination
            # (network_policy.go:196-207).
            to_eps = [EndpointSelector.wildcard()]
        egresses.append(
            EgressRule(
                to_endpoints=tuple(to_eps),
                to_cidr_set=tuple(to_cidr_set),
                to_ports=to_ports,
            )
        )

    # k8s default-deny idiom → empty (match-nothing-allowed) direction
    # rules, which flip the subject to default-deny without allowing
    # any peer (network_policy.go:212-232).
    policy_types = spec.get("policyTypes") or []
    if not ingresses and (
        POLICY_TYPE_INGRESS in policy_types or POLICY_TYPE_EGRESS not in policy_types
    ):
        ingresses = [IngressRule()]
    if not egresses and POLICY_TYPE_EGRESS in policy_types:
        egresses = [EgressRule()]

    subject = _k8s_selector(
        spec.get("podSelector") or {}, extra_labels={POD_NAMESPACE_LABEL: namespace}
    )
    rule = Rule(
        endpoint_selector=subject,
        ingress=tuple(ingresses),
        egress=tuple(egresses),
        labels=parse_label_array(policy_labels(namespace, name)),
        description=f"k8s NetworkPolicy {namespace}/{name}",
    )
    rule.sanitize()
    return [rule]
