"""CiliumNetworkPolicy (cilium.io/v2) → policy Rule translation.

Reference: pkg/k8s/apis/cilium.io/v2/types.go (CiliumNetworkPolicy:
Spec + Specs), pkg/k8s/apis/cilium.io/utils/utils.go ParseToCiliumRule.

A CNP embeds native rules; translation only *scopes* them to the
namespace the object lives in:
- the endpoint selector gets ``k8s:io.kubernetes.pod.namespace=<ns>``
  injected (an explicit foreign-namespace match is illegal and is
  overridden, utils.go:201-212);
- every fromEndpoints/toEndpoints selector likewise, unless it already
  pins a namespace, matches on ``reserved:``-sourced labels, or the
  policy targets initializing pods (utils.go:60-84);
- fromRequires/toRequires get the namespace too but skip the
  reserved-prefix exemption (utils.go addK8sPrefix=false);
- provenance labels name the CNP so deletion can find the rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from ..labels import parse_label_array
from ..policy.api import EndpointSelector, Rule
from ..policy.api.serialization import rule_from_dict
from .constants import (
    POD_ANY_PREFIX_LBL,
    POD_INIT_LBL,
    POD_PREFIX_LBL,
    SOURCE_RESERVED,
    extract_namespace,
    policy_labels,
)


def _namespace_valid(namespace: str, selector: EndpointSelector) -> bool:
    """An explicit namespace match is legal only when it names the
    namespace the policy lives in (utils.go namespacesAreValid)."""
    for key in (POD_PREFIX_LBL, POD_ANY_PREFIX_LBL):
        v = selector.get_match(key)
        if v is not None and v != namespace:
            return False
    return True


def _scope_selector(
    namespace: str,
    sel: EndpointSelector,
    skip_reserved: bool,
    matches_init: bool,
) -> EndpointSelector:
    """utils.go getEndpointSelector: inject the namespace match."""
    if skip_reserved and sel.has_key_prefix(f"{SOURCE_RESERVED}:"):
        return sel
    if matches_init:
        # Initializing pods carry no labels at all — adding a namespace
        # requirement would make the selector unmatchable (utils.go:74-79).
        return sel
    if sel.has_key(POD_PREFIX_LBL) or sel.has_key(POD_ANY_PREFIX_LBL):
        return sel
    return sel.with_match(POD_PREFIX_LBL, namespace)


def parse_cilium_rule(namespace: str, name: str, rule: Rule) -> Rule:
    """Namespace-scope one embedded rule (utils.go ParseToCiliumRule)."""
    subject = rule.endpoint_selector
    matches_init = subject.has_key(POD_INIT_LBL)
    if not matches_init:
        if not _namespace_valid(namespace, subject):
            # Illegal foreign-namespace match: the selector always
            # applies in the policy's own namespace (utils.go:202-211).
            subject = EndpointSelector(
                tuple(
                    (k, v)
                    for k, v in subject.match_labels
                    if k not in (POD_PREFIX_LBL, POD_ANY_PREFIX_LBL)
                ),
                subject.match_expressions,
            )
        subject = subject.with_match(POD_PREFIX_LBL, namespace)

    ingress = tuple(
        dataclasses.replace(
            ir,
            from_endpoints=tuple(
                _scope_selector(namespace, s, True, matches_init)
                for s in ir.from_endpoints
            ),
            from_requires=tuple(
                _scope_selector(namespace, s, False, matches_init)
                for s in ir.from_requires
            ),
        )
        for ir in rule.ingress
    )
    egress = tuple(
        dataclasses.replace(
            er,
            to_endpoints=tuple(
                _scope_selector(namespace, s, True, matches_init)
                for s in er.to_endpoints
            ),
            to_requires=tuple(
                _scope_selector(namespace, s, False, matches_init)
                for s in er.to_requires
            ),
        )
        for er in rule.egress
    )
    lbls = parse_label_array(
        policy_labels(namespace, name) + list(rule.labels.to_strings())
    )
    return dataclasses.replace(
        rule,
        endpoint_selector=subject,
        ingress=ingress,
        egress=egress,
        labels=lbls,
    )


def parse_cnp(obj: Dict[str, Any]) -> List[Rule]:
    """Translate one CiliumNetworkPolicy object (spec and/or specs,
    types.go:48-58). Returns the sanitized rule list."""
    meta = obj.get("metadata") or {}
    namespace = extract_namespace(meta)
    name = meta.get("name", "")
    specs: List[Dict[str, Any]] = []
    if obj.get("spec"):
        specs.append(obj["spec"])
    specs.extend(obj.get("specs") or ())
    if not specs:
        raise ValueError(f"CiliumNetworkPolicy {namespace}/{name} has no spec")
    out: List[Rule] = []
    for spec in specs:
        rule = parse_cilium_rule(namespace, name, rule_from_dict(spec))
        rule.sanitize()
        out.append(rule)
    return out
