"""ToServices → ToCIDRSet rule translation.

Reference: pkg/k8s/rule_translate.go (RuleTranslator.Translate,
generateToCidrFromEndpoint, deleteToCidrFromEndpoint,
PreprocessRules). The reference mutates rules in place; rules here are
frozen dataclasses, so translation is pure — it returns a new Rule —
and the caller swaps it into the repository (one revision bump).

Generated entries carry ``CIDRRule.generated`` so a revert removes
exactly what translation added and nothing the user wrote.
"""

from __future__ import annotations

import dataclasses
import ipaddress
from typing import Dict, Iterable, Optional, Tuple

from ..policy.api import CIDRRule, EgressRule, Rule, ServiceSelector
from ..policy.api.rules import host_cidr as _host_cidr
from .service_registry import ServiceEndpoint, ServiceID, ServiceInfo, ServiceRegistry


def _service_matches(
    sel: ServiceSelector, sid: ServiceID, svc_labels: Dict[str, str]
) -> bool:
    """rule_translate.go serviceMatches: selector-based match over the
    service's own labels, or direct name+namespace equality. An empty
    namespace on the selector matches any namespace."""
    if sel.selector is not None:
        from ..labels import parse_label_array

        lbls = parse_label_array([f"{k}={v}" for k, v in svc_labels.items()])
        return sel.selector.matches(lbls) and sel.namespace in ("", sid.namespace)
    return sel.name == sid.name and sel.namespace in ("", sid.namespace)


def _service_owned(c: CIDRRule) -> bool:
    """Entries this translator may add/remove. generated_by == "" is
    included for backward compatibility: snapshots written before the
    ownership tag existed serialized service-generated entries as bare
    {generated: true} — treating them as service-owned lets the next
    translation clean them up instead of orphaning them forever."""
    return c.generated and c.generated_by in ("service", "")


def _populate(egress: EgressRule, endpoint: ServiceEndpoint) -> EgressRule:
    """Add one-address generated CIDRs for every backend not already
    covered (generateToCidrFromEndpoint, rule_translate.go:113-160).
    Coverage counts only user-written and service-owned entries: an
    fqdn-generated /32 that happens to equal a backend today will be
    withdrawn when DNS moves, so it must not suppress the
    service-owned entry that keeps the backend reachable."""
    existing = [
        ipaddress.ip_network(c.cidr, strict=False)
        for c in egress.to_cidr_set
        if _service_owned(c) or not c.generated
    ]
    added = list(egress.to_cidr_set)
    for ip in endpoint.backend_ips:
        addr = ipaddress.ip_address(ip)
        if any(addr in net for net in existing):
            continue
        added.append(
            CIDRRule(cidr=_host_cidr(ip), generated=True, generated_by="service")
        )
        existing.append(ipaddress.ip_network(_host_cidr(ip), strict=False))
    return dataclasses.replace(egress, to_cidr_set=tuple(added))


def _depopulate(egress: EgressRule, endpoint: ServiceEndpoint) -> EgressRule:
    """Drop generated CIDRs covering this endpoint's backends
    (deleteToCidrFromEndpoint, rule_translate.go:170-199)."""
    backends = [ipaddress.ip_address(ip) for ip in endpoint.backend_ips]
    kept = tuple(
        c
        for c in egress.to_cidr_set
        # only entries THIS translator generated are eligible for
        # removal — fqdn-generated entries belong to the DNS poller
        if not _service_owned(c)
        or not any(
            b in ipaddress.ip_network(c.cidr, strict=False) for b in backends
        )
    )
    return dataclasses.replace(egress, to_cidr_set=kept)


class RuleTranslator:
    """Populates (or reverts) ToCIDRSet entries on every egress rule
    whose ToServices matches the given service."""

    def __init__(
        self,
        service: ServiceID,
        endpoint: ServiceEndpoint,
        service_labels: Optional[Dict[str, str]] = None,
        revert: bool = False,
    ) -> None:
        self.service = service
        self.endpoint = endpoint
        self.service_labels = service_labels or {}
        self.revert = revert

    def translate(self, rule: Rule) -> Rule:
        new_egress = []
        changed = False
        for er in rule.egress:
            if any(
                _service_matches(sel, self.service, self.service_labels)
                for sel in er.to_services
            ):
                er2 = _depopulate(er, self.endpoint)
                if not self.revert:
                    er2 = _populate(er2, self.endpoint)
                changed = changed or er2 != er
                new_egress.append(er2)
            else:
                new_egress.append(er)
        if not changed:
            return rule
        return dataclasses.replace(rule, egress=tuple(new_egress))


class RegistryTranslator:
    """Idempotent whole-registry translation: for every egress rule
    with ToServices, drop all generated CIDRs and repopulate from the
    services currently known. Unlike the reference's per-event
    populate/depopulate pair (which needs the *old* endpoint object to
    revert), recomputation needs no history — service and endpoint
    deletions fall out naturally."""

    def __init__(self, registry: ServiceRegistry) -> None:
        self.registry = registry

    def translate(self, rule: Rule) -> Rule:
        new_egress = []
        changed = False
        for er in rule.egress:
            if not er.to_services:
                new_egress.append(er)
                continue
            base = dataclasses.replace(
                er,
                to_cidr_set=tuple(
                    c for c in er.to_cidr_set if not _service_owned(c)
                ),
            )
            for sid, svc, ep in self.registry.external_services():
                if any(
                    _service_matches(sel, sid, svc.labels) for sel in er.to_services
                ):
                    base = _populate(base, ep)
            changed = changed or base != er
            new_egress.append(base)
        if not changed:
            return rule
        return dataclasses.replace(rule, egress=tuple(new_egress))


def preprocess_rules(rules: Iterable[Rule], registry: ServiceRegistry) -> Tuple[Rule, ...]:
    """Translate ToServices against every known external service before
    import (rule_translate.go PreprocessRules)."""
    out = list(rules)
    for sid, svc, ep in registry.external_services():
        t = RuleTranslator(sid, ep, svc.labels)
        out = [t.translate(r) for r in out]
    return tuple(out)
