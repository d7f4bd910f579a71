"""Resolved L4 policy: filters keyed by port/proto.

Reference: pkg/policy/l4.go — L4Filter{Port, Protocol, L7Parser,
L7RulesPerEp, Endpoints, DerivedFromRules} and L4PolicyMap keyed
"port/proto", with the merge rules of pkg/policy/rule.go
mergeL4IngressPort/mergeL4EgressPort:

- an empty peer-selector list selects all endpoints (wildcard);
- merging a wildcard filter with anything yields wildcard;
- L7 parsers must agree per port; L7 rules merge per peer selector.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..labels import LabelArray
from .api import EndpointSelector, HTTPRule, KafkaRule, L7Rules
from .search import Decision, PortContext, SearchContext

PARSER_NONE = ""
PARSER_HTTP = "http"
PARSER_KAFKA = "kafka"

WILDCARD = EndpointSelector.wildcard()


class MergeConflict(ValueError):
    """L7 parser or rule-type conflict while merging port rules."""


@dataclasses.dataclass
class L4Filter:
    port: int
    protocol: str  # "TCP" | "UDP"
    ingress: bool
    endpoints: List[EndpointSelector] = dataclasses.field(default_factory=list)
    l7_parser: str = PARSER_NONE
    l7_rules_per_ep: Dict[EndpointSelector, L7Rules] = dataclasses.field(default_factory=dict)
    derived_from: List[LabelArray] = dataclasses.field(default_factory=list)

    @property
    def allows_all_at_l3(self) -> bool:
        return not self.endpoints or any(s.is_wildcard for s in self.endpoints)

    @property
    def is_redirect(self) -> bool:
        return self.l7_parser != PARSER_NONE

    def matches_labels(self, labels: LabelArray) -> bool:
        if self.allows_all_at_l3:
            return True
        if len(labels) == 0:
            return False
        return any(sel.matches(labels) for sel in self.endpoints)

    def key(self) -> str:
        return f"{self.port}/{self.protocol}"


def create_l4_filter(
    peer_endpoints: List[EndpointSelector],
    l7: L7Rules,
    port: int,
    protocol: str,
    rule_labels: LabelArray,
    ingress: bool,
    l3_override_endpoints: Tuple[EndpointSelector, ...] = (),
) -> L4Filter:
    """CreateL4{Ingress,Egress}Filter (pkg/policy/l4.go:148,210)."""
    endpoints = list(peer_endpoints)
    if not endpoints or any(s.is_wildcard for s in endpoints):
        endpoints = [WILDCARD]
    f = L4Filter(
        port=port,
        protocol=protocol,
        ingress=ingress,
        endpoints=endpoints,
        derived_from=[rule_labels],
    )
    if protocol == "TCP" and l7:
        f.l7_parser = l7.parser
        for sel in endpoints:
            f.l7_rules_per_ep[sel] = l7
        # Endpoints the daemon force-allows at L3 (host/world) get their
        # L7 rules wildcarded so traffic still flows through the proxy.
        for sel in l3_override_endpoints:
            f.l7_rules_per_ep[sel] = L7Rules()
    return f


def _merge_l7(existing: L7Rules, new: L7Rules) -> L7Rules:
    if new.http:
        if existing.kafka:
            raise MergeConflict("cannot merge conflicting L7 rule types")
        http = list(existing.http)
        for r in new.http:
            if r not in http:
                http.append(r)
        return L7Rules(http=tuple(http), kafka=existing.kafka)
    if new.kafka:
        if existing.http:
            raise MergeConflict("cannot merge conflicting L7 rule types")
        kafka = list(existing.kafka)
        for r in new.kafka:
            if r not in kafka:
                kafka.append(r)
        return L7Rules(http=existing.http, kafka=tuple(kafka))
    return existing


class L4PolicyMap:
    """port/proto → L4Filter with reference merge semantics."""

    def __init__(self) -> None:
        self.filters: Dict[str, L4Filter] = {}

    def __len__(self) -> int:
        return len(self.filters)

    def __iter__(self):
        return iter(self.filters.values())

    def get(self, port: int, protocol: str) -> Optional[L4Filter]:
        return self.filters.get(f"{port}/{protocol}")

    def merge(self, new: L4Filter) -> None:
        """mergeL4IngressPort (pkg/policy/rule.go:46-122)."""
        key = new.key()
        existing = self.filters.get(key)
        if existing is None:
            self.filters[key] = new
            return
        if existing.allows_all_at_l3 or new.allows_all_at_l3:
            existing.endpoints = [WILDCARD]
        else:
            existing.endpoints.extend(new.endpoints)
        if new.l7_parser != PARSER_NONE:
            if existing.l7_parser == PARSER_NONE:
                existing.l7_parser = new.l7_parser
            elif existing.l7_parser != new.l7_parser:
                raise MergeConflict(
                    f"cannot merge conflicting L7 parsers ({new.l7_parser}/{existing.l7_parser})"
                )
        for sel, rules in new.l7_rules_per_ep.items():
            if sel in existing.l7_rules_per_ep:
                existing.l7_rules_per_ep[sel] = _merge_l7(existing.l7_rules_per_ep[sel], rules)
            else:
                existing.l7_rules_per_ep[sel] = rules
        existing.derived_from.extend(new.derived_from)

    def has_redirect(self) -> bool:
        return any(f.is_redirect for f in self)

    def wildcard_l3l4(
        self, protocol: str, port: int, endpoints: List[EndpointSelector], rule_labels: LabelArray
    ) -> None:
        """wildcardL3L4Rule (pkg/policy/repository.go:128): L3-only /
        L3L4-only allows wildcard the L7 rules of matching filters so
        that broader allows aren't narrowed by L7 restrictions."""
        for f in self.filters.values():
            if protocol != f.protocol or (port != 0 and port != f.port):
                continue
            if f.l7_parser == PARSER_NONE:
                continue
            wildcard_rules = (
                L7Rules(http=(HTTPRule(),))
                if f.l7_parser == PARSER_HTTP
                else L7Rules(kafka=(KafkaRule(),))
            )
            # Exactly the given selectors — an empty list is a no-op
            # (an ingress rule with no From fields allows nothing at L3,
            # so it must not wildcard anyone, repository.go:128-158).
            for sel in endpoints:
                f.l7_rules_per_ep[sel] = wildcard_rules
            f.endpoints.extend(endpoints)
            f.derived_from.append(rule_labels)

    # -- trace-path coverage (containsAllL3L4, pkg/policy/l4.go:286) ----
    def covers_context(self, peer_labels: LabelArray, dports: Tuple[PortContext, ...]) -> Decision:
        if not self.filters:
            return Decision.ALLOWED
        if not dports:
            return Decision.DENIED
        for pc in dports:
            proto = (pc.protocol or "ANY").upper()
            if proto == "ANY":
                candidates = [self.get(pc.port, "TCP"), self.get(pc.port, "UDP")]
                if not any(f is not None and f.matches_labels(peer_labels) for f in candidates):
                    return Decision.DENIED
            else:
                f = self.get(pc.port, proto)
                if f is None or not f.matches_labels(peer_labels):
                    return Decision.DENIED
        return Decision.ALLOWED


@dataclasses.dataclass
class L4Policy:
    ingress: L4PolicyMap = dataclasses.field(default_factory=L4PolicyMap)
    egress: L4PolicyMap = dataclasses.field(default_factory=L4PolicyMap)
    revision: int = 0

    def has_redirect(self) -> bool:
        return self.ingress.has_redirect() or self.egress.has_redirect()

    def requires_conntrack(self) -> bool:
        return len(self.ingress) > 0 or len(self.egress) > 0
