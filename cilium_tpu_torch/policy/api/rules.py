"""The user-facing policy rule model.

Reference: pkg/policy/api/rule.go (Rule), ingress.go (IngressRule),
egress.go (EgressRule), l4.go (PortRule/PortProtocol), cidr.go
(CIDRRule), entity.go (entities), rule_validation.go (Sanitize).

Semantics preserved from the reference (v1.2 is allow-only):
- a Rule applies to endpoints selected by ``endpoint_selector``;
- IngressRule: allow from peers matching any ``from_endpoints`` /
  ``from_cidr{_set}`` / ``from_entities``; ``from_requires`` adds
  *constraints* (ANDed across all rules selecting the endpoint);
- EgressRule mirrors with to_*;
- ``to_ports`` restricts the allow to L4 ports and optionally attaches
  L7 rules enforced by the proxy layer.
"""

from __future__ import annotations

import dataclasses
import ipaddress
from typing import Iterable, Optional, Sequence, Tuple

from ...labels import LabelArray, parse_label_array
from .l7 import L7Rules
from .selector import EndpointSelector

PROTO_TCP = "TCP"
PROTO_UDP = "UDP"
PROTO_ANY = "ANY"
_PROTOCOLS = (PROTO_TCP, PROTO_UDP, PROTO_ANY)

# Entities (pkg/policy/api/entity.go): named peers that expand to
# reserved-label selectors.
ENTITY_HOST = "host"
ENTITY_WORLD = "world"
ENTITY_CLUSTER = "cluster"
ENTITY_ALL = "all"
ENTITY_INIT = "init"  # initializing endpoints (entity.go:41)
_ENTITY_SELECTORS = {
    ENTITY_HOST: EndpointSelector.make(["reserved:host"]),
    ENTITY_WORLD: EndpointSelector.make(["reserved:world"]),
    ENTITY_CLUSTER: EndpointSelector.make(["reserved:cluster"]),
    ENTITY_ALL: EndpointSelector.wildcard(),
    ENTITY_INIT: EndpointSelector.make(["reserved:init"]),
}


def entity_selector(entity: str) -> EndpointSelector:
    try:
        return _ENTITY_SELECTORS[entity.lower()]
    except KeyError:
        raise ValueError(f"unknown entity {entity!r}") from None


@dataclasses.dataclass(frozen=True)
class PortProtocol:
    """One L4 port (l4.go PortProtocol). Ports are matched literally
    throughout (L4PolicyMap keys "port/proto" exactly), including 0."""

    port: int
    protocol: str = PROTO_ANY

    def sanitize(self) -> None:
        if not (0 <= self.port <= 65535):
            raise ValueError(f"invalid port {self.port}")
        if self.protocol.upper() not in _PROTOCOLS:
            raise ValueError(f"invalid protocol {self.protocol!r}")

    @property
    def proto(self) -> str:
        return self.protocol.upper()

    def __str__(self) -> str:
        return f"{self.port}/{self.proto}"


@dataclasses.dataclass(frozen=True)
class PortRule:
    """L4 allow with optional L7 refinement (l4.go PortRule)."""

    ports: Tuple[PortProtocol, ...]
    rules: L7Rules = L7Rules()
    redirect_port: int = 0  # legacy explicit proxy port (l4.go:52)

    def sanitize(self) -> None:
        if not self.ports:
            raise ValueError("PortRule needs at least one port")
        for p in self.ports:
            p.sanitize()
        self.rules.sanitize()
        if self.rules:
            for p in self.ports:
                if p.port == 0:
                    raise ValueError("L7 rules require a concrete port")


def host_cidr(ip: str) -> str:
    """ip → its single-address CIDR (/32 or /128) — shared by the
    translators that synthesize per-address CIDRRules (ToServices,
    ToFQDNs) so their generated entries stay mutually comparable."""
    addr = ipaddress.ip_address(ip)
    return f"{ip}/{32 if addr.version == 4 else 128}"


@dataclasses.dataclass(frozen=True)
class CIDRRule:
    """CIDR with carve-outs (cidr.go CIDRRule). ``generated`` marks
    entries synthesized by a translator (ToServices/ToFQDNs expansion,
    rule_translate.go CIDRRule.Generated) so reverts only remove what
    translation added."""

    cidr: str
    except_cidrs: Tuple[str, ...] = ()
    generated: bool = False
    # which translator synthesized this entry ("fqdn", "service", "")
    # — each translator replaces only its own entries on re-translate
    generated_by: str = ""

    def sanitize(self) -> None:
        net = ipaddress.ip_network(self.cidr, strict=False)
        for ex in self.except_cidrs:
            ex_net = ipaddress.ip_network(ex, strict=False)
            if ex_net.version != net.version or not ex_net.subnet_of(net):
                raise ValueError(f"except CIDR {ex} not contained in {self.cidr}")


@dataclasses.dataclass(frozen=True)
class IngressRule:
    from_endpoints: Tuple[EndpointSelector, ...] = ()
    from_requires: Tuple[EndpointSelector, ...] = ()
    from_cidr: Tuple[str, ...] = ()
    from_cidr_set: Tuple[CIDRRule, ...] = ()
    from_entities: Tuple[str, ...] = ()
    to_ports: Tuple[PortRule, ...] = ()

    def sanitize(self) -> None:
        for c in self.from_cidr:
            ipaddress.ip_network(c, strict=False)
        for cs in self.from_cidr_set:
            cs.sanitize()
        for e in self.from_entities:
            entity_selector(e)
        for pr in self.to_ports:
            pr.sanitize()

    def peer_selectors(self) -> Tuple[EndpointSelector, ...]:
        """All L3 peer selectors this rule allows (endpoints + entities);
        CIDR peers are resolved separately through CIDR identities."""
        return self.from_endpoints + tuple(entity_selector(e) for e in self.from_entities)

    @property
    def allows_all_l3(self) -> bool:
        """True when no L3 restriction is present (an empty from_* list
        with to_ports means 'any peer on these ports', ingress.go)."""
        return not (
            self.from_endpoints or self.from_cidr or self.from_cidr_set or self.from_entities
        )


@dataclasses.dataclass(frozen=True)
class EgressRule:
    to_endpoints: Tuple[EndpointSelector, ...] = ()
    to_requires: Tuple[EndpointSelector, ...] = ()
    to_cidr: Tuple[str, ...] = ()
    to_cidr_set: Tuple[CIDRRule, ...] = ()
    to_entities: Tuple[str, ...] = ()
    to_ports: Tuple[PortRule, ...] = ()
    to_services: Tuple["ServiceSelector", ...] = ()
    to_fqdns: Tuple[str, ...] = ()  # DNS names → generated to_cidr_set (pkg/fqdn)

    def sanitize(self) -> None:
        for c in self.to_cidr:
            ipaddress.ip_network(c, strict=False)
        for cs in self.to_cidr_set:
            cs.sanitize()
        for e in self.to_entities:
            entity_selector(e)
        for pr in self.to_ports:
            pr.sanitize()

    def peer_selectors(self) -> Tuple[EndpointSelector, ...]:
        return self.to_endpoints + tuple(entity_selector(e) for e in self.to_entities)

    @property
    def allows_all_l3(self) -> bool:
        return not (
            self.to_endpoints
            or self.to_cidr
            or self.to_cidr_set
            or self.to_entities
            or self.to_services
            or self.to_fqdns
        )


@dataclasses.dataclass(frozen=True)
class ServiceSelector:
    """k8s service reference (pkg/policy/api/service.go Service):
    either a direct name+namespace (K8sService) or a label selector over
    service labels (K8sServiceSelector). Resolved by the orchestrator
    layer (k8s/rule_translate.py) into endpoint IPs → CIDR set."""

    name: str = ""
    namespace: str = ""
    selector: Optional["EndpointSelector"] = None


@dataclasses.dataclass(frozen=True)
class Rule:
    """One policy rule (rule.go Rule)."""

    endpoint_selector: EndpointSelector
    ingress: Tuple[IngressRule, ...] = ()
    egress: Tuple[EgressRule, ...] = ()
    labels: LabelArray = dataclasses.field(default_factory=LabelArray)
    description: str = ""

    def sanitize(self) -> None:
        """Validation (rule_validation.go Sanitize)."""
        if self.endpoint_selector is None:
            raise ValueError("rule needs an endpoint selector")
        for r in self.ingress:
            r.sanitize()
        for r in self.egress:
            r.sanitize()


def rule(
    selector: Sequence[str],
    ingress: Iterable[IngressRule] = (),
    egress: Iterable[EgressRule] = (),
    labels: Optional[Sequence[str]] = None,
    description: str = "",
) -> Rule:
    """Convenience constructor from label strings."""
    return Rule(
        endpoint_selector=EndpointSelector.make(list(selector)),
        ingress=tuple(ingress),
        egress=tuple(egress),
        labels=parse_label_array(labels or []),
        description=description,
    )
