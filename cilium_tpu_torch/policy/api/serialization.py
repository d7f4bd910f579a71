"""JSON (de)serialization of policy rules.

Wire format follows the reference's JSON policy documents (the format
accepted by ``cilium policy import``, pkg/policy/api JSON tags):
camelCase keys, k8s-style LabelSelector for endpointSelector, e.g.::

    [{
      "endpointSelector": {"matchLabels": {"app": "web"}},
      "ingress": [{
        "fromEndpoints": [{"matchLabels": {"role": "frontend"}}],
        "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                     "rules": {"http": [{"method": "GET", "path": "/public.*"}]}}]
      }],
      "labels": ["k8s:name=web-policy"]
    }]
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Sequence

from ...labels import parse_label_array
from .l7 import HTTPRule, KafkaRule, L7Rules
from .rules import (
    CIDRRule,
    EgressRule,
    IngressRule,
    PortProtocol,
    PortRule,
    Rule,
    ServiceSelector,
)
from .selector import EndpointSelector, MatchExpression


def _selector_from_dict(d: Dict[str, Any]) -> EndpointSelector:
    exprs = tuple(
        MatchExpression(
            key=e["key"], operator=e["operator"], values=tuple(e.get("values") or ())
        )
        for e in d.get("matchExpressions") or ()
    )
    return EndpointSelector.make(d.get("matchLabels") or {}, exprs)


def _selector_to_dict(s: EndpointSelector) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if s.match_labels:
        out["matchLabels"] = dict(s.match_labels)
    if s.match_expressions:
        out["matchExpressions"] = [
            {"key": e.key, "operator": e.operator, **({"values": list(e.values)} if e.values else {})}
            for e in s.match_expressions
        ]
    return out


def _ports_from_dict(entries: Iterable[Dict[str, Any]]) -> tuple:
    out = []
    for pr in entries or ():
        ports = tuple(
            PortProtocol(port=int(p.get("port", 0) or 0), protocol=p.get("protocol", "ANY") or "ANY")
            for p in pr.get("ports") or ()
        )
        rules_d = pr.get("rules") or {}
        l7 = L7Rules(
            http=tuple(
                HTTPRule(
                    path=h.get("path", ""),
                    method=h.get("method", ""),
                    host=h.get("host", ""),
                    headers=tuple(h.get("headers") or ()),
                )
                for h in rules_d.get("http") or ()
            ),
            kafka=tuple(
                KafkaRule(
                    role=k.get("role", ""),
                    api_key=k.get("apiKey", ""),
                    api_version=str(k.get("apiVersion", "") or ""),
                    client_id=k.get("clientID", ""),
                    topic=k.get("topic", ""),
                )
                for k in rules_d.get("kafka") or ()
            ),
        )
        out.append(PortRule(ports=ports, rules=l7, redirect_port=int(pr.get("redirectPort", 0) or 0)))
    return tuple(out)


def _ports_to_dict(port_rules: Sequence[PortRule]) -> List[Dict[str, Any]]:
    out = []
    for pr in port_rules:
        d: Dict[str, Any] = {
            "ports": [{"port": str(p.port), "protocol": p.proto} for p in pr.ports]
        }
        rules: Dict[str, Any] = {}
        if pr.rules.http:
            rules["http"] = [
                {
                    k: v
                    for k, v in (
                        ("path", h.path),
                        ("method", h.method),
                        ("host", h.host),
                        ("headers", list(h.headers)),
                    )
                    if v
                }
                for h in pr.rules.http
            ]
        if pr.rules.kafka:
            rules["kafka"] = [
                {
                    k: v
                    for k, v in (
                        ("role", kr.role),
                        ("apiKey", kr.api_key),
                        ("apiVersion", kr.api_version),
                        ("clientID", kr.client_id),
                        ("topic", kr.topic),
                    )
                    if v
                }
                for kr in pr.rules.kafka
            ]
        if rules:
            d["rules"] = rules
        if pr.redirect_port:
            d["redirectPort"] = pr.redirect_port
        out.append(d)
    return out


def _cidr_set(entries: Iterable[Dict[str, Any]]) -> tuple:
    return tuple(
        CIDRRule(
            cidr=c["cidr"],
            except_cidrs=tuple(c.get("except") or ()),
            generated=bool(c.get("generated", False)),
            generated_by=str(c.get("generatedBy", "")),
        )
        for c in entries or ()
    )


def rule_from_dict(d: Dict[str, Any]) -> Rule:
    ingress = tuple(
        IngressRule(
            from_endpoints=tuple(_selector_from_dict(s) for s in r.get("fromEndpoints") or ()),
            from_requires=tuple(_selector_from_dict(s) for s in r.get("fromRequires") or ()),
            from_cidr=tuple(r.get("fromCIDR") or ()),
            from_cidr_set=_cidr_set(r.get("fromCIDRSet")),
            from_entities=tuple(r.get("fromEntities") or ()),
            to_ports=_ports_from_dict(r.get("toPorts")),
        )
        for r in d.get("ingress") or ()
    )
    egress = tuple(
        EgressRule(
            to_endpoints=tuple(_selector_from_dict(s) for s in r.get("toEndpoints") or ()),
            to_requires=tuple(_selector_from_dict(s) for s in r.get("toRequires") or ()),
            to_cidr=tuple(r.get("toCIDR") or ()),
            to_cidr_set=_cidr_set(r.get("toCIDRSet")),
            to_entities=tuple(r.get("toEntities") or ()),
            to_ports=_ports_from_dict(r.get("toPorts")),
            to_services=tuple(
                ServiceSelector(
                    name=(s.get("k8sService") or {}).get("serviceName", ""),
                    namespace=(s.get("k8sService") or {}).get("namespace", "")
                    or (s.get("k8sServiceSelector") or {}).get("namespace", ""),
                    selector=(
                        _selector_from_dict((s.get("k8sServiceSelector") or {}).get("selector") or {})
                        if s.get("k8sServiceSelector")
                        else None
                    ),
                )
                for s in r.get("toServices") or ()
            ),
            to_fqdns=tuple(f.get("matchName", "") for f in r.get("toFQDNs") or ()),
        )
        for r in d.get("egress") or ()
    )
    return Rule(
        endpoint_selector=_selector_from_dict(d.get("endpointSelector") or {}),
        ingress=ingress,
        egress=egress,
        labels=parse_label_array(_label_strings(d.get("labels") or [])),
        description=d.get("description", ""),
    )


def _label_strings(entries: Iterable[Any]) -> List[str]:
    """Labels appear either as strings ("k8s:name=web") or as decoded
    Label objects ({"key": ..., "value": ..., "source": ...} — the
    reference's labels.Label JSON shape)."""
    out: List[str] = []
    for e in entries:
        if isinstance(e, str):
            out.append(e)
        else:
            src = e.get("source") or "unspec"
            kv = e.get("key", "")
            if e.get("value"):
                kv = f"{kv}={e['value']}"
            out.append(f"{src}:{kv}" if src != "unspec" else kv)
    return out


def rule_to_dict(r: Rule) -> Dict[str, Any]:
    d: Dict[str, Any] = {"endpointSelector": _selector_to_dict(r.endpoint_selector)}
    if r.ingress:
        d["ingress"] = []
        for ing in r.ingress:
            rd: Dict[str, Any] = {}
            if ing.from_endpoints:
                rd["fromEndpoints"] = [_selector_to_dict(s) for s in ing.from_endpoints]
            if ing.from_requires:
                rd["fromRequires"] = [_selector_to_dict(s) for s in ing.from_requires]
            if ing.from_cidr:
                rd["fromCIDR"] = list(ing.from_cidr)
            if ing.from_cidr_set:
                rd["fromCIDRSet"] = [
                    {
                        "cidr": c.cidr,
                        **({"except": list(c.except_cidrs)} if c.except_cidrs else {}),
                        **({"generated": True} if c.generated else {}),
                        **({"generatedBy": c.generated_by} if c.generated_by else {}),
                    }
                    for c in ing.from_cidr_set
                ]
            if ing.from_entities:
                rd["fromEntities"] = list(ing.from_entities)
            if ing.to_ports:
                rd["toPorts"] = _ports_to_dict(ing.to_ports)
            d["ingress"].append(rd)
    if r.egress:
        d["egress"] = []
        for eg in r.egress:
            rd = {}
            if eg.to_endpoints:
                rd["toEndpoints"] = [_selector_to_dict(s) for s in eg.to_endpoints]
            if eg.to_requires:
                rd["toRequires"] = [_selector_to_dict(s) for s in eg.to_requires]
            if eg.to_cidr:
                rd["toCIDR"] = list(eg.to_cidr)
            if eg.to_cidr_set:
                rd["toCIDRSet"] = [
                    {
                        "cidr": c.cidr,
                        **({"except": list(c.except_cidrs)} if c.except_cidrs else {}),
                        **({"generated": True} if c.generated else {}),
                        **({"generatedBy": c.generated_by} if c.generated_by else {}),
                    }
                    for c in eg.to_cidr_set
                ]
            if eg.to_entities:
                rd["toEntities"] = list(eg.to_entities)
            if eg.to_ports:
                rd["toPorts"] = _ports_to_dict(eg.to_ports)
            if eg.to_services:
                rd["toServices"] = [
                    (
                        {
                            "k8sServiceSelector": {
                                "selector": _selector_to_dict(s.selector),
                                **({"namespace": s.namespace} if s.namespace else {}),
                            }
                        }
                        if s.selector is not None
                        else {"k8sService": {"serviceName": s.name, "namespace": s.namespace}}
                    )
                    for s in eg.to_services
                ]
            if eg.to_fqdns:
                rd["toFQDNs"] = [{"matchName": f} for f in eg.to_fqdns]
            d["egress"].append(rd)
    if len(r.labels):
        d["labels"] = list(r.labels.to_strings())
    if r.description:
        d["description"] = r.description
    return d


def rules_from_json(text: str) -> List[Rule]:
    data = json.loads(text)
    if isinstance(data, dict):
        data = [data]
    rules = [rule_from_dict(d) for d in data]
    for r in rules:
        r.sanitize()
    return rules


def rules_to_json(rules: Iterable[Rule], indent: int | None = 2) -> str:
    return json.dumps([rule_to_dict(r) for r in rules], indent=indent)
