"""CIDR policy resolution.

Reference: pkg/policy/cidr.go (CIDRPolicy with per-prefix-length
bookkeeping), pkg/policy/api/cidr.go (ComputeResultantCIDRSet — a
CIDRRule with exceptions is flattened into the covering set minus the
excepted subnets), pkg/policy/rule.go resolveCIDRPolicy/mergeCIDR.

The per-prefix-length map feeds the LPM tensor builder
(cilium_tpu_torch.ops.lpm) and the prefilter, mirroring how the reference
feeds cidrmap/ipcache prefixes.
"""

from __future__ import annotations

import dataclasses
import ipaddress
from typing import Dict, Iterable, List, Set, Tuple

from ..labels import LabelArray
from .api import CIDRRule, EndpointSelector


def compute_resultant_cidr_set(rules: Iterable[CIDRRule]) -> List[str]:
    """CIDRRule slice → flat allowed CIDR strings with exceptions carved
    out (api/cidr.go ComputeResultantCIDRSet)."""
    out: List[str] = []
    for r in rules:
        net = ipaddress.ip_network(r.cidr, strict=False)
        if not r.except_cidrs:
            out.append(str(net))
            continue
        remaining = [net]
        for ex in r.except_cidrs:
            ex_net = ipaddress.ip_network(ex, strict=False)
            next_remaining = []
            for n in remaining:
                if ex_net.version != n.version or not ex_net.subnet_of(n):
                    next_remaining.append(n)
                elif ex_net == n:
                    continue
                else:
                    next_remaining.extend(n.address_exclude(ex_net))
            remaining = next_remaining
        out.extend(str(n) for n in sorted(remaining))
    return out


def cidr_selectors(cidrs: Iterable[str], cidr_rules: Iterable[CIDRRule]) -> List[EndpointSelector]:
    """CIDR allows as label selectors over ``cidr:`` identity labels
    (api/cidr.go GetAsEndpointSelectors) — this is how CIDR peers join
    the same bitmap-matching path as label peers. The selector key must
    stay byte-identical to the identity-side label key, so both derive
    from labels.cidr.ip_string_to_label."""
    from ..labels.cidr import ip_string_to_label

    sels = []
    for c in list(cidrs) + compute_resultant_cidr_set(cidr_rules):
        lbl = ip_string_to_label(c)
        sels.append(EndpointSelector.make([f"{lbl.source}:{lbl.key}"]))
    return sels


@dataclasses.dataclass
class CIDRPolicyMap:
    """Allowed prefixes + the rules they derive from, with prefix-length
    reference counts (pkg/policy/cidr.go CIDRPolicyMapRule + counter)."""

    entries: Dict[str, List[LabelArray]] = dataclasses.field(default_factory=dict)

    def insert(self, cidr: str, rule_labels: LabelArray) -> int:
        net = ipaddress.ip_network(cidr, strict=False)
        key = str(net)
        if key in self.entries:
            self.entries[key].append(rule_labels)
            return 0
        self.entries[key] = [rule_labels]
        return 1

    def __len__(self) -> int:
        return len(self.entries)

    def prefixes(self) -> List[str]:
        return list(self.entries)

    def prefix_lengths(self) -> Set[Tuple[int, int]]:
        """{(ip_version, prefix_len)} — drives datapath shape decisions
        the way pkg/counter PrefixLengthCounter drives recompiles."""
        out = set()
        for key in self.entries:
            net = ipaddress.ip_network(key)
            out.add((net.version, net.prefixlen))
        return out


@dataclasses.dataclass
class CIDRPolicy:
    ingress: CIDRPolicyMap = dataclasses.field(default_factory=CIDRPolicyMap)
    egress: CIDRPolicyMap = dataclasses.field(default_factory=CIDRPolicyMap)
