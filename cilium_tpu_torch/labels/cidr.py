"""CIDR → label expansion.

Reference semantics: pkg/labels/cidr.go — an IP/prefix gets one ``cidr:``
label *per covering prefix length* (0..n), so a selector written against
``cidr:10.0.0.0/8`` matches the identity allocated for ``10.1.2.3/32``.
IPv6 colons are replaced with dashes in the label key (labels may not
contain ':').

The full expansion is what lets CIDR policy participate in the same
bitmap-matching kernels as every other label; the LPM *datapath* lookup
is handled separately by the bit-trie tensors in cilium_tpu_torch.ops.lpm.
"""

from __future__ import annotations

import ipaddress
from typing import List, Union

from .label import Label

_Network = Union[ipaddress.IPv4Network, ipaddress.IPv6Network]


def _format_net(net: _Network) -> str:
    return f"{net.network_address}/{net.prefixlen}".replace(":", "-")


def ip_string_to_label(cidr: str) -> Label:
    """The exact-prefix ``cidr:`` label for one CIDR string."""
    net = ipaddress.ip_network(cidr, strict=False)
    return Label(source="cidr", key=_format_net(net))


def cidr_labels(cidr: str) -> List[Label]:
    """All covering-prefix labels for ``cidr``, widest first.

    ``10.1.2.0/24`` → [cidr:0.0.0.0/0, cidr:10.0.0.0/8 … cidr:10.1.2.0/24]
    (every prefix length, not just octet boundaries, matching the
    reference's maskedIPToLabelString loop).
    """
    net = ipaddress.ip_network(cidr, strict=False)
    labels = []
    for plen in range(net.prefixlen + 1):
        super_net = net.supernet(new_prefix=plen) if plen < net.prefixlen else net
        labels.append(Label(source="cidr", key=_format_net(super_net)))
    return labels
