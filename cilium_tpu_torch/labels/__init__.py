"""Security labels.

Reference semantics: cilium pkg/labels (labels.go, array.go, cidr.go,
filter.go). Labels are (source, key, value) triples; a sorted
:class:`LabelArray` is the canonical key for a security identity.

TPU relevance: every label is interned into a global :class:`LabelVocab`
bit position so that identities and selectors become fixed-width packed
bitmaps (uint32 words) — the unit of the device-side matching kernels in
:mod:`cilium_tpu_torch.ops.bitmap`.
"""

from .label import Label, LabelArray, parse_label, parse_label_array
from .cidr import cidr_labels, ip_string_to_label
from .vocab import LabelVocab
from .filter import LabelFilter

SRC_K8S = "k8s"
SRC_CONTAINER = "container"
SRC_RESERVED = "reserved"
SRC_CIDR = "cidr"
SRC_UNSPEC = "unspec"
SRC_ANY = "any"

__all__ = [
    "Label",
    "LabelArray",
    "LabelVocab",
    "LabelFilter",
    "parse_label",
    "parse_label_array",
    "cidr_labels",
    "ip_string_to_label",
    "SRC_K8S",
    "SRC_CONTAINER",
    "SRC_RESERVED",
    "SRC_CIDR",
    "SRC_UNSPEC",
    "SRC_ANY",
]
