"""Policy engine: rule model, repository, resolved L4/CIDR policy.

The host side is the semantic oracle (reference: pkg/policy); the
device side (compiler + verdict kernels) lives in cilium_tpu_torch.compiler and
cilium_tpu_torch.ops and is differential-tested against this package.
"""

from .search import Decision, PortContext, SearchContext, Trace
from .repository import Repository
from .l4 import L4Filter, L4Policy, L4PolicyMap, MergeConflict, PARSER_HTTP, PARSER_KAFKA, PARSER_NONE
from .cidr import CIDRPolicy, CIDRPolicyMap, compute_resultant_cidr_set

__all__ = [
    "Decision",
    "PortContext",
    "SearchContext",
    "Trace",
    "Repository",
    "L4Filter",
    "L4Policy",
    "L4PolicyMap",
    "MergeConflict",
    "PARSER_HTTP",
    "PARSER_KAFKA",
    "PARSER_NONE",
    "CIDRPolicy",
    "CIDRPolicyMap",
    "compute_resultant_cidr_set",
]
