"""Device-side functions, each on a hand-written CUDA kernel
(csrc/*.cu) with a plain PyTorch version for CPU tensors."""

from .bitmap import compute_selector_matches, pack_bool_bits
from .lookup import PolicymapTables, lookup_batch
from .materialize import EndpointPolicySnapshot, PolicyKey, materialize_endpoints
from .verdict import DeviceTables, DevicePolicy, Verdict, verdict_batch

__all__ = [
    "compute_selector_matches",
    "pack_bool_bits",
    "PolicymapTables",
    "lookup_batch",
    "EndpointPolicySnapshot",
    "PolicyKey",
    "materialize_endpoints",
    "DeviceTables",
    "DevicePolicy",
    "Verdict",
    "verdict_batch",
]
