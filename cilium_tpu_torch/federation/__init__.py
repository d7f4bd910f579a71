"""policyd-fed: cluster federation — one identity plane and policy
epoch across N daemon nodes.

The subsystem that makes N daemon processes behave as ONE policy
plane (PAPER.md layer 5, pkg/allocator + pkg/clustermesh roles):

- :mod:`identity_plane` — cluster-wide identity allocation over the
  kvstore with a reserve/confirm CAS protocol, per-node leases with
  heartbeat renewal, and a local read-through cache. Two nodes
  labeling the same label set always converge to the same small
  integer; a partition can stall an allocation but never fork one.
- :mod:`epochs` — node registry + policy-epoch exchange: every node
  publishes its descriptor and current ``policy_epoch`` (the EpochSwap
  counter) under a lease, watches peers, and exposes the
  ``wait_cluster_epoch`` convergence barrier.
- :mod:`member` — one daemon's membership: composes the allocator and
  the exchange, bridges the identity registry, and drives heartbeats
  from the controller pump.
- :mod:`bootstrap` — multi-process mesh bring-up:
  ``torch.distributed.init_process_group`` (gloo) keyed off
  ``mesh_process_index`` feeding ``PlacementConfig.process_index``
  so MeshPlan spans hosts.

See README.md in this package for the lease/CAS protocol and its
failure modes.
"""

from .bootstrap import mesh_bootstrap, placement_config
from .epochs import EpochExchange
from .identity_plane import ClusterIdentityAllocator, FederationError
from .member import FederationMember

__all__ = [
    "ClusterIdentityAllocator",
    "EpochExchange",
    "FederationError",
    "FederationMember",
    "mesh_bootstrap",
    "placement_config",
]
