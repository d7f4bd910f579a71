"""Security identities.

Reference semantics: pkg/identity — an identity is a small integer bound
to a canonical LabelArray. Reserved identities (pkg/identity/
numericidentity.go): host=1, world=2, cluster=3, health=4, init=5.
User identities live in [256, 65535] (pkg/identity/allocator.go:77-78);
CIDR-derived identities are node-local (allocator.go cidr/).

TPU-first addition: the :class:`IdentityRegistry` also owns the *dense
row index* — identity IDs are sparse, device tensors are dense, so every
known identity gets a stable row in the packed label-bitmap matrix that
the policy compiler ships to the device.
"""

from .model import (
    Identity,
    ID_HOST,
    ID_WORLD,
    ID_CLUSTER,
    ID_HEALTH,
    ID_INIT,
    ID_INVALID,
    MIN_USER_IDENTITY,
    MAX_USER_IDENTITY,
    LOCAL_IDENTITY_BASE,
    RESERVED_IDENTITIES,
    reserved_identity_labels,
    lookup_reserved,
)
from .registry import IdentityRegistry

__all__ = [
    "Identity",
    "IdentityRegistry",
    "ID_HOST",
    "ID_WORLD",
    "ID_CLUSTER",
    "ID_HEALTH",
    "ID_INIT",
    "ID_INVALID",
    "MIN_USER_IDENTITY",
    "MAX_USER_IDENTITY",
    "LOCAL_IDENTITY_BASE",
    "RESERVED_IDENTITIES",
    "reserved_identity_labels",
    "lookup_reserved",
]
