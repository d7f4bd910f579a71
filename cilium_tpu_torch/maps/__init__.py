"""Realized datapath state maps (reference: pkg/maps/*)."""

from .policymap import PolicyMap
from .ctmap import ConntrackEntry, ConntrackMap

__all__ = ["PolicyMap", "ConntrackEntry", "ConntrackMap"]
