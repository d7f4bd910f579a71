"""Realized datapath state maps (reference: pkg/maps/*).

The port has the conntrack map only; the policy map comes with the
daemon slice."""

from .ctmap import ConntrackEntry, ConntrackMap

__all__ = ["ConntrackEntry", "ConntrackMap"]
