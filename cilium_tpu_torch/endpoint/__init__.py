"""Endpoint lifecycle (reference: pkg/endpoint, pkg/endpointmanager)."""

from .endpoint import Endpoint, EndpointState, RegenerationStats
from .manager import EndpointManager

__all__ = ["Endpoint", "EndpointState", "RegenerationStats", "EndpointManager"]
