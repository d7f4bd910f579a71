"""Node health probing (the cilium-health role: pkg/health +
cilium-health daemon — connectivity probes across the node registry)."""

from .prober import DEFAULT_HEALTH_PORT, HealthProber, NodeStatus, tcp_probe

__all__ = ["DEFAULT_HEALTH_PORT", "HealthProber", "NodeStatus", "tcp_probe"]
