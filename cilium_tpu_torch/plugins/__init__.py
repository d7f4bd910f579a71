"""Orchestrator plumbing: the CNI-shaped endpoint lifecycle
(plugins/cilium-cni role)."""

from .cni import CNIError, CNIResult, cni_add, cni_del, endpoint_id_for

__all__ = ["CNIError", "CNIResult", "cni_add", "cni_del", "endpoint_id_for"]
