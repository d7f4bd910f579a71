"""Process-lifecycle helpers for the agent's sidecar processes."""

from __future__ import annotations

import os
import signal
import sys


def die_with_parent(sig: int = signal.SIGTERM) -> None:
    """Arrange for THIS process to receive ``sig`` when its parent
    dies (Linux PR_SET_PDEATHSIG). The reference's sidecars
    (cilium-health, cilium-envoy) are reaped by the agent's launcher;
    a SIGKILLed agent can't reap, so the kernel does it instead.

    Called from the child's own main (not a preexec_fn — that forces
    the fork() slow path, which deadlocks under JAX's threads).
    Best-effort: a non-Linux platform is a no-op.

    Only arms when the launcher marked the process as supervised
    (CILIUM_TPU_PARENT_PID in the env): a manually launched
    ``python -m cilium_tpu_torch.monitor ... &`` must NOT die with the shell
    that started it."""
    if "CILIUM_TPU_PARENT_PID" not in os.environ:
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, sig)  # PR_SET_PDEATHSIG = 1
    except Exception:
        return
    # the parent may have died between fork and prctl — the signal
    # would never fire. The launcher passes its pid in the env, so the
    # authoritative check is "is my ppid still the launcher"; NOT
    # ppid==1 (an agent running as a container's PID 1 is a live
    # parent, not init-adoption).
    expected = os.environ.get("CILIUM_TPU_PARENT_PID")
    if expected and expected.isdigit() and os.getppid() != int(expected):
        sys.exit(0)
