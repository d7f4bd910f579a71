"""Multi-process mesh bootstrap: torch.distributed keyed off the
daemon's ``mesh_process_index``.

Placement is an explicit MeshPlan and ``PlacementConfig.process_index``
is plumbed through option.py, but past one process the field needs a
fleet to mean anything. This module is the bring-up:
``mesh_bootstrap`` joins a ``torch.distributed`` process group, after
which ``datapath.placement.visible_devices()`` tags this process's CUDA
cards with its rank, and ``placement_config`` builds the
PlacementConfig whose ``process_index`` filter
(placement.eligible_devices) then selects exactly those cards.

The group is gloo on a TCP rendezvous at the coordinator. It only
coordinates: the summary's device counts are gathered over it once,
and NCCL would refuse two ranks on one card. The rendezvous waits at
most :data:`INIT_TIMEOUT_S` (torch's own default is 30 minutes).

CPU recipe (what tests/test_torch_mesh_bootstrap.py subprocesses):
each process calls ``mesh_bootstrap("127.0.0.1:<port>",
num_processes=N, process_index=i)``; every process sees the summed
card count of the fleet as ``global_devices`` and its own as
``local_devices``, and per-process ``resolve_plan`` yields the same
generation and axis layout.

Initialization is process-global in torch.distributed, hence
idempotent here: a second call returns the first call's summary
(coordinator mismatch raises — silently reusing a different fleet
would be worse).
"""

from __future__ import annotations

import datetime
import threading
from typing import Dict, Optional

import torch

from ..option import get_config

#: Seconds the rendezvous and the first collective may take before the
#: bootstrap fails.
INIT_TIMEOUT_S = 60.0

_lock = threading.Lock()
_summary: Optional[Dict] = None


def mesh_bootstrap(
    coordinator_address: str,
    num_processes: int,
    process_index: Optional[int] = None,
) -> Dict:
    """Join (or found) the multi-process mesh; returns a summary of the
    resulting device complement. ``process_index`` defaults to the
    daemon config's ``mesh_process_index``."""
    if process_index is None:
        process_index = get_config().mesh_process_index
    global _summary
    with _lock:
        if _summary is not None:
            if _summary["coordinator"] != coordinator_address:
                raise RuntimeError(
                    "mesh already initialized against "
                    f"{_summary['coordinator']!r}, refusing "
                    f"{coordinator_address!r}"
                )
            return dict(_summary)
        import torch.distributed as dist

        if not dist.is_available():
            raise RuntimeError("torch.distributed unavailable for mesh bootstrap")
        try:
            dist.init_process_group(
                "gloo",
                init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes),
                rank=int(process_index),
                timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
            )
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(
                f"torch.distributed.init_process_group failed for process "
                f"{process_index}/{num_processes} at "
                f"{coordinator_address}: {e}"
            )
        local = torch.cuda.device_count() if torch.cuda.is_available() else 0
        counts = [None] * dist.get_world_size()
        try:
            dist.all_gather_object(counts, local)
        except RuntimeError as e:
            dist.destroy_process_group()
            raise RuntimeError(
                f"mesh bootstrap lost the fleet while gathering device "
                f"counts for process {process_index}/{num_processes} at "
                f"{coordinator_address}: {e}"
            )
        _summary = {
            "initialized": True,
            "coordinator": coordinator_address,
            "num_processes": int(num_processes),
            "process_index": int(dist.get_rank()),
            "process_count": int(dist.get_world_size()),
            "global_devices": int(sum(counts)),
            "local_devices": int(local),
        }
        return dict(_summary)


def bootstrap_state() -> Optional[Dict]:
    """The last successful bootstrap summary (None standalone)."""
    with _lock:
        return dict(_summary) if _summary is not None else None


def placement_config(process_index: Optional[int] = None):
    """The PlacementConfig for this host's slice of the fleet mesh —
    same construction the daemon ctor uses, with ``process_index``
    resolvable from the live bootstrap instead of static config."""
    from ..datapath.placement import PlacementConfig

    cfg = get_config()
    if process_index is None:
        state = bootstrap_state()
        process_index = (
            state["process_index"] if state else cfg.mesh_process_index
        )
    return PlacementConfig(
        device_ids=(
            tuple(int(x) for x in cfg.mesh_devices.split(","))
            if cfg.mesh_devices
            else None
        ),
        ident_axis=cfg.mesh_ident_axis,
        process_index=process_index,
    )
