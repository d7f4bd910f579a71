"""Placement subsystem — device selection and mesh planning.

The pipeline formed an implicit 1D "flows" mesh over every visible
device, every table replicated onto all of them. This module makes
placement an explicit, testable object:

  PlacementConfig  — what the operator asked for (device subset,
                     2D ``flows×ident`` axes, per-host process index)
  MeshPlan         — what the pipeline actually runs on (the device
                     grid, the axis shardings, a generation counter)

``resolve_plan`` is the only constructor of MeshPlans. It is pure with
respect to its inputs (config + requested modes + excluded set +
previous plan) and to :func:`visible_devices`. The generation counter
bumps whenever the resolved device set or axis layout changes —
callers key placed-table caches on it so a plan move can never serve
tables placed on a stale grid.

2D sharding splits the device grid into ``flows × ident``: flow
batches split over the ``flows`` axis, while the identity dimension
(dim 0) of the policymap bitmaps / rule tables / sel_match matrices
row-shards over ``ident`` (``ops/lookup.py`` ``shard_tables_ident``)
and every row fetch reads the shard that owns the row (in place, or
through ``ident_gather_rows`` across devices). LPM trie nodes stay
replicated. With ``ident`` of size 1 or 2D off, the plan is the 1D /
replicated layout.

The device grid is a tuple of :class:`DeviceRecord` rows shaped
``[flows][ident]`` (a 1D plan: ``[n][1]``); the three shardings are
:class:`GridSharding` descriptors of that grid with the reference's
partition specs as tuples: ``("flows",)``, ``()`` and
``("ident", None)``. :func:`visible_devices` lists one record per CUDA
card; it is the one seam tests and chip_smoke.py replace with a
virtual list (eight CPU records, or four records on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DeviceRecord:
    """One device a plan may place on: its id, the process that owns
    it and the torch device its tensors live on. Several records may
    name one torch device (a virtual grid)."""

    id: int
    process_index: int
    device: torch.device


def visible_devices() -> List[DeviceRecord]:
    """One record per visible CUDA card, in device order, owned by this
    process: its torch.distributed rank once a process group is up (a
    mesh bootstrap), else 0. Ids are this process's card indices."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    proc = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return [DeviceRecord(i, proc, torch.device("cuda", i)) for i in range(n)]


Grid = Tuple[Tuple[DeviceRecord, ...], ...]


@dataclasses.dataclass(frozen=True)
class GridSharding:
    """A placement over a device grid: ``spec`` is the reference's
    PartitionSpec as a tuple — ``("flows",)`` splits dim 0 over the
    grid's rows, ``()`` replicates on every device, ``("ident", None)``
    splits dim 0 over the grid's columns and replicates over its rows."""

    grid: Grid
    spec: Tuple

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The distinct torch devices of the grid, in grid order."""
        out: List[torch.device] = []
        for row in self.grid:
            for rec in row:
                if rec.device not in out:
                    out.append(rec.device)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Operator-facing placement intent (daemon config → pipeline ctor).

    ``device_ids``: explicit device subset (None = all visible).
    ``ident_axis``: requested size of the ``ident`` mesh axis when 2D
    sharding is on; the resolver shrinks it to the largest factor of
    the eligible device count that fits (≥2, else the plan stays 1D).
    ``process_index``: on multi-host platforms, restrict the plan to
    devices owned by this process (single-host: 0 matches everything;
    a non-matching index falls back to the unfiltered set rather than
    an empty mesh so a misconfigured daemon degrades, not crashes).
    """

    device_ids: Optional[Tuple[int, ...]] = None
    ident_axis: int = 2
    process_index: int = 0


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A resolved placement: the grid the pipeline runs on right now.

    ``flow_sharding`` places per-flow batch arrays (``("flows",)``),
    ``table_sharding`` replicates across the whole grid (``()``), and
    ``ident_sharding`` — non-None only on a 2D plan — row-shards
    ``[N, *]`` identity tables (``("ident", None)``). ``flows_size``
    is the flows-axis extent: the per-shard span math uses it, NOT the
    total device count (on a ``{'flows': 4, 'ident': 2}`` grid a batch
    splits 4 ways, not 8). ``mesh`` is the grid, None without one.
    """

    generation: int
    mesh: Optional[Grid]
    flow_sharding: Optional[GridSharding]
    table_sharding: Optional[GridSharding]
    ident_sharding: Optional[GridSharding]
    flows_size: int
    device_ids: Tuple[int, ...]
    axes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def is_2d(self) -> bool:
        return self.ident_sharding is not None

    @property
    def ident_size(self) -> int:
        return self.axes.get("ident", 1)


#: The pre-mesh state: host-only, no placement at all. Callers start
#: from this so the first resolve always bumps to generation 1.
EMPTY_PLAN = MeshPlan(
    generation=0,
    mesh=None,
    flow_sharding=None,
    table_sharding=None,
    ident_sharding=None,
    flows_size=1,
    device_ids=(),
    axes={},
)


def _ident_factor(n: int, want: int) -> int:
    """Largest factor of ``n`` that is ≤ ``want`` and ≥ 2 (1 = no 2D
    split possible — odd/prime device counts fall back to 1D)."""
    best = 1
    for f in range(2, max(2, want) + 1):
        if f <= n and n % f == 0:
            best = f
    return best


def eligible_devices(
    config: Optional[PlacementConfig],
    excluded: FrozenSet[int] = frozenset(),
) -> List[DeviceRecord]:
    """Devices the plan may use, in a deterministic order: the config
    subset (or all visible), filtered to this host's process, minus
    the excluded set. Never returns empty while a device is visible:
    exclusion of every eligible device falls back to the FIRST
    CONFIG-ELIGIBLE device — not the first visible one — so a
    placement-restricted pipeline never lands on hardware it was told
    not to touch."""
    all_devs = visible_devices()
    if config is not None and config.device_ids:
        wanted = set(config.device_ids)
        devs = [d for d in all_devs if d.id in wanted]
        if not devs:  # config names no visible device: degrade to all
            devs = list(all_devs)
    else:
        devs = list(all_devs)
    if config is not None:
        proc = [d for d in devs if d.process_index == config.process_index]
        if proc:
            devs = proc
    live = [d for d in devs if d.id not in excluded]
    if not live:
        live = devs[:1]
    return live


def resolve_plan(
    config: Optional[PlacementConfig],
    *,
    sharding: bool,
    mesh_2d: bool = False,
    excluded: FrozenSet[int] = frozenset(),
    prev: Optional[MeshPlan] = None,
) -> MeshPlan:
    """Resolve the placement intent into a MeshPlan.

    Returns ``prev`` unchanged (same generation) when the resolved
    device tuple AND axis layout match it, so placed tables survive
    no-op refreshes. Any real change (a device excluded, sharding/2D
    toggled, config swap) produces a new plan with
    ``prev.generation + 1``.
    """
    prev = prev or EMPTY_PLAN
    devs = eligible_devices(config, excluded)
    n = len(devs)

    want_mesh = sharding and n > 1
    ident = 0
    if want_mesh and mesh_2d:
        want = config.ident_axis if config is not None else 2
        f = _ident_factor(n, want)
        if f >= 2 and n // f >= 1:
            ident = f

    if ident >= 2:
        axes = {"flows": n // ident, "ident": ident}
    elif want_mesh:
        axes = {"flows": n}
    else:
        axes = {}

    ids = tuple(d.id for d in devs)
    if ids == prev.device_ids and axes == prev.axes:
        return prev

    gen = prev.generation + 1
    if not want_mesh:
        return MeshPlan(
            generation=gen,
            mesh=None,
            flow_sharding=None,
            table_sharding=None,
            ident_sharding=None,
            flows_size=1,
            device_ids=ids,
            axes={},
        )

    if ident >= 2:
        # row-major like np.array(devs).reshape(flows, ident): device i
        # sits at (flows i // ident, ident i % ident)
        grid: Grid = tuple(tuple(devs[r * ident:(r + 1) * ident]) for r in range(n // ident))
        return MeshPlan(
            generation=gen,
            mesh=grid,
            flow_sharding=GridSharding(grid, ("flows",)),
            table_sharding=GridSharding(grid, ()),
            # one spec serves every [N, *] rank-2 identity table
            # (id_bits, rule_tab, sel_match): rows shard, words stay
            ident_sharding=GridSharding(grid, ("ident", None)),
            flows_size=n // ident,
            device_ids=ids,
            axes=axes,
        )

    grid = tuple((d,) for d in devs)
    return MeshPlan(
        generation=gen,
        mesh=grid,
        flow_sharding=GridSharding(grid, ("flows",)),
        table_sharding=GridSharding(grid, ()),
        ident_sharding=None,
        flows_size=n,
        device_ids=ids,
        axes=axes,
    )
