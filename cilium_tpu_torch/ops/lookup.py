"""Materialized policymap lookup — the per-packet hot path.

The reference enforces verdicts per packet with ≤3 hash lookups in
eBPF (bpf/lib/policy.h:46-110: exact {id,port,proto} → L3-only {id} →
L4-only {port,proto}). The realized state here is a *column* layout:
every (endpoint, L3) and (endpoint, port, proto) pair in the desired
policy is one column c, and each identity row carries a packed bitmap
of the columns that allow it:

    col_ep/col_port/col_proto/col_is_l3  [C]      column metadata
    id_bits                              [N, 2·C/32] int32 words:
                                         allow words ‖ redirect words

A flow verdict is one row read of ``id_bits`` on the source identity
plus compares of its (endpoint, port, proto) against the column
metadata. :func:`policymap_verdict` also applies the prefilter
override and accumulates the per-endpoint counters of the datapath
pipeline; on a CUDA tensor it launches the ``policymap_verdict``
kernel (csrc/policymap_verdict.cu), on a CPU tensor it runs
:func:`policymap_verdict_plain`. Given a ``rule_tab`` (verdict
attribution) it also returns the deciding rule, the L4 coverage and
the rule-hit counts of each flow, through the kernel's attribution
entry (``policymap_verdict_attrib``). A row outside [0, N) reads as
no bits and rule -1; the reference's ``jnp.take`` fills (a row past N
reads all ones, so an allow) or wraps (-1 reads row N - 1) there, a
fault the port does not copy (ROADMAP queue C).

Placement (``datapath/placement.py``): :func:`replicate_tables` puts a
copy of every table on each device of a plan's grid
(:class:`Replicated`), :func:`shard_tables_ident` row-shards the
``[N, *]`` identity tables over the grid's ``ident`` axis
(:class:`IdentSharded`: the reference's ``P("ident", None)``) and keeps
the ``[C]`` column metadata replicated. A row fetch from an
ident-sharded table is :func:`ident_gather_rows`: one ``ident_gather``
kernel launch per device over every shard there (csrc/ident_gather.cu;
each lane's row from the shard that owns it, zeros where none does),
and a sum of the partials on the caller's device only when the shards
lie on several devices. ``lookup_batch(ident_gather=True)`` and the
pipeline's 2D path run :func:`policymap_verdict_gathered`: when every
shard of the reader's grid row lies on its device
(:func:`local_row_shards`), one ``policymap_verdict`` launch over the
shard list reads each row in place (:func:`policymap_verdict_shards`),
else the rows are gathered a block at a time and verdicted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import _kernels
from .bitmap import unpack_bits_u32
from .verdict import ALLOW, DENY, rule_hits

# verdict code of a flow the XDP prefilter dropped (datapath/pipeline.py
# DROP_PREFILTER; ALLOW and DENY double as FORWARD and DROP_POLICY)
DROP_PREFILTER = 3


@dataclasses.dataclass(frozen=True)
class PolicymapTables:
    col_ep: torch.Tensor  # [C] int32 (-1 padding)
    col_port: torch.Tensor  # [C] int32
    col_proto: torch.Tensor  # [C] int32
    col_is_l3: torch.Tensor  # [C] bool
    # combined per-identity bitmaps: [N, 2W] int32 words, first W words
    # = allow bits, last W = redirect bits (one row read serves both)
    id_bits: torch.Tensor

    @property
    def id_allow(self) -> torch.Tensor:  # [N, C/32] words
        return self.id_bits[:, : self.id_bits.shape[1] // 2]

    @property
    def id_redirect(self) -> torch.Tensor:
        return self.id_bits[:, self.id_bits.shape[1] // 2:]


def patch_bitmap_cols(
    tab: torch.Tensor,  # [N, W]
    col_idx: torch.Tensor,  # [k] int64, no repeats
    cols: torch.Tensor,  # [N, k], dtype of ``tab``
) -> torch.Tensor:
    """Scatter whole columns into a per-identity table, out of place —
    the column dual of ``materialize._patch_bitmap_rows``. Serves both
    the packed ``id_bits`` word columns and the int32 ``rule_tab``
    columns of the rule-patch path: a rule touching k columns uploads
    [N, k] words, not the table."""
    return tab.index_copy(1, col_idx, cols)


# -- placement: replicated and ident-sharded tables -----------------------


@dataclasses.dataclass(frozen=True)
class Replicated:
    """One tensor replicated onto every device of a grid (the
    reference's ``P()``): a copy per distinct torch device."""

    copies: Dict[torch.device, torch.Tensor]

    def on(self, device) -> torch.Tensor:
        return self.copies[torch.device(device)]


def replicate(x: torch.Tensor, sharding) -> Replicated:
    """``x`` on every device of ``sharding``'s grid (``.to``: no copy
    where ``x`` already lies)."""
    return Replicated({d: x.to(d) for d in sharding.devices})


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rows ``[row_lo, row_lo + rows)`` of an identity table on one
    device."""

    row_lo: int
    rows: int
    tensor: torch.Tensor  # [rows, W]


@dataclasses.dataclass(frozen=True)
class IdentSharded:
    """An ``[N, W]`` identity table under the reference's
    ``P("ident", None)``: its rows split into ``ident`` equal shards,
    shard k on the devices of grid column k, so each grid row (a flow
    shard) holds the whole table once. ``shards`` is shaped like the
    grid, ``[flows][ident]``; grid rows on one torch device share their
    RowShard objects. ``device`` is the home device a row read lands on
    when the reader's device is in no grid row (the engine's device for
    the sweeps). Rows are read with :func:`ident_gather_rows`."""

    shape: Tuple[int, int]
    device: torch.device
    shards: Tuple[Tuple[RowShard, ...], ...]

    def row_for(self, device) -> Tuple[RowShard, ...]:
        """The ident shards of the grid row whose first device is
        ``device`` (row 0 when none is)."""
        device = torch.device(device)
        for row in self.shards:
            if row[0].tensor.device == device:
                return row
        return self.shards[0]


def shard_rows(x: torch.Tensor, ident_sharding) -> IdentSharded:
    """Row-shard ``x`` [N, W] over ``ident_sharding``'s grid columns.
    ``N`` must be a multiple of the ident size (a ragged N raises
    ValueError, as the reference's ``device_put`` does)."""
    grid = ident_sharding.grid
    ident = len(grid[0])
    n = x.shape[0]
    if n % ident:
        raise ValueError(
            f"an identity table of {n} rows does not split into {ident} equal shards")
    rows = n // ident
    made: Dict[Tuple[torch.device, int], RowShard] = {}
    shards = []
    for grid_row in grid:
        out = []
        for k, rec in enumerate(grid_row):
            key = (rec.device, k)
            if key not in made:
                made[key] = RowShard(k * rows, rows, x[k * rows:(k + 1) * rows].to(rec.device))
            out.append(made[key])
        shards.append(tuple(out))
    return IdentSharded(tuple(x.shape), x.device, tuple(shards))


def map_placed(tab, fn: Callable[[torch.Tensor, int], torch.Tensor]):
    """Apply ``fn(tensor, row_lo) -> tensor`` to every stored tensor of
    a table — a tensor (row_lo 0), a :class:`Replicated` (each copy,
    row_lo 0) or an :class:`IdentSharded` (each shard once, at its
    row_lo) — and return the table of the same kind. The patch paths
    scatter into placed copies with it, out of place."""
    if isinstance(tab, Replicated):
        return Replicated({d: fn(t, 0) for d, t in tab.copies.items()})
    if isinstance(tab, IdentSharded):
        done: Dict[int, RowShard] = {}

        def one(s: RowShard) -> RowShard:
            if id(s) not in done:
                t = fn(s.tensor, s.row_lo)
                done[id(s)] = s if t is s.tensor else RowShard(s.row_lo, s.rows, t)
            return done[id(s)]

        return dataclasses.replace(
            tab, shards=tuple(tuple(one(s) for s in row) for row in tab.shards))
    return fn(tab, 0)


def patch_placed_rows(tab, idx: torch.Tensor, rows: torch.Tensor, op=None):
    """Whole rows ``rows`` [k, W] at identity rows ``idx`` [k] (int64)
    into a table of any placement, out of place: one ``op(tensor, idx,
    rows)`` (default ``index_copy`` on dim 0) per stored tensor that
    owns a patched row, with that tensor's own rows and offsets."""

    def one(t: torch.Tensor, lo: int) -> torch.Tensor:
        own = (idx >= lo) & (idx < lo + t.shape[0])
        if not bool(own.any()):
            return t
        i, v = (idx[own] - lo).to(t.device), rows[own].to(t.device)
        return t.index_copy(0, i, v) if op is None else op(t, i, v)

    return map_placed(tab, one)


def patch_placed_cols(tab, col_idx: torch.Tensor, cols: torch.Tensor):
    """:func:`patch_bitmap_cols` for a table of any placement: the
    columns ``col_idx`` of every row, one ``index_copy`` per stored
    tensor (each shard takes its own rows of ``cols``)."""
    return map_placed(tab, lambda t, lo: patch_bitmap_cols(
        t, col_idx.to(t.device), cols[lo:lo + t.shape[0]].to(t.device)))


def replicate_tables(t: PolicymapTables, sharding=None) -> PolicymapTables:
    """A policymap REPLICATED across a grid: every field a
    :class:`Replicated`. The row read touches arbitrary identity rows
    per flow, so the bitmap table must be whole on every device a flow
    shard lands on. ``sharding=None`` returns the tables untouched."""
    if sharding is None:
        return t
    return PolicymapTables(**{
        f.name: replicate(getattr(t, f.name), sharding) for f in dataclasses.fields(t)})


def shard_tables_ident(t: PolicymapTables, ident_sharding, replicated) -> PolicymapTables:
    """A policymap with the identity axis SHARDED: the [N, 2W] bitmap
    rows split over the grid's ``ident`` axis (:class:`IdentSharded`)
    while the [C] column metadata — tiny, read by every flow — stays
    replicated. Row reads then run through :func:`ident_gather_rows`."""
    return PolicymapTables(
        col_ep=replicate(t.col_ep, replicated),
        col_port=replicate(t.col_port, replicated),
        col_proto=replicate(t.col_proto, replicated),
        col_is_l3=replicate(t.col_is_l3, replicated),
        id_bits=shard_rows(t.id_bits, ident_sharding),
    )


def tables_on(t: PolicymapTables, device) -> PolicymapTables:
    """A placed policymap as read from ``device``: each replicated
    field's copy there; an ident-sharded ``id_bits`` stays the holder."""
    def on(v):
        return v.on(device) if isinstance(v, Replicated) else v

    return PolicymapTables(**{f.name: on(getattr(t, f.name)) for f in dataclasses.fields(t)})


def ident_gather_rows_plain(tab: torch.Tensor, src: torch.Tensor, row_lo: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the ``ident_gather`` kernel: the rows
    ``[row_lo, row_lo + rows)`` of an identity table held as ``tab``
    [rows, W] int32, [b] int32 ids → [b, W] int32, ``tab[src - row_lo]``
    where the row is owned and 0 where it is not (a masked
    ``index_select``)."""
    r = src.long() - row_lo
    n = tab.shape[0]
    own = (r >= 0) & (r < n)
    if n == 0:
        return torch.zeros((src.shape[0], tab.shape[1]), dtype=tab.dtype, device=tab.device)
    rows = tab.index_select(0, r.clamp(0, n - 1))
    return torch.where(own[:, None], rows, torch.zeros((), dtype=tab.dtype, device=tab.device))


def ident_gather_shards_plain(shards: Sequence[RowShard], src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``ident_gather`` kernel: [b] int32
    ids → [b, W], each lane's row from the listed shard whose
    ``[row_lo, row_lo + rows)`` holds its id, 0 where none does (one
    masked select a shard)."""
    s = src.long()
    first = shards[0].tensor
    out = torch.zeros((src.shape[0], first.shape[1]), dtype=first.dtype, device=first.device)
    for sh in shards:
        n = sh.tensor.shape[0]
        if n == 0:
            continue
        r = s - sh.row_lo
        own = (r >= 0) & (r < n)
        out = torch.where(own[:, None], sh.tensor.index_select(0, r.clamp(0, n - 1)), out)
    return out


def ident_gather_shards(shards: Sequence[RowShard], src: torch.Tensor) -> torch.Tensor:
    """The rows of ``src`` that the listed shards own, zeros elsewhere,
    in one ``ident_gather`` kernel launch over every shard (all on
    ``src``'s device) on CUDA tensors, :func:`ident_gather_shards_plain`
    on CPU ones."""
    dev = _kernels.dispatch_device(src, *(sh.tensor for sh in shards))
    if dev.type == "cpu":
        return ident_gather_shards_plain(shards, src)
    if not 1 <= len(shards) <= _kernels.IDENT_MAX_SHARDS:
        raise ValueError(f"ident_gather: {len(shards)} shards on one device, "
                         f"the kernel takes 1 to {_kernels.IDENT_MAX_SHARDS}")
    w = shards[0].tensor.shape[-1]
    tabs = [sh.tensor.contiguous() for sh in shards]
    for t in tabs:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != w:
            raise ValueError(f"ident_gather: shard {t.dtype} {tuple(t.shape)}, expected int32 [rows, {w}]")
    s = src.to(torch.int32).contiguous()
    b = s.shape[0]
    out = torch.empty((b, w), dtype=torch.int32, device=dev)
    _kernels.check_cuda("ident_gather", dev, *tabs, s, out)
    lst = _kernels.shard_list([(t, sh.row_lo) for sh, t in zip(shards, tabs)])
    _kernels.KERNELS["ident_gather"].launch(dev, lst, w, s.data_ptr(), b, out.data_ptr())
    return out


def ident_gather_shard(tab: torch.Tensor, src: torch.Tensor, row_lo: int = 0) -> torch.Tensor:
    """One shard's partial of a row gather: :func:`ident_gather_shards`
    over ``tab`` alone, holding rows ``[row_lo, row_lo + rows)``."""
    return ident_gather_shards((RowShard(row_lo, tab.shape[0], tab),), src)


def ident_gather_rows(tab, src: torch.Tensor) -> torch.Tensor:
    """Row gather for identity tables of any placement → [b, W] on
    ``src``'s device; a row outside [0, N) gives an all-zero row (the
    reference's one-hot contraction, not ``take``'s fill). A tensor or
    :class:`Replicated` table is one shard; an :class:`IdentSharded`
    one is gathered over the shards of the reader's grid row with one
    :func:`ident_gather_shards` call per device they lie on: on one
    card's grid a single launch and no sum. Shards on other devices
    give partials holding the rows they own, added on ``src``'s device;
    exactly one shard owns a row, so the integer sum is the row itself,
    bit for bit. uint32 words travel as int32 bit views."""
    if isinstance(tab, IdentSharded):
        by_dev: Dict[torch.device, List[RowShard]] = {}
        for shard in tab.row_for(src.device):
            by_dev.setdefault(shard.tensor.device, []).append(shard)
        out = None
        for dev, shards in by_dev.items():
            part = ident_gather_shards(shards, src.to(dev, non_blocking=True))
            part = part.to(src.device, non_blocking=True)
            out = part if out is None else out + part
        return out
    if isinstance(tab, Replicated):
        tab = tab.on(src.device)
    return ident_gather_shard(tab, src)


def policymap_verdict_plain(
    t: PolicymapTables,
    src_rows: torch.Tensor,  # [B] int32 identity rows
    ep_idx: torch.Tensor,  # [B] int32 local endpoint index
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
    denied_pf: Optional[torch.Tensor] = None,  # [B] bool, None = none
    ep_count: Optional[int] = None,
    block: int = 16384,
    rule_tab: Optional[torch.Tensor] = None,  # [N, C] int32, attribution
    n_rules: int = 0,
):
    """Plain PyTorch version of the ``policymap_verdict`` kernel →
    (verdict [B] int8, redirect [B] bool, counters [EP, 3] int32 or
    None when ``ep_count`` is None); with ``rule_tab`` also (rule [B]
    int32, l4_covered [B] bool, hits [max(n_rules, 1)] int32)."""
    n = t.id_bits.shape[0]
    w = t.id_bits.shape[1] // 2
    dec_parts, red_parts, rule_parts, l4x_parts = [], [], [], []
    for lo in range(0, src_rows.shape[0], block):
        src = src_rows[lo:lo + block].long()
        ep = ep_idx[lo:lo + block]
        port = dport[lo:lo + block]
        prt = proto[lo:lo + block]
        ok = (src >= 0) & (src < n)
        rows = t.id_bits[src.clamp(0, max(n - 1, 0))] * ok[:, None]
        both = unpack_bits_u32(rows).to(torch.bool)
        allow_bits = both[:, : w * 32]
        red_bits = both[:, w * 32:]
        colsel = (ep[:, None] == t.col_ep[None, :]) & (
            t.col_is_l3[None, :]
            | (
                (port[:, None] == t.col_port[None, :])
                & (prt[:, None] == t.col_proto[None, :])
            )
        )
        hit = colsel & allow_bits
        allow = hit.any(dim=1)
        # Exact-match wins over L3-only (bpf/lib/policy.h lookup order),
        # so a redirecting L4 hit redirects even when L3 also allows.
        red_parts.append((hit & red_bits).any(dim=1))
        dec_parts.append(torch.where(allow, ALLOW, DENY).to(torch.int8))
        if rule_tab is not None:
            # attribution column: allowed-L4 > allowed-L3 > covering-L4 >
            # covering-L3 (the drop fallbacks read the deny rule the sweep
            # recorded on the column that rejected the flow)
            not_l3 = ~t.col_is_l3[None, :]
            l4sel = colsel & not_l3
            col = torch.where(
                (hit & not_l3).any(dim=1), _first_col(hit & not_l3),
                torch.where(
                    allow, _first_col(hit),
                    torch.where(l4sel.any(dim=1), _first_col(l4sel), _first_col(colsel)),
                ),
            )
            rule_at = rule_tab[src.clamp(0, max(n - 1, 0))].gather(
                1, col.clamp(min=0)[:, None])[:, 0]
            rule_parts.append(torch.where((col >= 0) & ok, rule_at, -1).to(torch.int32))
            l4x_parts.append(l4sel.any(dim=1))
    dev = src_rows.device

    def cat(xs, dtype):
        return torch.cat(xs) if xs else torch.zeros(0, dtype=dtype, device=dev)

    verdict = cat(dec_parts, torch.int8)
    redirect = cat(red_parts, torch.bool)
    if denied_pf is not None:
        verdict = torch.where(denied_pf, DROP_PREFILTER, verdict).to(torch.int8)
        redirect = redirect & ~denied_pf
    counters = None
    if ep_count is not None:
        counted = (ep_idx >= 0) & (ep_idx < ep_count)
        cell = ep_idx.long() * 3 + (verdict.long() - 1)
        counters = torch.bincount(cell[counted], minlength=ep_count * 3)
        counters = counters.to(torch.int32).reshape(ep_count, 3)
    if rule_tab is None:
        return verdict, redirect, counters
    rule = cat(rule_parts, torch.int32)
    if denied_pf is not None:
        # a prefilter drop never reached the policymap: no rule decided
        rule = torch.where(denied_pf, -1, rule).to(torch.int32)
    return verdict, redirect, counters, rule, cat(l4x_parts, torch.bool), rule_hits(rule, n_rules)


def _first_col(mask: torch.Tensor) -> torch.Tensor:
    """[B, C] bool → [B] int64 index of the first set column, -1 when
    none is set (argmax with JAX's lowest-index tie-break)."""
    c = mask.shape[1]
    if c == 0:
        return torch.full((mask.shape[0],), -1, dtype=torch.int64, device=mask.device)
    first = torch.where(mask, torch.arange(c, device=mask.device)[None, :], c).amin(dim=1)
    return torch.where(first < c, first, -1)


def policymap_verdict(
    t: PolicymapTables,
    src_rows: torch.Tensor,
    ep_idx: torch.Tensor,
    dport: torch.Tensor,
    proto: torch.Tensor,
    denied_pf: Optional[torch.Tensor] = None,
    ep_count: Optional[int] = None,
    block: int = 16384,
    rule_tab: Optional[torch.Tensor] = None,
    n_rules: int = 0,
):
    """Policymap verdict + prefilter override + per-endpoint counters
    (forwarded, dropped by policy, dropped by the prefilter); a flow
    whose ``ep_idx`` lies outside [0, ep_count) counts nowhere. With
    ``rule_tab`` ([N, C] int32, the materializer's deciding rule per
    (identity row, column)) also returns the attribution: (rule [B]
    int32, -1 = none or a prefilter drop; l4_covered [B] bool; hits
    [max(n_rules, 1)] int32 rule-hit counts). A row outside [0, N)
    reads as no bits and rule -1."""
    tensors = [t.id_bits, src_rows, ep_idx, dport, proto]
    if denied_pf is not None:
        tensors.append(denied_pf)
    if rule_tab is not None:
        tensors.append(rule_tab)
    dev = _kernels.dispatch_device(*tensors)
    if dev.type == "cpu":
        return policymap_verdict_plain(
            t, src_rows, ep_idx, dport, proto, denied_pf, ep_count, block,
            rule_tab=rule_tab, n_rules=n_rules,
        )
    n = t.id_bits.shape[0]
    return _launch(
        dev, t, [RowShard(0, n, t.id_bits)],
        None if rule_tab is None else [RowShard(0, rule_tab.shape[0], rule_tab)],
        src_rows, ep_idx, dport, proto, denied_pf, ep_count, n_rules, gathered=False,
    )


def policymap_verdict_shards_plain(
    t: PolicymapTables,
    shards: Sequence[RowShard],
    src_rows: torch.Tensor,
    ep_idx: torch.Tensor,
    dport: torch.Tensor,
    proto: torch.Tensor,
    denied_pf: Optional[torch.Tensor] = None,
    ep_count: Optional[int] = None,
    block: int = 16384,
    rule_shards: Optional[Sequence[RowShard]] = None,
    n_rules: int = 0,
    gathered: bool = True,
):
    """Plain PyTorch version of the ``policymap_verdict`` kernel over a
    shard list (:func:`policymap_verdict_shards`): ``block`` lanes at a
    time, the rows (and rule rows) gathered with
    :func:`ident_gather_shards_plain` (zeros where no shard owns a row),
    then :func:`policymap_verdict_plain` on them with ``src =
    arange(block)``; in direct mode (``gathered=False``) an unowned
    row's lane gets src -1 (no bits, rule -1). Counters and hits are the
    sums over the blocks."""
    b = src_rows.shape[0]
    outs = []
    for lo in range(0, max(b, 1), block):
        hi = min(lo + block, b)
        src = src_rows[lo:hi]
        rows = ident_gather_shards_plain(shards, src)
        local = torch.arange(hi - lo, dtype=torch.int32, device=src.device)
        if not gathered:
            s = src.long()
            owned = torch.zeros(hi - lo, dtype=torch.bool, device=src.device)
            for sh in shards:
                owned |= (s >= sh.row_lo) & (s < sh.row_lo + sh.tensor.shape[0])
            local = torch.where(owned, local, -1).to(torch.int32)
        outs.append(policymap_verdict_plain(
            dataclasses.replace(t, id_bits=rows), local, ep_idx[lo:hi], dport[lo:hi],
            proto[lo:hi], denied_pf=None if denied_pf is None else denied_pf[lo:hi],
            ep_count=ep_count, block=block,
            rule_tab=None if rule_shards is None else ident_gather_shards_plain(rule_shards, src),
            n_rules=n_rules,
        ))
    return _combine(outs)


def policymap_verdict_shards(
    t: PolicymapTables,
    shards: Sequence[RowShard],
    src_rows: torch.Tensor,
    ep_idx: torch.Tensor,
    dport: torch.Tensor,
    proto: torch.Tensor,
    denied_pf: Optional[torch.Tensor] = None,
    ep_count: Optional[int] = None,
    block: int = 16384,
    rule_shards: Optional[Sequence[RowShard]] = None,
    n_rules: int = 0,
    gathered: bool = True,
):
    """:func:`policymap_verdict` over an identity table held as row
    shards, all on ``src_rows``' device: one ``policymap_verdict``
    kernel launch reads each lane's row in the shard that owns it (the
    attribution entry its rule row in ``rule_shards``, which must cover
    the same row ranges). A row that no listed shard owns reads as no
    bits; its rule is 0 where a column is chosen with ``gathered`` (the
    zero row of the reference's one-hot contraction) and -1 without
    (the direct lookup). :func:`policymap_verdict_shards_plain` on CPU
    tensors."""
    tensors = [t.col_ep, src_rows, ep_idx, dport, proto, *(sh.tensor for sh in shards)]
    if denied_pf is not None:
        tensors.append(denied_pf)
    if rule_shards is not None:
        _check_row_ranges(shards, rule_shards)
        tensors += [sh.tensor for sh in rule_shards]
    dev = _kernels.dispatch_device(*tensors)
    if dev.type == "cpu":
        return policymap_verdict_shards_plain(
            t, shards, src_rows, ep_idx, dport, proto, denied_pf, ep_count, block,
            rule_shards=rule_shards, n_rules=n_rules, gathered=gathered,
        )
    return _launch(dev, t, shards, rule_shards, src_rows, ep_idx, dport, proto, denied_pf,
                   ep_count, n_rules, gathered)


def _check_row_ranges(shards, rule_shards) -> None:
    bits = [(sh.row_lo, sh.tensor.shape[0]) for sh in shards]
    rules = [(sh.row_lo, sh.tensor.shape[0]) for sh in rule_shards]
    if rules != bits:
        raise ValueError(f"policymap_verdict: id_bits and rule_tab are not sharded over the "
                         f"same row ranges ((row_lo, rows): {bits} vs {rules})")


def _launch(dev, t, shards, rule_shards, src_rows, ep_idx, dport, proto, denied_pf, ep_count,
            n_rules, gathered):
    """Check the operands of a ``policymap_verdict`` launch, make its
    outputs and launch the entry (the attribution one with
    ``rule_shards``)."""
    if not 1 <= len(shards) <= _kernels.IDENT_MAX_SHARDS:
        raise ValueError(f"policymap_verdict: {len(shards)} row shards, the kernel takes 1 to "
                         f"{_kernels.IDENT_MAX_SHARDS}")
    i32, op = torch.int32, _kernels.operand
    words = shards[0].tensor.shape[-1]
    bits = [op(sh.tensor, i32) for sh in shards]
    for x in bits:
        if x.dim() != 2 or x.shape[1] != words:
            raise ValueError(f"policymap_verdict: row shard {tuple(x.shape)}, expected [rows, {words}]")
    c = t.col_ep.shape[0]
    if words % 2 or c != (words // 2) * 32:
        raise ValueError(f"policymap_verdict: {c} columns vs {words} words per row")
    b = src_rows.shape[0]
    cols = [op(t.col_ep, i32), op(t.col_port, i32), op(t.col_proto, i32),
            op(t.col_is_l3, torch.bool)]
    flows = [op(x, i32) for x in (src_rows, ep_idx, dport, proto)]
    if any(x.shape != (c,) for x in cols) or any(x.shape != (b,) for x in flows[1:]):
        raise ValueError("policymap_verdict: column or flow arrays differ in length")
    pf = None
    if denied_pf is not None:
        pf = op(denied_pf, torch.bool)
        if pf.shape != (b,):
            raise ValueError("policymap_verdict: denied_pf length")
    verdict = torch.empty(b, dtype=torch.int8, device=dev)
    redirect = torch.empty(b, dtype=torch.bool, device=dev)
    counters = None
    if ep_count is not None:
        counters = torch.zeros((ep_count, 3), dtype=i32, device=dev)
    lst = _kernels.shard_list([(x, sh.row_lo) for sh, x in zip(shards, bits)])
    if rule_shards is not None:
        return _launch_attrib(
            dev, lst, bits, shards, cols, rule_shards, flows, pf, verdict, redirect, counters,
            ep_count, n_rules, gathered,
        )
    _kernels.check_cuda(
        "policymap_verdict", dev, *bits, *cols, *flows, verdict, redirect,
        *(x for x in (pf, counters) if x is not None),
    )
    _kernels.KERNELS["policymap_verdict"].launch(
        dev, lst, words, int(gathered), *(x.data_ptr() for x in cols), c,
        *(x.data_ptr() for x in flows), _kernels.ptr(pf), verdict.data_ptr(),
        redirect.data_ptr(), _kernels.ptr(counters),
        0 if ep_count is None else ep_count, b,
    )
    return verdict, redirect, counters


def _launch_attrib(dev, lst, bits, shards, cols, rule_shards, flows, pf, verdict, redirect,
                   counters, ep_count, n_rules, gathered):
    """The attribution entry of the ``policymap_verdict`` kernel: the
    rule_tab shards must hold the same row ranges as the id_bits ones."""
    c = cols[0].shape[0]
    b = flows[0].shape[0]
    _check_row_ranges(shards, rule_shards)
    rts = [_kernels.operand(sh.tensor, torch.int32) for sh in rule_shards]
    for x in rts:
        if x.dim() != 2 or x.shape[1] != c:
            raise ValueError(f"policymap_verdict: rule_tab shard {tuple(x.shape)} vs [rows, {c}]")
    rule = torch.empty(b, dtype=torch.int32, device=dev)
    l4x = torch.empty(b, dtype=torch.bool, device=dev)
    hits = torch.zeros(max(n_rules, 1), dtype=torch.int32, device=dev)
    _kernels.check_cuda(
        "policymap_verdict_attrib", dev, *bits, *cols, *rts, *flows, verdict, redirect,
        rule, l4x, hits, *(x for x in (pf, counters) if x is not None),
    )
    rlst = _kernels.shard_list([(x, sh.row_lo) for sh, x in zip(rule_shards, rts)])
    _kernels.KERNELS["policymap_verdict_attrib"].launch(
        dev, lst, rlst, bits[0].shape[1], int(gathered), *(x.data_ptr() for x in cols), c,
        *(x.data_ptr() for x in flows), _kernels.ptr(pf),
        verdict.data_ptr(), redirect.data_ptr(), rule.data_ptr(), l4x.data_ptr(),
        _kernels.ptr(counters), 0 if ep_count is None else ep_count,
        hits.data_ptr(), hits.shape[0], b,
    )
    return verdict, redirect, counters, rule, l4x, hits


def local_row_shards(tab, device) -> Optional[List[RowShard]]:
    """The row shards of an identity table as read from ``device``,
    when all of them lie there: a tensor on ``device`` is one shard
    [0, N), a :class:`Replicated` its copy there, an
    :class:`IdentSharded` the shards of the reader's grid row (one
    card's virtual grid). None when a row would have to come from
    another device, or the kernel's list cannot hold the shards. The
    one seam through which the 2D verdict reads ident-sharded rows in
    place (:func:`policymap_verdict_gathered`)."""
    device = torch.device(device)
    if isinstance(tab, IdentSharded):
        shards = list(tab.row_for(device))
    elif isinstance(tab, Replicated):
        if device not in tab.copies:
            return None
        x = tab.copies[device]
        shards = [RowShard(0, x.shape[0], x)]
    else:
        shards = [RowShard(0, tab.shape[0], tab)]
    if len(shards) > _kernels.IDENT_MAX_SHARDS or any(sh.tensor.device != device for sh in shards):
        return None
    return shards


def _combine(outs):
    """One result of per-block ``policymap_verdict`` results: per-flow
    outputs concatenated, counters and rule hits summed."""
    if len(outs) == 1:
        return outs[0]

    def cat(i):
        return torch.cat([o[i] for o in outs])

    def total(i):
        return None if outs[0][i] is None else torch.stack([o[i] for o in outs]).sum(dim=0).to(
            outs[0][i].dtype)

    if len(outs[0]) == 3:
        return cat(0), cat(1), total(2)
    return cat(0), cat(1), total(2), cat(3), cat(4), total(5)


def policymap_verdict_gathered(
    t: PolicymapTables,
    src_rows: torch.Tensor,
    ep_idx: torch.Tensor,
    dport: torch.Tensor,
    proto: torch.Tensor,
    denied_pf: Optional[torch.Tensor] = None,
    ep_count: Optional[int] = None,
    block: int = 16384,
    rule_tab=None,
    n_rules: int = 0,
):
    """:func:`policymap_verdict` on rows read as the reference's
    ``ident_gather=True`` lookup does, for a ``t.id_bits`` (and
    ``rule_tab``) of any placement: a row outside [0, N) is all zeros,
    so a chosen column's rule is 0.

    When every shard the reader needs lies on ``src_rows``' device
    (:func:`local_row_shards`; one card's grid, or an unplaced table),
    one :func:`policymap_verdict_shards` launch in gathered mode reads
    each row from its owning shard: no gather, no blocks. Otherwise one
    ``block`` of lanes at a time, as the reference's ``lax.map``: its
    ``[block, 2W]`` rows (and ``[block, C]`` rule rows) gathered with
    :func:`ident_gather_rows`, then :func:`policymap_verdict` on them
    with ``src = arange(block)``; counters and rule hits summed over
    the blocks."""
    dev = src_rows.device
    shards = local_row_shards(t.id_bits, dev)
    rule_shards = None if rule_tab is None else local_row_shards(rule_tab, dev)
    if shards is not None and (rule_tab is None or rule_shards is not None):
        return policymap_verdict_shards(
            t, shards, src_rows, ep_idx, dport, proto, denied_pf=denied_pf, ep_count=ep_count,
            block=block, rule_shards=rule_shards, n_rules=n_rules, gathered=True,
        )
    b = src_rows.shape[0]
    outs = []
    for lo in range(0, max(b, 1), block):
        hi = min(lo + block, b)
        src = src_rows[lo:hi]
        local = torch.arange(hi - lo, dtype=torch.int32, device=dev)
        rows = dataclasses.replace(t, id_bits=ident_gather_rows(t.id_bits, src))
        outs.append(policymap_verdict(
            rows, local, ep_idx[lo:hi], dport[lo:hi], proto[lo:hi],
            denied_pf=None if denied_pf is None else denied_pf[lo:hi], ep_count=ep_count,
            block=block, rule_tab=None if rule_tab is None else ident_gather_rows(rule_tab, src),
            n_rules=n_rules,
        ))
    return _combine(outs)


def lookup_batch(
    t: PolicymapTables,
    ep_idx: torch.Tensor,  # [B] int32 local endpoint index
    src_rows: torch.Tensor,  # [B] int32 identity rows
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
    block: int = 16384,
    attrib: bool = False,
    rule_tab=None,  # [N, C_pad] int32 (attrib only)
    ident_gather: bool = False,
):
    """→ (decision[B] int8, redirect[B] bool); with ``attrib=True``
    also (rule[B] int32, l4_exists[B] bool): the deciding-rule index
    gathered from the materializer's per-(row, column) rule table (-1 =
    no rule decided) and whether an L4 column covered the flow's
    (endpoint, port, proto) at all. ``ident_gather=True`` reads the
    rows through :func:`ident_gather_rows` (the 2D plan's row fetch;
    ``t.id_bits`` and ``rule_tab`` may be ident-sharded); a row outside
    [0, N) is then all zeros, as in the reference's contraction."""
    verdict = policymap_verdict_gathered if ident_gather else policymap_verdict
    if not attrib:
        dec, red, _ = verdict(t, src_rows, ep_idx, dport, proto, block=block)
        return dec, red
    if rule_tab is None:
        raise ValueError("lookup_batch(attrib=True) needs rule_tab")
    dec, red, _, rule, l4x, _hits = verdict(
        t, src_rows, ep_idx, dport, proto, block=block, rule_tab=rule_tab
    )
    return dec, red, rule, l4x
