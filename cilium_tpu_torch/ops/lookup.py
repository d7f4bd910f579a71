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
entry (``policymap_verdict_attrib``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    [max(n_rules, 1)] int32 rule-hit counts)."""
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
    n, words = t.id_bits.shape
    c = t.col_ep.shape[0]
    if words % 2 or c != (words // 2) * 32:
        raise ValueError(f"policymap_verdict: {c} columns vs {words} words per row")
    b = src_rows.shape[0]
    i32 = torch.int32
    id_bits = t.id_bits.to(i32).contiguous()
    cols = [t.col_ep.to(i32).contiguous(), t.col_port.to(i32).contiguous(),
            t.col_proto.to(i32).contiguous(), t.col_is_l3.to(torch.bool).contiguous()]
    flows = [x.to(i32).contiguous() for x in (src_rows, ep_idx, dport, proto)]
    if any(x.shape != (b,) for x in flows[1:]):
        raise ValueError("policymap_verdict: flow arrays differ in length")
    pf = None
    if denied_pf is not None:
        pf = denied_pf.to(torch.bool).contiguous()
        if pf.shape != (b,):
            raise ValueError("policymap_verdict: denied_pf length")
    verdict = torch.empty(b, dtype=torch.int8, device=dev)
    redirect = torch.empty(b, dtype=torch.bool, device=dev)
    counters = None
    if ep_count is not None:
        counters = torch.zeros((ep_count, 3), dtype=i32, device=dev)
    if rule_tab is not None:
        return _launch_attrib(
            dev, id_bits, cols, rule_tab, flows, pf, verdict, redirect, counters,
            ep_count, n_rules,
        )
    _kernels.check_cuda(
        "policymap_verdict", dev, id_bits, *cols, *flows, verdict, redirect,
        *(x for x in (pf, counters) if x is not None),
    )
    _kernels.KERNELS["policymap_verdict"].launch(
        dev, id_bits.data_ptr(), n, words, *(x.data_ptr() for x in cols), c,
        *(x.data_ptr() for x in flows), _kernels.ptr(pf), verdict.data_ptr(),
        redirect.data_ptr(), _kernels.ptr(counters),
        0 if ep_count is None else ep_count, b,
    )
    return verdict, redirect, counters


def _launch_attrib(dev, id_bits, cols, rule_tab, flows, pf, verdict, redirect, counters,
                   ep_count, n_rules):
    """The attribution entry of the ``policymap_verdict`` kernel."""
    n, words = id_bits.shape
    c = cols[0].shape[0]
    b = flows[0].shape[0]
    rt = rule_tab.to(torch.int32).contiguous()
    if rt.shape != (n, c):
        raise ValueError(f"policymap_verdict: rule_tab {tuple(rt.shape)} vs [{n}, {c}]")
    rule = torch.empty(b, dtype=torch.int32, device=dev)
    l4x = torch.empty(b, dtype=torch.bool, device=dev)
    hits = torch.zeros(max(n_rules, 1), dtype=torch.int32, device=dev)
    _kernels.check_cuda(
        "policymap_verdict_attrib", dev, id_bits, *cols, rt, *flows, verdict, redirect,
        rule, l4x, hits, *(x for x in (pf, counters) if x is not None),
    )
    _kernels.KERNELS["policymap_verdict_attrib"].launch(
        dev, id_bits.data_ptr(), n, words, *(x.data_ptr() for x in cols), c,
        rt.data_ptr(), *(x.data_ptr() for x in flows), _kernels.ptr(pf),
        verdict.data_ptr(), redirect.data_ptr(), rule.data_ptr(), l4x.data_ptr(),
        _kernels.ptr(counters), 0 if ep_count is None else ep_count,
        hits.data_ptr(), hits.shape[0], b,
    )
    return verdict, redirect, counters, rule, l4x, hits


def lookup_batch(
    t: PolicymapTables,
    ep_idx: torch.Tensor,  # [B] int32 local endpoint index
    src_rows: torch.Tensor,  # [B] int32 identity rows
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
    block: int = 16384,
    attrib: bool = False,
    rule_tab: Optional[torch.Tensor] = None,  # [N, C_pad] int32 (attrib only)
    ident_gather: bool = False,
):
    """→ (decision[B] int8, redirect[B] bool); with ``attrib=True``
    also (rule[B] int32, l4_exists[B] bool): the deciding-rule index
    gathered from the materializer's per-(row, column) rule table (-1 =
    no rule decided) and whether an L4 column covered the flow's
    (endpoint, port, proto) at all."""
    if ident_gather:
        raise NotImplementedError("ident-sharded row gathers are not in the torch port yet")
    if not attrib:
        dec, red, _ = policymap_verdict(t, src_rows, ep_idx, dport, proto, block=block)
        return dec, red
    if rule_tab is None:
        raise ValueError("lookup_batch(attrib=True) needs rule_tab")
    dec, red, _, rule, l4x, _hits = policymap_verdict(
        t, src_rows, ep_idx, dport, proto, block=block, rule_tab=rule_tab
    )
    return dec, red, rule, l4x
