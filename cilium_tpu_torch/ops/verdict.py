"""Batched policy-verdict kernel (matmul formulation).

Evaluates the verdict semantics of pkg/policy/repository.go
AllowsIngressRLocked/AllowsEgressRLocked for a batch of flows
(subject identity row, peer identity row, dport, proto):

    deny      = any(subj ∧ ((1-peer) @ deny_matᵀ > 0))
    l3_allow  = any(subj ∧ (peer @ allow_matᵀ > 0))
    req_ok    = ¬deny                        # folded-requirements term
    combo     = (subj @ s1) ∧ (port_onehot @ p1)
    l4_allow  = any(combo ∧ peer@enᵀ) | req_ok ∧ any(combo ∧ peer@eeᵀ)
    l7_present= any((subj @ s7) ∧ (port @ p7) ∧ (group_ok @ g7))
    verdict   = ALLOW  if l3_allow ∧ ¬deny
              | ALLOW  if flow has L4 context ∧ l4_allow
              | DENY   otherwise

Per flow the only data-dependent access is one packed row gather from
``sel_match``; every relation product is :func:`bool_mm`, which on a
CUDA tensor launches the ``bool_mm`` kernel (csrc/bool_mm.cu) and on a
CPU tensor runs :func:`bool_mm_plain`.

Verdict attribution (the first-match rule and reason codes) is not in
this port yet: ``attrib=True`` raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from .. import _kernels
from ..compiler.program import DirectionProgram
from ..policy.search import Decision
from .bitmap import unpack_bits_u32

ALLOW = int(Decision.ALLOWED)
DENY = int(Decision.DENIED)


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Per-flow results. ``decision``: 1 allow / 2 deny. ``l3`` is the
    pure-L3 stage decision (0 undecided / 1 allowed / 2 denied) used by
    the policymap materializer; ``l7_redirect`` flags flows whose L4
    allow passes through a parser-bearing filter (proxy redirect)."""

    decision: torch.Tensor  # [B] int8
    l3: torch.Tensor  # [B] int8
    l7_redirect: torch.Tensor  # [B] bool


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """DirectionProgram matrices as tensors. Transposed copies of the
    peer-side relations are stored so every product runs with the
    contracted axis leading."""

    deny_t: torch.Tensor  # [S, S] int8  deny_matᵀ
    allow_t: torch.Tensor  # [S, S] int8  allow_matᵀ
    ports: torch.Tensor  # [P4] int32
    protos: torch.Tensor  # [P4] int32
    s1_mat: torch.Tensor  # [S, K1] int8
    p1_mat: torch.Tensor  # [P4, K1] int8
    en_t: torch.Tensor  # [S, K1] int8  en_matᵀ
    ee_t: torch.Tensor  # [S, K1] int8  ee_matᵀ
    gpn_mat: torch.Tensor  # [S, G] int8
    gpe_mat: torch.Tensor  # [S, G] int8
    group_no_peers: torch.Tensor  # [G] bool
    s7_mat: torch.Tensor  # [S, K7] int8
    p7_mat: torch.Tensor  # [P4, K7] int8
    g7_mat: torch.Tensor  # [G, K7] int8

    @classmethod
    def from_host(cls, d: DirectionProgram, device) -> "DeviceTables":
        return cls(
            deny_t=_t(d.deny_mat.T, device),
            allow_t=_t(d.allow_mat.T, device),
            ports=_t(d.ports.astype(np.int32), device),
            protos=_t(d.protos.astype(np.int32), device),
            s1_mat=_t(d.s1_mat, device),
            p1_mat=_t(d.p1_mat, device),
            en_t=_t(d.en_mat.T, device),
            ee_t=_t(d.ee_mat.T, device),
            gpn_mat=_t(d.gpn_mat, device),
            gpe_mat=_t(d.gpe_mat, device),
            group_no_peers=_t(d.group_no_peers.astype(bool), device),
            s7_mat=_t(d.s7_mat, device),
            p7_mat=_t(d.p7_mat, device),
            g7_mat=_t(d.g7_mat, device),
        )


@dataclasses.dataclass(frozen=True)
class DevicePolicy:
    """Compiled policy resident on one device."""

    id_bits: torch.Tensor  # [N, W] int32 (uint32 bit view)
    sel_match: torch.Tensor  # [N, S/32] int32 (packed selector matches)
    ingress: DeviceTables
    egress: DeviceTables


def _as_int8(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int8) if x.dtype == torch.bool else x


def bool_mm_plain(
    x: torch.Tensor, w: torch.Tensor, complement_x: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of the ``bool_mm`` kernel: int8 [B, A] @
    int8 [A, C] > 0 as a float64 product (exact: |sum| < 2**53)."""
    x = _as_int8(x)
    if complement_x:
        x = 1 - x
    return (x.to(torch.float64) @ _as_int8(w).to(torch.float64)) > 0


def bool_mm(
    x: torch.Tensor, w: torch.Tensor, complement_x: bool = False
) -> torch.Tensor:
    """int8 [B, A] @ int8 [A, C] → bool [B, C] (int32 accumulate, > 0).
    With ``complement_x`` the left operand is ``1 - x``."""
    dev = _kernels.dispatch_device(x, w)
    if dev.type == "cpu":
        return bool_mm_plain(x, w, complement_x)
    x = _as_int8(x).contiguous()
    w = _as_int8(w).contiguous()
    b, a = x.shape
    a2, c = w.shape
    if a != a2 or x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"bool_mm: bad operands {tuple(x.shape)} {x.dtype} @ {tuple(w.shape)} {w.dtype}")
    out = torch.empty((b, c), dtype=torch.bool, device=dev)
    _kernels.check_cuda("bool_mm", dev, x, w, out)
    _kernels.KERNELS["bool_mm"].launch(
        dev, x.data_ptr(), w.data_ptr(), out.data_ptr(), b, a, c, int(complement_x)
    )
    return out


def _verdict_block(
    sel_match: torch.Tensor,
    t: DeviceTables,
    subj_rows: torch.Tensor,
    peer_rows: torch.Tensor,
    dport: torch.Tensor,
    proto: torch.Tensor,
    has_l4: torch.Tensor,
) -> Verdict:
    subj8 = unpack_bits_u32(sel_match[subj_rows.long()])  # [b, S]
    peer8 = unpack_bits_u32(sel_match[peer_rows.long()])
    subj_b = subj8.to(torch.bool)

    deny_vec = subj_b & bool_mm(peer8, t.deny_t, complement_x=True)  # [b, S]
    allow_vec = subj_b & bool_mm(peer8, t.allow_t)
    deny = deny_vec.any(dim=1)
    l3_allow = allow_vec.any(dim=1)
    req_ok = ~deny

    pp = (
        (dport[:, None] == t.ports[None, :])
        & (proto[:, None] == t.protos[None, :])
        & has_l4[:, None]
    ).to(torch.int8)

    combo = bool_mm(subj8, t.s1_mat) & bool_mm(pp, t.p1_mat)  # [b, K1]
    en_hit = combo & bool_mm(peer8, t.en_t)
    ee_hit = combo & bool_mm(peer8, t.ee_t)
    l4_allow = en_hit.any(dim=1) | (req_ok & ee_hit.any(dim=1))

    group_ok = (
        bool_mm(peer8, t.gpn_mat)
        | (bool_mm(peer8, t.gpe_mat) & req_ok[:, None])
        | t.group_no_peers[None, :]
    )  # [b, G]
    l7_present = (
        bool_mm(subj8, t.s7_mat)
        & bool_mm(pp, t.p7_mat)
        & bool_mm(group_ok, t.g7_mat)
    ).any(dim=1)

    l3 = torch.where(deny, 2, torch.where(l3_allow, 1, 0)).to(torch.int8)
    decision = torch.where(
        l3_allow & ~deny, ALLOW, torch.where(has_l4 & l4_allow, ALLOW, DENY)
    ).to(torch.int8)
    # Datapath redirect semantics (bpf/lib/policy.h lookup order: the
    # exact {id,port,proto} entry wins over the L3-only entry): a flow
    # allowed at L4 through a parser-bearing filter redirects even when
    # L3 also allows it.
    l7_redirect = has_l4 & l4_allow & l7_present
    return Verdict(decision=decision, l3=l3, l7_redirect=l7_redirect)


def verdict_batch(
    policy: DevicePolicy,
    subj_rows: torch.Tensor,  # [B] int32 identity rows
    peer_rows: torch.Tensor,  # [B] int32
    dport: torch.Tensor,  # [B] int32 (with has_l4)
    proto: torch.Tensor,  # [B] int32 IANA proto (u8proto)
    has_l4: torch.Tensor,  # [B] bool — False = pure-L3 query
    ingress: bool = True,
    block: int = 8192,
    attrib: bool = False,
) -> Verdict:
    """Batch verdicts, ``block`` flows at a time to bound the
    [block, S] intermediates."""
    if attrib:
        raise NotImplementedError("verdict attribution is not in the torch port yet")
    t = policy.ingress if ingress else policy.egress
    b = subj_rows.shape[0]
    parts = [
        _verdict_block(
            policy.sel_match, t, subj_rows[lo:lo + block], peer_rows[lo:lo + block],
            dport[lo:lo + block], proto[lo:lo + block], has_l4[lo:lo + block],
        )
        for lo in range(0, b, block)
    ]
    if not parts:
        dev = subj_rows.device
        return Verdict(
            decision=torch.zeros(0, dtype=torch.int8, device=dev),
            l3=torch.zeros(0, dtype=torch.int8, device=dev),
            l7_redirect=torch.zeros(0, dtype=torch.bool, device=dev),
        )
    return Verdict(
        decision=torch.cat([p.decision for p in parts]),
        l3=torch.cat([p.l3 for p in parts]),
        l7_redirect=torch.cat([p.l7_redirect for p in parts]),
    )
