"""Device LB tables + the VIP→backend translate step.

Reference: bpf/lib/lb.h:36-83 (``cilium_lb4_services`` /
``cilium_lb4_backends-in-service`` slave slots / ``cilium_lb4_rr_seq``)
and their Go programming side (pkg/maps/lbmap/lbmap.go:274,351).
The kernel does three hash-map probes per packet: frontend lookup,
slave-slot lookup, revNAT record.

Here the frontend "hash map" is a scan for the first frontend whose
address, port and protocol match (the reference caps frontends at 256,
bpf/lib/lb.h:36, so F is small). Slave selection is one gather into a
per-service **selection sequence**: the weighted-RR sequence of
lbmap.go:351 and plain hash-mod selection collapse into the same
tensor (equal weights ⇒ the sequence is just the backend list).
Backend translation is one row gather.

:func:`lb_translate` launches the ``lb_translate`` kernel
(csrc/lb_translate.cu) on CUDA tensors and runs its plain version,
:func:`lb_translate_plain` (the dense ``[B, F]`` compare), on CPU
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _kernels

MAX_SEQ = 64  # selection-sequence width (weighted-RR resolution)


@dataclasses.dataclass(frozen=True)
class LBTables:
    """Device state for one address family (L = 4 or 16 address bytes),
    all int32 tensors on one device.

    Empty frontend slots carry fe_port = -1 (never matches a real
    dport ≥ 0); fe_proto 0 means ANY (L4Addr with protocol NONE).
    """

    fe_bytes: torch.Tensor  # [F, L] int32 VIP address bytes
    fe_port: torch.Tensor  # [F] int32
    fe_proto: torch.Tensor  # [F] int32 (0 = ANY)
    fe_seq: torch.Tensor  # [F, MAX_SEQ] int32 backend row per slot
    fe_seq_len: torch.Tensor  # [F] int32 live slots (0 = no backends)
    fe_revnat: torch.Tensor  # [F] int32 revNAT id
    be_bytes: torch.Tensor  # [NB, L] int32 backend address bytes
    be_port: torch.Tensor  # [NB] int32


def _gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A JAX ``x[idx]`` index: negative values count from the end, then
    the result is clamped into [0, n)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _check(t: LBTables, peer_bytes, dport, proto, fhash) -> None:
    f, length = t.fe_bytes.shape
    s = t.fe_seq.shape[1]
    nb = t.be_bytes.shape[0]
    if f == 0 or nb == 0 or s == 0:
        raise ValueError("lb_translate: empty frontend, backend or sequence table")
    if (
        peer_bytes.dim() != 2 or peer_bytes.shape[1] != length or length not in (4, 16)
        or t.be_bytes.shape[1] != length or t.fe_seq.shape[0] != f
        or any(x.shape != (f,) for x in (t.fe_port, t.fe_proto, t.fe_seq_len, t.fe_revnat))
        or t.be_port.shape != (nb,)
        or any(x.shape != (peer_bytes.shape[0],) for x in (dport, proto, fhash))
    ):
        raise ValueError("lb_translate: tables and flows do not fit together")


def lb_translate_plain(
    t: LBTables,
    peer_bytes: torch.Tensor,
    dport: torch.Tensor,
    proto: torch.Tensor,
    fhash: torch.Tensor,
):
    """The plain version of :func:`lb_translate`: the dense [B, F]
    compare, first match by argmax, JAX's floor modulo and clamping
    gathers."""
    _check(t, peer_bytes, dport, proto, fhash)
    m = (t.fe_bytes[None, :, :] == peer_bytes[:, None, :]).all(-1)
    m &= dport[:, None] == t.fe_port[None, :]
    m &= (t.fe_proto[None, :] == 0) | (proto[:, None] == t.fe_proto[None, :])
    hit = m.any(dim=1)
    # first True (argmax of a bool row); 0 for a row with no match
    fe = m.to(torch.int8).argmax(dim=1)
    slen = t.fe_seq_len[fe]
    idx = torch.remainder(fhash, slen.clamp(min=1))
    be = t.fe_seq[fe, idx.to(torch.int64).clamp(max=t.fe_seq.shape[1] - 1)]
    be = _gather_index(be, t.be_bytes.shape[0])
    ok = hit & (slen > 0)
    no_backend = hit & (slen == 0)
    new_bytes = torch.where(ok[:, None], t.be_bytes[be], peer_bytes).to(torch.int32)
    new_port = torch.where(ok, t.be_port[be], dport).to(torch.int32)
    revnat = torch.where(hit, t.fe_revnat[fe], 0).to(torch.int32)
    return new_bytes, new_port, revnat, ok, no_backend


def lb_translate(
    t: LBTables,
    peer_bytes: torch.Tensor,  # [B, L] int32 destination address bytes
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
    fhash: torch.Tensor,  # [B] int32 flow hash (slave selector)
):
    """→ (new_bytes [B, L] int32, new_port [B] int32, revnat [B] int32,
    translated [B] bool, no_backend [B] bool).

    ``no_backend`` marks flows that matched a frontend with zero
    backends — the kernel drops these (lb4_local: slave lookup
    failure → DROP_NO_SERVICE). ``revnat`` is the matched frontend's
    id whenever a frontend matched, a no-backend one included.
    """
    dev = _kernels.dispatch_device(
        peer_bytes, dport, proto, fhash, *(getattr(t, f.name) for f in dataclasses.fields(t))
    )
    if dev.type == "cpu":
        return lb_translate_plain(t, peer_bytes, dport, proto, fhash)
    _check(t, peer_bytes, dport, proto, fhash)
    tabs = [getattr(t, f.name).to(torch.int32).contiguous() for f in dataclasses.fields(t)]
    flows = [x.to(torch.int32).contiguous() for x in (peer_bytes, dport, proto, fhash)]
    b, length = flows[0].shape
    new_bytes = torch.empty((b, length), dtype=torch.int32, device=dev)
    new_port = torch.empty(b, dtype=torch.int32, device=dev)
    revnat = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    no_backend = torch.empty(b, dtype=torch.bool, device=dev)
    outs = (new_bytes, new_port, revnat, ok, no_backend)
    _kernels.check_cuda("lb_translate", dev, *tabs, *flows, *outs)
    fe_bytes, fe_port, fe_proto, fe_seq, fe_seq_len, fe_revnat, be_bytes, be_port = tabs
    _kernels.KERNELS["lb_translate"].launch(
        dev, fe_bytes.data_ptr(), fe_port.data_ptr(), fe_proto.data_ptr(),
        fe_seq.data_ptr(), fe_seq.shape[1], fe_seq_len.data_ptr(), fe_revnat.data_ptr(),
        fe_bytes.shape[0], be_bytes.data_ptr(), be_port.data_ptr(), be_bytes.shape[0],
        length, *(x.data_ptr() for x in flows), *(x.data_ptr() for x in outs), b,
    )
    return outs


def flow_hash32(
    peer_bytes: np.ndarray,  # [B, L] address bytes of the pre-NAT dst
    sports: Optional[np.ndarray],
    dports: np.ndarray,
    protos: np.ndarray,
    ep_ids: np.ndarray,  # [B] STABLE endpoint ids (not list indices)
) -> np.ndarray:
    """[B] int32 ≥ 0 deterministic per-flow hash (the skb flow-hash
    role). Determinism matters beyond affinity: the conntrack key of a
    load-balanced flow embeds the *translated* backend tuple, so the
    same packet must keep selecting the same backend for the
    established-flow bypass to hit. The endpoint contribution must be
    the endpoint's stable ID — a positional index would re-select
    backends for every established flow whenever an unrelated endpoint
    joins or leaves the list."""
    b = peer_bytes.shape[0]
    x = np.zeros(b, np.uint32)
    with np.errstate(over="ignore"):
        for col in range(peer_bytes.shape[1]):
            x = (x * np.uint32(0x01000193)) ^ peer_bytes[:, col].astype(np.uint32)
        if sports is not None:
            x ^= np.asarray(sports, np.uint32) << np.uint32(16)
        x ^= np.asarray(dports, np.uint32)
        x ^= np.asarray(protos, np.uint32) << np.uint32(8)
        x ^= np.asarray(ep_ids, np.uint32) << np.uint32(24)
        # final avalanche (murmur3 fmix32)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return (x & np.uint32(0x7FFFFFFF)).astype(np.int32)
