"""Device LB tables + the VIP→backend translate step.

Reference: bpf/lib/lb.h:36-83 (``cilium_lb4_services`` /
``cilium_lb4_backends-in-service`` slave slots / ``cilium_lb4_rr_seq``)
and their Go programming side (pkg/maps/lbmap/lbmap.go:274,351).
The kernel does three hash-map probes per packet: frontend lookup,
slave-slot lookup, revNAT record.

The function finds the first (lowest) frontend whose address, port and
protocol match. The JAX step compares every flow with every frontend;
on the card the ``lb_translate`` kernel (csrc/lb_translate.cu) finds it
as the reference's datapath does, through a hash: :func:`lb_index_build`
(entry ``lb_index_build``) indexes the frontends' keys by open
addressing, and the ``lb_translate`` entry probes each flow's key.
Slave selection is one gather into a per-service **selection
sequence**: the weighted-RR sequence of lbmap.go:351 and plain hash-mod
selection collapse into the same tensor (equal weights ⇒ the sequence
is just the backend list). Backend translation is one row gather.

:func:`lb_translate` launches both entries on CUDA tensors and runs its
plain version, :func:`lb_translate_plain` (the dense ``[B, F]``
compare), on CPU tensors.
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


def lb_index_slots(f: int) -> int:
    """Slots of the frontend index for ``f`` frontends: the least power
    of two ≥ 2f (a load of at most 1/2), and at least 64."""
    return max(64, 1 << (2 * f - 1).bit_length())


def _mix32_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x.astype(np.uint32, copy=True)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


def lb_key_hash_np(addr: np.ndarray, port: np.ndarray, proto: np.ndarray) -> np.ndarray:
    """[K] uint32 hashes of index keys (the kernel's ``key_hash`` over
    ``addr_port_hash``): the murmur3 fmix32 chain over the L address
    words, the port and the protocol, each a full 32-bit word. A key's
    home slot is its hash mod the index's slots."""
    addr = np.asarray(addr).astype(np.int64).astype(np.uint32)
    h = _mix32_np(addr[:, 0])
    for k in range(1, addr.shape[1]):
        h = _mix32_np(h ^ addr[:, k])
    h = _mix32_np(h ^ np.asarray(port).astype(np.int64).astype(np.uint32))
    return _mix32_np(h ^ np.asarray(proto).astype(np.int64).astype(np.uint32))


def lb_index_build_plain(t: LBTables) -> torch.Tensor:
    """The plain version of :func:`lb_index_build` → [N] int32 (N =
    :func:`lb_index_slots`), -1 for an empty slot: each distinct key
    (address words, port, fe_proto) holds its lowest frontend on its
    linear-probing chain. Keys are placed in rounds, lowest frontend
    first; the kernel's atomics may lay the same keys out in another
    order along their chains, so two indexes are compared by their
    sorted entries (:func:`lb_index_entries`)."""
    f, _length = t.fe_bytes.shape
    n = lb_index_slots(f)
    keys = np.concatenate([t.fe_bytes.cpu().numpy(), t.fe_port.cpu().numpy()[:, None],
                           t.fe_proto.cpu().numpy()[:, None]], 1)
    _, first = np.unique(keys, axis=0, return_index=True)
    pending = np.sort(first)  # the lowest frontend of each key
    k = keys[pending]
    pos = (lb_key_hash_np(k[:, :-2], k[:, -2], k[:, -1]) & np.uint32(n - 1)).astype(np.int64)
    index = np.full(n, -1, np.int32)
    while pending.size:
        free = index[pos] < 0
        # of the keys at one free slot, the lowest frontend takes it
        _, win = np.unique(np.where(free, pos, -1), return_index=True)
        win = win[free[win]]
        index[pos[win]] = pending[win]
        keep = np.ones(pending.size, bool)
        keep[win] = False
        pending, pos = pending[keep], (pos[keep] + 1) & (n - 1)
    return torch.from_numpy(index).to(t.fe_port.device)


def lb_index_entries(index: torch.Tensor) -> torch.Tensor:
    """The frontends an index holds, sorted: equal for two indexes of
    one table whatever the order their keys were placed in."""
    return torch.sort(index[index >= 0]).values


_FIELDS = tuple(f.name for f in dataclasses.fields(LBTables))


def _int32_tables(t: LBTables):
    return [_kernels.operand(getattr(t, f), torch.int32) for f in _FIELDS]


def _launch_build(dev: torch.device, fe_bytes, fe_port, fe_proto) -> torch.Tensor:
    """One ``lb_index_build`` launch over contiguous int32 frontend
    columns → the index (the entry fills it with -1 first)."""
    f, length = fe_bytes.shape
    n = lb_index_slots(f)
    index = torch.empty(n, dtype=torch.int32, device=dev)
    _kernels.check_cuda("lb_index_build", dev, fe_bytes, fe_port, fe_proto, index)
    _kernels.KERNELS["lb_index_build"].launch(
        dev, fe_bytes.data_ptr(), fe_port.data_ptr(), fe_proto.data_ptr(), f, length,
        index.data_ptr(), n)
    return index


def _launch_probe(dev: torch.device, tabs, index: torch.Tensor, flows):
    """One ``lb_translate`` launch: contiguous int32 tables and flows,
    checked by the caller → the five results."""
    fe_bytes, fe_port, fe_proto, fe_seq, fe_seq_len, fe_revnat, be_bytes, be_port = tabs
    b, length = flows[0].shape
    if index.dtype != torch.int32 or index.shape != (lb_index_slots(fe_bytes.shape[0]),):
        raise ValueError("lb_translate: the index does not fit the frontend table")
    outs = (torch.empty((b, length), dtype=torch.int32, device=dev),
            torch.empty(b, dtype=torch.int32, device=dev),
            torch.empty(b, dtype=torch.int32, device=dev),
            torch.empty(b, dtype=torch.bool, device=dev),
            torch.empty(b, dtype=torch.bool, device=dev))
    _kernels.check_cuda("lb_translate", dev, index, *tabs, *flows, *outs)
    _kernels.KERNELS["lb_translate"].launch(
        dev, index.data_ptr(), index.shape[0], fe_bytes.data_ptr(), fe_port.data_ptr(),
        fe_proto.data_ptr(), fe_seq.data_ptr(), fe_seq.shape[1], fe_seq_len.data_ptr(),
        fe_revnat.data_ptr(), fe_bytes.shape[0], be_bytes.data_ptr(), be_port.data_ptr(),
        be_bytes.shape[0], length, *(x.data_ptr() for x in flows), *(x.data_ptr() for x in outs),
        b,
    )
    return outs


def lb_index_build(t: LBTables) -> torch.Tensor:
    """The frontend index of ``t`` → [N] int32, N = :func:`lb_index_slots`
    (F), -1 for an empty slot: one launch of the ``lb_index_build``
    entry on CUDA tensors, :func:`lb_index_build_plain` on CPU tensors."""
    dev = _kernels.dispatch_device(t.fe_bytes, t.fe_port, t.fe_proto)
    f, length = t.fe_bytes.shape
    if f == 0 or length not in (4, 16) or any(x.shape != (f,) for x in (t.fe_port, t.fe_proto)):
        raise ValueError("lb_index_build: frontend tables do not fit together")
    if dev.type == "cpu":
        return lb_index_build_plain(t)
    return _launch_build(dev, *(_kernels.operand(x, torch.int32)
                                for x in (t.fe_bytes, t.fe_port, t.fe_proto)))


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
    id whenever a frontend matched, a no-backend one included. On
    CUDA tensors: one ``lb_index_build`` and one ``lb_translate``
    launch.
    """
    dev = _kernels.dispatch_device(peer_bytes, dport, proto, fhash,
                                   *(getattr(t, f) for f in _FIELDS))
    if dev.type == "cpu":
        return lb_translate_plain(t, peer_bytes, dport, proto, fhash)
    _check(t, peer_bytes, dport, proto, fhash)
    tabs = _int32_tables(t)
    flows = [_kernels.operand(x, torch.int32) for x in (peer_bytes, dport, proto, fhash)]
    return _launch_probe(dev, tabs, _launch_build(dev, *tabs[:3]), flows)


def lb_probe(t: LBTables, index: torch.Tensor, peer_bytes, dport, proto, fhash):
    """The ``lb_translate`` entry alone: the flows probed through
    ``index`` (:func:`lb_index_build` of ``t``) → the results of
    :func:`lb_translate`; on CPU tensors its plain version."""
    dev = _kernels.dispatch_device(index, peer_bytes, dport, proto, fhash,
                                   *(getattr(t, f) for f in _FIELDS))
    if dev.type == "cpu":
        return lb_translate_plain(t, peer_bytes, dport, proto, fhash)
    _check(t, peer_bytes, dport, proto, fhash)
    flows = [_kernels.operand(x, torch.int32) for x in (peer_bytes, dport, proto, fhash)]
    return _launch_probe(dev, _int32_tables(t), index, flows)


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
