"""Carry compiled state from numpy arrays into the port's tensors.

The compiler, the trie builders and the JAX package's device tables
all end in numpy arrays (``np.asarray`` of a JAX array is one). These
functions turn them into the port's dataclasses of tensors on one
device. Packed uint32 words travel as int32 bit views
(``arr.view(np.int32)``): PyTorch on the CPU has no right shift and no
``index_put_`` for uint32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .ops.bitmap import compute_selector_matches
from .ops.lookup import PolicymapTables
from .ops.verdict import DevicePolicy, DeviceTables


def words_i32(arr, device) -> torch.Tensor:
    """uint32 (or int32) words → int32 bit-view tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError(f"packed words must be uint32 or int32, got {a.dtype}")
    return _tensor(a, device)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy → tensor on ``device``; a read-only array (a view of a
    JAX buffer) is copied so the tensor never aliases it."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def device_policy_from_numpy(
    compiled, *, device, sel_match: Optional[np.ndarray] = None
) -> DevicePolicy:
    """A ``CompiledPolicy`` (of either package) → ``DevicePolicy``.
    Without ``sel_match`` the selector match is computed on ``device``
    by :func:`compute_selector_matches`."""
    id_bits = words_i32(compiled.id_bits, device)
    if sel_match is None:
        sel = compute_selector_matches(
            id_bits,
            words_i32(compiled.conj_req, device),
            words_i32(compiled.conj_forbid, device),
            _tensor(np.asarray(compiled.conj_valid, bool), device),
            _tensor(np.asarray(compiled.req_count, np.int32), device),
        )
    else:
        sel = words_i32(sel_match, device)
    return DevicePolicy(
        id_bits=id_bits,
        sel_match=sel,
        ingress=DeviceTables.from_host(compiled.ingress, device),
        egress=DeviceTables.from_host(compiled.egress, device),
    )


def policymap_from_numpy(
    col_ep, col_port, col_proto, col_is_l3, id_bits, *, device
) -> PolicymapTables:
    """Policymap column metadata + packed [N, 2W] words → tables."""

    def i32(a):
        return _tensor(np.asarray(a, np.int32), device)

    return PolicymapTables(
        col_ep=i32(col_ep),
        col_port=i32(col_port),
        col_proto=i32(col_proto),
        col_is_l3=_tensor(np.asarray(col_is_l3, bool), device),
        id_bits=words_i32(id_bits, device),
    )


def wide_tables_from_numpy(
    tries: Sequence[np.ndarray], world_row: int, policymap: PolicymapTables, *, device
):
    """The twelve v4 wide-trie arrays (deny, identity, merged; each
    root_info, root_child, sub_child, sub_info) + the world row + a
    policymap → ``WideDatapathTables``."""
    from .datapath.pipeline import WideDatapathTables

    if len(tries) != 12:
        raise ValueError(f"expected 12 trie arrays, got {len(tries)}")
    t = [_tensor(np.asarray(a, np.int32), device) for a in tries]
    return WideDatapathTables(
        pf_root_info=t[0], pf_root_child=t[1], pf_sub_child=t[2], pf_sub_info=t[3],
        ip_root_info=t[4], ip_root_child=t[5], ip_sub_child=t[6], ip_sub_info=t[7],
        merged_root_info=t[8], merged_root_child=t[9], merged_sub_child=t[10],
        merged_sub_info=t[11],
        world_row=int(world_row),
        policymap=policymap,
    )


def v6_tables_from_numpy(
    tries: Sequence[np.ndarray], world_row: int, policymap: PolicymapTables, *, device
):
    """The nine v6 elided-trie arrays (deny, identity, merged; each
    child, info, common) + the world row + a policymap →
    ``DatapathTables``."""
    from .datapath.pipeline import DatapathTables

    if len(tries) != 9:
        raise ValueError(f"expected 9 trie arrays, got {len(tries)}")
    t = [_tensor(np.asarray(a, np.int32), device) for a in tries]
    return DatapathTables(
        pf_child=t[0], pf_info=t[1], pf_common=t[2],
        ip_child=t[3], ip_info=t[4], ip_common=t[5],
        merged_child=t[6], merged_info=t[7], merged_common=t[8],
        world_row=int(world_row),
        policymap=policymap,
    )


def dfa_table_from_numpy(trans, accept, starts, pair, device, key=("numpy",)):
    """A ``FusedDFA``'s (or a ``MultiDFA``'s) numpy arrays, from either
    package → the port's ``DeviceDFATable`` on ``device``: ``trans``
    [Q, 256] int32, ``accept`` [Q] uint64 (split into two int32 bit
    views of its uint32 halves, as :func:`words_i32` carries words),
    ``starts`` [F] int32 field starts (a ``MultiDFA``'s scalar start is
    one field of Q states) and ``pair`` [Q, 257²] int32 or None."""
    from .ops.dfa import DeviceDFATable, FusedDFA

    trans = np.asarray(trans, np.int32)
    starts = np.atleast_1d(np.asarray(starts, np.int32))
    if trans.ndim != 2 or not starts.size or trans.shape[0] % starts.size:
        raise ValueError("trans must be [F * q_pad, 256] for F field starts")
    fused = FusedDFA(
        trans=trans,
        accept=np.asarray(accept, np.uint64),
        starts=starts,
        q_pad=trans.shape[0] // starts.size,
        n_fields=int(starts.size),
        pair=None if pair is None else np.asarray(pair, np.int32),
    )
    return DeviceDFATable(key, fused, device)


def lb_tables_from_numpy(
    fe_bytes, fe_port, fe_proto, fe_seq, fe_seq_len, fe_revnat, be_bytes, be_port, *, device
):
    """The eight LB arrays of ``ServiceManager.build_device`` (or the
    fields of the JAX package's ``LBTables``) → the port's ``LBTables``
    on ``device``, int32 throughout."""
    from .lb.device import LBTables

    def i32(a):
        return _tensor(np.asarray(a, np.int32), device)

    return LBTables(
        fe_bytes=i32(fe_bytes), fe_port=i32(fe_port), fe_proto=i32(fe_proto),
        fe_seq=i32(fe_seq), fe_seq_len=i32(fe_seq_len), fe_revnat=i32(fe_revnat),
        be_bytes=i32(be_bytes), be_port=i32(be_port),
    )


def device_ct_state_from_numpy(arrays, device=None):
    """A JAX ``DeviceCTState``'s seven [C] arrays as numpy (ka_hi,
    ka_lo, kb_hi, kb_lo, kc_hi, kc_lo uint32; exp int32), in field
    order → the port's ``DeviceCTState`` on ``device`` (None = the
    card), key words as int32 bit views and no insert claims."""
    from ._kernels import resolve_device
    from .datapath.device_ct import DeviceCTState

    arrays = [np.asarray(a) for a in arrays]
    c = arrays[-1].shape[0] if arrays else 0
    if len(arrays) != 7 or c <= 0 or c & (c - 1) or any(a.shape != (c,) for a in arrays):
        raise ValueError("expected the seven CT arrays, [C] each, C a power of two")
    dev = resolve_device(device)
    return DeviceCTState(
        *(words_i32(a, dev) for a in arrays[:6]),
        exp=_tensor(arrays[6].astype(np.int32), dev),
        owner=torch.full((c,), -1, dtype=torch.int32, device=dev),
    )
