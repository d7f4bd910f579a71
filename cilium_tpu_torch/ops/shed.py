"""The admission gate's prefilter shed walk (K11 ``shed_walk``).

An identity LPM walk gives each flow's identity row (world on a miss),
``flow_class(dport, proto)`` gives its column, and the two index the
``[N, 9]`` uint8 deny-for-sure table that
``cilium_tpu_torch.datapath.admission.compile_shed_table`` compiles
→ ``[B]`` bool, True = shed. The reference is
``cilium_tpu/datapath/pipeline.py:521,537`` (``shed_flows_wide`` /
``shed_flows``).

One difference from the reference, on purpose: an index
``row * 9 + cls`` outside ``[0, N*9)`` (a row past the table, which a
table stale against the tries gives) sheds nothing here, where
``jnp.take`` on a uint8 table fills it with 255 and sheds. Shedding is
deny-for-sure, so "not sure" is the sound answer.

Each wrapper runs its plain version for CPU tensors and launches its
kernel entry for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .lpm import STRIDE8_ROUTES, lpm_stride8_plain, lpm_stride8_route, lpm_wide_plain

# the table's columns: 3 proto classes (TCP, UDP, other) x 3 dport
# buckets (< 1024, < 32768, the rest), as the kernel counts them and as
# datapath.admission.flow_class defines them
N_SHED_CLASSES = 9


def _flow_class(dport: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    pi = 2 - 2 * (proto == 6).to(torch.int64) - (proto == 17).to(torch.int64)
    return pi * 3 + (dport >= 1024).to(torch.int64) + (dport >= 32768).to(torch.int64)


def _shed_gather(shed_tab: torch.Tensor, hit: torch.Tensor, world_row: int,
                 dport: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """Identity hits (value+1, 0 = miss) → [B] bool shed mask."""
    row = torch.where(hit > 0, hit.to(torch.int64) - 1, int(world_row))
    idx = row * N_SHED_CLASSES + _flow_class(dport.to(torch.int64), proto.to(torch.int64))
    inside = (idx >= 0) & (idx < shed_tab.shape[0] * N_SHED_CLASSES)
    return inside & (shed_tab.reshape(-1)[torch.where(inside, idx, 0)] != 0)


def shed_walk_wide_plain(root_info, root_child, sub_child, sub_info, shed_tab, world_row,
                         addr_u32, dport, proto) -> torch.Tensor:
    """Plain PyTorch version of K11's ``shed_walk_wide`` entry."""
    hit = lpm_wide_plain(root_info, root_child, sub_child, sub_info, addr_u32)
    return _shed_gather(shed_tab, hit, world_row, dport, proto)


def shed_walk_stride8_plain(child, info, common, shed_tab, world_row, addr_bytes, dport,
                            proto, levels: int = 16) -> torch.Tensor:
    """Plain PyTorch version of K11's ``shed_walk_stride8`` entry."""
    hit = lpm_stride8_plain(child, info, common, addr_bytes, levels)
    return _shed_gather(shed_tab, hit, world_row, dport, proto)


def _check_flows(name: str, shed_tab, b: int, dport, proto) -> None:
    if shed_tab.dim() != 2 or shed_tab.shape[1] != N_SHED_CLASSES:
        raise ValueError(f"{name}: shed table must be [N, {N_SHED_CLASSES}]")
    if dport.shape != (b,) or proto.shape != (b,):
        raise ValueError(f"{name}: flow arrays differ in length")


def shed_walk_wide(
    root_info: torch.Tensor,  # [65536] int32
    root_child: torch.Tensor,  # [65536] int32
    sub_child: torch.Tensor,  # [M, 256] or [1, 65536] int32
    sub_info: torch.Tensor,  # [M, 256] or [M, 65536] int32
    shed_tab: torch.Tensor,  # [N, 9] uint8
    world_row: int,
    addr_u32: torch.Tensor,  # [B] int32 bit view of host-order addresses
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """→ [B] bool shed mask over the wide IPv4 identity trie."""
    dev = _kernels.dispatch_device(root_info, root_child, sub_child, sub_info, shed_tab,
                                   addr_u32, dport, proto)
    b = addr_u32.shape[0]
    _check_flows("shed_walk_wide", shed_tab, b, dport, proto)
    if dev.type == "cpu":
        return shed_walk_wide_plain(root_info, root_child, sub_child, sub_info, shed_tab,
                                    world_row, addr_u32, dport, proto)
    flat = sub_info.shape[-1] == 65536
    if root_info.shape != (65536,) or root_child.shape != (65536,) or (
        not flat and (sub_info.shape[-1] != 256 or sub_child.shape != sub_info.shape)
    ):
        raise ValueError("shed_walk_wide: not a wide-trie table set")
    tries = [x.to(torch.int32).contiguous() for x in (root_info, root_child, sub_child, sub_info)]
    flows = [x.to(torch.int32).contiguous() for x in (addr_u32, dport, proto)]
    tab = shed_tab.to(torch.uint8).contiguous()
    out = torch.empty(b, dtype=torch.uint8, device=dev)
    _kernels.check_cuda("shed_walk_wide", dev, *tries, tab, *flows, out)
    ri, rc, sc, si = tries
    _kernels.KERNELS["shed_walk_wide"].launch(
        dev, ri.data_ptr(), rc.data_ptr(), sc.data_ptr(), si.data_ptr(), si.shape[0],
        int(flat), tab.data_ptr(), tab.shape[0], int(world_row),
        *(x.data_ptr() for x in flows), out.data_ptr(), b,
    )
    return out.view(torch.bool)


def shed_walk_stride8(
    child: torch.Tensor,  # [M, 256] int32
    info: torch.Tensor,  # [M, 256] int32
    common: torch.Tensor,  # [K] int32 elided shared prefix bytes
    shed_tab: torch.Tensor,  # [N, 9] uint8
    world_row: int,
    addr_bytes: torch.Tensor,  # [B, >= levels] int32, one byte per level
    dport: torch.Tensor,  # [B] int32
    proto: torch.Tensor,  # [B] int32
    levels: int = 16,
) -> torch.Tensor:
    """→ [B] bool shed mask over the elided stride-8 identity trie."""
    dev = _kernels.dispatch_device(child, info, common, shed_tab, addr_bytes, dport, proto)
    b = addr_bytes.shape[0]
    k = common.shape[0]
    _check_flows("shed_walk_stride8", shed_tab, b, dport, proto)
    if (
        child.dim() != 2 or child.shape[-1] != 256 or child.shape != info.shape
        or addr_bytes.dim() != 2 or not 0 <= k <= levels <= addr_bytes.shape[1]
    ):
        raise ValueError("shed_walk_stride8: not a stride-8 trie and address batch")
    if dev.type == "cpu":
        return shed_walk_stride8_plain(child, info, common, shed_tab, world_row, addr_bytes,
                                       dport, proto, levels)
    tries = [x.to(torch.int32).contiguous() for x in (child, info, common)]
    addr = addr_bytes.to(torch.int32).contiguous()
    flows = [x.to(torch.int32).contiguous() for x in (dport, proto)]
    tab = shed_tab.to(torch.uint8).contiguous()
    out = torch.empty(b, dtype=torch.uint8, device=dev)
    _kernels.check_cuda("shed_walk_stride8", dev, *tries, tab, addr, *flows, out)
    ch, inf, com = tries
    route = lpm_stride8_route(addr.shape[1], levels, addr.data_ptr())
    STRIDE8_ROUTES["shed_walk_stride8"] = route
    _kernels.KERNELS["shed_walk_stride8"].launch(
        dev, ch.data_ptr(), inf.data_ptr(), ch.shape[0], com.data_ptr(), k, tab.data_ptr(),
        tab.shape[0], int(world_row), addr.data_ptr(), addr.shape[1], levels,
        *(x.data_ptr() for x in flows), out.data_ptr(), b, int(route == "vector"),
    )
    return out.view(torch.bool)
