"""Selector↔identity matching and the packed-bitmap bit order.

Given identity label bitmaps ``id_bits [N, W]`` and selector conjunct
masks ``conj_req/conj_forbid [S, CPS, W]``, compute the boolean match
matrix

    sel_match[n, s] = any_c valid[s,c]
                      & popcount(id & req[s,c])    == req_count[s,c]
                      & popcount(id & forbid[s,c]) == 0

bit-packed over the selector axis ([N, ceil(S/32)] words), so the
verdict kernels pay one 4-byte gather per (flow, selector-id) test.

Packed uint32 words are carried as int32 bit views throughout the
port (PyTorch on the CPU has no right shift for uint32); every unpack
is ``(w >> k) & 1``, where the mask makes the arithmetic shift of bit
31 harmless.

On a CUDA tensor :func:`compute_selector_matches` launches the
``selector_match`` kernel (csrc/selector_match.cu) on the route
:func:`selector_match_route` names; on a CPU tensor it runs
:func:`selector_match_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import _kernels

# K1's tiles and shared-memory budget (csrc/selector_match.cu): a block
# takes SEL_ROWS identity rows (a lane each, SEL_WARPS warps) and one
# output word; it stages its selectors' conjunct words SEL_STAGE_MAX at
# most a round; a block may take SEL_SMEM_BUDGET bytes.
SEL_ROWS = 128
SEL_WARPS = 4
SEL_STAGE_MAX = 2048
SEL_SMEM_BUDGET = 232448

# The route of K1's latest launch on the card, keyed "selector_match".
SELECTOR_ROUTES: Dict[str, str] = {}


def selector_match_smem_bytes(w: int, cps: int, staged: bool) -> int:
    """Shared memory of one K1 block: a round's entries (4 words each),
    its req and forbid words and its conjuncts' req_count, the warps'
    entry counts, and the [SEL_ROWS, W | 1] row tile when staged
    (csrc/selector_match.cu sel_smem_words)."""
    piece = 32 * SEL_WARPS
    stage = min(-(-32 * cps * w // piece) * piece, SEL_STAGE_MAX)
    return 4 * (7 * stage + 8 + (SEL_ROWS * (w | 1) if staged else 0))


def selector_match_route(w: int, cps: int) -> str:
    """The path K1 takes inside its kernel: "staged" (the row tile in
    shared memory) when a block's tiles fit SEL_SMEM_BUDGET, else
    "wide" (each list entry's word read from the row in device
    memory). A dense conjunct changes neither: its longer list runs
    over more rounds. Shapes past what a list entry packs (W > 65535,
    CPS > 1023) raise ValueError; the C entry refuses them too, and a
    staged route past the budget."""
    if not 0 <= w <= 65535 or not 0 <= cps <= 1023:
        raise ValueError(f"selector_match: W {w}, CPS {cps} past the kernel's entry packing")
    return "staged" if selector_match_smem_bytes(max(w, 1), cps, True) <= SEL_SMEM_BUDGET \
        else "wide"


def unpack_bits_u32(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words → [..., W*32] int8 (bit 0 of word 0 first).

    The single definition of the packed-bitmap bit order — the inverse
    of :func:`pack_bool_bits`."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).to(torch.int8)


def pack_bool_bits(flags: torch.Tensor) -> torch.Tensor:
    """[..., S] bool → [..., ceil(S/32)] int32 words (pads with zeros)."""
    s = flags.shape[-1]
    s_words = (s + 31) // 32
    pad = s_words * 32 - s
    if pad:
        flags = torch.cat(
            [flags, flags.new_zeros((*flags.shape[:-1], pad))], dim=-1
        )
    grouped = flags.reshape(*flags.shape[:-1], s_words, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=flags.device) << torch.arange(
        32, dtype=torch.int64, device=flags.device
    )
    words = (grouped * weights).sum(dim=-1)  # exact, < 2**32
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def selector_match_plain(
    id_bits: torch.Tensor,  # [N, W] int32
    conj_req: torch.Tensor,  # [S, CPS, W] int32
    conj_forbid: torch.Tensor,  # [S, CPS, W] int32
    conj_valid: torch.Tensor,  # [S, CPS] bool
    req_count: torch.Tensor,  # [S, CPS] int32
    row_chunk: int = 2048,
) -> torch.Tensor:
    """Plain PyTorch version of the ``selector_match`` kernel: two
    float64 products of unpacked 0/1 bit lanes per row chunk (exact:
    every sum is an integer far below 2**53)."""
    n, w = id_bits.shape
    s, cps, _ = conj_req.shape
    req_t = unpack_bits_u32(conj_req.reshape(s * cps, w)).T.to(torch.float64)
    forbid_t = unpack_bits_u32(conj_forbid.reshape(s * cps, w)).T.to(torch.float64)
    req_n = req_count.reshape(1, s * cps).to(torch.float64)
    valid = conj_valid.reshape(1, s * cps).to(torch.bool)
    out = []
    for lo in range(0, n, row_chunk):
        bits = unpack_bits_u32(id_bits[lo:lo + row_chunk]).to(torch.float64)
        hit_req = bits @ req_t
        hit_forbid = bits @ forbid_t
        ok = valid & (hit_req == req_n) & (hit_forbid == 0)
        sel = ok.reshape(bits.shape[0], s, cps).any(dim=-1)
        out.append(pack_bool_bits(sel))
    if not out:  # N = 0
        return torch.zeros((0, (s + 31) // 32), dtype=torch.int32, device=id_bits.device)
    return torch.cat(out)


def compute_selector_matches(
    id_bits: torch.Tensor,
    conj_req: torch.Tensor,
    conj_forbid: torch.Tensor,
    conj_valid: torch.Tensor,
    req_count: torch.Tensor,
    row_chunk: int = 2048,
) -> torch.Tensor:
    """→ packed sel_match [N, ceil(S/32)] int32 words."""
    dev = _kernels.dispatch_device(id_bits, conj_req, conj_forbid, conj_valid, req_count)
    if dev.type == "cpu":
        return selector_match_plain(
            id_bits, conj_req, conj_forbid, conj_valid, req_count, row_chunk
        )
    n, w = id_bits.shape
    s, cps, w2 = conj_req.shape
    if w2 != w or conj_forbid.shape != conj_req.shape or conj_valid.shape != (s, cps) \
            or req_count.shape != (s, cps):
        raise ValueError("compute_selector_matches: inconsistent shapes")
    route = selector_match_route(w, cps)
    if w == 0:  # no label words: one zero word matches the same way
        id_bits = id_bits.new_zeros((n, 1))
        conj_req = conj_forbid = conj_req.new_zeros((s, cps, 1))
        w = 1
    args = (
        _kernels.operand(id_bits, torch.int32),
        _kernels.operand(conj_req, torch.int32),
        _kernels.operand(conj_forbid, torch.int32),
        _kernels.operand(conj_valid, torch.bool),
        _kernels.operand(req_count, torch.int32),
    )
    out = torch.empty((n, (s + 31) // 32), dtype=torch.int32, device=dev)
    _kernels.check_cuda("selector_match", dev, *args, out)
    SELECTOR_ROUTES["selector_match"] = route
    _kernels.KERNELS["selector_match"].launch(
        dev, *(_kernels.ptr(a) for a in args), _kernels.ptr(out), n, w, s, cps,
        int(route == "staged"),
    )
    return out
