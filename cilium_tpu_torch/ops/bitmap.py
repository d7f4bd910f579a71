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
``selector_match`` kernel (csrc/selector_match.cu); on a CPU tensor it
runs :func:`selector_match_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from .. import _kernels


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
        sel = ok.reshape(-1, s, cps).any(dim=-1)
        out.append(pack_bool_bits(sel))
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
    args = (
        id_bits.to(torch.int32).contiguous(),
        conj_req.to(torch.int32).contiguous(),
        conj_forbid.to(torch.int32).contiguous(),
        conj_valid.to(torch.bool).contiguous(),
        req_count.to(torch.int32).contiguous(),
    )
    out = torch.empty((n, (s + 31) // 32), dtype=torch.int32, device=dev)
    _kernels.check_cuda("selector_match", dev, *args, out)
    _kernels.KERNELS["selector_match"].launch(
        dev, *(_kernels.ptr(a) for a in args), _kernels.ptr(out), n, w, s, cps
    )
    return out
