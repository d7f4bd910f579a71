"""Port parity: ops/bitmap.py — bit order and the selector match.

Same numpy inputs through the JAX functions and the port's plain
PyTorch versions; every output is packed integer words, so equality is
exact (tolerance 0).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.compiler import compile_policy
from cilium_tpu.ops import bitmap as jbitmap
from cilium_tpu_torch.convert import words_i32
from cilium_tpu_torch.ops import bitmap as tbitmap
from test_torch_harness import build_world


@pytest.mark.parametrize("shape", [(3, 1), (5, 4), (2, 3, 2)])
def test_unpack_bits_matches_jax(shape):
    words = np.random.default_rng(7).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    words[..., 0] |= np.uint32(1 << 31)  # bit 31 must survive the signed view
    want = np.asarray(jbitmap.unpack_bits_u32(jnp.asarray(words)))
    got = tbitmap.unpack_bits_u32(words_i32(words, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [1, 31, 32, 33, 100])
def test_pack_bool_bits_matches_jax(s):
    flags = np.random.default_rng(s).random((4, s)) < 0.5
    flags[:, -1] = True
    want = np.asarray(jbitmap.pack_bool_bits(jnp.asarray(flags)))
    got = tbitmap.pack_bool_bits(torch.from_numpy(flags)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    # the round trip is the identity on the live bits
    back = tbitmap.unpack_bits_u32(torch.from_numpy(got.view(np.int32))).numpy()
    np.testing.assert_array_equal(back[:, :s].astype(bool), flags)


@pytest.mark.parametrize("seed", [0, 3])
def test_compute_selector_matches_matches_jax(seed):
    w = build_world("cilium_tpu", seed, n_rules=32, n_idents=40)
    c = compile_policy(w.repo, w.reg)
    want = np.asarray(jbitmap.compute_selector_matches(
        jnp.asarray(c.id_bits), jnp.asarray(c.conj_req), jnp.asarray(c.conj_forbid),
        jnp.asarray(c.conj_valid), jnp.asarray(c.req_count),
    ))
    got = tbitmap.compute_selector_matches(
        words_i32(c.id_bits, "cpu"), words_i32(c.conj_req, "cpu"),
        words_i32(c.conj_forbid, "cpu"), torch.from_numpy(c.conj_valid),
        torch.from_numpy(c.req_count.astype(np.int32)), row_chunk=64,
    ).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert want.any()  # the world really matches selectors


def test_selector_match_random_conjuncts():
    """Random words, several conjuncts per selector, ragged S."""
    rs = np.random.default_rng(11)
    n, s, cps, w = 70, 45, 3, 2
    id_bits = rs.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    req = np.zeros((s, cps, w), np.uint32)
    forbid = np.zeros((s, cps, w), np.uint32)
    for si in range(s):
        for ci in range(cps):
            bits = rs.choice(w * 32, 3, replace=False)
            for b in bits[:2]:
                req[si, ci, b // 32] |= np.uint32(1 << (b % 32))
            if rs.random() < 0.5:
                forbid[si, ci, bits[2] // 32] |= np.uint32(1 << (bits[2] % 32))
    valid = rs.random((s, cps)) < 0.8
    count = np.array([[bin(int(x)).count("1") for x in row.ravel()] for row in req.reshape(s * cps, w)])
    count = count.sum(axis=1).reshape(s, cps).astype(np.int32)
    want = np.asarray(jbitmap.compute_selector_matches(
        jnp.asarray(id_bits), jnp.asarray(req), jnp.asarray(forbid),
        jnp.asarray(valid), jnp.asarray(count), row_chunk=32,
    ))
    got = tbitmap.compute_selector_matches(
        words_i32(id_bits, "cpu"), words_i32(req, "cpu"), words_i32(forbid, "cpu"),
        torch.from_numpy(valid), torch.from_numpy(count),
    ).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert want.any()
