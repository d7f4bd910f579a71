"""Port parity: the L7 DFA compiler copies and the three DFA walks.

The port's copies of ``compile_patterns`` / ``fuse_dfas`` /
``_pair_table`` / ``strings_to_batch*`` must build the same numpy
arrays as the JAX package's; the plain versions of the ``dfa_walk``
kernel (both entries) and the ``dfa_pair_walk`` kernel must give the
same accept masks as ``dfa_match_batch`` / ``_fused`` / ``_pair`` on
the same inputs, bit for bit. Inputs are made from seeds with numpy
and ``random``. One divergence is named and tested on its own: the
JAX pair walk reads one byte past an odd ``max_len`` for a row longer
than it (ROADMAP queue C); every other pair-walk case keeps
``length <= max_len``.
"""

from __future__ import annotations

import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu import metrics as jmetrics
from cilium_tpu.l7 import regex_compile as jrc
from cilium_tpu.ops import dfa as jdfa
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.convert import dfa_table_from_numpy
from cilium_tpu_torch.l7 import regex_compile as trc
from cilium_tpu_torch.ops import dfa as tdfa

ATOMS = ["a", "b", "0", "/", "[a-z]", "[0-9]", ".", "x+", "b*", "(ab|ba)", "c?", "[^a]"]
ALPHABET = "ab0/xcyz\x00"


@pytest.fixture(autouse=True)
def _reset_intern():
    jdfa._reset_intern_for_tests()
    tdfa._reset_intern_for_tests()
    yield
    jdfa._reset_intern_for_tests()
    tdfa._reset_intern_for_tests()


def _patterns(rng: random.Random, n: int):
    out = []
    while len(out) < n:
        pat = "".join(rng.choice(ATOMS) for _ in range(rng.randrange(1, 6)))
        try:
            re.compile(pat)
        except re.error:
            continue
        out.append(pat)
    return out


def _strings(rng: random.Random, n: int, longest: int):
    return [
        "".join(rng.choice(ALPHABET) for _ in range(rng.randrange(0, longest + 1))).encode()
        for _ in range(n)
    ]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _jax_accept(accept):
    return (
        jnp.asarray((accept & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((accept >> np.uint64(32)).astype(np.uint32)),
    )


def _fused_pair(seed: int, n_fields: int = 2):
    """A fused table of ``n_fields`` random automata (for both
    packages) small enough to carry a pair table."""
    rng = random.Random(seed)
    sets = [_patterns(rng, rng.randrange(2, 6)) for _ in range(n_fields)]
    jf = jdfa.fuse_dfas([jrc.compile_patterns(p) for p in sets])
    tf = tdfa.fuse_dfas([trc.compile_patterns(p) for p in sets])
    return jf, tf


def _batch(seed: int, n: int, max_len: int, n_starts: np.ndarray, longest: int):
    rs = np.random.default_rng(seed)
    strs = _strings(random.Random(seed), n, longest)
    sb, lens = jdfa.strings_to_batch_u8(strs, max_len)
    lens = lens.copy()
    lens[rs.random(n) < 0.05] = -1
    starts = rs.choice(n_starts, n).astype(np.int32)
    return sb, lens, starts


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_compiler_copies_build_equal_arrays(seed):
    rng = random.Random(seed)
    sets = [_patterns(rng, rng.randrange(1, 12)) for _ in range(3)]
    jd = [jrc.compile_patterns(p) for p in sets]
    td = [trc.compile_patterns(p) for p in sets]
    assert trc.MAX_DFA_STATES == jrc.MAX_DFA_STATES == 4096
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(a.trans, b.trans)
        np.testing.assert_array_equal(a.accept, b.accept)
        assert (a.start, a.n_patterns) == (b.start, b.n_patterns)
        for s in _strings(rng, 50, 12):
            assert a.match_str(s) == b.match_str(s)
    jf, tf = jdfa.fuse_dfas(jd), tdfa.fuse_dfas(td)
    for field in ("trans", "accept", "starts"):
        np.testing.assert_array_equal(getattr(jf, field), getattr(tf, field))
    assert (jf.q_pad, jf.n_fields, jf.n_states) == (tf.q_pad, tf.n_fields, tf.n_states)
    assert (jf.pair is None) == (tf.pair is None)
    if jf.pair is not None:
        np.testing.assert_array_equal(jf.pair, tf.pair)
    np.testing.assert_array_equal(jdfa._pair_table(jd[0].trans), tdfa._pair_table(td[0].trans))
    nopair = tdfa.fuse_dfas(td, pair_cap_elems=0)
    assert nopair.pair is None and jdfa.fuse_dfas(jd, pair_cap_elems=0).pair is None


@pytest.mark.parametrize("max_len", [3, 16, 64])
def test_packers_equal(max_len):
    rng = random.Random(max_len)
    strs = _strings(rng, 200, max_len + 6) + [b"", b"a\x00", b"\x00" * max_len]
    for jfn, tfn in ((jdfa.strings_to_batch, tdfa.strings_to_batch),
                     (jdfa.strings_to_batch_u8, tdfa.strings_to_batch_u8)):
        (ja, jl), (ta, tl) = jfn(strs, max_len), tfn(strs, max_len)
        assert ja.dtype == ta.dtype and jl.dtype == tl.dtype
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jl, tl)
    assert tdfa.len_rung(3, 3) == jdfa.len_rung(3, 3) == 3
    for needed, cap in ((1, 128), (17, 128), (100, 256), (200, 256), (5, 24), (500, 24)):
        assert tdfa.len_rung(needed, cap) == jdfa.len_rung(needed, cap)


@pytest.mark.parametrize("seed", range(3))
def test_generated_tables_stay_in_range(seed):
    """Every entry of a compiled, fused or pair table is a state id in
    [0, Q), so the JAX walks never gather out of range on them."""
    rng = random.Random(50 + seed)
    dfas = [trc.compile_patterns(_patterns(rng, rng.randrange(1, 10))) for _ in range(3)]
    for d in dfas:
        assert 0 <= d.trans.min() and d.trans.max() < d.trans.shape[0]
        assert 0 <= d.start < d.trans.shape[0]
    f = tdfa.fuse_dfas(dfas)
    q = f.n_states
    assert 0 <= f.trans.min() and f.trans.max() < q
    assert ((0 <= f.starts) & (f.starts < q)).all()
    assert f.pair is not None
    assert 0 <= f.pair.min() and f.pair.max() < q
    # (pad, pad) is the identity: the pair walk may stop at the length
    pad = tdfa.PAIR_PAD * tdfa.PAIR_ALPHA + tdfa.PAIR_PAD
    np.testing.assert_array_equal(f.pair[:, pad], np.arange(q))


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", [16, 32, 64, 128, 3, 5, 17])
def test_single_walk_matches_dfa_match_batch(max_len):
    """K7's scalar-start entry (int32 bytes) against dfa_match_batch,
    with lengths -1, NUL bytes and lengths past max_len (the single
    walk steps min(length, max_len) bytes in both)."""
    rng = random.Random(max_len)
    dfa = jrc.compile_patterns(_patterns(rng, 10))
    strs = _strings(rng, 300, max_len)
    sb, lens = jdfa.strings_to_batch(strs, max_len)
    lens = lens.copy()
    rs = np.random.default_rng(max_len)
    lens[rs.random(lens.size) < 0.05] = -1
    longer = rs.random(lens.size) < 0.1
    lens[longer] = max_len + rs.integers(1, 9, int(longer.sum()))
    jlo, jhi = jdfa.dfa_match_batch(*jdfa.device_dfa(dfa), jnp.asarray(sb), jnp.asarray(lens), max_len)
    tlo, thi = tdfa.dfa_match_batch(*tdfa.device_dfa(dfa, "cpu"), _t(sb), _t(lens), max_len)
    np.testing.assert_array_equal(_u32(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_u32(thi), np.asarray(jhi))
    assert np.asarray(jlo).any()


@pytest.mark.parametrize("max_len", [16, 32, 64, 128, 3, 5, 17])
def test_fused_walk_matches_dfa_match_batch_fused(max_len):
    """K7's per-row-start entry (uint8 bytes) against
    dfa_match_batch_fused on a three-field stacked table."""
    jf, tf = _fused_pair(max_len, n_fields=3)
    sb, lens, starts = _batch(max_len, 400, max_len, tf.starts, max_len)
    rs = np.random.default_rng(max_len + 1)
    longer = rs.random(lens.size) < 0.1
    lens[longer] = max_len + 3
    jlo, jhi = jdfa.dfa_match_batch_fused(
        jnp.asarray(jf.trans), *_jax_accept(jf.accept), jnp.asarray(starts),
        jnp.asarray(sb), jnp.asarray(lens), max_len)
    lo, hi = tdfa.accept_words(tf.accept)
    tlo, thi = tdfa.dfa_match_batch_fused(
        _t(tf.trans), _t(lo), _t(hi), _t(starts), _t(sb), _t(lens), max_len)
    np.testing.assert_array_equal(_u32(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_u32(thi), np.asarray(jhi))


@pytest.mark.parametrize("max_len", [16, 32, 64, 128, 3, 5, 17])
def test_pair_walk_matches_dfa_match_batch_pair(max_len):
    """K8 against dfa_match_batch_pair with every length <= max_len
    (odd caps included: a half pair at the end), and equal to the
    single-byte walk on the same rows."""
    jf, tf = _fused_pair(100 + max_len)
    assert tf.pair is not None
    sb, lens, starts = _batch(max_len, 400, max_len, tf.starts, max_len)
    assert lens.max() <= max_len and (lens == -1).any()
    jlo, jhi = jdfa.dfa_match_batch_pair(
        jnp.asarray(jf.pair), *_jax_accept(jf.accept), jnp.asarray(starts),
        jnp.asarray(sb), jnp.asarray(lens), max_len)
    lo, hi = tdfa.accept_words(tf.accept)
    args = (_t(lo), _t(hi), _t(starts), _t(sb), _t(lens), max_len)
    tlo, thi = tdfa.dfa_match_batch_pair(_t(tf.pair), *args)
    np.testing.assert_array_equal(_u32(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_u32(thi), np.asarray(jhi))
    slo, shi = tdfa.dfa_match_batch_fused(_t(tf.trans), *args)
    assert torch.equal(slo, tlo) and torch.equal(shi, thi)


def test_pair_walk_reference_fault_past_odd_max_len():
    """The divergence in ROADMAP queue C. With the automaton of
    ["ab", "abb", "a"], the bytes "abb" and max_len 3: at length 3
    both walks give mask 2 ("abb"); at length 4 the JAX pair walk
    reads bytes[:, 3] (clamped to the last byte) and steps "b" twice
    (mask 0), while its single-byte walk gives 2. The port's pair walk
    reads no byte at or past max_len, so it gives 2, like both
    single-byte walks."""
    jd, td = jrc.compile_patterns(["ab", "abb", "a"]), trc.compile_patterns(["ab", "abb", "a"])
    jf, tf = jdfa.fuse_dfas([jd]), tdfa.fuse_dfas([td])
    sb = np.frombuffer(b"abbabb", np.uint8).reshape(2, 3).copy()
    lens = np.array([3, 4], np.int32)
    starts = np.repeat(tf.starts, 2)
    jargs = (*_jax_accept(jf.accept), jnp.asarray(starts), jnp.asarray(sb), jnp.asarray(lens), 3)
    j_pair = np.asarray(jdfa.dfa_match_batch_pair(jnp.asarray(jf.pair), *jargs)[0])
    j_single = np.asarray(jdfa.dfa_match_batch_fused(jnp.asarray(jf.trans), *jargs)[0])
    assert j_pair.tolist() == [2, 0]  # the reference fault
    assert j_single.tolist() == [2, 2]
    lo, hi = tdfa.accept_words(tf.accept)
    targs = (_t(lo), _t(hi), _t(starts), _t(sb), _t(lens), 3)
    assert _u32(tdfa.dfa_match_batch_pair(_t(tf.pair), *targs)[0]).tolist() == [2, 2]
    assert _u32(tdfa.dfa_match_batch_fused(_t(tf.trans), *targs)[0]).tolist() == [2, 2]


def test_length_is_authoritative_over_nul_bytes():
    """A string ending in NUL walks its full length: "a\\x00" is not
    "a", and "a." accepts it, in both packages."""
    pats = ["a", "a."]
    strs = [b"a", b"a\x00", b"a\x00\x00", b"\x00"]
    jd, td = jrc.compile_patterns(pats), trc.compile_patterns(pats)
    want = jdfa.match_patterns(jd, strs, 16)
    got = tdfa.match_patterns(td, strs, 16, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [1, 2, 0, 0]


def test_empty_batch_on_every_walk():
    jf, tf = _fused_pair(7)
    lo, hi = tdfa.accept_words(tf.accept)
    empty = (_t(np.zeros(0, np.int32)), _t(np.zeros((0, 16), np.uint8)), _t(np.zeros(0, np.int32)), 16)
    for fn, tab in ((tdfa.dfa_match_batch_fused, tf.trans), (tdfa.dfa_match_batch_pair, tf.pair)):
        out = fn(_t(tab), _t(lo), _t(hi), *empty)
        assert [o.shape for o in out] == [(0,), (0,)]
    out = tdfa.dfa_match_batch(_t(tf.trans), _t(lo), _t(hi), torch.tensor(0, dtype=torch.int32),
                               _t(np.zeros((0, 16), np.int32)), _t(np.zeros(0, np.int32)), 16)
    assert [o.shape for o in out] == [(0,), (0,)]
    assert tdfa.match_patterns(trc.compile_patterns(["a"]), [], 16, device="cpu").shape == (0,)


def test_out_of_range_reads_nothing():
    """The port's own semantics where the JAX walks gather out of
    range (no JAX table reaches it): a byte outside [0, 255] or a
    start outside [0, Q) gives mask 0."""
    d = trc.compile_patterns(["a*"])
    f = tdfa.fuse_dfas([d])
    lo, hi = tdfa.accept_words(f.accept)
    sb = torch.tensor([[97, 97], [97, 300], [-1, 97], [97, 97]], dtype=torch.int32)
    lens = torch.tensor([2, 2, 2, 2], dtype=torch.int32)
    starts = torch.tensor([f.starts[0], f.starts[0], f.starts[0], f.n_states], dtype=torch.int32)
    for fn, tab in ((tdfa.dfa_match_batch_fused, f.trans), (tdfa.dfa_match_batch_pair, f.pair)):
        got = fn(_t(tab), _t(lo), _t(hi), starts, sb, lens, 2)[0]
        assert got.tolist() == [1, 0, 0, 0]


def test_wrappers_refuse_malformed_inputs():
    f = tdfa.fuse_dfas([trc.compile_patterns(["a"])])
    lo, hi = tdfa.accept_words(f.accept)
    sb = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):  # max_len past the batch width
        tdfa.dfa_match_batch_fused(_t(f.trans), _t(lo), _t(hi), starts, sb, lens, 16)
    with pytest.raises(ValueError):  # a single-step table given to the pair walk
        tdfa.dfa_match_batch_pair(_t(f.trans), _t(lo), _t(hi), starts, sb, lens, 8)
    with pytest.raises(ValueError):  # per-row starts given as the scalar start
        tdfa.dfa_match_batch(_t(f.trans), _t(lo), _t(hi), starts, sb, lens, 8)


# ---------------------------------------------------------------------------
# residence and conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(2))
def test_dfa_table_from_numpy_round_trips_a_jax_table(seed):
    """A JAX DeviceDFATable's arrays (np.asarray of its device arrays)
    become the same port table as one built from the port's own
    FusedDFA, and walk to the same masks."""
    jf, tf = _fused_pair(200 + seed)
    jt = jdfa.DeviceDFATable(("rt", seed), jf)
    accept = (np.asarray(jt.accept_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        jt.accept_lo).astype(np.uint64)
    got = dfa_table_from_numpy(np.asarray(jt.trans), accept, jt.starts_host,
                               np.asarray(jt.pair), "cpu")
    want = tdfa.DeviceDFATable(("rt", seed), tf, "cpu")
    for name in ("trans", "accept_lo", "accept_hi", "pair"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.n_states, got.n_fields, got.q_pad, got.has_pair, got.device_bytes) == (
        jt.n_states, jt.n_fields, jt.q_pad, jt.has_pair, jt.device_bytes)
    np.testing.assert_array_equal(got.starts_host, jt.starts_host)
    single = trc.compile_patterns(["/api/.*", "/x"])
    t1 = dfa_table_from_numpy(single.trans, single.accept, single.start, None, "cpu")
    assert t1.n_fields == 1 and t1.starts_host.tolist() == [single.start] and not t1.has_pair


def test_interning_metrics_match_jax():
    """Same pattern-set key → one shared table; a bounded LRU past the
    cap; the intern metrics move as the JAX package's do; the device is
    part of the key."""
    def series():
        return (
            {k: jmetrics.l7_dfa_intern_total.get({"result": k}) for k in ("hit", "miss", "evict")},
            {k: tmetrics.l7_dfa_intern_total.get({"result": k}) for k in ("hit", "miss", "evict")},
        )

    (j0, t0) = series()
    for i in list(range(tdfa.DFA_INTERN_CAP + 3)) + [tdfa.DFA_INTERN_CAP + 1]:
        jd = jrc.compile_patterns([f"/p{i}"])
        td = trc.compile_patterns([f"/p{i}"])
        jdfa.intern_fused_table(("t", i), lambda d=jd: jdfa.fuse_dfas([d]))
        tdfa.intern_fused_table(("t", i), lambda d=td: tdfa.fuse_dfas([d]), device="cpu")
    j1, t1 = series()
    assert {k: j1[k] - j0[k] for k in j0} == {k: t1[k] - t0[k] for k in t0}
    assert tdfa.dfa_intern_stats() == jdfa.dfa_intern_stats() == (tdfa.DFA_INTERN_CAP,) * 2
    assert tmetrics.l7_dfa_tables_interned.get() == jmetrics.l7_dfa_tables_interned.get()
    dev_bytes = {"family": "dfa", "placement": "replicated"}
    assert tmetrics.device_table_bytes.get(dev_bytes) == jmetrics.device_table_bytes.get(dev_bytes)
    a = tdfa.intern_fused_table(("k",), lambda: tdfa.fuse_dfas([trc.compile_patterns(["x"])]),
                                device="cpu")
    assert tdfa.intern_fused_table(("k",), lambda: 1 / 0, device=torch.device("cpu")) is a
    assert all(k[0] == "cpu" for k in tdfa._interned)


@pytest.mark.parametrize("max_len", [16, 128])
def test_match_patterns_matches_jax(max_len):
    rng = random.Random(max_len + 9)
    pats = _patterns(rng, 12)
    strs = _strings(rng, 120, max_len + 4)
    want = jdfa.match_patterns(jrc.compile_patterns(pats), strs, max_len)
    got = tdfa.match_patterns(trc.compile_patterns(pats), strs, max_len, device="cpu")
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("walk", ["single", "fused", "pair"])
def test_high_accept_word(walk):
    """48 patterns: accept bits 32..47 travel in the high word, as an
    int32 bit view, on every walk."""
    pats = [f"/p{i}/[a-z]*" for i in range(48)]
    strs = [f"/p{i % 50}/ab".encode() for i in range(120)]
    jd, td = jrc.compile_patterns(pats), trc.compile_patterns(pats)
    if walk == "single":
        want = jdfa.match_patterns(jd, strs, 16)
        got = tdfa.match_patterns(td, strs, 16, device="cpu")
    else:
        jf, tf = jdfa.fuse_dfas([jd]), tdfa.fuse_dfas([td], pair_cap_elems=1 << 30)
        sb, lens = jdfa.strings_to_batch_u8(strs, 16)
        starts = np.repeat(tf.starts, len(strs))
        jfn = jdfa.dfa_match_batch_fused if walk == "fused" else jdfa.dfa_match_batch_pair
        jtab = jf.trans if walk == "fused" else tdfa._pair_table(jf.trans)
        jlo, jhi = jfn(jnp.asarray(jtab), *_jax_accept(jf.accept), jnp.asarray(starts),
                       jnp.asarray(sb), jnp.asarray(lens), 16)
        want = np.asarray(jlo).astype(np.uint64) | (np.asarray(jhi).astype(np.uint64) << np.uint64(32))
        tfn = tdfa.dfa_match_batch_fused if walk == "fused" else tdfa.dfa_match_batch_pair
        lo, hi = tdfa.accept_words(tf.accept)
        got = tdfa.masks_u64(*tfn(_t(tf.trans if walk == "fused" else tf.pair), _t(lo), _t(hi),
                                  _t(starts), _t(sb), _t(lens), 16))
    np.testing.assert_array_equal(got, want)
    assert (got >> np.uint64(32)).any() and (got == 0).any()
