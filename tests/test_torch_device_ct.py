"""Port parity: device-resident conntrack (datapath/device_ct.py).

The same numpy inputs go through the JAX package's functions and the
port's plain versions (the ``ct_step`` kernel's CPU path). Every output
is an integer or a bool, so equality is exact.

The reference writes slot C-1 for every lane that neither refreshes
nor inserts (ROADMAP queue C): its ``-1`` scatter targets are not
dropped. The port writes nothing for those lanes. So ``ct_step_plain``
is held to JAX ``ct_step`` one step at a time from a state in which
slot C-1 is already live: there the fault cannot make C-1 look taken
to an insert, and the two must agree on every lane and at every slot
but C-1. On a fresh table the port's own behaviour is checked instead,
beside what JAX does there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import device_ct as jct
from cilium_tpu_torch.convert import device_ct_state_from_numpy
from cilium_tpu_torch.datapath import device_ct as tct

FIELDS = ("ka_hi", "ka_lo", "kb_hi", "kb_lo", "kc_hi", "kc_lo", "exp")
NOW = 5000


def u32(a: np.ndarray) -> np.ndarray:
    return np.asarray(a).astype(np.int64).astype(np.uint32)


def t32(a: np.ndarray) -> torch.Tensor:
    """uint32 (or int32) words → the port's int32 bit-view tensor."""
    return torch.from_numpy(np.ascontiguousarray(u32(a)).view(np.int32))


def words_of(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def random_words(rs, n):
    """[n] uint32 words, a third of them ≥ 2**31."""
    w = rs.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w[rs.random(n) < 0.33] |= np.uint32(1 << 31)
    return w


def kc_fields(rs, n, n_eps=1 << 23):
    ep = rs.integers(0, n_eps, n).astype(np.int32)
    sp = rs.integers(0, 65536, n).astype(np.int32)
    dp = rs.integers(0, 65536, n).astype(np.int32)
    pr = rs.choice(np.array([6, 17, 1], np.int32), n)
    dr = rs.integers(0, 2, n).astype(np.int32)
    return ep, sp, dp, pr, dr


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["mix32", "hash_tuple", "pack_kc_words", "flip_kc_words"])
def test_hash_and_kc_helpers_match_jax(fn, seed):
    rs = np.random.default_rng(seed)
    n = 4096
    if fn == "mix32":
        w = random_words(rs, n)
        want = np.asarray(jct._mix32(jnp.asarray(w)))
        np.testing.assert_array_equal(words_of(tct._mix32(t32(w))), want)
        np.testing.assert_array_equal(jct._mix32_np(w), want)
    elif fn == "hash_tuple":
        ws = [random_words(rs, n) for _ in range(6)]
        want = np.asarray(jct._hash_tuple(*(jnp.asarray(w) for w in ws)))
        np.testing.assert_array_equal(words_of(tct._hash_tuple(*(t32(w) for w in ws))), want)
        np.testing.assert_array_equal(tct._hash_tuple_np(*ws), want)
    elif fn == "pack_kc_words":
        fields = kc_fields(rs, n)
        want = jct.pack_kc_words(*(jnp.asarray(x) for x in fields))
        got = tct.pack_kc_words(*(torch.from_numpy(x) for x in fields))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(words_of(g), np.asarray(w))
        # one direction for the whole batch, as process_flows_ct passes it
        got = tct.pack_kc_words(*(torch.from_numpy(x) for x in fields[:4]), 1)
        want = jct.pack_kc_words(*(jnp.asarray(x) for x in fields[:4]), jnp.int32(1))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(words_of(g), np.asarray(w))
    else:
        hi, lo = random_words(rs, n), random_words(rs, n)
        want = jct._flip_kc_words(jnp.asarray(hi), jnp.asarray(lo))
        got = tct._flip_kc_words(t32(hi), t32(lo))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(words_of(g), np.asarray(w))


# -- one ct_step from a shared state ---------------------------------------


def flow_pool(rs, n):
    """n random flows → (ka_hi, ka_lo, kb_hi, kb_lo) uint32 words, the
    kc fields and the proto; TCP and UDP, peers with high bits set."""
    peers = [random_words(rs, n) for _ in range(4)]
    ep, sp, dp, pr, dr = kc_fields(rs, n, n_eps=64)
    pr = rs.choice(np.array([6, 17], np.int32), n)
    return peers, (ep, sp, dp, pr, dr)


def kc_np(fields):
    hi, lo = jct.pack_kc_words(*(jnp.asarray(x) for x in fields))
    return np.asarray(hi), np.asarray(lo)


def build_state(rs, bits, peers, kc, flip_kc):
    """A table holding some of the pool's forward keys, some flipped
    (reply) keys and some random keys, live and expired, with slot C-1
    live."""
    c = 1 << bits
    t = {f: np.zeros(c, np.uint32) for f in FIELDS[:6]}
    exp = np.zeros(c, np.int32)
    n = peers[0].shape[0]
    for i in rs.choice(n, n // 2, replace=False):
        s = int(rs.integers(0, c))
        use_flip = rs.random() < 0.4
        k_hi, k_lo = (flip_kc if use_flip else kc)
        for f, w in zip(FIELDS[:4], peers):
            t[f][s] = w[i]
        t["kc_hi"][s], t["kc_lo"][s] = k_hi[i], k_lo[i]
        exp[s] = NOW + int(rs.integers(1, 100)) if rs.random() < 0.7 else NOW - int(rs.integers(0, 50))
    # also place keys at their own probe slots, so hits really occur
    h = jct._hash_tuple_np(*peers, *kc)
    for i in rs.choice(n, n // 3, replace=False):
        s = (int(h[i]) + int(rs.integers(0, 8))) & (c - 1)
        for f, w in zip(FIELDS[:4], peers):
            t[f][s] = w[i]
        t["kc_hi"][s], t["kc_lo"][s] = kc[0][i], kc[1][i]
        exp[s] = NOW + 7 if rs.random() < 0.75 else NOW  # exp == now is expired
    hr = jct._hash_tuple_np(*peers, *flip_kc)
    for i in rs.choice(n, n // 4, replace=False):
        s = (int(hr[i]) + int(rs.integers(0, 8))) & (c - 1)
        for f, w in zip(FIELDS[:4], peers):
            t[f][s] = w[i]
        t["kc_hi"][s], t["kc_lo"][s] = flip_kc[0][i], flip_kc[1][i]
        exp[s] = NOW + 3
    exp[c - 1] = NOW + 1000  # slot C-1 live: see the module docstring
    return [t[f] for f in FIELDS[:6]] + [exp]


def first_free(arrays, words, c):
    """[B] first slot of each lane's forward window with exp <= NOW, -1
    when none."""
    h = jct._hash_tuple_np(*words).astype(np.int64)
    win = (h[:, None] + np.arange(8)[None, :]) & (c - 1)
    free = arrays[-1][win] <= NOW
    return np.where(free.any(1), win[np.arange(h.size), free.argmax(1)], -1)


def jax_step(arrays, words, proto, allow):
    # copies: the jitted step donates its state
    st = jct.DeviceCTState(*(jnp.asarray(np.array(a)) for a in arrays))
    w = [jnp.asarray(x) for x in words]
    new, est = jct.ct_step(st, (w[0], w[1]), (w[2], w[3]), (w[4], w[5]), jnp.asarray(proto),
                           jnp.int32(NOW), jnp.asarray(allow))
    return [np.asarray(a) for a in new], np.asarray(est)


def port_step(arrays, words, proto, allow, now=NOW):
    st = device_ct_state_from_numpy(arrays, device="cpu")
    w = [t32(x) for x in words]
    est = tct.ct_step(st, (w[0], w[1]), (w[2], w[3]), (w[4], w[5]), torch.from_numpy(proto),
                      now, torch.from_numpy(allow))
    assert bool((st.owner == -1).all()), "owner scratch not reset"
    return [words_of(getattr(st, f)) for f in FIELDS[:6]] + [st.exp.numpy()], est.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bits", [4, 10])
def test_ct_step_plain_matches_jax_except_slot_c_minus_1(bits, seed):
    """Three steps, each from the port's state of the step before (slot
    C-1 kept live) through both packages: established equal on every
    lane, the table equal at every slot but C-1, which JAX's step
    writes for the lanes it skips (ROADMAP queue C) and the port does
    not. The batches repeat flows (contested slots), hit forward and
    reply tuples, meet expired entries, mix allow_new and TCP / UDP."""
    rs = np.random.default_rng(100 * bits + seed)
    c = 1 << bits
    n = 48 if bits == 4 else 900
    peers, fields = flow_pool(rs, n)
    kc = kc_np(fields)
    f_hi, f_lo = (np.asarray(x) for x in jct._flip_kc_words(*(jnp.asarray(k) for k in kc)))
    arrays = build_state(rs, bits, peers, kc, (f_hi, f_lo))
    seen = dict(est=0, rep=0, contested=0, c1_written=0)
    for _step in range(3):
        idx = rs.integers(0, n, 64 if bits == 4 else 1500)
        words = [w[idx] for w in peers] + [kc[0][idx], kc[1][idx]]
        proto = fields[3][idx]
        allow = rs.random(idx.size) < 0.6
        j_arrays, j_est = jax_step(arrays, words, proto, allow)
        t_arrays, t_est = port_step(arrays, words, proto, allow)
        np.testing.assert_array_equal(t_est, j_est)
        for f, a, b in zip(FIELDS, t_arrays, j_arrays):
            np.testing.assert_array_equal(a[: c - 1], b[: c - 1].view(a.dtype), err_msg=f)
        seen["est"] += int(t_est.sum())
        seen["c1_written"] += any(not np.array_equal(a[c - 1], b[c - 1].view(a.dtype))
                                  for a, b in zip(t_arrays, j_arrays))
        # lanes established only through the reply tuple
        fwd = [np.asarray(x) for x in jct._probe(
            jct.DeviceCTState(*(jnp.asarray(a) for a in arrays)),
            *(jnp.asarray(w) for w in words), jnp.int32(NOW))][0]
        seen["rep"] += int((t_est & ~fwd).sum())
        # slots that inserting lanes of different keys competed for
        ins = first_free(arrays, words, c)
        cand = allow & ~t_est & (ins >= 0)
        keys = np.unique(np.stack([ins[cand], *(w[cand] for w in words)], 1), axis=0)
        seen["contested"] += int((np.unique(keys[:, 0], return_counts=True)[1] > 1).sum())
        arrays = t_arrays
        arrays[-1] = arrays[-1].copy()
        arrays[-1][c - 1] = max(int(arrays[-1][c - 1]), NOW + 1000)
    assert seen["est"] and seen["rep"] and seen["contested"], seen


def test_contested_slot_goes_to_highest_lane():
    """64 allowed TCP flows into 16 slots from a table with only slot
    C-1 live: in every slot that several lanes claimed, JAX's scatter
    kept the highest lane's key, and so does the port, which computes
    that winner explicitly."""
    rs = np.random.default_rng(7)
    c = 16
    peers, fields = flow_pool(rs, 64)
    fields = (*fields[:3], np.full(64, 6, np.int32), fields[4])
    kc = kc_np(fields)
    arrays = [np.zeros(c, np.uint32) for _ in range(6)] + [np.zeros(c, np.int32)]
    arrays[-1][c - 1] = NOW + 1000
    words = [*peers, *kc]
    allow = np.ones(64, bool)
    j_arrays, _ = jax_step(arrays, words, fields[3], allow)
    t_arrays, _ = port_step(arrays, words, fields[3], allow)
    first_free = jct._hash_tuple_np(*words) & np.uint32(c - 1)
    first_free[first_free == c - 1] = 0  # C-1 is live: the window moves on to slot 0
    n_contested = 0
    for s in range(c - 1):
        lanes = np.nonzero(first_free == s)[0]
        if lanes.size < 2:
            continue
        n_contested += 1
        top = lanes.max()
        for k in range(6):
            assert j_arrays[k][s] == words[k][top]
            assert t_arrays[k][s].view(np.uint32) == words[k][top]
    assert n_contested >= 4


def _fresh(bits):
    return tct.make_state(bits, device="cpu")


def _first_slot_flow(c, want_start, n_try=1 << 16):
    """A flow (6 uint32 words) whose probe window starts at slot
    ``want_start`` of a C-slot table."""
    rs = np.random.default_rng(11)
    peers, fields = flow_pool(rs, n_try)
    fields = (*fields[:3], np.full(n_try, 6, np.int32), fields[4])
    kc = kc_np(fields)
    words = [*peers, *kc]
    h = jct._hash_tuple_np(*words)
    i = int(np.nonzero((h & np.uint32(c - 1)) == want_start)[0][0])
    return [w[i:i + 1] for w in words]


def test_port_fresh_table_stores_at_slot_c_minus_1():
    """A flow whose first free slot is C-1 is stored there by the port
    and is established on the next step. JAX's step first writes slot
    C-1's expiry for the lanes it does not refresh, which here is this
    very lane, so C-1 is taken by the time it inserts and the flow
    lands in slot 0 instead (the displacement of ROADMAP queue C)."""
    c = 16
    words = _first_slot_flow(c, c - 1)
    proto = np.array([6], np.int32)
    allow = np.array([True])
    st = _fresh(4)
    w = [t32(x) for x in words]

    def step():
        return tct.ct_step(st, (w[0], w[1]), (w[2], w[3]), (w[4], w[5]),
                           torch.from_numpy(proto), NOW, torch.from_numpy(allow))

    assert not step().item()
    live = np.nonzero(st.exp.numpy() > NOW)[0].tolist()
    assert live == [c - 1]
    for k, f in enumerate(FIELDS[:6]):
        assert words_of(getattr(st, f))[c - 1] == words[k][0]
    assert st.exp[c - 1].item() == NOW + tct.LIFE_TCP_S
    assert step().item()
    # JAX on the same fresh table
    j_arrays, _ = jax_step([np.zeros(c, np.uint32)] * 6 + [np.zeros(c, np.int32)], words,
                           proto, allow)
    assert j_arrays[-1][0] == NOW + tct.LIFE_TCP_S and j_arrays[4][0] == words[4][0]


@pytest.mark.parametrize("seed", [0, 1])
def test_allow_new_false_never_established(seed):
    """The port's side of the slot C-1 fault: flows that are never
    allowed are never established and leave no live slot, however often
    they come back. JAX's step stores the last skipped lane's key in
    slot C-1 with a live expiry; a flow whose window covers C-1 then
    comes back established there (ROADMAP queue C, reproduction 1)."""
    rs = np.random.default_rng(seed)
    c = 16
    peers, fields = flow_pool(rs, 3)
    last = _first_slot_flow(c, c - 3)  # window covers C-1
    words = [np.concatenate([p, q]) for p, q in zip([*peers, *kc_np(fields)], last)]
    proto = np.concatenate([fields[3], [6]]).astype(np.int32)
    allow = np.zeros(4, bool)
    st = _fresh(4)
    w = [t32(x) for x in words]
    for _ in range(4):
        est = tct.ct_step(st, (w[0], w[1]), (w[2], w[3]), (w[4], w[5]),
                          torch.from_numpy(proto), NOW, torch.from_numpy(allow))
        assert not est.any()
        assert not (st.exp > 0).any() and not (st.kc_lo != 0).any()
    j_arrays = [np.zeros(c, np.uint32)] * 6 + [np.zeros(c, np.int32)]
    j_arrays, j_est = jax_step(j_arrays, words, proto, allow)
    assert not j_est.any()
    assert j_arrays[5][c - 1] == words[5][3] and j_arrays[-1][c - 1] == NOW + tct.LIFE_TCP_S
    _, j_est = jax_step(j_arrays, words, proto, allow)
    assert j_est.tolist() == [False, False, False, True]


def host_entries(rs, n):
    ka = rs.integers(0, 1 << 63, n, dtype=np.uint64) | np.uint64(1 << 63)
    kb = rs.integers(0, 1 << 63, n, dtype=np.uint64)
    ep, sp, dp, pr, dr = kc_fields(rs, n, n_eps=64)
    kc = ((ep.astype(np.uint64) << np.uint64(41)) | (sp.astype(np.uint64) << np.uint64(25))
          | (dp.astype(np.uint64) << np.uint64(9)) | (pr.astype(np.uint64) << np.uint64(1))
          | dr.astype(np.uint64))
    ttl = rs.uniform(-5, 100, n)
    return ka, kb, kc, ttl


@pytest.mark.parametrize("bits,n,limit", [(4, 40, 1 << 16), (10, 3000, 1 << 16), (10, 600, 100)])
def test_seed_and_pull_match_jax(bits, n, limit):
    """seed_state_from_host places the same entries at the same slots as
    the JAX package's (a full neighbourhood drops the same ones), and
    pull_live_entries reads the same live entries back."""
    rs = np.random.default_rng(bits * 1000 + n)
    ka, kb, kc, ttl = host_entries(rs, n)
    js = jct.seed_state_from_host(ka, kb, kc, ttl, bits, NOW, limit=limit)
    ts = tct.seed_state_from_host(ka, kb, kc, ttl, bits, NOW, limit=limit, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)).view(np.int32),
                                      err_msg=f)
    assert bool((ts.owner == -1).all())
    for now_s, lim in ((NOW, 1 << 16), (NOW + 40, 1 << 16), (NOW, 7)):
        want = jct.pull_live_entries(js, now_s, limit=lim)
        got = tct.pull_live_entries(ts, now_s, limit=lim)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0 < len(tct.pull_live_entries(ts, NOW)["ka"]) < n


def test_state_carried_across_and_ct_step_wrapper_on_cpu():
    """convert.device_ct_state_from_numpy carries a JAX state over bit
    for bit; on CPU tensors ct_step runs the plain version and launches
    nothing; the plain verdict tail derives allow_new, overrides the
    verdicts of established flows and counts the valid lanes."""
    from cilium_tpu_torch import _kernels

    rs = np.random.default_rng(3)
    ka, kb, kc, ttl = host_entries(rs, 200)
    js = jct.seed_state_from_host(ka, kb, kc, ttl, 10, NOW)
    ts = device_ct_state_from_numpy([np.asarray(a) for a in js], device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)).view(np.int32))
    before = _kernels.launches()
    peers, fields = flow_pool(rs, 500)
    kc_w = tct.pack_kc_words(*(torch.from_numpy(x) for x in fields))
    w = [t32(x) for x in peers]
    proto = torch.from_numpy(fields[3])
    verdict = torch.from_numpy(rs.choice(np.array([1, 2, 3], np.int8), 500))
    redirect = torch.from_numpy(rs.random(500) < 0.2) & (verdict == 1)
    valid = torch.from_numpy(rs.random(500) < 0.9)
    ep = torch.from_numpy(fields[0])
    ref = device_ct_state_from_numpy([np.asarray(a) for a in js], device="cpu")
    for _ in range(2):  # the second pass finds the first pass's inserts
        v, r, counters, est = tct.ct_step_verdict(ts, (w[0], w[1]), (w[2], w[3]), kc_w, proto,
                                                  NOW, verdict, redirect, valid, ep, 64)
        allow = (verdict == 1) & ~redirect & valid
        want_est = tct.ct_step(ref, (w[0], w[1]), (w[2], w[3]), kc_w, proto, NOW, allow)
        assert torch.equal(est, want_est)
        assert torch.equal(v, torch.where(est, 1, verdict).to(torch.int8))
        assert torch.equal(r, redirect & ~est)
        want = np.zeros((64, 3), np.int32)
        np.add.at(want, (fields[0][valid.numpy()], v.numpy()[valid.numpy()] - 1), 1)
        np.testing.assert_array_equal(counters.numpy(), want)
        for f in FIELDS:
            assert torch.equal(getattr(ts, f), getattr(ref, f))
    assert bool(est.any())
    assert _kernels.launches() == before
