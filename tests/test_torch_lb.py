"""Port parity: the LB stage (lb/device.py, lb/service.py, lb_only.py).

The port's ``lb_translate`` on the CPU runs its plain version, the
dense [B, F] compare that stands beside the ``lb_translate`` kernel;
it is held bit for bit against the JAX step on random tables from
numpy seeds: ANY-protocol frontends that overlap specific ones,
frontends with no backend, selection sequences that point past the
backend table or below it (JAX's gathers count a negative index from
the end, then clamp), sequence lengths past the sequence width, and
flow hashes of either sign (JAX's floor modulo). The host halves
(``flow_hash32``, ``build_selection_seq``, ``build_device``) and the
LB-only datapath follow.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath.conntrack import FlowConntrack as JaxCT
from cilium_tpu.datapath.lb_only import LBOnlyDatapath as JaxLBOnly
from cilium_tpu.lb import device as jdev
from cilium_tpu.lb import service as jsvc
from cilium_tpu_torch.convert import lb_tables_from_numpy
from cilium_tpu_torch.datapath.conntrack import FlowConntrack as TorchCT
from cilium_tpu_torch.datapath.lb_only import LBOnlyDatapath as TorchLBOnly
from cilium_tpu_torch.lb import device as tdev
from cilium_tpu_torch.lb import service as tsvc

FIELDS = ("fe_bytes", "fe_port", "fe_proto", "fe_seq", "fe_seq_len", "fe_revnat",
          "be_bytes", "be_port")


def random_tables(rs, f: int, length: int, nb: int):
    """Frontends over a small pool of addresses and ports, so that
    several share a VIP and port (an ANY frontend beside a specific
    one); about 1/8 have no backend; the sequences hold rows past the
    backend table and negative rows."""
    pool = rs.integers(0, 256, (max(2, f // 3), length))
    fe_bytes = pool[rs.integers(0, pool.shape[0], f)]
    fe_port = rs.choice(np.array([53, 80, 443, 8080]), f)
    fe_proto = rs.choice(np.array([0, 6, 17]), f)
    fe_seq_len = rs.integers(1, jdev.MAX_SEQ + 1, f)
    fe_seq_len[rs.random(f) < 0.125] = 0
    fe_seq_len[rs.random(f) < 0.05] = jdev.MAX_SEQ + rs.integers(1, 50)
    if f > 1:
        fe_seq_len[0] = 0  # the lowest index: never shadowed by another match
        # and one frontend of its own address with backends
        fe_bytes[-1] = rs.integers(0, 256, length)
        fe_seq_len[-1] = 3
    fe_seq = rs.integers(0, nb, (f, jdev.MAX_SEQ))
    wild = rs.random((f, jdev.MAX_SEQ)) < 0.1
    fe_seq[wild] = rs.integers(-2 * nb - 3, 2 * nb + 3, int(wild.sum()))
    return [np.asarray(a, np.int32) for a in (
        fe_bytes, fe_port, fe_proto, fe_seq, fe_seq_len, rs.integers(1, 65536, f),
        rs.integers(0, 256, (nb, length)), rs.integers(1, 65536, nb),
    )]


def random_flows(rs, tables, b: int):
    """Half the flows aim at a frontend's address and port (with its
    protocol, another one or the ANY frontend's); fhash of either sign."""
    fe_bytes, fe_port, fe_proto = tables[:3]
    f, length = fe_bytes.shape
    pick = rs.integers(0, f, b)
    aim = rs.random(b) < 0.5
    peer = np.where(aim[:, None], fe_bytes[pick], rs.integers(0, 256, (b, length)))
    dport = np.where(aim, fe_port[pick], rs.choice(np.array([53, 80, 443, 22]), b))
    proto = np.where(rs.random(b) < 0.7, fe_proto[pick], rs.choice(np.array([6, 17]), b))
    proto = np.where(proto == 0, 6, proto)
    fhash = rs.integers(-(2 ** 31), 2 ** 31, b)
    return [np.asarray(a, np.int32) for a in (peer, dport, proto, fhash)]


def _jax_translate(tables, flows):
    jt = jdev.LBTables(**{k: jnp.asarray(v) for k, v in zip(FIELDS, tables)})
    return [np.asarray(x) for x in jdev.lb_translate(jt, *(jnp.asarray(a) for a in flows))]


def _torch_translate(tables, flows):
    tt = lb_tables_from_numpy(*tables, device="cpu")
    return [x.numpy() for x in tdev.lb_translate(tt, *(torch.from_numpy(a) for a in flows))]


@pytest.mark.parametrize("length", [4, 16])
@pytest.mark.parametrize("f,nb,seed", [(1, 1, 0), (2, 3, 1), (37, 20, 2), (256, 128, 3),
                                       (300, 700, 4)])
def test_lb_translate_matches_jax(f, nb, seed, length):
    rs = np.random.default_rng(seed * 31 + length)
    tables = random_tables(rs, f, length, nb)
    flows = random_flows(rs, tables, 2000)
    want = _jax_translate(tables, flows)
    got = _torch_translate(tables, flows)
    for name, g, w in zip(("new_bytes", "new_port", "revnat", "ok", "no_backend"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    ok, nobk = want[3], want[4]
    assert ok.any() and (~(ok | nobk)).any() and (nobk.any() or f == 1)
    # no-backend hits still carry their frontend's revNAT id
    assert (want[2][nobk] != 0).all()


def test_lb_translate_first_match_and_edges():
    """An ANY frontend before a TCP one on the same VIP and port wins
    for TCP (the lowest index, as jnp.argmax of the match row); a row
    past the backend table clamps to the last backend, a negative one
    counts from the end; a negative hash takes the floor modulo."""
    tables = [np.asarray(a, np.int32) for a in (
        [[10, 96, 0, 1], [10, 96, 0, 1], [10, 96, 0, 2]],  # fe_bytes
        [80, 80, 443], [0, 6, 17],  # port, proto (0 = ANY)
        np.pad([[5, -1, 1], [0, 0, 0], [0, 1, 2]], ((0, 0), (0, jdev.MAX_SEQ - 3))),
        [3, 1, 0], [7, 8, 9],  # seq_len, revnat
        [[1, 1, 1, 1], [2, 2, 2, 2], [3, 3, 3, 3]], [100, 200, 300],
    )]
    flows = [np.asarray(a, np.int32) for a in (
        [[10, 96, 0, 1]] * 4 + [[10, 96, 0, 2], [10, 96, 0, 9]],
        [80, 80, 80, 80, 443, 80], [6, 6, 17, 6, 17, 6], [0, 1, -2, -1, 5, 0],
    )]
    want = _jax_translate(tables, flows)
    got = _torch_translate(tables, flows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    new_bytes, new_port, revnat, ok, nobk = got
    # fhash 0 → seq[0] = 5 → clamped to row 2; 1 → -1 → row 2 (from the
    # end); -2 floor-mod 3 = 1 → -1 → row 2; -1 mod 3 = 2 → row 1
    assert new_port.tolist() == [300, 300, 300, 200, 443, 80]
    assert revnat.tolist() == [7, 7, 7, 7, 9, 0]
    assert ok.tolist() == [True, True, True, True, False, False]
    assert nobk.tolist() == [False, False, False, False, True, False]


@pytest.mark.parametrize("with_sports", [False, True])
@pytest.mark.parametrize("length", [4, 16])
def test_flow_hash32_matches_jax(length, with_sports):
    rs = np.random.default_rng(length + with_sports)
    b = 5000
    args = (rs.integers(0, 256, (b, length)).astype(np.int32),
            rs.integers(1024, 65536, b) if with_sports else None,
            rs.integers(0, 65536, b).astype(np.int32), rs.choice([6, 17], b).astype(np.int32),
            rs.integers(0, 1 << 20, b))
    np.testing.assert_array_equal(tdev.flow_hash32(*args), jdev.flow_hash32(*args))


@pytest.mark.parametrize("weights", [
    [], [1], [1, 3], [0, 0, 2], [0, 0], [1000, 1, 7, 300], [1] * 70, list(range(1, 40)),
])
def test_build_selection_seq_matches_jax(weights):
    backs = [(f"10.0.{i // 250}.{i % 250 + 1}", 80, w) for i, w in enumerate(weights)]
    got = tsvc.build_selection_seq([tsvc.Backend(*b) for b in backs])
    want = jsvc.build_selection_seq([jsvc.Backend(*b) for b in backs])
    assert got == want
    assert len(got) <= tdev.MAX_SEQ


def _fill_manager(mod, seed: int, families=(4, 6)):
    """The same services through ``mod``: ClusterIP frontends of both
    families, weighted backends, a frontend with no backend, an ANY
    frontend beside a TCP one on one VIP and port, and remote backends."""
    rs = np.random.default_rng(seed)
    m = mod.ServiceManager()
    for i in range(24):
        fam = families[i % len(families)]
        vip = f"10.96.0.{i + 1}" if fam == 4 else f"fd00:96::{i + 1:x}"
        n = 0 if i % 7 == 3 else int(rs.integers(1, 6))
        backs = [
            mod.Backend(f"10.1.{i}.{k + 1}" if fam == 4 else f"fd00::{i:x}:{k + 1:x}",
                        int(rs.choice([80, 8080, 5432])),
                        int(rs.integers(1, 5)) if i % 4 == 0 else 1)
            for k in range(n)
        ]
        proto = "UDP" if i % 5 == 0 else "TCP"
        m.upsert(mod.L3n4Addr(vip, int(rs.choice([80, 443, 53])), proto), backs)
        if i % 6 == 1:
            m.upsert(mod.L3n4Addr(vip, 80, "ANY"), backs[:1])
    fe = m.list()[0].frontend
    m.set_remote_backends(fe, "c2", [mod.Backend("10.2.0.1" if fe.family == 4 else "fd00::2:1", 80)])
    return m


@pytest.mark.parametrize("families", [(4, 6), (4,), (6,)])
def test_build_device_matches_jax(families):
    want = _fill_manager(jsvc, 5, families).build_device()
    got = _fill_manager(tsvc, 5, families).build_device(device="cpu")
    assert set(got) == set(want) == {4, 6}
    for fam in (4, 6):
        if want[fam] is None:
            assert got[fam] is None and fam not in families
            continue
        for name in FIELDS:
            g = getattr(got[fam], name)
            assert g.dtype == torch.int32 and g.device.type == "cpu", name
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want[fam], name)),
                                          err_msg=f"v{fam} {name}")


def _lb_only(mod_svc, ct_cls, lb_only_cls, **kw):
    m = mod_svc.ServiceManager()
    m.upsert(mod_svc.L3n4Addr("10.96.0.10", 80, "TCP"),
             [mod_svc.Backend("10.0.0.3", 8080), mod_svc.Backend("10.0.0.4", 8080, weight=3)])
    m.upsert(mod_svc.L3n4Addr("10.96.0.11", 53, "UDP"), [])
    m.upsert(mod_svc.L3n4Addr("10.96.0.12", 443, "ANY"), [mod_svc.Backend("10.0.0.5", 8443)])
    return m, lb_only_cls(m, ct_cls(capacity_bits=12), **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_lb_only_matches_jax(seed):
    """LBOnlyDatapath.process / rev_nat, each package with its own
    FlowConntrack: translations, verdicts, revNAT ids, the live CT
    keys, and the reply-direction VIP restore; then backend churn."""
    (mj, dj), (mt, dt) = (_lb_only(jsvc, JaxCT, JaxLBOnly),
                          _lb_only(tsvc, TorchCT, TorchLBOnly, device="cpu"))
    rs = np.random.default_rng(seed)
    b = 3000
    vips = np.array([0x0A60000A, 0x0A60000B, 0x0A60000C, 0x0A000003, 0x08080808], np.uint32)
    pick = rs.integers(0, len(vips), b)
    dst = vips[pick]
    dports = np.array([80, 53, 443, 8080, 80], np.int32)[pick]
    protos = np.where(pick == 1, 17, 6).astype(np.int32)
    sports = rs.integers(1024, 60000, b)
    for _ in range(2):
        got = dt.process(dst, dports, protos, sports)
        want = dj.process(dst, dports, protos, sports)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        snap_t, snap_j = dt.conntrack.snapshot_arrays(), dj.conntrack.snapshot_arrays()
        for k in ("ka", "kb", "kc", "revnat", "packets"):
            np.testing.assert_array_equal(np.sort(snap_t[k]), np.sort(snap_j[k]), err_msg=k)
    new_dst, new_port, verdict, revnat = got
    assert (verdict == 4).sum() == (pick == 1).sum() and revnat.any()
    # replies from the backends, ports flipped
    rargs = (new_dst, new_port.astype(np.int64), sports, protos)
    for g, w in zip(dt.rev_nat(*rargs), dj.rev_nat(*rargs)):
        np.testing.assert_array_equal(g, w)
    restored = dt.rev_nat(*rargs)[0]
    assert (restored[pick == 0] == 0x0A60000A).all()
    # backend churn: the tables rebuild and both conntracks flush
    for m, mod in ((mj, jsvc), (mt, tsvc)):
        m.upsert(mod.L3n4Addr("10.96.0.10", 80, "TCP"), [mod.Backend("10.0.0.9", 9090)])
    got = dt.process(dst, dports, protos, sports)
    want = dj.process(dst, dports, protos, sports)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(dt.conntrack) == len(dj.conntrack) > 0
