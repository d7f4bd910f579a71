"""Port parity: the CT snapshot, the restore hold and the first-batch hook.

``datapath/ct_snapshot.py`` (``save_ct_state`` / ``load_ct_state``) and
the pipeline's ``_ct_restore_hold`` and ``on_first_batch`` against the
JAX package's, on the CPU:

- the JAX package's ``TestCTSnapshot`` runs against the port;
- the same host-CT sequence through both pipelines saves equal
  snapshots: keys, ``packets``, ``revnat``, ``basis``, ``ct_epoch`` and
  ``entries`` bit for bit; ``ttl`` (each entry's remaining lifetime at
  the save, from the monotonic clock) within 1 s. The clock is pinned
  and stepped the same way for both packages, so the comparison does
  not rest on how long each package's passes took;
- the restore hold at pipeline level, the ``test_survive.py`` restart
  cases that need no daemon (the daemon's CT restore step is the helper
  ``restore_ct`` below): entries kept across the held rebuild, the hold
  voided by a rule added before it, a basis mismatch restoring cold, a
  torn write loading as None; and each flush trigger on its own (the
  basis move, the LB move), the hold spent after one rebuild, the
  device CT kept by a held rebuild and reset by an unheld one. Each
  case runs through both packages with equal outcomes;
- ``on_first_batch`` fires once, on the first completed batch, and its
  exception does not fail the batch.
"""

from __future__ import annotations

import importlib
import json
import os
import time

import numpy as np
import pytest

from cilium_tpu import faults as jfaults
from cilium_tpu_torch import faults as tfaults
from cilium_tpu_torch.datapath.conntrack import CT_ESTABLISHED, FlowConntrack, pack_keys
from cilium_tpu_torch.datapath.ct_snapshot import load_ct_state, save_ct_state
from test_torch_harness import PKGS, random_flows
from test_torch_pipeline_ct import N_EPS, Stack, _pack, ct_keys, egress_flows

B = 1200
TTL_TOLERANCE_S = 1.0


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _dev(pkg: str) -> dict:
    return {} if pkg == "cilium_tpu" else {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean_hubs():
    for hub in (jfaults.hub, tfaults.hub):
        hub.reset()
    yield
    for hub in (jfaults.hub, tfaults.hub):
        hub.reset()


# -- the JAX package's TestCTSnapshot, run against the port ----------------
class TestCTSnapshot:
    def _table(self, n=64):
        rng = np.random.default_rng(11)
        ct = FlowConntrack(capacity_bits=10)
        ka, kb, kc = pack_keys(
            np.zeros(n, np.uint64),
            rng.integers(1, 1 << 32, n, dtype=np.uint64),
            (np.arange(n) % 4).astype(np.uint64),
            (1000 + np.arange(n)).astype(np.uint64),
            np.full(n, 80, np.uint64),
            np.full(n, 6, np.uint64),
            np.zeros(n, np.uint64),
        )
        assert ct.create_batch(ka, kb, kc, revnat=np.arange(n).astype(np.uint16)) == n
        return ct, (ka, kb, kc)

    def test_roundtrip_entries_basis_revnat(self, tmp_path):
        ct, keys = self._table()
        p = str(tmp_path / "ct.npz")
        nbytes = save_ct_state(p, ct, basis=(3, 4, 5), ct_epoch=7)
        assert nbytes == os.path.getsize(p)
        snap = load_ct_state(p)
        assert snap is not None
        assert snap["basis"] == (3, 4, 5)
        assert snap["ct_epoch"] == 7
        assert snap["entries"] == 64
        ct2 = FlowConntrack(capacity_bits=10)
        kept, expired = ct2.restore_arrays(snap["ka"], snap["kb"], snap["kc"], snap["ttl"],
                                           packets=snap["packets"], revnat=snap["revnat"])
        assert (kept, expired) == (64, 0)
        state, _, rev = ct2.lookup_batch(*keys, want_revnat=True)
        assert (state == CT_ESTABLISHED).all()
        np.testing.assert_array_equal(rev, np.arange(64).astype(np.uint16))

    def test_restore_sweeps_expired_and_clamps_ttl(self, tmp_path):
        ct, _ = self._table()
        p = str(tmp_path / "ct.npz")
        save_ct_state(p, ct, basis=(1, 1, 1), ct_epoch=0)
        snap = load_ct_state(p)
        # downtime: the first 10 lifetimes ran out while the process was
        # dead; one is absurd (a corrupt snapshot's shape)
        ttl = snap["ttl"].copy()
        ttl[:10] = -1.0
        ttl[10] = 1e9
        ct2 = FlowConntrack(capacity_bits=10)
        kept, expired = ct2.restore_arrays(snap["ka"], snap["kb"], snap["kc"], ttl,
                                           packets=snap["packets"], revnat=snap["revnat"])
        assert (kept, expired) == (54, 10)
        # the clamp: no restored entry outlives the configured lifetimes
        horizon = time.monotonic() + max(ct2.tcp_lifetime, ct2.other_lifetime)
        assert float(ct2.expires[ct2.valid].max()) <= horizon + 1.0

    def test_torn_write_fault_leaves_tolerated_file(self, tmp_path):
        """SITE_STATE_WRITE models a power loss that kept the rename and
        lost the data: the save leaves a truncated file at the final
        path and raises the fault; the loader reads it as None."""
        ct, _ = self._table()
        p = str(tmp_path / "ct.npz")
        good = save_ct_state(p, ct, basis=(1, 1, 1), ct_epoch=0)
        tfaults.hub.fail(tfaults.SITE_STATE_WRITE, tfaults.KIND_TRANSIENT, times=1)
        with pytest.raises(tfaults.FaultError):
            save_ct_state(p, ct, basis=(1, 1, 1), ct_epoch=0)
        assert os.path.getsize(p) < good  # the torn half
        assert load_ct_state(p) is None
        save_ct_state(p, ct, basis=(1, 1, 1), ct_epoch=0)  # the next clean save heals it
        assert load_ct_state(p) is not None

    def test_loader_tolerates_absent_garbage_and_foreign_schema(self, tmp_path):
        assert load_ct_state(str(tmp_path / "absent.npz")) is None
        bad = tmp_path / "bad.npz"
        bad.write_bytes(b"not an npz at all")
        assert load_ct_state(str(bad)) is None
        foreign = str(tmp_path / "foreign.npz")
        np.savez(foreign, meta=np.frombuffer(json.dumps({"schema": 99}).encode(), np.uint8).copy())
        assert load_ct_state(foreign) is None


# -- CT snapshots of the same sequence, one per package -------------------
def _sorted(snap):
    order = np.lexsort((snap["kc"], snap["kb"], snap["ka"]))
    return {k: snap[k][order] for k in ("ka", "kb", "kc", "ttl", "packets", "revnat")}


@pytest.mark.parametrize("fam", [4, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_ct_snapshots_equal_across_packages(tmp_path, monkeypatch, seed, fam):
    """Pass 1 and pass 2 of the same egress batch (new flows through the
    LB stage, then the bypass that counts packets) and an ingress batch
    through each package, its CT saved after its own passes. The
    monotonic clock reads 1000 s during pass 1 and one second more at
    each later step, in both packages."""
    clock = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    st = Stack(seed)
    peer, ep, dp, pr, sp = egress_flows(st, fam, B, seed * 5 + fam)
    call = "process" if fam == 4 else "process_v6"
    arg = _pack(peer) if fam == 4 else peer
    snaps = {}
    for pkg, pipe in st.pipes.items():
        for k in range(2):
            clock[0] = 1000.0 + k
            getattr(pipe, call)(arg, ep, dp, pr, ingress=False, sports=sp)
        clock[0] = 1002.0
        getattr(pipe, call)(arg, ep, dp, pr, ingress=True, sports=sp)
        clock[0] = 1003.0
        path = str(tmp_path / f"{pkg}.npz")
        nbytes = _mod(pkg, "datapath.ct_snapshot").save_ct_state(
            path, pipe.conntrack, basis=pipe._mat_basis, ct_epoch=pipe._ct_epoch)
        assert nbytes == os.path.getsize(path)
        snaps[pkg] = _mod(pkg, "datapath.ct_snapshot").load_ct_state(path)
    j, t = snaps["cilium_tpu"], snaps["cilium_tpu_torch"]
    assert t["entries"] == j["entries"] > 0
    assert t["basis"] == j["basis"] and t["ct_epoch"] == j["ct_epoch"]
    sj, stt = _sorted(j), _sorted(t)
    for k in ("ka", "kb", "kc", "packets", "revnat"):
        assert stt[k].dtype == sj[k].dtype, k
        np.testing.assert_array_equal(stt[k], sj[k], err_msg=k)
    assert (stt["packets"] > 1).any()  # pass 2 counted
    # remaining lifetimes at the save (the pinned clock's 1003 s)
    assert np.abs(stt["ttl"] - sj["ttl"]).max() <= TTL_TOLERANCE_S
    assert (stt["ttl"] > 0).all()


# -- the restore hold at pipeline level ------------------------------------
def restore_ct(pipe, engine, snap, disk_basis) -> dict:
    """The daemon's CT restore step at pipeline level: refill the host
    table when the snapshot's basis equals the restored compiled
    snapshot's, then hold the next rebuild's flush triggers, pinned to
    the engine's current revision. Anything else restores cold."""
    info = {"kept": 0, "expired": 0, "flushed": 0, "basis_match": False}
    if snap is None:  # absent, torn or foreign
        return info
    if disk_basis is None or disk_basis != snap["basis"]:
        info["flushed"] = int(snap["entries"])
        return info
    kept, expired = pipe.conntrack.restore_arrays(
        snap["ka"], snap["kb"], snap["kc"], snap["ttl"], packets=snap["packets"], revnat=snap["revnat"])
    c = engine._compiled
    pipe._ct_restore_hold = c.revision if c is not None else None
    info.update(kept=int(kept), expired=int(expired), basis_match=True)
    return info


class Restart:
    """One package's save → restart → restore over a ``Stack`` world:
    pass 1 of an egress batch on the stack's pipeline, both snapshots
    saved, then a fresh engine (trusted restore: the same repository and
    registry objects) and a fresh pipeline with an empty table of the
    same size."""

    def __init__(self, st: Stack, pkg: str, tmp_path, fam: int, flows, *, torn=False, basis=None):
        self.pkg, self.flows, self.fam = pkg, flows, fam
        w, pipe = st.w[pkg], st.pipes[pkg]
        self.first = self.batch(pipe)
        self.saved = len(pipe.conntrack)
        cpath, ctpath = str(tmp_path / f"{pkg}-compiled.npz"), str(tmp_path / f"{pkg}-ct.npz")
        pipe.engine.save_snapshot(cpath)
        cts = _mod(pkg, "datapath.ct_snapshot")
        hub = jfaults.hub if pkg == "cilium_tpu" else tfaults.hub
        if torn:
            cts.save_ct_state(ctpath, pipe.conntrack, basis=pipe._mat_basis, ct_epoch=pipe._ct_epoch)
            hub.fail(hub_site(pkg), "transient", times=1)
            with pytest.raises(Exception) as e:
                cts.save_ct_state(ctpath, pipe.conntrack, basis=pipe._mat_basis, ct_epoch=0)
            assert type(e.value).__name__ == "TransientFault"
        else:
            cts.save_ct_state(ctpath, pipe.conntrack, basis=basis or pipe._mat_basis,
                              ct_epoch=pipe._ct_epoch)
        self.engine = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_dev(pkg))
        assert self.engine.restore_snapshot(cpath, trust_counters=True) == {}
        ct = _mod(pkg, "datapath.conntrack").FlowConntrack(capacity_bits=14)
        self.pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
            self.engine, w.ipcache, pipe.prefilter, conntrack=ct, lb=st.lb[pkg], **_dev(pkg))
        self.pipe.set_endpoints(list(zip(pipe._endpoint_ids, pipe._endpoints)))
        self.snap = cts.load_ct_state(ctpath)
        self.disk_basis = _mod(pkg, "compiler.snapshot").read_snapshot_basis(cpath)

    def restore(self) -> dict:
        return restore_ct(self.pipe, self.engine, self.snap, self.disk_basis)

    def batch(self, pipe):
        peer, ep, dp, pr, sp = self.flows
        if self.fam == 4:
            peer = _pack(peer)
        call = pipe.process if self.fam == 4 else pipe.process_v6
        tails = []
        real = pipe._dispatch_enqueue
        pipe._dispatch_enqueue = lambda s, fl, sel, *a, **k: tails.append(len(sel)) or real(s, fl, sel, *a, **k)
        try:
            v, r = call(peer, ep, dp, pr, ingress=False, sports=sp)
        finally:
            del pipe._dispatch_enqueue
        return v, r, tails


def hub_site(pkg: str) -> str:
    return (jfaults if pkg == "cilium_tpu" else tfaults).SITE_STATE_WRITE


def _both(seed: int, fam: int, tmp_path, **kw):
    st = Stack(seed)
    flows = egress_flows(st, fam, B, seed * 3 + fam)
    return {pkg: Restart(st, pkg, tmp_path, fam, flows, **kw) for pkg in PKGS}


def _outcome(rs: Restart, info: dict):
    v, r, tails = rs.batch(rs.pipe)
    return {"info": info, "v": v.tolist(), "r": r.tolist(), "tails": tails, "ct": len(rs.pipe.conntrack),
            "keys": {k: a.tolist() for k, a in ct_keys(rs.pipe.conntrack).items()},
            "hold": rs.pipe._ct_restore_hold}


@pytest.mark.parametrize("fam", [4, 6])
def test_established_flows_survive_restart(tmp_path, fam):
    """The restored entries are kept across the first (held) rebuild:
    the same batch again finds them established, and the miss tail holds
    none of them."""
    out = {}
    for pkg, rs in _both(5, fam, tmp_path).items():
        info = rs.restore()
        assert info == {"kept": rs.saved, "expired": 0, "flushed": 0, "basis_match": True}
        assert rs.pipe._ct_restore_hold == rs.engine._compiled.revision >= 0
        o = out[pkg] = _outcome(rs, info)
        v1, r1, tails1 = rs.first
        admitted = (v1 == 1) & ~r1  # FORWARD, not redirected: the entries made
        assert tails1 == [B] and o["tails"] == [int((~admitted).sum())]
        assert (np.asarray(o["v"])[admitted] == 1).all()
        assert o["ct"] == rs.saved and o["hold"] is None
    assert out["cilium_tpu"] == out["cilium_tpu_torch"]


def test_rule_change_before_first_batch_voids_hold(tmp_path):
    """A rule added after the restore and before the first rebuild moves
    the revision: the restored entries flush instead of bypassing the
    new rules (and the restored engine, which has no CompileState, takes
    the full refresh path to get there)."""
    out = {}
    for pkg, rs in _both(6, 4, tmp_path).items():
        info = rs.restore()
        assert info["kept"] == rs.saved > 0
        api = _mod(pkg, "policy.api")
        rs.pipe.engine.repo.add_list([api.rule(["k8s:app=a1"], ingress=[api.IngressRule(
            from_endpoints=(api.EndpointSelector.make(["k8s:app=a2"]),))], labels=["k8s:policy=extra"])])
        o = out[pkg] = _outcome(rs, info)
        assert o["tails"] == [B]  # every flow re-verdicted
        assert o["ct"] <= rs.saved
    assert out["cilium_tpu"] == out["cilium_tpu_torch"]


def test_basis_mismatch_restores_cold(tmp_path):
    out = {}
    for pkg, rs in _both(7, 4, tmp_path, basis=(99999, 1, 1)).items():
        info = rs.restore()
        assert info == {"kept": 0, "expired": 0, "flushed": rs.saved, "basis_match": False}
        assert len(rs.pipe.conntrack) == 0 and rs.pipe._ct_restore_hold is None
        out[pkg] = _outcome(rs, info)
        assert out[pkg]["tails"] == [B]
    assert out["cilium_tpu"] == out["cilium_tpu_torch"]


def test_torn_ct_write_boots_cold_never_crashes(tmp_path):
    out = {}
    for pkg, rs in _both(8, 6, tmp_path, torn=True).items():
        assert rs.snap is None  # torn
        info = rs.restore()
        assert info == {"kept": 0, "expired": 0, "flushed": 0, "basis_match": False}
        out[pkg] = _outcome(rs, info)
        assert out[pkg]["tails"] == [B] and out[pkg]["v"] == rs.first[0].tolist()
    assert out["cilium_tpu"] == out["cilium_tpu_torch"]


def _move_lb(pkg, st, k):
    lb = _mod(pkg, "lb")
    st.lb[pkg].upsert(lb.L3n4Addr(f"10.97.0.{k}", 80, "TCP"), [lb.Backend(st.w[pkg].peer_ips[0], 80)])


def _move_ipcache(pkg, st, k):
    st.w[pkg].ipcache.upsert(f"192.168.77.{k}/32", st.w[pkg].idents[1].id, source="k8s")


@pytest.mark.parametrize("trigger", ["lb", "basis", "both"])
def test_each_flush_trigger_honours_the_hold_once(tmp_path, trigger):
    """A pipeline that already serves gets its table refilled and the
    hold set; the next rebuild moves only the LB tables, only the basis
    (an ipcache upsert), or both: the entries are kept. The hold is then
    spent, and the same move on the next rebuild flushes. A hold pinned
    to another revision flushes at once."""
    st = Stack(9)
    flows = egress_flows(st, 4, B, 31)
    out = {}
    for pkg in PKGS:
        rs = Restart(st, pkg, tmp_path, 4, flows)
        rs.pipe.rebuild()
        steps = [rs.restore()["kept"]]
        for k, hold in ((1, "now"), (2, None), (3, "stale")):
            if hold is not None:
                rs.restore()
                if hold == "stale":
                    rs.pipe._ct_restore_hold = rs.engine._compiled.revision - 1
            if trigger in ("lb", "both"):
                _move_lb(pkg, st, k)
            if trigger in ("basis", "both"):
                _move_ipcache(pkg, st, k)
            epoch = rs.pipe._ct_epoch
            rs.pipe.rebuild()
            steps.append((len(rs.pipe.conntrack), rs.pipe._ct_epoch - epoch, rs.pipe._ct_restore_hold))
        assert steps[1] == (rs.saved, 0, None)  # held: kept, no flush
        assert steps[2][0] == 0 and steps[2][1] >= 1  # spent: the move flushes
        assert steps[3][0] == 0 and steps[3][1] >= 1  # another revision: no hold
        out[pkg] = steps
    assert out["cilium_tpu"] == out["cilium_tpu_torch"]


def test_held_rebuild_keeps_the_device_ct(tmp_path, monkeypatch):
    """With device CT on, a held rebuild keeps the device table and an
    unheld one resets it, in both packages."""
    import time as _time

    monkeypatch.setattr(_time, "monotonic", lambda: 1000.0)
    st = Stack(10, with_lb=False)
    out = {}
    for pkg in PKGS:
        w = st.w[pkg]
        engine = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_dev(pkg))
        pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(
            engine, w.ipcache, device_ct_bits=10, **_dev(pkg))
        pipe.set_endpoints([i.id for i in w.idents[:N_EPS]])
        peer, ep, dp, pr = random_flows(w, 400, N_EPS, 12)
        sp = np.arange(400) + 2000
        pipe.process(peer, ep, dp, pr, ingress=True, sports=sp)
        table = pipe._device_ct
        assert table is not None
        steps = []
        for k, hold in ((1, True), (2, False)):
            if hold:
                pipe._ct_restore_hold = engine._compiled.revision
            _move_ipcache(pkg, st, k)
            pipe.rebuild()
            steps.append((pipe._device_ct is table, pipe._device_ct is None))
        assert steps == [(True, False), (False, True)]
        v, _r = pipe.process(peer, ep, dp, pr, ingress=True, sports=sp)
        out[pkg] = (steps, v.tolist())
    assert out["cilium_tpu"] == out["cilium_tpu_torch"]


# -- on_first_batch -----------------------------------------------------------
@pytest.mark.parametrize("raises", [False, True])
def test_on_first_batch_fires_once(raises):
    st = Stack(11, with_lb=False, with_ct=False)
    peer, ep, dp, pr = random_flows(st.w["cilium_tpu"], 300, N_EPS, 13)
    out = {}
    for pkg, pipe in st.pipes.items():
        calls = []

        def hook():
            calls.append(len(calls))
            if raises:
                raise RuntimeError("hook")

        pipe.on_first_batch = hook
        res = [pipe.process(peer, ep, dp, pr, ingress=True)[0].tolist()]
        assert calls == [0] and pipe.on_first_batch is None
        pend = [pipe.submit(peer, ep, dp, pr, ingress=False) for _ in range(2)]
        res += [p.result()[0].tolist() for p in pend]
        assert calls == [0]
        out[pkg] = res
    assert out["cilium_tpu"] == out["cilium_tpu_torch"]
