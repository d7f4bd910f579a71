"""Port parity: compiled-state snapshots and restore.

The port's ``compiler/snapshot.py``, ``ops/materialize.state_from_snapshot``
and ``PolicyEngine.save_snapshot`` / ``restore_snapshot`` /
``_kick_background_refresh`` / ``wait_refreshed`` against the JAX
package's, on the CPU with the plain kernel versions:

- the JAX package's snapshot tests (``TestSnapshotRoundtrip``,
  ``test_restart_with_coincidental_revision_recompiles``, the two
  restored-engine cases of ``test_policyd_delta.py``, the migration
  tests of ``test_config_maps_cli.py`` that need no daemon) run against
  the port;
- a file written by either package loads in the other with every array
  and meta key equal, and pipelines over the restored engines give the
  same verdicts, redirects and counters on v4 and v6 batches, with
  attribution off and on;
- the background refresh: a kernel that cannot build and any other
  programmer error reach ``threading.excepthook`` raw, a transient
  fault leaves the restored tables serving;
- the refresh guard: a rule delta on a restored engine takes the full
  path.

Every comparison is bit equality: the outputs are integers and bools.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import random
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from cilium_tpu_torch import _kernels
from cilium_tpu_torch import faults as tfaults
from cilium_tpu_torch import metrics as tmetrics
from cilium_tpu_torch.engine import PolicyEngine
from cilium_tpu_torch.identity import IdentityRegistry
from cilium_tpu_torch.labels import parse_label_array
from cilium_tpu_torch.ops.lookup import lookup_batch
from cilium_tpu_torch.ops.materialize import TRAFFIC_EGRESS, TRAFFIC_INGRESS, materialize_endpoints_state
from cilium_tpu_torch.ops.verdict import verdict_batch
from cilium_tpu_torch.policy.api import EndpointSelector, IngressRule, PortProtocol, PortRule, rule
from cilium_tpu_torch.policy.repository import Repository
from test_torch_harness import PKGS, REPO, build_world, random_flows
from test_torch_pipeline_v6 import N_EPS, add_v6, v6_flows


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _dev(pkg: str) -> dict:
    return {} if pkg == "cilium_tpu" else {"device": "cpu"}


# -- the JAX package's TestSnapshotRoundtrip, run against the port -------
def _world(n_rules=40, n_idents=24, seed=5):
    rng = random.Random(seed)
    repo = Repository()
    rules = []
    for i in range(n_rules):
        subject = [f"k8s:app=a{rng.randrange(8)}"]
        peer = EndpointSelector.make([f"k8s:app=a{rng.randrange(8)}"])
        if i % 3 == 0:
            ing = IngressRule(
                from_endpoints=(peer,),
                to_ports=(PortRule(ports=(PortProtocol(80, "TCP"),)),),
            )
        else:
            ing = IngressRule(from_endpoints=(peer,))
        rules.append(rule(subject, ingress=[ing]))
    repo.add_list(rules)
    reg = IdentityRegistry()
    idents = [reg.allocate(parse_label_array([f"k8s:app=a{rng.randrange(8)}"])) for _ in range(n_idents)]
    return repo, reg, idents


def _flows(engine, idents, b=512, seed=9):
    rows = engine.rows([i.id for i in idents])
    rng = np.random.default_rng(seed)
    subj = torch.from_numpy(rng.choice(rows, b).astype(np.int32))
    peer = torch.from_numpy(rng.choice(rows, b).astype(np.int32))
    dport = torch.from_numpy(rng.choice(np.array([0, 80, 443], np.int32), b))
    proto = torch.from_numpy(np.full(b, 6, np.int32))
    return subj, peer, dport, proto, dport != 0


class TestSnapshotRoundtrip:
    def test_restore_serves_identical_verdicts(self, tmp_path):
        repo, reg, idents = _world()
        engine = PolicyEngine(repo, reg, device="cpu")
        compiled = engine.refresh()
        ep_ids = [idents[i].id for i in range(6)]
        mats = {
            TRAFFIC_INGRESS: materialize_endpoints_state(compiled, engine.device_policy, ep_ids, ingress=True),
            TRAFFIC_EGRESS: materialize_endpoints_state(compiled, engine.device_policy, ep_ids, ingress=False),
        }
        path = str(tmp_path / "compiled.npz")
        engine.save_snapshot(path, mats)

        # a fresh engine over the SAME repository and registry objects:
        # the one case where trusting the snapshot's counters is sound
        engine2 = PolicyEngine(repo, reg, device="cpu")
        launches = _kernels.launches()
        restored = engine2.restore_snapshot(path, trust_counters=True)
        assert _kernels.launches() == launches  # a load: no selector match, no sweep
        assert restored is not None and set(restored) == {TRAFFIC_INGRESS, TRAFFIC_EGRESS}
        args = _flows(engine, idents)
        v1 = verdict_batch(engine.device_policy, *args)
        v2 = verdict_batch(engine2.device_policy, *args)
        np.testing.assert_array_equal(v1.decision.numpy(), v2.decision.numpy())
        # not stale: refresh() is a no-op, not a recompile
        assert engine2.refresh() is engine2._compiled

        rng = np.random.default_rng(3)
        b = 256
        rows = engine.rows([i.id for i in idents])
        ep_idx = torch.from_numpy(rng.integers(0, 6, b, dtype=np.int32))
        src = torch.from_numpy(rng.choice(rows, b).astype(np.int32))
        dport = torch.from_numpy(rng.choice(np.array([0, 80, 443], np.int32), b))
        proto = torch.from_numpy(np.full(b, 6, np.int32))
        for d in (TRAFFIC_INGRESS, TRAFFIC_EGRESS):
            d1, r1 = lookup_batch(mats[d].tables, ep_idx, src, dport, proto)
            d2, r2 = lookup_batch(restored[d].tables, ep_idx, src, dport, proto)
            np.testing.assert_array_equal(d1.numpy(), d2.numpy())
            np.testing.assert_array_equal(r1.numpy(), r2.numpy())
            np.testing.assert_array_equal(mats[d].tables.id_bits.numpy(), restored[d].tables.id_bits.numpy())
            assert restored[d].rule_nc is None and restored[d].rule_tab is None
            for s1, s2 in zip(mats[d].snapshots, restored[d].snapshots):
                assert s1.entries == s2.entries
                assert s1.slots == s2.slots

    def test_restored_engine_recompiles_when_inputs_move(self, tmp_path):
        """The snapshot serves as-is, and a rule import after the
        restore triggers a full recompile whose verdicts match a
        from-scratch engine."""
        repo, reg, idents = _world()
        engine = PolicyEngine(repo, reg, device="cpu")
        engine.refresh()
        path = str(tmp_path / "compiled.npz")
        engine.save_snapshot(path)

        engine2 = PolicyEngine(repo, reg, device="cpu")
        assert engine2.restore_snapshot(path) is not None
        repo.add_list([rule(["k8s:app=a0"], ingress=[IngressRule(
            from_endpoints=(EndpointSelector.make(["k8s:app=a7"]),))])])
        idents.append(reg.allocate(parse_label_array(["k8s:app=a7"])))
        # untrusted restore: the first refresh returns the restored
        # (still serving) compile and recompiles in the background
        stale = engine2.refresh()
        assert stale.revision < 0
        assert engine2.wait_refreshed(60)
        c2 = engine2.refresh()
        fresh = PolicyEngine(repo, reg, device="cpu")
        fresh.refresh()
        args = _flows(engine2, idents)
        va = verdict_batch(engine2.device_policy, *args)
        vb = verdict_batch(fresh.device_policy, *args)
        np.testing.assert_array_equal(va.decision.numpy(), vb.decision.numpy())
        assert c2.revision == repo.revision

    def test_missing_or_corrupt_snapshot(self, tmp_path):
        repo, reg, _ = _world(n_rules=4, n_idents=4)
        engine = PolicyEngine(repo, reg, device="cpu")
        assert engine.restore_snapshot(str(tmp_path / "absent.npz")) is None
        bad = tmp_path / "bad.npz"
        bad.write_bytes(b"not an npz")
        assert engine.restore_snapshot(str(bad)) is None
        engine.refresh()
        good = tmp_path / "good.npz"
        engine.save_snapshot(str(good))
        data = good.read_bytes()
        (tmp_path / "trunc.npz").write_bytes(data[: len(data) // 2])
        assert engine.restore_snapshot(str(tmp_path / "trunc.npz")) is None
        engine.refresh(force=True)
        assert engine.device_policy is not None


def test_restart_with_coincidental_revision_recompiles(tmp_path):
    """A fresh repository restarts its revision numbering, so a rule
    imported after the restore can land on a revision at or under the
    dead process's counter; the untrusted restore re-stamps the counters
    so the recompile happens anyway."""
    repo, reg, idents = _world()
    engine = PolicyEngine(repo, reg, device="cpu")
    for i in range(3):
        repo.add_list([rule(
            [f"k8s:app=a{i}"],
            ingress=[IngressRule(from_endpoints=(EndpointSelector.make([f"k8s:app=a{(i + 1) % 8}"]),))],
            labels=[f"k8s:policy=extra-{i}"],
        )])
    engine.refresh()
    path = str(tmp_path / "compiled.npz")
    engine.save_snapshot(path)
    old_revision = engine._compiled.revision

    with repo._lock:
        all_rules = [copy.deepcopy(r) for r in repo.rules]
    repo2 = Repository()
    repo2.add_list(all_rules)
    reg2 = IdentityRegistry()
    idents2 = [reg2.allocate(i.labels) for i in idents]
    engine2 = PolicyEngine(repo2, reg2, device="cpu")
    assert engine2.restore_snapshot(path) is not None
    assert repo2.revision < old_revision
    repo2.add_list([rule(
        ["k8s:app=a5"],
        ingress=[IngressRule(from_endpoints=(EndpointSelector.make(["k8s:app=a6"]),))],
        labels=["k8s:policy=post-restart"],
    )])
    assert repo2.revision <= old_revision
    engine2.refresh()  # kicks the background recompile
    assert engine2.wait_refreshed(60)
    c = engine2.refresh()
    assert c.revision == repo2.revision
    fresh = PolicyEngine(repo2, reg2, device="cpu")
    fresh.refresh()
    args = _flows(engine2, idents2)
    va = verdict_batch(engine2.device_policy, *args)
    vb = verdict_batch(fresh.device_policy, *args)
    np.testing.assert_array_equal(va.decision.numpy(), vb.decision.numpy())


# -- the restored-engine cases of test_policyd_delta.py ------------------
def _pipeline(pkg, engine, w, **kw):
    pipe = _mod(pkg, "datapath.pipeline").DatapathPipeline(engine, w.ipcache, **kw, **_dev(pkg))
    pipe.set_endpoints([i.id for i in w.idents[:N_EPS]])
    return pipe


def test_snapshot_restored_engine_full_fallback(tmp_path):
    """A restored engine carries no CompileState and logs a "full"
    delta on restore: a pipeline over it takes the full path and serves
    correct verdicts at once."""
    w = build_world("cilium_tpu_torch", 17, n_rules=14, n_idents=16)
    engine = PolicyEngine(w.repo, w.reg, device="cpu")
    pipe = _pipeline("cilium_tpu_torch", engine, w)
    pipe.rebuild()
    path = str(tmp_path / "engine.npz")
    engine.save_snapshot(path)

    engine2 = PolicyEngine(w.repo, w.reg, device="cpu")
    assert engine2.restore_snapshot(path, trust_counters=True) is not None
    assert [k for _, k, _ in engine2.deltas_since(0)] == ["full"]
    assert engine2._state is None
    pipe2 = _pipeline("cilium_tpu_torch", engine2, w)
    pipe2.rebuild()
    flows = random_flows(w, 200, N_EPS, 5)
    for ingress in (True, False):
        v1, r1 = pipe.process(*flows, ingress=ingress)
        v2, r2 = pipe2.process(*flows, ingress=ingress)
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(r1, r2)


def test_delta_racing_background_refresh(tmp_path):
    """An untrusted restore refreshes in the background; a rule landing
    during that window reaches the pipeline as a "full" delta
    (re-materialization), never as a stale patch."""
    w = build_world("cilium_tpu_torch", 19, n_rules=14, n_idents=16)
    engine = PolicyEngine(w.repo, w.reg, device="cpu")
    pipe = _pipeline("cilium_tpu_torch", engine, w)
    pipe.rebuild()
    path = str(tmp_path / "engine.npz")
    engine.save_snapshot(path)

    engine2 = PolicyEngine(w.repo, w.reg, device="cpu")
    assert engine2.restore_snapshot(path) is not None  # untrusted
    pipe2 = _pipeline("cilium_tpu_torch", engine2, w)
    pipe2.rebuild()
    base = dict(pipe2._mat)
    # the racing deltas: an identity and a rule while the refresh path
    # of the restored engine is kicked into the background
    labels = _mod("cilium_tpu_torch", "labels")
    w.reg.allocate(labels.parse_label_array(["k8s:app=a1", "k8s:team=t2", "k8s:uid=race"]))
    w.repo.add_list([rule(
        ["k8s:app=a0"],
        ingress=[IngressRule(from_endpoints=(EndpointSelector.make(["k8s:app=a3"]),))],
        labels=["k8s:policy=race"],
    )])
    engine2.refresh()  # revision < 0: kicks the background full refresh
    assert engine2.wait_refreshed(60)
    pipe2.rebuild()
    assert all(pipe2._mat.get(d) is not base[d] for d in base), (
        "the background recompile's full delta must re-materialize"
    )
    pipe.rebuild()
    flows = random_flows(w, 200, N_EPS, 6)
    for ingress in (True, False):
        v1, _ = pipe.process(*flows, ingress=ingress)
        v2, _ = pipe2.process(*flows, ingress=ingress)
        np.testing.assert_array_equal(v1, v2)


# -- the refresh guard ----------------------------------------------------
@pytest.mark.parametrize("op", ["add", "delete"])
def test_rule_delta_on_restored_engine_takes_full_path(tmp_path, op):
    """A trusted restore keeps the counters, so a later rule op is an
    incremental candidate; with no CompileState it must take the full
    path (never the packers' assert) and match a fresh engine."""
    w = build_world("cilium_tpu_torch", 23, n_rules=16, n_idents=16)
    engine = PolicyEngine(w.repo, w.reg, device="cpu")
    engine.refresh()
    path = str(tmp_path / "c.npz")
    engine.save_snapshot(path)
    engine2 = PolicyEngine(w.repo, w.reg, device="cpu")
    engine2.restore_snapshot(path, trust_counters=True)
    if op == "add":
        w.repo.add_list([rule(["k8s:app=a2"], ingress=[IngressRule(
            from_endpoints=(EndpointSelector.make(["k8s:app=a4"]),))], labels=["k8s:policy=g"])])
    else:
        w.repo.delete_by_labels(parse_label_array(["k8s:policy=fz3"]))
    full = tmetrics.engine_refreshes_total.get({"kind": "full"})
    c = engine2.refresh()
    assert tmetrics.engine_refreshes_total.get({"kind": "full"}) == full + 1
    assert c.revision == w.repo.revision and engine2._state is not None
    assert engine2.wait_refreshed(0)  # synchronous: no thread was started
    fresh = PolicyEngine(w.repo, w.reg, device="cpu")
    fresh.refresh()
    args = _flows(engine2, w.idents)
    np.testing.assert_array_equal(verdict_batch(engine2.device_policy, *args).decision.numpy(),
                                  verdict_batch(fresh.device_policy, *args).decision.numpy())


# -- the background thread -------------------------------------------------
def _restored_and_moved(tmp_path):
    w = build_world("cilium_tpu_torch", 29, n_rules=12, n_idents=12)
    engine = PolicyEngine(w.repo, w.reg, device="cpu")
    engine.refresh()
    path = str(tmp_path / "c.npz")
    engine.save_snapshot(path)
    engine2 = PolicyEngine(w.repo, w.reg, device="cpu")
    engine2.restore_snapshot(path)
    restored = engine2._device
    w.repo.add_list([rule(["k8s:app=a1"], ingress=[IngressRule(
        from_endpoints=(EndpointSelector.make(["k8s:app=a5"]),))], labels=["k8s:policy=bg"])])
    return w, engine2, restored


@pytest.mark.parametrize("exc", [
    _kernels.KernelError("nvcc failed"),
    TypeError("bad operand"),
    AssertionError("broken invariant"),
])
def test_background_programmer_errors_reach_excepthook(tmp_path, monkeypatch, exc):
    w, engine, restored = _restored_and_moved(tmp_path)
    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda args: seen.append(args))

    def boom(repo, registry, device):
        raise exc

    monkeypatch.setattr(PolicyEngine, "_compute_full", staticmethod(boom))
    assert engine.refresh().revision == -1
    assert engine.wait_refreshed(30)
    assert [a.exc_value for a in seen] == [exc]  # raw, never absorbed
    assert seen[0].thread.name == "policyd-bg-refresh"
    assert engine._device is restored


@pytest.mark.parametrize("exc", [
    tfaults.TransientFault("bg"), tfaults.PoisonedFault("bg"), OSError("disk"), RuntimeError("device"),
])
def test_background_fault_leaves_restored_tables_serving(tmp_path, monkeypatch, exc):
    w, engine, restored = _restored_and_moved(tmp_path)
    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda args: seen.append(args))
    real = PolicyEngine._compute_full

    def fault(repo, registry, device):
        raise exc

    monkeypatch.setattr(PolicyEngine, "_compute_full", staticmethod(fault))
    args = _flows(engine, w.idents[:8])
    before = verdict_batch(engine.device_policy, *args).decision.numpy()
    assert engine.wait_refreshed(30)
    assert seen == []
    assert engine._device is restored and engine._compiled.revision == -1
    np.testing.assert_array_equal(verdict_batch(engine.device_policy, *args).decision.numpy(), before)
    # the next refresh retries, and lands
    monkeypatch.setattr(PolicyEngine, "_compute_full", staticmethod(real))
    engine.refresh()
    assert engine.wait_refreshed(30)
    assert engine.refresh().revision == w.repo.revision


def test_background_install_drops_a_stale_result(tmp_path, monkeypatch):
    """A full refresh that installs while the background one runs wins:
    the older background result is dropped, never installed over it."""
    w, engine, _restored = _restored_and_moved(tmp_path)
    gate = threading.Event()
    real = PolicyEngine._compute_full

    def slow(repo, registry, device):
        gate.wait(30)
        return real(repo, registry, device)

    monkeypatch.setattr(PolicyEngine, "_compute_full", staticmethod(slow))
    engine.refresh()  # kicks; the thread waits on the gate
    monkeypatch.setattr(PolicyEngine, "_compute_full", staticmethod(real))
    gen = engine.install_gen
    forced = engine.refresh(force=True)
    assert engine.install_gen == gen + 1
    gate.set()
    assert engine.wait_refreshed(30)
    assert engine._compiled is forced and engine.install_gen == gen + 1


# -- snapshots across the two packages --------------------------------------
def _stack(pkg, seed, *, attrib):
    w = build_world(pkg, seed)
    peers6 = add_v6(w)
    engine = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_dev(pkg))
    pipe = _pipeline(pkg, engine, w)
    pipe.set_attribution(attrib)
    pipe.rebuild()
    return w, peers6, engine, pipe


def _npz(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "meta"}
        meta = json.loads(bytes(z["meta"]).decode())
    return arrays, meta


def _entries(snapshots):
    """Per-endpoint policymap entries with the keys as tuples: each
    package has its own PolicyKey class."""
    return [{dataclasses.astuple(k): v for k, v in s.entries.items()} for s in snapshots]


def _batches(w, peers6, seed):
    return [(4, random_flows(w, 700, N_EPS, seed)), (6, v6_flows(peers6, 700, seed + 1))]


def _run(pipe, fam, flows, ingress):
    call = pipe.process if fam == 4 else pipe.process_v6
    out = call(*flows, ingress=ingress)
    return [np.asarray(x) for x in out] + [pipe.counters.copy()]


@pytest.mark.parametrize("attrib", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_files_cross_packages(tmp_path, seed, attrib):
    """Each package saves its engine and both materialized directions;
    the two files hold the same arrays (dtype and values) and the same
    meta. Each package restores the OTHER's file, and pipelines over the
    restored engines give what the originals gave, in both packages,
    on v4 and v6 batches and both directions."""
    st = {pkg: _stack(pkg, seed, attrib=attrib) for pkg in PKGS}
    paths = {pkg: str(tmp_path / f"{pkg}.npz") for pkg in PKGS}
    for pkg, (_w, _p6, engine, pipe) in st.items():
        engine.save_snapshot(paths[pkg], dict(pipe._mat))
    (aj, mj), (at, mt) = _npz(paths["cilium_tpu"]), _npz(paths["cilium_tpu_torch"])
    assert mj == mt
    assert sorted(aj) == sorted(at)
    for k in aj:
        assert aj[k].dtype == at[k].dtype, k
        np.testing.assert_array_equal(aj[k], at[k], err_msg=k)
    # each loader reads the other's file to the same state
    for pkg, other in zip(PKGS, PKGS[::-1]):
        mine = _mod(pkg, "compiler.snapshot").load_compiled_state(paths[pkg])
        theirs = _mod(pkg, "compiler.snapshot").load_compiled_state(paths[other])
        assert mine[0].id_to_row == theirs[0].id_to_row
        np.testing.assert_array_equal(mine[1], theirs[1])
        assert mine[2].keys() == theirs[2].keys()
        for d in mine[2]:
            for k, v in mine[2][d].items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(v, theirs[2][d][k], err_msg=k)
                else:
                    assert v == theirs[2][d][k], k

    restored = {}
    for pkg, other in zip(PKGS, PKGS[::-1]):
        w, _p6, _engine, _pipe = st[pkg]
        engine2 = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_dev(pkg))
        mats = engine2.restore_snapshot(paths[other], trust_counters=True)
        assert set(mats) == {TRAFFIC_INGRESS, TRAFFIC_EGRESS}
        for d, m in mats.items():
            np.testing.assert_array_equal(np.asarray(m.tables.id_bits),
                                          np.asarray(st[other][3]._mat[d].tables.id_bits))
            assert _entries(m.snapshots) == _entries(st[other][3]._mat[d].snapshots)
        pipe2 = _pipeline(pkg, engine2, w)
        pipe2.set_attribution(attrib)
        pipe2.rebuild()
        restored[pkg] = pipe2
    wj, p6 = st["cilium_tpu"][0], st["cilium_tpu"][1]
    for fam, flows in _batches(wj, p6, seed + 40):
        for ingress in (True, False):
            outs = [_run(p, fam, flows, ingress)
                    for p in (st["cilium_tpu"][3], restored["cilium_tpu"], st["cilium_tpu_torch"][3],
                              restored["cilium_tpu_torch"])]
            # all four start their counters at zero and see the same
            # batches: every output, counters included, is equal
            for o in outs[1:]:
                for a, b in zip(outs[0], o):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [3, 4])
def test_background_refresh_lands_same_as_jax(tmp_path, seed):
    """Untrusted restores of one file in both packages, a rule added,
    the background refresh awaited: the landed compiles, the refresh
    kinds and the pipelines' results (attribution on, rule tables back)
    are equal."""
    st = {pkg: _stack(pkg, seed, attrib=True) for pkg in PKGS}
    path = str(tmp_path / "c.npz")
    st["cilium_tpu"][2].save_snapshot(path)
    pipes = {}
    for pkg in PKGS:
        w = st[pkg][0]
        engine2 = _mod(pkg, "engine").PolicyEngine(w.repo, w.reg, **_dev(pkg))
        assert engine2.restore_snapshot(path) == {}
        api = _mod(pkg, "policy.api")
        w.repo.add_list([api.rule(["k8s:app=a3"], ingress=[api.IngressRule(
            from_endpoints=(api.EndpointSelector.make(["k8s:app=a6"]),))], labels=["k8s:policy=new"])])
        assert engine2.refresh().revision == -1
        assert engine2.wait_refreshed(60)
        assert [k for _, k, _ in engine2.deltas_since(0)] == ["full", "full"]
        pipe2 = _pipeline(pkg, engine2, w)
        pipe2.set_attribution(True)
        pipe2.rebuild()
        assert all(m.rule_tab is not None for m in pipe2._mat.values())
        pipes[pkg] = pipe2
    for fam, flows in _batches(st["cilium_tpu"][0], st["cilium_tpu"][1], seed + 50):
        for ingress in (True, False):
            a, b = (_run(pipes[p], fam, flows, ingress) for p in PKGS)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# -- state_migrate -----------------------------------------------------------
V1 = {
    "rules": [{
        "endpointSelector": {"matchLabels": {"k8s:app": "web"}},
        "egress": [{
            "toServices": [{"k8sService": {"serviceName": "ext", "namespace": "default"}}],
            "toCIDRSet": [{"cidr": "192.0.2.8/32", "generated": True}],
        }],
        "labels": ["k8s:policy=mig"],
    }],
    "endpoints": [{"id": 3, "labels": ["k8s:app=web"], "ipv4": "10.200.0.3"}],
}


def test_v1_snapshot_migrates():
    """An unversioned (v1) state.json migrates: services defaulted,
    legacy generated CIDRs service-owned, the CT stanza added; a schema
    newer than the build is refused. Equal to the JAX package's chain.
    (The daemon half of the JAX package's test comes with the daemon.)"""
    from cilium_tpu_torch.state_migrate import SCHEMA_VERSION, migrate

    out = migrate(copy.deepcopy(V1))
    assert out["schema"] == SCHEMA_VERSION
    cidr = out["rules"][0]["egress"][0]["toCIDRSet"][0]
    assert cidr["generatedBy"] == "service"
    assert out["services"] == []
    assert out["ct"] == {"snapshot": None, "basis": None}
    with pytest.raises(ValueError, match="newer"):
        migrate({"schema": 99})
    for start in (V1, {**copy.deepcopy(V1), "schema": 2}, {"schema": 3, "rules": []}):
        assert migrate(copy.deepcopy(start)) == _mod("cilium_tpu", "state_migrate").migrate(copy.deepcopy(start))
    assert migrate(copy.deepcopy(out)) == out  # idempotent


def test_cli_migrate_tool(tmp_path, capsys):
    from cilium_tpu_torch.state_migrate import main

    p = tmp_path / "state.json"
    p.write_text(json.dumps({"rules": [], "endpoints": []}))
    assert main([str(p)]) == 0
    assert json.loads(p.read_text())["schema"] >= 2
    assert "schema 3" in capsys.readouterr().out
    assert main([]) == 2


def test_migrate_module_runs_standalone(tmp_path):
    p = tmp_path / "state.json"
    p.write_text(json.dumps(V1))
    proc = subprocess.run([sys.executable, "-m", "cilium_tpu_torch.state_migrate", str(p)],
                          cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"{p}: schema 3"
    assert json.loads(p.read_text())["ct"] == {"snapshot": None, "basis": None}
