"""Port parity: the entry points (``cilium_tpu_torch/entry.py``).

``test_multichip.py``'s sharding parity through the port: the same
worlds from the same seeds (``_build_world``, ``_make_flows``,
``_build_datapath_world``, ``_make_ip_flows``, ``_build_dfa_world``),
each sharded result on a grid of 8 CPU records (``{"flows": 4, "ident":
2}``, the tests' 8 virtual JAX devices) equal to the port's unsharded
result and to the JAX package's on ``__graft_entry__``'s worlds, bit for
bit. Then ``entry()`` against ``__graft_entry__.entry()`` on the same
example arguments, and ``dryrun_multichip(8, device="cpu")``: its ok
line, and the placement seam restored after it, also when a phase fails;
on 1 and 3 records, the odd counts' one flows axis.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import __graft_entry__ as ref  # noqa: E402

from cilium_tpu_torch import entry  # noqa: E402
from cilium_tpu_torch.convert import device_policy_from_numpy  # noqa: E402
from cilium_tpu_torch.datapath import placement  # noqa: E402
from cilium_tpu_torch.ops import lookup  # noqa: E402
from cilium_tpu_torch.ops.materialize import _sweep_device  # noqa: E402
from cilium_tpu_torch.ops.verdict import verdict_batch  # noqa: E402

N_DEVICES = 8
CPU = torch.device("cpu")
SEG = (np.asarray([0, 1, 2, 3, 0, 1, 2, 3], np.int32),
       np.asarray([0, 0, 0, 0, 80, 80, 443, 443], np.int32),
       np.asarray([0, 0, 0, 0, 6, 6, 6, 6], np.int32),
       np.asarray([False] * 4 + [True] * 4))


@pytest.fixture()
def plan():
    with entry.virtual_devices(N_DEVICES, CPU):
        p = entry._grid_plan(N_DEVICES)
        assert p.axes == {"flows": 4, "ident": 2}
        yield p


def _world(pkg_world, seed: int, **kw):
    return pkg_world(n_rules=48, n_idents=24, seed=seed, n_apps=12, n_zones=3, **kw)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _i32(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(a.dtype, copy=False)


def _eq(got, *wants) -> None:
    g = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    for w in wants:
        w = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
        np.testing.assert_array_equal(_i32(g), _i32(w))


def _step_args(compiled, flows):
    return (_t(_i32(compiled.id_bits)), _t(_i32(compiled.conj_req)),
            _t(_i32(compiled.conj_forbid)), _t(np.asarray(compiled.conj_valid, bool)),
            _t(np.asarray(compiled.req_count, np.int32)), *flows)


def _flow_sharded_verdicts(policy, flows, b, plan):
    parts = [verdict_batch(policy, *(_t(x[lo:hi]).to(d) for x in flows), block=b)
             for lo, hi, d in entry._flow_spans(b, plan)]
    return [torch.cat([getattr(p, f) for p in parts]) for f in ("decision", "l3", "l7_redirect")]


class TestShardingParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_selector_matches_ident_sharded(self, plan, seed):
        engine, idents = _world(entry._build_world, seed, device="cpu")
        j_engine, _ = _world(ref._build_world, seed)
        b = 64 * N_DEVICES
        flows = entry._make_flows(engine, idents, b, seed)
        step = entry.make_sharded_step(engine.device_policy, engine._compiled, b, plan)
        _dec, sel = step(*_step_args(engine._compiled, flows))
        _eq(sel, engine.device_policy.sel_match, j_engine.device_policy.sel_match)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_verdict_batch_flow_sharded(self, plan, seed):
        engine, idents = _world(entry._build_world, seed, device="cpu")
        j_engine, j_idents = _world(ref._build_world, seed)
        b = 128 * N_DEVICES
        flows = entry._make_flows(engine, idents, b, seed)
        j_flows = ref._make_flows(j_engine, j_idents, b, seed)
        for x, y in zip(flows, j_flows):
            _eq(x, y)
        base = verdict_batch(engine.device_policy, *(_t(x) for x in flows))
        from cilium_tpu.ops.verdict import verdict_batch as j_verdict_batch

        j_base = j_verdict_batch(j_engine.device_policy, *(jnp.asarray(x) for x in j_flows))
        sharded = _flow_sharded_verdicts(engine.device_policy, flows, b, plan)
        for s, f in zip(sharded, ("decision", "l3", "l7_redirect")):
            _eq(s, getattr(base, f), getattr(j_base, f))

    @pytest.mark.parametrize("seed", [0, 5])
    def test_full_step_recompute_plus_verdicts(self, plan, seed):
        """The dry run's step (``make_sharded_step``: K1 on each ident
        shard, verdicts on each flow shard reading the ident-sharded
        rows) against the unsharded path, full batch."""
        engine, idents = _world(entry._build_world, seed, device="cpu")
        j_engine, j_idents = _world(ref._build_world, seed)
        b = 64 * N_DEVICES
        flows = entry._make_flows(engine, idents, b, seed + 100)
        j_flows = ref._make_flows(j_engine, j_idents, b, seed + 100)
        step = entry.make_sharded_step(engine.device_policy, engine._compiled, b, plan)
        dec, _sel = step(*_step_args(engine._compiled, flows))
        base = verdict_batch(engine.device_policy, *(_t(x) for x in flows))
        from cilium_tpu.ops.verdict import verdict_batch as j_verdict_batch

        j_base = j_verdict_batch(j_engine.device_policy, *(jnp.asarray(x) for x in j_flows))
        _eq(dec, base.decision, j_base.decision)


class TestDatapathSharding:
    def test_lpm_policymap_chain_flow_sharded(self, plan):
        """The datapath chain of a pipeline placed on the grid (each
        flow shard on its grid row's tables, the policymap rows read
        from their ident shards) against the unplaced tables and the
        reference's chain."""
        pipe, _engine, idents = entry._build_datapath_world(seed=3, device="cpu")
        assert pipe.placement_state()["axes"] == {"flows": 4, "ident": 2}
        assert isinstance(pipe._placed_pm[0][2].id_bits, lookup.IdentSharded)
        j_pipe, _je, j_idents = ref._build_datapath_world(seed=3)
        b = 128 * N_DEVICES
        dp = entry.make_sharded_datapath_step(pipe, b)
        flows = entry._make_ip_flows(idents, b, seed=4)
        j_flows = ref._make_ip_flows(j_idents, b, seed=4)
        base = dp(*flows, sharded=False)
        sh = dp(*flows)
        j_out = ref.make_sharded_datapath_step(j_pipe, b)(*(jnp.asarray(x) for x in j_flows))
        for s, a, j in zip(sh, base, j_out):
            _eq(s, a, j)
        assert len(set(base[0].tolist())) >= 3

    def test_materialize_sweep_ident_sharded(self, plan):
        engine, _ = _world(entry._build_world, 7, device="cpu")
        j_engine, _ = _world(ref._build_world, 7)
        from cilium_tpu.ops.materialize import _sweep_device as j_sweep

        policy = engine.device_policy
        n = int(engine._compiled.id_bits.shape[0])
        base = _sweep_device(policy, *(_t(x) for x in SEG), n, True, 1024)
        policy_sh = dataclasses.replace(
            policy, sel_match=lookup.shard_rows(policy.sel_match, entry._ident_sharding(plan)))
        sh = _sweep_device(policy_sh, *(_t(x) for x in SEG), n, True, 1024)
        j_base = j_sweep(j_engine.device_policy, *(jnp.asarray(x) for x in SEG), n, True, 1024)
        for s, a, j in zip(sh, base, j_base):
            _eq(s, a, j)

    @pytest.mark.parametrize("seed", [3, 4])
    def test_l7_dfa_flow_sharded(self, plan, seed):
        from cilium_tpu.ops.dfa import dfa_match_batch as j_dfa_match_batch
        from cilium_tpu_torch.ops.dfa import dfa_match_batch

        b, max_len = 1024, 64
        tabs, sb, lens = entry._build_dfa_world(b, seed=seed, max_len=max_len, device="cpu")
        j_tabs, j_sb, j_lens = ref._build_dfa_world(b, seed=seed, max_len=max_len)
        _eq(sb, j_sb)
        _eq(lens, j_lens)
        base = dfa_match_batch(*tabs, _t(sb), _t(lens), max_len)
        outs = [dfa_match_batch(*tabs, _t(sb[lo:hi]), _t(lens[lo:hi]), max_len)
                for lo, hi, _d in entry._flow_spans(b, plan)]
        sh = [torch.cat([o[k] for o in outs]) for k in (0, 1)]
        j_base = j_dfa_match_batch(*j_tabs, jnp.asarray(j_sb), jnp.asarray(j_lens), max_len)
        for s, a, j in zip(sh, base, j_base):
            _eq(s, a, j)
        assert bool((sh[0] != 0).any()) and bool((sh[0] == 0).any())


def test_entry_matches_the_reference_entry():
    """``entry(device="cpu")``'s step on its own example arguments and on
    the reference's (converted) equals ``__graft_entry__.entry()``'s
    decision."""
    fn, args = entry.entry(device="cpu")
    j_fn, j_args = ref.entry()
    want = np.asarray(j_fn(*j_args))
    got = fn(*args)
    assert got.dtype == torch.int8 and tuple(got.shape) == (1024,)
    _eq(got, want)
    j_engine, _ = ref._build_world()
    policy = device_policy_from_numpy(j_engine._compiled, device="cpu",
                                      sel_match=np.asarray(j_args[0].sel_match))
    _eq(fn(policy, *(_t(x) for x in j_args[1:])), want)
    for x, y in zip(args[1:], j_args[1:]):
        _eq(x, y)


def test_dryrun_multichip_prints_its_line_and_restores_the_seam(capsys):
    seam = placement.visible_devices
    entry.dryrun_multichip(N_DEVICES, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith('dryrun_multichip ok: 8 devices, mesh {"flows": 4, "ident": 2}, '
                          'batch 2048; phases: selector-recompute+verdicts=')
    for phase in ("lpm+policymap datapath=", "materialize sweep=", "l7 dfa batch="):
        assert phase in out
    assert placement.visible_devices is seam


@pytest.mark.parametrize("n", [1, 3])
def test_dryrun_multichip_on_an_odd_count_is_one_flows_axis(n, capsys):
    """An odd record count gives the reference's one-row grid: ``{"flows":
    n}`` (one record: a one-cell grid), every phase still equal to the
    unsharded run."""
    seam = placement.visible_devices
    entry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith(f'dryrun_multichip ok: {n} devices, mesh {{"flows": {n}}}, '
                          f'batch {256 * n}; phases: selector-recompute+verdicts=')
    assert placement.visible_devices is seam


def test_dryrun_multichip_raises_on_a_wrong_phase_and_restores_the_seam(monkeypatch):
    """A kernel wrapper that gives a wrong answer on a flow shard fails
    its phase; the seam is back afterwards."""
    from cilium_tpu_torch.ops import dfa

    real = dfa.dfa_match_batch
    calls = []

    def wrong(*a, **kw):
        lo, hi = real(*a, **kw)
        calls.append(1)
        return (lo ^ 1, hi) if len(calls) > 1 else (lo, hi)

    monkeypatch.setattr(dfa, "dfa_match_batch", wrong)
    seam = placement.visible_devices
    with pytest.raises(AssertionError, match="l7 dfa batch"):
        entry.dryrun_multichip(4, device="cpu")
    assert placement.visible_devices is seam
