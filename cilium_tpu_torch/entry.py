"""Entry points of the port: the verdict step and the multi-device dry
run.

- ``entry()`` returns the batched verdict step over the engine's device
  policy (``verdict_batch``: the ``bool_mm`` kernel on the card) and its
  example arguments.
- ``dryrun_multichip(n)`` runs the full pipeline step over an n-device
  grid and holds each phase bit for bit against the unsharded run:
  selector recompute (``selector_match`` over each ``ident`` shard's
  ``id_bits`` rows) feeding verdicts over each ``flows`` shard, the LPM
  + policymap datapath chain of a pipeline placed on the grid, one
  materialization sweep with ``sel_match`` ident-sharded (its rows read
  through ``ident_gather``), and an L7 DFA batch with the request rows
  sharded over flows.

The grid is virtual: ``n`` ``DeviceRecord``s on one torch device (the
card unless ``device="cpu"``), given to the placement through its one
seam, ``placement.visible_devices``, and restored on exit. Identity rows
shard over ``ident`` (2 for an even ``n``), flow batches over
``flows``. The functions that build the worlds are shared with the tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import _kernels
from .datapath import placement
from .ops import dfa as _dfa
from .ops import lookup as _lookup
from .ops import materialize as _materialize
from .ops import verdict as _verdict
from .ops.bitmap import compute_selector_matches


def _build_world(
    n_rules: int = 64,
    n_idents: int = 32,
    seed: int = 0,
    n_apps: int = 16,
    n_zones: int = 4,
    device=None,
):
    """The shared world: ``n_rules`` ingress rules between random apps
    (every third with an 80/TCP port rule) and ``n_idents`` identities,
    drawn from ``random.Random(seed)`` in the reference's order, on an
    engine refreshed on ``device`` (None = the card)."""
    from .engine import PolicyEngine
    from .identity import IdentityRegistry
    from .labels import parse_label_array
    from .policy.api import EndpointSelector, IngressRule, PortProtocol, PortRule, rule
    from .policy.repository import Repository

    rng = random.Random(seed)
    repo = Repository()
    rules = []
    for i in range(n_rules):
        subject = [f"k8s:app=a{rng.randrange(n_apps)}"]
        peer = EndpointSelector.make([f"k8s:app=a{rng.randrange(n_apps)}"])
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
    idents = [
        reg.allocate(parse_label_array(
            [f"k8s:app=a{rng.randrange(n_apps)}", f"k8s:z=z{i % n_zones}"]))
        for i in range(n_idents)
    ]
    engine = PolicyEngine(repo, reg, device=device)
    engine.refresh()
    return engine, idents


def _make_flows(engine, idents, b: int, seed: int):
    """A host flow batch over live identity rows: (subj, peer, dport,
    proto, has_l4) numpy arrays."""
    rows = engine.rows([i.id for i in idents])
    rng = np.random.default_rng(seed)
    subj = rng.choice(rows, b).astype(np.int32)
    peer = rng.choice(rows, b).astype(np.int32)
    dport = rng.choice(np.array([0, 80, 443], np.int32), b)
    proto = np.full(b, 6, np.int32)
    has_l4 = dport != 0
    return subj, peer, dport, proto, has_l4


def _on(x, device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _tables_on(t: _verdict.DeviceTables, device) -> _verdict.DeviceTables:
    return _verdict.DeviceTables(**{
        f.name: getattr(t, f.name).to(device) for f in dataclasses.fields(t)})


def _flow_spans(b: int, plan) -> List[Tuple[int, int, torch.device]]:
    """(lo, hi, device) of each flow shard: the grid rows' first
    devices, the pipeline's span widths."""
    from .datapath.pipeline import DatapathPipeline

    rows = plan.mesh
    spans = DatapathPipeline._shard_spans(b, len(rows))
    return [(lo, hi, row[0].device) for (lo, hi), row in zip(spans, rows)]


def _ident_sharding(plan) -> placement.GridSharding:
    """The plan's ``("ident", None)`` sharding; on a 1D grid one shard
    a grid row (the whole table)."""
    return plan.ident_sharding or placement.GridSharding(plan.mesh, ("ident", None))


def make_sharded_step(policy, compiled, b: int, plan):
    """The multichip step over ``plan``'s grid: the selector recompute
    runs ``selector_match`` on each ``ident`` shard's ``id_bits`` rows
    (on the shard's device), and the verdicts of each ``flows`` shard
    run on its grid row's device, reading the ident-sharded ``sel_match``
    rows through ``ident_gather`` (the reference's GSPMD all-gather).
    ``step(id_bits, conj_req, conj_forbid, conj_valid, req_count, subj,
    peer, dport, proto, has_l4)`` → (decision [b] int8, sel_match
    [N, S/32] int32), both on ``policy``'s device. ``compiled`` is the
    policy's CompiledPolicy (its arrays are the step's arguments)."""
    home = policy.id_bits.device
    ident_sh = _ident_sharding(plan)

    def step(id_bits, conj_req, conj_forbid, conj_valid, req_count,
             subj, peer, dport, proto, has_l4):
        conj = (conj_req, conj_forbid, conj_valid, req_count)
        ids = _lookup.shard_rows(_on(id_bits, home), ident_sh)
        conj_on: Dict[torch.device, Tuple] = {}
        made: Dict[int, _lookup.RowShard] = {}

        def recompute(s: _lookup.RowShard) -> _lookup.RowShard:
            if id(s) not in made:
                dev = s.tensor.device
                if dev not in conj_on:
                    conj_on[dev] = tuple(_on(c, dev) for c in conj)
                out = compute_selector_matches(s.tensor, *conj_on[dev], row_chunk=max(s.rows, 1))
                made[id(s)] = _lookup.RowShard(s.row_lo, s.rows, out)
            return made[id(s)]

        shards = tuple(tuple(recompute(s) for s in row) for row in ids.shards)
        words = shards[0][0].tensor.shape[1]
        sel = _lookup.IdentSharded((ids.shape[0], words), home, shards)
        flows = (subj, peer, dport, proto, has_l4)
        parts = []
        for lo, hi, dev in _flow_spans(b, plan):
            pol = _verdict.DevicePolicy(
                id_bits=policy.id_bits, sel_match=sel,
                ingress=_tables_on(policy.ingress, dev), egress=_tables_on(policy.egress, dev))
            v = _verdict.verdict_batch(pol, *(_on(x[lo:hi], dev) for x in flows), block=b)
            parts.append(v.decision.to(home))
        full = torch.cat([s.tensor.to(home) for s in shards[0]])
        return torch.cat(parts), full

    return step


def _build_datapath_world(seed: int = 0, device=None):
    """The engine world with an ipcache (a /32 per identity and one
    /16), a one-prefix prefilter and four endpoints, assembled into a
    DatapathPipeline placed on the visible devices' 2D grid
    (``sharding=True, mesh_2d=True``; one card forms no grid) and
    rebuilt: the full datapath state (tries and policymaps)."""
    from .datapath.pipeline import DatapathPipeline
    from .ipcache.ipcache import IPCache
    from .ipcache.prefilter import PreFilter

    engine, idents = _build_world(seed=seed, device=device)
    cache = IPCache()
    for i, ident in enumerate(idents):
        cache.upsert(f"10.0.{i >> 8}.{i & 255}/32", ident.id, source="k8s")
    cache.upsert("10.7.0.0/16", idents[0].id, source="k8s")
    pf = PreFilter()
    pf.insert(pf.revision, ["192.0.2.0/24"])
    pipe = DatapathPipeline(engine, cache, pf, sharding=True, mesh_2d=True, device=device)
    pipe.set_endpoints([i.id for i in idents[:4]])
    pipe.rebuild()
    return pipe, engine, idents


def _make_ip_flows(idents, b: int, seed: int):
    """Flow batches addressed by IP (the LPM stage's input): known
    endpoint addresses, the broad prefix, a prefiltered source and an
    unknown (world) address. → (peer uint32, ep_idx, dport, proto)."""
    rng = np.random.default_rng(seed)
    known = [(10 << 24) | (0 << 16) | ((i >> 8) << 8) | (i & 255) for i in range(len(idents))]
    pool = np.asarray(
        known + [(10 << 24) | (7 << 16) | 99, (192 << 24) | (0 << 16) | (2 << 8) | 5,
                 (8 << 24) | (8 << 16) | (8 << 8) | 8],
        np.uint32,
    )
    peer_u32 = pool[rng.integers(0, len(pool), b)].astype(np.uint32)
    ep_idx = rng.integers(0, 4, b).astype(np.int32)
    dport = rng.choice(np.array([0, 80, 443], np.int32), b)
    proto = np.full(b, 6, np.int32)
    return peer_u32, ep_idx, dport, proto


def make_sharded_datapath_step(pipe, b: int):
    """The datapath half of the multichip step: prefilter deny-LPM +
    identity-LPM (wide tries, ``lpm_wide``) + policymap verdict and
    counters (``policymap_verdict``) over the ingress v4 tables, as
    ``DatapathPipeline._dispatch_enqueue`` runs them. ``fn(peer_u32,
    ep_idx, dport, proto, sharded=True)`` → (verdict [B] int8, redirect
    [B] bool, counters [EP, 3] int32) on the pipeline's device: sharded,
    each flow shard on its grid row's placed tables (a 2D grid's rows
    read from their ident shards); unsharded, the whole batch on the
    unplaced tables."""
    from .datapath.pipeline import TRAFFIC_INGRESS, process_flows_wide

    key = (TRAFFIC_INGRESS, 4)
    tables = pipe.rebuild()[key]
    placed = pipe._placed
    home = pipe.device
    ep_count = max(1, len(pipe._endpoints))

    def fn(peer_u32, ep_idx, dport, proto, sharded: bool = True):
        flows = (np.asarray(peer_u32, np.uint32).view(np.int32), ep_idx, dport, proto)
        n = flows[0].shape[0]
        if sharded and placed is not None:
            spans = pipe._shard_spans(n, len(placed.rows))
            shards = [(lo, hi, dev, tabs[key]) for (lo, hi), (dev, tabs, _rt)
                      in zip(spans, placed.rows)]
            ident2d = placed.ident2d
        else:
            shards, ident2d = [(0, n, home, tables)], False
        outs = [process_flows_wide(t, *(_on(x[lo:hi], dev) for x in flows), ep_count=ep_count,
                                   block=b, prefilter=True, ident_gather=ident2d)
                for lo, hi, dev, t in shards]
        return (torch.cat([o[0].to(home) for o in outs]),
                torch.cat([o[1].to(home) for o in outs]),
                torch.stack([o[2].to(home) for o in outs]).sum(dim=0).to(torch.int32))

    return fn


def _build_dfa_world(b: int, seed: int = 3, max_len: int = 64, device=None):
    """Compiled DFA tables on ``device`` and a synthetic request-path
    batch (host arrays): 4 ``/api/v<k>/...`` and 4 ``/svc<k>/...``
    patterns, paths that match each and ``/deny/...`` ones."""
    from .l7.regex_compile import compile_patterns

    patterns = [f"/api/v{i}/[a-z0-9]*" for i in range(4)] + [f"/svc{i}/.*" for i in range(4)]
    dev = _dfa.device_dfa(compile_patterns(patterns), device=device)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(b):
        k = int(rng.integers(0, 10))
        if k < 4:
            paths.append(f"/api/v{k}/obj{i % 97}".encode())
        elif k < 8:
            paths.append(f"/svc{k - 4}/x/{i}".encode())
        else:
            paths.append(f"/deny/{i}".encode())
    sb, lens = _dfa.strings_to_batch(paths, max_len)
    return dev, sb, lens


def entry(device=None):
    """→ (fn, example_args): the batched verdict step. ``fn(policy,
    subj, peer, dport, proto, has_l4)`` is ``verdict_batch``'s decision
    vector; the example arguments are ``_build_world()``'s device policy
    and a seeded batch of 1 024 flows, on ``device`` (None = the card)."""
    engine, idents = _build_world(device=device)
    policy = engine.device_policy
    dev = engine.device
    rows = engine.rows([i.id for i in idents])
    b = 1024
    rng = np.random.default_rng(0)
    subj = _on(rng.choice(rows, b).astype(np.int32), dev)
    peer = _on(rng.choice(rows, b).astype(np.int32), dev)
    dport_np = rng.choice(np.array([0, 80, 443], np.int32), b)
    dport = _on(dport_np, dev)
    proto = _on(np.full(b, 6, np.int32), dev)
    has_l4 = _on(dport_np != 0, dev)

    def fn(policy, subj, peer, dport, proto, has_l4):
        return _verdict.verdict_batch(policy, subj, peer, dport, proto, has_l4).decision

    return fn, (policy, subj, peer, dport, proto, has_l4)


@contextlib.contextmanager
def virtual_devices(n: int, device: torch.device):
    """``placement.visible_devices`` as ``n`` records on ``device`` for
    the block's duration, restored on exit (also on an exception)."""
    real = placement.visible_devices
    placement.visible_devices = lambda: [placement.DeviceRecord(i, 0, device) for i in range(n)]
    try:
        yield
    finally:
        placement.visible_devices = real


def _grid_plan(n: int) -> placement.MeshPlan:
    """The dry run's grid over the visible records: ``{"flows": n / 2,
    "ident": 2}`` for an even ``n``, else ``{"flows": n}`` (one record:
    a one-cell grid)."""
    if n > 1:
        return placement.resolve_plan(None, sharding=True, mesh_2d=n % 2 == 0)
    grid = ((placement.visible_devices()[0],),)
    return placement.MeshPlan(
        generation=1, mesh=grid, flow_sharding=placement.GridSharding(grid, ("flows",)),
        table_sharding=placement.GridSharding(grid, ()), ident_sharding=None, flows_size=1,
        device_ids=(grid[0][0].id,), axes={"flows": 1})


def _same(phase: str, got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> None:
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"dryrun_multichip {phase}: output {k} differs from the "
                                 f"unsharded run")


def _timer(device: torch.device) -> Callable[[Callable], float]:
    """→ timed(fn): the seconds of one warm run of ``fn`` after a
    warm-up run: CUDA events on the card, a monotonic clock on the CPU."""
    def timed(fn) -> float:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.monotonic()
        fn()
        return time.monotonic() - t0

    return timed


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The full pipeline step over an ``n_devices`` grid of virtual
    records on one torch device (None = the card; ``"cpu"`` runs the
    plain versions), one warm execution of each phase timed. Each phase
    is held bit for bit against the unsharded run and raises when it
    differs; phase 2 must give at least three verdict kinds and phase 4
    DFA accepts and rejects. Prints ``dryrun_multichip ok: <n> devices,
    mesh {...}, batch <b>; phases: ...``."""
    dev = _kernels.resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs a device, got {n_devices}")
    with virtual_devices(n_devices, dev):
        _dryrun(n_devices, dev)


def _dryrun(n_devices: int, dev: torch.device) -> None:
    plan = _grid_plan(n_devices)
    timed = _timer(dev)
    timings: Dict[str, float] = {}
    b = 256 * n_devices

    # -- phase 1: selector recompute (ident-sharded) + verdicts (flows)
    engine, idents = _build_world(device=dev)
    compiled = engine._compiled
    policy = engine.device_policy
    flows = _make_flows(engine, idents, b, seed=1)
    conj = (compiled.conj_req, compiled.conj_forbid, compiled.conj_valid, compiled.req_count)
    args = (_on(np.asarray(compiled.id_bits).view(np.int32), dev),
            _on(np.asarray(conj[0]).view(np.int32), dev),
            _on(np.asarray(conj[1]).view(np.int32), dev),
            _on(np.asarray(conj[2], bool), dev),
            _on(np.asarray(conj[3], np.int32), dev),
            *flows)
    step = make_sharded_step(policy, compiled, b, plan)
    dec, sel = step(*args)
    single = _verdict.verdict_batch(policy, *(_on(x, dev) for x in flows))
    _same("selector-recompute+verdicts", [dec, sel], [single.decision, policy.sel_match])
    timings["selector-recompute+verdicts"] = timed(lambda: step(*args)[0])

    # -- phase 2: the datapath chain on a pipeline placed on the grid
    pipe, _p_engine, p_idents = _build_datapath_world(device=dev)
    dp = make_sharded_datapath_step(pipe, b)
    ip_flows = _make_ip_flows(p_idents, b, seed=2)
    base = dp(*ip_flows, sharded=False)
    sh = dp(*ip_flows)
    _same("lpm+policymap datapath", sh, base)
    if len(set(sh[0].cpu().tolist())) < 3:
        raise AssertionError("dryrun_multichip lpm+policymap datapath: dp stages unexercised")
    timings["lpm+policymap datapath"] = timed(lambda: dp(*ip_flows)[0])

    # -- phase 3: one materialization sweep, sel_match ident-sharded
    n_rows = int(compiled.id_bits.shape[0])
    seg = (_on(np.asarray([0, 1, 2, 3, 0, 1, 2, 3], np.int32), dev),
           _on(np.asarray([0, 0, 0, 0, 80, 80, 443, 443], np.int32), dev),
           _on(np.asarray([0, 0, 0, 0, 6, 6, 6, 6], np.int32), dev),
           _on(np.asarray([False] * 4 + [True] * 4), dev))
    base_sweep = _materialize._sweep_device(policy, *seg, n_rows, True, 1024)
    policy_sh = dataclasses.replace(
        policy, sel_match=_lookup.shard_rows(policy.sel_match, _ident_sharding(plan)))
    sh_sweep = _materialize._sweep_device(policy_sh, *seg, n_rows, True, 1024)
    _same("materialize sweep", sh_sweep, base_sweep)
    timings["materialize sweep"] = timed(
        lambda: _materialize._sweep_device(policy_sh, *seg, n_rows, True, 1024)[0])

    # -- phase 4: L7 DFA batch, request rows sharded over flows
    max_len = 64
    tabs, sb, lens = _build_dfa_world(b, max_len=max_len, device=dev)
    base_lo, base_hi = _dfa.dfa_match_batch(*tabs, _on(sb, dev), _on(lens, dev), max_len)

    def dfa_sharded():
        outs = [_dfa.dfa_match_batch(*(t.to(d) for t in tabs), _on(sb[lo:hi], d),
                                     _on(lens[lo:hi], d), max_len)
                for lo, hi, d in _flow_spans(b, plan)]
        return (torch.cat([o[0].to(dev) for o in outs]), torch.cat([o[1].to(dev) for o in outs]))

    sh_lo, sh_hi = dfa_sharded()
    _same("l7 dfa batch", [sh_lo, sh_hi], [base_lo, base_hi])
    if not bool((sh_lo != 0).any()) or not bool((sh_lo == 0).any()):
        raise AssertionError("dryrun_multichip l7 dfa batch: needs DFA accepts and rejects")
    timings["l7 dfa batch"] = timed(lambda: dfa_sharded()[0])

    phase_list = "; ".join(f"{k}={round(v, 4)}s" for k, v in timings.items())
    print(f"dryrun_multichip ok: {n_devices} devices, mesh {json.dumps(plan.axes)}, "
          f"batch {b}; phases: {phase_list}", flush=True)
