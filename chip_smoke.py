"""Smoke run of cilium_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

1. Builds the port's CUDA kernels (csrc/*.cu → build/cilium_tpu_torch/).
2. Builds the headline deployment of bench.py with the port's own
   modules: 10 000 rules over 512 apps (30% with an L4 port), 2 048
   identities with one /32 ipcache entry each, 64 endpoints.
3. Drives the main path with every launch count at 0 first:
   PolicyEngine.refresh → DatapathPipeline.rebuild → process() of
   1 048 576-flow batches, once with an empty prefilter (identity walk
   only) and once with the four bench prefilter CIDRs (the fused
   deny+identity walk). Fails unless every kernel launched.
4. Holds 65 536 flows of each run against the same path run with
   device="cpu" (the plain PyTorch versions) and a few hundred flows
   against the host oracle Repository.allows_ingress.
5. Holds every kernel against its plain version on the card, at the
   main path's shapes, with exact equality (all outputs are integers),
   and times kernel, plain version and, where one exists, a library
   call computing the same function (CUDA events: the median of five
   runs' per-launch means, after 50 ms of warm-up launches). Before
   the main path it also holds each kernel against its plain version
   on shapes the main path does not reach (ragged sizes, the 16-8-8
   trie, wide policymaps).

Prints the card's name and power limit, one JSON line with every
kernel's numbers and, last, the result line
{"ok": true, "device": {...}}. Any failure exits non-zero before that
line. Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import ipaddress
import json
import random
import subprocess
import sys
import time

N_RULES = 10_000
N_IDENTITIES = 2_048
N_ENDPOINTS = 64
N_APPS = 512
BATCH = 1 << 20
SLICE = 1 << 16
N_ORACLE = 400
PREFILTER_CIDRS = ["192.0.2.0/24", "198.51.100.0/24", "10.3.0.0/16", "10.250.7.0/28"]

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# int8 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_world(seed: int):
    """bench.py build_world (10k rules / 2 048 identities) with the
    port's modules; rule and identity draws from ``random.Random(seed)``."""
    from cilium_tpu_torch.identity import IdentityRegistry
    from cilium_tpu_torch.ipcache.ipcache import IPCache
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.api import (
        EndpointSelector, IngressRule, PortProtocol, PortRule, rule,
    )
    from cilium_tpu_torch.policy.repository import Repository

    rng = random.Random(seed)
    repo = Repository()
    rules = []
    for _ in range(N_RULES):
        app = rng.randrange(N_APPS)
        peer = EndpointSelector.make([f"k8s:app=a{rng.randrange(N_APPS)}"])
        if rng.random() < 0.3:
            port = rng.choice([80, 443, 8080, 53, 5432])
            proto = "UDP" if port == 53 else "TCP"
            ing = IngressRule(
                from_endpoints=(peer,),
                to_ports=(PortRule(ports=(PortProtocol(port, proto),)),),
            )
        else:
            ing = IngressRule(from_endpoints=(peer,))
        rules.append(rule([f"k8s:app=a{app}"], ingress=[ing]))
    repo.add_list(rules)
    reg = IdentityRegistry()
    idents, labels_of = [], {}
    for _ in range(N_IDENTITIES):
        labels = [f"k8s:app=a{rng.randrange(N_APPS)}", f"k8s:zone=z{rng.randrange(8)}"]
        if rng.random() < 0.5:
            labels.append(f"k8s:env={'prod' if rng.random() < 0.5 else 'dev'}")
        ident = reg.allocate(parse_label_array(labels))
        idents.append(ident)
        labels_of[ident.id] = labels
    cache = IPCache()
    for i, ident in enumerate(idents):
        cache.upsert(f"10.{(i >> 8) & 255}.{i & 255}.1/32", ident.id, source="k8s")
    return repo, reg, cache, idents, labels_of


def make_flows(seed: int, n_idents: int):
    """bench.py's flow batch: peers drawn over the identity /32s."""
    import numpy as np

    nrng = np.random.default_rng(seed)
    i_sel = nrng.integers(0, n_idents, BATCH)
    ips = (
        np.uint32(10) << 24
        | ((i_sel >> 8) & 255).astype(np.uint32) << 16
        | (i_sel & 255).astype(np.uint32) << 8
        | 1
    ).astype(np.uint32)
    eps = nrng.integers(0, N_ENDPOINTS, BATCH).astype(np.int32)
    dports = nrng.choice(np.array([80, 443, 8080, 53, 22], np.int32), BATCH)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return ips, eps, dports.astype(np.int32), protos, i_sel


def cuda_ms(fn, iters: int = 20, reps: int = 5, warm_s: float = 0.05):
    """Per-launch means (ms, CUDA events) of ``reps`` runs of ``iters``
    launches, sorted. Launches for at least ``warm_s`` seconds first, so
    that a card idle through the host phases has raised its clocks."""
    import torch

    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return sorted(out)


def median(xs):
    return xs[len(xs) // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int):
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT8_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def lpm_touched_bytes(root_info, root_child, sub_info, addr) -> int:
    """Bytes the flat 16+16 walk must move for these addresses: each
    address in and each value out once, plus the distinct table entries
    this data reaches (the root_info and root_child entry of every
    address's top 16 bits, and the sub_info entry below it). The flat
    walk never reads sub_child."""
    import torch

    if sub_info.shape[-1] != 65536:
        fail("lpm_touched_bytes counts the flat layout only")
    q = addr.to(torch.int64) & 0xFFFFFFFF
    hi = q >> 16
    node = root_child[hi].to(torch.int64)
    ok = (node > 0) & (node < sub_info.shape[0])
    sub = torch.unique(node[ok] * 65536 + (q[ok] & 0xFFFF)).numel()
    return 4 * (2 * addr.numel() + 2 * torch.unique(hi).numel() + sub)


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def oracle_check(repo, labels_of, idents, pipe_name, ips, eps, dports, protos,
                 i_sel, verdicts, denied_net, endpoints):
    """Hold N_ORACLE flows against Repository.allows_ingress (and the
    prefilter membership for the deny stage)."""
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.search import Decision, PortContext, SearchContext

    for i in range(N_ORACLE):
        ip = ipaddress.IPv4Address(int(ips[i]))
        if any(ip in net for net in denied_net):
            want = 3
        else:
            subj = parse_label_array(labels_of[endpoints[int(eps[i])]])
            peer = parse_label_array(labels_of[idents[int(i_sel[i])].id])
            pc = PortContext(int(dports[i]), "UDP" if int(protos[i]) == 17 else "TCP")
            ok = repo.allows_ingress(SearchContext(src=peer, dst=subj, dports=(pc,)))
            want = 1 if ok == Decision.ALLOWED else 2
        if int(verdicts[i]) != want:
            fail(f"{pipe_name}: flow {i} verdict {int(verdicts[i])}, oracle {want}")


def edge_checks(dev) -> None:
    """Kernel vs plain version, exact, on shapes the main path does not
    reach: ragged selector counts with several conjuncts (K1), ragged
    int8 products (K2), the 16-8-8 trie layout (K3), and a policymap
    wider than one staged column chunk with more endpoints than the
    shared counter histogram holds (K4)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.bitmap import compute_selector_matches, selector_match_plain
    from cilium_tpu_torch.ops.lookup import PolicymapTables, policymap_verdict, policymap_verdict_plain
    from cilium_tpu_torch.ops.lpm import build_wide_trie, lpm_lookup_wide, lpm_wide_plain
    from cilium_tpu_torch.ops.verdict import bool_mm, bool_mm_plain

    rs = np.random.default_rng(1234)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n, s, cps, w = 1000, 45, 3, 2
    k1 = (
        t(rs.integers(-2**31, 2**31, (n, w), dtype=np.int64).astype(np.int32)),
        t((rs.integers(0, 2**31, (s, cps, w)) & rs.integers(0, 2**31, (s, cps, w))
           & rs.integers(0, 2**31, (s, cps, w))).astype(np.int32)),
        t((rs.integers(0, 2**31, (s, cps, w)) & rs.integers(0, 2**31, (s, cps, w))
           & rs.integers(0, 2**31, (s, cps, w)) & rs.integers(0, 2**31, (s, cps, w))).astype(np.int32)),
        t(rs.random((s, cps)) < 0.8),
        t(rs.integers(0, 12, (s, cps)).astype(np.int32)),
    )
    if max_abs_err(compute_selector_matches(*k1), selector_match_plain(*k1)):
        fail("selector_match disagrees on ragged conjuncts")

    x = t((rs.random((777, 333)) < 0.3).astype(np.int8))
    wm = t(rs.integers(-3, 4, (333, 201)).astype(np.int8))
    for comp in (False, True):
        if max_abs_err(bool_mm(x, wm, complement_x=comp), bool_mm_plain(x, wm, complement_x=comp)):
            fail(f"bool_mm disagrees on a ragged product (complement {comp})")

    prefixes = [("0.0.0.0/0", 1), ("10.0.0.0/8", 2)]
    for j in range(129):
        for _ in range(4):
            addr = ((100 << 24) | (j << 16)) | int(rs.integers(0, 1 << 16))
            plen = int(rs.choice([17, 20, 24, 28, 32]))
            prefixes.append((str(ipaddress.ip_network((addr, plen), strict=False)), len(prefixes)))
    tabs = [t(a) for a in build_wide_trie(prefixes)]
    if tabs[3].shape[-1] != 256:
        fail("129 deep /16s did not build the 16-8-8 layout")
    addr = t(((100 << 24) | rs.integers(0, 1 << 24, 200_000)).astype(np.uint32).view(np.int32))
    if max_abs_err(lpm_lookup_wide(*tabs, addr), lpm_wide_plain(*tabs, addr)):
        fail("lpm_wide disagrees on the 16-8-8 layout")

    n_rows, words, ep_count, b = 300, 80, 2100, 50_000  # 1 280 columns
    c = words // 2 * 32
    bits = rs.integers(-2**31, 2**31, (n_rows, words), dtype=np.int64).astype(np.int32)
    pm = PolicymapTables(
        col_ep=t(rs.integers(-1, 40, c).astype(np.int32)),
        col_port=t(rs.choice(np.array([0, 80, 443], np.int32), c)),
        col_proto=t(rs.choice(np.array([6, 17], np.int32), c)),
        col_is_l3=t(rs.random(c) < 0.2),
        id_bits=t(bits & bits // 3),
    )
    flows = [t(rs.integers(-5, n_rows + 5, b).astype(np.int32)),
             t(rs.integers(-1, 41, b).astype(np.int32)),
             t(rs.choice(np.array([80, 443, 22], np.int32), b)),
             t(rs.choice(np.array([6, 17], np.int32), b))]
    denied = t(rs.random(b) < 0.1)
    for eps in (64, ep_count):
        got = policymap_verdict(pm, *flows, denied_pf=denied, ep_count=eps)
        want = policymap_verdict_plain(pm, *flows, denied_pf=denied, ep_count=eps)
        if any(max_abs_err(g, w_) for g, w_ in zip(got, want)):
            fail(f"policymap_verdict disagrees on {c} columns / {eps} endpoints")
    torch.cuda.synchronize()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.pipeline import TRAFFIC_INGRESS, DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.ops.bitmap import compute_selector_matches, selector_match_plain, unpack_bits_u32
    from cilium_tpu_torch.ops.lookup import policymap_verdict, policymap_verdict_plain
    from cilium_tpu_torch.ops.lpm import lpm_lookup_wide, lpm_wide_plain
    from cilium_tpu_torch.ops.verdict import bool_mm, bool_mm_plain
    from cilium_tpu_torch.convert import words_i32

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build()
    _kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {_kernels.build_seconds if _kernels.build_seconds is not None else 0.0:.2f}s)",
          flush=True)

    edge_checks(dev)
    print("edge shapes: every kernel equals its plain version (ragged K1/K2, "
          "16-8-8 K3, 1 280-column / 2 100-endpoint K4)", flush=True)

    # -- 2. world --------------------------------------------------------
    t0 = time.perf_counter()
    repo, reg, cache, idents, labels_of = build_world(args.seed)
    ips, eps, dports, protos, i_sel = make_flows(args.seed, len(idents))
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]
    print(f"world: {N_RULES} rules, {len(idents)} identities, {N_ENDPOINTS} endpoints "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)

    # -- 3. main path on the card, launch counts from zero ---------------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    engine = PolicyEngine(repo, reg)
    engine.refresh()
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    pipes = {}
    results = {}
    for name, cidrs in (("no-prefilter", []), ("prefilter", PREFILTER_CIDRS)):
        pf = PreFilter()
        if cidrs:
            pf.insert(pf.revision, cidrs)
        pipe = DatapathPipeline(engine, cache, pf)
        pipe.set_endpoints(endpoints)
        t0 = time.perf_counter()
        pipe.rebuild()
        torch.cuda.synchronize()
        t_rebuild = time.perf_counter() - t0
        times, outs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            outs.append(pipe.process(ips, eps, dports, protos))
            times.append(time.perf_counter() - t0)
        v, red = outs[0]
        for v2, red2 in outs[1:]:
            if not (np.array_equal(v, v2) and np.array_equal(red, red2)):
                fail(f"{name}: runs of one batch disagree")
        pipes[name] = pipe
        results[name] = (v, red)
        fused = pipe._tables[TRAFFIC_INGRESS].merged_sub_info.shape[-1] == 65536
        t_med = sorted(times)[1]
        print(f"main path [{name}]: rebuild {t_rebuild!r}s, process {BATCH} flows "
              f"{times}s (median {t_med!r}s = {BATCH / t_med!r} "
              f"verdicts/s end to end incl. h2d/d2h; fused walk: {fused}); verdicts "
              f"{np.bincount(v, minlength=4)[1:].tolist()}, redirects {int(red.sum())} "
              f"[{card}]", flush=True)
    launches = _kernels.launches()
    print(f"refresh {t_refresh!r}s; main-path launches {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} never launched on the main path")
    if not pipes["prefilter"]._tables[TRAFFIC_INGRESS].merged_sub_info.shape[-1] == 65536:
        fail("prefilter run did not take the fused walk")

    # -- 4. against the plain path on the CPU and the host oracle --------
    t0 = time.perf_counter()
    cpu_engine = PolicyEngine(repo, reg, device="cpu")
    denied_net = [ipaddress.ip_network(c) for c in PREFILTER_CIDRS]
    for name, cidrs in (("no-prefilter", []), ("prefilter", PREFILTER_CIDRS)):
        pf = PreFilter()
        if cidrs:
            pf.insert(pf.revision, cidrs)
        cpu_pipe = DatapathPipeline(cpu_engine, cache, pf, device="cpu")
        cpu_pipe.set_endpoints(endpoints)
        s = slice(0, SLICE)
        vc, rc = cpu_pipe.process(ips[s], eps[s], dports[s], protos[s])
        v, red = results[name]
        if not (np.array_equal(vc, v[s]) and np.array_equal(rc, red[s])):
            bad = int(np.argmax((vc != v[s]) | (rc != red[s])))
            fail(f"{name}: card and CPU disagree at flow {bad}")
        gpu_pipe = pipes[name]
        gpu_pipe.counters[:] = 0
        gpu_pipe.process(ips[s], eps[s], dports[s], protos[s])
        if not np.array_equal(gpu_pipe.counters, cpu_pipe.counters):
            fail(f"{name}: counters differ between card and CPU")
        oracle_check(repo, labels_of, idents, name, ips, eps, dports, protos, i_sel,
                     v, denied_net if cidrs else [], endpoints)
    print(f"card == CPU plain path on {SLICE} flows (verdicts, redirects, counters) and "
          f"== host oracle on {N_ORACLE} flows, both runs, in {time.perf_counter() - t0:.2f}s",
          flush=True)

    # -- 5. each kernel against its plain version on the card ------------
    compiled, device = engine.snapshot()
    rows = []

    # K1 selector_match at the engine's shapes
    k1_in = (
        words_i32(compiled.id_bits, dev), words_i32(compiled.conj_req, dev),
        words_i32(compiled.conj_forbid, dev),
        torch.from_numpy(np.ascontiguousarray(compiled.conj_valid, bool)).to(dev),
        torch.from_numpy(np.ascontiguousarray(compiled.req_count, np.int32)).to(dev),
    )
    k_out = compute_selector_matches(*k1_in)
    p_out = selector_match_plain(*k1_in)
    n, w = compiled.id_bits.shape
    s, cps, _ = compiled.conj_req.shape
    b_ms, b_by = bound(nbytes(*k1_in, k_out), 2 * 2 * n * (w * 32) * s * cps)
    rows.append(dict(
        name="selector_match", source="cilium_tpu_torch/csrc/selector_match.cu",
        replaces="cilium_tpu/ops/bitmap.py:57", err=max_abs_err(k_out, p_out),
        ms=cuda_ms(lambda: compute_selector_matches(*k1_in)),
        plain_ms=cuda_ms(lambda: selector_match_plain(*k1_in), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"id_bits [{n},{w}], conj [{s},{cps},{w}]",
    ))

    # K2 bool_mm at the sweep's largest product: [1024, S] x [S, S], the
    # deny product with its complemented left operand
    t_in = device.ingress
    peer8 = unpack_bits_u32(device.sel_match[:1024])
    k_out = bool_mm(peer8, t_in.deny_t, complement_x=True)
    p_out = bool_mm_plain(peer8, t_in.deny_t, complement_x=True)
    comp = (1 - peer8).contiguous()
    bm, ba = comp.shape
    bc = t_in.deny_t.shape[1]
    # yardstick only: torch._int_mm (int8 tensor cores), thresholded
    lib_out = torch._int_mm(comp, t_in.deny_t) > 0
    if max_abs_err(lib_out, k_out):
        fail("bool_mm disagrees with the library product")
    b_ms, b_by = bound(nbytes(peer8, t_in.deny_t, k_out), 2 * bm * ba * bc)
    rows.append(dict(
        name="bool_mm", source="cilium_tpu_torch/csrc/bool_mm.cu",
        replaces="cilium_tpu/ops/verdict.py:151", err=max_abs_err(k_out, p_out),
        ms=cuda_ms(lambda: bool_mm(peer8, t_in.deny_t, complement_x=True)),
        plain_ms=cuda_ms(lambda: bool_mm_plain(peer8, t_in.deny_t, complement_x=True), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch._int_mm(comp, t_in.deny_t)),
        shape=f"[{bm},{ba}] x [{ba},{bc}], library torch._int_mm",
    ))

    # K3 lpm_wide over the batch: identity trie (flat) and the fused trie
    peer = torch.from_numpy(ips.view(np.int32)).to(dev)
    for name, prefix in (("no-prefilter", "ip"), ("prefilter", "merged")):
        t = pipes[name]._tables[TRAFFIC_INGRESS]
        tabs = [getattr(t, f"{prefix}_{f}") for f in ("root_info", "root_child", "sub_child", "sub_info")]
        k_out = lpm_lookup_wide(*tabs, peer)
        p_out = lpm_wide_plain(*tabs, peer)
        b_ms, b_by = bound(lpm_touched_bytes(tabs[0], tabs[1], tabs[3], peer), 0)
        rows.append(dict(
            name="lpm_wide", source="cilium_tpu_torch/csrc/lpm_wide.cu",
            replaces="cilium_tpu/ops/lpm.py:346", err=max_abs_err(k_out, p_out),
            ms=cuda_ms(lambda: lpm_lookup_wide(*tabs, peer)),
            plain_ms=cuda_ms(lambda: lpm_wide_plain(*tabs, peer), iters=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"{BATCH} addresses, {prefix} trie sub_info {list(tabs[3].shape)}",
        ))

    # K4 policymap_verdict over the batch with the prefilter run's rows
    t = pipes["prefilter"]._tables[TRAFFIC_INGRESS]
    packed = lpm_lookup_wide(t.merged_root_info, t.merged_root_child, t.merged_sub_child,
                             t.merged_sub_info, peer)
    denied = (packed & (1 << 30)) != 0
    hit = packed & ((1 << 30) - 1)
    src_rows = torch.where(hit > 0, hit - 1, t.world_row).to(torch.int32)
    flow_t = [torch.from_numpy(a).to(dev) for a in (eps, dports, protos)]
    pm = t.policymap
    k_v, k_r, k_c = policymap_verdict(pm, src_rows, *flow_t, denied_pf=denied, ep_count=N_ENDPOINTS)
    p_v, p_r, p_c = policymap_verdict_plain(pm, src_rows, *flow_t, denied_pf=denied, ep_count=N_ENDPOINTS)
    err = max(max_abs_err(k_v, p_v), max_abs_err(k_r, p_r), max_abs_err(k_c, p_c))
    b_ms, b_by = bound(
        nbytes(pm.id_bits, pm.col_ep, pm.col_port, pm.col_proto, pm.col_is_l3, src_rows,
               *flow_t, denied, k_v, k_r, k_c), 0)
    rows.append(dict(
        name="policymap_verdict", source="cilium_tpu_torch/csrc/policymap_verdict.cu",
        replaces="cilium_tpu/ops/lookup.py:146", err=err,
        ms=cuda_ms(lambda: policymap_verdict(pm, src_rows, *flow_t, denied_pf=denied,
                                             ep_count=N_ENDPOINTS)),
        plain_ms=cuda_ms(lambda: policymap_verdict_plain(pm, src_rows, *flow_t, denied_pf=denied,
                                                         ep_count=N_ENDPOINTS), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{BATCH} flows, id_bits {list(pm.id_bits.shape)}, {pm.col_ep.shape[0]} columns",
    ))

    # one JSON entry per kernel: lpm_wide keeps the identity walk's
    # numbers and the larger error of its two checks
    by_name = {}
    for r in rows:
        if r["name"] in by_name:
            by_name[r["name"]]["err"] = max(by_name[r["name"]]["err"], r["err"])
        else:
            by_name[r["name"]] = dict(r)
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{median(r['library_ms'])!r} {r['library_ms']}"
        print(f"kernel {r['name']:<18} {r['shape']}: launches {launches[r['name']]}, "
              f"max_abs_err {r['err']}, ms {median(r['ms'])!r} {r['ms']}, "
              f"plain_ms {median(r['plain_ms'])!r} {r['plain_ms']}, library_ms {lib}, "
              f"bound_ms {r['bound_ms']!r} ({r['bound_by']}) [{card}]",
              flush=True)
        if r["err"] != 0:
            fail(f"kernel {r['name']} disagrees with its plain version")
    torch.cuda.synchronize()

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[r["name"]],
            "max_abs_err": r["err"], "ms": median(r["ms"]),
            "plain_ms": median(r["plain_ms"]), "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None if r["library_ms"] is None else median(r["library_ms"]),
        }
        for r in by_name.values()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
