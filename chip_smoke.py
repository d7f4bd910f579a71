"""Smoke run of cilium_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

1. Builds the port's CUDA kernels (csrc/*.cu → build/cilium_tpu_torch/)
   and holds every kernel against its plain version on shapes the main
   paths do not reach (ragged sizes, the 16-8-8 trie, out-of-range trie
   bytes and child ids, wide policymaps, global-atomic histograms).
2. Builds the headline deployment of bench.py with the port's own
   modules: 10 000 rules over 512 apps (30% with an L4 port), 2 048
   identities with one /32 and one fd00::{hi}:{lo}/128 ipcache entry
   each (bench.py:588-593), 64 endpoints.
3. Drives three main paths, every launch count set to 0 just before
   each and read just after; each fails unless its kernels launched:
   - v4: PolicyEngine.refresh → DatapathPipeline.rebuild → process()
     of 1 048 576-flow batches, once with an empty prefilter (identity
     walk only) and once with the four bench prefilter CIDRs plus two
     IPv6 deny prefixes (the fused deny+identity walks);
   - v6: process_v6() of a 1 048 576-flow IPv6 batch (1/16 of the
     peers in 2001:db8::/32, the world) on both pipelines: the elided
     identity walk (K = 13 shared bytes, 3 levels) and the fused walk;
   - attribution: set_attribution(True) on the prefilter pipeline, then
     one v4 and one v6 batch (the attribution sweep, the first-rule
     reductions and the policymap kernel's attribution entry).
4. Holds 65 536 flows of each v4 and v6 run against the same path run
   with device="cpu" (the plain PyTorch versions) and 400 against the
   host oracle Repository.allows_ingress plus prefilter membership;
   holds the attribution (rule, l4_covered, rule hits, counters and the
   rule_hits_total / drop_reasons_total deltas) of 16 384 flows of each
   family against a CPU pipeline over the first four endpoints, and
   explain_one against the CPU engine; then a small world with deny and
   L7 rules, where every attribution reason code must occur on the card.
4d. The L7 main path, launch counts from zero (L7DeviceBatch off, then
   on; the off half must launch no fused or pair walk):
   - a 3-field HTTP policy at the pattern cap (7 methods, 64 path
     patterns, one of them demoted to host re, 3 hosts; fused Q 735, K7
     only): HTTPPolicy.check_batch of 131 072 requests, paths longer
     than 128 and 256 among them;
   - Kafka (bench.py:290-308): 32 produce rules, 100 000 requests
     through Proxy.check_kafka (the literal walk on K8 at rung 3), and
     handle_kafka_bytes on produce frames with allowed and rejected
     topics;
   - the redirect path: the bench world again with every port-80 rule
     carrying HTTP rules of the bench's L7 corpus, refreshed and rebuilt;
     process() of the v4 batch, redirects built from resolve_l4_policy
     for every endpoint, and one HTTP request per redirected flow of an
     HTTP batch (131 072 port-80 flows to the redirecting peers) through
     Proxy.check_http.
   Each is held against the port's CPU path (a slice) and re.fullmatch
   of the rules (400 requests), on and off.
4e. The services+CT main path, launch counts from zero: the bench world
   plus one egress rule per endpoint app (pods of zones z0-z3 on the
   service ports; the bench world alone has no egress rule, so every
   egress flow would drop), a ServiceManager with 1 024 v4 ClusterIP
   frontends in 10.96.0.0/16 and 256 v6 ones in fd00:96::/112 (1-8
   backends at bench identity addresses, weights on a quarter, 16 v4
   and 4 v6 with no backend, ANY frontends on a specific one's VIP and
   port) and a FlowConntrack of 2^22 slots. Each family runs four
   1 048 576-flow batches through process() / process_v6() with sports:
   egress pass 1 (1/4 to the frontends; LB stage on K9, miss tail, CT
   creation), pass 2 (the same batch: admitted flows bypass, only the
   rest reach K4), the replies from each flow's backend with the ports
   flipped and return_rev_nat=True, and an overlay batch (1/8 of the
   lanes carry tunnel identities, half unknown). Host-clock times of
   each pass and its stages (LB stage, CT lookup, miss tail, CT create).
   Checks: K9 launches once per egress batch, pass 2 dispatches exactly
   the flows pass 1 did not admit, replies of admitted flows forward
   with their services' revNAT ids, and 400 translated flows of each
   family against Repository.allows_egress for the backend's identity
   and port; then the first 65 536 flows of each sequence on a CPU
   pipeline (its own conntrack) and on the card: outputs, counters and
   live CT keys after every pass.
4f. The device-CT main path, launch counts from zero: the services
   world with no LB (an LB table sends a family to the host CT), as
   DatapathPipeline(engine, cache, pf, device_ct_bits=22), and per
   family four 1 048 576-flow passes: egress pass 1 and the same batch
   again (K3 / K5, K4 without counters, both K10 entries), the replies
   from each flow's destination (without LB, the peer itself) with the
   ports swapped, and the overlay batch, which must take the host CT
   fallback (no K10 launch). Host-clock times beside the host-CT
   pipeline's passes of 4e; admitted, inserted, lost, established
   counts. Checks: nothing is established on the fresh table, no flow
   whose policy verdict is a drop comes back established, pass 2
   establishes exactly the flows whose keys pass 1 inserted, every
   reply of an inserted flow forwards; then the first 65 536 flows of
   each sequence on a CPU pipeline (device="cpu", same device_ct_bits,
   time.monotonic pinned for both) and on the card: outputs, counters,
   the device table slot by slot and the host CT keys after every pass.
5. Holds every kernel against its plain version on the card, at the
   main paths' shapes, with exact equality (all outputs are integers),
   and times kernel, plain version and, where one exists, a library
   call computing the same function (CUDA events: the median of five
   runs' per-launch means, after 50 ms of warm-up launches), printing
   the SM clock (nvidia-smi clocks.sm) right after each timed series.
   The attribution flow-route sweep (_sweep_device_attrib, on K2 + K6)
   is timed the same way, its plain version with the plain K2 / K6, and
   so is the plain flow-route sweep (_sweep_device, off the main paths).
   K7 (both entries) and K8 are timed on the bench's L7 corpus
   (bench.py:266-430: 16 path patterns, 131 072 requests) at every
   length rung, and K7 on the pattern-cap policy's fused table. K9 is
   timed on each family's pass-1 batch (1 048 576 flows x 1 024 / 256
   frontends), its bound the int32 compares of a first-match scan on
   the CUDA cores. K10 (both entries and the verdict tail) is timed on
   each family's pass-1 inputs over a fresh table (insert-heavy) and
   its pass-2 inputs over the table pass 2 saw (hit-heavy), its bound
   the 32-byte sectors its probe windows touch in the seven arrays.

Prints the card's name and power limit, one JSON line with every
kernel's numbers and, last, the result line
{"ok": true, "device": {...}}. Any failure exits non-zero before that
line. Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
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
V6_DENY = ["fd00::3:0/120", "fd00::5:10/124"]
N_ATTR_EPS = 4  # endpoints of the CPU pipeline the attribution slice is held against
ATTR_SLICE = 1 << 14
# L7 (bench.py:266-430 and :290-308): the 16-pattern path corpus, its
# 131 072-request batch, the 32-topic Kafka ACL and its 100 000 requests
L7_PATHS = [f"/api/v{i}/[a-z0-9]*" for i in range(8)] + [f"/svc{i}/.*" for i in range(8)]
L7_BATCH = 1 << 17
KAFKA_REQS = 100_000
L7_SLICE = 1 << 13  # requests of the pattern-cap policy held against the CPU path
N_L7_CPU_EPS = 4  # endpoints whose redirects are held against the CPU path

# services+CT (the LB stage's K9 and the host conntrack): frontends per
# family, the ports they take, conntrack slots (a load of 0.25 at 1M flows)
N_FE4, N_FE6 = 1024, 256
SVC_PORTS = [(80, "TCP"), (443, "TCP"), (8080, "TCP"), (5432, "TCP"), (53, "UDP")]
CT_BITS = 22

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# int8 tensor-core operations/s; int32 operations/s on the CUDA cores
# (the Hopper white paper's 64 INT32 lanes per SM x 132 SMs x 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_world(seed: int, l7: bool = False):
    """bench.py build_world (10k rules / 2 048 identities) with the
    port's modules; rule and identity draws from ``random.Random(seed)``.
    With ``l7`` every port-80 rule also carries one to three HTTP rules
    over the bench's L7 corpus (bench.py:2416-2422: the eight
    /api/v{i}/[a-z0-9]* and eight /svc{i}/.* paths), half of them with
    a method (GET or POST), drawn from a second generator so that the
    rules, identities and endpoints are the same as without it."""
    from cilium_tpu_torch.identity import IdentityRegistry
    from cilium_tpu_torch.ipcache.ipcache import IPCache
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.api import (
        EndpointSelector, HTTPRule, IngressRule, L7Rules, PortProtocol, PortRule, rule,
    )
    from cilium_tpu_torch.policy.repository import Repository

    rng = random.Random(seed)
    hrng = random.Random(seed + 80)

    def l7_rules(port):
        if not l7 or port != 80:
            return L7Rules()
        return L7Rules(http=tuple(
            HTTPRule(method=hrng.choice(["GET", "POST"]) if hrng.random() < 0.5 else "", path=p)
            for p in hrng.sample(L7_PATHS, hrng.randint(1, 3))))
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
                to_ports=(PortRule(ports=(PortProtocol(port, proto),), rules=l7_rules(port)),),
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
        cache.upsert(f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128", ident.id, source="k8s")
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


def make_flows6(seed: int, n_idents: int):
    """A v6 batch: peers fd00::{hi}:{lo} over the identities, 1/16 of
    them random addresses in 2001:db8::/32 (the world); ``i_sel`` is -1
    for a world peer."""
    import numpy as np

    nrng = np.random.default_rng(seed + 6)
    i_sel = nrng.integers(0, n_idents, BATCH)
    world = nrng.random(BATCH) < 1 / 16
    addr = np.zeros((BATCH, 16), np.int32)
    addr[:, 0] = 0xFD
    addr[:, 13] = (i_sel >> 8) & 255
    addr[:, 15] = i_sel & 255
    addr[world] = nrng.integers(0, 256, (int(world.sum()), 16))
    addr[world, :4] = (0x20, 0x01, 0x0D, 0xB8)
    i_sel = np.where(world, -1, i_sel)
    eps = nrng.integers(0, N_ENDPOINTS, BATCH).astype(np.int32)
    dports = nrng.choice(np.array([80, 443, 8080, 53, 22], np.int32), BATCH)
    protos = np.where(dports == 53, 17, 6).astype(np.int32)
    return addr, eps, dports.astype(np.int32), protos, i_sel


def sm_clock() -> str:
    """The SM clock right now (nvidia-smi clocks.sm)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "?"


def timed(fn, **kw):
    """(cuda_ms of fn, the SM clock read right after the timed runs)."""
    ms = cuda_ms(fn, **kw)
    return ms, sm_clock()


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


def graph_ms(fn, launches: int = 20, reps: int = 5):
    """Per-launch device time (ms) of ``fn`` without the wrapper's host
    work: ``launches`` calls captured in one CUDA graph, whose replays
    are timed as ``cuda_ms`` times calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    torch.cuda.synchronize()
    return [ms / launches for ms in cuda_ms(g.replay, iters=5, reps=reps)]


def median(xs):
    return xs[len(xs) // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int, ops_per_s: float = INT8_OPS_PER_S):
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
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


def stride8_touched_bytes(child, info, common, addr, levels: int) -> int:
    """Bytes the elided stride-8 walk must move for these addresses:
    each address's int32 bytes up to where its walk stops (the K
    compare ends at the first mismatch), one int32 out per address, the
    K common bytes, and the distinct (node, byte) cells it reaches (info
    and child, 4 bytes each)."""
    import torch

    b = addr.shape[0]
    k = common.shape[0]
    m = info.shape[0]
    reads = torch.zeros(b, dtype=torch.int64, device=addr.device)
    alive = torch.ones(b, dtype=torch.bool, device=addr.device)
    for j in range(k):
        reads += alive.long()
        alive &= addr[:, j] == common[j]
    node = torch.zeros(b, dtype=torch.int64, device=addr.device)
    cells = []
    flat_c = child.reshape(-1)
    for lvl in range(k, levels):
        reads += alive.long()
        byte = addr[:, lvl].long()
        alive &= (byte >= 0) & (byte < 256)
        flat = node * 256 + byte
        cells.append(flat[alive])
        nxt = flat_c[torch.where(alive, flat, 0)].long()
        alive &= (nxt > 0) & (nxt < m)
        node = torch.where(alive, nxt, node)
    n_cells = torch.unique(torch.cat(cells)).numel() if cells else 0
    return 4 * (int(reads.sum()) + b + k) + 8 * n_cells


def sweep_ops(t, n_flows: int) -> int:
    """int8 multiply-adds ×2 of the flow-route sweep's products for
    ``n_flows`` flows: deny and allow [S, S], s1 / en / ee [S, K1], p1
    [P4, K1], gpn / gpe [S, G], s7 [S, K7], p7 [P4, K7], g7 [G, K7]."""
    s = t.deny_t.shape[0]
    k1 = t.s1_mat.shape[1]
    p4 = t.p1_mat.shape[0]
    g = t.gpn_mat.shape[1]
    k7 = t.s7_mat.shape[1]
    per = 2 * s * s + 3 * s * k1 + p4 * k1 + 2 * s * g + s * k7 + p4 * k7 + g * k7
    return 2 * n_flows * per


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


def oracle_check6(repo, reg, labels_of, idents, pipe_name, addr, eps, dports, protos,
                  i_sel, verdicts, denied_net, endpoints):
    """Hold N_ORACLE v6 flows against Repository.allows_ingress (world
    peers carry the reserved:world labels) and the v6 deny prefixes."""
    from cilium_tpu_torch.identity.model import ID_WORLD
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.search import Decision, PortContext, SearchContext

    world_labels = reg.get(ID_WORLD).labels
    for i in range(N_ORACLE):
        ip = ipaddress.IPv6Address(bytes(int(x) for x in addr[i]))
        if any(ip in net for net in denied_net):
            want = 3
        else:
            subj = parse_label_array(labels_of[endpoints[int(eps[i])]])
            j = int(i_sel[i])
            peer = world_labels if j < 0 else parse_label_array(labels_of[idents[j].id])
            pc = PortContext(int(dports[i]), "UDP" if int(protos[i]) == 17 else "TCP")
            ok = repo.allows_ingress(SearchContext(src=peer, dst=subj, dports=(pc,)))
            want = 1 if ok == Decision.ALLOWED else 2
        if int(verdicts[i]) != want:
            fail(f"{pipe_name} v6: flow {i} ({ip}) verdict {int(verdicts[i])}, oracle {want}")


def edge_checks2(dev) -> None:
    """K5, K6 and K4's attribution entry against their plain versions,
    exact, on shapes the main paths do not reach: K5 over a 4-level and a
    16-level trie with no elision, bytes outside [0, 255] and child ids
    outside [1, M); K6 with ragged row widths, empty rows and NO_RULE
    entries; K4's attribution entry over 1 280 columns (several staged
    chunks) with 2 100 endpoints and 40 000 rules (global-atomic
    counters and hits) and with 64 endpoints and 300 rules (shared)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.ops.lookup import PolicymapTables, policymap_verdict, policymap_verdict_plain
    from cilium_tpu_torch.ops.lpm import build_trie, build_trie_elided, elided_lookup, lpm_stride8_plain
    from cilium_tpu_torch.ops.verdict import NO_RULE, first_rule, first_rule_plain

    rs = np.random.default_rng(4321)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for ipv6 in (False, True):
        size = 16 if ipv6 else 4
        base = int(ipaddress.ip_address("fd00::" if ipv6 else "10.0.0.0"))
        prefixes = [("::/0" if ipv6 else "0.0.0.0/0", 1)]
        for j in range(3000):
            plen = int(rs.choice([8, 16, 24, 32, 48, 64, 100, 120, 128] if ipv6 else [8, 12, 16, 20, 24, 28, 32]))
            a = base + int(rs.integers(0, 1 << (20 if not ipv6 else 40)))
            prefixes.append((str(ipaddress.ip_network((a, plen), strict=False)), j + 2))
        child, info = build_trie(prefixes, ipv6=ipv6)
        child[rs.random(child.shape) < 0.002] = child.shape[0] + 5  # out-of-range child ids
        child[rs.random(child.shape) < 0.002] = -3
        addr = np.array([list((base + int(rs.integers(0, 1 << 20))).to_bytes(size, "big"))
                         for _ in range(20000)], np.int32)
        addr[rs.random(addr.shape) < 0.03] = rs.choice(np.array([-1, 256, 1 << 20], np.int32))
        tabs = [t(child), t(info), t(np.zeros(0, np.int32)), t(addr)]
        if max_abs_err(elided_lookup(*tabs, size), lpm_stride8_plain(*tabs, size)):
            fail(f"lpm_stride8 disagrees on a {size}-level trie with out-of-range bytes")
    child, info, common = build_trie_elided([(f"fd00::{j:x}:0/112", j) for j in range(300)])
    if common.shape[0] == 0:
        fail("the elided edge trie kept no shared bytes")
    addr = np.zeros((5000, 16), np.int32)
    addr[:, 0] = 0xFD
    addr[:, 12:14] = rs.integers(0, 2, (5000, 2))
    addr[:, 13] = rs.integers(0, 300, 5000) & 255
    addr[rs.random(5000) < 0.2, 1] = 7  # differs in the elided bytes
    tabs = [t(child), t(info), t(common), t(addr)]
    if max_abs_err(elided_lookup(*tabs, 16), lpm_stride8_plain(*tabs, 16)):
        fail("lpm_stride8 disagrees on the elided compare")

    for b, s in ((777, 1), (777, 31), (4099, 33), (8192, 700)):
        mask = t(rs.random((b, s)) < 0.02)
        rule_of = rs.integers(0, 10**6, s).astype(np.int32)
        rule_of[rs.random(s) < 0.3] = NO_RULE
        if max_abs_err(first_rule(mask, t(rule_of)), first_rule_plain(mask, t(rule_of))):
            fail(f"first_rule disagrees on [{b}, {s}]")

    n_rows, words, b = 300, 80, 50_000  # 1 280 columns
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
    for eps, n_rules in ((64, 300), (2100, 40_000)):
        rule_tab = t(np.where(rs.random((n_rows, c)) < 0.7,
                              rs.integers(0, n_rules + 50, (n_rows, c)), -1).astype(np.int32))
        for pf in (None, denied):
            got = policymap_verdict(pm, *flows, denied_pf=pf, ep_count=eps, rule_tab=rule_tab,
                                    n_rules=n_rules)
            want = policymap_verdict_plain(pm, *flows, denied_pf=pf, ep_count=eps,
                                           rule_tab=rule_tab, n_rules=n_rules)
            if any(max_abs_err(g, w_) for g, w_ in zip(got, want)):
                fail(f"policymap_verdict (attribution) disagrees on {c} columns / {eps} "
                     f"endpoints / {n_rules} rules")
    torch.cuda.synchronize()


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


def build_small_world(seed: int):
    """A small world with deny (from_requires), L4 and L7-HTTP rules in
    both directions, where every attribution reason code occurs: 40
    rules over 8 apps, 48 identities with one /32 and one /128 each."""
    from cilium_tpu_torch.identity import IdentityRegistry
    from cilium_tpu_torch.ipcache.ipcache import IPCache
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.api import (
        EgressRule, EndpointSelector, HTTPRule, IngressRule, L7Rules, PortProtocol, PortRule,
        rule,
    )
    from cilium_tpu_torch.policy.repository import Repository

    rng = random.Random(seed)
    apps = [f"k8s:app=s{i}" for i in range(8)]
    envs = ["k8s:env=prod", "k8s:env=dev"]

    def port_rule():
        port = rng.choice([80, 443, 8080, 53])
        proto = "UDP" if port == 53 else "TCP"
        l7 = L7Rules()
        if proto == "TCP" and rng.random() < 0.5:
            l7 = L7Rules(http=(HTTPRule(method="GET", path="/api/.*"),))
        return PortRule(ports=(PortProtocol(port, proto),), rules=l7)

    rules = []
    for i in range(40):
        peer = EndpointSelector.make([rng.choice(apps)])
        ing = IngressRule(
            from_endpoints=(peer,),
            from_requires=((EndpointSelector.make([rng.choice(envs)]),) if rng.random() < 0.25 else ()),
            to_ports=((port_rule(),) if rng.random() < 0.6 else ()),
        )
        eg = EgressRule(to_endpoints=(EndpointSelector.make([rng.choice(apps)]),),
                        to_ports=((port_rule(),) if rng.random() < 0.5 else ()))
        rules.append(rule([rng.choice(apps)], labels=[f"k8s:policy=small{i}"],
                          ingress=[ing], egress=[eg] if rng.random() < 0.5 else []))
    repo = Repository()
    repo.add_list(rules)
    reg = IdentityRegistry()
    cache = IPCache()
    idents = []
    for i in range(48):
        labels = [rng.choice(apps), rng.choice(envs), f"k8s:uid=s{i}"]
        ident = reg.allocate(parse_label_array(labels))
        idents.append(ident)
        cache.upsert(f"172.16.0.{i + 1}/32", ident.id, source="k8s")
        cache.upsert(f"fd00::9:{i + 1:x}/128", ident.id, source="k8s")
    return repo, reg, cache, idents


def build_redirects(repo, reg, proxy, ep_id: int, ep_labels, device) -> None:
    """One redirect per redirecting L4 filter of the endpoint, each with
    an HTTPPolicy / KafkaACL on ``device`` whose rules are scoped to the
    identities its peer selector matches: the logic of the JAX
    package's endpoint/endpoint.py:199-247 ``_update_redirects``, whose
    endpoint module the port does not have yet."""
    from cilium_tpu_torch.l7 import HTTPPolicy, KafkaACL
    from cilium_tpu_torch.policy.api import HTTPRule, KafkaRule

    l4 = repo.resolve_l4_policy(ep_labels)
    identities = list(reg)
    for direction_map, ingress in ((l4.ingress, True), (l4.egress, False)):
        for f in direction_map:
            if not f.is_redirect:
                continue
            http_rules, kafka_rules = [], []
            for sel, rules in f.l7_rules_per_ep.items():
                idents = None if sel.is_wildcard else {
                    i.id for i in identities if sel.matches(i.labels)}
                http_rules += [(hr, idents) for hr in rules.http]
                kafka_rules += [(kr, idents) for kr in rules.kafka]
                if not rules.http and not rules.kafka:
                    # wildcarded L7: this peer passes the proxy unrestricted
                    if f.l7_parser == "http":
                        http_rules.append((HTTPRule(), idents))
                    elif f.l7_parser == "kafka":
                        kafka_rules.append((KafkaRule(), idents))
            proxy.create_or_update_redirect(
                ep_id, f.port, f.l7_parser, ingress=ingress,
                http_policy=HTTPPolicy(http_rules, device=device) if f.l7_parser == "http" else None,
                kafka_acl=KafkaACL(kafka_rules, device=device) if f.l7_parser == "kafka" else None,
            )


def cap_policy_rules():
    """A 3-field HTTP policy at the pattern cap: 7 methods, 64 path
    patterns (the last one in syntax the DFA compiler refuses, so it is
    demoted to host re) and 3 host patterns, one rule per path."""
    from cilium_tpu_torch.policy.api import HTTPRule

    methods = ["GET", "POST", "PUT", "DELETE", "PATCH", "HEAD", "OPTIONS"]
    hosts = ["api[.]example[.]com", "[a-z]+[.]internal", "svc[0-9]+[.]local"]
    paths = ([f"/api/v{i % 8}/r{i}/[a-z0-9]*" for i in range(40)]
             + [f"/svc{i}/.*" for i in range(23)] + ["/legacy/(?:v1|v2)/.*"])
    return [(HTTPRule(method=methods[i % 7], path=p, host=hosts[i % 3] if i % 2 else ""), None)
            for i, p in enumerate(paths)]


def cap_requests(seed: int, n: int):
    """Requests for the pattern-cap policy: most aim at one rule's path
    with that rule's method and host three times in four; 1/16 of the
    paths are longer than 128 bytes and 1/32 longer than 256 (the host
    walk)."""
    import numpy as np

    from cilium_tpu_torch.l7 import HTTPRequest

    rs = np.random.default_rng(seed + 70)
    methods = ["GET", "POST", "PUT", "DELETE", "PATCH", "HEAD", "OPTIONS", "TRACE"]
    hosts = ["api.example.com", "db.internal", "svc12.local", "", "evil.com"]
    out = []
    for j, k, a, b, s_ in zip(rs.integers(0, 64, n).tolist(), rs.integers(0, 32, n).tolist(),
                              rs.integers(0, 32, n).tolist(), rs.integers(0, 32, n).tolist(),
                              rs.integers(256, 4096, n).tolist()):
        if k == 0:
            path = f"/svc{j % 23}/" + "b" * 300
        elif k < 3:
            path = f"/svc{j % 30}/" + "a" * 150
        elif k < 5:
            path = f"/legacy/v{j % 4}/x"
        elif k < 26:
            path = f"/api/v{j % 8}/r{j}/obj{k}" if j < 40 else f"/svc{j - 40}/up/{k}"
        elif k < 30:
            path = f"/api/v{(j + 1) % 8}/r{j}/x"
        else:
            path = "/nope"
        method = methods[j % 7] if a < 24 else methods[a % 8]
        host = hosts[j % 3] if b < 24 else hosts[b % 5]
        out.append(HTTPRequest(method=method, path=path, host=host, src_identity=s_))
    return out


def kafka_bench():
    """bench.py:290-308: 32 produce rules over topics t0..t31 and
    100 000 requests over t0..t47."""
    from cilium_tpu_torch.l7 import KafkaRequest
    from cilium_tpu_torch.policy.api import KafkaRule

    rules = [(KafkaRule(role="produce", topic=f"t{i}"), None) for i in range(32)]
    reqs = [KafkaRequest(api_key=0, api_version=2, client_id="c", topic=f"t{i % 48}")
            for i in range(KAFKA_REQS)]
    return rules, reqs


def produce_frame(client: str, topics, cid: int = 7) -> bytes:
    """A Kafka produce request frame (v0), built with the port's wire
    module's constants and string encoder."""
    import struct

    from cilium_tpu_torch.l7 import kafka_wire

    body = struct.pack(">hhi", kafka_wire.API_PRODUCE, 0, cid) + kafka_wire._w_str(client)
    body += struct.pack(">hi", 1, 30000) + struct.pack(">i", len(topics))
    for t in topics:
        body += kafka_wire._w_str(t) + struct.pack(">i", 1) + struct.pack(">ii", 0, 10) + b"\x00" * 10
    return struct.pack(">i", len(body)) + body


def http_oracle(pol, reqs):
    """re.fullmatch of a policy's rules (HTTPRule.matches) with their
    identity scopes, request by request."""
    import numpy as np

    return np.array([any(cr.rule.matches(q.method, q.path, q.host)
                         and (cr.allowed_identities is None
                              or q.src_identity in cr.allowed_identities)
                         for cr in pol._rules) for q in reqs], bool)


def dfa_touched_bytes(table, starts, sb, lens, max_len: int, pair: bool) -> int:
    """Bytes a DFA walk must move for these rows: the string bytes it
    walks (min(length, max_len) per row, at the batch's element size),
    each row's length and start (one start when ``starts`` holds one)
    and its two mask words, plus the distinct table entries the walks
    reach and the accept words of the distinct final states."""
    import torch

    b = sb.shape[0]
    state = starts.long().expand(b) if starts.numel() == 1 else starts.long()
    end = lens.long().clamp(max=max_len)
    alive = lens >= 0
    flat = table.reshape(-1)
    cells = []
    for lvl in range(0, max_len, 2 if pair else 1):
        step = alive & (lvl < end)
        if pair:
            b1 = sb[:, lvl + 1].long() if lvl + 1 < max_len else torch.zeros_like(state)
            b1 = torch.where(lvl + 1 < end, b1, 256)
            idx = (state * 257 + sb[:, lvl].long()) * 257 + b1
        else:
            idx = state * 256 + sb[:, lvl].long()
        idx = torch.where(step, idx, 0)
        cells.append(idx[step])
        state = torch.where(step, flat[idx].long(), state)
    n_cells = torch.unique(torch.cat(cells)).numel() if cells else 0
    n_final = torch.unique(state[alive]).numel()
    walked = int(end.clamp(min=0).sum())
    return (walked * sb.element_size() + b * (4 + 8) + 4 * starts.numel()
            + 4 * n_cells + 8 * n_final)


def edge_checks3(dev) -> None:
    """K7 (both entries) and K8 against their plain versions, exact, on
    shapes the main paths do not reach: random automata at every rung
    and at odd caps (3, 5, 17), uint8 and int32 bytes, batch widths
    wider than max_len, lengths -1 and past max_len (the pair walk
    reads no byte at or past max_len), starts outside [0, Q), int32
    bytes outside [0, 255], max_len 0, and an empty batch (no launch)."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops.dfa import (
        accept_words, dfa_match_batch, dfa_match_batch_fused, dfa_match_batch_pair,
        dfa_pair_walk_plain, dfa_walk_plain, fuse_dfas,
    )

    rs = np.random.default_rng(777)
    rng = random.Random(777)
    atoms = ["a", "b", "/", "[a-z]", "[0-9]", ".", "x+", "b*", "(ab|ba)", "c?", "[^a]"]

    def pats(n):
        return ["".join(rng.choice(atoms) for _ in range(rng.randrange(1, 6))) for _ in range(n)]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fused = fuse_dfas([compile_patterns(pats(rng.randrange(2, 8))) for _ in range(3)])
    if fused.pair is None:
        fail("the edge automata are too large for a pair table")
    lo, hi = (t(w) for w in accept_words(fused.accept))
    q = fused.n_states
    for max_len in (0, 3, 5, 16, 17, 32, 64, 128, 256):
        b = 20_000
        width = max_len + int(rs.integers(0, 5))
        for dtype in (np.uint8, np.int32):
            sb = rs.choice(np.frombuffer(b"ab/xyz019c\x00", np.uint8), (b, width)).astype(dtype)
            lens = rs.integers(-1, max_len + 6, b).astype(np.int32)
            starts = rs.choice(fused.starts, b).astype(np.int32)
            starts[rs.random(b) < 0.01] = q + 3
            starts[rs.random(b) < 0.01] = -2
            if dtype == np.int32:
                sb[rs.random(sb.shape) < 0.002] = rs.choice(np.array([-1, 256, 1 << 20], np.int32))
            args = (lo, hi, t(starts), t(sb), t(lens), max_len)
            for fn, plain, tab in ((dfa_match_batch_fused, dfa_walk_plain, fused.trans),
                                   (dfa_match_batch_pair, dfa_pair_walk_plain, fused.pair)):
                got, want = fn(t(tab), *args), plain(t(tab), *args)
                if any(max_abs_err(g, w) for g, w in zip(got, want)):
                    fail(f"{fn.__name__} disagrees at max_len {max_len}, {np.dtype(dtype).name} bytes")
            if max_abs_err(dfa_match_batch_pair(t(fused.pair), *args)[0],
                           dfa_match_batch_fused(t(fused.trans), *args)[0]):
                fail(f"the pair walk and the single-byte walk differ at max_len {max_len}")
            start = torch.tensor(int(fused.starts[1]), dtype=torch.int32, device=dev)
            got = dfa_match_batch(t(fused.trans), lo, hi, start, *args[3:])
            want = dfa_walk_plain(t(fused.trans), lo, hi, start.expand(b), *args[3:])
            if any(max_abs_err(g, w) for g, w in zip(got, want)):
                fail(f"dfa_match_batch disagrees at max_len {max_len}")
    before = _kernels.launches()
    empty = (lo, hi, t(np.zeros(0, np.int32)), t(np.zeros((0, 16), np.uint8)),
             t(np.zeros(0, np.int32)), 16)
    for fn, tab in ((dfa_match_batch_fused, fused.trans), (dfa_match_batch_pair, fused.pair)):
        if fn(t(tab), *empty)[0].shape != (0,):
            fail("an empty DFA batch returned rows")
    if _kernels.launches() != before:
        fail("an empty DFA batch launched a kernel")
    torch.cuda.synchronize()


def l7_main_path(seed: int, card: str, v4_flows, endpoints):
    """The L7 main path on the card (see 4d in the module docstring),
    L7DeviceBatch off and then on; returns what the CPU checks and the
    kernel rows need, and the launch counts of the off half."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath import l7_pipeline as l7rt
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.l7 import HTTPPolicy, HTTPRequest, KafkaACL
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.proxy import Proxy

    r = {}
    t0 = time.perf_counter()
    repo, reg, cache, idents, labels_of = build_world(seed, l7=True)
    engine = PolicyEngine(repo, reg)
    engine.refresh()
    pipe = DatapathPipeline(engine, cache)
    pipe.set_endpoints(endpoints)
    pipe.rebuild()
    torch.cuda.synchronize()
    _, red = pipe.process(*v4_flows)
    n_bench = int(red.sum())
    proxy = Proxy()
    for ep in endpoints:
        build_redirects(repo, reg, proxy, ep, parse_label_array(labels_of[ep]), None)
    n_redirects = len(proxy.redirects())
    # the HTTP batch: port-80 flows to endpoints with a port-80 redirect,
    # 7/8 of them from the peers its HTTP rules name (a peer that an
    # L3-only rule also allows is not redirected), 1/8 from any identity
    index_of = {ident.id: j for j, ident in enumerate(idents)}
    peers_of = {}
    for e, ep in enumerate(endpoints):
        rd = proxy.lookup(ep, 80, ingress=True)
        if rd is not None:
            ids = set().union(*(cr.allowed_identities or set() for cr in rd.http_policy._rules
                                if cr.rule.path or cr.rule.method))
            peers_of[e] = np.array(sorted(index_of[i] for i in ids if i in index_of))
    rs = np.random.default_rng(seed + 81)
    n_h = 2 * L7_BATCH
    ep_h = rs.choice(np.array(sorted(k for k, v in peers_of.items() if v.size)), n_h)
    pick = rs.integers(0, 1 << 30, n_h)
    j = np.array([peers_of[e][k % peers_of[e].size] for e, k in zip(ep_h.tolist(), pick.tolist())])
    j = np.where(rs.random(n_h) < 1 / 8, rs.integers(0, len(idents), n_h), j)
    ips_h = ((10 << 24) | ((j >> 8) & 255) << 16 | (j & 255) << 8 | 1).astype(np.uint32)
    http_flows = (ips_h, ep_h.astype(np.int32), np.full(n_h, 80, np.int32),
                  np.full(n_h, 6, np.int32))
    _, red_h = pipe.process(*http_flows)
    # one request per redirected flow: the bench batch's, then the HTTP batch's
    bench_idx = np.nonzero(red)[0]
    ep_r = np.concatenate([v4_flows[1][bench_idx], ep_h[red_h]])[:L7_BATCH]
    port_r = np.concatenate([v4_flows[2][bench_idx], np.full(int(red_h.sum()), 80)])[:L7_BATCH]
    ip_r = np.concatenate([v4_flows[0][bench_idx], ips_h[red_h]])[:L7_BATCH]
    j_r = ((ip_r.astype(np.int64) >> 16) & 255) << 8 | ((ip_r.astype(np.int64) >> 8) & 255)
    src_r = np.array([ident.id for ident in idents])[j_r]
    groups = {}
    for i, (e, port) in enumerate(zip(ep_r.tolist(), port_r.tolist())):
        groups.setdefault((endpoints[e], port), []).append(i)
    # half the requests take a path and method of one of the redirect's
    # rules, the rest any corpus path (and some past the 256-byte cap)
    methods, paths = [""] * ep_r.size, [""] * ep_r.size
    corpus = [f"/api/v{a}/obj{a}" for a in range(10)] + [f"/svc{a}/x/y" for a in range(10)]
    for (ep, port), sel in groups.items():
        rd = proxy.lookup(ep, port, ingress=True)
        own = [cr.rule for cr in rd.http_policy._rules] if rd is not None else []
        for i, a, b in zip(sel, rs.integers(0, 64, len(sel)).tolist(),
                           rs.integers(0, 1 << 30, len(sel)).tolist()):
            if own and a < 32:
                rule = own[b % len(own)]
                paths[i] = rule.path.replace("[a-z0-9]*", f"obj{a}").replace(".*", "x/y")
                methods[i] = rule.method or ["GET", "POST", "PUT"][a % 3]
            else:
                paths[i] = corpus[b % 20] if a < 60 else "/api/v1/" + "a" * 300
                methods[i] = ["GET", "POST", "PUT", "DELETE"][a % 4]
    reqs_d = [HTTPRequest(method=m, path=p_, src_identity=int(s_))
              for m, p_, s_ in zip(methods, paths, src_r)]
    t_setup = time.perf_counter() - t0
    print(f"main path l7 [redirect world]: {n_bench} of {BATCH} bench flows redirect "
          f"({int(red_h.sum())} of the {n_h}-flow HTTP batch), {n_redirects} redirects over "
          f"{len(endpoints)} endpoints, {len(groups)} (endpoint, port) groups of requests, "
          f"{ep_r.size} requests; world, refresh, rebuild, process and redirects "
          f"{t_setup!r}s [{card}]", flush=True)
    if n_bench <= 0 or ep_r.size < L7_BATCH // 4:
        fail("the redirect world sends too few flows through the proxy")

    pol_b = HTTPPolicy(cap_policy_rules())
    if not pol_b._paths.host_pids:
        fail("the pattern-cap policy demoted no pattern")
    reqs_b = cap_requests(seed, L7_BATCH)
    k_rules, k_reqs = kafka_bench()
    acl = KafkaACL(k_rules)
    rk = proxy.create_or_update_redirect(1 << 20, 9092, "kafka", kafka_acl=acl)
    frames = [produce_frame("c", ["t3"]), produce_frame("c", ["t40"]),
              produce_frame("c", ["t1", "t2"]), produce_frame("c", ["t5", "t33"]), b"\x00\x00"]
    # each state runs twice: the first pass of the on state builds and
    # uploads the fused (and pair) tables, the second is the steady state
    for on in (False, True):
        tag = "on" if on else "off"
        l7rt.set_device_batch(on)
        for rep in ("first", "second"):
            t0 = time.perf_counter()
            out_b = pol_b.check_batch(reqs_b)
            t_b = time.perf_counter() - t0
            t0 = time.perf_counter()
            out_c = np.asarray(proxy.check_kafka(rk, k_reqs))
            t_c = time.perf_counter() - t0
            out_f = [proxy.handle_kafka_bytes(rk, f, src_identity=5) for f in frames]
            allow = np.zeros(ep_r.size, bool)
            t0 = time.perf_counter()
            for (ep, port), sel in groups.items():
                rd = proxy.lookup(ep, port, ingress=True)
                if rd is None or rd.parser != "http":
                    fail(f"a redirected flow to ({ep}, {port}) has no HTTP redirect")
                allow[sel] = proxy.check_http(rd, [reqs_d[i] for i in sel])
            t_d = time.perf_counter() - t0
            if rep == "second" and not (np.array_equal(out_b, r[("b", tag)])
                                        and np.array_equal(out_c, r[("c", tag)])
                                        and out_f == r[("frames", tag)]
                                        and np.array_equal(allow, r[("d", tag)])):
                fail(f"L7: two passes with L7DeviceBatch {tag} disagree")
            r[("b", tag)], r[("c", tag)], r[("frames", tag)], r[("d", tag)] = (
                out_b, out_c, out_f, allow)
            print(f"main path l7 [L7DeviceBatch {tag}, {rep} pass]: pattern-cap check_batch "
                  f"{L7_BATCH} requests {t_b!r}s = {L7_BATCH / t_b!r} req/s "
                  f"({int(out_b.sum())} allowed); kafka check_kafka {KAFKA_REQS} requests "
                  f"{t_c!r}s = {KAFKA_REQS / t_c!r} req/s ({int(out_c.sum())} allowed); redirect "
                  f"check_http {ep_r.size} requests {t_d!r}s = {ep_r.size / t_d!r} req/s "
                  f"({int(allow.sum())} allowed); handle_kafka_bytes forward "
                  f"{[f for f, _ in out_f]} [{card}]", flush=True)
        if not on:
            r["off_launches"] = _kernels.launches()
    l7rt.set_device_batch(False)
    for part in ("b", "c", "d"):
        if not np.array_equal(r[(part, "on")], r[(part, "off")]):
            fail(f"L7 {part}: L7DeviceBatch on and off disagree on the card")
    if r[("frames", "on")] != r[("frames", "off")]:
        fail("handle_kafka_bytes: L7DeviceBatch on and off disagree on the card")
    if [f for f, _ in r[("frames", "on")]] != [True, False, True, False, False]:
        fail(f"handle_kafka_bytes forwarded {[f for f, _ in r[('frames', 'on')]]}")
    for part in ("b", "c", "d"):
        if not (r[(part, "on")].any() and not r[(part, "on")].all()):
            fail(f"L7 {part}: the requests are all allowed or all denied")
    r.update(pol_b=pol_b, reqs_b=reqs_b, k_rules=k_rules, k_reqs=k_reqs, frames=frames,
             proxy=proxy, groups=groups, reqs_d=reqs_d, repo=repo, reg=reg, labels_of=labels_of)
    return r


def l7_cpu_checks(r) -> None:
    """Hold the card's L7 results against the port's CPU path (the
    pattern-cap policy on its first L7_SLICE requests, the Kafka ACL on
    every request and frame, the redirects of the first N_L7_CPU_EPS
    endpoints that receive requests) and against re.fullmatch of the rules (400 requests of
    each HTTP policy), for L7DeviceBatch off and on."""
    import numpy as np

    from cilium_tpu_torch.datapath import l7_pipeline as l7rt
    from cilium_tpu_torch.l7 import HTTPPolicy, KafkaACL
    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.proxy import Proxy

    cpu_eps = []
    for ep, _port in r["groups"]:
        if ep not in cpu_eps and len(cpu_eps) < N_L7_CPU_EPS:
            cpu_eps.append(ep)
    cpu_pol = HTTPPolicy(cap_policy_rules(), device="cpu")
    cpu_acl = KafkaACL(r["k_rules"], device="cpu")
    cpu_proxy = Proxy()
    rk = cpu_proxy.create_or_update_redirect(1 << 20, 9092, "kafka", kafka_acl=cpu_acl)
    for ep in cpu_eps:
        build_redirects(r["repo"], r["reg"], cpu_proxy, ep,
                        parse_label_array(r["labels_of"][ep]), "cpu")
    n_d = 0
    try:
        for on in (False, True):
            tag = "on" if on else "off"
            l7rt.set_device_batch(on, device="cpu")
            got = cpu_pol.check_batch(r["reqs_b"][:L7_SLICE])
            if not np.array_equal(got, r[("b", tag)][:L7_SLICE]):
                fail(f"pattern-cap policy: card and CPU disagree (L7DeviceBatch {tag})")
            if not np.array_equal(np.asarray(cpu_proxy.check_kafka(rk, r["k_reqs"])), r[("c", tag)]):
                fail(f"kafka: card and CPU disagree (L7DeviceBatch {tag})")
            if [cpu_proxy.handle_kafka_bytes(rk, f, src_identity=5) for f in r["frames"]] != r[
                    ("frames", tag)]:
                fail(f"handle_kafka_bytes: card and CPU disagree (L7DeviceBatch {tag})")
            n_d = 0
            for (ep, port), sel in r["groups"].items():
                if ep not in cpu_eps:
                    continue
                rd = cpu_proxy.lookup(ep, port, ingress=True)
                got = cpu_proxy.check_http(rd, [r["reqs_d"][i] for i in sel])
                if not np.array_equal(got, r[("d", tag)][sel]):
                    fail(f"redirect ({ep}, {port}): card and CPU disagree (L7DeviceBatch {tag})")
                n_d += len(sel)
    finally:
        l7rt.set_device_batch(False)
    if n_d < 32:
        fail("the CPU slice of the redirect path holds too few requests")
    if not np.array_equal(http_oracle(r["pol_b"], r["reqs_b"][:N_ORACLE]),
                          r[("b", "on")][:N_ORACLE]):
        fail("pattern-cap policy: the card disagrees with re.fullmatch")
    checked = 0
    for (ep, port), sel in r["groups"].items():
        rd = r["proxy"].lookup(ep, port, ingress=True)
        sel = sel[:N_ORACLE - checked]
        if not np.array_equal(http_oracle(rd.http_policy, [r["reqs_d"][i] for i in sel]),
                              r[("d", "on")][sel]):
            fail(f"redirect ({ep}, {port}): the card disagrees with re.fullmatch")
        checked += len(sel)
        if checked >= N_ORACLE:
            break
    want = np.array([any(rule.matches(q.api_key, q.api_version, q.client_id, q.topic)
                         for rule, _ in r["k_rules"]) for q in r["k_reqs"][:N_ORACLE]])
    if not np.array_equal(want, r[("c", "on")][:N_ORACLE]):
        fail("kafka: the card disagrees with KafkaRule.matches")
    print(f"L7: card == CPU path (pattern-cap policy on {L7_SLICE} requests, kafka on "
          f"{KAFKA_REQS} and on the frames, the redirects of {N_L7_CPU_EPS} endpoints on {n_d} "
          f"requests) and == re.fullmatch / KafkaRule.matches on {N_ORACLE} requests each, "
          f"L7DeviceBatch off and on", flush=True)


def random_lb_case(rs, f: int, length: int, nb: int, b: int):
    """Random K9 inputs: frontends over a small pool of addresses and
    ports (ANY frontends beside specific ones), 1/8 with no backend,
    sequence lengths past the sequence width, sequence rows past the
    backend table and negative ones, half the flows aimed at a
    frontend, flow hashes of either sign."""
    import numpy as np
    import torch

    from cilium_tpu_torch.convert import lb_tables_from_numpy
    from cilium_tpu_torch.lb.device import MAX_SEQ

    pool = rs.integers(0, 256, (max(2, f // 3), length))
    fe_bytes = pool[rs.integers(0, pool.shape[0], f)]
    fe_port = rs.choice(np.array([53, 80, 443, 8080]), f)
    fe_proto = rs.choice(np.array([0, 6, 17]), f)
    fe_seq_len = rs.integers(1, MAX_SEQ + 1, f)
    fe_seq_len[rs.random(f) < 0.125] = 0
    fe_seq_len[rs.random(f) < 0.05] = MAX_SEQ + 7
    fe_seq = rs.integers(0, nb, (f, MAX_SEQ))
    wild = rs.random((f, MAX_SEQ)) < 0.1
    fe_seq[wild] = rs.integers(-2 * nb - 3, 2 * nb + 3, int(wild.sum()))
    tables = lb_tables_from_numpy(
        fe_bytes, fe_port, fe_proto, fe_seq, fe_seq_len, rs.integers(1, 65536, f),
        rs.integers(0, 256, (nb, length)), rs.integers(1, 65536, nb), device="cpu")
    pick = rs.integers(0, f, b)
    aim = rs.random(b) < 0.5
    peer = np.where(aim[:, None], fe_bytes[pick], rs.integers(0, 256, (b, length)))
    dport = np.where(aim, fe_port[pick], rs.choice(np.array([53, 80, 443, 22]), b))
    proto = np.where(rs.random(b) < 0.7, fe_proto[pick], rs.choice(np.array([6, 17]), b))
    proto = np.where(proto == 0, 6, proto)
    flows = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
        peer, dport, proto, rs.integers(-(2 ** 31), 2 ** 31, b))]
    return tables, flows


def edge_checks4(dev) -> None:
    """K9 lb_translate against its plain version, exact, on shapes the
    main path does not reach: F = 1, F = 1025 (past four 256-frontend
    tiles), B = 1 and ragged B, both address widths, ANY frontends
    shadowing specific ones, no-backend frontends, sequence rows past
    the backend table and negative, sequence lengths past the width,
    negative flow hashes, and an empty batch."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.lb.device import lb_translate, lb_translate_plain

    rs = np.random.default_rng(909)
    for length in (4, 16):
        for f, nb, b in ((1, 1, 1), (1, 3, 777), (2, 5, 1), (300, 40, 4099), (1025, 513, 1),
                         (1025, 513, 70_001), (5, 2, 0)):
            tables, flows = random_lb_case(rs, f, length, nb, b)
            got = lb_translate(dataclasses.replace(tables, **{
                fl.name: getattr(tables, fl.name).to(dev) for fl in dataclasses.fields(tables)}),
                *(x.to(dev) for x in flows))
            want = lb_translate_plain(tables, *flows)
            torch.cuda.synchronize()
            for name, g, w in zip(("new_bytes", "new_port", "revnat", "ok", "no_backend"),
                                  got, want):
                if max_abs_err(g.cpu(), w):
                    fail(f"K9 lb_translate edge F={f} NB={nb} B={b} L={length}: {name} differs")


def build_services_world(seed: int):
    """The bench world with egress rules, and its services.

    The bench world has ingress rules only, so under default deny every
    egress flow would drop and no connection would ever be tracked.
    One egress rule per distinct endpoint app lets the endpoints reach
    pods of zones z0-z3 (half the identities) on the service ports
    {80, 443, 8080, 5432}/TCP and 53/UDP.

    Services (a ServiceManager): N_FE4 IPv4 ClusterIP frontends in
    10.96.0.0/16 and N_FE6 IPv6 ones in fd00:96::/112, each on a port of
    {80, 443, 8080, 5432}/TCP or 53/UDP; 1-8 backends each at bench
    identity addresses (10.x.y.1 / fd00::{hi}:{lo}) on a port the rules
    name, weights 1-4 on a quarter of the frontends; 16 v4 and 4 v6
    frontends with no backend; 8 v4 and 2 v6 proto-ANY frontends on the
    VIP and port of a specific one (half of them added before it, so
    they come first in the table)."""
    from cilium_tpu_torch.lb import Backend, L3n4Addr, ServiceManager
    from cilium_tpu_torch.policy.api import EgressRule, EndpointSelector, PortProtocol, PortRule, rule

    repo, reg, cache, idents, labels_of = build_world(seed)
    apps = sorted({labels_of[idents[j].id][0] for j in range(N_ENDPOINTS)})
    to = tuple(EndpointSelector.make([f"k8s:zone=z{z}"]) for z in range(4))
    ports = (PortRule(ports=tuple(PortProtocol(p, pr) for p, pr in SVC_PORTS)),)
    repo.add_list([rule([a], egress=[EgressRule(to_endpoints=to, to_ports=ports)]) for a in apps])

    rng = random.Random(seed + 96)
    m = ServiceManager()
    for fam, n_fe, n_empty, n_any in ((4, N_FE4, 16, 8), (6, N_FE6, 4, 2)):
        n_spec = n_fe - n_any
        empty = set(rng.sample(range(n_spec), n_empty))
        shadow = rng.sample(range(n_spec), n_any)
        for i in range(n_spec):
            vip = (f"10.96.{(i + 1) >> 8}.{(i + 1) & 255}" if fam == 4
                   else f"fd00:96::{i + 1:x}")
            port, proto = rng.choice(SVC_PORTS)
            weighted = rng.random() < 0.25
            backs = []
            for _ in range(0 if i in empty else rng.randint(1, 8)):
                j = rng.randrange(len(idents))
                ip = (f"10.{(j >> 8) & 255}.{j & 255}.1" if fam == 4
                      else f"fd00::{(j >> 8) & 255:x}:{j & 255:x}")
                bport = 53 if proto == "UDP" else rng.choice([80, 443, 8080, 5432])
                backs.append(Backend(ip, bport, rng.randint(1, 4) if weighted else 1))
            any_fe = L3n4Addr(vip, port, "ANY")
            if i in shadow[: n_any // 2]:
                m.upsert(any_fe, backs[:1])
            m.upsert(L3n4Addr(vip, port, proto), backs)
            if i in shadow[n_any // 2:]:
                m.upsert(any_fe, backs[:1])
    return repo, reg, cache, idents, labels_of, m


def make_svc_flows(seed: int, fam: int, n_idents: int, manager):
    """A 1 048 576-flow egress batch: 3/4 the bench's flows, 1/4 to the
    family's frontends (an ANY frontend's flows TCP or UDP), sports
    uniform in 1024-60000. → (peer, ep, dport, proto, sport, peer bytes);
    ``peer`` is uint32 for v4 and the [B, 16] bytes for v6."""
    import numpy as np

    from cilium_tpu_torch.ops.lpm import ipv4_to_bytes, ipv6_to_bytes

    if fam == 4:
        ips, eps, dports, protos, _ = make_flows(seed + 40, n_idents)
        pb = ipv4_to_bytes(ips)
    else:
        pb, eps, dports, protos, _ = make_flows6(seed + 40, n_idents)
    nrng = np.random.default_rng(seed + 41 + fam)
    fes = [s.frontend for s in manager.list() if s.frontend.family == fam]
    fe_bytes = (ipv4_to_bytes(np.array([int(ipaddress.IPv4Address(f.ip)) for f in fes], np.uint32))
                if fam == 4 else ipv6_to_bytes([f.ip for f in fes]))
    vip = nrng.random(BATCH) < 0.25
    pick = nrng.integers(0, len(fes), BATCH)
    any_proto = nrng.choice(np.array([6, 17], np.int32), BATCH)
    fe_port = np.array([f.port for f in fes], np.int32)[pick]
    fe_proto = np.array([f.proto_num for f in fes], np.int32)[pick]
    pb = np.where(vip[:, None], fe_bytes[pick], pb).astype(np.int32)
    dports = np.where(vip, fe_port, dports).astype(np.int32)
    protos = np.where(vip, np.where(fe_proto == 0, any_proto, fe_proto), protos).astype(np.int32)
    sports = nrng.integers(1024, 60001, BATCH)
    peer = pack_u32(pb) if fam == 4 else pb
    return peer, eps, dports, protos, sports, pb


def pack_u32(pb):
    import numpy as np

    b = pb.astype(np.uint32)
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def lb_inputs(pipe, fam: int, pb, eps, dports, protos, sports):
    """The pipeline's LB stage inputs as tensors on its device: its
    tables and (peer bytes, dport, proto, flow hash over the stable
    endpoint ids)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.lb.device import flow_hash32

    ep_ids = np.asarray(pipe._endpoint_ids, np.int64)[eps]
    fh = flow_hash32(pb, sports, dports, protos, ep_ids)
    return pipe._lb_tables[fam], [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(pipe.device)
                                  for a in (pb, dports, protos, fh)]


def lb_scan_ops(t, peer, dport, proto) -> int:
    """int32 compares a first-match frontend scan cannot skip on these
    flows: one for each frontend it passes over, L + 2 (address bytes,
    port, protocol) for the one it stops at; all F for a flow that
    matches none."""
    import torch

    f, length = t.fe_bytes.shape
    total = 0
    for lo in range(0, peer.shape[0], 1 << 17):
        p, d, r = peer[lo:lo + (1 << 17)], dport[lo:lo + (1 << 17)], proto[lo:lo + (1 << 17)]
        m = (t.fe_bytes[None] == p[:, None]).all(-1) & (d[:, None] == t.fe_port[None])
        m &= (t.fe_proto[None] == 0) | (r[:, None] == t.fe_proto[None])
        hit = m.any(1)
        first = m.to(torch.int8).argmax(1)
        scanned = torch.where(hit, first + 1, f)
        total += int(scanned.sum()) + int(hit.sum()) * (length + 1)
    return total


def svc_sequence(pipe, fam: int, batch, reply, overlay, probe=None):
    """The services+CT sequence on one pipeline → [(v, r) pass 1,
    (v, r) pass 2, (v, r, revnat) replies, (v, r) overlay]. ``probe``
    is called after each pass with its index."""
    call = getattr(pipe, "process" if fam == 4 else "process_v6")
    out = []
    peer, eps, dports, protos, sports = batch
    for k in range(2):  # pass 1: all new; pass 2: the same flows again
        out.append(call(peer, eps, dports, protos, ingress=False, sports=sports))
        if probe:
            probe(k)
    out.append(call(*reply[:4], ingress=True, sports=reply[4], return_rev_nat=True))
    if probe:
        probe(2)
    out.append(call(*overlay[:4], ingress=True, sports=overlay[4], tunnel_identities=overlay[5]))
    if probe:
        probe(3)
    return out


class PhaseClock:
    """Host-clock time of the pipeline's stages, by wrapping the methods
    that run them: the LB stage, the CT lookup (the pre-pass), the miss
    tail's device dispatch and the CT creation. Records the size of each
    dispatch."""

    STAGES = (("lb", "pipe", "_lb_stage"), ("ct_prepass", "ct", "lookup_batch"),
              ("miss_tail", "pipe", "_dispatch"), ("ct_create", "ct", "create_batch"))

    def __init__(self, pipe):
        self.objs = {"pipe": pipe, "ct": pipe.conntrack}
        self.secs = {name: 0.0 for name, _, _ in self.STAGES}
        self.tails = []
        for name, owner, attr in self.STAGES:
            real = getattr(self.objs[owner], attr)

            def timed_call(*a, _real=real, _name=name, **k):
                if _name == "miss_tail":
                    self.tails.append(len(a[2]) if a[2] is not None else -1)
                t0 = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    self.secs[_name] += time.perf_counter() - t0

            setattr(self.objs[owner], attr, timed_call)

    def take(self):
        out = dict(self.secs)
        for k in self.secs:
            self.secs[k] = 0.0
        return out

    def close(self):
        for _name, owner, attr in self.STAGES:
            delattr(self.objs[owner], attr)


def ct_live_keys(ct):
    import numpy as np

    s = ct.snapshot_arrays()
    order = np.lexsort((s["kc"], s["kb"], s["ka"]))
    return {k: s[k][order] for k in ("ka", "kb", "kc", "revnat", "packets")}


def svc_oracle(repo, labels_of, idents, endpoints, fam, pb_new, new_port, eps, protos, ok,
               verdicts, seed):
    """Hold N_ORACLE translated flows of pass 1 against
    Repository.allows_egress for the backend's identity and port."""
    import numpy as np

    from cilium_tpu_torch.labels import parse_label_array
    from cilium_tpu_torch.policy.search import Decision, PortContext, SearchContext

    idx = np.nonzero(ok)[0]
    sample = np.random.default_rng(seed).choice(idx, min(N_ORACLE, idx.size), replace=False)
    n_allowed = 0
    for i in sample:
        hi, lo = (int(pb_new[i, 1]), int(pb_new[i, 2])) if fam == 4 else (int(pb_new[i, 13]),
                                                                        int(pb_new[i, 15]))
        peer = parse_label_array(labels_of[idents[hi * 256 + lo].id])
        subj = parse_label_array(labels_of[endpoints[int(eps[i])]])
        pc = PortContext(int(new_port[i]), "UDP" if int(protos[i]) == 17 else "TCP")
        allowed = repo.allows_egress(SearchContext(src=subj, dst=peer, dports=(pc,))) == Decision.ALLOWED
        n_allowed += allowed
        if int(verdicts[i]) != (1 if allowed else 2):
            fail(f"services v{fam}: translated flow {i} verdict {int(verdicts[i])}, oracle "
                 f"{'allow' if allowed else 'deny'} for backend identity {hi * 256 + lo} port "
                 f"{int(new_port[i])}")
    if not 0 < n_allowed < sample.size:
        fail(f"services v{fam}: the oracle sample is all one verdict ({n_allowed}/{sample.size})")
    return sample.size


def services_main_path(seed: int, card: str):
    """The services+CT main path on the card, both families; returns
    what the CPU checks and the K9 rows need."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import DROP_NO_SERVICE, FORWARD, DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.lb.device import lb_translate

    t0 = time.perf_counter()
    repo, reg, cache, idents, labels_of, manager = build_services_world(seed)
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]
    engine = PolicyEngine(repo, reg)
    pipe = DatapathPipeline(engine, cache, conntrack=FlowConntrack(capacity_bits=CT_BITS),
                            lb=manager)
    # stable endpoint ids (the flow hash's input) apart from identity ids
    pipe.set_endpoints([(10_000 + j, e) for j, e in enumerate(endpoints)])
    pipe.rebuild()
    torch.cuda.synchronize()
    print(f"services world: {len(repo.rules)} rules ({len(repo.rules) - N_RULES} egress), "
          f"{manager.version} service upserts, frontends v4 {pipe._lb_tables[4].fe_port.shape[0]} "
          f"/ v6 {pipe._lb_tables[6].fe_port.shape[0]}, backends v4 "
          f"{pipe._lb_tables[4].be_port.shape[0]} / v6 {pipe._lb_tables[6].be_port.shape[0]}, "
          f"CT {pipe.conntrack.capacity} slots, refresh + rebuild in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # inputs of every batch, made before the launch counts are reset: the
    # replies need each flow's backend, which K9 computes here
    seqs = {}
    nrng = np.random.default_rng(seed + 77)
    for fam in (4, 6):
        peer, eps, dports, protos, sports, pb = make_svc_flows(seed, fam, len(idents), manager)
        tabs, flows = lb_inputs(pipe, fam, pb, eps, dports, protos, sports)
        nb, npo, rv, ok, nobk = (x.cpu().numpy() for x in lb_translate(tabs, *flows))
        reply = (pack_u32(nb) if fam == 4 else nb, eps, sports.astype(np.int32), protos,
                 npo.astype(np.int64))
        tun = np.zeros(BATCH, np.int64)
        lanes = nrng.random(BATCH) < 1 / 8
        known = nrng.random(BATCH) < 0.5
        ids = np.array(endpoints + [i.id for i in idents], np.int64)
        tun[lanes & known] = ids[nrng.integers(0, ids.size, int((lanes & known).sum()))]
        tun[lanes & ~known] = 900_000 + nrng.integers(0, 1000, int((lanes & ~known).sum()))
        overlay = (peer, eps, dports, protos, nrng.integers(1024, 60001, BATCH), tun)
        seqs[fam] = dict(batch=(peer, eps, dports, protos, sports), pb=pb, reply=reply,
                         overlay=overlay, lb=(nb, npo, rv, ok, nobk))

    _kernels.reset_launches()
    clock = PhaseClock(pipe)
    res = {}
    pass_times = {}
    k4 = []
    for fam in (4, 6):
        s = seqs[fam]
        times, stages = [], []
        t_last = [time.perf_counter()]

        def probe(k):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.append(now - t_last[0])
            stages.append(clock.take())
            k4.append(_kernels.launches()["policymap_verdict"])
            t_last[0] = time.perf_counter()

        clock.tails.clear()
        before = _kernels.launches()["policymap_verdict"]
        k4.clear()
        out = svc_sequence(pipe, fam, s["batch"], s["reply"], s["overlay"], probe=probe)
        res[fam] = out
        pass_times[fam] = times
        (v1, r1), (v2, _r2), (vr, _rr, rev), (vo, _ro) = out
        nb, npo, rv, ok, nobk = s["lb"]
        admitted = (v1 == FORWARD) & ~r1
        want_tail = int((~admitted).sum())
        tails = list(clock.tails)
        print(f"main path services+CT v{fam} [{card}]: {BATCH} flows a pass, host clock "
              f"(torch.cuda.synchronize after each), n_ct {len(pipe.conntrack)}", flush=True)
        for name, dt, st in zip(("pass 1 (new)", "pass 2 (established)",
                                 "replies (revNAT)", "overlay"), times, stages):
            print(f"  {name}: {dt!r}s = {BATCH / dt!r} flows/s; stages {st}", flush=True)
        print(f"  verdicts pass 1 {np.bincount(v1, minlength=5)[1:].tolist()} (translated "
              f"{int(ok.sum())}, no backend {int(nobk.sum())}), pass 2 "
              f"{np.bincount(v2, minlength=5)[1:].tolist()}, replies "
              f"{np.bincount(vr, minlength=5)[1:].tolist()} (revNAT ids {int((rev != 0).sum())}),"
              f" overlay {np.bincount(vo, minlength=5)[1:].tolist()}; miss tails {tails}; "
              f"policymap_verdict launches after each pass {[x - before for x in k4]}", flush=True)
        if not (ok.any() and nobk.any() and admitted.any() and (~admitted).any()):
            fail(f"services v{fam}: pass 1 lacks translated, no-backend, admitted or denied flows")
        if not (v1[nobk] == DROP_NO_SERVICE).all() or (v1[~nobk] == DROP_NO_SERVICE).any():
            fail(f"services v{fam}: DROP_NO_SERVICE does not follow the no-backend flows")
        if tails[:2] != [BATCH, want_tail]:
            fail(f"services v{fam}: miss tails {tails[:2]}, expected [{BATCH}, {want_tail}]")
        if [x - before for x in k4[:2]] != [1, 2]:
            fail(f"services v{fam}: K4 launched {[x - before for x in k4[:2]]} on passes 1-2")
        if not ((v2 == v1) | admitted).all() or not (v2[admitted] == FORWARD).all():
            fail(f"services v{fam}: pass 2 differs from pass 1 outside the bypass")
        if not (vr[admitted] == FORWARD).all():
            fail(f"services v{fam}: a reply of an admitted flow was not forwarded")
        # an entry keeps the revNAT id of the first admitted flow with its
        # key: a direct flow to a backend can share its key with a flow
        # translated to that backend (same endpoint, sport, port)
        keys = np.concatenate([nb.astype(np.int64), np.stack(
            [s["batch"][1], s["batch"][4], npo, s["batch"][3]], 1).astype(np.int64)], 1)[admitted]
        _u, first, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
        want_rev = np.zeros(BATCH, np.uint16)
        want_rev[admitted] = rv[admitted][first][inv.reshape(-1)]
        shared = int((want_rev != np.where(admitted, rv, 0)).sum())
        if not np.array_equal(rev, want_rev) or not rev.any():
            fail(f"services v{fam}: reply revNAT ids differ from the services' ids")
        for i in np.nonzero(rev)[0][:8]:
            fe = pipe.rev_nat_frontend(int(rev[i]))
            if fe is None or fe.port != int(s["batch"][2][i]):
                fail(f"services v{fam}: rev_nat_frontend({int(rev[i])}) = {fe}")
        tun = s["overlay"][5]
        if not (vo[(tun > 0) & (tun < 900_000)] == FORWARD).any():
            fail(f"services v{fam}: no overlay flow with a trusted identity was forwarded")
        print(f"  replies: {int((rev != 0).sum())} revNAT ids, each its service's; {shared} "
              "flows share their key with an earlier admitted flow of another revNAT id",
              flush=True)
    clock.close()
    if _kernels.launches()["lb_translate"] != 4:
        fail(f"K9 launched {_kernels.launches()['lb_translate']} times, expected one per egress "
             "batch (4)")
    for fam in (4, 6):
        nb, npo, rv, ok, nobk = seqs[fam]["lb"]
        n = svc_oracle(repo, labels_of, idents, endpoints, fam, nb, npo, seqs[fam]["batch"][1],
                       seqs[fam]["batch"][3], ok, res[fam][0][0], seed + fam)
    print(f"services: translated flows == host oracle (allows_egress for the backend's identity "
          f"and port) on {n} flows of each family", flush=True)
    return dict(repo=repo, reg=reg, cache=cache, manager=manager, pipe=pipe, seqs=seqs,
                res=res, endpoints=endpoints, pass_times=pass_times)


def services_cpu_checks(r) -> None:
    """The first SLICE flows of each batch sequence on a CPU pipeline
    over the same world (its own conntrack) and on the card pipeline
    (conntrack flushed, counters zeroed): verdicts, redirects, revNAT
    ids, counters and live CT keys equal; and the card's full-batch
    results equal to the CPU's on those flows."""
    import numpy as np

    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine

    t0 = time.perf_counter()
    gpu = r["pipe"]
    cpu = DatapathPipeline(PolicyEngine(r["repo"], r["reg"], device="cpu"), r["cache"],
                           conntrack=FlowConntrack(capacity_bits=18), lb=r["manager"],
                           device="cpu")
    cpu.set_endpoints([(10_000 + j, e) for j, e in enumerate(r["endpoints"])])
    cpu.rebuild()
    s_ = slice(0, SLICE)
    for fam in (4, 6):
        q = r["seqs"][fam]
        args = [tuple(a[s_] for a in q[k]) for k in ("batch", "reply", "overlay")]
        gpu.conntrack.flush()
        gpu.counters[:] = 0
        runs = []
        for pipe in (gpu, cpu):
            state = []
            out = svc_sequence(pipe, fam, *args, probe=lambda k, pipe=pipe, state=state: state.append(
                (pipe.counters.copy(), ct_live_keys(pipe.conntrack))))
            runs.append((out, state))
        (g_out, g_state), (c_out, c_state) = runs
        for k in range(4):
            if not all(np.array_equal(a, b) for a, b in zip(g_out[k], c_out[k])):
                fail(f"services v{fam}: pass {k} outputs differ between card and CPU")
            if not np.array_equal(g_state[k][0], c_state[k][0]):
                fail(f"services v{fam}: counters after pass {k} differ between card and CPU")
            for key in g_state[k][1]:
                if not np.array_equal(g_state[k][1][key], c_state[k][1][key]):
                    fail(f"services v{fam}: live CT {key} after pass {k} differ between card "
                         "and CPU")
            # the full card batch, on its first SLICE flows
            for a, b in zip(r["res"][fam][k], c_out[k]):
                if not np.array_equal(a[s_], b):
                    bad = int(np.argmax(a[s_] != b))
                    fail(f"services v{fam}: pass {k} of the full card batch differs from the "
                         f"CPU path at flow {bad}")
        if not len(cpu.conntrack):
            fail(f"services v{fam}: the CPU slice created no CT entry")
        cpu.conntrack.flush()
        cpu.counters[:] = 0
    print(f"services: card == CPU on the first {SLICE} flows of each batch sequence (verdicts, "
          f"redirects, revNAT ids, counters and live CT keys after every pass), v4 and v6, in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)


def ct_clone(st, device=None):
    """A copy of a DeviceCTState (on ``device``, default its own)."""
    import dataclasses

    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).to(device or getattr(st, f.name).device, copy=True)
        for f in dataclasses.fields(st)})


def ct_state_err(a, b) -> int:
    import dataclasses

    return max(max_abs_err(getattr(a, f.name).cpu(), getattr(b, f.name).cpu())
               for f in dataclasses.fields(a))


def edge_checks5(dev) -> None:
    """K10 ct_step (both entries) against its plain version, exact, over
    several steps of one table: 16-, 64- and 1024-slot tables with live,
    expired (UDP after 60 s) and reply-tuple entries, flows that repeat
    in a batch (contested slots), probe windows that wrap past C-1, B = 0
    and B = 1, ct_step alone and with the verdict tail (a shared and a
    global-atomic counter histogram, invalid lanes); and the wrapper's
    refusals (C not a power of two, more endpoints than the 23 bits of
    the kc word hold)."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.datapath import device_ct as dct

    rs = np.random.default_rng(4321)
    for bits, b, n_pool, ep_count in ((4, 64, 24, 3), (4, 1, 4, 1), (4, 0, 4, 1),
                                      (6, 777, 300, 64), (10, 3000, 1200, 2100)):
        st = dct.make_state(bits, device="cpu")
        pool = [rs.integers(-2**31, 2**31, n_pool).astype(np.int32) for _ in range(4)]
        ep = rs.integers(0, ep_count, n_pool).astype(np.int32)
        sp = rs.integers(0, 65536, n_pool).astype(np.int32)
        dp = rs.integers(0, 65536, n_pool).astype(np.int32)
        pr = rs.choice(np.array([6, 17], np.int32), n_pool)
        dr = rs.integers(0, 2, n_pool).astype(np.int32)
        for step in range(5):
            idx = rs.integers(0, n_pool, b)
            rep = rs.random(b) < (0.5 if step % 2 else 0.0)  # half the lanes as replies
            fields = [np.where(rep, dp[idx], sp[idx]), np.where(rep, sp[idx], dp[idx]),
                      np.where(rep, 1 - dr[idx], dr[idx])]
            cpu_in = [torch.from_numpy(np.ascontiguousarray(w[idx])) for w in pool]
            kc = dct.pack_kc_words(torch.from_numpy(ep[idx]), torch.from_numpy(fields[0]),
                                   torch.from_numpy(fields[1]), torch.from_numpy(pr[idx]),
                                   torch.from_numpy(fields[2]))
            cpu_in += [*kc, torch.from_numpy(pr[idx])]
            now = 1000 + 40 * step
            gpu, cpu = ct_clone(st, dev), ct_clone(st, "cpu")
            g_in = [x.to(dev) for x in cpu_in]
            if step % 2 == 0:
                allow = torch.from_numpy(rs.random(b) < 0.7)
                outs = [dct.ct_step(s, (x[0], x[1]), (x[2], x[3]), (x[4], x[5]), x[6], now,
                                    a) for s, x, a in ((gpu, g_in, allow.to(dev)),
                                                       (cpu, cpu_in, allow))]
            else:
                tail = [torch.from_numpy(rs.choice(np.array([1, 1, 2, 3], np.int8), b)),
                        torch.from_numpy(rs.random(b) < 0.2), torch.from_numpy(rs.random(b) < 0.9),
                        torch.from_numpy(ep[idx])]
                outs = [dct.ct_step_verdict(s, (x[0], x[1]), (x[2], x[3]), (x[4], x[5]), x[6],
                                            now, *t, ep_count)
                        for s, x, t in ((gpu, g_in, [y.to(dev) for y in tail]), (cpu, cpu_in, tail))]
            torch.cuda.synchronize()
            g_out, c_out = (o if isinstance(o, tuple) else (o,) for o in outs)
            err = max([max_abs_err(g.cpu(), c) for g, c in zip(g_out, c_out)] + [ct_state_err(gpu, cpu)])
            if err:
                fail(f"K10 ct_step edge C={1 << bits} B={b} step {step}: card and plain differ")
            st = cpu
        if b > 1 and not int((st.exp > 1000 + 40 * 4).sum()):
            fail(f"K10 ct_step edge C={1 << bits} B={b}: no live entry after five steps")
    bad = dct.make_state(4, device=dev)
    cut = dataclasses.replace(bad, **{f.name: getattr(bad, f.name)[:12].clone()
                                      for f in dataclasses.fields(bad)})
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    for what, state, ep_count in (("C = 12", cut, 4), ("ep_count 2**23 + 1", bad, (1 << 23) + 1)):
        try:
            dct.ct_step_verdict(state, (one, one), (one, one), (one, one), one + 6, 5,
                                (one + 1).to(torch.int8), one > 0, one == 0, one, ep_count)
        except ValueError:
            continue
        fail(f"K10 ct_step took {what}")


class CTRecorder:
    """Wraps the pipeline module's ct_step_verdict, which process_flows_ct
    calls, to keep each call's established lanes and arguments."""

    def __init__(self):
        from cilium_tpu_torch.datapath import pipeline as pmod

        self.mod, self.real = pmod, pmod.ct_step_verdict
        self.calls = []

        def call(*a, **k):
            out = self.real(*a, **k)
            self.calls.append((a, out[3]))
            return out

        pmod.ct_step_verdict = call

    def close(self):
        self.mod.ct_step_verdict = self.real


def flow_keys(fam: int, pb, eps, sports, dports, protos, ingress: bool):
    """[B] 24-byte CT keys of the flows (the host CT's pack_keys words),
    as a numpy void view for set tests."""
    import numpy as np

    from cilium_tpu_torch.datapath.conntrack import pack_keys
    from cilium_tpu_torch.datapath.pipeline import _peer_words

    hi, lo = _peer_words(np.asarray(pb), fam)
    b = hi.shape[0]
    ka, kb, kc = pack_keys(hi, lo, np.asarray(eps, np.uint64), np.asarray(sports, np.uint64),
                           np.asarray(dports, np.uint64), np.asarray(protos, np.uint64),
                           np.full(b, 0 if ingress else 1, np.uint64))
    return void_keys(ka, kb, kc)


def void_keys(ka, kb, kc):
    import numpy as np

    k = np.ascontiguousarray(np.stack([ka, kb, kc], 1).astype(np.uint64))
    return k.view(np.dtype((np.void, 24))).ravel()


def device_ct_main_path(svc, card: str):
    """The device-CT main path on the card, both families, on the
    services world with no LB: DatapathPipeline(engine, cache, pf,
    device_ct_bits=CT_BITS), launch counts from zero, four 1 048 576-flow
    passes per family (egress pass 1, the same batch, the replies from
    each flow's destination with the ports swapped, the overlay batch on
    the host CT fallback)."""
    import numpy as np
    import torch

    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.device_ct import pull_live_entries
    from cilium_tpu_torch.datapath.pipeline import FORWARD, DatapathPipeline
    from cilium_tpu_torch.ipcache.prefilter import PreFilter

    t0 = time.perf_counter()
    pipe = DatapathPipeline(svc["pipe"].engine, svc["cache"], PreFilter(), device_ct_bits=CT_BITS)
    pipe.set_endpoints([(10_000 + j, e) for j, e in enumerate(svc["endpoints"])])
    pipe.rebuild()
    torch.cuda.synchronize()
    c = 1 << CT_BITS
    print(f"device CT: pipeline with device_ct_bits={CT_BITS} ({c} slots) and no LB, host CT "
          f"fallback {pipe.conntrack.capacity} slots, rebuilt in {time.perf_counter() - t0:.2f}s",
          flush=True)
    seqs = {}
    for fam in (4, 6):
        q = svc["seqs"][fam]
        peer, eps, dports, protos, sports = q["batch"]
        seqs[fam] = dict(batch=q["batch"], pb=q["pb"],
                         reply=(peer, eps, sports.astype(np.int32), protos, dports.astype(np.int64)),
                         overlay=q["overlay"])

    _kernels.reset_launches()
    rec = CTRecorder()
    res, args, hit_state, pass_times = {}, {}, {}, {}
    for fam in (4, 6):
        q = seqs[fam]
        times, k10, live = [], [], []
        t_last = [time.perf_counter()]

        def probe(k):
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t_last[0])
            k10.append(_kernels.launches()["ct_probe_claim"])
            if k == 0:
                hit_state[fam] = ct_clone(pipe._device_ct)
            if k < 3:
                live.append(pull_live_entries(pipe._device_ct, int(time.monotonic()), limit=c))
            t_last[0] = time.perf_counter()

        n_calls = len(rec.calls)
        if len(pipe.conntrack):
            fail("device CT: the host CT fallback holds entries before the overlay pass")
        k10_0 = _kernels.launches()["ct_probe_claim"]
        out = svc_sequence(pipe, fam, q["batch"], q["reply"], q["overlay"], probe=probe)
        res[fam], pass_times[fam] = out, times
        calls = rec.calls[n_calls:]
        if len(calls) != 3 or [x - k10_0 for x in k10] != [1, 2, 3, 3]:
            fail(f"device CT v{fam}: K10 launched {[x - k10_0 for x in k10]} after the passes, "
                 f"expected [1, 2, 3, 3] (the overlay pass on the host CT)")
        args[fam] = (calls[0][0], calls[1][0])
        est1, est2, est_r = (x[1].cpu().numpy() for x in calls)
        (v1, r1), (v2, r2), (vr, _rr, rev), (vo, _ro) = out
        peer, eps, dports, protos, sports = q["batch"]
        keys = flow_keys(fam, q["pb"], eps, sports, dports, protos, False)
        admitted = (v1 == FORWARD) & ~r1
        in1 = np.isin(keys, void_keys(live[0]["ka"], live[0]["kb"], live[0]["kc"]))
        in2 = np.isin(keys, void_keys(live[1]["ka"], live[1]["kb"], live[1]["kc"]))
        n_keys = np.unique(keys[admitted]).size
        inserted1, inserted2 = len(live[0]["ka"]), len(live[1]["ka"]) - len(live[0]["ka"])
        print(f"main path device CT v{fam} [{card}]: {BATCH} flows a pass, host clock "
              f"(torch.cuda.synchronize after each)", flush=True)
        for name, dt, ht in zip(("pass 1 (new)", "pass 2 (established)", "replies",
                                 "overlay (host CT fallback)"), times, svc["pass_times"][fam]):
            print(f"  {name}: {dt!r}s = {BATCH / dt!r} flows/s (host CT pipeline with LB, same "
                  f"run: {ht!r}s)", flush=True)
        print(f"  pass 1: admitted {int(admitted.sum())} ({n_keys} distinct keys), inserted "
              f"{inserted1}, lost to conflicts or full windows {n_keys - inserted1}; pass 2: "
              f"established {int(est2.sum())}, inserted {inserted2}; replies: established "
              f"{int(est_r.sum())}, forwarded {int((vr == FORWARD).sum())}; verdicts pass 1 "
              f"{np.bincount(v1, minlength=4)[1:].tolist()}, pass 2 "
              f"{np.bincount(v2, minlength=4)[1:].tolist()}, replies "
              f"{np.bincount(vr, minlength=4)[1:].tolist()}, overlay "
              f"{np.bincount(vo, minlength=4)[1:].tolist()} (host CT {len(pipe.conntrack)} "
              f"entries); K10 launches {k10[-1] - k10_0}", flush=True)
        if est1.any():
            fail(f"device CT v{fam}: a flow was established on a fresh table")
        if not (admitted.any() and (~admitted).any() and inserted1 > 0):
            fail(f"device CT v{fam}: pass 1 admitted or inserted nothing, or everything")
        if (est2 & ~admitted).any() or (est_r & ~in2).any():
            fail(f"device CT v{fam}: a flow whose policy verdict is a drop came back established")
        if not np.array_equal(est2, in1):
            fail(f"device CT v{fam}: pass 2 established {int(est2.sum())} flows, pass 1 inserted "
                 f"the keys of {int(in1.sum())}")
        if not np.array_equal(est_r, in2) or not (vr[in2] == FORWARD).all():
            fail(f"device CT v{fam}: a reply of an inserted flow was not forwarded")
        if not (np.array_equal(v2, np.where(admitted, FORWARD, v1)) and not (r2 & admitted).any()):
            fail(f"device CT v{fam}: pass 2 differs from pass 1 outside the bypass")
        if rev.any():
            fail(f"device CT v{fam}: the device path returned revNAT ids")
        if not len(pipe.conntrack):
            fail(f"device CT v{fam}: the overlay pass did not take the host CT")
        with pipe._lock:
            pipe._flush_ct_locked()
    rec.close()
    print(f"device CT main path and its checks in {time.perf_counter() - t0:.2f}s", flush=True)
    return dict(pipe=pipe, seqs=seqs, res=res, args=args, hit_state=hit_state,
                pass_times=pass_times)


def host_ct_compare(svc, r, card: str) -> None:
    """The same four batches of each family through the pipeline that
    the device CT replaces on this path: host CT, no LB
    (DatapathPipeline(engine, cache, pf, FlowConntrack(CT_BITS))). Prints
    each pass's host-clock time beside the device-CT pass's, and holds
    passes 1-2 equal to the device-CT pipeline's (an admitted flow
    forwards whether or not it is established) and every reply that the
    device-CT pipeline forwards forwarded here too."""
    import numpy as np
    import torch

    from cilium_tpu_torch.datapath.conntrack import FlowConntrack
    from cilium_tpu_torch.datapath.pipeline import FORWARD, DatapathPipeline
    from cilium_tpu_torch.ipcache.prefilter import PreFilter

    t0 = time.perf_counter()
    pipe = DatapathPipeline(svc["pipe"].engine, svc["cache"], PreFilter(),
                            FlowConntrack(capacity_bits=CT_BITS))
    pipe.set_endpoints([(10_000 + j, e) for j, e in enumerate(svc["endpoints"])])
    pipe.rebuild()
    for fam in (4, 6):
        q = r["seqs"][fam]
        times, t_last = [], [time.perf_counter()]

        def probe(_k):
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t_last[0])
            t_last[0] = time.perf_counter()

        t_last[0] = time.perf_counter()
        out = svc_sequence(pipe, fam, q["batch"], q["reply"], q["overlay"], probe=probe)
        dev = r["res"][fam]
        for k in range(2):
            if not all(np.array_equal(a, b) for a, b in zip(out[k], dev[k])):
                fail(f"host CT without LB v{fam}: pass {k + 1} differs from the device-CT pipeline")
        if ((dev[2][0] == FORWARD) & (out[2][0] != FORWARD)).any():
            fail(f"host CT without LB v{fam}: a reply the device CT forwards was not forwarded")
        print(f"host CT without LB v{fam} [{card}]: {len(pipe.conntrack)} entries after the four "
              f"passes; host clock (torch.cuda.synchronize after each)", flush=True)
        for name, ht, dt in zip(("pass 1 (new)", "pass 2 (established)", "replies",
                                 "overlay"), times, r["pass_times"][fam]):
            print(f"  {name}: {ht!r}s (device CT pipeline, same run: {dt!r}s, ratio "
                  f"{ht / dt!r})", flush=True)
        with pipe._lock:
            pipe._flush_ct_locked()
    print(f"host CT without LB on the device-CT batches in {time.perf_counter() - t0:.2f}s",
          flush=True)


def device_ct_cpu_checks(svc, r) -> None:
    """The first SLICE flows of each device-CT sequence on a CPU pipeline
    (device="cpu", same device_ct_bits) and on the card pipeline (tables
    flushed, counters zeroed), time.monotonic pinned for both: verdicts,
    redirects, revNAT ids, counters, the device table slot by slot
    (pull_live_entries and the live slots) and the host CT's live keys
    after every pass; and passes 1-2 of the full card batch on those
    flows."""
    import numpy as np

    from cilium_tpu_torch.datapath.device_ct import pull_live_entries
    from cilium_tpu_torch.datapath.pipeline import DatapathPipeline
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter

    t0 = time.perf_counter()
    gpu = r["pipe"]
    cpu = DatapathPipeline(PolicyEngine(svc["repo"], svc["reg"], device="cpu"), svc["cache"],
                           PreFilter(), device_ct_bits=CT_BITS, device="cpu")
    cpu.set_endpoints([(10_000 + j, e) for j, e in enumerate(svc["endpoints"])])
    cpu.rebuild()
    now_s = int(time.monotonic())
    real_clock = time.monotonic
    time.monotonic = lambda: now_s + 0.5
    try:
        for fam in (4, 6):
            q = r["seqs"][fam]
            args = [tuple(a[:SLICE] for a in q[k]) for k in ("batch", "reply", "overlay")]
            runs = []
            for pipe in (gpu, cpu):
                with pipe._lock:
                    pipe._flush_ct_locked()
                pipe.counters[:] = 0
                state = []

                def probe(k, pipe=pipe, state=state):
                    dct = pull_live_entries(pipe._device_ct, now_s, limit=1 << CT_BITS)
                    slots = np.nonzero(pipe._device_ct.exp.cpu().numpy() > now_s)[0]
                    state.append((pipe.counters.copy(), dct, slots, ct_live_keys(pipe.conntrack)))

                runs.append((svc_sequence(pipe, fam, *args, probe=probe), state))
            (g_out, g_state), (c_out, c_state) = runs
            for k in range(4):
                if not all(np.array_equal(a, b) for a, b in zip(g_out[k], c_out[k])):
                    fail(f"device CT v{fam}: pass {k} outputs differ between card and CPU")
                (gc, gd, gs, gh), (cc, cd, cs, ch) = g_state[k], c_state[k]
                if not np.array_equal(gc, cc):
                    fail(f"device CT v{fam}: counters after pass {k} differ between card and CPU")
                if not np.array_equal(gs, cs) or any(not np.array_equal(gd[x], cd[x]) for x in gd):
                    fail(f"device CT v{fam}: the device table after pass {k} differs between card "
                         "and CPU")
                if any(not np.array_equal(gh[x], ch[x]) for x in gh):
                    fail(f"device CT v{fam}: host CT keys after pass {k} differ between card and "
                         "CPU")
            for k in range(2):
                for a, b in zip(r["res"][fam][k], c_out[k]):
                    if not np.array_equal(a[:SLICE], b):
                        fail(f"device CT v{fam}: pass {k} of the full card batch differs from the "
                             "CPU path")
            if not len(c_state[0][1]["ka"]) or not len(c_state[3][3]["ka"]):
                fail(f"device CT v{fam}: the CPU slice filled no device or host CT entry")
    finally:
        time.monotonic = real_clock
    for pipe in (gpu, cpu):
        with pipe._lock:
            pipe._flush_ct_locked()
    print(f"device CT: card == CPU on the first {SLICE} flows of each sequence (verdicts, "
          f"redirects, revNAT ids, counters, the device table slot by slot and the host CT keys "
          f"after every pass), v4 and v6, in {time.perf_counter() - t0:.2f}s", flush=True)


def ct_step_bytes(before, after, words, now: int, n_lanes: int, ep_count: int):
    """(bytes K10 must move, bytes if no two windows shared a sector),
    as this run's data needs them. Of each forward and reply window: exp
    up to the first live slot holding the key (all 8 slots without one),
    kc_lo of the live slots among those, and the five other key words of
    that matching slot, each as the distinct 32-byte sectors it falls
    in, read once; the sectors whose content the step changed, written
    once; and the flows in (six words, proto, verdict, redirect, valid,
    ep_idx) and out (verdict, redirect, established, counters) once."""
    import dataclasses

    import torch

    from cilium_tpu_torch.datapath.device_ct import CT_PROBES, _flip_kc_words, _hash_u32, _window

    live = before.exp > now
    pos = torch.arange(CT_PROBES, device=live.device)
    f_hi, f_lo = _flip_kc_words(words[4], words[5])
    sectors = {"exp": [], "kc_lo": [], "key": []}
    per_lane = 0
    for ws in (words, (*words[:4], f_hi, f_lo)):
        slots = _window(_hash_u32(*ws), before.capacity)
        lv = live[slots]
        match = lv.clone()
        for table, w in zip(before.keys(), ws):
            match &= table[slots] == w.to(torch.int32)[:, None]
        hit = match.any(1)
        first = match.to(torch.int8).argmax(1)
        need = pos[None, :] <= torch.where(hit, first, CT_PROBES - 1)[:, None]
        sec = slots >> 3
        head = sec[:, :1]  # a window spans its first slot's sector and at most one more
        for name, m in (("exp", need), ("kc_lo", need & lv)):
            sectors[name].append(sec[m])
            per_lane += int((m & (sec == head)).any(1).sum() + (m & (sec != head)).any(1).sum())
        sectors["key"].append(sec.gather(1, first[:, None])[hit, 0])
        per_lane += 5 * int(hit.sum())
    n = {k: torch.unique(torch.cat(v)).numel() for k, v in sectors.items()}
    read = (n["exp"] + n["kc_lo"] + 5 * n["key"]) * 32
    written = 0
    for f in dataclasses.fields(before):
        if f.name != "owner":
            moved = torch.nonzero(getattr(before, f.name) != getattr(after, f.name))[:, 0]
            written += torch.unique(moved >> 3).numel() * 32
    flows = n_lanes * (6 * 4 + 4 + 1 + 1 + 1 + 4) + n_lanes * 3 + ep_count * 3 * 4
    return read + written + flows, per_lane * 32 + written + flows


def ct_step_rows(dct, dev, row) -> None:
    """The K10 rows: ``row(...)`` for each family and table fill."""
    # K10 ct_step, both entries, as process_flows_ct calls them (the
    # verdict tail included), on each family's pass-1 inputs over a fresh
    # table (insert-heavy: every call advances the clock past the TCP
    # lifetime, so each finds every slot expired) and on its pass-2 inputs
    # over the table pass 2 saw (hit-heavy: after the first call the table
    # no longer changes). Bound: bytes, from the sectors this run's
    # windows need (ct_step_bytes)
    from cilium_tpu_torch.datapath.device_ct import LIFE_TCP_S, ct_step_verdict, ct_step_verdict_plain
    from cilium_tpu_torch.datapath.device_ct import make_state as ct_make_state

    for fam in (4, 6):
        a1, a2 = dct["args"][fam]
        for kind, base, a in (("insert-heavy", None, a1), ("hit-heavy", dct["hit_state"][fam], a2)):
            _st, ka_w, kb_w, kc_w, proto_t, now0, *tail = a
            words = (*ka_w, *kb_w, *kc_w)
            start = ct_make_state(CT_BITS, device=dev) if base is None else base
            st_k, st_p = ct_clone(start), ct_clone(start)
            k_out = ct_step_verdict(st_k, ka_w, kb_w, kc_w, proto_t, now0, *tail)
            p_out = ct_step_verdict_plain(st_p, ka_w, kb_w, kc_w, proto_t, now0, *tail)
            err = max([max_abs_err(x, y) for x, y in zip(k_out, p_out)] + [ct_state_err(st_k, st_p)])
            b_bytes, lane_bytes = ct_step_bytes(start, st_k, words, now0, proto_t.shape[0],
                                                tail[-1])
            b_ms, b_by = bound(b_bytes, 0)
            step = [0]

            def now_of():
                step[0] += 1
                return now0 + step[0] * (LIFE_TCP_S + 1) if base is None else now0

            row("ct_step", "cilium_tpu_torch/csrc/ct_step.cu",
                "cilium_tpu/datapath/device_ct.py:166", err,
                lambda st=st_k, t=tail, nf=now_of: ct_step_verdict(st, ka_w, kb_w, kc_w, proto_t,
                                                                    nf(), *t),
                lambda st=st_p, t=tail, nf=now_of: ct_step_verdict_plain(st, ka_w, kb_w, kc_w,
                                                                         proto_t, nf(), *t),
                b_ms, b_by, f"v{fam} {kind}: {proto_t.shape[0]} flows, {1 << CT_BITS} slots, "
                f"{int(k_out[3].sum())} established, both entries + verdict tail; {b_bytes} bytes "
                f"(distinct sectors needed), {lane_bytes} if no two windows shared a sector "
                f"({lane_bytes / HBM_BYTES_PER_S * 1e3!r} ms)", plain_iters=2, reps=5)


def metric_series():
    """Snapshot of the attribution metrics (rule_hits_total and
    drop_reasons_total), keyed by (metric, labels)."""
    from cilium_tpu_torch import metrics

    return {(m.name, k): v for m in (metrics.rule_hits_total, metrics.drop_reasons_total)
            for k, v in m.series().items()}


def metric_delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.datapath.pipeline import (
        TRAFFIC_INGRESS, DatapathPipeline, process_flows, process_flows_wide,
    )
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ipcache.prefilter import PreFilter
    from cilium_tpu_torch.ops import materialize as matmod
    from cilium_tpu_torch.ops import verdict as verdictmod
    from cilium_tpu_torch.ops.bitmap import compute_selector_matches, selector_match_plain, unpack_bits_u32
    from cilium_tpu_torch.lb.device import lb_translate, lb_translate_plain
    from cilium_tpu_torch.ops.lookup import policymap_verdict, policymap_verdict_plain
    from cilium_tpu_torch.ops.lpm import (
        build_trie_elided, elided_lookup, lpm_lookup_wide, lpm_stride8_plain, lpm_wide_plain,
    )
    from cilium_tpu_torch.ops.verdict import ATTR_NAMES, bool_mm, bool_mm_plain, first_rule, first_rule_plain
    from cilium_tpu_torch.convert import words_i32
    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops.dfa import (
        L7_LEN_LADDER, DeviceDFATable, device_dfa, dfa_match_batch, dfa_match_batch_fused,
        dfa_match_batch_pair, dfa_pair_walk_plain, dfa_walk_plain, fuse_dfas, len_rung,
        strings_to_batch, strings_to_batch_u8,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    t_start = time.perf_counter()

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build()
    _kernels.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {_kernels.build_seconds if _kernels.build_seconds is not None else 0.0:.2f}s)",
          flush=True)

    edge_checks(dev)
    edge_checks2(dev)
    edge_checks3(dev)
    edge_checks4(dev)
    edge_checks5(dev)
    print("edge shapes: every kernel equals its plain version (ragged K1/K2, "
          "16-8-8 K3, 1 280-column / 2 100-endpoint K4; 4- and 16-level K5 with "
          "out-of-range bytes and child ids; ragged K6; K4 attribution with shared and "
          "global histograms; K7 both entries and K8 at every rung and odd caps, uint8 and "
          "int32 bytes, out-of-range starts and bytes, lengths past max_len, empty batches; K9 at "
          "F = 1 and 1025, B = 0, 1 and ragged, both address widths; K10 both entries on 16-, 64- and "
          "1024-slot tables over five steps, wrapped windows, contested slots, B = 0 and 1)",
          flush=True)

    # -- 2. world --------------------------------------------------------
    t0 = time.perf_counter()
    repo, reg, cache, idents, labels_of = build_world(args.seed)
    ips, eps, dports, protos, i_sel = make_flows(args.seed, len(idents))
    addr6, eps6, dports6, protos6, i_sel6 = make_flows6(args.seed, len(idents))
    endpoints = [idents[j].id for j in range(N_ENDPOINTS)]
    print(f"world: {N_RULES} rules, {len(idents)} identities, {N_ENDPOINTS} endpoints "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    launches = {}

    def check_path(path, names):
        got = _kernels.launches()
        launches[path] = got
        print(f"main path [{path}] launches {got}", flush=True)
        for k in names:
            if got[k] <= 0:
                fail(f"kernel {k} never launched on the {path} main path")

    # -- 3a. v4 main path on the card, launch counts from zero -----------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    engine = PolicyEngine(repo, reg)
    engine.refresh()
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    pipes = {}
    results = {}
    pf_sets = (("no-prefilter", []), ("prefilter", PREFILTER_CIDRS + V6_DENY))
    for name, cidrs in pf_sets:
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
        fused = pipe._tables[(TRAFFIC_INGRESS, 4)].merged_sub_info.shape[-1] == 65536
        t_med = sorted(times)[1]
        print(f"main path [{name}]: rebuild {t_rebuild!r}s (both families' tries), process "
              f"{BATCH} flows {times}s (median {t_med!r}s = {BATCH / t_med!r} "
              f"verdicts/s end to end incl. h2d/d2h; fused walk: {fused}); verdicts "
              f"{np.bincount(v, minlength=4)[1:].tolist()}, redirects {int(red.sum())} "
              f"[{card}]", flush=True)
    print(f"refresh {t_refresh!r}s", flush=True)
    check_path("v4", ["selector_match", "bool_mm", "lpm_wide", "policymap_verdict"])
    if not pipes["prefilter"]._tables[(TRAFFIC_INGRESS, 4)].merged_sub_info.shape[-1] == 65536:
        fail("prefilter run did not take the fused walk")

    # -- 3b. v6 main path -------------------------------------------------
    _kernels.reset_launches()
    results6 = {}
    for name, _cidrs in pf_sets:
        pipe = pipes[name]
        times, outs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            outs.append(pipe.process_v6(addr6, eps6, dports6, protos6))
            times.append(time.perf_counter() - t0)
        v, red = outs[0]
        for v2, red2 in outs[1:]:
            if not (np.array_equal(v, v2) and np.array_equal(red, red2)):
                fail(f"{name} v6: runs of one batch disagree")
        results6[name] = (v, red)
        t6 = pipe._tables[(TRAFFIC_INGRESS, 6)]
        k_ip, k_m = t6.ip_common.shape[0], t6.merged_common.shape[0]
        t_med = sorted(times)[1]
        print(f"main path v6 [{name}]: process_v6 {BATCH} flows {times}s (median {t_med!r}s = "
              f"{BATCH / t_med!r} verdicts/s end to end incl. h2d/d2h; fused walk: "
              f"{pipe._v6_fused}, K identity {k_ip}, K fused {k_m}); verdicts "
              f"{np.bincount(v, minlength=4)[1:].tolist()}, redirects {int(red.sum())} "
              f"[{card}]", flush=True)
        if k_ip != 13:
            fail(f"{name}: the v6 identity trie elided {k_ip} bytes, not 13")
    check_path("v6", ["lpm_stride8", "policymap_verdict"])
    if pipes["no-prefilter"]._v6_fused or not pipes["prefilter"]._v6_fused:
        fail("the v6 walks are not identity-only / fused as configured")
    if pipes["prefilter"]._tables[(TRAFFIC_INGRESS, 6)].merged_common.shape[0] != 13:
        fail("the fused v6 trie did not keep the 13 shared bytes")

    # -- 4. against the plain path on the CPU and the host oracle --------
    t0 = time.perf_counter()
    cpu_engine = PolicyEngine(repo, reg, device="cpu")
    cpu_pipes = {}
    s = slice(0, SLICE)
    for name, cidrs in pf_sets:
        pf = PreFilter()
        if cidrs:
            pf.insert(pf.revision, cidrs)
        cpu_pipe = DatapathPipeline(cpu_engine, cache, pf, device="cpu")
        cpu_pipe.set_endpoints(endpoints)
        cpu_pipes[name] = cpu_pipe
        gpu_pipe = pipes[name]
        for fam, call, flows, res in (
            ("v4", "process", (ips, eps, dports, protos), results),
            ("v6", "process_v6", (addr6, eps6, dports6, protos6), results6),
        ):
            cpu_pipe.counters[:] = 0
            vc, rc = getattr(cpu_pipe, call)(*(a[s] for a in flows))
            v, red = res[name]
            if not (np.array_equal(vc, v[s]) and np.array_equal(rc, red[s])):
                bad = int(np.argmax((vc != v[s]) | (rc != red[s])))
                fail(f"{name} {fam}: card and CPU disagree at flow {bad}")
            gpu_pipe.counters[:] = 0
            getattr(gpu_pipe, call)(*(a[s] for a in flows))
            if not np.array_equal(gpu_pipe.counters, cpu_pipe.counters):
                fail(f"{name} {fam}: counters differ between card and CPU")
        denied = [ipaddress.ip_network(c) for c in cidrs]
        oracle_check(repo, labels_of, idents, name, ips, eps, dports, protos, i_sel,
                     results[name][0], [n for n in denied if n.version == 4], endpoints)
        oracle_check6(repo, reg, labels_of, idents, name, addr6, eps6, dports6, protos6, i_sel6,
                      results6[name][0], [n for n in denied if n.version == 6], endpoints)
    print(f"card == CPU plain path on {SLICE} flows (verdicts, redirects, counters) and "
          f"== host oracle on {N_ORACLE} flows, v4 and v6, both pipelines, in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # -- 3c. attribution main path ---------------------------------------
    _kernels.reset_launches()
    matmod.SWEEPS.clear()
    apipe = pipes["prefilter"]
    apipe.set_attribution(True)
    t0 = time.perf_counter()
    apipe.rebuild()
    torch.cuda.synchronize()
    t_rebuild = time.perf_counter() - t0
    attr_out = {}
    for fam, call, flows in (("v4", "process", (ips, eps, dports, protos)),
                             ("v6", "process_v6", (addr6, eps6, dports6, protos6))):
        before = metric_series()
        t0 = time.perf_counter()
        v, red = getattr(apipe, call)(*flows)
        t_proc = time.perf_counter() - t0
        d = metric_delta(before, metric_series())
        attr_out[fam] = (v, red)
        drops = {dict(k[1])["reason"]: int(x) for k, x in d.items()
                 if k[0].endswith("drop_reasons_total")}
        n_hit = sum(int(x) for k, x in d.items() if k[0].endswith("rule_hits_total"))
        print(f"main path attribution [{fam}]: process {BATCH} flows {t_proc!r}s = "
              f"{BATCH / t_proc!r} verdicts/s end to end (first call after the attributed "
              f"rebuild); rule hits {n_hit}, drop reasons {drops} [{card}]", flush=True)
        if not np.array_equal(v, (results if fam == "v4" else results6)["prefilter"][0]):
            fail(f"attribution changed the {fam} verdicts")
    sweeps = dict(matmod.SWEEPS)
    print(f"attributed rebuild {t_rebuild!r}s ({sweeps} sweep calls) [{card}]", flush=True)
    check_path("attribution", ["bool_mm", "first_rule", "policymap_verdict_attrib",
                               "lpm_wide", "lpm_stride8"])
    if sweeps.get("flow_attrib", 0) <= 0:
        fail("the attributed rebuild did not run the flow-route sweep")

    # -- 4b. attribution against the CPU path on a slice -------------------
    t0 = time.perf_counter()
    cpu_apipe = DatapathPipeline(cpu_engine, cache, cpu_pipes["prefilter"].prefilter, device="cpu")
    cpu_apipe.set_endpoints(endpoints[:N_ATTR_EPS])
    cpu_apipe.set_attribution(True)
    cpu_apipe.rebuild()
    n_rules = apipe._attrib_n_rules
    if n_rules != N_RULES or cpu_apipe._attrib_n_rules != N_RULES:
        fail(f"attribution counts {n_rules} rules, expected {N_RULES}")
    for fam, flows in (("v4", (ips, eps, dports, protos)), ("v6", (addr6, eps6, dports6, protos6))):
        sel = np.nonzero(flows[1] < N_ATTR_EPS)[0][:ATTR_SLICE]
        part = [a[sel] for a in flows]
        outs = []
        for pipe, ep_count in ((apipe, N_ENDPOINTS), (cpu_apipe, N_ATTR_EPS)):
            fdev = pipe.device
            t = pipe._tables[(TRAFFIC_INGRESS, 4 if fam == "v4" else 6)]
            fargs = [torch.from_numpy(np.ascontiguousarray(a)).to(fdev) for a in part[1:]]
            kw = dict(ep_count=ep_count, prefilter=True, attrib=True, n_rules=n_rules,
                      rule_tab=pipe._rule_tabs[TRAFFIC_INGRESS])
            if fam == "v4":
                peer = torch.from_numpy(part[0].view(np.int32)).to(fdev)
                out = process_flows_wide(t, peer, *fargs, **kw)
            else:
                out = process_flows(t, torch.from_numpy(part[0]).to(fdev), *fargs, levels=16,
                                    fused=pipe._v6_fused, **kw)
            outs.append([x.cpu().numpy() for x in out])
        g, c = outs
        for k, what in ((0, "verdicts"), (1, "redirects"), (3, "rules"), (4, "l4_covered"),
                        (5, "rule hits")):
            if not np.array_equal(g[k], c[k]):
                fail(f"attribution {fam}: {what} differ between card and CPU")
        if not (np.array_equal(g[2][:N_ATTR_EPS], c[2]) and not g[2][N_ATTR_EPS:].any()):
            fail(f"attribution {fam}: counters differ between card and CPU")
        if not ((g[3] >= 0).any() and (g[3] == -1).any() and g[4].any()):
            fail(f"attribution {fam}: the slice attributes no rule or no drop")
        deltas = []
        call = "process" if fam == "v4" else "process_v6"
        for pipe in (apipe, cpu_apipe):
            before = metric_series()
            getattr(pipe, call)(*part)
            deltas.append(metric_delta(before, metric_series()))
        if deltas[0] != deltas[1] or not deltas[0]:
            fail(f"attribution {fam}: metric deltas differ between card and CPU")
    rs = np.random.default_rng(args.seed + 9)
    for _ in range(8):
        q = (int(rs.choice(endpoints)), int(idents[int(rs.integers(0, len(idents)))].id),
             int(rs.choice([80, 443, 8080, 53, 22])))
        q = (*q, 17 if q[2] == 53 else 6)
        for ingress in (True, False):
            if engine.explain_one(*q, ingress=ingress) != cpu_engine.explain_one(*q, ingress=ingress):
                fail(f"explain_one{q} (ingress {ingress}) differs between card and CPU")
    print(f"attribution: card == CPU path on {ATTR_SLICE} flows of each family over the first "
          f"{N_ATTR_EPS} endpoints (verdicts, rules, l4_covered, rule hits, counters, metric "
          f"deltas) and explain_one on 16 queries, in {time.perf_counter() - t0:.2f}s", flush=True)

    # -- 4c. small world: every reason code on the card --------------------
    t0 = time.perf_counter()
    srepo, sreg, scache, sidents = build_small_world(args.seed)
    seng = {d: PolicyEngine(srepo, sreg, device=d) for d in ("cuda", "cpu")}
    rs = np.random.default_rng(args.seed + 11)
    ids = [i.id for i in sidents]
    q = (rs.choice(ids, 4096), rs.choice(ids, 4096),
         rs.choice(np.array([80, 443, 8080, 53, 22], np.int32), 4096))
    q = (*q, np.where(q[2] == 53, 17, 6).astype(np.int32))
    hl4 = rs.random(4096) < 0.85
    for ingress in (True, False):
        (gv, ga, gh), (cv, ca, ch) = (seng[d].verdicts(*q, ingress=ingress, has_l4=hl4, attrib=True)
                                      for d in ("cuda", "cpu"))
        for a, b in ((gv.decision, cv.decision), (gv.l3, cv.l3), (gv.l7_redirect, cv.l7_redirect),
                     (ga.rule, ca.rule), (ga.reason, ca.reason), (gh, ch)):
            if max_abs_err(a.cpu(), b):
                fail(f"small world: engine attribution differs between card and CPU (ingress {ingress})")
        reasons = set(ga.reason.cpu().numpy().tolist())
        if ingress and reasons != set(ATTR_NAMES):
            fail(f"small world: reason codes {sorted(reasons)} on the card, expected all of {sorted(ATTR_NAMES)}")
    for k in range(12):
        a = (int(q[0][k]), int(q[1][k]), int(q[2][k]), int(q[3][k]))
        if seng["cuda"].explain_one(*a) != seng["cpu"].explain_one(*a):
            fail(f"small world: explain_one{a} differs between card and CPU")
    spipes = {}
    for d in ("cuda", "cpu"):
        spf = PreFilter()
        spf.insert(spf.revision, ["172.16.0.0/29", "fd00::9:0/125"])
        spipes[d] = DatapathPipeline(seng[d], scache, spf, device=d)
        spipes[d].set_endpoints([i.id for i in sidents[:6]])
        spipes[d].set_attribution(True)
    sflows4 = (np.array([int(ipaddress.IPv4Address(f"172.16.0.{int(j) + 1}"))
                         for j in rs.integers(0, 48, 4096)], np.uint32),
               rs.integers(0, 6, 4096).astype(np.int32), q[2], q[3])
    sflows6 = (np.stack([np.frombuffer(ipaddress.IPv6Address(f"fd00::9:{int(j) + 1:x}").packed,
                                       np.uint8) for j in rs.integers(0, 48, 4096)]).astype(np.int32),
               *sflows4[1:])
    for call, flows in (("process", sflows4), ("process_v6", sflows6)):
        for ingress in (True, False):
            out, deltas = [], []
            for d in ("cuda", "cpu"):
                before = metric_series()
                out.append(getattr(spipes[d], call)(*flows, ingress=ingress))
                deltas.append(metric_delta(before, metric_series()))
            if not all(np.array_equal(x, y) for x, y in zip(*out)) or deltas[0] != deltas[1]:
                fail(f"small world {call} (ingress {ingress}): card and CPU differ")
    print(f"small world (40 rules with deny and L7, 48 identities): every reason code "
          f"{sorted(ATTR_NAMES.values())} on the card, engine attribution, explain_one and "
          f"pipeline metric deltas == CPU, in {time.perf_counter() - t0:.2f}s", flush=True)

    # -- 3d. L7 main path, launch counts from zero -----------------------
    _kernels.reset_launches()
    l7res = l7_main_path(args.seed, card, (ips, eps, dports, protos), endpoints)
    off = l7res["off_launches"]
    if off["dfa_walk_fused"] or off["dfa_pair_walk"] or not off["dfa_walk"]:
        fail(f"the L7DeviceBatch-off path launched {off}")
    check_path("l7", ["dfa_walk", "dfa_walk_fused", "dfa_pair_walk"])

    # -- 4d. L7 against the CPU path and the rules' oracle -----------------
    t0 = time.perf_counter()
    l7_cpu_checks(l7res)
    print(f"L7 CPU and oracle checks in {time.perf_counter() - t0:.2f}s", flush=True)

    # -- 3e. services+CT main path, launch counts from zero --------------
    svc = services_main_path(args.seed, card)
    check_path("services", ["lb_translate", "lpm_wide", "lpm_stride8", "policymap_verdict"])

    # -- 4e. services+CT against the CPU path -----------------------------
    services_cpu_checks(svc)

    # -- 3f. device-CT main path, launch counts from zero ----------------
    dct = device_ct_main_path(svc, card)
    check_path("device_ct", ["lpm_wide", "lpm_stride8", "policymap_verdict", "ct_probe_claim",
                             "ct_commit"])
    if launches["device_ct"]["lb_translate"]:
        fail("the device-CT pipeline has no LB, yet K9 launched")

    # -- 4f. device CT against the CPU path and the host CT -------------
    device_ct_cpu_checks(svc, dct)
    host_ct_compare(svc, dct, card)

    # -- 5. each kernel against its plain version on the card ------------
    compiled, device = engine.snapshot()
    rows = []

    def row(name, source, replaces, err, fn, plain_fn, b_ms, b_by, shape, lib_fn=None,
            iters=20, plain_iters=5, reps=5, graph=False):
        ms, clk = timed(fn, iters=iters, reps=reps)
        plain_ms, pclk = timed(plain_fn, iters=plain_iters, reps=reps)
        lib = None
        if lib_fn is not None:
            lib, _ = timed(lib_fn, iters=iters, reps=reps)
        rows.append(dict(name=name, source=source, replaces=replaces, err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         shape=shape, clock=clk, plain_clock=pclk,
                         graph_ms=graph_ms(fn) if graph else None))

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
    s_, cps, _ = compiled.conj_req.shape
    b_ms, b_by = bound(nbytes(*k1_in, k_out), 2 * 2 * n * (w * 32) * s_ * cps)
    row("selector_match", "cilium_tpu_torch/csrc/selector_match.cu", "cilium_tpu/ops/bitmap.py:57",
        max_abs_err(k_out, p_out), lambda: compute_selector_matches(*k1_in),
        lambda: selector_match_plain(*k1_in), b_ms, b_by,
        f"id_bits [{n},{w}], conj [{s_},{cps},{w}]")

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
    row("bool_mm", "cilium_tpu_torch/csrc/bool_mm.cu", "cilium_tpu/ops/verdict.py:151",
        max_abs_err(k_out, p_out), lambda: bool_mm(peer8, t_in.deny_t, complement_x=True),
        lambda: bool_mm_plain(peer8, t_in.deny_t, complement_x=True), b_ms, b_by,
        f"[{bm},{ba}] x [{ba},{bc}], library torch._int_mm",
        lib_fn=lambda: torch._int_mm(comp, t_in.deny_t))

    # K3 lpm_wide over the batch: identity trie (flat) and the fused trie
    peer = torch.from_numpy(ips.view(np.int32)).to(dev)
    for name, prefix in (("no-prefilter", "ip"), ("prefilter", "merged")):
        t = pipes[name]._tables[(TRAFFIC_INGRESS, 4)]
        tabs = [getattr(t, f"{prefix}_{f}") for f in ("root_info", "root_child", "sub_child", "sub_info")]
        b_ms, b_by = bound(lpm_touched_bytes(tabs[0], tabs[1], tabs[3], peer), 0)
        row("lpm_wide", "cilium_tpu_torch/csrc/lpm_wide.cu", "cilium_tpu/ops/lpm.py:346",
            max_abs_err(lpm_lookup_wide(*tabs, peer), lpm_wide_plain(*tabs, peer)),
            lambda: lpm_lookup_wide(*tabs, peer), lambda: lpm_wide_plain(*tabs, peer),
            b_ms, b_by, f"{BATCH} addresses, {prefix} trie sub_info {list(tabs[3].shape)}")

    # K4 policymap_verdict over the batch with the prefilter run's rows
    t = pipes["prefilter"]._tables[(TRAFFIC_INGRESS, 4)]
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
    pm_bytes = nbytes(pm.id_bits, pm.col_ep, pm.col_port, pm.col_proto, pm.col_is_l3, src_rows,
                      *flow_t, denied, k_v, k_r, k_c)
    b_ms, b_by = bound(pm_bytes, 0)
    row("policymap_verdict", "cilium_tpu_torch/csrc/policymap_verdict.cu",
        "cilium_tpu/ops/lookup.py:146", err,
        lambda: policymap_verdict(pm, src_rows, *flow_t, denied_pf=denied, ep_count=N_ENDPOINTS),
        lambda: policymap_verdict_plain(pm, src_rows, *flow_t, denied_pf=denied,
                                        ep_count=N_ENDPOINTS),
        b_ms, b_by, f"{BATCH} flows, id_bits {list(pm.id_bits.shape)}, {pm.col_ep.shape[0]} columns")

    # K4 attribution entry over the batch, the attributed pipeline's rule table
    rule_tab = apipe._rule_tabs[TRAFFIC_INGRESS]
    pm_a = apipe._tables[(TRAFFIC_INGRESS, 4)].policymap
    k_out = policymap_verdict(pm_a, src_rows, *flow_t, denied_pf=denied, ep_count=N_ENDPOINTS,
                              rule_tab=rule_tab, n_rules=n_rules)
    p_out = policymap_verdict_plain(pm_a, src_rows, *flow_t, denied_pf=denied,
                                    ep_count=N_ENDPOINTS, rule_tab=rule_tab, n_rules=n_rules)
    err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
    rule_k, l4x_k, hits_k = k_out[3], k_out[4], k_out[5]
    # rule_tab cells read: at least one per distinct (identity row,
    # endpoint) of the flows a rule decided (endpoints own disjoint columns)
    decided = rule_k >= 0
    rt_cells = torch.unique(src_rows.long()[decided] * N_ENDPOINTS + flow_t[0].long()[decided]).numel()
    b_ms, b_by = bound(pm_bytes + nbytes(rule_k, l4x_k, hits_k) + 4 * rt_cells, 0)
    row("policymap_verdict_attrib", "cilium_tpu_torch/csrc/policymap_verdict.cu",
        "cilium_tpu/ops/lookup.py:202", err,
        lambda: policymap_verdict(pm_a, src_rows, *flow_t, denied_pf=denied,
                                  ep_count=N_ENDPOINTS, rule_tab=rule_tab, n_rules=n_rules),
        lambda: policymap_verdict_plain(pm_a, src_rows, *flow_t, denied_pf=denied,
                                        ep_count=N_ENDPOINTS, rule_tab=rule_tab, n_rules=n_rules),
        b_ms, b_by, f"{BATCH} flows, rule_tab {list(rule_tab.shape)}, {n_rules} rules, "
        f"{rt_cells} (row, endpoint) rule cells read")

    # K5 lpm_stride8 over the v6 batch: identity trie and fused trie, then
    # an edge trie with no elision (K = 0, 16 levels)
    peer6 = torch.from_numpy(addr6).to(dev)
    for name, prefix in (("no-prefilter", "ip"), ("prefilter", "merged")):
        t = pipes[name]._tables[(TRAFFIC_INGRESS, 6)]
        tabs = [getattr(t, f"{prefix}_{f}") for f in ("child", "info", "common")]
        b_ms, b_by = bound(stride8_touched_bytes(*tabs, peer6, 16), 0)
        row("lpm_stride8", "cilium_tpu_torch/csrc/lpm_stride8.cu", "cilium_tpu/ops/lpm.py:144",
            max_abs_err(elided_lookup(*tabs, peer6, 16), lpm_stride8_plain(*tabs, peer6, 16)),
            lambda: elided_lookup(*tabs, peer6, 16), lambda: lpm_stride8_plain(*tabs, peer6, 16),
            b_ms, b_by, f"{BATCH} addresses, {prefix} trie [{tabs[0].shape[0]}, 256], "
            f"K {tabs[2].shape[0]}")
    edge = [f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128" for i in range(len(idents))]
    ech, ein, ecom = build_trie_elided([(c, i) for i, c in enumerate(edge)] + [("2000::/3", 9999)])
    if ecom.shape[0] != 0:
        fail("the edge v6 trie kept shared bytes")
    tabs = [torch.from_numpy(a).to(dev) for a in (ech, ein, ecom)]
    b_ms, b_by = bound(stride8_touched_bytes(*tabs, peer6, 16), 0)
    row("lpm_stride8", "cilium_tpu_torch/csrc/lpm_stride8.cu", "cilium_tpu/ops/lpm.py:144",
        max_abs_err(elided_lookup(*tabs, peer6, 16), lpm_stride8_plain(*tabs, peer6, 16)),
        lambda: elided_lookup(*tabs, peer6, 16), lambda: lpm_stride8_plain(*tabs, peer6, 16),
        b_ms, b_by, f"{BATCH} addresses, edge trie [{tabs[0].shape[0]}, 256], K 0, 16 levels")

    # K6 first_rule at the sweep's block shape: the deny term of the
    # first 8192 sweep flows (endpoint 0's L3 segment x identity rows)
    origin, _ = engine.attribution(True)
    nrow = compiled.id_bits.shape[0]
    sb = 8192
    subj8 = unpack_bits_u32(device.sel_match[torch.full((sb,), int(compiled.rows_for(endpoints[:1])[0]),
                                                        device=dev, dtype=torch.long)])
    peer8 = unpack_bits_u32(device.sel_match[torch.arange(sb, device=dev) % nrow])
    mask = subj8.to(torch.bool) & bool_mm(peer8, t_in.allow_t)
    b_ms, b_by = bound(nbytes(mask, origin.allow_rule) + 4 * sb, 2 * mask.numel())
    row("first_rule", "cilium_tpu_torch/csrc/first_rule.cu", "cilium_tpu/ops/verdict.py:224",
        max_abs_err(first_rule(mask, origin.allow_rule), first_rule_plain(mask, origin.allow_rule)),
        lambda: first_rule(mask, origin.allow_rule), lambda: first_rule_plain(mask, origin.allow_rule),
        b_ms, b_by, f"mask [{sb}, {mask.shape[1]}] ({int(mask.sum())} set), allow term")

    # the attribution flow-route sweep, one direction at full width; its
    # plain version runs the same sweep with the plain K2 and K6
    # (the segments materialize_endpoints_state sweeps: each endpoint's
    # L3 segment, then one per L4 slot)
    ep_rows = compiled.rows_for(endpoints)
    ep_sel = device.sel_match[torch.from_numpy(ep_rows.astype(np.int64)).to(dev)]
    ep_sel = ep_sel.cpu().numpy().view(np.uint32)
    segs = []
    for e, r in enumerate(ep_rows):
        segs.append((int(r), 0, 0, False))
        segs += [(int(r), port, proto, True)
                 for port, proto in matmod._endpoint_slots(compiled, ep_sel[e], True)]
    seg = [torch.from_numpy(np.asarray(col, dt)).to(dev)
           for col, dt in zip(zip(*segs), (np.int32, np.int32, np.int32, bool))]

    def sweep():
        return matmod._sweep_device_attrib(device, *seg, origin, nrow, True, 8192, n_rules)

    def sweep_plain():
        real = (verdictmod.bool_mm, verdictmod.first_rule)
        verdictmod.bool_mm, verdictmod.first_rule = bool_mm_plain, first_rule_plain
        try:
            return sweep()
        finally:
            verdictmod.bool_mm, verdictmod.first_rule = real

    k_out, p_out = sweep(), sweep_plain()
    err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
    n_flows = seg[0].shape[0] * nrow
    b_ms, b_by = bound(nbytes(device.sel_match, *k_out), sweep_ops(t_in, n_flows))
    row("sweep_device_attrib", "cilium_tpu_torch/ops/materialize.py",
        "cilium_tpu/ops/materialize.py:163", err, sweep, sweep_plain, b_ms, b_by,
        f"{seg[0].shape[0]} segments x {nrow} identity rows = {n_flows} flows, K2 + K6",
        iters=1, plain_iters=1, reps=3)

    # the plain flow-route sweep (_sweep_device, no attribution) at the
    # same segments: off the main paths, timed once for its row
    def sweep_flow():
        return matmod._sweep_device(device, *seg, nrow, True, 8192)

    def sweep_flow_plain():
        real = verdictmod.bool_mm
        verdictmod.bool_mm = bool_mm_plain
        try:
            return sweep_flow()
        finally:
            verdictmod.bool_mm = real

    err = max(max_abs_err(a, b) for a, b in zip(sweep_flow(), sweep_flow_plain()))
    if err:
        fail("sweep_device disagrees with its plain version")
    ms, clk = timed(sweep_flow, iters=1, reps=3)
    plain_ms, _ = timed(sweep_flow_plain, iters=1, reps=3)
    b_ms, b_by = bound(nbytes(device.sel_match, *sweep_flow()), sweep_ops(t_in, n_flows))
    print(f"sweep_device (no attribution, off the main paths) {seg[0].shape[0]} segments x {nrow} "
          f"identity rows = {n_flows} flows, K2: max_abs_err {err}, ms {median(ms)!r} {ms} (SM "
          f"clock after: {clk}), plain_ms {median(plain_ms)!r} {plain_ms}, bound_ms {b_ms!r} "
          f"({b_by}) [{card}]", flush=True)

    # K7 / K8 on the bench's L7 corpus (bench.py:266-430): the unfused
    # walk at max_len 64 over int32 bytes (the l7_dfa_rps definition),
    # then the fused entry and the pair walk at every length rung over the
    # same corpus padded to the rung
    mdfa = compile_patterns(L7_PATHS)
    l7_paths = [f"/api/v{i % 8}/obj{i % 97}".encode() for i in range(L7_BATCH)]
    sb, lens = strings_to_batch(l7_paths, 64)
    trans, alo, ahi, start = device_dfa(mdfa)
    sb_t, lens_t = torch.from_numpy(sb).to(dev), torch.from_numpy(lens).to(dev)
    args7 = (trans, alo, ahi, start, sb_t, lens_t, 64)
    plain7 = (trans, alo, ahi, start.expand(L7_BATCH), sb_t, lens_t, 64)
    k_out = dfa_match_batch(*args7)
    if not bool((k_out[0] != 0).all()):
        fail("a bench corpus path matched no pattern")
    b_ms, b_by = bound(dfa_touched_bytes(trans, start.reshape(1), sb_t, lens_t, 64, False), 0)
    row("dfa_walk", "cilium_tpu_torch/csrc/dfa_walk.cu", "cilium_tpu/ops/dfa.py:104",
        max(max_abs_err(a, b) for a, b in zip(k_out, dfa_walk_plain(*plain7))),
        lambda: dfa_match_batch(*args7), lambda: dfa_walk_plain(*plain7), b_ms, b_by,
        f"{L7_BATCH} paths, int32 bytes, max_len 64, Q {trans.shape[0]}", graph=True)
    table = DeviceDFATable(("bench-l7",), fuse_dfas([mdfa]))
    if not table.has_pair:
        fail("the bench corpus's fused table has no pair table")
    st = torch.from_numpy(np.repeat(table.starts_host, L7_BATCH)).to(dev)
    for rung in L7_LEN_LADDER:
        rp = l7_paths if rung == L7_LEN_LADDER[0] else [(x + b"x" * rung)[:rung] for x in l7_paths]
        usb, ul = (torch.from_numpy(a).to(dev) for a in strings_to_batch_u8(rp, rung))
        a8 = (table.accept_lo, table.accept_hi, st, usb, ul, rung)
        for name, rep, fn, plain, tab, pair in (
            ("dfa_walk_fused", ":236", dfa_match_batch_fused, dfa_walk_plain, table.trans, False),
            ("dfa_pair_walk", ":264", dfa_match_batch_pair, dfa_pair_walk_plain, table.pair, True),
        ):
            k_out = fn(tab, *a8)
            if not bool((k_out[0] != 0).all()):
                fail(f"{name}: a padded corpus path matched no pattern at rung {rung}")
            b_ms, b_by = bound(dfa_touched_bytes(tab, st, usb, ul, rung, pair), 0)
            row(name, f"cilium_tpu_torch/csrc/{'dfa_pair_walk' if pair else 'dfa_walk'}.cu",
                f"cilium_tpu/ops/dfa.py{rep}",
                max(max_abs_err(x, y) for x, y in zip(k_out, plain(tab, *a8))),
                lambda fn=fn, tab=tab, a8=a8: fn(tab, *a8),
                lambda plain=plain, tab=tab, a8=a8: plain(tab, *a8), b_ms, b_by,
                f"{L7_BATCH} paths, uint8 bytes, rung {rung}, Q {table.n_states}", graph=True)
    # K7's fused entry on the pattern-cap policy's table (Q 735, no pair
    # table) over its main-path batch packed as submit() packs it, in
    # one launch (the pipeline launches it in 16 384-row chunks)
    ptab = l7res["pol_b"]._fused_table
    reqs_b = l7res["reqs_b"]
    cols = [[q.method.encode() for q in reqs_b], [q.path.encode() for q in reqs_b],
            [q.host.encode() for q in reqs_b]]
    flat = cols[0] + cols[1] + cols[2]
    rung = len_rung(min(max(map(len, flat)), 256), 256)
    usb, ul = strings_to_batch_u8(flat, rung)
    ul[:L7_BATCH][ul[:L7_BATCH] > 16] = -1
    usb, ul = torch.from_numpy(usb).to(dev), torch.from_numpy(ul).to(dev)
    st = torch.from_numpy(np.repeat(ptab.starts_host, L7_BATCH)).to(dev)
    a8 = (ptab.accept_lo, ptab.accept_hi, st, usb, ul, rung)
    k_out = dfa_match_batch_fused(ptab.trans, *a8)
    b_ms, b_by = bound(dfa_touched_bytes(ptab.trans, st, usb, ul, rung, False), 0)
    row("dfa_walk_fused", "cilium_tpu_torch/csrc/dfa_walk.cu", "cilium_tpu/ops/dfa.py:236",
        max(max_abs_err(x, y) for x, y in zip(k_out, dfa_walk_plain(ptab.trans, *a8))),
        lambda: dfa_match_batch_fused(ptab.trans, *a8), lambda: dfa_walk_plain(ptab.trans, *a8),
        b_ms, b_by, f"pattern-cap policy: {len(flat)} rows (3 fields), rung {rung}, "
        f"Q {ptab.n_states}", plain_iters=2, reps=3, graph=True)

    # K9 lb_translate over each family's pass-1 batch of the services
    # phase: v4 1 048 576 flows x 1 024 frontends, v6 x 256. Bound by the
    # int32 compares of a first-match scan on the CUDA cores, not tensor-core
    # work (lb_scan_ops), or by the bytes: tables, flows and outputs once
    for fam in (4, 6):
        q = svc["seqs"][fam]
        tabs, flows = lb_inputs(svc["pipe"], fam, q["pb"], *q["batch"][1:])
        k_out = lb_translate(tabs, *flows)
        p_out = lb_translate_plain(tabs, *flows)
        err = max(max_abs_err(a, b) for a, b in zip(k_out, p_out))
        ops = lb_scan_ops(tabs, *flows[:3])
        tab_t = [getattr(tabs, f.name) for f in dataclasses.fields(tabs)]
        b_ms, b_by = bound(nbytes(*tab_t, *flows, *k_out), ops, INT32_OPS_PER_S)
        f_n, length = tabs.fe_bytes.shape
        row("lb_translate", "cilium_tpu_torch/csrc/lb_translate.cu", "cilium_tpu/lb/device.py:51",
            err, lambda tabs=tabs, flows=flows: lb_translate(tabs, *flows),
            lambda tabs=tabs, flows=flows: lb_translate_plain(tabs, *flows), b_ms, b_by,
            f"v{fam}: {BATCH} flows x {f_n} frontends (L {length}), {tabs.be_port.shape[0]} "
            f"backends, {ops} scan compares at {INT32_OPS_PER_S:.4g} int32 op/s",
            plain_iters=2, reps=5)

    ct_step_rows(dct, dev, row)

    # one JSON entry per kernel: a kernel timed on several inputs keeps
    # its first input's numbers and the largest error of all its checks
    total = {k: sum(p.get(k, 0) for p in launches.values()) for k in _kernels.launches()}
    total["sweep_device_attrib"] = sweeps.get("flow_attrib", 0)
    if total["ct_probe_claim"] != total["ct_commit"]:
        fail(f"K10's entries launched {total['ct_probe_claim']} and {total['ct_commit']} times")
    total["ct_step"] = total["ct_probe_claim"]
    by_name = {}
    for r in rows:
        if r["name"] in by_name:
            by_name[r["name"]]["err"] = max(by_name[r["name"]]["err"], r["err"])
        else:
            by_name[r["name"]] = dict(r)
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{median(r['library_ms'])!r} {r['library_ms']}"
        graph = "" if r["graph_ms"] is None else (
            f", in a CUDA graph (no wrapper host work) {median(r['graph_ms'])!r} {r['graph_ms']}")
        print(f"kernel {r['name']:<24} {r['shape']}: launches {total[r['name']]}, "
              f"max_abs_err {r['err']}, ms {median(r['ms'])!r} {r['ms']} (SM clock after: "
              f"{r['clock']}){graph}, plain_ms {median(r['plain_ms'])!r} {r['plain_ms']} (SM "
              f"clock after: {r['plain_clock']}), library_ms {lib}, bound_ms {r['bound_ms']!r} "
              f"({r['bound_by']}) [{card}]", flush=True)
        if r["err"] != 0:
            fail(f"kernel {r['name']} disagrees with its plain version")
        if total[r["name"]] <= 0:
            fail(f"kernel {r['name']} has no launch on a main path")
    torch.cuda.synchronize()
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)

    print(card)
    print(json.dumps({"kernels": [
        {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": total[r["name"]],
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
