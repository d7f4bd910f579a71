"""Where K8 dfa_pair_walk's time goes on the card, beside K7's class
walk on the same rows: a probe, not a test.

    python3 tools/k8_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k8_probe/, cilium_tpu_torch/csrc/dfa_pair_walk.cu (K8) and
cilium_tpu_torch/csrc/dfa_walk.cu (K7) as they are, copies of K7 with
its class walk's steps a byte at a time and with phases compiled out,
tools/k8_pair_classes.cu (the walk over the pair table's own classes,
tried and not kept) with its rows padded and not, and
tools/k8_first_version.cu (K8's first version: one thread a row in
blocks of 256, a scalar read a byte, every step a gather from the
[Q, 257 * 257] pair table through L1 / L2), and times each through its C
entry in a CUDA graph (chip_smoke.graph_ms: the device's time without
the wrapper's host work) on:

  bench rung R     the bench's L7 corpus (bench.py:266-430: 16 path
                   patterns, Q 59), 131 072 paths as uint8 rows padded
                   to rung R = 16, 32, 64, 128 (chip_smoke's K8 rows),
                   and truncated to R = 4 and 8 (rows under one 16-byte
                   vector, as a field cap under 16 gives)
  bench rung R N   its first N rows: N = 512, 4 096 and 16 384 (the L7
                   pipeline's lane rungs) at rung 16, 16 384 at 4 and 8
  kafka            the Kafka ACL's table (chip_smoke.kafka_bench: 32
                   topic literals), one 16 384-row chunk of its topic
                   rows at rung 3, as check_kafka packs them
  redirect R       a redirect group's method + path table (HTTP rules
                   drawn as chip_smoke.build_world draws them), 2 048
                   requests' two fields (4 096 rows) packed as
                   L7Pipeline.submit packs them: rung 16, and rung 256
                   when one path is longer than 128 bytes (the main
                   path's groups hold such paths)

Variants, each through its C entry with its route flags:

  first version       tools/k8_first_version.cu
  pair + vector       K8: the pair table through L1 / L2, 16-byte rows
  pair + scalar       the same, a byte read a step
  K7 classes          K7's class route: the [Q + 1, C] class table and
                      [256] class map (ops/dfa.py class_table) in shared
                      memory, a dependent read a byte, 16-byte rows where
                      the layout allows, else a byte read a step and two
                      steps a pair (the L7 walk of these tables from
                      16-byte rows: ops/dfa.py l7_walk_route)
  K7 classes, a step  the same with its scalar rows a step and a bound
  a byte              check a byte (K7's scalar loop before; its vector
                      rows as "K7 classes")
  pair classes        tools/k8_pair_classes.cu on its pair-class route
                      (pair_class_table below: one read a pair from a
                      [Q + 1, C0, C1] table), 16-byte rows where the
                      layout allows, its state rows one word apart
  pair classes, rows  the same with its rows C0 x C1 entries apart (a
  unpadded            multiple of 32 banks)

and floors of K7's class route with its later phases compiled out
(their output is not checked):

  no steps            the table copied and the rows read, each step's
                      column folded into the state instead of a table
                      read
  copy alone          the table copied, no row walked

A route the layout does not allow is skipped (a 3-byte row has no
vector route). Every other variant's masks are held against the plain
version (ops/dfa.py dfa_pair_walk_plain); a mismatch exits non-zero. The
patches match exact source lines and the probe exits non-zero when one
is gone, so edit PATCHES with the kernels. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import random
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "cilium_tpu_torch" / "csrc"
SRC = CSRC / "dfa_pair_walk.cu"
K7 = CSRC / "dfa_walk.cu"
PAIR_CLASSES = Path(__file__).resolve().parent / "k8_pair_classes.cu"
FIRST = Path(__file__).resolve().parent / "k8_first_version.cu"
OUT = REPO / "build" / "k8_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]

STEPS = "                    const int nx = shared_step<TAB>(p, s_trans, state, col[j]);\n"
SCALAR_PAIRS = """        for (int lvl = 0; lvl < end; lvl += 2) {
            state = shared_step<TAB>(p, s_trans, state,
                                     column<TAB>(p, s_class, (int)__ldg(row + lvl)));
            if (lvl + 1 < end)
                state = shared_step<TAB>(p, s_trans, state,
                                         column<TAB>(p, s_class, (int)__ldg(row + lvl + 1)));
        }
"""
SCALAR_BYTES = """        for (int lvl = 0; lvl < end; ++lvl) {
            state = shared_step<TAB>(p, s_trans, state,
                                     column<TAB>(p, s_class, (int)__ldg(row + lvl)));
            if ((unsigned)state >= q) return -1;
        }
"""
ROWS = "    for (; i < p.b; i += step) {\n"
PAD = "constexpr bool PAD_ROWS = true;\n"
# (source, [(old, new), ...]) for each library built
PATCHES = {
    "pair": (SRC, []),
    "K7": (K7, []),
    "K7 a step a byte": (K7, [(SCALAR_PAIRS, SCALAR_BYTES)]),
    "no steps": (K7, [(STEPS, "                    const int nx = state ^ col[j];\n")]),
    "copy alone": (K7, [(ROWS, "    for (; i < p.b && p.max_len < 0; i += step) {\n")]),
    "pair classes": (PAIR_CLASSES, []),
    "pair classes, rows unpadded": (PAIR_CLASSES, [(PAD, "constexpr bool PAD_ROWS = false;\n")]),
    "first version": (FIRST, []),
}
# variant: (library, C entry kind, vector rows)
VARIANTS = {
    "first version": ("first version", "first", 0),
    "pair + vector": ("pair", "pair", 1),
    "pair + scalar": ("pair", "pair", 0),
    "K7 classes": ("K7", "k7", 1),
    "K7 classes, a step a byte": ("K7 a step a byte", "k7", 1),
    "pair classes": ("pair classes", "pair classes", 1),
    "pair classes, rows unpadded": ("pair classes, rows unpadded", "pair classes", 1),
    "no steps": ("no steps", "k7", 1),
    "copy alone": ("copy alone", "k7", 1),
}
FLOORS = ("no steps", "copy alone")
N_ROWS = 1 << 17


def build() -> dict:
    """One shared library per variant, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, (name, (path, patches)) in enumerate(PATCHES.items()):
        src = path.read_text()
        for old, new in patches:
            if old not in src:
                sys.exit(f"k8_probe: the line {old!r} of {path.name} is gone; edit PATCHES")
            src = src.replace(old, new)
        cu = OUT / f"v{k}.cu"
        cu.write_text(src)
        so = OUT / f"v{k}.so"
        procs[name] = (so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-I", str(CSRC), str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k8_probe: nvcc failed on {name!r}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib, kind: str):
    """The library's C entry with its argtypes: "pair" (K8), "k7" (K7's
    cilium_dfa_walk, a start a row), "pair classes" (the pair-class
    table) or "first" (no route flags)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if kind == "k7":
        fn = lib.cilium_dfa_walk
        fn.argtypes = [P, I, P, P, P, I, P, I, I, I, P, P, P, L, I, I, P, P, I, I, P]
    else:
        tail = {"pair": [I], "pair classes": [I, I, P, P, P, I, I], "first": []}[kind]
        fn = lib.cilium_dfa_pair_walk
        fn.argtypes = [P, I, P, P, P, P, I, I, I, P, P, P, L, *tail, I, P]
    fn.restype = ctypes.c_int
    return fn


def _slice_classes(slices):
    """[N, K] slices → (class [N] of each slice, numbered in the order of
    its first slice; the index of each class's first slice)."""
    import numpy as np

    rows = np.ascontiguousarray(slices)
    keys = rows.view(np.dtype((np.void, rows.dtype.itemsize * rows.shape[1]))).reshape(-1)
    _, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return rank[inverse.reshape(-1)], first[order]


def pair_class_table(pair):
    """The pair table's own classes, tools/k8_pair_classes.cu's form →
    (class0 [256] uint8, class1 [257] uint8, pair_cls [Q + 1, C0, C1]
    int16 bit views of uint16 state ids), or None where (Q + 1) x C0 x
    C1 > DFA_SMEM_ENTRIES or C0 or C1 passes 256.

    Bytes a whose first-position slices ``pair[:, a, :]`` are equal
    share a first class, bytes b (the pad 256 included) whose
    second-position slices ``pair[:, :256, b]`` are equal share a second
    class, both derived from ``pair`` itself. C0 and C1 are each axis's
    class count plus one reserved class (where a byte outside [0, 255]
    goes), padded to DFA_CLASS_PAD. Row Q is a sink state: every entry
    outside [0, Q), all of row Q and every class past an axis's classes
    is Q, so ``pair_cls[s, class0[a], class1[b]] == pair[s, a * 257 + b]``
    wherever ``pair`` stays inside [0, Q)."""
    import numpy as np

    sys.path.insert(0, str(REPO))
    from cilium_tpu_torch.ops.dfa import DFA_CLASS_PAD, DFA_SMEM_ENTRIES, PAIR_ALPHA

    pair = np.asarray(pair, np.int32)
    q = pair.shape[0]
    p = pair.reshape(q, PAIR_ALPHA, PAIR_ALPHA)[:, :256, :]  # the first position is a byte
    class0, rep0 = _slice_classes(p.transpose(1, 0, 2).reshape(256, -1))
    class1, rep1 = _slice_classes(p.transpose(2, 0, 1).reshape(PAIR_ALPHA, -1))
    c0, c1 = (-(-(n.size + 1) // DFA_CLASS_PAD) * DFA_CLASS_PAD for n in (rep0, rep1))
    if c0 > 256 or c1 > 256 or (q + 1) * c0 * c1 > DFA_SMEM_ENTRIES:
        return None
    cls = p[:, rep0][:, :, rep1]
    out = np.full((q + 1, c0, c1), q, np.uint16)
    out[:q, :rep0.size, :rep1.size] = np.where((cls >= 0) & (cls < q), cls, q)
    return class0.astype(np.uint8), class1.astype(np.uint8), out.view(np.int16)


def redirect_group(dev):
    """A redirect group's HTTP policy (three port-80 rules' HTTP rules,
    drawn as chip_smoke.build_world draws them) and 2 048 requests:
    half on one of its rules, the rest on corpus paths."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch.l7 import HTTPPolicy
    from cilium_tpu_torch.policy.api import HTTPRule

    hrng = random.Random(80)
    rules = [(HTTPRule(method=hrng.choice(["GET", "POST"]) if hrng.random() < 0.5 else "",
                       path=p), None)
             for _ in range(3) for p in hrng.sample(smoke.L7_PATHS, hrng.randint(1, 3))]
    pol = HTTPPolicy(rules, device=dev)
    pol._ensure_fused()
    rng = random.Random(81)
    corpus = [f"/api/v{a}/obj{a}" for a in range(10)] + [f"/svc{a}/x/y" for a in range(10)]
    methods, paths = [], []
    for _ in range(2048):
        if rng.random() < 0.5:
            rule = rng.choice(rules)[0]
            paths.append(rule.path.replace("[a-z0-9]*", "obj7").replace(".*", "x/y"))
            methods.append(rule.method or "GET")
        else:
            paths.append(rng.choice(corpus))
            methods.append(rng.choice(["GET", "POST", "PUT", "DELETE"]))
    return pol._fused_table, [m.encode() for m in methods], [p.encode() for p in paths]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k8_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch.l7 import KafkaACL
    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops.dfa import (
        DeviceDFATable, dfa_pair_walk_plain, dfa_pair_walk_route, fuse_dfas, l7_walk_route,
        len_rung, strings_to_batch_u8,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def packed(table, fields, caps):
        """The rows, lengths and starts L7Pipeline.submit packs."""
        flat = [s for f in fields for s in f]
        cap_max = max(caps)
        rung = len_rung(min(max(map(len, flat)), cap_max), cap_max)
        sb, lens = strings_to_batch_u8(flat, rung)
        n = len(fields[0])
        for f, cap in enumerate(caps):
            seg = lens[f * n:(f + 1) * n]
            seg[seg > cap] = -1
        return t(sb), t(lens), t(np.repeat(table.starts_host, n)), rung

    # the shapes: (name, DeviceDFATable, rows, lengths, starts, max_len)
    shapes = []
    bench = DeviceDFATable(("bench-l7",), fuse_dfas([compile_patterns(smoke.L7_PATHS)]), dev)
    paths = [f"/api/v{i % 8}/obj{i % 97}".encode() for i in range(N_ROWS)]
    bst = t(np.repeat(bench.starts_host, N_ROWS))
    for rung in (4, 8, 16, 32, 64, 128):
        rp = paths if rung == 16 else [(x + b"x" * rung)[:rung] for x in paths]
        sb, lens = (t(a) for a in strings_to_batch_u8(rp, rung))
        shapes.append((f"bench rung {rung}", bench, sb, lens, bst, rung))
        if rung < 16:
            shapes.append((f"bench rung {rung} 16384", bench, sb[:16384].clone(),
                           lens[:16384].clone(), bst[:16384].clone(), rung))
        if rung == 16:
            for rows in (512, 4096, 16384):
                shapes.append((f"bench rung 16 {rows}", bench, sb[:rows].clone(),
                               lens[:rows].clone(), bst[:rows].clone(), 16))
    k_rules, k_reqs = smoke.kafka_bench()
    acl = KafkaACL(k_rules, device=dev)
    acl._ensure_fused()
    ktab = acl._fused_table
    topics = [q.topic.encode() for q in k_reqs[:16384]]
    sb, lens, st, rung = packed(ktab, [topics], [c for _, c in acl._fused_fields])
    shapes.append(("kafka", ktab, sb, lens, st, rung))
    rtab, methods, rpaths = redirect_group(dev)
    for name, ps in (("redirect 16", rpaths),
                     ("redirect 256", rpaths[:-1] + [b"/api/v1/" + b"a" * 150])):
        sb, lens, st, rung = packed(rtab, [methods, ps], [16, 256])
        shapes.append((name, rtab, sb, lens, st, rung))

    forms = {}
    for name, tab, sb, lens, st, max_len in shapes:
        if not tab.has_pair or tab.class_trans is None:
            sys.exit(f"k8_probe: the {name} table has no pair table or class table")
        if id(tab) not in forms:
            form = pair_class_table(tab.pair.cpu().numpy())
            if form is None:
                sys.exit(f"k8_probe: the {name} table's pair classes do not fit")
            forms[id(tab)] = tuple(t(a) for a in form)
        m0, m1, pcls = forms[id(tab)]
        c0, c1 = pcls.shape[1:]
        b, q, c = sb.shape[0], tab.n_states, tab.class_trans.shape[1]
        plain = dfa_pair_walk_plain(tab.pair, tab.accept_lo, tab.accept_hi, st, sb, lens, max_len)
        out_lo = torch.empty(b, dtype=torch.int32, device=dev)
        out_hi = torch.empty(b, dtype=torch.int32, device=dev)
        print(f"{name}: Q {q}, class table [{q + 1}, {c}] ({(q + 1) * c * 2} bytes), pair-class "
              f"table [{q + 1}, {c0}, {c1}] ({pcls.numel() * 2} bytes), rows {b}, max_len "
              f"{max_len}, live bytes {int(lens.clamp(min=0, max=max_len).sum())}; the L7 walk "
              f"takes {l7_walk_route(True, True, max_len)!r}, K8 reads its rows "
              f"{dfa_pair_walk_route(sb.shape[1], 1, sb.data_ptr())!r}", flush=True)
        pair_head = (tab.pair.data_ptr(), q, tab.accept_lo.data_ptr(), tab.accept_hi.data_ptr(),
                     st.data_ptr(), sb.data_ptr(), 1, sb.shape[1], max_len, lens.data_ptr(),
                     out_lo.data_ptr(), out_hi.data_ptr(), b)
        k7_head = (tab.trans.data_ptr(), q, tab.accept_lo.data_ptr(), tab.accept_hi.data_ptr(),
                   st.data_ptr(), 1, sb.data_ptr(), 1, sb.shape[1], max_len, lens.data_ptr(),
                   out_lo.data_ptr(), out_hi.data_ptr(), b)
        vec = int(sb.shape[1] % 16 == 0)
        for vname, (lib, kind, want_vec) in VARIANTS.items():
            v = want_vec and vec
            if kind == "pair" and want_vec and not vec:
                continue  # "pair + scalar" times this layout
            args = {
                "first": pair_head,
                "pair": (*pair_head, v),
                "k7": (*k7_head, 2, v, tab.byte_class.data_ptr(), tab.class_trans.data_ptr(), c),
                "pair classes": (*pair_head, 1, v, m0.data_ptr(), m1.data_ptr(), pcls.data_ptr(),
                                 c0, c1),
            }[kind]
            fn = entry(libs[lib], kind)

            def call(fn=fn, args=args, vname=vname):
                err = fn(*args, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"k8_probe: {vname} failed to launch on {name} ({err})")

            out_lo.fill_(-7)
            call()
            bad = sum(int((a != w).sum()) for a, w in zip((out_lo, out_hi), plain))
            ms = smoke.graph_ms(call)
            checked = vname not in FLOORS
            print(f"{name:<20} {vname:<27} graph_ms {smoke.median(ms)!r} {ms}, "
                  f"{f'mismatches {bad}' if checked else 'not checked'} [{card}]", flush=True)
            if checked and bad:
                sys.exit(1)

if __name__ == "__main__":
    main()
