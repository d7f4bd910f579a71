"""Where K7 dfa_walk's time goes on the card: a probe, not a test.

    python3 tools/k7_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k7_probe/, cilium_tpu_torch/csrc/dfa_walk.cu as it is, a copy with
the next chunk's load moved behind the walk of the current one, and
tools/k7_first_walk.cu (the first version: one thread a row, a byte read
a step, the table through L1 / L2, a block per 256 rows), and times each
in a CUDA graph (chip_smoke.graph_ms: the device's time without the
wrapper's host work) on chip_smoke's K7 shapes:

  int32 max_len 64   the bench's L7 corpus (bench.py:266-430: 16 path
                     patterns, Q 59), 131 072 paths as int32 bytes at
                     max_len 64, one start (the dfa_walk entry)
  int32 max_len 256  the same paths at max_len 256 (a 1 KB row stride),
                     as HTTPPolicy.masks packs a path field; also its
                     first 2 048, 16 384 and 65 536 rows
  cap paths int32    the pattern-cap policy's path automaton alone
                     (Q 245) over 16 384, 65 536 and 131 072 of its
                     paths, int32
                     at max_len 256, as the off path walks the field
  uint8 rung 16      the same corpus as uint8 bytes at rung 16, per-row
                     starts (the dfa_walk_fused entry)
  uint8 rung 64      padded to rung 64
  cap rung 256       the pattern-cap policy's fused table (chip_smoke's
                     cap_policy_rules: Q 735, no pair table) over three
                     fields of 131 072 cap_requests at rung 256
  cap N rows         4 096, 16 384 (l7_pipeline.submit's chunk) and
                     65 536 of its path rows
  uint8 rung R N rows  the first 4 096 and 16 384 rows at rungs 16, 64

Routes of the kernel as built, each through its C entry with the route
flags set (ops/dfa.py dfa_walk_route picks one from the table and the
row layout):

  shared + vector    the table in shared memory, the row in 16-byte loads
  shared + scalar    the table in shared memory, a byte read a step
  classes + vector   the table's byte classes (ops/dfa.py class_table,
                     built here once a table) in shared memory: the
                     [Q, C] class table and the [256] class map
  L2 + vector        the table through L1 / L2, the row in 16-byte loads
  L2 + scalar        the table through L1 / L2, a byte read a step (the
                     first version's reads on the persistent grid)
  no lookahead       classes + vector, the next chunk loaded only once
                     the current one is walked
  a branch at each   classes + vector, a branch out of the chunk at the
  step               row's end (the kernel takes every step of a chunk,
                     one past the row's end keeping the state by a select)
  blocks from 128    classes + vector, a shared table's blocks 128 to
                     1 024 threads (the kernel's: 256 to 1 024)
  blocks of 1 024    classes + vector in blocks of 1 024 threads
  first version      the first version

Then a sweep of the [Q + 1, 256] shared table against the L2 walk
over table sizes and row counts as the off path launches them
(route_sweep). Every variant's masks are held against the plain version
(ops/dfa.py dfa_walk_plain); a mismatch exits non-zero. The patch
matches an exact source line and the probe exits non-zero when it is
gone, so edit PATCHES with the kernel. Prints the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "cilium_tpu_torch" / "csrc" / "dfa_walk.cu"
FIRST = Path(__file__).resolve().parent / "k7_first_walk.cu"
OUT = REPO / "build" / "k7_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared"]

NEXT = "            const uint4 nxt = c + 1 < chunks ? __ldg(vrow + c + 1) : cur;\n"
FLOOR = "        threads = 256;\n"
IN_STEP = "                const bool in = j < left;\n"
PATCHES = {
    "kernel": [],
    "no lookahead": [(NEXT, ""),
                     ("            cur = nxt;\n",
                      "            if (c + 1 < chunks) cur = __ldg(vrow + c + 1);\n")],
    "a branch at each step": [
        (IN_STEP, "                if (j >= left) break;\n                const bool in = true;\n")],
    "blocks from 128": [(FLOOR, "        threads = 128;\n")],
    "blocks of 1 024": [(FLOOR, "        threads = 1024;\n")],
}
ROUTES = {"shared + vector": (1, 1), "shared + scalar": (1, 0), "classes + vector": (2, 1),
          "L2 + vector": (0, 1), "L2 + scalar": (0, 0)}
N_ROWS = 1 << 17
CHUNKS = (1 << 12, 1 << 14, 1 << 16)  # batch sizes below the full one


def build() -> dict:
    """One shared library per source, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    sources = {}
    for name, patches in PATCHES.items():
        src = text
        for old, new in patches:
            if old not in src:
                sys.exit(f"k7_probe: the line {old!r} of {SRC.name} is gone; edit PATCHES")
            src = src.replace(old, new)
        sources[name] = src
    sources["first version"] = FIRST.read_text()
    procs = {}
    for k, (name, src) in enumerate(sources.items()):
        cu = OUT / f"v{k}.cu"
        cu.write_text(src)
        so = OUT / f"v{k}.so"
        procs[name] = (so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-I", str(SRC.parent), str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k7_probe: nvcc failed on {name!r}:\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib, routed: bool):
    """The library's cilium_dfa_walk with its argtypes (the first version
    takes no route flags)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.cilium_dfa_walk
    fn.argtypes = [P, I, P, P, P, I, P, I, I, I, P, P, P, L,
                   *([I, I, P, P, I] if routed else []), I, P]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k7_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch.l7 import HTTPPolicy
    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops.dfa import (
        DFA_SMEM_MAX_Q, DeviceDFATable, class_table, device_dfa, dfa_walk_plain, dfa_walk_route,
        fuse_dfas, strings_to_batch, strings_to_batch_u8,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the shapes: (name, trans, accept lo, hi, starts, start stride, bytes, lengths, max_len)
    shapes = []
    paths = [f"/api/v{i % 8}/obj{i % 97}".encode() for i in range(N_ROWS)]
    trans, alo, ahi, start = device_dfa(compile_patterns(smoke.L7_PATHS), dev)
    for max_len in (64, 256):
        sb, lens = strings_to_batch(paths, max_len)
        shapes.append((f"int32 max_len {max_len}", trans, alo, ahi, start.reshape(1), 0, t(sb),
                       t(lens), max_len))
    for rows in (2048, CHUNKS[1], CHUNKS[2]):  # a redirect group's field batch, larger ones
        shapes.append((f"int32 max_len 256 {rows} rows", trans, alo, ahi, start.reshape(1), 0,
                       t(sb[:rows]), t(lens[:rows]), 256))
    table = DeviceDFATable(("bench-l7",), fuse_dfas([compile_patterns(smoke.L7_PATHS)]), dev)
    st = t(np.repeat(table.starts_host, N_ROWS))
    for rung in (16, 64):
        rp = paths if rung == 16 else [(x + b"x" * rung)[:rung] for x in paths]
        sb, lens = strings_to_batch_u8(rp, rung)
        shapes.append((f"uint8 rung {rung}", table.trans, table.accept_lo, table.accept_hi, st, 1,
                       t(sb), t(lens), rung))
        for rows in CHUNKS[:2]:
            shapes.append((f"uint8 rung {rung} {rows} rows", table.trans, table.accept_lo,
                           table.accept_hi, st[:rows].clone(), 1, t(sb[:rows]), t(lens[:rows]),
                           rung))
    pol = HTTPPolicy(smoke.cap_policy_rules(), device=dev)
    cap = DeviceDFATable(("cap",), fuse_dfas([ps.dfa for ps in (pol._methods, pol._paths,
                                                                pol._hosts) if ps.dfa is not None]),
                         dev)
    reqs = smoke.cap_requests(0, N_ROWS)
    # the off path's walk of the policy's path field alone (HTTPPolicy.masks)
    ptrans, palo, pahi, pstart = device_dfa(pol._paths.dfa, dev)
    psb, plens = strings_to_batch([q.path.encode() for q in reqs], 256)
    for rows in (CHUNKS[1], CHUNKS[2], N_ROWS):
        shapes.append((f"cap paths int32 {rows} rows", ptrans, palo, pahi, pstart.reshape(1), 0,
                       t(psb[:rows]), t(plens[:rows]), 256))
    flat = ([q.method.encode() for q in reqs] + [q.path.encode() for q in reqs]
            + [q.host.encode() for q in reqs])
    sb, lens = strings_to_batch_u8(flat, 256)
    lens[:N_ROWS][lens[:N_ROWS] > 16] = -1
    cst = t(np.repeat(cap.starts_host, N_ROWS))
    shapes.append(("cap rung 256", cap.trans, cap.accept_lo, cap.accept_hi, cst, 1, t(sb),
                   t(lens), 256))
    for rows in CHUNKS:  # path rows, as l7_pipeline.submit's chunks hold them
        mid = N_ROWS + N_ROWS // 2 if rows <= N_ROWS // 2 else N_ROWS
        shapes.append((f"cap {rows} rows", cap.trans, cap.accept_lo, cap.accept_hi,
                       cst[mid:mid + rows].clone(), 1, t(sb[mid:mid + rows]),
                       t(lens[mid:mid + rows]), 256))
    print(f"bench corpus Q {trans.shape[0]}, pattern-cap table Q {cap.n_states} "
          f"(shared-memory budget Q {DFA_SMEM_MAX_Q})", flush=True)

    classes = {}
    for name, tr, lo, hi, starts, sstride, sb, lens, max_len in shapes:
        b = sb.shape[0]
        q = tr.shape[0]
        if tr.data_ptr() not in classes:
            classes[tr.data_ptr()] = tuple(t(a) for a in class_table(tr.cpu().numpy()))
        cmap, ctab = classes[tr.data_ptr()]
        plain = dfa_walk_plain(tr, lo, hi, starts.expand(b) if sstride == 0 else starts, sb, lens,
                               max_len)
        out_lo = torch.empty(b, dtype=torch.int32, device=dev)
        out_hi = torch.empty(b, dtype=torch.int32, device=dev)

        head = (tr.data_ptr(), q, lo.data_ptr(), hi.data_ptr(), starts.data_ptr(), sstride,
                sb.data_ptr(), sb.element_size(), sb.shape[1], max_len, lens.data_ptr(),
                out_lo.data_ptr(), out_hi.data_ptr(), b)
        # the wrapper's route: a fused table comes with its classes
        wrap = dfa_walk_route(q, b, sb.shape[1], sb.element_size(), sb.data_ptr(),
                              ctab.shape[1] if sstride else 0)
        print(f"{name}: Q {q}, class table [{q}, {ctab.shape[1]}], rows {b}; the wrapper's "
              f"route {wrap}", flush=True)
        cls = (cmap.data_ptr(), ctab.data_ptr(), ctab.shape[1])
        variants = []
        for route, (table, vec) in ROUTES.items():
            if table == 1 and q > DFA_SMEM_MAX_Q:
                continue
            variants.append((route, entry(libs["kernel"], True),
                             (table, vec, *(cls if table == 2 else (None, None, 0)))))
        classes_route = (2, 1, *cls)
        for vname in ("no lookahead", "blocks from 128", "blocks of 1 024"):
            variants.append((vname, entry(libs[vname], True), classes_route))
        variants.append(("a branch at each step", entry(libs["a branch at each step"], True),
                         classes_route))
        variants.append(("first version", entry(libs["first version"], False), ()))
        for vname, fn, flags in variants:
            def call(fn=fn, flags=flags):
                err = fn(*head, *flags, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"k7_probe: {vname} failed to launch on {name} ({err})")

            out_lo.fill_(-7)
            call()
            bad = sum(int((a != w).sum()) for a, w in zip((out_lo, out_hi), plain))
            ms = smoke.graph_ms(call)
            print(f"{name:<17} {vname:<16} graph_ms {smoke.median(ms)!r} {ms}, mismatches {bad} "
                  f"[{card}]", flush=True)
            if bad:
                sys.exit(1)
    route_sweep(libs["kernel"], card, dev)


def route_sweep(lib, card: str, dev) -> None:
    """The [Q + 1, 256] shared table against the L2 walk (both with
    vector bytes) as the off path launches them (one start, int32 bytes
    at max_len 256): automata of 1 to 16 of the bench's path patterns
    over the bench corpus, at 2 048 to 131 072 rows. The route function
    takes the shared table from DFA_SHARED_MIN_ROWS rows."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch.l7.regex_compile import compile_patterns
    from cilium_tpu_torch.ops.dfa import DFA_SHARED_MIN_ROWS, device_dfa, strings_to_batch

    fn = entry(lib, True)
    paths = [f"/api/v{i % 8}/obj{i % 97}".encode() for i in range(N_ROWS)]
    sb, lens = (torch.from_numpy(a).to(dev) for a in strings_to_batch(paths, 256))
    print(f"route sweep (shared from {DFA_SHARED_MIN_ROWS} rows): graph_ms shared / L2",
          flush=True)
    for n_pat in (1, 4, 8, 16):
        tr, lo, hi, st = device_dfa(compile_patterns(smoke.L7_PATHS[:n_pat]), dev)
        st = st.reshape(1)
        q = tr.shape[0]
        for rows in (2048, 8192, 32768, N_ROWS):
            out_lo = torch.empty(rows, dtype=torch.int32, device=dev)
            out_hi = torch.empty(rows, dtype=torch.int32, device=dev)
            head = (tr.data_ptr(), q, lo.data_ptr(), hi.data_ptr(), st.data_ptr(), 0,
                    sb.data_ptr(), 4, 256, 256, lens.data_ptr(), out_lo.data_ptr(),
                    out_hi.data_ptr(), rows)
            ms = []
            for table in (1, 0):
                def call(table=table):
                    err = fn(*head, table, 1, None, None, 0, 0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        sys.exit(f"k7_probe: the route sweep failed to launch ({err})")

                ms.append(smoke.median(smoke.graph_ms(call)))
            print(f"sweep Q {q:<4} rows {rows:<7} shared {ms[0]!r} L2 {ms[1]!r} "
                  f"shared/L2 {ms[0] / ms[1]:.3f} [{card}]", flush=True)


if __name__ == "__main__":
    main()
