"""Where K1 selector_match's time goes on the card: a probe, not a test.

    python3 tools/k1_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k1_probe/, tools/k1_first_version.cu (the first version: one lane
a selector, every conjunct word read from device memory for every
row), cilium_tpu_torch/csrc/selector_match.cu as it is, and a copy
whose lists keep every word, and times each through its C entry in a
CUDA graph (chip_smoke.graph_ms: the device's time without the
wrapper's host work) at:

  main   the bench world's id_bits [2048, 34] and conj [640, 1, 34]
         (PolicyEngine.refresh of chip_smoke.build_world(0))
  w300   chip_smoke.k1_edge_case(N 2 048, W 300, S 640, CPS 3), seed 0:
         one to three required labels a conjunct, a tenth of them dense

Variants:

  first version         tools/k1_first_version.cu
  staged, dense words   the staged route with every word kept in the
                        lists (each entry read and popcounted)
  staged, lists         the kernel's staged route (nonzero words only)
  wide                  the kernel's wide route (the row tile not
                        staged: each entry's word from device memory)

and diagnostics of the staged route with its later phases compiled out
(their output is not checked):

  no list walk          rows and conjunct words staged, lists built
  no lists              rows and conjunct words staged
  rows only             the row tile staged, no conjunct word read
  empty                 the kernel returning at once (the launch, with
                        the staged route's shared memory)

Every other variant's output is held against the plain version
(ops/bitmap.py selector_match_plain); a mismatch exits non-zero. The
patches match exact source lines and the probe exits non-zero when one
is gone, so edit PATCHES with the kernel. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "cilium_tpu_torch" / "csrc"
FIRST = Path(__file__).resolve().parent / "k1_first_version.cu"
OUT = REPO / "build" / "k1_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]

# (old, new) patches of selector_match.cu
WALK = "            for (int e = 0; e < m; ++e) {\n"
LISTS = "        for (int b0 = lo; b0 < hi; b0 += 32) {\n"
ROUNDS = "    for (int p0 = 0; p0 < total; p0 += stage) {\n"
PATCHES = {
    "kernel": [],
    "dense words": [("                keep = (en.y | en.z) != 0 || k == 0;\n",
                     "                keep = true;\n")],
    "no list walk": [(WALK, WALK.replace("e < m", "e < 0 * m"))],
    "no lists": [(WALK, WALK.replace("e < m", "e < 0 * m")),
                 (LISTS, LISTS.replace("b0 < hi", "b0 < 0 * hi"))],
    "rows only": [(ROUNDS, ROUNDS.replace("p0 < total", "p0 < 0 * total"))],
    "empty": [("    const int lane = threadIdx.x & 31;\n",
               "    if (n > 0) return;\n    const int lane = threadIdx.x & 31;\n")],
}
DIAGNOSTIC = ("no list walk", "no lists", "rows only", "empty")


def build() -> dict:
    """One shared library per variant (and the first version), compiled
    in parallel; prints each build's registers (-Xptxas -v)."""
    procs = {}
    for k, (name, patches) in enumerate(PATCHES.items()):
        d = OUT / f"v{k}"
        d.mkdir(parents=True, exist_ok=True)
        text = (CSRC / "selector_match.cu").read_text()
        for old, new in patches:
            if old not in text:
                sys.exit(f"k1_probe: the line {old!r} of selector_match.cu is gone; edit PATCHES")
            text = text.replace(old, new)
        (d / "selector_match.cu").write_text(text)
        (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
        procs[name] = (d / "k1.so", d / "selector_match.cu")
    d = OUT / "first"
    d.mkdir(parents=True, exist_ok=True)
    (d / "common.cuh").write_text((CSRC / "common.cuh").read_text())
    procs["first version"] = (d / "k1.so", FIRST)
    running = {name: (so, subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-I", str(so.parent), str(src), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (so, src) in procs.items()}
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (so, proc) in running.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k1_probe: nvcc failed on {name!r}:\n{out}")
        print(f"build {name}: {[ln.strip() for ln in out.splitlines() if 'registers' in ln]}",
              flush=True)
        fn = ctypes.CDLL(str(so)).cilium_selector_match
        extra = [] if name == "first version" else [I]  # staged
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, *extra, I, P]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k1_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch.convert import words_i32
    from cilium_tpu_torch.engine import PolicyEngine
    from cilium_tpu_torch.ops.bitmap import selector_match_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")
    repo, reg, *_ = smoke.build_world(0)
    engine = PolicyEngine(repo, reg)
    engine.refresh()
    c = engine.snapshot()[0]
    cases = {
        "main": (words_i32(c.id_bits, dev), words_i32(c.conj_req, dev),
                 words_i32(c.conj_forbid, dev),
                 torch.from_numpy(np.ascontiguousarray(c.conj_valid, bool)).to(dev),
                 torch.from_numpy(np.ascontiguousarray(c.req_count, np.int32)).to(dev)),
        "w300": tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in smoke.k1_edge_case(np.random.default_rng(0), 2048, 300, 640, 3)),
    }
    for cname, args in cases.items():
        n, w = args[0].shape
        s, cps, _ = args[1].shape
        nz = int(((args[1] | args[2]) != 0)[args[3]].sum())
        plain = selector_match_plain(*args)
        out = torch.empty_like(plain)
        variants = [("first version", libs["first version"], None),
                    ("staged, dense words", libs["dense words"], 1),
                    ("staged, lists", libs["kernel"], 1), ("wide", libs["kernel"], 0)]
        variants += [(name, libs[name], 1) for name in DIAGNOSTIC]
        for vname, fn, staged in variants:
            def call(fn=fn, staged=staged):
                extra = () if staged is None else (staged,)
                # the current stream inside the call: a graph captures on its own
                err = fn(*(a.data_ptr() for a in args), out.data_ptr(), n, w, s, cps, *extra, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"k1_probe: {vname} failed to launch on {cname} ({err})")

            out.fill_(-7)
            call()
            bad = 0 if vname in DIAGNOSTIC else int((out != plain).sum())
            ms = smoke.graph_ms(call)
            print(f"{cname:<5} id_bits [{n},{w}] conj [{s},{cps},{w}] ({nz} nonzero words over "
                  f"valid conjuncts) {vname:<20} graph_ms {smoke.median(ms)!r} {ms}, mismatches "
                  f"{bad} [{card}]", flush=True)
            if bad:
                sys.exit(1)


if __name__ == "__main__":
    main()
