"""K6 first_rule before and after its redesign, on both clocks: a probe.

    python3 tools/k6_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k6_probe/, cilium_tpu_torch/csrc/first_rule.cu as it is and a
copy whose row loop is the first version's (one byte a lane a load, no
vector reads), runs each through the port's own wrapper
(ops/verdict.py first_rule_terms, the library handle swapped for the
copy's) and times, by CUDA events around back-to-back wrapper calls
(chip_smoke.cuda_ms) and in a CUDA graph (chip_smoke.graph_ms: the
device's time without the wrapper's host work):

  one term at [8192, 640] and [8192, 4096] (the sweep block's and the
  attributed column patch's widest masks), 0.05% of the cells set;
  a sweep block's three terms ([8192, 640] x 2 and [8192, 4096]) as
  three one-term launches (the first version's three calls) and as one
  three-term launch.

Every output is checked equal to first_rule_terms_plain ("mismatches
0"). The loop patch matches exact source lines and the probe exits
non-zero when one is gone. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "cilium_tpu_torch" / "csrc" / "first_rule.cu"
OUT = REPO / "build" / "k6_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared"]

# the first version's row loop (csrc/first_rule.cu before the redesign)
BYTE_LOOP = ("    int32_t best = NO_RULE;\n",
             "    for (int j = head + nv * 16 + lane; j < s; j += 32) {\n")
BYTE_BODY = ("    int32_t best = NO_RULE;\n"
             "    for (int j = lane; j < s; j += 32) {\n"
             "        if (m[j]) best = min(best, __ldg(rule_of + j));\n"
             "    }\n"
             "    for (int j = s; j < s; ++j) {\n")
VARIANTS = ("redesigned", "byte a lane")


def build() -> dict:
    """One shared library per variant, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    lo, hi = (text.find(x) for x in BYTE_LOOP)
    if lo < 0 or hi < lo:
        sys.exit(f"k6_probe: the row loop of {SRC.name} is gone; edit BYTE_LOOP")
    sources = {"redesigned": text, "byte a lane": text[:lo] + BYTE_BODY + text[hi + len(BYTE_LOOP[1]):]}
    procs = {}
    for k, name in enumerate(VARIANTS):
        cu, so = OUT / f"v{k}.cu", OUT / f"v{k}.so"
        cu.write_text(sources[name])
        procs[name] = (so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-I", str(SRC.parent), str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k6_probe: nvcc failed on {name!r}:\n{out}")
        libs[name] = so
    return libs


class Variant:
    """A library handle for the wrapper: the copy's first_rule entry."""

    def __init__(self, path: Path) -> None:
        from cilium_tpu_torch import _kernels

        lib = ctypes.CDLL(str(path))
        k = _kernels.KERNELS["first_rule"]
        fn = getattr(lib, k.symbol)
        fn.argtypes = [*k.argtypes, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        setattr(self, k.symbol, fn)

    @staticmethod
    def cilium_error_string(err: int) -> bytes:
        return f"CUDA error {err}".encode()


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k6_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.ops.verdict import first_rule_terms, first_rule_terms_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")
    rs = np.random.default_rng(6)

    def term(width):
        mask = torch.from_numpy(rs.random((8192, width)) < 0.0005).to(dev)
        return mask, torch.from_numpy(rs.integers(0, 10_000, width).astype(np.int32)).to(dev)

    t640, t640b, t4096 = term(640), term(640), term(4096)
    cases = {"[8192, 640]": [[t640]], "[8192, 4096]": [[t4096]],
             "three terms, three launches": [[t640], [t640b], [t4096]],
             "three terms, one launch": [[t640, t640b, t4096]]}
    for name, path in libs.items():
        with _kernels._lock:
            _kernels._lib = Variant(path)
        for case, launches in cases.items():
            def fn(launches=launches):
                return [first_rule_terms(terms) for terms in launches]

            bad = sum(int((g != w).sum()) for terms, got in zip(launches, fn())
                      for g, w in zip(got, first_rule_terms_plain(terms)))
            ev, gr = smoke.cuda_ms(fn), smoke.graph_ms(fn)
            print(f"first_rule {name:<12} {case:<28} cuda_ms {smoke.median(ev)!r} graph_ms "
                  f"{smoke.median(gr)!r} (a call of {len(launches)} launch(es)), mismatches {bad} "
                  f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
