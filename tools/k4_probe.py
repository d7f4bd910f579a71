"""Where K4 policymap_verdict's time goes on the card: a probe, not a test.

    python3 tools/k4_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k4_probe/, copies of cilium_tpu_torch/csrc/policymap_verdict.cu
with parts compiled out or changed, runs each through the port's own
wrapper (ops/lookup.py policymap_verdict, the library handle swapped
for the copy's) and times both entries in a CUDA graph
(chip_smoke.graph_ms: the device's time without the wrapper's host
work) on 1 048 576 flows over a materializer-laid policymap of 288
columns and 2 048 rows (64 endpoints; chip_smoke.k4_edge_world), 10%
of the flows prefilter-denied, with a [2 048, 288] rule table of
10 000 rules for the attribution entry. "full" is also timed by CUDA
events around back-to-back wrapper calls (chip_smoke.cuda_ms). Variants:

  full             the kernel as built (its outputs checked equal to the
                   plain version: "mismatches 0")
  no atomics       the per-flow counter and rule-hit atomics compiled out
  no row reads     every row read as owned by no shard (no allow,
                   redirect or rule word; the range scan still runs)
  no columns       every flow's column range empty (flows in, verdicts
                   and counters out: the streaming skeleton)
  global hits      the rule-hit histogram in device memory, not shared
  3 blocks an SM   __launch_bounds__(THREADS, 3): registers for three
  4 blocks an SM   __launch_bounds__(THREADS, 4): registers for four
  6 blocks an SM   __launch_bounds__(THREADS, 6): registers for six
  1 block an SM    the persistent grid cut to one block per SM
  256 threads      blocks of 256 threads (the kernel's THREADS is 512)
  L1 first         the least shared-memory carveout asked for (the rest
                   of the SM's 256 KB is L1, where the rows are read)

Only "full" computes the verdicts; the others time what is left. The
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
SRC = REPO / "cilium_tpu_torch" / "csrc" / "policymap_verdict.cu"
OUT = REPO / "build" / "k4_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared"]

ATOMICS = [("atomicAdd(&cnt[ep[f] * 3 + (v[f] - 1)], 1);", "(void)cnt;"),
           ("atomicAdd(&hit[min(rule[f], max(p.n_hits - 1, 0))], 1);", "(void)hit;")]
PATCHES = {
    "full": [],
    "no atomics": ATOMICS,
    "no row reads": [("    bits = nullptr;\n    rules = nullptr;\n",
                      "    bits = nullptr;\n    rules = nullptr;\n    return;\n")],
    "no columns": [("                if (i0 + f >= p.b) hi[f] = lo[f];", "                hi[f] = lo[f];")],
    "global hits": [("p.n_hits <= HITS_SHARED_MAX;", "false;")],
    "3 blocks an SM": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 3)")],
    "4 blocks an SM": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 4)")],
    "6 blocks an SM": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 6)")],
    "1 block an SM": [("(int64_t)sms * std::max(per_sm, 1));", "(int64_t)sms);")],
    "256 threads": [("constexpr int THREADS = 512;", "constexpr int THREADS = 256;")],
    "L1 first": [("    if (err) return err;\n    err = (int)cudaDeviceGetAttribute(",
                  "    if (err) return err;\n    err = (int)cudaFuncSetAttribute(kern, "
                  "cudaFuncAttributePreferredSharedMemoryCarveout, 0);\n    if (err) return err;\n"
                  "    err = (int)cudaDeviceGetAttribute(")],
}
N_FLOWS = 1 << 20
N_ROWS, N_COLS, N_EPS, N_RULES = 2048, 288, 64, 10_000


def build() -> dict:
    """One shared library per variant, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for k, (name, patches) in enumerate(PATCHES.items()):
        src = text
        for old, new in patches:
            if old not in src:
                sys.exit(f"k4_probe: the line {old!r} of {SRC.name} is gone; edit PATCHES")
            src = src.replace(old, new)
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
            sys.exit(f"k4_probe: nvcc failed on {name!r}:\n{out}")
        libs[name] = so
    return libs


class Variant:
    """A library handle for the wrapper: the copy's two K4 entries."""

    def __init__(self, path: Path) -> None:
        from cilium_tpu_torch import _kernels

        lib = ctypes.CDLL(str(path))
        for name in ("policymap_verdict", "policymap_verdict_attrib"):
            k = _kernels.KERNELS[name]
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
        sys.exit("k4_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch import _kernels
    from cilium_tpu_torch.ops.lookup import policymap_verdict, policymap_verdict_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")
    rs = np.random.default_rng(4)
    pm = smoke.k4_edge_world(rs, N_ROWS, N_COLS, N_EPS, False, dev)
    dports = rs.choice(np.array([80, 443, 8080, 53, 5432, 22], np.int32), N_FLOWS)
    flows = [torch.from_numpy(a).to(dev) for a in (
        rs.integers(0, N_ROWS, N_FLOWS).astype(np.int32),
        rs.integers(0, N_EPS, N_FLOWS).astype(np.int32),
        dports, np.where(dports == 53, 17, 6).astype(np.int32))]
    denied = torch.from_numpy(rs.random(N_FLOWS) < 0.1).to(dev)
    rule_tab = torch.from_numpy(np.where(rs.random((N_ROWS, N_COLS)) < 0.7, rs.integers(
        0, N_RULES, (N_ROWS, N_COLS)), -1).astype(np.int32)).to(dev)
    kws = {"policymap_verdict": dict(denied_pf=denied, ep_count=N_EPS),
           "policymap_verdict_attrib": dict(denied_pf=denied, ep_count=N_EPS, rule_tab=rule_tab,
                                            n_rules=N_RULES)}
    for name, path in libs.items():
        with _kernels._lock:
            _kernels._lib = Variant(path)
        for entry, kw in kws.items():
            def fn(kw=kw):
                return policymap_verdict(pm, *flows, **kw)

            note = ""
            if name == "full":
                bad = sum(int((a.to(torch.int64) != b.to(torch.int64)).sum())
                          for a, b in zip(fn(), policymap_verdict_plain(pm, *flows, **kw))
                          if a is not None)
                note = f", cuda_ms {smoke.median(smoke.cuda_ms(fn))!r}, mismatches {bad}"
            ms = smoke.graph_ms(fn)
            print(f"{entry:<25} {name:<15} graph_ms {smoke.median(ms)!r} {ms}{note} [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
