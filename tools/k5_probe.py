"""Where K5 lpm_stride8's time goes on the card: a probe, not a test.

    python3 tools/k5_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k5_probe/, cilium_tpu_torch/csrc/lpm_stride8.cu as it is and a
copy whose vector walk reads ``common`` by broadcast reads from device
memory instead of staging it in shared memory once a block, and times
each through its C entry
in a CUDA graph (chip_smoke.graph_ms: the device's time without the
wrapper's host work) on chip_smoke's K5 shapes, 1 048 576 IPv6 peers of
chip_smoke.make_flows6 (1/16 in 2001:db8::/32) as [B, 16] int32 bytes:

  identity   the bench's identity trie (2 048 fd00::{hi}:{lo}/128
             entries): K 13 elided bytes compared, 3 levels walked
  edge       the same entries and 2000::/3: K 0, 16 levels walked

Variants:

  first walk          the kernel's scalar route (a byte read a step, each
                      behind the compare's or the walk's branch: the
                      first version's walk)
  vector row          the kernel's vector route (four 16-byte loads
                      issued together; the compare and the walk on
                      registers; common staged in shared memory)
  vector, common by   the vector route with common read from device
  broadcast reads     memory (every lane the same address) instead

Every variant's output is held against the plain version
(ops/lpm.py lpm_stride8_plain); a mismatch exits non-zero. The patches
match exact source lines and the probe exits non-zero when one is gone,
so edit PATCHES with the kernel. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "cilium_tpu_torch" / "csrc"
OUT = REPO / "build" / "k5_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared"]

# (file, old, new) patches of lpm_stride8.cu and lpm_walk.cuh
PATCHES = {
    "kernel": [],
    "common by broadcast reads": [
        ("lpm_walk.cuh", "            if (j < k) same &= v[j] == common[j];\n",
         "            if (j < k) same &= v[j] == __ldg(common + j);\n"),
        ("lpm_stride8.cu",
         "    const int32_t* com = VEC ? lpm_stage_common(common, k, s_common) : common;\n",
         "    const int32_t* com = common;\n"),
    ],
}
ROUTES = {"first walk": 0, "vector row": 1}


def build() -> dict:
    """One shared library per variant, compiled in parallel."""
    procs = {}
    for k, (name, patches) in enumerate(PATCHES.items()):
        d = OUT / f"v{k}"
        d.mkdir(parents=True, exist_ok=True)
        texts = {f: (CSRC / f).read_text() for f in ("lpm_stride8.cu", "lpm_walk.cuh",
                                                    "common.cuh")}
        for f, old, new in patches:
            if old not in texts[f]:
                sys.exit(f"k5_probe: the line {old!r} of {f} is gone; edit PATCHES")
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (d / f).write_text(text)
        so = d / "k5.so"
        procs[name] = (so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-I", str(d), str(d / "lpm_stride8.cu"),
             "-o", str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k5_probe: nvcc failed on {name!r}:\n{out}")
        lib = ctypes.CDLL(str(so))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.cilium_lpm_stride8.argtypes = [P, P, I, P, I, P, I, I, P, L, I, I, P]
        lib.cilium_lpm_stride8.restype = ctypes.c_int
        libs[name] = lib.cilium_lpm_stride8
    return libs


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k5_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch.ops.lpm import build_trie_elided, lpm_stride8_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")
    n_idents = smoke.N_IDENTITIES
    addr = torch.from_numpy(smoke.make_flows6(0, n_idents)[0]).to(dev)
    ident = [(f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128", i + 1) for i in range(n_idents)]
    tries = {"identity": build_trie_elided(ident),
             "edge": build_trie_elided(ident + [("2000::/3", 9999)])}
    b = addr.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=dev)
    for tname, arrays in tries.items():
        child, info, common = (torch.from_numpy(a).to(dev) for a in arrays)
        k = common.shape[0]
        plain = lpm_stride8_plain(child, info, common, addr, 16)
        variants = [(name, libs["kernel"], vec) for name, vec in ROUTES.items()]
        variants.append(("vector, common by broadcast reads",
                         libs["common by broadcast reads"], 1))
        for vname, fn, vec in variants:
            def call(fn=fn, vec=vec):
                err = fn(child.data_ptr(), info.data_ptr(), child.shape[0], common.data_ptr(), k,
                         addr.data_ptr(), 16, 16, out.data_ptr(), b, vec, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"k5_probe: {vname} failed to launch on {tname} ({err})")

            out.fill_(-7)
            call()
            bad = int((out != plain).sum())
            ms = smoke.graph_ms(call)
            print(f"{tname:<9} K {k:<2} {vname:<32} graph_ms {smoke.median(ms)!r} {ms}, "
                  f"mismatches {bad} [{card}]", flush=True)
            if bad:
                sys.exit(1)


if __name__ == "__main__":
    main()
