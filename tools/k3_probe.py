"""Where K3 lpm_wide's time goes on the card: a probe, not a test.

    python3 tools/k3_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k3_probe/, cilium_tpu_torch/csrc/lpm_wide.cu (the kernel: one
address a thread) and tools/k3_vector_walk.cu (the vector walk tried
against it), as they are and patched, and times each through its C
entry in a CUDA graph (chip_smoke.graph_ms: the device's time without
the wrapper's host work) over 1 048 576 addresses:

  ip       the identity trie of the bench's 2 048 10.x.y.1/32 entries
           (flat 16+16, sub_info [9, 65536]) over chip_smoke.make_flows
  merged   the same merged with the four prefilter CIDRs (the fused
           deny+identity walk, ops/lpm.py merge_flat_tries)

and, off the main path, two tries whose gathers leave L1 and L2, over
addresses drawn under their deep /16s (seed 0):

  flat128  128 deep /16s of 512 /32s each (flat, sub_info [129, 65536],
           34 MB: the largest flat trie)
  wide     256 deep /16s of 256 /32s each (16-8-8, [41839, 256] twice,
           86 MB: past the L2)

Variants:

  first version        the kernel
  1, sub via L2        the kernel with the sub-table gathers as
                       ld.global.cg (L2 only)
  2 / 4 / 8 a thread   the vector walk with LPM_WIDE_VEC 2, 4 or 8
  4, 8 blocks an SM    the vector walk under __launch_bounds__(256, 8)
                       (at most 32 registers a thread)
  4, interleaved root  the two root words as one 8-byte gather from a
                       [65536, 2] table (passed where the flat walk
                       never reads: sub_child; flat tries only)
  4, sub via L2        the vector walk's sub-table gathers as
                       ld.global.cg

and, to find the floor, diagnostics whose output is the address itself
(held against it, not against the walk):

  copy, 1 a thread     the kernel storing the address instead of walking
  copy, 4 a thread     the vector walk storing its four addresses
  empty                the vector kernel returning at once (the launch)

Every other variant's output is held against the plain version
(ops/lpm.py lpm_wide_plain); a mismatch exits non-zero. The patches
match exact source lines and the probe exits non-zero when one is gone,
so edit PATCHES with the sources. Prints the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import ipaddress
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "cilium_tpu_torch" / "csrc"
OUT = REPO / "build" / "k3_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
KERNEL = "lpm_wide.cu"
VECTOR = "k3_vector_walk.cu"
SOURCES = {KERNEL: CSRC / KERNEL, VECTOR: Path(__file__).resolve().parent / VECTOR,
           "lpm_walk.cuh": CSRC / "lpm_walk.cuh", "common.cuh": CSRC / "common.cuh"}
SYMBOL = {KERNEL: "cilium_lpm_wide", VECTOR: "cilium_lpm_wide_vec"}
VEC_LINE = "constexpr int LPM_WIDE_VEC = 4;\n"

# variant: (source built, [(file, old, new) patches])
PATCHES = {
    "first version": (KERNEL, []),
    "1, sub via L2": (KERNEL, [
        ("lpm_walk.cuh",
         "            const int v1 = __ldg(sub_info + (int64_t)node * 65536 + (q & 0xFFFFu));\n",
         "            const int v1 = __ldcg(sub_info + (int64_t)node * 65536 + (q & 0xFFFFu));\n"),
        ("lpm_walk.cuh", "            const int v1 = __ldg(sub_info + idx1);\n",
         "            const int v1 = __ldcg(sub_info + idx1);\n"),
        ("lpm_walk.cuh",
         "                const int v2 = __ldg(sub_info + (int64_t)n1 * 256 + (q & 0xFFu));\n",
         "                const int v2 = __ldcg(sub_info + (int64_t)n1 * 256 + (q & 0xFFu));\n")]),
    "4 a thread": (VECTOR, []),
    "2 a thread": (VECTOR, [(VECTOR, VEC_LINE, VEC_LINE.replace("= 4;", "= 2;"))]),
    "8 a thread": (VECTOR, [(VECTOR, VEC_LINE, VEC_LINE.replace("= 4;", "= 8;"))]),
    "4, 8 blocks an SM": (VECTOR, [
        (VECTOR, "__global__ void __launch_bounds__(LPM_WIDE_THREADS) lpm_wide_vec_kernel(",
         "__global__ void __launch_bounds__(LPM_WIDE_THREADS, 8) lpm_wide_vec_kernel(")]),
    "4, interleaved root": (VECTOR, [
        (VECTOR,
         "        const int2 r = lpm_wide_root(root_info, root_child, (int)(q[j] >> 16));\n",
         "        const int2 r = __ldg(reinterpret_cast<const int2*>(sub_child) + (q[j] >> 16));\n")]),
    "4, sub via L2": (VECTOR, [
        (VECTOR,
         "            v1[j] = node[j] ? __ldg(sub_info + (int64_t)node[j] * 65536 + (q[j] & 0xFFFFu)) : 0;\n",
         "            v1[j] = node[j] ? __ldcg(sub_info + (int64_t)node[j] * 65536 + (q[j] & 0xFFFFu)) : 0;\n"),
        (VECTOR, "        v1[j] = node[j] ? __ldg(sub_info + idx1) : 0;\n",
         "        v1[j] = node[j] ? __ldcg(sub_info + idx1) : 0;\n"),
        (VECTOR,
         "        v1[j] = n1[j] ? __ldg(sub_info + (int64_t)n1[j] * 256 + (q[j] & 0xFFu)) : 0;\n",
         "        v1[j] = n1[j] ? __ldcg(sub_info + (int64_t)n1[j] * 256 + (q[j] & 0xFFu)) : 0;\n")]),
    "copy, 1 a thread": (KERNEL, [
        (KERNEL,
         "    out[i] = lpm_wide_walk(root_info, root_child, sub_child, sub_info, m, flat,\n"
         "                           (uint32_t)addr[i]);\n",
         "    out[i] = addr[i];\n")]),
    "copy, 4 a thread": (VECTOR, [
        (VECTOR,
         "        lpm_wide_walk_n<V, FLAT>(root_info, root_child, sub_child, sub_info, m, q, best);\n",
         "        for (int j = 0; j < V; ++j) best[j] = (int)q[j];\n")]),
    "empty": (VECTOR, [
        (VECTOR, "    constexpr int V = LPM_WIDE_VEC;\n    const int64_t nv = b / V;\n",
         "    constexpr int V = LPM_WIDE_VEC;\n    if (b > 0) return;\n    const int64_t nv = b / V;\n")]),
}


def build() -> dict:
    """One shared library per variant, compiled in parallel; prints
    each build's registers (-Xptxas -v)."""
    procs = {}
    for k, (name, (src, patches)) in enumerate(PATCHES.items()):
        d = OUT / f"v{k}"
        d.mkdir(parents=True, exist_ok=True)
        texts = {f: path.read_text() for f, path in SOURCES.items()}
        for f, old, new in patches:
            if old not in texts[f]:
                sys.exit(f"k3_probe: the line {old!r} of {f} is gone; edit PATCHES")
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (d / f).write_text(text)
        so = d / "k3.so"
        procs[name] = (src, so, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-I", str(d), str(d / src), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, (src, so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k3_probe: nvcc failed on {name!r}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"build {name}: {regs}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), SYMBOL[src])
        fn.argtypes = [P, P, P, P, I, I, P, P, L, I, P]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k3_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch.ops.lpm import build_wide_trie, lpm_wide_plain, merge_flat_tries

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")
    n = smoke.N_IDENTITIES
    ips = smoke.make_flows(0, n)[0]
    bench = torch.from_numpy(ips.view(np.int32)).to(dev)
    ip = build_wide_trie([(f"10.{(i >> 8) & 255}.{i & 255}.1/32", i + 1) for i in range(n)])
    pf = build_wide_trie((c, 0) for c in smoke.PREFILTER_CIDRS)
    rs = np.random.default_rng(0)
    b = bench.shape[0]
    big = {}
    for name, (n_hi, per) in (("flat128", (128, 512)), ("wide", (256, 256))):
        his = [(10 << 8) | h for h in range(min(n_hi, 128))] + [(11 << 8) | h for h in range(n_hi - 128)]
        pre = [("0.0.0.0/0", 1)] + [
            (str(ipaddress.ip_address((hi << 16) | int(x))) + "/32", 2 + k * per + j)
            for k, hi in enumerate(his) for j, x in enumerate(rs.integers(0, 1 << 16, per))]
        a = (np.array(his, np.uint32)[rs.integers(0, len(his), b)] << 16) \
            | rs.integers(0, 1 << 16, b).astype(np.uint32)
        big[name] = (build_wide_trie(pre), torch.from_numpy(a.view(np.int32)).to(dev))
    tries = {"ip": (ip, bench), "merged": (merge_flat_tries(ip, pf), bench), **big}
    out = torch.empty(b, dtype=torch.int32, device=dev)
    for tname, (arrays, addr) in tries.items():
        ri, rc, sc, si = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
        flat = int(si.shape[-1] == 65536)
        if flat != (tname != "wide"):
            sys.exit(f"k3_probe: the {tname} trie has the wrong layout")
        inter = torch.stack([ri, rc], dim=1).contiguous()  # [65536, 2]
        plain = lpm_wide_plain(ri, rc, sc, si, addr)
        for vname, fn in libs.items():
            if not flat and "interleaved" in vname:
                continue
            sub_child = inter if "interleaved" in vname else sc

            def call(fn=fn, sub_child=sub_child):
                err = fn(ri.data_ptr(), rc.data_ptr(), sub_child.data_ptr(), si.data_ptr(),
                         si.shape[0], flat, addr.data_ptr(), out.data_ptr(), b, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"k3_probe: {vname} failed to launch on {tname} ({err})")

            out.fill_(-7)
            call()
            want = addr if vname.startswith("copy") else plain
            bad = 0 if vname == "empty" else int((out != want).sum())
            ms = smoke.graph_ms(call)
            print(f"{tname:<7} sub_info {list(si.shape)} {vname:<20} graph_ms "
                  f"{smoke.median(ms)!r} {ms}, mismatches {bad} [{card}]", flush=True)
            if bad:
                sys.exit(1)


if __name__ == "__main__":
    main()
