"""Where K11 shed_walk's IPv6 time goes on the card: a probe, not a test.

    python3 tools/k11_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k11_probe/, cilium_tpu_torch/csrc/shed_walk.cu as it is (the
port's kernel: one thread a flow, the whole 64-byte int32 row as four
16-byte loads issued together on the vector route),
tools/k11_sector_walk.cu (the "sector" route tried against it: the
row's first 32-byte sector, the second only for a lane whose K compare
holds) and copies of it with one choice changed, and
tools/k11_u8_rows.cu (a walk over uint8 address rows), and times each
through its C entry in a CUDA graph (chip_smoke.graph_ms: the device's
time without the wrapper's host work; the median of five) on 1 048 576
IPv6 flows of the bench world as [B, 16] int32 rows:

  deny-heavy   the admission gate's batch (chip_smoke.deny_heavy over
               chip_smoke.make_flows6: 3/4 of the peers moved to
               2001:db8::/32, about 77% world peers in all)
  ungated      chip_smoke.make_flows6's batch (1/16 world)

over the bench's identity trie (2 048 fd00::{hi}:{lo}/128 entries, K 13
elided bytes starting with 0xFD, 3 levels walked; "identity") and, on
the deny-heavy batch, the same entries with 2000::/3 (K 0; "edge"),
with a synthetic [2 049, 9] shed table (the table's values change the
mask, not the reads; the world row sheds every class).

Variants (PATCHES of tools/k11_sector_walk.cu for the sector ones):

  kernel, vector / scalar  csrc/shed_walk.cu on K5's routes
  sector                   tools/k11_sector_walk.cu's sector route
  sector, 2 / 4 flows      2 or 4 flows a thread, their dports and
                           protos loaded first, then their walks (the
                           kernel swapped for _GENERIC below)
  sector, persistent       _GENERIC's grid capped at the blocks the SMs
                           hold, each thread stepping by the grid's width
  sector, table in         the persistent grid with the [N, 9] shed
  shared memory            table staged in shared memory once a block
  sector / kernel vector,  with the context's L2 fetch granularity
  L2 fetch 32 B            (cudaLimitMaxL2FetchGranularity) set to 32
                           bytes for its timing, then restored
  uint8 rows               tools/k11_u8_rows.cu: 16 bytes an address,
                           the rows converted outside the timed window

and floors with no walk (the output is not checked): the route's loads
(the sector(s), dport and proto) and a store of one byte a flow,
"floor, sector" and "floor, vector"; the sector route's loads at
levels 8, the first sector of every 64-byte row and no second ("floor,
first sector only"); and the same on rows of 32 bytes (the first 8
int32 of each address copied out, "floor, 32-byte rows").

Every checked variant's mask is held against the plain version
(ops/shed.py shed_walk_stride8_plain); a mismatch exits non-zero. The
patches match exact source lines and the probe exits non-zero when one
is gone, so edit PATCHES with tools/k11_sector_walk.cu. Prints the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "cilium_tpu_torch" / "csrc"
TOOLS = REPO / "tools"
OUT = REPO / "build" / "k11_probe"
NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
# the route codes: the port's entry takes 0 / 1 as its vec flag,
# tools/k11_sector_walk.cu's all three
ROUTES = {"scalar": 0, "vector": 1, "sector": 2}

_KERNEL = "template <int LOADS>\n__global__ void __launch_bounds__(STRIDE8_THREADS)"
_NAMESPACE_END = "}  // namespace\n"
_CALLS = [f"launch_stride8<LPM_LOADS_{r}>(p, s)" for r in ("SECTOR", "FULL", "SCALAR")]
# The kernel with FLOWS flows a thread (their dports and protos loaded
# first, then their walks one after another) and, when PERSISTENT, its
# grid capped at the blocks the SMs hold (each thread stepping by the
# grid's width): it replaces the kernel and its launch in the variants
# that try those
_GENERIC = """constexpr int STRIDE8_FLOWS = {flows};
constexpr bool STRIDE8_PERSISTENT = {persistent};

template <int LOADS>
__global__ void __launch_bounds__(STRIDE8_THREADS) shed_walk_stride8_kernel(Stride8 p) {{
    __shared__ int32_t s_common[LPM_VEC_LEVELS];
    const int32_t* com =
        LOADS != LPM_LOADS_SCALAR ? lpm_stage_common(p.common, p.k, s_common) : p.common;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i0 < p.b;
         i0 += step * STRIDE8_FLOWS) {{
        int dport[STRIDE8_FLOWS], proto[STRIDE8_FLOWS];
#pragma unroll
        for (int f = 0; f < STRIDE8_FLOWS; ++f) {{
            const int64_t i = i0 + f * step;
            if (i < p.b) {{
                dport[f] = __ldg(p.dport + i);
                proto[f] = __ldg(p.proto + i);
            }}
        }}
#pragma unroll
        for (int f = 0; f < STRIDE8_FLOWS; ++f) {{
            const int64_t i = i0 + f * step;
            if (i < p.b) {{
                const int hit = lpm_stride8_walk<LOADS>(p.child, p.info, p.m, com, p.k,
                                                        p.addr + i * p.stride, p.levels);
                p.out[i] = shed_lookup(p.shed_tab, p.n_rows, p.world_row, hit, dport[f],
                                       proto[f]);
            }}
        }}
    }}
}}

template <int LOADS>
int launch_stride8(const Stride8& p, int device, cudaStream_t s) {{
    auto kern = shed_walk_stride8_kernel<LOADS>;
    const int64_t per_block = (int64_t)STRIDE8_THREADS * STRIDE8_FLOWS;
    int64_t blocks = (p.b + per_block - 1) / per_block;
    if (STRIDE8_PERSISTENT) {{
        int sms = 0, per_sm = 0;
        int err = launch_fit::sm_count((const void*)kern, 0, device, sms);
        if (err) return err;
        err = launch_fit::blocks_per_sm((const void*)kern, device, STRIDE8_THREADS, 0, per_sm);
        if (err) return err;
        blocks = std::min<int64_t>(blocks, (int64_t)sms * std::max(per_sm, 1));
    }}
    kern<<<(unsigned)blocks, STRIDE8_THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
}}

"""


def _generic(flows: int, persistent: bool):
    """Patches that swap the kernel and its launch for _GENERIC."""
    return [("KERNEL..NAMESPACE", _GENERIC.format(flows=flows, persistent=str(persistent).lower())),
            ('#include "common.cuh"\n', '#include <algorithm>\n\n#include "common.cuh"\n')] + [
        (c, c.replace("(p, s)", "(p, device, s)")) for c in _CALLS]


_STEP = "    const int64_t step = (int64_t)gridDim.x * blockDim.x;\n"
_FIT = "launch_fit::blocks_per_sm((const void*)kern, device, STRIDE8_THREADS, 0, per_sm);\n"
_LAUNCH = "    kern<<<(unsigned)blocks, STRIDE8_THREADS, 0, s>>>(p);\n"
_LOOKUP = "    p.out[i] = shed_lookup(p.shed_tab, p.n_rows, p.world_row, hit, dport, proto);\n"

# (old, new) patches of tools/k11_sector_walk.cu a variant's build
# applies, in order; "KERNEL..NAMESPACE" stands for the text from the
# kernel's template line to the end of the anonymous namespace
PATCHES = {
    "sector walk": [],
    "2 flows": _generic(2, False),
    "4 flows": _generic(4, False),
    "persistent": _generic(1, True),
    "table in shared memory": _generic(1, True) + [
        (_KERNEL, """__device__ __forceinline__ uint8_t shed_lookup_shared(
    const uint8_t* s_tab, int64_t n_rows, int world_row, int hit, int dport, int proto) {
    const int64_t row = hit > 0 ? (int64_t)hit - 1 : (int64_t)world_row;
    const int pi = 2 - 2 * (proto == 6) - (proto == 17);
    const int64_t idx = row * 9 + pi * 3 + (dport >= 1024) + (dport >= 32768);
    return idx >= 0 && idx < n_rows * 9 && s_tab[idx] != 0;
}

""" + _KERNEL),
        (_STEP, _STEP + """    extern __shared__ uint8_t s_tab[];
    for (int64_t j = threadIdx.x; j < p.n_rows * 9; j += blockDim.x) s_tab[j] = p.shed_tab[j];
    __syncthreads();
"""),
        ("p.out[i] = shed_lookup(p.shed_tab, p.n_rows,", "p.out[i] = shed_lookup_shared(s_tab, p.n_rows,"),
        (_FIT, _FIT.replace(", 0, per_sm", ", (size_t)p.n_rows * 9, per_sm")),
        (_LAUNCH, _LAUNCH.replace(", 0, s>>>", ", (size_t)p.n_rows * 9, s>>>")),
    ],
    # the walk's loads folded into its result in place of the walk, and
    # the mask from that, dport and proto in place of the table
    "floor": [
        ("        if (!same) return 0;\n", """        int x = same;
#pragma unroll
        for (int j = 0; j < LPM_VEC_LEVELS; ++j) x ^= v[j];
        return x;
"""),
        (_LOOKUP, "    p.out[i] = (hit ^ dport ^ proto) & 1;\n"),
    ],
}
# a context limit's setter and getter (cudaLimitMaxL2FetchGranularity)
LIMITS_CU = """#include <cuda_runtime.h>
extern "C" int k11_set_l2_fetch(int bytes) {
    return (int)cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
}
extern "C" int k11_get_l2_fetch() {
    size_t v = 0;
    return cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity) ? -1 : (int)v;
}
"""


def _patched(name: str, text: str, patches) -> str:
    """tools/k11_sector_walk.cu with a variant's patches."""
    for old, new in patches:
        if old == "KERNEL..NAMESPACE":
            if _KERNEL not in text or _NAMESPACE_END not in text:
                sys.exit("k11_probe: k11_sector_walk.cu's stride-8 kernel is gone; edit PATCHES")
            a, b = text.index(_KERNEL), text.index(_NAMESPACE_END)
            text = text[:a] + new + text[b:]
            continue
        if old not in text:
            sys.exit(f"k11_probe: the line {old!r} of k11_sector_walk.cu is gone ({name}); "
                     "edit PATCHES")
        text = text.replace(old, new, 1)
    return text


def sources() -> dict:
    """name → (directory, main source file) written under OUT."""
    out = {}
    common = (CSRC / "common.cuh").read_text()

    def put(name, files, main):
        d = OUT / re.sub(r"[^a-z0-9]+", "_", name)
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        out[name] = (d, d / main)

    put("kernel", {"common.cuh": common, "lpm_walk.cuh": (CSRC / "lpm_walk.cuh").read_text(),
                   "shed_walk.cu": (CSRC / "shed_walk.cu").read_text()}, "shed_walk.cu")
    sector = (TOOLS / "k11_sector_walk.cu").read_text()
    for name, patches in PATCHES.items():
        put(name, {"common.cuh": common, "k11.cu": _patched(name, sector, patches)}, "k11.cu")
    put("uint8 rows", {"common.cuh": common,
                       "k11.cu": (TOOLS / "k11_u8_rows.cu").read_text()}, "k11.cu")
    put("limits", {"limits.cu": LIMITS_CU}, "limits.cu")
    return out


def build() -> dict:
    """One shared library per source, compiled in parallel → name → CDLL."""
    procs = {}
    for name, (d, main) in sources().items():
        so = d / "k11.so"
        procs[name] = (so, subprocess.Popen(
            [NVCC, *NVCC_FLAGS, "-I", str(d), str(main), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k11_probe: nvcc failed on {name!r}:\n{out}")
        if name in ("kernel", "sector walk"):
            print(f"nvcc -Xptxas -v ({name}):\n{out}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, lib in libs.items():
        if name == "uint8 rows":
            fn = lib.k11_shed_walk_u8
            fn.argtypes = [P, P, I, P, I, P, L, I, P, P, P, P, L, P]
        elif name == "limits":
            lib.k11_set_l2_fetch.argtypes = [I]
            lib.k11_set_l2_fetch.restype = I
            lib.k11_get_l2_fetch.restype = I
            continue
        else:
            fn = lib.cilium_shed_walk_stride8
            fn.argtypes = [P, P, I, P, I, P, L, I, P, I, I, P, P, P, L, I, I, P]
        fn.restype = I
    return libs


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k11_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from cilium_tpu_torch.ops.lpm import build_trie_elided
    from cilium_tpu_torch.ops.shed import shed_walk_stride8_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    n_idents = smoke.N_IDENTITIES
    flows6 = smoke.make_flows6(0, n_idents)[:4]
    batches = {"deny-heavy": smoke.deny_heavy(6, 0, flows6), "ungated": flows6}
    ident = [(f"fd00::{(i >> 8) & 255:x}:{i & 255:x}/128", i + 1) for i in range(n_idents)]
    tries = {"identity": build_trie_elided(ident),
             "edge": build_trie_elided(ident + [("2000::/3", n_idents + 1)])}
    rs = np.random.default_rng(11)
    tab_np = (rs.random((n_idents + 1, 9)) < 0.3).astype(np.uint8)
    tab_np[0] = 1  # the world row: deny-for-sure in every class
    tab = torch.from_numpy(tab_np).to(dev)
    world_row = 0
    b = flows6[0].shape[0]
    out = torch.empty(b, dtype=torch.uint8, device=dev)
    limits = libs["limits"]

    def k11(lib_name, route, ch, inf, com, addr, dp, pr, levels=16):
        fn = libs[lib_name].cilium_shed_walk_stride8

        def call():
            err = fn(ch.data_ptr(), inf.data_ptr(), ch.shape[0], com.data_ptr(), com.shape[0],
                     tab.data_ptr(), tab.shape[0], world_row, addr.data_ptr(), addr.shape[1],
                     levels, dp.data_ptr(), pr.data_ptr(), out.data_ptr(), b, route, 0,
                     stream())
            if err:
                sys.exit(f"k11_probe: {lib_name} (route {route}) failed to launch ({err})")
        return call

    def u8(ch, inf, com, addr, dp, pr):
        fn = libs["uint8 rows"].k11_shed_walk_u8
        rows = addr.to(torch.uint8).contiguous()  # converted outside the timed window

        def call():
            err = fn(ch.data_ptr(), inf.data_ptr(), ch.shape[0], com.data_ptr(), com.shape[0],
                     tab.data_ptr(), tab.shape[0], world_row, rows.data_ptr(), dp.data_ptr(),
                     pr.data_ptr(), out.data_ptr(), b, stream())
            if err:
                sys.exit(f"k11_probe: uint8 rows failed to launch ({err})")
        return call

    def time_it(label, call, want):
        out.fill_(7)
        call()
        torch.cuda.synchronize()
        bad = None if want is None else int((out.view(torch.bool) != want).sum())
        ms = smoke.graph_ms(call)
        print(f"{label:<58} graph_ms {smoke.median(ms)!r} {ms}"
              + ("" if bad is None else f", mismatches {bad}") + f" [{card}]", flush=True)
        if bad:
            sys.exit(1)
        return smoke.median(ms)

    sector = ROUTES["sector"]
    for bname, trie in (("deny-heavy", "identity"), ("ungated", "identity"),
                        ("deny-heavy", "edge")):
        peer, _eps, dports, protos = batches[bname]
        addr = torch.from_numpy(np.ascontiguousarray(peer, np.int32)).to(dev)
        dp, pr = (torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
                  for x in (dports, protos))
        ch, inf, com = (torch.from_numpy(a).to(dev) for a in tries[trie])
        k = com.shape[0]
        world = int((addr[:, 0] != com[0]).sum()) if k else 0
        args = (ch, inf, com, addr, dp, pr)
        want = shed_walk_stride8_plain(ch, inf, com, tab, world_row, addr, dp, pr, 16)
        head = f"{bname} ({trie} trie, K {k}, {world} lanes fail byte 0)"
        timed = [("kernel, vector", k11("kernel", ROUTES["vector"], *args), want),
                 ("kernel, scalar", k11("kernel", ROUTES["scalar"], *args), want),
                 ("sector", k11("sector walk", sector, *args), want),
                 ("sector, 2 flows", k11("2 flows", sector, *args), want),
                 ("sector, 4 flows", k11("4 flows", sector, *args), want),
                 ("sector, persistent", k11("persistent", sector, *args), want),
                 ("sector, table in shared memory", k11("table in shared memory", sector, *args),
                  want),
                 ("uint8 rows", u8(*args), want),
                 ("floor, sector", k11("floor", sector, *args), None),
                 ("floor, vector", k11("floor", ROUTES["vector"], *args), None),
                 ("floor, first sector only", k11("floor", sector, *args, levels=8), None),
                 ("floor, 32-byte rows", k11("floor", sector, ch, inf, com,
                                             addr[:, :8].contiguous(), dp, pr, levels=8), None)]
        for label, call, w in timed:
            time_it(f"{head} {label}", call, w)
        before = limits.k11_get_l2_fetch()
        err = limits.k11_set_l2_fetch(32)
        now = limits.k11_get_l2_fetch()
        print(f"{head} L2 fetch granularity {before} B, set to 32: error {err}, reads {now} B",
              flush=True)
        time_it(f"{head} sector, L2 fetch 32 B", k11("sector walk", sector, *args), want)
        time_it(f"{head} kernel, vector, L2 fetch 32 B", k11("kernel", ROUTES["vector"], *args),
                want)
        if before >= 0:
            limits.k11_set_l2_fetch(before)
        # the kernel and the sector route again: the spread of one code
        # timed twice
        for label, call, w in timed[:1] + timed[2:3]:
            time_it(f"{head} {label} (again)", call, w)


if __name__ == "__main__":
    main()
