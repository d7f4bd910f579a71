"""Where K2 bool_mm's time goes on the card: a probe, not a test.

    python3 tools/k2_probe.py

Needs nvcc and a CUDA card (exits non-zero without them). Builds, under
build/k2_probe/, copies of cilium_tpu_torch/csrc/bool_mm.cu with parts
of its main loop compiled out, and times each through the same
launch code as the library (one, two and four warpgroups a block) at
the four shapes the main paths give K2: the sweep's [1024, 640] x
[640, 640], a row patch's [282, 640] x [640, 4096], a column patch's
[1024, 640] x [640, 4096] and an attributed column patch's
[8192, 640] x [640, 4096], complement_x off and on (CUDA events, the
mean of 50 launches after 5). Variants:

  full          the kernel as built (its output checked against a host
                product on every 97th row: "mismatches 0")
  no products   the wgmma instructions compiled out
  no transposes w's tile not transposed (nor x complemented)
  no copies     no cp.async past the first three stages
  neither       no copies past the prologue and no transposes
  no stores     the output tile not written to device memory

Only "full" computes the product; the others time what is left. Then a
kernel that runs nothing but int8 wgmma m64n128k32 from shared memory
(two warpgroups a block, one and two blocks an SM) gives the tensor
cores' rate from K2's no-swizzle K-major layout, the 128-byte swizzle
and a layout with the 8-row groups adjacent. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "build" / "k2_probe"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

# variant name -> SKIP bits: 1 products, 2 transposes, 4 copies past the
# prologue, 8 output stores
VARIANTS = {"full": 0, "no products": 1, "no transposes": 2, "no copies": 4,
            "neither": 6, "no stores": 8}
PATCHES = [
    ("        wgmma_s8(d, da, db);\n        wgmma_s8(d, da + (256 >> 4), db + (256 >> 4));",
     "        if (!(SKIP & 1)) { wgmma_s8(d, da, db);\n"
     "        wgmma_s8(d, da + (256 >> 4), db + (256 >> 4)); }"),
    ("        if (s + 1 < ksteps) prep<NWG>(", "        if (!(SKIP & 2) && s + 1 < ksteps) prep<NWG>("),
    ("        if (s + STAGES - 1 < ksteps)\n", "        if (!(SKIP & 4) && s + STAGES - 1 < ksteps)\n"),
    ("    if (vec_out) {", "    if (SKIP & 8) return;\n    if (vec_out) {"),
]

HARNESS = r'''#include K2_SRC
#include <cstdio>
#include <vector>
#include <cstdlib>

template <int NWG>
float run(const int8_t* x, const int8_t* w, uint8_t* out, int b, int a, int c, int comp, int iters) {
    cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
    for (int i = 0; i < 5; ++i) pick<NWG>(x, w, out, b, a, c, comp, 0, 0);
    cudaEventRecord(e0);
    for (int i = 0; i < iters; ++i) pick<NWG>(x, w, out, b, a, c, comp, 0, 0);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    int err = (int)cudaGetLastError();
    if (err) printf("error %d\n", err);
    return ms / iters;
}

int main() {
    int shapes[4][3] = {{1024, 640, 640}, {282, 640, 4096}, {1024, 640, 4096}, {8192, 640, 4096}};
    for (auto& sh : shapes) {
        int b = sh[0], a = sh[1], c = sh[2];
        std::vector<int8_t> hx((size_t)b * a), hw((size_t)a * c);
        srand(1);
        for (auto& v : hx) v = (rand() % 10) < 3;
        for (auto& v : hw) v = (rand() % 7) - 3;
        int8_t *x, *w; uint8_t *o1, *o2, *o4;
        cudaMalloc(&x, hx.size()); cudaMalloc(&w, hw.size());
        cudaMalloc(&o1, (size_t)b * c); cudaMalloc(&o2, (size_t)b * c); cudaMalloc(&o4, (size_t)b * c);
        cudaMemcpy(x, hx.data(), hx.size(), cudaMemcpyHostToDevice);
        cudaMemcpy(w, hw.data(), hw.size(), cudaMemcpyHostToDevice);
        for (int comp = 0; comp < 2; ++comp) {
            float t1 = run<1>(x, w, o1, b, a, c, comp, 50);
            float t2 = run<2>(x, w, o2, b, a, c, comp, 50);
            float t4 = run<4>(x, w, o4, b, a, c, comp, 50);
            std::vector<uint8_t> h1((size_t)b * c), h2((size_t)b * c), h4((size_t)b * c);
            cudaMemcpy(h1.data(), o1, h1.size(), cudaMemcpyDeviceToHost);
            cudaMemcpy(h2.data(), o2, h2.size(), cudaMemcpyDeviceToHost);
            cudaMemcpy(h4.data(), o4, h4.size(), cudaMemcpyDeviceToHost);
            // host reference on a few rows
            long bad = 0;
            for (int r = 0; r < b; r += 97) for (int cc = 0; cc < c; ++cc) {
                int s = 0;
                for (int k = 0; k < a; ++k) s += (comp ? 1 - hx[(size_t)r * a + k] : hx[(size_t)r * a + k]) * hw[(size_t)k * c + cc];
                uint8_t want = s > 0;
                bad += h1[(size_t)r * c + cc] != want;
                bad += h2[(size_t)r * c + cc] != want;
                bad += h4[(size_t)r * c + cc] != want;
            }
            printf("[%d,%d]x[%d,%d] comp %d: NWG1 %.5f ms, NWG2 %.5f ms, NWG4 %.5f ms, mismatches %ld\n",
                   b, a, a, c, comp, t1, t2, t4, bad);
        }
        cudaFree(x); cudaFree(w); cudaFree(o1); cudaFree(o2); cudaFree(o4);
    }
    return 0;
}
'''

RATE = r'''#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo, int layout) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// LAYOUT 0: no swizzle, core matrices, A: [128 rows][128 k] groups of 8 rows SBO = 1024, LBO = 128
// LAYOUT 1: 128B swizzle, rows of 128 bytes, SBO = 1024
// LAYOUT 2: no swizzle with SBO 128 (8-row groups adjacent) and LBO = 16 groups * 128 (K chunks far apart)
template <int LAYOUT>
__global__ void __launch_bounds__(256) rate(int iters, int* sink) {
    extern __shared__ uint8_t raw[];
    uint8_t* smem = (uint8_t*)(((uintptr_t)raw + 1023) & ~(uintptr_t)1023);
    for (int i = threadIdx.x; i < 32768 / 4; i += 256) ((uint32_t*)smem)[i] = 0x01010101u * (i & 3);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int g = threadIdx.x >> 7;
    uint32_t sa = (uint32_t)__cvta_generic_to_shared(smem);
    uint32_t sb = sa + 16384;
    int d[64];
    for (int j = 0; j < 64; ++j) d[j] = 0;
    for (int it = 0; it < iters; ++it) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            uint64_t da, db;
            if (LAYOUT == 0) {
                da = desc(sa + g * 8 * 1024 + kk * 256, 128, 1024, 0);
                db = desc(sb + kk * 256, 128, 1024, 0);
            } else if (LAYOUT == 1) {
                da = desc(sa + g * 8 * 1024 + kk * 32, 16, 1024, 1);
                db = desc(sb + kk * 32, 16, 1024, 1);
            } else {
                da = desc(sa + g * 8 * 128 + kk * 2 * 2048, 2048, 128, 0);
                db = desc(sb + kk * 2 * 2048, 2048, 128, 0);
            }
            wgmma_s8(d, da, db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    int s = 0;
    for (int j = 0; j < 64; ++j) s += d[j];
    if (s == 123456789) sink[0] = s;
}

int main() {
    int* sink; cudaMalloc(&sink, 4);
    const int smem = 32768 + 1024;
    cudaFuncSetAttribute(rate<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(rate<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(rate<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const int iters = 2000;
    for (int rep = 0; rep < 2; ++rep)
    for (int layout = 0; layout < 3; ++layout) {
        for (int blocks_per_sm = 1; blocks_per_sm <= 2; ++blocks_per_sm) {
            dim3 grid(132 * blocks_per_sm);
            cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
            auto k = layout == 0 ? rate<0> : layout == 1 ? rate<1> : rate<2>;
            k<<<grid, 256, smem>>>(10, sink);
            cudaEventRecord(e0);
            k<<<grid, 256, smem>>>(iters, sink);
            cudaEventRecord(e1); cudaEventSynchronize(e1);
            float ms; cudaEventElapsedTime(&ms, e0, e1);
            double ops = 2.0 * 64 * 128 * 32 * 4 * 2 * (double)iters * grid.x;
            printf("layout %d, %d blocks/SM: %.4f ms, %.1f TOP/s (err %d)\n", layout, blocks_per_sm, ms,
                   ops / ms / 1e9, (int)cudaGetLastError());
        }
    }
    return 0;
}
'''


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        sys.exit("nvcc not found")
    return found


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    if smi.returncode != 0:
        sys.exit("no CUDA card (nvidia-smi failed)")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = (REPO / "cilium_tpu_torch" / "csrc" / "bool_mm.cu").read_text()
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n#ifndef SKIP\n#define SKIP 0\n#endif')
    for old, new in PATCHES:
        if src.count(old) != 1:
            sys.exit(f"bool_mm.cu no longer has the line this probe patches: {old.strip()!r}")
        src = src.replace(old, new)
    (OUT / "bool_mm_probe.cu").write_text(src)
    (OUT / "harness.cu").write_text(HARNESS.replace("#include K2_SRC", '#include "bool_mm_probe.cu"'))
    (OUT / "wgmma_rate.cu").write_text(RATE)
    inc = ["-I", str(REPO / "cilium_tpu_torch" / "csrc")]
    procs = {name: subprocess.Popen([nvcc(), *NVCC_FLAGS, *inc, f"-DSKIP={bits}", str(OUT / "harness.cu"),
                                     "-o", str(OUT / f"k2_skip{bits}")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, bits in VARIANTS.items()}
    procs["rate"] = subprocess.Popen([nvcc(), *NVCC_FLAGS, str(OUT / "wgmma_rate.cu"), "-o",
                                      str(OUT / "wgmma_rate")],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{out}")
    for name, bits in VARIANTS.items():
        r = subprocess.run([str(OUT / f"k2_skip{bits}")], capture_output=True, text=True, timeout=600)
        for line in r.stdout.splitlines():
            print(f"{name}: {line}", flush=True)
        if r.returncode != 0:
            sys.exit(f"{name} exited {r.returncode}: {r.stderr}")
    r = subprocess.run([str(OUT / "wgmma_rate")], capture_output=True, text=True, timeout=600)
    print(r.stdout, end="", flush=True)
    if r.returncode != 0:
        sys.exit(f"wgmma_rate exited {r.returncode}")


if __name__ == "__main__":
    main()
