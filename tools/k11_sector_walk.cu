// K11 shed_walk's IPv6 entry with a "sector" route, kept for
// tools/k11_probe.py: the design tried against the kernel in
// cilium_tpu_torch/csrc/shed_walk.cu, and no faster than it on the
// gate's deny-heavy batch, slower where every lane reads its whole row
// (the probe's numbers in PERF.md). Built only by the probe.
//
// An address row is 16 int32 = 64 bytes = two 32-byte DRAM sectors,
// bytes 0-7 and bytes 8-15. The sector walk loads the first sector,
// compares bytes 0 .. min(K, 8) - 1 against ``common`` (staged in
// shared memory), and loads the second sector only for a lane whose
// compare still holds: on the gate's batch about 3/4 of the lanes are
// world peers whose compare fails on byte 0. On an H100 that moves no
// fewer bytes: the L2 fetches a 64-byte row whole, so the probe's
// no-walk floors read alike whether one sector of a row or two is
// asked for.
//
// The walk is lpm_walk.cuh's stride-8 walk with a load policy (LOADS):
// FULL is the port's vector walk, SCALAR its byte-a-step walk, SECTOR
// the above. The C entry takes the same arguments as the port's
// cilium_shed_walk_stride8, with a route code (0 scalar, 1 vector,
// 2 sector) in place of its vec flag, and refuses a route its inputs
// do not allow.
#include "common.cuh"

namespace {

constexpr int LPM_VEC_LEVELS = 16;
constexpr int LPM_SECTOR_BYTES = 32;
constexpr int LPM_LOADS_SCALAR = 0;
constexpr int LPM_LOADS_FULL = 1;
constexpr int LPM_LOADS_SECTOR = 2;

__device__ __forceinline__ const int32_t* lpm_stage_common(
    const int32_t* __restrict__ common, int k, int32_t* s_common) {
    if ((int)threadIdx.x < k) s_common[threadIdx.x] = __ldg(common + threadIdx.x);
    __syncthreads();
    return s_common;
}

template <int LOADS>
__device__ __forceinline__ int lpm_stride8_walk(
    const int32_t* __restrict__ child,   // [M, 256]
    const int32_t* __restrict__ info,    // [M, 256]
    int m,
    const int32_t* common,               // [K]; FULL / SECTOR: in shared memory
    int k,
    const int32_t* __restrict__ a,       // this address's bytes
    int levels) {
    int best = 0;
    int node = 0;
    if (LOADS != LPM_LOADS_SCALAR) {
        // SECTOR: the first sector's pieces, their compare, then the rest
        constexpr int FIRST = LOADS == LPM_LOADS_SECTOR ? 2 : LPM_VEC_LEVELS / 4;
        constexpr int COMPARED = LOADS == LPM_LOADS_SECTOR ? 8 : 0;
        int v[LPM_VEC_LEVELS];
        bool same = true;
#pragma unroll
        for (int c = 0; c < LPM_VEC_LEVELS / 4; ++c) {
            if (c == FIRST) {
#pragma unroll
                for (int j = 0; j < COMPARED; ++j) {
                    if (j < k) same &= v[j] == common[j];
                }
            }
            const int4 x = (c < FIRST || same) && c * 4 < levels
                               ? __ldg((const int4*)a + c) : make_int4(0, 0, 0, 0);
            v[c * 4] = x.x;
            v[c * 4 + 1] = x.y;
            v[c * 4 + 2] = x.z;
            v[c * 4 + 3] = x.w;
        }
#pragma unroll
        for (int j = COMPARED; j < LPM_VEC_LEVELS; ++j) {
            if (j < k) same &= v[j] == common[j];
        }
        if (!same) return 0;
#pragma unroll
        for (int j = 0; j < LPM_VEC_LEVELS; ++j) {
            if (j < k || j >= levels) continue;
            const int byte = v[j];
            if ((unsigned)byte > 255u) break;
            const int64_t flat = (int64_t)node * 256 + byte;
            const int hit = __ldg(info + flat);
            if (hit > 0) best = hit;
            const int nxt = __ldg(child + flat);
            if (nxt <= 0 || nxt >= m) break;
            node = nxt;
        }
        return best;
    }
    for (int j = 0; j < k; ++j) {
        if (__ldg(a + j) != __ldg(common + j)) return 0;
    }
    for (int lvl = k; lvl < levels; ++lvl) {
        const int byte = __ldg(a + lvl);
        if ((unsigned)byte > 255u) break;
        const int64_t flat = (int64_t)node * 256 + byte;
        const int hit = __ldg(info + flat);
        if (hit > 0) best = hit;
        const int nxt = __ldg(child + flat);
        if (nxt <= 0 || nxt >= m) break;
        node = nxt;
    }
    return best;
}

inline bool lpm_stride8_vec_ok(const int32_t* addr, int stride, int levels) {
    return levels <= LPM_VEC_LEVELS && stride % 4 == 0 && ((uintptr_t)addr & 15) == 0;
}

// The vector walk's precondition, with every row starting on a sector.
inline bool lpm_stride8_sector_ok(const int32_t* addr, int stride, int levels) {
    return levels <= LPM_VEC_LEVELS && (4 * stride) % LPM_SECTOR_BYTES == 0 &&
           ((uintptr_t)addr % LPM_SECTOR_BYTES) == 0;
}

__device__ __forceinline__ uint8_t shed_lookup(
    const uint8_t* __restrict__ shed_tab, int64_t n_rows, int world_row,
    int hit, int dport, int proto) {
    const int64_t row = hit > 0 ? (int64_t)hit - 1 : (int64_t)world_row;
    const int pi = 2 - 2 * (proto == 6) - (proto == 17);
    const int bucket = (dport >= 1024) + (dport >= 32768);
    const int64_t idx = row * 9 + pi * 3 + bucket;
    if (idx < 0 || idx >= n_rows * 9) return 0;
    return __ldg(shed_tab + idx) != 0;
}

constexpr int STRIDE8_THREADS = 256;

struct Stride8 {
    const int32_t* child;   // [M, 256]
    const int32_t* info;    // [M, 256]
    int m;
    const int32_t* common;  // [K]
    int k;
    const uint8_t* shed_tab;
    int64_t n_rows;
    int world_row;
    const int32_t* addr;    // [B, stride] one byte per int32
    int stride, levels;
    const int32_t* dport;   // [B]
    const int32_t* proto;   // [B]
    uint8_t* out;
    int64_t b;
};

// One thread a flow; the probe swaps this kernel and its launch for
// 2 or 4 flows a thread and a persistent grid.
template <int LOADS>
__global__ void __launch_bounds__(STRIDE8_THREADS) shed_walk_stride8_kernel(Stride8 p) {
    __shared__ int32_t s_common[LPM_VEC_LEVELS];
    const int32_t* com =
        LOADS != LPM_LOADS_SCALAR ? lpm_stage_common(p.common, p.k, s_common) : p.common;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.b) return;
    // in flight during the walk's first loads and compare
    const int dport = __ldg(p.dport + i);
    const int proto = __ldg(p.proto + i);
    const int hit =
        lpm_stride8_walk<LOADS>(p.child, p.info, p.m, com, p.k, p.addr + i * p.stride, p.levels);
    p.out[i] = shed_lookup(p.shed_tab, p.n_rows, p.world_row, hit, dport, proto);
}

template <int LOADS>
int launch_stride8(const Stride8& p, cudaStream_t s) {
    const int64_t blocks = (p.b + STRIDE8_THREADS - 1) / STRIDE8_THREADS;
    shed_walk_stride8_kernel<LOADS><<<(unsigned)blocks, STRIDE8_THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

CILIUM_API int cilium_shed_walk_stride8(
    const int32_t* child, const int32_t* info, int m, const int32_t* common, int k,
    const uint8_t* shed_tab, int64_t n_rows, int world_row, const int32_t* addr,
    int stride, int levels, const int32_t* dport, const int32_t* proto, uint8_t* out,
    int64_t b, int route, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    (void)cudaGetLastError();
    if ((route == LPM_LOADS_FULL && !lpm_stride8_vec_ok(addr, stride, levels)) ||
        (route == LPM_LOADS_SECTOR && !lpm_stride8_sector_ok(addr, stride, levels)) ||
        (route != LPM_LOADS_SCALAR && route != LPM_LOADS_FULL && route != LPM_LOADS_SECTOR))
        return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    const Stride8 p{child, info, m, common, k, shed_tab, n_rows, world_row, addr, stride,
                    levels, dport, proto, out, b};
    cudaStream_t s = (cudaStream_t)stream;
    if (route == LPM_LOADS_SECTOR) return launch_stride8<LPM_LOADS_SECTOR>(p, s);
    if (route == LPM_LOADS_FULL) return launch_stride8<LPM_LOADS_FULL>(p, s);
    return launch_stride8<LPM_LOADS_SCALAR>(p, s);
}
