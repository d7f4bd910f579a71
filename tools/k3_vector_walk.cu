// K3 lpm_wide as a vector walk, kept for tools/k3_probe.py: the design
// tried against the kernel in cilium_tpu_torch/csrc/lpm_wide.cu, and no
// faster than it on the v4 main path's tries nor on tries past L1 and
// L2 (the probe's numbers in PERF.md). Built only by the probe.
//
// A thread takes LPM_WIDE_VEC addresses, read with one 16-byte load and
// written with one 16-byte store, and walks them together
// (lpm_wide_walk_n: every root gather before any sub-table gather), so
// each thread keeps LPM_WIDE_VEC chains in flight; the grid is sized to
// the blocks the card holds at once (a grid-stride loop past that), so
// 1M addresses run in one wave while the flows stream. The ragged tail
// (B mod LPM_WIDE_VEC) is walked one address a thread (lpm_wide_walk)
// in the same launch. Both pointers must be 16-byte aligned.
#include "common.cuh"
#include "lpm_walk.cuh"

namespace {

constexpr int LPM_WIDE_VEC = 4;
constexpr int LPM_WIDE_THREADS = 256;
constexpr int LPM_MAX_DEVICES = 64;

// The two root words of /16 bucket ``hi``.
__device__ __forceinline__ int2 lpm_wide_root(
    const int32_t* __restrict__ root_info, const int32_t* __restrict__ root_child, int hi) {
    return make_int2(__ldg(root_info + hi), __ldg(root_child + hi));
}

// lpm_wide_walk over V addresses at once: every address's root gathers
// are issued before any sub-table gather, and each level's gathers of
// all V before the next level's. Same results as V calls of
// lpm_wide_walk, the layout fixed at compile time.
template <int V, bool FLAT>
__device__ __forceinline__ void lpm_wide_walk_n(
    const int32_t* __restrict__ root_info,   // [65536]
    const int32_t* __restrict__ root_child,  // [65536]
    const int32_t* __restrict__ sub_child,   // [M, 256] (16-8-8 only)
    const int32_t* __restrict__ sub_info,    // [M, 65536] or [M, 256]
    int m, const uint32_t (&q)[V], int (&best)[V]) {
    int node[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const int2 r = lpm_wide_root(root_info, root_child, (int)(q[j] >> 16));
        best[j] = r.x;
        node[j] = r.y > 0 && r.y < m ? r.y : 0;  // 0: no node
    }
    int v1[V];
    if (FLAT) {
#pragma unroll
        for (int j = 0; j < V; ++j)
            v1[j] = node[j] ? __ldg(sub_info + (int64_t)node[j] * 65536 + (q[j] & 0xFFFFu)) : 0;
#pragma unroll
        for (int j = 0; j < V; ++j)
            if (v1[j] > 0) best[j] = v1[j];
        return;
    }
    int n1[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const int64_t idx1 = (int64_t)node[j] * 256 + ((q[j] >> 8) & 0xFFu);
        v1[j] = node[j] ? __ldg(sub_info + idx1) : 0;
        n1[j] = node[j] ? __ldg(sub_child + idx1) : 0;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
        if (v1[j] > 0) best[j] = v1[j];
        if (n1[j] <= 0 || n1[j] >= m) n1[j] = 0;
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
        v1[j] = n1[j] ? __ldg(sub_info + (int64_t)n1[j] * 256 + (q[j] & 0xFFu)) : 0;
#pragma unroll
    for (int j = 0; j < V; ++j)
        if (v1[j] > 0) best[j] = v1[j];
}

template <int V>
__device__ __forceinline__ void lpm_load_vec(const int32_t* __restrict__ p, uint32_t (&q)[V]) {
    static_assert(V % 2 == 0, "a vector of 2, 4 or 8 addresses");
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int c = 0; c < V / 4; ++c) {
            const int4 x = __ldg(reinterpret_cast<const int4*>(p) + c);
            q[4 * c] = (uint32_t)x.x;
            q[4 * c + 1] = (uint32_t)x.y;
            q[4 * c + 2] = (uint32_t)x.z;
            q[4 * c + 3] = (uint32_t)x.w;
        }
    } else {
#pragma unroll
        for (int c = 0; c < V / 2; ++c) {
            const int2 x = __ldg(reinterpret_cast<const int2*>(p) + c);
            q[2 * c] = (uint32_t)x.x;
            q[2 * c + 1] = (uint32_t)x.y;
        }
    }
}

template <int V>
__device__ __forceinline__ void lpm_store_vec(int32_t* __restrict__ p, const int (&v)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int c = 0; c < V / 4; ++c)
            reinterpret_cast<int4*>(p)[c] = make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else {
#pragma unroll
        for (int c = 0; c < V / 2; ++c)
            reinterpret_cast<int2*>(p)[c] = make_int2(v[2 * c], v[2 * c + 1]);
    }
}

template <bool FLAT>
__global__ void __launch_bounds__(LPM_WIDE_THREADS) lpm_wide_vec_kernel(
    const int32_t* __restrict__ root_info, const int32_t* __restrict__ root_child,
    const int32_t* __restrict__ sub_child, const int32_t* __restrict__ sub_info, int m,
    const int32_t* __restrict__ addr,  // [B], 16-byte aligned
    int32_t* __restrict__ out,         // [B], 16-byte aligned
    int64_t b) {
    constexpr int V = LPM_WIDE_VEC;
    const int64_t nv = b / V;
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = t; i < nv; i += step) {
        uint32_t q[V];
        int best[V];
        lpm_load_vec<V>(addr + i * V, q);
        lpm_wide_walk_n<V, FLAT>(root_info, root_child, sub_child, sub_info, m, q, best);
        lpm_store_vec<V>(out + i * V, best);
    }
    const int64_t tail = nv * V + t;  // the B mod V last addresses
    if (tail < b)
        out[tail] = lpm_wide_walk(root_info, root_child, sub_child, sub_info, m, FLAT,
                                  (uint32_t)__ldg(addr + tail));
}

// Blocks of the vector kernel the card holds at once (SMs x resident
// blocks an SM), per layout and device, asked once.
int lpm_wide_resident(bool flat, int device) {
    static int cached[2][LPM_MAX_DEVICES];
    if (device < 0 || device >= LPM_MAX_DEVICES) return 0;
    int& n = cached[flat][device];
    if (n == 0) {
        int sms = 0, per_sm = 0;
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
            return 0;
        const cudaError_t err = flat
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lpm_wide_vec_kernel<true>,
                                                            LPM_WIDE_THREADS, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lpm_wide_vec_kernel<false>,
                                                            LPM_WIDE_THREADS, 0);
        if (err != cudaSuccess) return 0;
        n = sms * (per_sm > 0 ? per_sm : 1);
    }
    return n;
}

}  // namespace

extern "C" int cilium_lpm_wide_vec(
    const int32_t* root_info, const int32_t* root_child,
    const int32_t* sub_child, const int32_t* sub_info, int m, int flat,
    const int32_t* addr, int32_t* out, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    (void)cudaGetLastError();
    if ((((uintptr_t)addr | (uintptr_t)out) & 15) != 0) return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    const int threads = LPM_WIDE_THREADS;
    const int resident = lpm_wide_resident(flat != 0, device);
    if (resident <= 0) return (int)cudaErrorInvalidDevice;
    // one thread a vector, and at least one for each tail address
    const int64_t work = b / LPM_WIDE_VEC > b % LPM_WIDE_VEC ? b / LPM_WIDE_VEC : b % LPM_WIDE_VEC;
    int64_t blocks = (work + threads - 1) / threads;
    if (blocks > resident) blocks = resident;
    cudaStream_t s = (cudaStream_t)stream;
    if (flat) {
        lpm_wide_vec_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
            root_info, root_child, sub_child, sub_info, m, addr, out, b);
    } else {
        lpm_wide_vec_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
            root_info, root_child, sub_child, sub_info, m, addr, out, b);
    }
    return (int)cudaGetLastError();
}
