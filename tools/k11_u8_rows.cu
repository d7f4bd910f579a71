// K11 shed_walk's IPv6 entry over uint8 address rows, a probe-only
// variant for tools/k11_probe.py: it sizes ROADMAP A3's host item "v6
// uploads 16 int32 per address", and no wrapper routes to it. A row is
// the address's 16 bytes, one 16-byte load (a 32-byte sector holds two
// rows), where the port's rows are 16 int32 (64 bytes, two sectors).
// The walk is csrc/lpm_walk.cuh's vector walk on those bytes (a uint8
// byte is never outside [0, 255]), the lookup csrc/shed_walk.cu's:
//
//   if a[0:K] != common[0:K]: hit = 0, else the stride-8 trie walk
//   row  = hit > 0 ? hit - 1 : world_row
//   shed = shed_tab[row * 9 + flow class] != 0  (outside [0, N*9): 0)
#include "common.cuh"

namespace {

constexpr int LEVELS = 16;

__global__ void shed_walk_u8_kernel(
    const int32_t* __restrict__ child, const int32_t* __restrict__ info, int m,
    const int32_t* __restrict__ common, int k,
    const uint8_t* __restrict__ shed_tab, int64_t n_rows, int world_row,
    const uint8_t* __restrict__ addr,  // [B, 16], 16-byte aligned
    const int32_t* __restrict__ dport, const int32_t* __restrict__ proto,
    uint8_t* __restrict__ out, int64_t b) {
    __shared__ int32_t s_common[LEVELS];
    if ((int)threadIdx.x < k) s_common[threadIdx.x] = __ldg(common + threadIdx.x);
    __syncthreads();
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    const uint4 x = __ldg((const uint4*)addr + i);
    const int dp = __ldg(dport + i);
    const int pr = __ldg(proto + i);
    int best = 0;
    bool same = true;
#pragma unroll
    for (int j = 0; j < LEVELS; ++j) {
        if (j < k) same &= chunk_element<uint8_t>(x, j) == s_common[j];
    }
    if (same) {
        int node = 0;
#pragma unroll
        for (int j = 0; j < LEVELS; ++j) {
            if (j < k) continue;
            const int64_t flat = (int64_t)node * 256 + chunk_element<uint8_t>(x, j);
            const int hit = __ldg(info + flat);
            if (hit > 0) best = hit;
            const int nxt = __ldg(child + flat);
            if (nxt <= 0 || nxt >= m) break;
            node = nxt;
        }
    }
    const int64_t row = best > 0 ? (int64_t)best - 1 : (int64_t)world_row;
    const int pi = 2 - 2 * (pr == 6) - (pr == 17);
    const int64_t idx = row * 9 + pi * 3 + (dp >= 1024) + (dp >= 32768);
    out[i] = idx >= 0 && idx < n_rows * 9 && __ldg(shed_tab + idx) != 0;
}

}  // namespace

CILIUM_API int k11_shed_walk_u8(
    const int32_t* child, const int32_t* info, int m, const int32_t* common, int k,
    const uint8_t* shed_tab, int64_t n_rows, int world_row, const uint8_t* addr,
    const int32_t* dport, const int32_t* proto, uint8_t* out, int64_t b, void* stream) {
    (void)cudaGetLastError();
    if (k > LEVELS || ((uintptr_t)addr & 15)) return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    const int threads = 256;
    shed_walk_u8_kernel<<<(unsigned)((b + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(child, info, m, common, k, shed_tab, n_rows,
                                                  world_row, addr, dport, proto, out, b);
    return (int)cudaGetLastError();
}
