// K5 lpm_stride8: longest-prefix match over an elided stride-8 trie.
//
// Replaces cilium_tpu/ops/lpm.py:144 lpm_lookup and folds in
// datapath/pipeline.py:171 _elided_lpm (the IPv6 identity, deny and
// fused deny+identity walks of _v6_lpm_stage). One thread per address:
//
//   if addr[0:K] != common[0:K]: out = 0          (elided shared bytes)
//   node = 0
//   for lvl in K .. levels-1:
//       flat = node * 256 + addr[lvl]
//       if info[flat] > 0: best = info[flat]      (deepest match wins)
//       node = child[flat]; stop when node is 0
//   out = best                                    (value+1, 0 = none)
//
// The K compare runs in the same launch, not as a separate pass. A
// byte outside [0, 255] reads nothing and ends the walk, and so does a
// child id outside [1, M): no read leaves the tables, as with the fill
// of an out-of-range jnp.take (no hit, the walk ends).
//
// Bound: bytes. Each address reads the int32 bytes its walk needs
// (up to the first mismatch of the K compare, then one per level) and
// writes 4 bytes; the trie's nodes sit in L2.
#include "common.cuh"

namespace {

__global__ void lpm_stride8_kernel(
    const int32_t* __restrict__ child,   // [M, 256]
    const int32_t* __restrict__ info,    // [M, 256]
    int m,
    const int32_t* __restrict__ common,  // [K]
    int k,
    const int32_t* __restrict__ addr,    // [B, stride] one byte per int32
    int stride, int levels,
    int32_t* __restrict__ out, int64_t b) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    const int32_t* a = addr + i * stride;
    for (int j = 0; j < k; ++j) {
        if (__ldg(a + j) != __ldg(common + j)) {
            out[i] = 0;
            return;
        }
    }
    int best = 0;
    int node = 0;
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
    out[i] = best;
}

}  // namespace

CILIUM_API int cilium_lpm_stride8(
    const int32_t* child, const int32_t* info, int m, const int32_t* common,
    int k, const int32_t* addr, int stride, int levels, int32_t* out,
    int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    const int threads = 256;
    const int64_t blocks = (b + threads - 1) / threads;
    lpm_stride8_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        child, info, m, common, k, addr, stride, levels, out, b);
    return (int)cudaGetLastError();
}
