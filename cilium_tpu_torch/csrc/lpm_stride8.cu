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
// The K compare runs in the same launch, not as a separate pass; the
// walk is lpm_stride8_walk (lpm_walk.cuh), shared with K11. A
// byte outside [0, 255] reads nothing and ends the walk, and so does a
// child id outside [1, M): no read leaves the tables, as with the fill
// of an out-of-range jnp.take (no hit, the walk ends).
//
// Bound: bytes. Each address reads the int32 bytes its walk needs
// (up to the first mismatch of the K compare, then one per level) and
// writes 4 bytes; the trie's nodes sit in L2. The first version read
// the address one __ldg a byte, each behind the compare's or the
// walk's branch, so every byte read sat in the dependent chain; the
// vector walk (``vec``, the wrapper's route: ops/lpm.py
// lpm_stride8_route) reads the row as 16-byte loads issued together,
// compares against ``common`` staged in shared memory once a block, and
// leaves only the trie gathers in the chain. Any other stride, offset
// or depth takes the byte-a-step walk in the same kernel.
#include "common.cuh"
#include "lpm_walk.cuh"

namespace {

template <bool VEC>
__global__ void lpm_stride8_kernel(
    const int32_t* __restrict__ child,   // [M, 256]
    const int32_t* __restrict__ info,    // [M, 256]
    int m,
    const int32_t* __restrict__ common,  // [K]
    int k,
    const int32_t* __restrict__ addr,    // [B, stride] one byte per int32
    int stride, int levels,
    int32_t* __restrict__ out, int64_t b) {
    __shared__ int32_t s_common[LPM_VEC_LEVELS];
    const int32_t* com = VEC ? lpm_stage_common(common, k, s_common) : common;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    out[i] = lpm_stride8_walk<VEC>(child, info, m, com, k, addr + i * stride, levels);
}

}  // namespace

CILIUM_API int cilium_lpm_stride8(
    const int32_t* child, const int32_t* info, int m, const int32_t* common,
    int k, const int32_t* addr, int stride, int levels, int32_t* out,
    int64_t b, int vec, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    // report this launch's error, not one an earlier runtime call left
    (void)cudaGetLastError();
    if (vec && !lpm_stride8_vec_ok(addr, stride, levels)) return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    const int threads = 256;
    const int64_t blocks = (b + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec) {
        lpm_stride8_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
            child, info, m, common, k, addr, stride, levels, out, b);
    } else {
        lpm_stride8_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
            child, info, m, common, k, addr, stride, levels, out, b);
    }
    return (int)cudaGetLastError();
}
