// K3 lpm_wide: IPv4 longest-prefix match over the wide tries.
//
// Replaces cilium_tpu/ops/lpm.py:346 lpm_lookup_wide (called by
// datapath/pipeline.py:189 _v4_lpm_stage). One thread per address
// chains the walk's dependent gathers:
//
//   flat 16+16 (sub tables [M, 65536]):  root[hi16] -> sub[node][lo16]
//   16-8-8     (sub tables [M, 256])  :  root[hi16] -> sub[node][b2]
//                                                   -> sub[n1][b3]
//
// and returns the matched value+1, 0 = no match, longest match wins.
// The walk itself is lpm_wide_walk (lpm_walk.cuh), shared with K11.
// The layout is chosen on the host from the sub-table width, as the
// JAX function does at trace time. A node id outside [1, M) counts as
// no node, so no read leaves the tables.
//
// Bound: bytes. Each address moves 4 bytes in and 4 bytes out; the
// table reads are random but land in the 50 MB L2 for the main path's
// tries, so the flow arrays are the floor.
//
// What holds it above that floor is the sub-table gather, not the
// chain's latency: one scattered 4-byte read an address, so a warp's
// request touches 32 lines, which L1 serves one at a time. A vector
// walk (tools/k3_vector_walk.cu: 2, 4 or 8 addresses a thread, one
// 16-byte load and store, one wave of resident blocks) keeps more
// chains in flight and is no faster, on the main path's tries or on
// tries past L1 and L2 (tools/k3_probe.py), so this kernel stays.
#include "common.cuh"
#include "lpm_walk.cuh"

namespace {

__global__ void lpm_wide_kernel(
    const int32_t* __restrict__ root_info,   // [65536]
    const int32_t* __restrict__ root_child,  // [65536]
    const int32_t* __restrict__ sub_child,   // [M, 256] (16-8-8 only)
    const int32_t* __restrict__ sub_info,    // [M, 65536] or [M, 256]
    int m, int flat,
    const int32_t* __restrict__ addr,  // [B] uint32 bit view
    int32_t* __restrict__ out, int64_t b) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    out[i] = lpm_wide_walk(root_info, root_child, sub_child, sub_info, m, flat,
                           (uint32_t)addr[i]);
}

}  // namespace

CILIUM_API int cilium_lpm_wide(
    const int32_t* root_info, const int32_t* root_child,
    const int32_t* sub_child, const int32_t* sub_info, int m, int flat,
    const int32_t* addr, int32_t* out, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    const int threads = 256;
    const int64_t blocks = (b + threads - 1) / threads;
    lpm_wide_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        root_info, root_child, sub_child, sub_info, m, flat, addr, out, b);
    return (int)cudaGetLastError();
}
