// K11 shed_walk: the admission gate's prefilter shed walk.
//
// Replaces cilium_tpu/datapath/pipeline.py:521 shed_flows_wide (IPv4)
// and :537 shed_flows (IPv6). One thread per flow:
//
//   hit  = identity walk of the peer     (K3's or K5's, lpm_walk.cuh)
//   row  = hit > 0 ? hit - 1 : world_row
//   cls  = pi * 3 + bucket,  pi = 2 - 2*(proto==6) - (proto==17),
//          bucket = (dport >= 1024) + (dport >= 32768)
//   shed = shed_tab[row * 9 + cls] != 0
//
// shed_tab is the [N, 9] uint8 deny-for-sure table that
// cilium_tpu_torch/datapath/admission.py compile_shed_table builds.
// An index outside [0, N*9) sheds nothing: a row past the table is a
// table stale against the tries, and the sound answer is "not sure".
// (jnp.take on uint8 fills such an index with 255, which sheds.)
//
// Two entries: shed_walk_wide walks the wide IPv4 identity trie with a
// uint32 address per flow; shed_walk_stride8 walks the elided
// stride-8 IPv6 identity trie with 16 int32 bytes per flow, ending the
// walk at a byte outside [0, 255] as K5 does, and on K5's routes: the
// row as 16-byte loads where ``vec`` (ops/lpm.py lpm_stride8_route),
// else a byte a step.
//
// Bound: bytes. Per flow 12 bytes in (v4; 72 on v6) and 1 byte out,
// plus the trie cells and table sectors the walk reaches, which sit in
// L2 for the main path's tables. A dependent chain of 2 (v4) or up to
// 16 (v6) gathers per thread; many threads in flight hide it.
//
// On the gate's deny-heavy v6 batch about 3/4 of the lanes are world
// peers whose K compare fails on byte 0, yet each reads its whole
// 64-byte row. A route that loads a row's second 32-byte sector only
// for lanes whose compare holds (tools/k11_sector_walk.cu) is no
// faster: the L2 fetches the 64-byte row whole (tools/k11_probe.py's
// no-walk floors), so this kernel stays. Rows of 16 uint8 bytes
// (tools/k11_u8_rows.cu) would read fewer bytes, but the pipeline
// uploads int32 rows.
#include "common.cuh"
#include "lpm_walk.cuh"

namespace {

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

__global__ void shed_walk_wide_kernel(
    const int32_t* __restrict__ root_info, const int32_t* __restrict__ root_child,
    const int32_t* __restrict__ sub_child, const int32_t* __restrict__ sub_info,
    int m, int flat,
    const uint8_t* __restrict__ shed_tab, int64_t n_rows, int world_row,
    const int32_t* __restrict__ addr,   // [B] uint32 bit view
    const int32_t* __restrict__ dport,  // [B]
    const int32_t* __restrict__ proto,  // [B]
    uint8_t* __restrict__ out, int64_t b) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    const int hit = lpm_wide_walk(root_info, root_child, sub_child, sub_info, m, flat,
                                  (uint32_t)addr[i]);
    out[i] = shed_lookup(shed_tab, n_rows, world_row, hit, dport[i], proto[i]);
}

template <bool VEC>
__global__ void shed_walk_stride8_kernel(
    const int32_t* __restrict__ child, const int32_t* __restrict__ info, int m,
    const int32_t* __restrict__ common, int k,
    const uint8_t* __restrict__ shed_tab, int64_t n_rows, int world_row,
    const int32_t* __restrict__ addr,   // [B, stride] one byte per int32
    int stride, int levels,
    const int32_t* __restrict__ dport, const int32_t* __restrict__ proto,
    uint8_t* __restrict__ out, int64_t b) {
    __shared__ int32_t s_common[LPM_VEC_LEVELS];
    const int32_t* com = VEC ? lpm_stage_common(common, k, s_common) : common;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    const int hit = lpm_stride8_walk<VEC>(child, info, m, com, k, addr + i * stride, levels);
    out[i] = shed_lookup(shed_tab, n_rows, world_row, hit, dport[i], proto[i]);
}

}  // namespace

CILIUM_API int cilium_shed_walk_wide(
    const int32_t* root_info, const int32_t* root_child, const int32_t* sub_child,
    const int32_t* sub_info, int m, int flat, const uint8_t* shed_tab, int64_t n_rows,
    int world_row, const int32_t* addr, const int32_t* dport, const int32_t* proto,
    uint8_t* out, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    const int threads = 256;
    const int64_t blocks = (b + threads - 1) / threads;
    shed_walk_wide_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        root_info, root_child, sub_child, sub_info, m, flat, shed_tab, n_rows, world_row,
        addr, dport, proto, out, b);
    return (int)cudaGetLastError();
}

CILIUM_API int cilium_shed_walk_stride8(
    const int32_t* child, const int32_t* info, int m, const int32_t* common, int k,
    const uint8_t* shed_tab, int64_t n_rows, int world_row, const int32_t* addr,
    int stride, int levels, const int32_t* dport, const int32_t* proto, uint8_t* out,
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
        shed_walk_stride8_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
            child, info, m, common, k, shed_tab, n_rows, world_row, addr, stride, levels,
            dport, proto, out, b);
    } else {
        shed_walk_stride8_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
            child, info, m, common, k, shed_tab, n_rows, world_row, addr, stride, levels,
            dport, proto, out, b);
    }
    return (int)cudaGetLastError();
}
