// The per-address LPM walks shared by K3 lpm_wide, K5 lpm_stride8 and
// K11 shed_walk: one definition of each walk, inlined into every
// kernel that needs it, so the shed walk resolves an identity row
// exactly as the verdict path does.
//
// Both return the matched value+1 (0 = no match, longest match wins)
// and never read outside the tables: a node id outside [1, M) counts
// as no node, and a stride-8 byte outside [0, 255] ends the walk.
#pragma once

#include <stdint.h>

// Wide IPv4 walk (cilium_tpu/ops/lpm.py:346 lpm_lookup_wide):
//
//   flat 16+16 (sub tables [M, 65536]):  root[hi16] -> sub[node][lo16]
//   16-8-8     (sub tables [M, 256])  :  root[hi16] -> sub[node][b2]
//                                                   -> sub[n1][b3]
__device__ __forceinline__ int lpm_wide_walk(
    const int32_t* __restrict__ root_info,   // [65536]
    const int32_t* __restrict__ root_child,  // [65536]
    const int32_t* __restrict__ sub_child,   // [M, 256] (16-8-8 only)
    const int32_t* __restrict__ sub_info,    // [M, 65536] or [M, 256]
    int m, int flat, uint32_t q) {
    const int hi = (int)(q >> 16);
    int best = __ldg(root_info + hi);
    const int node = __ldg(root_child + hi);
    if (node > 0 && node < m) {
        if (flat) {
            const int v1 = __ldg(sub_info + (int64_t)node * 65536 + (q & 0xFFFFu));
            if (v1 > 0) best = v1;
        } else {
            const int64_t idx1 = (int64_t)node * 256 + ((q >> 8) & 0xFFu);
            const int v1 = __ldg(sub_info + idx1);
            const int n1 = __ldg(sub_child + idx1);
            if (v1 > 0) best = v1;
            if (n1 > 0 && n1 < m) {
                const int v2 = __ldg(sub_info + (int64_t)n1 * 256 + (q & 0xFFu));
                if (v2 > 0) best = v2;
            }
        }
    }
    return best;
}

// Elided stride-8 walk (cilium_tpu/ops/lpm.py:144 lpm_lookup with
// datapath/pipeline.py:171 _elided_lpm) of one address ``a`` (one byte
// per int32):
//
//   if a[0:K] != common[0:K]: no match        (elided shared bytes)
//   node = 0
//   for lvl in K .. levels-1:
//       flat = node * 256 + a[lvl]
//       if info[flat] > 0: best = info[flat]  (deepest match wins)
//       node = child[flat]; stop when node is 0
//
// VEC (levels <= LPM_VEC_LEVELS, ``a`` and the row stride multiples of
// 16 bytes: ops/lpm.py lpm_stride8_route): the address comes in as
// ceil(levels / 4) 16-byte loads issued together, the K compare runs on
// registers against ``common`` staged in shared memory
// (lpm_stage_common) with no load behind its branch, and each level
// takes its byte from registers, so only the info / child gathers stay
// in the dependent chain. Otherwise one __ldg a byte (``common`` in
// device memory).
constexpr int LPM_VEC_LEVELS = 16;  // ops/lpm.py LPM_VEC_LEVELS

// The K <= LPM_VEC_LEVELS common bytes copied into ``s_common`` once a
// block for the vector walk; every thread of the block calls it.
__device__ __forceinline__ const int32_t* lpm_stage_common(
    const int32_t* __restrict__ common, int k, int32_t* s_common) {
    if ((int)threadIdx.x < k) s_common[threadIdx.x] = __ldg(common + threadIdx.x);
    __syncthreads();
    return s_common;
}

template <bool VEC>
__device__ __forceinline__ int lpm_stride8_walk(
    const int32_t* __restrict__ child,   // [M, 256]
    const int32_t* __restrict__ info,    // [M, 256]
    int m,
    const int32_t* common,               // [K]; VEC: in shared memory
    int k,
    const int32_t* __restrict__ a,       // this address's bytes
    int levels) {
    int best = 0;
    int node = 0;
    if (VEC) {
        int v[LPM_VEC_LEVELS];
#pragma unroll
        for (int c = 0; c < LPM_VEC_LEVELS / 4; ++c) {
            const int4 x = c * 4 < levels ? __ldg((const int4*)a + c) : make_int4(0, 0, 0, 0);
            v[c * 4] = x.x;
            v[c * 4 + 1] = x.y;
            v[c * 4 + 2] = x.z;
            v[c * 4 + 3] = x.w;
        }
        bool same = true;
#pragma unroll
        for (int j = 0; j < LPM_VEC_LEVELS; ++j) {
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

// The vector walk's precondition, checked by every C entry that takes
// it (the wrapper's route, ops/lpm.py lpm_stride8_route).
inline bool lpm_stride8_vec_ok(const int32_t* addr, int stride, int levels) {
    return levels <= LPM_VEC_LEVELS && stride % 4 == 0 && ((uintptr_t)addr & 15) == 0;
}
