// K6 first_rule: the first-match rule reductions of verdict attribution.
//
// Replaces cilium_tpu/ops/verdict.py:224 _first, which _verdict_block
// calls three times in its attribution tail (deny, pure-L3 allow and
// L4 combo terms; ops/materialize.py:166 _sweep_device_attrib reaches
// it through verdict_batch). For each term k (one to three, passed by
// value as a FirstRuleTerms list) and each row b of its bool mask
// [B, S_k]:
//
//   out_k[b] = min over s of (mask_k[b, s] ? rule_of_k[s] : NO_RULE)
//
// i.e. the lowest repository rule index whose term fired. One launch
// serves every term of a sweep block (grid y = the term): 87 launches
// per attributed bench rebuild instead of 261, 3 per attributed column
// patch instead of 9.
//
// One warp per (term, row). The lanes read the row 16 bytes a lane
// where its base allows (the unaligned head and the tail byte by
// byte), skip all-zero vectors, and read rule_of only for set bytes;
// a shuffle-min then reduces the 32 partial minima. The minimum of
// integers does not depend on the order of the reduction.
//
// Bound: bytes. Each mask is read once (B x S_k bytes), rule_of (4 S_k
// bytes) stays in L1/L2, and 4 B bytes are written per term. The first
// version read one byte a lane per load, 20 dependent loads a row at
// S = 640, and its time did not follow its bytes (0.0253 ms at
// [8192, 640], 0.0246 at [8192, 4096]).
#include "common.cuh"

constexpr int FIRST_RULE_MAX_TERMS = 3;  // _kernels.py FIRST_RULE_MAX_TERMS

// passed by value; ctypes mirror: _kernels.py FirstRuleTerms
struct FirstRuleTerms {
    const uint8_t* mask[FIRST_RULE_MAX_TERMS];     // [B, width] bool
    const int32_t* rule_of[FIRST_RULE_MAX_TERMS];  // [width]
    int32_t* out[FIRST_RULE_MAX_TERMS];            // [B]
    int width[FIRST_RULE_MAX_TERMS];
    int n;
};

namespace {

constexpr int WARPS = 8;  // rows per 256-thread block
constexpr int32_t NO_RULE = 0x7FFFFFFF;

__device__ __forceinline__ int32_t min_set_bytes(uint32_t word, const int32_t* rule_of,
                                                 int32_t best) {
    while (word) {
        const int byte = (__ffs(word) - 1) >> 3;
        word &= ~(0xFFu << (8 * byte));
        best = min(best, __ldg(rule_of + byte));
    }
    return best;
}

__global__ void first_rule_kernel(const __grid_constant__ FirstRuleTerms t, int64_t b) {
    const uint8_t* mask = nullptr;
    const int32_t* rule_of = nullptr;
    int32_t* out = nullptr;
    int s = 0;
#pragma unroll
    for (int k = 0; k < FIRST_RULE_MAX_TERMS; ++k) {
        if (k == (int)blockIdx.y) {
            mask = t.mask[k];
            rule_of = t.rule_of[k];
            out = t.out[k];
            s = t.width[k];
        }
    }
    const int lane = threadIdx.x & 31;
    const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (row >= b) return;  // whole warps leave together
    const uint8_t* m = mask + row * s;
    int32_t best = NO_RULE;
    const int head = min(s, (int)((16 - ((uintptr_t)m & 15)) & 15));
    for (int j = lane; j < head; j += 32) {
        if (m[j]) best = min(best, __ldg(rule_of + j));
    }
    const int nv = (s - head) >> 4;
    const uint4* mv = reinterpret_cast<const uint4*>(m + head);
    for (int v = lane; v < nv; v += 32) {
        const uint4 x = __ldg(mv + v);
        if ((x.x | x.y | x.z | x.w) == 0) continue;
        const int32_t* r = rule_of + head + v * 16;
        best = min_set_bytes(x.x, r, best);
        best = min_set_bytes(x.y, r + 4, best);
        best = min_set_bytes(x.z, r + 8, best);
        best = min_set_bytes(x.w, r + 12, best);
    }
    for (int j = head + nv * 16 + lane; j < s; j += 32) {
        if (m[j]) best = min(best, __ldg(rule_of + j));
    }
    for (int off = 16; off > 0; off >>= 1) {
        best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, off));
    }
    if (lane == 0) out[row] = best;
}

}  // namespace

CILIUM_API int cilium_first_rule(FirstRuleTerms terms, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (terms.n < 1 || terms.n > FIRST_RULE_MAX_TERMS) return (int)cudaErrorInvalidValue;
    (void)cudaGetLastError();  // report this launch's error only
    if (b == 0) return 0;
    const int64_t blocks = (b + WARPS - 1) / WARPS;
    const dim3 grid((unsigned)blocks, (unsigned)terms.n);
    first_rule_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(terms, b);
    return (int)cudaGetLastError();
}
