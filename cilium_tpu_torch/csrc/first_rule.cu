// K6 first_rule: the first-match rule reduction of verdict attribution.
//
// Replaces cilium_tpu/ops/verdict.py:224 _first, which _verdict_block
// calls three times in its attribution tail (deny, pure-L3 allow and
// L4 combo terms; ops/materialize.py:166 _sweep_device_attrib reaches
// it through verdict_batch). For each row b of a bool mask [B, S]:
//
//   out[b] = min over s of (mask[b, s] ? rule_of[s] : NO_RULE)
//
// i.e. the lowest repository rule index whose term fired. One warp
// per row: each lane strides over the columns, then a shuffle-min
// reduces the 32 partial minima. The minimum of integers does not
// depend on the order of the reduction.
//
// Bound: bytes. The mask is read once (B x S bytes), rule_of (4 S
// bytes) stays in L1/L2, and 4 B bytes are written.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // rows per 256-thread block
constexpr int32_t NO_RULE = 0x7FFFFFFF;

__global__ void first_rule_kernel(
    const uint8_t* __restrict__ mask,     // [B, S] bool
    const int32_t* __restrict__ rule_of,  // [S]
    int s, int64_t b,
    int32_t* __restrict__ out) {          // [B]
    const int lane = threadIdx.x & 31;
    const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (row >= b) return;  // whole warps leave together
    const uint8_t* mrow = mask + row * s;
    int32_t best = NO_RULE;
    for (int j = lane; j < s; j += 32) {
        if (mrow[j]) best = min(best, __ldg(rule_of + j));
    }
    for (int off = 16; off > 0; off >>= 1) {
        best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, off));
    }
    if (lane == 0) out[row] = best;
}

}  // namespace

CILIUM_API int cilium_first_rule(
    const uint8_t* mask, const int32_t* rule_of, int s, int64_t b,
    int32_t* out, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    const int64_t blocks = (b + WARPS - 1) / WARPS;
    first_rule_kernel<<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        mask, rule_of, s, b, out);
    return (int)cudaGetLastError();
}
