// K1 selector_match as first ported, kept for tools/k1_probe.py: one
// lane a selector, every conjunct word read from device memory for
// every identity row. The kernel in cilium_tpu_torch/csrc/
// selector_match.cu replaced it; this copy is built only by the probe,
// to time the first version against the redesign.
//
// Replaces cilium_tpu/ops/bitmap.py:57 compute_selector_matches, whose
// TPU form unpacks the label words to int8 bit lanes and runs two
// [chunk, L] x [L, S*CPS] int8 products. Here each thread owns one
// (identity row, selector) pair and works on the packed words
// directly with __popc, so no unpacked int8 array ever reaches device
// memory:
//
//   match = any_c valid[s,c] && popc(id & req[s,c]) == req_count[s,c]
//                            && (id & forbid[s,c]) == 0
//
// A warp covers 32 consecutive selectors of one row and packs their
// results into one output word with __ballot_sync (lane k = bit k, the
// bit order of ops/bitmap.py pack_bool_bits).
//
// Bound: operations. The work is counted as the TPU form's two int8
// products (2 * N * 32W * S * CPS operations each) at the card's int8
// tensor-core rate; moving the inputs (a few hundred KB) and the
// N*S/8-byte output takes less time than that.
#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;

__global__ void selector_match_kernel(
    const int32_t* __restrict__ id_bits,      // [N, W]
    const int32_t* __restrict__ conj_req,     // [S, CPS, W]
    const int32_t* __restrict__ conj_forbid,  // [S, CPS, W]
    const uint8_t* __restrict__ conj_valid,   // [S, CPS]
    const int32_t* __restrict__ req_count,    // [S, CPS]
    int32_t* __restrict__ out,                // [N, S_words]
    int n, int w, int s, int cps, int s_words) {
    const int lane = threadIdx.x;
    const int word = blockIdx.y;
    const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.y;
    if (row >= n) return;  // uniform across the warp (one row per warp)
    const int sel = word * 32 + lane;
    bool ok = false;
    if (sel < s) {
        const uint32_t* idr =
            reinterpret_cast<const uint32_t*>(id_bits) + (int64_t)row * w;
        for (int c = 0; c < cps && !ok; ++c) {
            const int64_t idx = (int64_t)sel * cps + c;
            if (!conj_valid[idx]) continue;
            const uint32_t* rq =
                reinterpret_cast<const uint32_t*>(conj_req) + idx * w;
            const uint32_t* fb =
                reinterpret_cast<const uint32_t*>(conj_forbid) + idx * w;
            int hit = 0;
            uint32_t bad = 0;
            for (int k = 0; k < w; ++k) {
                const uint32_t iw = __ldg(idr + k);
                hit += __popc(iw & __ldg(rq + k));
                bad |= iw & __ldg(fb + k);
            }
            ok = (hit == req_count[idx]) && (bad == 0);
        }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) out[(int64_t)row * s_words + word] = (int32_t)mask;
}

}  // namespace

CILIUM_API int cilium_selector_match(
    const int32_t* id_bits, const int32_t* conj_req,
    const int32_t* conj_forbid, const uint8_t* conj_valid,
    const int32_t* req_count, int32_t* out, int n, int w, int s, int cps,
    int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    const int s_words = (s + 31) / 32;
    if (n == 0 || s_words == 0) return (int)cudaGetLastError();
    dim3 block(32, ROWS_PER_BLOCK);
    dim3 grid((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, s_words);
    selector_match_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        id_bits, conj_req, conj_forbid, conj_valid, req_count, out, n, w, s,
        cps, s_words);
    return (int)cudaGetLastError();
}

CILIUM_API const char* cilium_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
