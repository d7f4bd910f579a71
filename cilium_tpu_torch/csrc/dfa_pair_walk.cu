// K8 dfa_pair_walk: batched walk of a multi-pattern DFA, two bytes per
// step over the stride-2 pair table.
//
// Replaces cilium_tpu/ops/dfa.py:264 dfa_match_batch_pair (the
// L7DeviceBatch-on path of a fused table small enough to carry a pair
// table: F * q_pad * 257^2 <= 2^23 int32, so Q <= 126). One thread per
// row:
//
//   end = min(length, max_len)
//   for lvl = 0, 2, 4, ... while lvl < end:
//       b0 = bytes[i, lvl]
//       b1 = lvl + 1 < end ? bytes[i, lvl + 1] : 256     (pad symbol)
//       state = pair[(state * 257 + b0) * 257 + b1]
//   out = (accept_lo[state], accept_hi[state]), or 0 for length < 0
//
// The JAX program runs all ceil(max_len / 2) steps; the steps past
// `end` are (pad, pad), the identity of the tables _pair_table builds,
// so stopping at `end` gives the same state. No byte at or past
// max_len is read: the JAX walk reads bytes[:, max_len] (clamped to the
// last byte) when max_len is odd and a row is longer than max_len,
// which is the reference fault recorded in ROADMAP queue C; here that
// position is the pad, equal to the single-byte walk. A byte outside
// [0, 255] or a state outside [0, Q) ends the walk with mask 0.
//
// Bound: bytes. Each row reads the min(length, max_len) bytes it walks,
// its length and start, and writes 8 bytes of mask; the pair table is
// up to 32 MiB, but a corpus reaches few of its entries (L2 holds
// them), half as many dependent gathers as the single-byte walk.
#include "common.cuh"

namespace {

constexpr int kAlpha = 257;
constexpr int kPad = 256;

template <typename ByteT>
__global__ void dfa_pair_walk_kernel(
    const int32_t* __restrict__ pair,       // [Q, 257 * 257]
    int q,
    const int32_t* __restrict__ accept_lo,  // [Q]
    const int32_t* __restrict__ accept_hi,  // [Q]
    const int32_t* __restrict__ starts,     // [B]
    const ByteT* __restrict__ bytes,        // [B, row_stride]
    int row_stride, int max_len,
    const int32_t* __restrict__ lengths,    // [B]
    int32_t* __restrict__ out_lo, int32_t* __restrict__ out_hi, int64_t b) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    const int len = __ldg(lengths + i);
    int state = __ldg(starts + i);
    int lo = 0, hi = 0;
    if (len >= 0 && (unsigned)state < (unsigned)q) {
        const ByteT* row = bytes + i * (int64_t)row_stride;
        const int end = min(len, max_len);
        bool alive = true;
        for (int lvl = 0; lvl < end; lvl += 2) {
            const int b0 = (int)__ldg(row + lvl);
            bool bad = (unsigned)b0 > 255u;  // outside [0, 255]: int32 input only
            int b1 = kPad;
            if (lvl + 1 < end) {
                b1 = (int)__ldg(row + lvl + 1);
                bad = bad || (unsigned)b1 > 255u;
            }
            if (bad) { alive = false; break; }
            state = __ldg(pair + ((int64_t)state * kAlpha + b0) * kAlpha + b1);
            if ((unsigned)state >= (unsigned)q) { alive = false; break; }
        }
        if (alive) {
            lo = __ldg(accept_lo + state);
            hi = __ldg(accept_hi + state);
        }
    }
    out_lo[i] = lo;
    out_hi[i] = hi;
}

}  // namespace

CILIUM_API int cilium_dfa_pair_walk(
    const int32_t* pair, int q, const int32_t* accept_lo, const int32_t* accept_hi,
    const int32_t* starts, const void* bytes, int byte_size, int row_stride,
    int max_len, const int32_t* lengths, int32_t* out_lo, int32_t* out_hi,
    int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    if (byte_size != 1 && byte_size != 4) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const int64_t blocks = (b + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (byte_size == 1) {
        dfa_pair_walk_kernel<uint8_t><<<(unsigned)blocks, threads, 0, s>>>(
            pair, q, accept_lo, accept_hi, starts, (const uint8_t*)bytes,
            row_stride, max_len, lengths, out_lo, out_hi, b);
    } else {
        dfa_pair_walk_kernel<int32_t><<<(unsigned)blocks, threads, 0, s>>>(
            pair, q, accept_lo, accept_hi, starts, (const int32_t*)bytes,
            row_stride, max_len, lengths, out_lo, out_hi, b);
    }
    return (int)cudaGetLastError();
}
