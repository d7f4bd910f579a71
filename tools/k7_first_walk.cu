// K7 dfa_walk: batched walk of a multi-pattern DFA, one byte per step.
//
// Replaces cilium_tpu/ops/dfa.py:104 dfa_match_batch (one scalar start,
// int32 bytes: the L7DeviceBatch-off path of every HTTP field) and
// :236 dfa_match_batch_fused (per-row starts into a stacked multi-field
// table, uint8 bytes: the L7DeviceBatch-on path when the fused table
// has no pair table). One thread per row:
//
//   state = starts[i * start_stride]        (stride 0: one scalar start)
//   for lvl in 0 .. min(length, max_len) - 1:
//       state = trans[state * 256 + bytes[i, lvl]]
//   out = (accept_lo[state], accept_hi[state]), or 0 for length < 0
//
// The byte type (uint8 or int32) is a template parameter; the wrapper
// picks the entry. A byte outside [0, 255] or a state outside [0, Q)
// ends the walk with mask 0, so no read leaves the tables (the JAX walk
// fills or lands in another state's row there; every table
// compile_patterns / fuse_dfas builds stays inside [0, Q)).
//
// Bound: bytes. Each row reads the min(length, max_len) bytes it walks,
// its length and start, and writes 8 bytes of mask; the table entries
// the walk reaches are a few KB to a few hundred KB and sit in L1/L2,
// read through the read-only cache. The chain of dependent gathers is
// what the kernel waits on; enough rows in flight hide it.
#include "common.cuh"

namespace {

template <typename ByteT>
__global__ void dfa_walk_kernel(
    const int32_t* __restrict__ trans,      // [Q, 256]
    int q,
    const int32_t* __restrict__ accept_lo,  // [Q]
    const int32_t* __restrict__ accept_hi,  // [Q]
    const int32_t* __restrict__ starts,     // [B * start_stride] or [1]
    int start_stride,
    const ByteT* __restrict__ bytes,        // [B, row_stride]
    int row_stride, int max_len,
    const int32_t* __restrict__ lengths,    // [B]
    int32_t* __restrict__ out_lo, int32_t* __restrict__ out_hi, int64_t b) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    const int len = __ldg(lengths + i);
    int state = __ldg(starts + i * start_stride);
    int lo = 0, hi = 0;
    if (len >= 0 && (unsigned)state < (unsigned)q) {
        const ByteT* row = bytes + i * (int64_t)row_stride;
        const int end = min(len, max_len);
        bool alive = true;
        for (int lvl = 0; lvl < end; ++lvl) {
            const int byte = (int)__ldg(row + lvl);
            if ((unsigned)byte > 255u) { alive = false; break; }
            state = __ldg(trans + (int64_t)state * 256 + byte);
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

CILIUM_API int cilium_dfa_walk(
    const int32_t* trans, int q, const int32_t* accept_lo, const int32_t* accept_hi,
    const int32_t* starts, int start_stride, const void* bytes, int byte_size,
    int row_stride, int max_len, const int32_t* lengths, int32_t* out_lo,
    int32_t* out_hi, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    if (byte_size != 1 && byte_size != 4) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const int64_t blocks = (b + threads - 1) / threads;
    cudaStream_t s = (cudaStream_t)stream;
    if (byte_size == 1) {
        dfa_walk_kernel<uint8_t><<<(unsigned)blocks, threads, 0, s>>>(
            trans, q, accept_lo, accept_hi, starts, start_stride,
            (const uint8_t*)bytes, row_stride, max_len, lengths, out_lo, out_hi, b);
    } else {
        dfa_walk_kernel<int32_t><<<(unsigned)blocks, threads, 0, s>>>(
            trans, q, accept_lo, accept_hi, starts, start_stride,
            (const int32_t*)bytes, row_stride, max_len, lengths, out_lo, out_hi, b);
    }
    return (int)cudaGetLastError();
}
