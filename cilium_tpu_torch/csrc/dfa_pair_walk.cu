// K8 dfa_pair_walk: batched walk of a multi-pattern DFA, two bytes per
// step over the stride-2 pair table.
//
// Replaces cilium_tpu/ops/dfa.py:264 dfa_match_batch_pair (the
// L7DeviceBatch-on path of a fused table small enough to carry a pair
// table: F * q_pad * 257^2 <= 2^23 int32, so Q <= 126; the port takes it
// for rows under 16 bytes, or for a table without byte classes, and
// K7's class walk for the rest: ops/dfa.py l7_walk_route). One thread
// per row:
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
// its length and start, and writes 8 bytes of mask. The pair table is
// up to 32 MiB and a walk reaches few of its entries (L1 / L2 hold
// them), so what the kernel waits on is its chain of dependent gathers,
// half as long as the single-byte walk's. The design (the bytes route is
// the wrapper's: ops/dfa.py dfa_pair_walk_route; the C entry refuses one
// its inputs do not allow):
//
// - A persistent grid of 256-thread blocks; each thread walks rows i,
//   i + grid, ..., the next row's length and start in flight during a
//   walk.
// - "vector": row bytes in 16-byte vectors (16 uint8 or 4 int32 bytes:
//   whole pairs), the next chunk in flight while the current one is
//   walked from registers, read only as far as min(length, max_len),
//   when the row stride in bytes and the base pointer are multiples of
//   16. A chunk's pair columns are computed before its gathers, and a
//   bad byte or state clears `alive` and the walk goes on from state 0
//   to the chunk's end, so no branch is in a chunk's steps. "scalar":
//   any other row, read one element a step.
//
// A walk of K7's [Q + 1, C] class table from shared memory beats the
// pair table from 16-byte rows up (tools/k8_probe.py); that walk is K7's
// class route (csrc/dfa_walk.cu), not a second copy here. The pair
// table's own classes ([Q + 1, C0, C1], one read a pair:
// tools/k8_pair_classes.cu) were slower than both.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int PAIR_ALPHA = 257;  // ops/dfa.py PAIR_ALPHA
constexpr int PAIR_PAD = 256;    // ops/dfa.py PAIR_PAD
constexpr int THREADS = 256;

struct Walk {
    const int32_t* pair;       // [Q, 257 * 257]
    int q;
    const int32_t* accept_lo;  // [Q]
    const int32_t* accept_hi;  // [Q]
    const int32_t* starts;     // [B]
    const void* bytes;         // [B, row_stride] uint8 or int32
    int row_stride, max_len;
    const int32_t* lengths;    // [B]
    int32_t* out_lo;
    int32_t* out_hi;
    int64_t b;
};

// A byte outside [0, 255]: an int32 row's only
template <typename ByteT>
__device__ __forceinline__ bool outside(int byte) {
    return sizeof(ByteT) > 1 && (unsigned)byte > 255u;
}

// One row's walk on the pair table: the final state, or -1 once it met
// a byte outside [0, 255] or a state outside [0, Q).
template <typename ByteT, bool VEC>
__device__ __forceinline__ int walk_row(const Walk& p, int64_t i, int end, int state) {
    const ByteT* row = (const ByteT*)p.bytes + i * (int64_t)p.row_stride;
    const unsigned q = (unsigned)p.q;
    constexpr int64_t ROW = (int64_t)PAIR_ALPHA * PAIR_ALPHA;
    if (VEC) {
        constexpr int CH = 16 / sizeof(ByteT);
        const uint4* vrow = (const uint4*)row;
        const int chunks = (end + CH - 1) / CH;
        uint4 cur = chunks > 0 ? __ldg(vrow) : make_uint4(0, 0, 0, 0);
        bool alive = true;
        for (int c = 0; c < chunks; ++c) {
            const uint4 nxt = c + 1 < chunks ? __ldg(vrow + c + 1) : cur;
            const int left = end - c * CH;
            int col[CH / 2];  // the pair's column of a state's row, -1 for a bad byte
#pragma unroll
            for (int k = 0; k < CH / 2; ++k) {
                const int b0 = chunk_element<ByteT>(cur, 2 * k);
                const bool in1 = 2 * k + 1 < left;
                const int b1 = in1 ? chunk_element<ByteT>(cur, 2 * k + 1) : PAIR_PAD;
                const bool bad = outside<ByteT>(b0) || (in1 && outside<ByteT>(b1));
                col[k] = bad ? -1 : b0 * PAIR_ALPHA + b1;
            }
#pragma unroll
            for (int k = 0; k < CH / 2; ++k) {
                const bool in = 2 * k < left;
                const int nx = __ldg(p.pair + (int64_t)state * ROW + max(col[k], 0));
                const bool ok = col[k] >= 0 && (unsigned)nx < q;
                alive = alive && (ok || !in);
                state = in ? (ok ? nx : 0) : state;
            }
            if (!alive) return -1;
            cur = nxt;
        }
        return state;
    }
    for (int lvl = 0; lvl < end; lvl += 2) {
        const int b0 = (int)__ldg(row + lvl);
        const bool in1 = lvl + 1 < end;
        const int b1 = in1 ? (int)__ldg(row + lvl + 1) : PAIR_PAD;
        if (outside<ByteT>(b0) || (in1 && outside<ByteT>(b1))) return -1;
        state = __ldg(p.pair + (int64_t)state * ROW + b0 * PAIR_ALPHA + b1);
        if ((unsigned)state >= q) return -1;
    }
    return state;
}

template <typename ByteT, bool VEC>
__global__ void __launch_bounds__(THREADS) dfa_pair_walk_kernel(Walk p) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int len = -1, start = -1;
    if (i < p.b) {
        len = __ldg(p.lengths + i);
        start = __ldg(p.starts + i);
    }
    for (; i < p.b; i += step) {
        const int len_i = len, start_i = start;
        const int64_t nx = i + step;
        if (nx < p.b) {  // the next row's, in flight during this walk
            len = __ldg(p.lengths + nx);
            start = __ldg(p.starts + nx);
        }
        int lo = 0, hi = 0;
        if (len_i >= 0 && (unsigned)start_i < (unsigned)p.q) {
            const int state = walk_row<ByteT, VEC>(p, i, min(len_i, p.max_len), start_i);
            if (state >= 0) {
                lo = __ldg(p.accept_lo + state);
                hi = __ldg(p.accept_hi + state);
            }
        }
        p.out_lo[i] = lo;
        p.out_hi[i] = hi;
    }
}

template <typename ByteT, bool VEC>
int launch(Walk& p, int device, cudaStream_t stream) {
    auto kern = dfa_pair_walk_kernel<ByteT, VEC>;
    const void* k = (const void*)kern;
    int sms = 0, per_sm = 0;
    int err = launch_fit::sm_count(k, 0, device, sms);
    if (err) return err;
    err = launch_fit::blocks_per_sm(k, device, THREADS, 0, per_sm);
    if (err) return err;
    const int64_t blocks = std::min<int64_t>((p.b + THREADS - 1) / THREADS,
                                             (int64_t)sms * std::max(per_sm, 1));
    kern<<<(unsigned)blocks, THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename ByteT>
int pick(Walk& p, int vec_bytes, int device, cudaStream_t s) {
    return vec_bytes ? launch<ByteT, true>(p, device, s) : launch<ByteT, false>(p, device, s);
}

}  // namespace

// vec_bytes is the wrapper's route (ops/dfa.py dfa_pair_walk_route: 1
// "vector", 0 "scalar"); a route the inputs do not allow is refused.
CILIUM_API int cilium_dfa_pair_walk(
    const int32_t* pair, int q, const int32_t* accept_lo, const int32_t* accept_hi,
    const int32_t* starts, const void* bytes, int byte_size, int row_stride,
    int max_len, const int32_t* lengths, int32_t* out_lo, int32_t* out_hi,
    int64_t b, int vec_bytes, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    // report this launch's error, not one an earlier runtime call left
    (void)cudaGetLastError();
    if (byte_size != 1 && byte_size != 4) return (int)cudaErrorInvalidValue;
    if (vec_bytes && (((int64_t)row_stride * byte_size) % 16 != 0 || (uintptr_t)bytes % 16 != 0))
        return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    Walk p{pair, q, accept_lo, accept_hi, starts, bytes, row_stride, max_len, lengths,
           out_lo, out_hi, b};
    cudaStream_t s = (cudaStream_t)stream;
    return byte_size == 1 ? pick<uint8_t>(p, vec_bytes, device, s)
                          : pick<int32_t>(p, vec_bytes, device, s);
}
