// K7 dfa_walk: batched walk of a multi-pattern DFA, one byte per step.
//
// Replaces cilium_tpu/ops/dfa.py:104 dfa_match_batch (one scalar start,
// int32 bytes: the L7DeviceBatch-off path of every HTTP field) and
// :236 dfa_match_batch_fused (per-row starts into a stacked multi-field
// table, uint8 bytes: the L7DeviceBatch-on path when the fused table
// has no pair table, or has byte classes and rows of 16 bytes or more:
// ops/dfa.py l7_walk_route). One thread per row:
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
// the walk reaches are a few KB to a few hundred KB. What the kernel
// waits on is the chain of dependent steps, so the design keeps every
// read and every branch it can out of that chain (the route is the
// wrapper's: ops/dfa.py dfa_walk_route; the C entry refuses one its
// inputs do not allow):
//
// - Row bytes in 16-byte vectors (16 uint8 or 4 int32 bytes a load),
//   the next chunk in flight while the current one is walked from
//   registers, read only as far as min(length, max_len), when the row
//   stride in bytes and the base pointer are multiples of 16; any other
//   row is read one element a step.
// - The transitions from shared memory, with a sink state Q: every
//   entry outside [0, Q), and every byte outside [0, 255], leads to it,
//   and it leads only to itself, so a step is a multiply-add, one
//   shared-memory read and a select (a step past the row's end keeps
//   the state), with no branch in a chunk's steps, and a walk that ends
//   in Q gives mask 0. A chunk's columns are looked up before its
//   steps. A row of the class route read one element a step goes two
//   steps a pair with the sink in place of a bound check, 2-16% faster
//   than a step and a check a byte (tools/k8_probe.py); on 16-byte rows
//   two steps a pair gained nothing there or on the [Q + 1, 256] route.
//   * "shared": each block's prologue copies trans as uint16 [Q + 1,
//     256] rows (the sink row last) while the first row's length and
//     start are in flight; for Q <= SMEM_MAX_Q.
//   * "classes": the byte classes of an interned table (bytes whose
//     columns of trans are equal: ops/dfa.py class_table, built once
//     per DeviceDFATable as a uint16 [Q + 1, C] class table whose last
//     column and row lead to the sink, and a [256] class map), copied
//     by asynchronous 16-byte copies while the class map is read, then
//     clamped to the sink (an entry past Q or a class past the table
//     leads to it, so no step leaves the table), when (Q + 1) x C <=
//     SMEM_ENTRIES: a smaller copy, and a table that fits where the
//     [Q, 256] one does not (the pattern-cap policy's Q 735 has 43
//     classes; the bench corpus's is 2.9 KB: Q 59, 24 columns).
//   The grid is persistent and one block an SM where it can be, so a
//   table is copied once an SM, not once per 256 rows.
// - "l2": any other table is gathered through L1 / L2; a bad byte or
//   state clears ``alive`` and the walk goes on from state 0 to the
//   chunk's end, so no branch is in a chunk's steps there either.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int SMEM_MAX_Q = 400;  // ops/dfa.py DFA_SMEM_MAX_Q
// the shared-memory table's uint16 entries: the [Q + 1, 256] table up to
// Q = SMEM_MAX_Q, or a [Q + 1, C] class table as large (ops/dfa.py
// DFA_SMEM_ENTRIES); then the class map's 256 bytes
constexpr int SMEM_ENTRIES = (SMEM_MAX_Q + 1) * 256;
constexpr int SMEM_MAX_BYTES = SMEM_ENTRIES * 2 + 16 + 256;
enum Table { TAB_L2 = 0, TAB_SHARED = 1, TAB_CLASSES = 2 };  // ops/dfa.py WALK_TABLES
constexpr int MAX_THREADS = 1024;
constexpr int L2_THREADS = 256;

struct Walk {
    const int32_t* trans;         // [Q, 256]
    int q;
    const uint8_t* byte_class;    // TAB_CLASSES: [256] class of each byte
    const uint16_t* class_trans;  // TAB_CLASSES: [Q + 1, classes], sink row and column last
    int classes;                  // the class table's row width
    const int32_t* accept_lo;     // [Q]
    const int32_t* accept_hi;     // [Q]
    const int32_t* starts;        // [B * start_stride] or [1]
    int start_stride;
    const void* bytes;            // [B, row_stride] uint8 or int32
    int row_stride, max_len;
    const int32_t* lengths;       // [B]
    int32_t* out_lo;
    int32_t* out_hi;
    int64_t b;
};

// The table column of a byte: itself or its class. A byte outside
// [0, 255] gets -1 (a shared_step to the sink), or the class table's
// last column, whose entries are all the sink.
template <int TAB>
__device__ __forceinline__ int column(const Walk& p, const uint8_t* s_class, int byte) {
    if ((unsigned)byte > 255u) return TAB == TAB_CLASSES ? p.classes - 1 : -1;
    return TAB == TAB_CLASSES ? (int)s_class[byte] : byte;
}

// One step from a state in [0, Q] (Q the sink) on a shared table.
template <int TAB>
__device__ __forceinline__ int shared_step(const Walk& p, const uint16_t* s_trans, int state,
                                           int col) {
    if (TAB == TAB_CLASSES) return (int)s_trans[state * p.classes + col];
    return (int)s_trans[col < 0 ? p.q * 256 : state * 256 + col];
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One row's walk: the final state, or -1 once it met a byte outside
// [0, 255] or a state outside [0, Q).
template <typename ByteT, int TAB, bool VEC>
__device__ __forceinline__ int walk_row(const Walk& p, const uint16_t* s_trans,
                                        const uint8_t* s_class, int64_t i, int end, int state) {
    const ByteT* row = (const ByteT*)p.bytes + i * (int64_t)p.row_stride;
    const unsigned q = (unsigned)p.q;
    if (VEC) {
        constexpr int CH = 16 / sizeof(ByteT);
        const uint4* vrow = (const uint4*)row;
        const int chunks = (end + CH - 1) / CH;
        uint4 cur = chunks > 0 ? __ldg(vrow) : make_uint4(0, 0, 0, 0);
        bool alive = true;  // the L2 walk's: no sink state there
        for (int c = 0; c < chunks; ++c) {
            const uint4 nxt = c + 1 < chunks ? __ldg(vrow + c + 1) : cur;
            const int left = end - c * CH;
            // the chunk's columns first: none of them waits on the state
            int col[CH];
#pragma unroll
            for (int j = 0; j < CH; ++j)
                col[j] = column<TAB>(p, s_class, chunk_element<ByteT>(cur, j));
#pragma unroll
            for (int j = 0; j < CH; ++j) {
                const bool in = j < left;
                if (TAB == TAB_L2) {
                    const int nx = __ldg(p.trans + (int64_t)state * 256 + max(col[j], 0));
                    const bool ok = col[j] >= 0 && (unsigned)nx < q;
                    alive = alive && (ok || !in);
                    state = in ? (ok ? nx : 0) : state;
                } else {
                    const int nx = shared_step<TAB>(p, s_trans, state, col[j]);
                    state = in ? nx : state;
                }
            }
            if (TAB == TAB_L2 && !alive) return -1;
            cur = nxt;
        }
        return (unsigned)state < q ? state : -1;
    }
    if (TAB == TAB_CLASSES) {  // two steps a pair, the sink in place of a bound check
        for (int lvl = 0; lvl < end; lvl += 2) {
            state = shared_step<TAB>(p, s_trans, state,
                                     column<TAB>(p, s_class, (int)__ldg(row + lvl)));
            if (lvl + 1 < end)
                state = shared_step<TAB>(p, s_trans, state,
                                         column<TAB>(p, s_class, (int)__ldg(row + lvl + 1)));
        }
        return (unsigned)state < q ? state : -1;
    }
    for (int lvl = 0; lvl < end; ++lvl) {
        const int col = column<TAB>(p, s_class, (int)__ldg(row + lvl));
        if (TAB == TAB_L2) {
            if (col < 0) return -1;
            state = __ldg(p.trans + (int64_t)state * 256 + col);
        } else {
            state = shared_step<TAB>(p, s_trans, state, col);
        }
        if ((unsigned)state >= q) return -1;
    }
    return state;
}

template <typename ByteT, int TAB, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS) dfa_walk_kernel(Walk p) {
    extern __shared__ __align__(16) uint16_t s_trans[];
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    // the first row's length and start, in flight during the table copy
    int len = -1, start = -1;
    if (i < p.b) {
        len = __ldg(p.lengths + i);
        start = __ldg(p.starts + i * p.start_stride);
    }
    const uint8_t* s_class = nullptr;
    if (TAB == TAB_CLASSES) {
        const int n = (p.q + 1) * p.classes;
        uint8_t* cls = (uint8_t*)(s_trans + ((n + 7) & ~7));
        const uint32_t qq = (uint32_t)p.q * 0x10001u;  // Q in both halves of a word
        const bool async = ((uintptr_t)p.class_trans & 15) == 0 && n % 8 == 0;
        if (async) {
            const uint32_t base = (uint32_t)__cvta_generic_to_shared(s_trans);
            for (int e = threadIdx.x; e < n / 8; e += blockDim.x)
                cp_async16(base + 16u * e, (const uint4*)p.class_trans + e);
        } else {
            for (int e = threadIdx.x; e < n; e += blockDim.x)
                s_trans[e] = (uint16_t)min((int)p.class_trans[e], p.q);
        }
        // the class map while the copies are in flight, a class past
        // the table taken as the sink's column
        for (int e = threadIdx.x; e < 256; e += blockDim.x)
            cls[e] = (uint8_t)min((int)__ldg(p.byte_class + e), p.classes - 1);
        if (async) {
            // each thread clamps the entries it copied, once they landed
            cp_async_wait_all();
            for (int e = threadIdx.x; e < n / 8; e += blockDim.x) {
                uint4 v = ((uint4*)s_trans)[e];
                v.x = __vminu2(v.x, qq);
                v.y = __vminu2(v.y, qq);
                v.z = __vminu2(v.z, qq);
                v.w = __vminu2(v.w, qq);
                ((uint4*)s_trans)[e] = v;
            }
        }
        s_class = cls;
        __syncthreads();
    } else if (TAB == TAB_SHARED) {
        // [Q, 256] int32 -> uint16 rows, an entry outside [0, Q) as the
        // sink Q; then the sink's own row
        const unsigned q = (unsigned)p.q;
        const int n = p.q * 256;
        if (((uintptr_t)p.trans & 15) == 0) {
            uint2* dst = (uint2*)s_trans;
#pragma unroll 8
            for (int e = threadIdx.x; e < n / 4; e += blockDim.x) {
                const int4 v = __ldg((const int4*)p.trans + e);
                const unsigned a = (unsigned)v.x < q ? (unsigned)v.x : q;
                const unsigned b = (unsigned)v.y < q ? (unsigned)v.y : q;
                const unsigned c = (unsigned)v.z < q ? (unsigned)v.z : q;
                const unsigned d = (unsigned)v.w < q ? (unsigned)v.w : q;
                dst[e] = make_uint2(a | (b << 16), c | (d << 16));
            }
        } else {
            for (int e = threadIdx.x; e < n; e += blockDim.x) {
                const unsigned v = (unsigned)__ldg(p.trans + e);
                s_trans[e] = (uint16_t)(v < q ? v : q);
            }
        }
        for (int e = threadIdx.x; e < 256; e += blockDim.x) s_trans[n + e] = (uint16_t)q;
        __syncthreads();
    }
    for (; i < p.b; i += step) {
        const int len_i = len, start_i = start;
        const int64_t nx = i + step;
        if (nx < p.b) {  // the next row's, in flight during this walk
            len = __ldg(p.lengths + nx);
            start = __ldg(p.starts + nx * p.start_stride);
        }
        int lo = 0, hi = 0;
        if (len_i >= 0 && (unsigned)start_i < (unsigned)p.q) {
            const int state = walk_row<ByteT, TAB, VEC>(p, s_trans, s_class, i,
                                                        min(len_i, p.max_len), start_i);
            if (state >= 0) {
                lo = __ldg(p.accept_lo + state);
                hi = __ldg(p.accept_hi + state);
            }
        }
        p.out_lo[i] = lo;
        p.out_hi[i] = hi;
    }
}

template <typename ByteT, int TAB, bool VEC>
int launch(Walk& p, int device, cudaStream_t stream) {
    auto kern = dfa_walk_kernel<ByteT, TAB, VEC>;
    const void* k = (const void*)kern;
    const bool smem_table = TAB != TAB_L2;
    const int entries = (p.q + 1) * (TAB == TAB_CLASSES ? p.classes : 256);
    const size_t smem = TAB == TAB_L2 ? 0
                      : TAB == TAB_SHARED ? (size_t)entries * 2
                                          : (size_t)((entries + 7) & ~7) * 2 + 256;
    int sms = 0, per_sm = 0;
    int err = launch_fit::sm_count(k, smem_table ? SMEM_MAX_BYTES : 0, device, sms);
    if (err) return err;
    // a shared table is copied once a block: one block an SM covers the
    // batch where it can (blocks of 256 to 1 024); the L2 walk takes
    // blocks of 256
    int threads = L2_THREADS;
    if (smem_table) {
        const int64_t per = (p.b + sms - 1) / sms;
        threads = 256;
        while (threads < MAX_THREADS && threads < per) threads *= 2;
    }
    err = launch_fit::blocks_per_sm(k, device, threads, smem, per_sm);
    if (err) return err;
    const int64_t blocks = std::min<int64_t>((p.b + threads - 1) / threads,
                                             (int64_t)sms * std::max(per_sm, 1));
    kern<<<(unsigned)blocks, threads, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename ByteT>
int pick(Walk& p, int table, int vec_bytes, int device, cudaStream_t s) {
    switch (table) {
        case TAB_SHARED:
            return vec_bytes ? launch<ByteT, TAB_SHARED, true>(p, device, s)
                             : launch<ByteT, TAB_SHARED, false>(p, device, s);
        case TAB_CLASSES:
            return vec_bytes ? launch<ByteT, TAB_CLASSES, true>(p, device, s)
                             : launch<ByteT, TAB_CLASSES, false>(p, device, s);
        default:
            return vec_bytes ? launch<ByteT, TAB_L2, true>(p, device, s)
                             : launch<ByteT, TAB_L2, false>(p, device, s);
    }
}

}  // namespace

// table and vec_bytes are the wrapper's route (ops/dfa.py
// dfa_walk_route: table 0 L2, 1 shared, 2 classes, which walks
// ``class_trans`` [Q + 1, classes] through ``byte_class`` [256]); a
// route the inputs do not allow is refused.
CILIUM_API int cilium_dfa_walk(
    const int32_t* trans, int q, const int32_t* accept_lo, const int32_t* accept_hi,
    const int32_t* starts, int start_stride, const void* bytes, int byte_size,
    int row_stride, int max_len, const int32_t* lengths, int32_t* out_lo,
    int32_t* out_hi, int64_t b, int table, int vec_bytes, const uint8_t* byte_class,
    const uint16_t* class_trans, int classes, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    // report this launch's error, not one an earlier runtime call left
    (void)cudaGetLastError();
    if (byte_size != 1 && byte_size != 4) return (int)cudaErrorInvalidValue;
    if (table == TAB_SHARED && (q < 1 || q > SMEM_MAX_Q)) return (int)cudaErrorInvalidValue;
    if (table == TAB_CLASSES && (byte_class == nullptr || class_trans == nullptr || classes < 2 ||
                                 classes > 256 || q < 1 ||
                                 (int64_t)(q + 1) * classes > SMEM_ENTRIES))
        return (int)cudaErrorInvalidValue;
    if (table < TAB_L2 || table > TAB_CLASSES) return (int)cudaErrorInvalidValue;
    if (vec_bytes && (((int64_t)row_stride * byte_size) % 16 != 0 || (uintptr_t)bytes % 16 != 0))
        return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    Walk p{trans, q, byte_class, class_trans, classes, accept_lo, accept_hi, starts,
           start_stride, bytes, row_stride, max_len, lengths, out_lo, out_hi, b};
    cudaStream_t s = (cudaStream_t)stream;
    return byte_size == 1 ? pick<uint8_t>(p, table, vec_bytes, device, s)
                          : pick<int32_t>(p, table, vec_bytes, device, s);
}
