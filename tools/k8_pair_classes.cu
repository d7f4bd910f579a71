// K8 dfa_pair_walk on a pair-class table, tried and not kept: kept for
// tools/k8_probe.py, which builds it with the pair-class form of
// tools/k8_probe.py pair_class_table and times it against the kernel in
// cilium_tpu_torch/csrc/dfa_pair_walk.cu and against K7's class route
// (cilium_tpu_torch/csrc/dfa_walk.cu: the [Q + 1, C] class table two
// dependent reads a pair, faster on every shape the probe measures).
//
// The pair table's own classes: bytes whose first-position slices
// pair[:, a, :] are equal share a first class, bytes and the pad whose
// second-position slices pair[:, :256, b] are equal share a second, and
// a uint16 [Q + 1, C0, C1] table holds the pair table's entry for each
// state and class pair, exactly, with a sink state Q and a reserved
// last column on each axis (a byte outside [0, 255]). The bench corpus's
// 15.6 MB pair table (Q 59, 18 x 19 classes) is a 69 KB one. One pair
// step is one shared-memory read:
//
//   state = tab[state * stride + first[b0] * C1 + second[b1 or pad]]
//
// on K8's persistent grid and 16-byte row reads. Each block copies the
// table into shared memory by asynchronous copies; a row of C0 x C1
// entries is a multiple of 64 entries (32 banks) when C0 and C1 are
// multiples of 8, so states of one column would share a bank: with
// PAD_ROWS the rows are laid out one word apart (4-byte copies), and
// every entry past Q is clamped to it once copied.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int PAIR_ALPHA = 257;
constexpr int PAIR_PAD = 256;
// the pair-class table's uint16 entries in shared memory, K7's budget
// (ops/dfa.py DFA_SMEM_ENTRIES), then the two class maps as uint16
constexpr int SMEM_ENTRIES = 102656;
constexpr int MAP_ENTRIES = 256 + 264;
// rows padded by one word when they are a multiple of 64 entries
constexpr bool PAD_ROWS = true;
constexpr int SMEM_MAX_BYTES = SMEM_ENTRIES * 2 + (SMEM_ENTRIES / 64) * 4 + 16 + MAP_ENTRIES * 2;
// table routes: the pair table through L2 (as the kernel's), the
// pair-class table
constexpr int TAB_L2 = 0;
constexpr int TAB_CLASSES = 1;
constexpr int MAX_THREADS = 1024;
constexpr int L2_THREADS = 256;

struct Walk {
    const int32_t* pair;        // [Q, 257 * 257]
    int q;
    const uint8_t* class0;      // TAB_CLASSES: [256] first class of each byte
    const uint8_t* class1;      // TAB_CLASSES: [257] second class of each byte and the pad
    const uint16_t* pair_cls;   // TAB_CLASSES: [Q + 1, c0, c1], sink row and columns last
    int c0, c1;
    const int32_t* accept_lo;   // [Q]
    const int32_t* accept_hi;   // [Q]
    const int32_t* starts;      // [B]
    const void* bytes;          // [B, row_stride] uint8 or int32
    int row_stride, max_len;
    const int32_t* lengths;     // [B]
    int32_t* out_lo;
    int32_t* out_hi;
    int64_t b;
};

// A block's pair-class table in shared memory.
struct Classes {
    const uint16_t* tab;   // [(Q + 1) * stride]
    const uint16_t* col0;  // [256]: a byte's first class times c1
    const uint16_t* col1;  // [257]: a byte's (and the pad's) second class
    int stride;            // a state's row in shared memory: c0 * c1, + 2 padded
    int bad0, bad1;        // the reserved last class of each axis
    int pad1;              // the pad's second class
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__host__ __device__ __forceinline__ int padded(int s) {
    return PAD_ROWS && s % 64 == 0 ? s + 2 : s;
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A byte outside [0, 255]: an int32 row's only
template <typename ByteT>
__device__ __forceinline__ bool outside(int byte) {
    return sizeof(ByteT) > 1 && (unsigned)byte > 255u;
}

// The pair column of bytes (b0, b1), b1 the pad unless in1.
template <typename ByteT>
__device__ __forceinline__ int pair_column(const Classes& s, int b0, int b1, bool in1) {
    const int x = outside<ByteT>(b0) ? s.bad0 : (int)s.col0[b0];
    const int y = !in1 ? s.pad1 : outside<ByteT>(b1) ? s.bad1 : (int)s.col1[b1];
    return x + y;
}

// One row's walk on the pair-class table: the final state, or -1 when
// it is the sink.
template <typename ByteT, bool VEC>
__device__ __forceinline__ int walk_classes(const Walk& p, const Classes& s, int64_t i, int end,
                                            int state) {
    const ByteT* row = (const ByteT*)p.bytes + i * (int64_t)p.row_stride;
    if (VEC) {
        constexpr int CH = 16 / sizeof(ByteT);
        const uint4* vrow = (const uint4*)row;
        const int chunks = (end + CH - 1) / CH;
        uint4 cur = chunks > 0 ? __ldg(vrow) : make_uint4(0, 0, 0, 0);
        for (int c = 0; c < chunks; ++c) {
            const uint4 nxt = c + 1 < chunks ? __ldg(vrow + c + 1) : cur;
            const int left = end - c * CH;
            // the chunk's pair columns first: none of them waits on the state
            int col[CH / 2];
#pragma unroll
            for (int k = 0; k < CH / 2; ++k)
                col[k] = pair_column<ByteT>(s, chunk_element<ByteT>(cur, 2 * k),
                                            chunk_element<ByteT>(cur, 2 * k + 1), 2 * k + 1 < left);
#pragma unroll
            for (int k = 0; k < CH / 2; ++k) {
                const int nx = (int)s.tab[state * s.stride + col[k]];
                state = 2 * k < left ? nx : state;
            }
            cur = nxt;
        }
    } else {
        for (int lvl = 0; lvl < end; lvl += 2) {
            const bool in1 = lvl + 1 < end;
            const int b1 = in1 ? (int)__ldg(row + lvl + 1) : PAIR_PAD;
            const int col = pair_column<ByteT>(s, (int)__ldg(row + lvl), b1, in1);
            state = (int)s.tab[state * s.stride + col];
        }
    }
    return state < p.q ? state : -1;
}

// One row's walk on the pair table through L1 / L2: the final state,
// or -1 once it met a byte outside [0, 255] or a state outside [0, Q).
template <typename ByteT, bool VEC>
__device__ __forceinline__ int walk_l2(const Walk& p, int64_t i, int end, int state) {
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

template <typename ByteT, int TAB, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS) dfa_pair_walk_kernel(Walk p) {
    extern __shared__ __align__(16) uint16_t smem[];
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    // the first row's length and start, in flight during the table copy
    int len = -1, start = -1;
    if (i < p.b) {
        len = __ldg(p.lengths + i);
        start = __ldg(p.starts + i);
    }
    Classes s{};
    if (TAB == TAB_CLASSES) {
        const int row = p.c0 * p.c1;
        s.stride = padded(row);
        const int n = (p.q + 1) * s.stride;
        const int n_pad = (n + 7) & ~7;
        uint16_t* col0 = smem + n_pad;
        uint16_t* col1 = col0 + 256;
        const uint32_t qq = (uint32_t)p.q * 0x10001u;  // Q in both halves of a word
        const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
        const bool pad = s.stride != row;  // then row % 64 == 0: whole words
        const bool async = pad ? ((uintptr_t)p.pair_cls & 3) == 0
                               : ((uintptr_t)p.pair_cls & 15) == 0 && n % 8 == 0;
        const int half = row / 2, words = (p.q + 1) * half;
        if (async && pad) {
            for (int w = threadIdx.x; w < words; w += blockDim.x) {
                const int r = w / half;
                cp_async4(base + 4u * (r * (half + 1) + (w - r * half)),
                          (const uint32_t*)p.pair_cls + w);
            }
        } else if (async) {
            for (int e = threadIdx.x; e < n / 8; e += blockDim.x)
                cp_async16(base + 16u * e, (const uint4*)p.pair_cls + e);
        } else {
            for (int e = threadIdx.x; e < (p.q + 1) * row; e += blockDim.x)
                smem[e / row * s.stride + e % row] = (uint16_t)min((int)p.pair_cls[e], p.q);
        }
        // the class maps while the copies are in flight, each class
        // past its axis taken as the reserved one
        for (int e = threadIdx.x; e < 256; e += blockDim.x)
            col0[e] = (uint16_t)(min((int)__ldg(p.class0 + e), p.c0 - 1) * p.c1);
        for (int e = threadIdx.x; e < PAIR_ALPHA; e += blockDim.x)
            col1[e] = (uint16_t)min((int)__ldg(p.class1 + e), p.c1 - 1);
        if (async) {
            // each thread clamps the entries it copied, once they landed
            cp_async_wait_all();
            uint32_t* sw = (uint32_t*)smem;
            if (pad) {
                for (int w = threadIdx.x; w < words; w += blockDim.x) {
                    const int r = w / half;
                    const int d = r * (half + 1) + (w - r * half);
                    sw[d] = __vminu2(sw[d], qq);
                }
            } else {
                for (int e = threadIdx.x; e < n / 8; e += blockDim.x) {
                    uint4 v = ((uint4*)smem)[e];
                    v.x = __vminu2(v.x, qq);
                    v.y = __vminu2(v.y, qq);
                    v.z = __vminu2(v.z, qq);
                    v.w = __vminu2(v.w, qq);
                    ((uint4*)smem)[e] = v;
                }
            }
        }
        __syncthreads();
        s.tab = smem;
        s.col0 = col0;
        s.col1 = col1;
        s.bad0 = (p.c0 - 1) * p.c1;
        s.bad1 = p.c1 - 1;
        s.pad1 = col1[PAIR_PAD];
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
            const int end = min(len_i, p.max_len);
            const int state = TAB == TAB_CLASSES ? walk_classes<ByteT, VEC>(p, s, i, end, start_i)
                                                 : walk_l2<ByteT, VEC>(p, i, end, start_i);
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
    auto kern = dfa_pair_walk_kernel<ByteT, TAB, VEC>;
    const void* k = (const void*)kern;
    const size_t smem = TAB == TAB_L2
        ? 0 : (size_t)((((p.q + 1) * padded(p.c0 * p.c1)) + 7) & ~7) * 2 + MAP_ENTRIES * 2;
    int sms = 0, per_sm = 0;
    int err = launch_fit::sm_count(k, TAB == TAB_L2 ? 0 : SMEM_MAX_BYTES, device, sms);
    if (err) return err;
    // a shared table is copied once a block: one block an SM covers the
    // batch where it can (blocks of 256 to 1 024); the L2 walk takes
    // blocks of 256
    int threads = L2_THREADS;
    if (TAB == TAB_CLASSES) {
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
    if (table == TAB_CLASSES)
        return vec_bytes ? launch<ByteT, TAB_CLASSES, true>(p, device, s)
                         : launch<ByteT, TAB_CLASSES, false>(p, device, s);
    return vec_bytes ? launch<ByteT, TAB_L2, true>(p, device, s)
                     : launch<ByteT, TAB_L2, false>(p, device, s);
}

}  // namespace

// table 0 walks the pair table through L2, 1 walks ``pair_cls`` [Q + 1,
// c0, c1] through ``class0`` [256] and ``class1`` [257]; a route the
// inputs do not allow is refused.
CILIUM_API int cilium_dfa_pair_walk(
    const int32_t* pair, int q, const int32_t* accept_lo, const int32_t* accept_hi,
    const int32_t* starts, const void* bytes, int byte_size, int row_stride,
    int max_len, const int32_t* lengths, int32_t* out_lo, int32_t* out_hi,
    int64_t b, int table, int vec_bytes, const uint8_t* class0, const uint8_t* class1,
    const uint16_t* pair_cls, int c0, int c1, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    // report this launch's error, not one an earlier runtime call left
    (void)cudaGetLastError();
    if (byte_size != 1 && byte_size != 4) return (int)cudaErrorInvalidValue;
    if (table != TAB_L2 && table != TAB_CLASSES) return (int)cudaErrorInvalidValue;
    if (table == TAB_CLASSES &&
        (class0 == nullptr || class1 == nullptr || pair_cls == nullptr || c0 < 2 || c0 > 256 ||
         c1 < 2 || c1 > 256 || q < 1 || (int64_t)(q + 1) * c0 * c1 > SMEM_ENTRIES))
        return (int)cudaErrorInvalidValue;
    if (vec_bytes && (((int64_t)row_stride * byte_size) % 16 != 0 || (uintptr_t)bytes % 16 != 0))
        return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    Walk p{pair, q, class0, class1, pair_cls, c0, c1, accept_lo, accept_hi, starts,
           bytes, row_stride, max_len, lengths, out_lo, out_hi, b};
    cudaStream_t s = (cudaStream_t)stream;
    return byte_size == 1 ? pick<uint8_t>(p, table, vec_bytes, device, s)
                          : pick<int32_t>(p, table, vec_bytes, device, s);
}
