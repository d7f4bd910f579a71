// K1 selector_match: packed sel_match[N, ceil(S/32)] from identity
// label words and selector conjunct masks.
//
// Replaces cilium_tpu/ops/bitmap.py:57 compute_selector_matches, whose
// TPU form unpacks the label words to int8 bit lanes and runs two
// [chunk, L] x [L, S*CPS] int8 products:
//
//   match = any_c valid[s,c] && popc(id & req[s,c]) == req_count[s,c]
//                            && (id & forbid[s,c]) == 0
//
// A selector names a handful of labels (compiler/selectors.py: one bit
// a required or forbidden label), so nearly every word of a conjunct
// is zero. The first version gave each lane one selector and read all
// W words of its conjuncts from device memory for every identity row,
// at a lane stride of CPS*W words: each load touched 32 sectors, ~89 M
// sector requests at [2048, 34] x [640, 1, 34], which was its time.
//
// Here a block takes SEL_ROWS identity rows (four warps, a lane a row)
// and one output word, 32 selectors:
// - the row tile is staged in shared memory with 16-byte loads, its
//   row stride padded to an odd word count, so the lane-per-row reads
//   below are free of bank conflicts (route "staged");
// - the block streams its selectors' conjunct words (one contiguous
//   span of [S, CPS, W]) into shared memory with asynchronous copies,
//   up to SEL_STAGE_MAX words a round, and each warp compacts a quarter
//   of the round, by a ballot over 32 words at a time, into a list of
//   its nonzero words in stream order: (word index, req word, forbid
//   word) and, on each conjunct's first entry, its selector bit and
//   req_count (-1 when invalid). Each conjunct's word 0 is kept, so
//   every conjunct has a first entry and one with no nonzero word
//   (req_count 0, no forbid) is judged like the rest;
// - every warp then walks the four lists for its 32 rows: the loop is
//   uniform across the warp (every lane reads the same 16-byte entry, a
//   broadcast), each lane ANDs its row's word, popcounts and ORs, and at
//   the next conjunct's first entry (or the end) sets the selector's bit
//   when popc == req_count and no forbidden bit is set, the bit order
//   of ops/bitmap.py pack_bool_bits.
// A block writes one word a row: its 128 rows lie S/32 words apart, so
// there is no row segment to gather through shared memory; the output
// is a quarter of the bytes and written once.
// A dense conjunct only makes a longer list: a list longer than a
// round continues in the next round, with the lane's partial counts
// carried over. Rows whose tile does not fit the shared-memory budget
// (large W) take route "wide": the same kernel reading each entry's
// word from the row in device memory (ops/bitmap.py
// selector_match_route; the C entry refuses a staged route past the
// budget).
//
// Tensor cores are not used: the TPU form's two int8 products do
// 2 * 32W * S * CPS operations per row whatever the selectors name,
// and unpacking the bits to int8 in shared memory costs more than the
// products at W = 34, where the lists hold one to three words a
// conjunct.
//
// Bound: the larger of the bytes it must move (inputs once, the
// [N, S/32] output once) and the popcounts over the conjuncts' nonzero
// words at the card's popc rate (chip_smoke.py).
#include "common.cuh"

namespace {

constexpr int SEL_ROWS = 128;            // ops/bitmap.py SEL_ROWS
constexpr int SEL_WARPS = 4;             // ops/bitmap.py SEL_WARPS
constexpr int SEL_STAGE_MAX = 2048;      // ops/bitmap.py SEL_STAGE_MAX
constexpr int SEL_SMEM_BUDGET = 232448;  // ops/bitmap.py SEL_SMEM_BUDGET
constexpr int SEL_MAX_DEVICES = 64;
constexpr int SEL_FIRST = 1 << 24;       // an entry's "first of its conjunct" flag

// Conjunct words a block stages a round: its whole stream (32
// selectors x CPS x W, rounded up to a piece of 32 for each warp) up to
// SEL_STAGE_MAX.
inline int sel_stage(int w, int cps) {
    constexpr int piece = 32 * SEL_WARPS;
    const int64_t t = ((int64_t)32 * cps * w + piece - 1) / piece * piece;
    return t < SEL_STAGE_MAX ? (int)t : SEL_STAGE_MAX;
}

// Shared memory of one block, in int32 words (ops/bitmap.py
// selector_match_smem_bytes / 4): a round's entries (4 words each), its
// req and forbid words, its conjuncts' req_count (a round of ``stage``
// words spans at most stage + 1 conjuncts), the warps' entry counts,
// and the row tile when staged.
inline int64_t sel_smem_words(int w, int cps, bool staged) {
    const int stage = sel_stage(w, cps);
    return 7 * (int64_t)stage + 8 + (staged ? (int64_t)SEL_ROWS * (w | 1) : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool STAGED>
__global__ void __launch_bounds__(SEL_ROWS) selector_match_kernel(
    const int32_t* __restrict__ id_bits,      // [N, W]
    const int32_t* __restrict__ conj_req,     // [S, CPS, W]
    const int32_t* __restrict__ conj_forbid,  // [S, CPS, W]
    const uint8_t* __restrict__ conj_valid,   // [S, CPS]
    const int32_t* __restrict__ req_count,    // [S, CPS]
    int32_t* __restrict__ out,                // [N, S_words]
    int n, int w, int s, int cps, int s_words, int stage) {
    extern __shared__ __align__(16) int32_t smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row0 = blockIdx.x * SEL_ROWS;
    const int word = blockIdx.y;
    const int rows = min(SEL_ROWS, n - row0);
    const int wp = w | 1;
    int4* s_ent = reinterpret_cast<int4*>(smem);  // [stage]: meta, req, forbid, need
    uint32_t* s_req = reinterpret_cast<uint32_t*>(smem + 4 * stage);  // [stage]
    uint32_t* s_fb = s_req + stage;                                    // [stage]
    int32_t* s_need = reinterpret_cast<int32_t*>(s_fb + stage);        // [stage + 4]
    int32_t* s_cnt = s_need + stage + 4;                                // [SEL_WARPS]
    int32_t* s_rows = s_cnt + 4;                                        // [SEL_ROWS, wp]

    if (STAGED) {
        // rows [row0, row0 + rows) are one span of rows * W words: a word
        // a thread into the odd-strided tile by asynchronous copies,
        // coalesced and all in flight with the first round's conjunct
        // words ((r, c) advanced SEL_ROWS words a step, no division)
        const int32_t* src = id_bits + (int64_t)row0 * w;
        const int total = rows * w;
        const int dr = SEL_ROWS / w, dc = SEL_ROWS - dr * w;
        int r = threadIdx.x / w, c = threadIdx.x - r * w;
        for (int e = threadIdx.x; e < total; e += SEL_ROWS) {
            cp_async4(s_rows + r * wp + c, src + e);
            r += dr;
            c += dc;
            if (c >= w) c -= w, ++r;
        }
    }

    // this block's 32 selectors: conjuncts [sel0 * CPS, (sel0 + nsel) * CPS)
    const int sel0 = word * 32;
    const int nsel = min(32, s - sel0);
    const int total = nsel * cps * w;  // < 32 * 1024 * 65536 = 2^31: the C entry's limits
    const int64_t cbase = (int64_t)sel0 * cps;
    const int32_t* req_src = conj_req + cbase * w;
    const int32_t* fb_src = conj_forbid + cbase * w;
    const bool vec = ((reinterpret_cast<uintptr_t>(conj_req) |
                       reinterpret_cast<uintptr_t>(conj_forbid)) & 15) == 0;
    const int my = min(row0 + threadIdx.x, n - 1);  // a lane past N computes a row it never writes
    const uint32_t* row = STAGED ? reinterpret_cast<const uint32_t*>(s_rows) + threadIdx.x * wp
                                 : reinterpret_cast<const uint32_t*>(id_bits) + (int64_t)my * w;
    const int quarter = stage / SEL_WARPS;  // a multiple of 32
    const int dj = 32 / w, dk = 32 - dj * w;
    const float inv_cps = 1.0f / (float)max(cps, 1);
    uint32_t bits = 0, bad = 0;
    int hit = 0, need = -1, sbit = 0;
    for (int p0 = 0; p0 < total; p0 += stage) {
        const int len = min(stage, total - p0);
        // stage the round's words (p0 is a multiple of 128, the span's
        // start of 4 words: every quad of an aligned array is aligned)
        int done = 0;
        if (vec) {
            const int quads = len / 4;
            for (int qd = threadIdx.x; qd < quads; qd += blockDim.x) {
                cp_async16(s_req + 4 * qd, req_src + p0 + 4 * qd);
                cp_async16(s_fb + 4 * qd, fb_src + p0 + 4 * qd);
            }
            done = quads * 4;
        }
        for (int i = done + threadIdx.x; i < len; i += blockDim.x) {
            cp_async4(s_req + i, req_src + p0 + i);
            cp_async4(s_fb + i, fb_src + p0 + i);
        }
        const int j0 = p0 / w;
        const int nj = (p0 + len - 1) / w - j0 + 1;
        for (int k = threadIdx.x; k < nj; k += blockDim.x) {
            const int64_t gj = cbase + j0 + k;
            const int rc = __ldg(req_count + gj);
            s_need[k] = conj_valid[gj] ? rc : -1;
        }
        cp_async_wait_all();
        __syncthreads();
        // each warp compacts its quarter of the round into its own part
        // of the entries, in stream order; the lane's position p0 + i is
        // (conjunct j, word k), advanced 32 words a piece
        const int lo = warp * quarter;
        const int hi = min(lo + quarter, len);
        int j = (p0 + lo + lane) / w;
        int k = p0 + lo + lane - j * w;
        int cnt = 0;
        for (int b0 = lo; b0 < hi; b0 += 32) {
            const int i = b0 + lane;
            int4 en = make_int4(0, 0, 0, 0);
            bool keep = false;
            if (i < hi) {
                en.y = (int)s_req[i];
                en.z = (int)s_fb[i];
                keep = (en.y | en.z) != 0 || k == 0;
                // j / CPS exactly: j < 2^15, so (j + 0.5) / CPS stays
                // 0.5 / CPS clear of an integer, far above float error
                const int sel = (int)(((float)j + 0.5f) * inv_cps);
                en.x = k | sel << 16 | (k == 0 ? SEL_FIRST : 0);
                en.w = k == 0 ? s_need[j - j0] : 0;
            }
            const unsigned mask = __ballot_sync(0xffffffffu, keep);
            if (keep) s_ent[lo + cnt + __popc(mask & ((1u << lane) - 1u))] = en;
            cnt += __popc(mask);
            j += dj;
            k += dk;
            if (k >= w) k -= w, ++j;
        }
        if (lane == 0) s_cnt[warp] = cnt;
        __syncthreads();
        // walk the four lists: every lane the same entry
        for (int q = 0; q < SEL_WARPS; ++q) {
            const int4* ent = s_ent + q * quarter;
            const int m = s_cnt[q];
#pragma unroll 4
            for (int e = 0; e < m; ++e) {
                const int4 en = ent[e];
                // a conjunct's first entry closes the previous one: no
                // branch, so the unrolled entries' reads overlap
                const bool first = (en.x & SEL_FIRST) != 0;
                bits |= (uint32_t)(first & (hit == need) & (bad == 0)) << sbit;
                hit = first ? 0 : hit;
                bad = first ? 0u : bad;
                need = first ? en.w : need;
                sbit = first ? (en.x >> 16) & 31 : sbit;
                const uint32_t iw = STAGED ? row[en.x & 0xFFFF] : __ldg(row + (en.x & 0xFFFF));
                hit += __popc(iw & (uint32_t)en.y);
                bad |= iw & (uint32_t)en.z;
            }
        }
        __syncthreads();  // the next round overwrites the words and lists
    }
    cp_async_wait_all();  // the row tile's copies when no round ran
    if (hit == need && bad == 0) bits |= 1u << sbit;
    if ((int)threadIdx.x < rows) out[(int64_t)(row0 + threadIdx.x) * s_words + word] = (int32_t)bits;
}

}  // namespace

CILIUM_API int cilium_selector_match(
    const int32_t* id_bits, const int32_t* conj_req,
    const int32_t* conj_forbid, const uint8_t* conj_valid,
    const int32_t* req_count, int32_t* out, int n, int w, int s, int cps,
    int staged, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    // report this launch's error, not one an earlier runtime call left
    (void)cudaGetLastError();
    // an entry packs (word | selector bit << 16): ops/bitmap.py selector_match_route
    if (w < 1 || w > 65535 || cps < 0 || cps > 1023) return (int)cudaErrorInvalidValue;
    const int64_t bytes = 4 * sel_smem_words(w, cps, staged != 0);
    if (bytes > SEL_SMEM_BUDGET) return (int)cudaErrorInvalidValue;
    const int s_words = (s + 31) / 32;
    if (n == 0 || s_words == 0) return 0;
    if (device < 0 || device >= SEL_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    static bool budget_set[2][SEL_MAX_DEVICES];
    if (!budget_set[staged != 0][device]) {
        const void* fn = staged ? (const void*)selector_match_kernel<true>
                                : (const void*)selector_match_kernel<false>;
        err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        SEL_SMEM_BUDGET);
        if (!err)
            err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                            (int)cudaSharedmemCarveoutMaxShared);
        if (err) return err;
        budget_set[staged != 0][device] = true;
    }
    const dim3 grid((n + SEL_ROWS - 1) / SEL_ROWS, s_words);
    const int stage = sel_stage(w, cps);
    cudaStream_t st = (cudaStream_t)stream;
    if (staged) {
        selector_match_kernel<true><<<grid, SEL_ROWS, bytes, st>>>(
            id_bits, conj_req, conj_forbid, conj_valid, req_count, out, n, w, s, cps, s_words, stage);
    } else {
        selector_match_kernel<false><<<grid, SEL_ROWS, bytes, st>>>(
            id_bits, conj_req, conj_forbid, conj_valid, req_count, out, n, w, s, cps, s_words, stage);
    }
    return (int)cudaGetLastError();
}

CILIUM_API const char* cilium_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
