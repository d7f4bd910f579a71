// K2 bool_mm: out[b, c] = (sum_a x[b, a] * w[a, c]) > 0 over int8
// operands with int32 accumulation, on Hopper's int8 tensor cores.
//
// Replaces cilium_tpu/ops/verdict.py:151 _mm, the primitive of every
// relation product in _verdict_block (ops/verdict.py:161), of the
// identity-major policymap sweep _sweep_device_matrix
// (ops/materialize.py:205) and of the row and column patches' re-sweeps.
// The operands are int8 of any sign; the sum is exact in int32, so the
// thresholded result is bit-identical to _mm. With ``complement_x`` the
// kernel reads 1 - x[b, a] in place of x[b, a] (the deny product's
// (1 - peer) operand) without a second array.
//
// Bound. At the small sweep shape ([1024, 640] x [640, 640], 0.84 GOP)
// the bytes bound it (1.5 MB in and out against 0.4 us of tensor-core
// work); at the patch and attributed shapes ([*, 640] x [640, 4096], the
// attributed one 43 GOP) the operations do (22 us at 1 979 TOP/s against
// 10 us for its 32 MB of output). The design spends its effort on
// keeping the tensor cores fed and writes the output once, as bytes,
// through shared memory. tools/k2_probe.py times the kernel with parts
// of its main loop compiled out, and the tensor cores alone on these
// layouts, to show which part holds it back.
//
// Design.
// - Products: wgmma.mma_async m64n128k32 .s32.s8.s8 (sm_90a), int32
//   accumulators in registers. A block is one or two warpgroups, each
//   owning 64 rows x 128 columns of the output (the C entry chooses by
//   the output's size); two blocks fit an SM.
// - The layout trap: for 8-bit types wgmma reads A and B K-major only.
//   x [B, A] is K-major; every w K2 receives ([A, C], C contiguous: the
//   DeviceTables fields, the sweep's subj_t8 / combo_t / sp7_t) is
//   MN-major. Its tile is copied as it lies and transposed in shared
//   memory: each thread reads a 4 (k) x 4 (c) byte block as four words,
//   transposes it with byte permutes and writes four words, one per
//   column, into the K-major no-swizzle core-matrix layout the
//   descriptor names (8 rows x 16 bytes per core matrix; the 8-row
//   groups of B sit 16 bytes further apart than their size, which keeps
//   those writes free of bank conflicts). No table changes layout.
// - Staging: a ring of four shared-memory stages of 64 contracted
//   bytes, fed by cp.async (16-byte copies, zero-filled past the
//   edges): x's tile lands in the K-major layout the descriptor reads,
//   w's tile as it lies. The copies of stage s + 3 are issued while the
//   tensor cores run stage s, and w's tile of stage s + 1 is transposed
//   (into one of two transposed buffers) meanwhile; wgmma.wait_group 1
//   keeps one group of products in flight across the block barriers.
//   TMA does not fit: it cannot transpose bytes, and x's rows need not
//   be 16-byte aligned.
// - Any shape, one kernel: x rows 16-byte aligned (a % 16 == 0) and w
//   rows 16-byte aligned (c % 16 == 0) take the cp.async copies; other
//   shapes load byte by byte into the same layouts. Rows past b, columns
//   past c and K past a are zero-filled. a = 0 writes all zeros; b = 0
//   or c = 0 launches nothing. The wrapper pads and copies nothing.
// - complement_x: 1 - v is applied (four bytes at a time) to the staged
//   A tile in shared memory before the wgmma that reads it, padding
//   included: a padded K position then reads 1, which is correct only
//   because B's K padding is zero (1 * 0 = 0); padded rows are never
//   written out. Every shared-memory write (cp.async's and the
//   threads') is followed by fence.proxy.async and the block barrier
//   before the wgmma that reads it.
// - Epilogue: the accumulators are thresholded (> 0) to 0/1 bytes,
//   written to a shared tile (row stride 144: no bank conflicts) and
//   stored to the bool output in 16-byte vectors when c % 16 == 0.
// - Launch: on the stream given, nothing allocated, no synchronisation.
//   A block needs 70-87 KB of dynamic shared memory, so the C entry
//   raises the kernel's limit once per device (an atomic mask; the call
//   is idempotent, so a race only repeats it).
#include <atomic>

#include "common.cuh"

namespace {

constexpr int BN = 128;      // output columns per block (wgmma N)
constexpr int BK = 64;       // contracted bytes per stage (two k32 steps)
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int A_SBO = BK * 8;        // bytes between 8-row core-matrix groups of A
constexpr int B_SBO = BK * 8 + 16;   // of transposed B: +16 spreads its writes over the banks
constexpr int BT_BYTES = (BN / 8) * B_SBO;
constexpr int BR_LD = BN + 16;       // row stride of w's tile as copied
constexpr int BR_BYTES = BK * BR_LD;
constexpr int OUT_LD = BN + 16;      // epilogue tile row stride

template <int NWG>
struct Cfg {
    static constexpr int BM = 64 * NWG;
    static constexpr int NT = 128 * NWG;
    static constexpr int A_BYTES = BM * BK;
    static constexpr int STAGE = A_BYTES + BR_BYTES;      // one ring stage: A, then w's tile
    static constexpr int SMEM = STAGES * STAGE + 2 * BT_BYTES;
    static constexpr int CA = A_BYTES / 16 / NT;          // 16-byte A chunks a thread
    static constexpr int CB = BK * BN / 16 / NT;          // 16-byte chunks of w's tile a thread
    static constexpr int QB = (BK / 4) * (BN / 4) / NT;   // 4 x 4 transposes a thread
    static_assert(SMEM >= BM * OUT_LD, "the epilogue tile reuses the ring");
    static_assert(A_BYTES % 128 == 0 && STAGE % 128 == 0 && BT_BYTES % 128 == 0, "alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major, no swizzle: LBO = the next 16-byte K chunk (one core matrix,
// 128 bytes on), SBO = the next 8-row group
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t sbo) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
    for (int j = 0; j < 64; ++j) asm volatile("" : "+r"(d[j])::"memory");
}

// 16 bytes global -> shared; bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += A (64 x 32, K-major) * B (32 x 128, K-major), int8 -> int32
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// Stage s's copies into ring slot sa (A) / sb (w's tile). A chunk u:
// rows (u / 32) * 8 + u % 8, K bytes (u / 8 % 4) * 16 .. + 15, eight
// consecutive threads filling one 128-byte core matrix. w chunk v:
// K row v / 8, columns (v % 8) * 16 .. + 15, eight threads a 128-byte row.
template <int NWG, int VA, int VB>
__device__ __forceinline__ void issue(uint8_t* sa, uint8_t* sb, const int8_t* __restrict__ x,
                                      const int8_t* __restrict__ w, int64_t m0, int64_t n0,
                                      int k0, int b, int a, int c) {
    using C = Cfg<NWG>;
#pragma unroll
    for (int i = 0; i < C::CA; ++i) {
        const int u = threadIdx.x + i * C::NT;
        const int64_t row = m0 + (u >> 5) * 8 + (u & 7);
        const int k = k0 + ((u >> 3) & 3) * 16;
        uint8_t* dst = sa + (u >> 5) * A_SBO + ((u >> 3) & 3) * 128 + (u & 7) * 16;
        const bool ok = row < b && k < a;
        if (VA == 16) {
            cp_async16(smem_u32(dst), ok ? x + row * a + k : x, ok ? 16 : 0);
        } else {
            uint32_t wd[4] = {0, 0, 0, 0};
            if (row < b) {
#pragma unroll
                for (int t = 0; t < 16; ++t)
                    if (k + t < a) wd[t >> 2] |= (uint32_t)(uint8_t)x[row * a + k + t] << (8 * (t & 3));
            }
            *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
    }
#pragma unroll
    for (int i = 0; i < C::CB; ++i) {
        const int v = threadIdx.x + i * C::NT;
        const int k = k0 + (v >> 3);
        const int64_t n = n0 + (v & 7) * 16;
        uint8_t* dst = sb + (v >> 3) * BR_LD + (v & 7) * 16;
        const bool ok = k < a && n < c;
        if (VB == 16) {
            cp_async16(smem_u32(dst), ok ? w + (int64_t)k * c + n : w, ok ? 16 : 0);
        } else {
            uint32_t wd[4] = {0, 0, 0, 0};
            if (k < a) {
#pragma unroll
                for (int t = 0; t < 16; ++t)
                    if (n + t < c) wd[t >> 2] |= (uint32_t)(uint8_t)w[(int64_t)k * c + n + t] << (8 * (t & 3));
            }
            *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
    }
}

// transpose block q: K rows k .. k + 3 of columns n .. n + 3, with
// k = 4 * (q % 4 + 4 * (q / 32 % 4)), n = 4 * (q / 4 % 8 + 8 * (q / 128))
__device__ __forceinline__ int b_k(int q) { return 4 * ((q & 3) + 4 * ((q >> 5) & 3)); }
__device__ __forceinline__ int b_n(int q) { return 4 * (((q >> 2) & 7) + 8 * (q >> 7)); }

// Stage s made ready for its wgmma: w's tile (sb, as copied) transposed
// into bt, and 1 - v applied to the A tile (sa) under complement_x.
template <int NWG>
__device__ __forceinline__ void prep(uint8_t* sa, const uint8_t* sb, uint8_t* bt, int complement_x) {
    using C = Cfg<NWG>;
#pragma unroll
    for (int i = 0; i < C::QB; ++i) {
        const int q = threadIdx.x + i * C::NT;
        const int k = b_k(q), n = b_n(q);
        const uint8_t* src = sb + k * BR_LD + n;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
        const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + BR_LD);
        const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * BR_LD);
        const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * BR_LD);
        // r holds columns n .. n + 3 of one K row; word j of the transpose
        // holds K rows k .. k + 3 of column n + j
        const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
        const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
        const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
        const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
        const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                                 __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
        uint8_t* base = bt + (k >> 4) * 128 + (k & 15);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint32_t*>(base + ((n + j) >> 3) * B_SBO + ((n + j) & 7) * 16) = col[j];
    }
    if (complement_x) {  // 1 - v in each byte (int8 wrap-around, as _mm's 1 - x)
#pragma unroll
        for (int i = 0; i < C::CA; ++i) {
            const int u = threadIdx.x + i * C::NT;
            uint4* p = reinterpret_cast<uint4*>(sa + (u >> 5) * A_SBO + ((u >> 3) & 3) * 128 + (u & 7) * 16);
            uint4 v = *p;
            v.x = __vsub4(0x01010101u, v.x);
            v.y = __vsub4(0x01010101u, v.y);
            v.z = __vsub4(0x01010101u, v.z);
            v.w = __vsub4(0x01010101u, v.w);
            *p = v;
        }
    }
}

template <int NWG, int VA, int VB>
__global__ void __launch_bounds__(128 * NWG) bool_mm_kernel(
    const int8_t* __restrict__ x,  // [B, A]
    const int8_t* __restrict__ w,  // [A, C]
    uint8_t* __restrict__ out,     // [B, C] 0/1
    int b, int a, int c, int complement_x, int vec_out) {
    using C = Cfg<NWG>;
    extern __shared__ __align__(128) uint8_t smem[];
    const int g = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int64_t m0 = (int64_t)blockIdx.x * C::BM;
    const int64_t n0 = (int64_t)blockIdx.y * BN;
    uint8_t* const bt0 = smem + STAGES * C::STAGE;
    auto sa = [&](int s) { return smem + (s % STAGES) * C::STAGE; };
    auto sb = [&](int s) { return smem + (s % STAGES) * C::STAGE + C::A_BYTES; };
    auto bt = [&](int s) { return bt0 + (s & 1) * BT_BYTES; };

    int d[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) d[j] = 0;
    fence_acc(d);

    const int ksteps = (a + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ksteps) issue<NWG, VA, VB>(sa(s), sb(s), x, w, m0, n0, s * BK, b, a, c);
        cp_async_commit();
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ksteps > 0) prep<NWG>(sa(0), sb(0), bt(0), complement_x);
    fence_proxy_async();
    __syncthreads();

    for (int s = 0; s < ksteps; ++s) {
        const uint64_t da = make_desc(smem_u32(sa(s)) + g * 8 * A_SBO, A_SBO);
        const uint64_t db = make_desc(smem_u32(bt(s)), B_SBO);
        wgmma_fence();
        wgmma_s8(d, da, db);
        wgmma_s8(d, da + (256 >> 4), db + (256 >> 4));  // the second 32-byte K step
        wgmma_commit();
        wgmma_wait<1>();               // this warpgroup's products of s - 1 are done
        cp_async_wait<STAGES - 3>();   // this thread's copies of stage s + 1 landed
        __syncthreads();
        // slot (s - 1) % STAGES and transposed buffer (s + 1) % 2 are free:
        // the products of s - 1 read them, and prep(s - 1) ran before
        if (s + STAGES - 1 < ksteps)
            issue<NWG, VA, VB>(sa(s + STAGES - 1), sb(s + STAGES - 1), x, w, m0, n0,
                               (s + STAGES - 1) * BK, b, a, c);
        cp_async_commit();
        if (s + 1 < ksteps) prep<NWG>(sa(s + 1), sb(s + 1), bt(s + 1), complement_x);
        fence_proxy_async();
        __syncthreads();
    }
    wgmma_wait<0>();
    fence_acc(d);
    cp_async_wait<0>();
    __syncthreads();  // every product and copy is done with the ring

    // accumulator d[j] of this thread: row 16 * warp + lane / 4 (+ 8 for
    // odd j / 2) of its warpgroup's 64, column 8 * (j / 4) + 2 * (lane % 4)
    // + j % 2
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
        const int row = g * 64 + warp * 16 + (lane >> 2) + ((j >> 1) & 1) * 8;
        const int col = (j >> 2) * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint16_t*>(smem + row * OUT_LD + col) =
            (uint16_t)(d[j] > 0) | (uint16_t)((d[j + 1] > 0) << 8);
    }
    __syncthreads();
    if (vec_out) {
        for (int u = threadIdx.x; u < C::BM * (BN / 16); u += C::NT) {
            const int row = u >> 3, cb = (u & 7) * 16;
            const int64_t gr = m0 + row, gc = n0 + cb;
            if (gr < b && gc < c)
                *reinterpret_cast<uint4*>(out + gr * c + gc) =
                    *reinterpret_cast<const uint4*>(smem + row * OUT_LD + cb);
        }
    } else {
        for (int e = threadIdx.x; e < C::BM * BN; e += C::NT) {
            const int row = e >> 7, col = e & (BN - 1);
            const int64_t gr = m0 + row, gc = n0 + col;
            if (gr < b && gc < c) out[gr * c + gc] = smem[row * OUT_LD + col];
        }
    }
}

template <int NWG, int VA, int VB>
int launch(const int8_t* x, const int8_t* w, uint8_t* out, int b, int a, int c,
           int complement_x, int vec_out, int device, cudaStream_t stream) {
    using C = Cfg<NWG>;
    auto kernel = bool_mm_kernel<NWG, VA, VB>;
    static std::atomic<unsigned long long> raised{0};
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (bit == 0 || !(raised.load() & bit)) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (e != cudaSuccess) return (int)e;
        raised.fetch_or(bit);
    }
    dim3 grid((unsigned)((b + C::BM - 1) / C::BM), (unsigned)((c + BN - 1) / BN));
    kernel<<<grid, C::NT, C::SMEM, stream>>>(x, w, out, b, a, c, complement_x, vec_out);
    return (int)cudaGetLastError();
}

template <int NWG>
int pick(const int8_t* x, const int8_t* w, uint8_t* out, int b, int a, int c,
         int complement_x, int device, cudaStream_t stream) {
    const bool va = a % 16 == 0 && (uintptr_t)x % 16 == 0;
    const bool vb = c % 16 == 0 && (uintptr_t)w % 16 == 0;
    const int vec_out = c % 16 == 0 && (uintptr_t)out % 16 == 0;
    if (va && vb) return launch<NWG, 16, 16>(x, w, out, b, a, c, complement_x, vec_out, device, stream);
    if (va) return launch<NWG, 16, 1>(x, w, out, b, a, c, complement_x, vec_out, device, stream);
    if (vb) return launch<NWG, 1, 16>(x, w, out, b, a, c, complement_x, vec_out, device, stream);
    return launch<NWG, 1, 1>(x, w, out, b, a, c, complement_x, vec_out, device, stream);
}

}  // namespace

CILIUM_API int cilium_bool_mm(
    const int8_t* x, const int8_t* w, uint8_t* out, int b, int a, int c,
    int complement_x, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0 || c == 0) return (int)cudaGetLastError();
    // 128-row blocks once there are 64 of them (at [282, 640] x [640,
    // 4096] they beat 64-row ones, at [1024, 640] x [640, 640] with 40
    // they lose); four warpgroups measured no faster than two anywhere
    const int64_t tiles = (int64_t)((b + 127) / 128) * ((c + BN - 1) / BN);
    cudaStream_t s = (cudaStream_t)stream;
    return tiles >= 64 ? pick<2>(x, w, out, b, a, c, complement_x, device, s)
                       : pick<1>(x, w, out, b, a, c, complement_x, device, s);
}
