// K12 ident_gather: the ident-sharded row fetch, one launch per device.
//
// Replaces cilium_tpu/ops/lookup.py:93,115 _onehot_rows_i32 /
// ident_gather_rows: under the 2D flows x ident plan an identity table
// [N, W] is row-sharded over the ident axis, and the reference fetches
// a flow block's rows as a one-hot int32 contraction over the sharded
// N, each device contributing the rows it owns, then an all-reduce over
// ident. Here one launch reads every shard that lives on one device:
//
//   out[i, :] = shard_k[src[i] - row_lo_k, :]   for the k whose
//                                               [row_lo_k, row_lo_k + rows_k) holds src[i]
//             = 0                               when no listed shard owns src[i]
//
// The shards come as a small fixed-size list passed by value (at most
// MAX_SHARDS; the wrapper raises past it). When every shard of the
// reader's grid row lies on the reader's device (one card's virtual
// grid) this is the whole fetch: one launch, no partials, no add. When
// the shards lie on several cards the wrapper launches once per device
// and adds the partials, which is exact because one shard owns a row.
// A row outside [0, N) is all zeros, as the contraction gives.
//
// Mapping: a group of G threads (a power of two, at most a warp) per
// lane. The group reads the lane's id once (one broadcast load), finds
// the owning shard by its row range (an unrolled compare over the
// list: no divergence inside the group), then copies the row in the
// widest vector its alignment allows (16, 8 or 4 bytes: W = 20 and
// 288 take 16, W = 18 takes 8), thread g of the group taking vectors
// g, g + G, ...; a row no shard owns is written as zero vectors.
// Consecutive groups write consecutive rows, so the stores coalesce.
// No division or modulo per cell.
//
// Bound: bytes. b x W x 4 written, the distinct owned rows read once,
// b x 4 of ids.
#include "common.cuh"  // ShardList, MAX_SHARDS

namespace {

constexpr int THREADS = 256;

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = int4; };
template <> struct Vec<2> { using T = int2; };
template <> struct Vec<1> { using T = int32_t; };

template <int VEC>
__global__ void ident_gather_kernel(
    const ShardList shards, int wv, int gshift,
    const int32_t* __restrict__ src,  // [b]
    int64_t b,
    int32_t* __restrict__ out) {      // [b, wv * VEC]
    using V = typename Vec<VEC>::T;
    const int g = threadIdx.x & ((1 << gshift) - 1);
    const int step = 1 << gshift;
    const int64_t groups = THREADS >> gshift;
    const int64_t stride = (int64_t)gridDim.x * groups;
    for (int64_t lane = (int64_t)blockIdx.x * groups + (threadIdx.x >> gshift); lane < b;
         lane += stride) {
        const int64_t id = __ldg(src + lane);
        const V* row = nullptr;
#pragma unroll
        for (int k = 0; k < MAX_SHARDS; ++k) {
            const int64_t r = id - shards.row_lo[k];
            if (k < shards.n && r >= 0 && r < shards.rows[k])
                row = reinterpret_cast<const V*>(shards.ptr[k]) + r * wv;
        }
        V* dst = reinterpret_cast<V*>(out) + lane * wv;
        if (row != nullptr) {
            for (int j = g; j < wv; j += step) dst[j] = __ldg(row + j);
        } else {
            const V zero{};
            for (int j = g; j < wv; j += step) dst[j] = zero;
        }
    }
}

template <int VEC>
int launch(const ShardList& shards, int w, const int32_t* src, int64_t b, int32_t* out,
           cudaStream_t stream) {
    const int wv = w / VEC;
    int gshift = 0;
    while ((1 << gshift) < wv && gshift < 5) ++gshift;
    const int64_t groups = THREADS >> gshift;
    int64_t blocks = (b + groups - 1) / groups;
    if (blocks > (1 << 30)) blocks = 1 << 30;  // the kernel strides over the rest
    ident_gather_kernel<VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
        shards, wv, gshift, src, b, out);
    return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

}  // namespace

CILIUM_API int cilium_ident_gather(
    ShardList shards, int w, const int32_t* src, int64_t b, int32_t* out,
    int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (shards.n < 1 || shards.n > MAX_SHARDS) return (int)cudaErrorInvalidValue;
    if (b == 0 || w == 0) return (int)cudaGetLastError();
    int vec = w % 4 == 0 ? 4 : (w % 2 == 0 ? 2 : 1);
    for (int k = 0; k < shards.n; ++k) {
        while (vec > 1 && !aligned(shards.ptr[k], 4 * vec)) vec /= 2;
    }
    while (vec > 1 && !aligned(out, 4 * vec)) vec /= 2;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec == 4) return launch<4>(shards, w, src, b, out, s);
    if (vec == 2) return launch<2>(shards, w, src, b, out, s);
    return launch<1>(shards, w, src, b, out, s);
}
