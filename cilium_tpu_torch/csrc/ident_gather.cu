// K12 ident_gather: one shard's partial of the ident-sharded row fetch.
//
// Replaces cilium_tpu/ops/lookup.py:93,115 _onehot_rows_i32 /
// ident_gather_rows: under the 2D flows x ident plan an identity table
// [N, W] is row-sharded over the ident axis, and the reference fetches
// a flow block's rows as a one-hot int32 contraction over the sharded
// N, each device contributing the rows it owns, then an all-reduce over
// ident. Here each shard gathers directly:
//
//   out[i, j] = shard[src[i] - row_lo, j]   if row_lo <= src[i] < row_lo + rows
//             = 0                            otherwise
//
// and the wrapper (ops/lookup.py ident_gather_rows) adds the shards'
// partials on the flow shard's device. Exactly one shard owns a row, so
// the sum is the row, bit for bit, and a row outside [0, N) is all
// zeros, as the contraction gives.
//
// One thread block per group of lanes: the block covers CELLS
// consecutive (lane, word) cells of out, so consecutive threads write
// consecutive words and read consecutive words of the owned rows
// (coalesced); a lane's src id is read once per cell from L1. No shared
// memory, no TMA: the gather is a copy.
//
// Bound: bytes. b x W x 4 written, the owned rows read once, b x 4 of
// src.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 2048;  // (lane, word) cells per block: 8 a thread

__global__ void ident_gather_kernel(
    const int32_t* __restrict__ shard,  // [rows, w]
    int64_t rows, int w, int64_t row_lo,
    const int32_t* __restrict__ src,    // [b]
    int64_t b, int64_t lanes_per_block,
    int32_t* __restrict__ out) {        // [b, w]
    const int64_t lane0 = (int64_t)blockIdx.x * lanes_per_block;
    const int64_t lane_end = lane0 + lanes_per_block < b ? lane0 + lanes_per_block : b;
    const int64_t cells = (lane_end - lane0) * w;
    const int64_t base = lane0 * w;
    for (int64_t c = threadIdx.x; c < cells; c += THREADS) {
        const int64_t lane = lane0 + c / w;
        const int j = (int)(c % w);
        const int64_t r = (int64_t)__ldg(src + lane) - row_lo;
        out[base + c] = (r >= 0 && r < rows) ? __ldg(shard + r * w + j) : 0;
    }
}

}  // namespace

CILIUM_API int cilium_ident_gather(
    const int32_t* shard, int64_t rows, int w, int64_t row_lo,
    const int32_t* src, int64_t b, int32_t* out, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0 || w == 0) return (int)cudaGetLastError();
    const int64_t lanes_per_block = w >= CELLS ? 1 : CELLS / w;
    const int64_t blocks = (b + lanes_per_block - 1) / lanes_per_block;
    ident_gather_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        shard, rows, w, row_lo, src, b, lanes_per_block, out);
    return (int)cudaGetLastError();
}
