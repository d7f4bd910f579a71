// K2 bool_mm: out[b, c] = (sum_a x[b, a] * w[a, c]) > 0 over int8
// operands with int32 accumulation.
//
// Replaces cilium_tpu/ops/verdict.py:151 _mm, the primitive of every
// relation product in _verdict_block (ops/verdict.py:161) and in the
// identity-major policymap sweep _sweep_device_matrix
// (ops/materialize.py:205). The sum is exact in int32 for any int8
// inputs, so the thresholded result is bit-identical to _mm. With
// ``complement_x`` the kernel reads 1 - x[b, a] in place of x[b, a]
// (the deny product's (1 - peer) operand) without a second array;
// the zero padding of ragged tiles is never complemented.
//
// Bound: operations. At the main path's largest shape, [1024, S] x
// [S, S] with S ~ 1.2k, the card's int8 tensor-core rate would finish
// in microseconds; this first kernel runs on the CUDA cores (one
// IMAD per product), 64x64 output tiles through shared memory, each
// thread holding a 4x4 block of int32 sums in registers.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

__global__ void bool_mm_kernel(
    const int8_t* __restrict__ x,  // [B, A]
    const int8_t* __restrict__ w,  // [A, C]
    uint8_t* __restrict__ out,     // [B, C] 0/1
    int b, int a, int c, int complement_x) {
    __shared__ int8_t xs[BM][BK + 4];
    __shared__ int8_t ws[BK][BN + 4];
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const int64_t row0 = (int64_t)blockIdx.x * BM;
    const int64_t col0 = (int64_t)blockIdx.y * BN;
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < a; k0 += BK) {
        for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
            const int r = e / BK, k = e % BK;
            const int64_t gr = row0 + r;
            const int gk = k0 + k;
            int8_t v = 0;
            if (gr < b && gk < a) {
                v = x[gr * a + gk];
                if (complement_x) v = (int8_t)(1 - v);
            }
            xs[r][k] = v;
        }
        for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
            const int k = e / BN, cc = e % BN;
            const int gk = k0 + k;
            const int64_t gc = col0 + cc;
            ws[k][cc] = (gk < a && gc < c) ? w[(int64_t)gk * c + gc] : (int8_t)0;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < BK; ++k) {
            int av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = xs[ty * 4 + i][k];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = ws[k][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int64_t gr = row0 + ty * 4 + i;
        if (gr >= b) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int64_t gc = col0 + tx * 4 + j;
            if (gc < c) out[gr * c + gc] = acc[i][j] > 0 ? 1 : 0;
        }
    }
}

}  // namespace

CILIUM_API int cilium_bool_mm(
    const int8_t* x, const int8_t* w, uint8_t* out, int b, int a, int c,
    int complement_x, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0 || c == 0) return (int)cudaGetLastError();
    dim3 grid((b + BM - 1) / BM, (c + BN - 1) / BN);
    bool_mm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, w, out, b, a, c, complement_x);
    return (int)cudaGetLastError();
}
