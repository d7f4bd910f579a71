// Shared declarations of the port's CUDA kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// cilium_tpu_torch/_kernels.py), launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() right after its
// launch so that a refused launch surfaces in the Python wrapper.
// Packed uint32 words travel as int32 bit views; kernels reinterpret
// them as unsigned before shifting.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CILIUM_API extern "C" __attribute__((visibility("default")))

static inline int cilium_set_device(int device) {
    int cur = -1;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess) return (int)err;
    if (cur != device) return (int)cudaSetDevice(device);
    return 0;
}

// A list of row shards of one identity table, passed by value (at most
// MAX_SHARDS). Shard k holds rows [row_lo[k], row_lo[k] + rows[k]) as a
// row-major [rows[k], W] array. K12 ident_gather and K4
// policymap_verdict take their rows this way; ctypes mirror:
// _kernels.py ShardList.
constexpr int MAX_SHARDS = 16;  // _kernels.py IDENT_MAX_SHARDS

struct ShardList {
    const int32_t* ptr[MAX_SHARDS];
    int64_t row_lo[MAX_SHARDS];
    int64_t rows[MAX_SHARDS];
    int n;
};
