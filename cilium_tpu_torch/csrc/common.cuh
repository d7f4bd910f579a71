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
