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

#include <mutex>

#define CILIUM_API extern "C" __attribute__((visibility("default")))

static inline int cilium_set_device(int device) {
    int cur = -1;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess) return (int)err;
    if (cur != device) return (int)cudaSetDevice(device);
    return 0;
}

// Element j (a compile-time index once unrolled) of a 16-byte chunk of
// uint8 or int32 row bytes: the vector row reads of K7 dfa_walk and K8
// dfa_pair_walk.
template <typename ByteT>
__device__ __forceinline__ int chunk_element(const uint4& c, int j) {
    constexpr int PER_WORD = 4 / sizeof(ByteT);
    const int k = j / PER_WORD;
    const uint32_t w = k == 0 ? c.x : k == 1 ? c.y : k == 2 ? c.z : c.w;
    if (sizeof(ByteT) == 1) return (int)((w >> ((j & 3) * 8)) & 0xFFu);
    return (int)w;
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

// A persistent grid's fit, asked once and not at every launch: per
// (device, kernel) the SM count, with the kernel's dynamic shared-memory
// limit raised to smem_max first when it is not 0; per (device, kernel,
// block, shared bytes) the blocks an SM holds. K7 dfa_walk and K8
// dfa_pair_walk size their grids with them (one cache for the library).
namespace launch_fit {

struct Dev {
    int device;
    const void* kern;
    int sms;
};
struct Fit {
    int device;
    const void* kern;
    int threads;
    size_t smem;
    int per_sm;
};
inline std::mutex mu;
inline Dev devs[64];
inline Fit fits[256];
inline int n_devs = 0, n_fits = 0;

inline int sm_count(const void* kern, size_t smem_max, int device, int& sms) {
    std::lock_guard<std::mutex> hold(mu);
    for (int k = 0; k < n_devs; ++k) {
        if (devs[k].device == device && devs[k].kern == kern) {
            sms = devs[k].sms;
            return 0;
        }
    }
    int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err) return err;
    if (smem_max) {
        err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem_max);
        if (err) return err;
    }
    if (n_devs < 64) devs[n_devs++] = Dev{device, kern, sms};
    return 0;
}

inline int blocks_per_sm(const void* kern, int device, int threads, size_t smem,
                                int& per_sm) {
    std::lock_guard<std::mutex> hold(mu);
    for (int k = 0; k < n_fits; ++k) {
        const Fit& f = fits[k];
        if (f.device == device && f.kern == kern && f.threads == threads && f.smem == smem) {
            per_sm = f.per_sm;
            return 0;
        }
    }
    int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err) return err;
    if (n_fits < 256) fits[n_fits++] = Fit{device, kern, threads, smem, per_sm};
    return 0;
}

}  // namespace launch_fit
