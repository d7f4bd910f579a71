// K4 policymap_verdict: per-flow policymap lookup, prefilter override
// and per-endpoint counters.
//
// Replaces cilium_tpu/ops/lookup.py:146 lookup_batch together with the
// tail of datapath/pipeline.py:220 _verdict_tail. One thread per flow
// reads its identity row of the combined table (allow words ‖ redirect
// words) and visits only the set allow bits, testing each column's
// selection against the column metadata staged in shared memory:
//
//   colsel[c] = ep == col_ep[c] && (col_is_l3[c] ||
//               (port == col_port[c] && proto == col_proto[c]))
//   allow     = any_c colsel[c] && allow_bit[c]
//   redirect  = any_c colsel[c] && allow_bit[c] && red_bit[c]
//   verdict   = denied_pf ? DROP_PREFILTER(3) : allow ? 1 : 2
//
// Counters [EP, 3] (forwarded, dropped by policy, dropped by the
// prefilter) gather in a per-block shared histogram and reach device
// memory with one atomicAdd per non-zero cell; the sums are integers,
// so the result does not depend on the order of the atomics. A flow
// whose ep_idx lies outside [0, ep_count) counts nowhere, as in the
// one-hot contraction it replaces. A row outside [0, N) reads as no
// bits.
//
// Bound: bytes. Per flow 16 bytes in (row, ep, port, proto), one
// optional prefilter byte, 2 bytes out; the table rows (N x 2W words)
// sit in L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // columns staged per pass (32 words)
constexpr int HIST_MAX = 6144;  // shared histogram cells (24 KB)

__global__ void policymap_verdict_kernel(
    const int32_t* __restrict__ id_bits,  // [N, 2W] uint32 bit view
    int n, int words,
    const int32_t* __restrict__ col_ep,     // [C]
    const int32_t* __restrict__ col_port,   // [C]
    const int32_t* __restrict__ col_proto,  // [C]
    const uint8_t* __restrict__ col_is_l3,  // [C]
    int c,
    const int32_t* __restrict__ src_rows,   // [B]
    const int32_t* __restrict__ ep_idx,     // [B]
    const int32_t* __restrict__ dport,      // [B]
    const int32_t* __restrict__ proto,      // [B]
    const uint8_t* __restrict__ denied_pf,  // [B] or null
    int8_t* __restrict__ verdict,           // [B]
    uint8_t* __restrict__ redirect,         // [B]
    int32_t* __restrict__ counters,         // [EP, 3] or null
    int ep_count, int shared_hist, int64_t b) {
    __shared__ int s_ep[CHUNK];
    __shared__ int s_port[CHUNK];
    __shared__ int s_proto[CHUNK];
    __shared__ uint8_t s_l3[CHUNK];
    extern __shared__ int hist[];

    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    const bool live = i < b;
    const int hist_cells = ep_count * 3;
    if (counters != nullptr && shared_hist) {
        for (int e = threadIdx.x; e < hist_cells; e += THREADS) hist[e] = 0;
        __syncthreads();
    }

    int ep = 0, port = 0, prt = 0, row = -1;
    if (live) {
        ep = ep_idx[i];
        port = dport[i];
        prt = proto[i];
        row = src_rows[i];
    }
    const bool row_ok = live && row >= 0 && row < n;
    const int w = words / 2;
    const uint32_t* rowp =
        reinterpret_cast<const uint32_t*>(id_bits) + (int64_t)(row_ok ? row : 0) * words;
    bool allow = false, red = false;

    for (int c0 = 0; c0 < c; c0 += CHUNK) {
        const int span = min(CHUNK, c - c0);
        __syncthreads();
        for (int j = threadIdx.x; j < span; j += THREADS) {
            s_ep[j] = col_ep[c0 + j];
            s_port[j] = col_port[c0 + j];
            s_proto[j] = col_proto[c0 + j];
            s_l3[j] = col_is_l3[c0 + j];
        }
        __syncthreads();
        if (!row_ok || (allow && red)) continue;
        const int wlo = c0 / 32;
        const int whi = (c0 + span + 31) / 32;
        for (int wd = wlo; wd < whi; ++wd) {
            uint32_t aw = __ldg(rowp + wd);
            if (!aw) continue;
            const uint32_t rw = __ldg(rowp + w + wd);
            while (aw) {
                const int bit = __ffs(aw) - 1;
                aw &= aw - 1;
                const int cc = wd * 32 + bit - c0;
                if (cc >= span) break;
                const bool sel = ep == s_ep[cc] &&
                    (s_l3[cc] || (port == s_port[cc] && prt == s_proto[cc]));
                if (sel) {
                    allow = true;
                    if ((rw >> bit) & 1u) red = true;
                }
            }
        }
    }

    int8_t v = allow ? 1 : 2;
    if (live) {
        if (denied_pf != nullptr && denied_pf[i]) {
            v = 3;
            red = false;
        }
        verdict[i] = v;
        redirect[i] = red ? 1 : 0;
    }
    if (counters == nullptr) return;
    const bool counted = live && ep >= 0 && ep < ep_count;
    if (shared_hist) {
        if (counted) atomicAdd(&hist[ep * 3 + (v - 1)], 1);
        __syncthreads();
        for (int e = threadIdx.x; e < hist_cells; e += THREADS) {
            if (hist[e]) atomicAdd(&counters[e], hist[e]);
        }
    } else if (counted) {
        atomicAdd(&counters[ep * 3 + (v - 1)], 1);
    }
}

}  // namespace

CILIUM_API int cilium_policymap_verdict(
    const int32_t* id_bits, int n, int words, const int32_t* col_ep,
    const int32_t* col_port, const int32_t* col_proto,
    const uint8_t* col_is_l3, int c, const int32_t* src_rows,
    const int32_t* ep_idx, const int32_t* dport, const int32_t* proto,
    const uint8_t* denied_pf, int8_t* verdict, uint8_t* redirect,
    int32_t* counters, int ep_count, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    const int shared_hist = counters != nullptr && ep_count * 3 <= HIST_MAX;
    const size_t smem = shared_hist ? (size_t)ep_count * 3 * sizeof(int) : 0;
    const int64_t blocks = (b + THREADS - 1) / THREADS;
    policymap_verdict_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
        id_bits, n, words, col_ep, col_port, col_proto, col_is_l3, c,
        src_rows, ep_idx, dport, proto, denied_pf, verdict, redirect,
        counters, ep_count, shared_hist, b);
    return (int)cudaGetLastError();
}
