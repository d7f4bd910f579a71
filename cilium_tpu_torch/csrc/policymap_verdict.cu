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
//
// Attribution mode (cilium_policymap_verdict_attrib) replaces the
// attrib branch of cilium_tpu/ops/lookup.py:202-234 and the rule-hit
// segment-sum of datapath/pipeline.py:267-276. Each thread visits every
// column and keeps the first (lowest-index) column of four classes:
//
//   col = first allowed L4 column, else first allowed column,
//         else first covering L4 column, else first covering column,
//         else -1                       (covering = colsel[c])
//   rule       = col >= 0 && row in [0, N) ? rule_tab[row, col] : -1
//   rule       = denied_pf ? -1 : rule  (the prefilter drop decided)
//   l4_covered = any covering L4 column
//   hits[min(rule, max(R-1, 0))] += 1 for rule >= 0
//
// The [R] hit histogram, like the counters, gathers per block in
// shared memory (falling back to global atomics past the shared
// budget) over a grid-stride loop, so each block flushes it once.
// Bound: bytes. Per flow the 17 bytes in and 2 out above plus 5 out
// (rule, l4_covered) and one int32 read of rule_tab.
#include <algorithm>

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

namespace {

constexpr int HITS_SHARED_MAX = 32768;  // shared rule-hit cells (128 KB)

__global__ void policymap_verdict_attrib_kernel(
    const int32_t* __restrict__ id_bits, int n, int words,
    const int32_t* __restrict__ col_ep, const int32_t* __restrict__ col_port,
    const int32_t* __restrict__ col_proto, const uint8_t* __restrict__ col_is_l3,
    int c,
    const int32_t* __restrict__ rule_tab,   // [N, C]
    const int32_t* __restrict__ src_rows, const int32_t* __restrict__ ep_idx,
    const int32_t* __restrict__ dport, const int32_t* __restrict__ proto,
    const uint8_t* __restrict__ denied_pf,  // [B] or null
    int8_t* __restrict__ verdict, uint8_t* __restrict__ redirect,
    int32_t* __restrict__ rule_out,         // [B]
    uint8_t* __restrict__ l4x_out,          // [B]
    int32_t* __restrict__ counters, int ep_count, int shared_counters,
    int32_t* __restrict__ hits, int n_hits, int shared_hits,
    int64_t b, int64_t rounds) {
    __shared__ int s_ep[CHUNK];
    __shared__ int s_port[CHUNK];
    __shared__ int s_proto[CHUNK];
    __shared__ uint8_t s_l3[CHUNK];
    extern __shared__ int hist[];
    const int hist_cells = shared_counters ? ep_count * 3 : 0;
    int* s_hits = hist + hist_cells;
    const int hit_cells = shared_hits ? n_hits : 0;
    for (int e = threadIdx.x; e < hist_cells + hit_cells; e += THREADS) hist[e] = 0;
    __syncthreads();
    const int w = words / 2;
    const int64_t grid = (int64_t)gridDim.x * THREADS;

    for (int64_t r = 0; r < rounds; ++r) {
        const int64_t i = r * grid + (int64_t)blockIdx.x * THREADS + threadIdx.x;
        const bool live = i < b;
        int ep = 0, port = 0, prt = 0, row = -1;
        if (live) {
            ep = ep_idx[i];
            port = dport[i];
            prt = proto[i];
            row = src_rows[i];
        }
        const bool row_ok = live && row >= 0 && row < n;
        const uint32_t* rowp = reinterpret_cast<const uint32_t*>(id_bits) +
                               (int64_t)(row_ok ? row : 0) * words;
        bool allow = false, red = false;
        int first_l4_hit = -1, first_hit = -1, first_l4_sel = -1, first_sel = -1;
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
            if (!live) continue;
            uint32_t aw = 0, rw = 0;
            for (int cc = 0; cc < span; ++cc) {
                const int col = c0 + cc;
                if ((col & 31) == 0 || cc == 0) {
                    aw = row_ok ? __ldg(rowp + (col >> 5)) : 0u;
                    rw = row_ok ? __ldg(rowp + w + (col >> 5)) : 0u;
                }
                if (ep != s_ep[cc]) continue;
                const bool l3 = s_l3[cc] != 0;
                if (!l3 && (port != s_port[cc] || prt != s_proto[cc])) continue;
                if (first_sel < 0) first_sel = col;
                if (!l3 && first_l4_sel < 0) first_l4_sel = col;
                const int bit = col & 31;
                if ((aw >> bit) & 1u) {
                    allow = true;
                    if (first_hit < 0) first_hit = col;
                    if (!l3 && first_l4_hit < 0) first_l4_hit = col;
                    if ((rw >> bit) & 1u) red = true;
                }
            }
        }
        if (!live) continue;
        const int col = first_l4_hit >= 0 ? first_l4_hit
                        : allow           ? first_hit
                        : first_l4_sel >= 0 ? first_l4_sel
                                            : first_sel;
        int rule = (col >= 0 && row_ok) ? __ldg(rule_tab + (int64_t)row * c + col) : -1;
        int8_t v = allow ? 1 : 2;
        if (denied_pf != nullptr && denied_pf[i]) {
            v = 3;
            red = false;
            rule = -1;
        }
        verdict[i] = v;
        redirect[i] = red ? 1 : 0;
        rule_out[i] = rule;
        l4x_out[i] = first_l4_sel >= 0 ? 1 : 0;
        if (counters != nullptr && ep >= 0 && ep < ep_count) {
            int* cell = shared_counters ? &hist[ep * 3 + (v - 1)] : &counters[ep * 3 + (v - 1)];
            atomicAdd(cell, 1);
        }
        if (hits != nullptr && rule >= 0) {
            const int idx = min(rule, max(n_hits - 1, 0));
            atomicAdd(shared_hits ? &s_hits[idx] : &hits[idx], 1);
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < hist_cells; e += THREADS) {
        if (hist[e]) atomicAdd(&counters[e], hist[e]);
    }
    for (int e = threadIdx.x; e < hit_cells; e += THREADS) {
        if (s_hits[e]) atomicAdd(&hits[e], s_hits[e]);
    }
}

}  // namespace

CILIUM_API int cilium_policymap_verdict_attrib(
    const int32_t* id_bits, int n, int words, const int32_t* col_ep,
    const int32_t* col_port, const int32_t* col_proto,
    const uint8_t* col_is_l3, int c, const int32_t* rule_tab,
    const int32_t* src_rows, const int32_t* ep_idx, const int32_t* dport,
    const int32_t* proto, const uint8_t* denied_pf, int8_t* verdict,
    uint8_t* redirect, int32_t* rule_out, uint8_t* l4x_out,
    int32_t* counters, int ep_count, int32_t* hits, int n_hits, int64_t b,
    int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    const int shared_counters = counters != nullptr && ep_count * 3 <= HIST_MAX;
    const int shared_hits = hits != nullptr && n_hits <= HITS_SHARED_MAX;
    const size_t smem =
        ((shared_counters ? (size_t)ep_count * 3 : 0) + (shared_hits ? (size_t)n_hits : 0)) *
        sizeof(int);
    err = (int)cudaFuncSetAttribute(
        policymap_verdict_attrib_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    int sms = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err) return err;
    int per_sm = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, policymap_verdict_attrib_kernel, THREADS, smem);
    if (err) return err;
    // enough blocks to fill the card once; each walks a grid stride, so
    // the shared histograms are zeroed and flushed once per block
    const int64_t need = (b + THREADS - 1) / THREADS;
    const int64_t blocks = std::min<int64_t>(need, (int64_t)sms * std::max(per_sm, 1));
    const int64_t rounds = (b + blocks * THREADS - 1) / (blocks * THREADS);
    policymap_verdict_attrib_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
        id_bits, n, words, col_ep, col_port, col_proto, col_is_l3, c, rule_tab,
        src_rows, ep_idx, dport, proto, denied_pf, verdict, redirect, rule_out,
        l4x_out, counters, ep_count, shared_counters, hits, n_hits, shared_hits,
        b, rounds);
    return (int)cudaGetLastError();
}
