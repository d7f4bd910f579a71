// K4 policymap_verdict: per-flow policymap lookup, prefilter override
// and per-endpoint counters.
//
// Replaces cilium_tpu/ops/lookup.py:146 lookup_batch together with the
// tail of datapath/pipeline.py:220 _verdict_tail. Each flow reads its
// identity row of the combined table (allow words ‖ redirect words) and
// tests the columns of that row against the column metadata:
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
// one-hot contraction it replaces.
//
// Attribution mode (cilium_policymap_verdict_attrib) replaces the
// attrib branch of cilium_tpu/ops/lookup.py:202-234 and the rule-hit
// segment-sum of datapath/pipeline.py:267-276, keeping the first
// (lowest-index) column of four classes:
//
//   col = first allowed L4 column, else first allowed column,
//         else first covering L4 column, else first covering column,
//         else -1                       (covering = colsel[c])
//   rule       = col >= 0 ? rule_tab[row, col] : -1
//   rule       = denied_pf ? -1 : rule  (the prefilter drop decided)
//   l4_covered = any covering L4 column
//   hits[min(rule, max(R-1, 0))] += 1 for rule >= 0
//
// Rows. Both entries take the table as a list of row shards (common.cuh
// ShardList; the attribution entry a second list of rule_tab shards
// over the same row ranges): a plain table is one shard [0, N), and on
// the 2D plan the shards of a grid row that all lie on one card are
// read in place, with no gather. A row that no listed shard owns reads
// as no bits; its rule is -1 in direct mode (today's lookup) and, in
// gathered mode, 0 where a column is chosen: the zero row of the
// reference's one-hot contraction (ident_gather=True).
//
// Bound: bytes, at every main-path shape (a 1 048 576-flow batch of
// either entry, a 524 288-flow shard of a 2D batch): per flow 16 bytes
// in (row, ep, port, proto), an optional prefilter byte and 2 bytes
// out; with attribution 5 bytes more out (rule, l4_covered) and one
// rule_tab cell. The table rows (2 048 x 18 words at the bench world)
// and the rule table (2 048 x 288) sit in L2; an operation bound lies
// far below (a few dozen integer operations a flow).
//
// What the design does about the three costs of the first version:
// - A persistent grid (about SMs x occupancy blocks, each walking a
//   grid stride, FPT flows a thread a round) zeroes and flushes the
//   shared counters and rule-hit histogram once per block, not once
//   per 256 flows. FPT = 4 lets one 16-byte load bring a thread's four
//   flows of each input array and keeps four row reads of a thread in
//   flight (the first allow word of every flow is loaded before any is
//   scanned), enough bytes in flight to cover the memory latency at a
//   few blocks an SM.
// - Endpoint column ranges. The materializer lays the columns out
//   endpoint-major with the -1 padding last (cilium_tpu/ops/
//   materialize.py:445-505; the rule deltas keep that or rebuild), so
//   col_ep read as uint32 is non-decreasing. Each block stages the
//   column metadata in shared memory once, checks that order in
//   parallel, and builds per endpoint value e in [0, C) the range
//   [lo, hi) of its columns; any other ep (-1 included, which selects
//   the -1 padding columns as colsel does) binary-searches the staged
//   col_ep. A flow then reads only the allow words that cover its range
//   (about one word of nine at the bench world), a redirect word only
//   when a selected column is allowed, and the attribution entry scans
//   only [lo, hi): the first column of each class is the global first,
//   since no column outside the range has col_ep == ep.
// - When col_ep is not sorted, the same kernel scans the row's set
//   allow bits (attribution: every column) as the first version did,
//   over the staged columns; past COLS_STAGED columns (17 bytes each in
//   shared memory: 68 KB, which leaves room for both histograms in the
//   227 KB a block may have) it stages CHUNK columns a pass.
#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;  // 4-8% faster than 256 on an H100 (tools/k4_probe.py)
constexpr int FPT = 4;                  // flows a thread takes per round
constexpr int COLS_STAGED = 4096;       // columns staged once per block
constexpr int CHUNK = 1024;             // past that: columns staged per pass
constexpr int COL_BYTES = 17;           // ep, port, proto, lo, hi, is_l3
constexpr int HIST_MAX = 6144;          // shared counter cells (24 KB)
constexpr int HITS_SHARED_MAX = 32768;  // shared rule-hit cells (128 KB)
// the most shared memory a launch asks for (220 KB of the 227 KB a block
// may have); each kernel's limit is raised to it once, so a launch that
// needs more than the one before it finds the limit already there
constexpr int SMEM_MAX = (HIST_MAX + HITS_SHARED_MAX) * 4 + COLS_STAGED * COL_BYTES;
static_assert(SMEM_MAX <= 232448, "past the shared memory of one H100 block");

struct Params {
    ShardList bits;   // [rows_k, words] int32 bit views
    ShardList rules;  // [rows_k, c] int32 (attribution), the same row ranges
    int words;        // 2W: allow words ‖ redirect words
    int gathered;     // an unowned row's chosen column gives rule 0, not -1
    const int32_t* col_ep;
    const int32_t* col_port;
    const int32_t* col_proto;
    const uint8_t* col_is_l3;
    int c;
    int staged_all;  // c <= COLS_STAGED
    const int32_t* src;
    const int32_t* ep;
    const int32_t* dport;
    const int32_t* proto;
    const uint8_t* denied;  // [B] or null
    int8_t* verdict;
    uint8_t* redirect;
    int32_t* rule_out;  // attribution
    uint8_t* l4x_out;   // attribution
    int32_t* counters;  // [EP, 3] or null
    int ep_count;
    int shared_counters;
    int32_t* hits;  // [n_hits] or null (attribution)
    int n_hits;
    int shared_hits;
    int vec;  // inputs and outputs aligned for FPT-wide loads and stores
    int64_t b;
    int64_t rounds;
};

struct Staged {
    int* ep;
    int* port;
    int* proto;
    uint16_t* lo;  // per endpoint value e in [0, c): its columns [lo[e], hi[e])
    uint16_t* hi;
    uint8_t* l3;
};

struct Firsts {
    int l4_hit, hit, l4_sel, sel;
};

__device__ __forceinline__ void stage(const Params& p, const Staged& s, int c0, int span) {
    for (int j = threadIdx.x; j < span; j += THREADS) {
        s.ep[j] = __ldg(p.col_ep + c0 + j);
        s.port[j] = __ldg(p.col_port + c0 + j);
        s.proto[j] = __ldg(p.col_proto + c0 + j);
        s.l3[j] = __ldg(p.col_is_l3 + c0 + j);
    }
}

// the columns [lo, hi) whose col_ep equals ep, on a sorted staging
__device__ __forceinline__ void ep_range(const Staged& s, int c, int ep, int& lo, int& hi) {
    if (ep >= 0 && ep < c) {
        lo = s.lo[ep];
        hi = s.hi[ep];
        return;
    }
    const uint32_t key = (uint32_t)ep;
    int a = 0, z = c;
    while (a < z) {
        const int m = (a + z) >> 1;
        if ((uint32_t)s.ep[m] < key) a = m + 1; else z = m;
    }
    lo = a;
    z = c;
    while (a < z) {
        const int m = (a + z) >> 1;
        if ((uint32_t)s.ep[m] <= key) a = m + 1; else z = m;
    }
    hi = a;
}

// the row of `row` in the shard that owns it (null when none does)
template <bool ATTRIB>
__device__ __forceinline__ void row_ptrs(const Params& p, int row, const uint32_t*& bits,
                                         const int32_t*& rules) {
    bits = nullptr;
    rules = nullptr;
    if (p.bits.n == 1) {  // a plain table: no walk over the list
        const int64_t r = (int64_t)row - p.bits.row_lo[0];
        if (r >= 0 && r < p.bits.rows[0]) {
            bits = reinterpret_cast<const uint32_t*>(p.bits.ptr[0]) + r * p.words;
            if (ATTRIB) rules = p.rules.ptr[0] + r * p.c;
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < MAX_SHARDS; ++k) {
        if (k >= p.bits.n) break;
        const int64_t r = (int64_t)row - p.bits.row_lo[k];
        if (r >= 0 && r < p.bits.rows[k]) {
            bits = reinterpret_cast<const uint32_t*>(p.bits.ptr[k]) + r * p.words;
            if (ATTRIB) rules = p.rules.ptr[k] + r * p.c;
        }
    }
}

// allow / redirect over the columns [lo, hi) of a row (staged from c0);
// aw0 / rw0 are the row's allow and redirect words lo >> 5, loaded by
// the caller. CHECK_EP tests col_ep (the general path); a range holds
// only ep's columns.
template <bool CHECK_EP>
__device__ __forceinline__ void verdict_cols(const uint32_t* rowp, int w, const Staged& s, int c0,
                                             int lo, int hi, uint32_t aw0, uint32_t rw0, int ep,
                                             int port, int prt, bool& allow, bool& red) {
    if (rowp == nullptr || red || lo >= hi) return;
    for (int wd = lo >> 5; wd <= (hi - 1) >> 5; ++wd) {
        const int base = wd << 5;
        const bool first = wd == (lo >> 5);
        uint32_t aw = first ? aw0 : __ldg(rowp + wd);
        if (lo > base) aw &= ~0u << (lo - base);
        if (hi - base < 32) aw &= (1u << (hi - base)) - 1u;
        uint32_t rw = rw0;
        bool have_rw = first;
        while (aw) {
            const int bit = __ffs(aw) - 1;
            aw &= aw - 1;
            const int j = base + bit - c0;
            if (CHECK_EP && ep != s.ep[j]) continue;
            if (s.l3[j] || (port == s.port[j] && prt == s.proto[j])) {
                allow = true;
                if (!have_rw) {
                    rw = __ldg(rowp + w + wd);
                    have_rw = true;
                }
                if ((rw >> bit) & 1u) {
                    red = true;
                    return;
                }
            }
        }
    }
}

// the attribution scan of the columns [lo, hi) (staged from c0)
template <bool CHECK_EP>
__device__ __forceinline__ void attrib_cols(const uint32_t* rowp, int w, const Staged& s, int c0,
                                            int lo, int hi, uint32_t aw0, uint32_t rw0, int ep,
                                            int port, int prt, bool& allow, bool& red, Firsts& f) {
    uint32_t aw = aw0, rw = rw0;
    bool have_rw = true;
    for (int cc = lo; cc < hi; ++cc) {
        if ((cc & 31) == 0 && cc != lo) {
            aw = rowp != nullptr ? __ldg(rowp + (cc >> 5)) : 0u;
            have_rw = false;
        }
        const int j = cc - c0;
        if (CHECK_EP && ep != s.ep[j]) continue;
        const bool l3 = s.l3[j] != 0;
        if (!l3 && (port != s.port[j] || prt != s.proto[j])) continue;
        if (f.sel < 0) f.sel = cc;
        if (!l3 && f.l4_sel < 0) f.l4_sel = cc;
        const int bit = cc & 31;
        if ((aw >> bit) & 1u) {
            allow = true;
            if (f.hit < 0) f.hit = cc;
            if (!l3 && f.l4_hit < 0) f.l4_hit = cc;
            if (!red) {
                if (!have_rw) {
                    rw = __ldg(rowp + w + (cc >> 5));
                    have_rw = true;
                }
                if ((rw >> bit) & 1u) red = true;
            }
        }
    }
}

__device__ __forceinline__ void load_i32(const int32_t* a, int64_t i0, int64_t b, bool full,
                                         int (&out)[FPT]) {
    if (full) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(a + i0));
        out[0] = v.x;
        out[1] = v.y;
        out[2] = v.z;
        out[3] = v.w;
    } else {
#pragma unroll
        for (int f = 0; f < FPT; ++f) out[f] = i0 + f < b ? __ldg(a + i0 + f) : 0;
    }
}

template <bool ATTRIB>
__global__ void __launch_bounds__(THREADS) policymap_verdict_kernel(const __grid_constant__ Params p) {
    extern __shared__ int smem[];
    const int cnt_cells = p.shared_counters ? p.ep_count * 3 : 0;
    const int hit_cells = ATTRIB && p.shared_hits ? p.n_hits : 0;
    int* s_cnt = smem;
    int* s_hits = smem + cnt_cells;
    const int cs = p.staged_all ? p.c : CHUNK;
    Staged s;
    s.ep = s_hits + hit_cells;
    s.port = s.ep + cs;
    s.proto = s.port + cs;
    s.lo = reinterpret_cast<uint16_t*>(s.proto + cs);
    s.hi = s.lo + cs;
    s.l3 = reinterpret_cast<uint8_t*>(s.hi + cs);
    for (int e = threadIdx.x; e < cnt_cells + hit_cells; e += THREADS) smem[e] = 0;

    bool sorted = false;
    if (p.staged_all) {
        stage(p, s, 0, p.c);
        __syncthreads();
        bool ok = true;
        for (int j = threadIdx.x + 1; j < p.c; j += THREADS) {
            ok = ok && (uint32_t)s.ep[j - 1] <= (uint32_t)s.ep[j];
        }
        sorted = __syncthreads_and(ok) != 0;
        if (sorted) {
            for (int j = threadIdx.x; j < p.c; j += THREADS) s.lo[j] = s.hi[j] = 0;
            __syncthreads();
            for (int j = threadIdx.x; j < p.c; j += THREADS) {
                const int e = s.ep[j];
                if (e < 0 || e >= p.c) continue;
                if (j == 0 || s.ep[j - 1] != e) s.lo[e] = (uint16_t)j;
                if (j == p.c - 1 || s.ep[j + 1] != e) s.hi[e] = (uint16_t)(j + 1);
            }
        }
    }
    __syncthreads();

    int* cnt = p.counters == nullptr ? nullptr : p.shared_counters ? s_cnt : p.counters;
    int* hit = !ATTRIB || p.hits == nullptr ? nullptr : p.shared_hits ? s_hits : p.hits;
    const int w = p.words / 2;
    for (int64_t r = 0; r < p.rounds; ++r) {
        const int64_t i0 = ((r * gridDim.x + blockIdx.x) * THREADS + threadIdx.x) * FPT;
        const bool full = p.vec && i0 + FPT <= p.b;
        int row[FPT], ep[FPT], port[FPT], prt[FPT];
        load_i32(p.src, i0, p.b, full, row);
        load_i32(p.ep, i0, p.b, full, ep);
        load_i32(p.dport, i0, p.b, full, port);
        load_i32(p.proto, i0, p.b, full, prt);
        bool dn[FPT];
        if (p.denied == nullptr) {
#pragma unroll
            for (int f = 0; f < FPT; ++f) dn[f] = false;
        } else if (full) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(p.denied + i0);
#pragma unroll
            for (int f = 0; f < FPT; ++f) dn[f] = ((v >> (8 * f)) & 0xFFu) != 0;
        } else {
#pragma unroll
            for (int f = 0; f < FPT; ++f) dn[f] = i0 + f < p.b && p.denied[i0 + f] != 0;
        }

        const uint32_t* bits[FPT];
        const int32_t* rules[FPT];
        bool allow[FPT], red[FPT];
        Firsts fs[FPT];
#pragma unroll
        for (int f = 0; f < FPT; ++f) {
            row_ptrs<ATTRIB>(p, row[f], bits[f], rules[f]);
            if (i0 + f >= p.b) bits[f] = nullptr;
            allow[f] = red[f] = false;
            fs[f] = Firsts{-1, -1, -1, -1};
        }

        if (sorted) {
            // every flow's first allow word is asked for before any is
            // scanned (FPT reads in flight a thread), then its redirect
            // word only where an allow bit of its range is set: random
            // 4-byte reads cost L1 a pass each, and most flows allow
            // nothing
            int lo[FPT], hi[FPT];
            uint32_t aw0[FPT], rw0[FPT];
#pragma unroll
            for (int f = 0; f < FPT; ++f) {
                ep_range(s, p.c, ep[f], lo[f], hi[f]);
                if (i0 + f >= p.b) hi[f] = lo[f];
                const bool rd = bits[f] != nullptr && lo[f] < hi[f];
                aw0[f] = rd ? __ldg(bits[f] + (lo[f] >> 5)) : 0u;
            }
#pragma unroll
            for (int f = 0; f < FPT; ++f) {
                const int base = lo[f] & ~31;
                uint32_t in_range = aw0[f] & (~0u << (lo[f] - base));
                if (hi[f] - base < 32) in_range &= (1u << (hi[f] - base)) - 1u;
                rw0[f] = in_range ? __ldg(bits[f] + w + (lo[f] >> 5)) : 0u;
            }
#pragma unroll
            for (int f = 0; f < FPT; ++f) {
                if (ATTRIB) {
                    attrib_cols<false>(bits[f], w, s, 0, lo[f], hi[f], aw0[f], rw0[f], ep[f],
                                       port[f], prt[f], allow[f], red[f], fs[f]);
                } else {
                    verdict_cols<false>(bits[f], w, s, 0, lo[f], hi[f], aw0[f], rw0[f], ep[f],
                                        port[f], prt[f], allow[f], red[f]);
                }
            }
        } else {
            for (int c0 = 0; c0 < p.c; c0 += cs) {
                const int span = min(cs, p.c - c0);
                if (!p.staged_all) {
                    __syncthreads();
                    stage(p, s, c0, span);
                    __syncthreads();
                }
#pragma unroll
                for (int f = 0; f < FPT; ++f) {
                    if (i0 + f >= p.b) continue;
                    const bool rd = bits[f] != nullptr;
                    const uint32_t aw0 = rd ? __ldg(bits[f] + (c0 >> 5)) : 0u;
                    const uint32_t rw0 = rd ? __ldg(bits[f] + w + (c0 >> 5)) : 0u;
                    if (ATTRIB) {
                        attrib_cols<true>(bits[f], w, s, c0, c0, c0 + span, aw0, rw0, ep[f],
                                          port[f], prt[f], allow[f], red[f], fs[f]);
                    } else {
                        verdict_cols<true>(bits[f], w, s, c0, c0, c0 + span, aw0, rw0, ep[f],
                                           port[f], prt[f], allow[f], red[f]);
                    }
                }
            }
        }

        int8_t v[FPT];
        int rule[FPT];
        int col[FPT];
#pragma unroll
        for (int f = 0; f < FPT; ++f) {
            v[f] = dn[f] ? 3 : allow[f] ? 1 : 2;
            if (dn[f]) red[f] = false;
            if (ATTRIB) {
                const Firsts& x = fs[f];
                col[f] = x.l4_hit >= 0 ? x.l4_hit : allow[f] ? x.hit : x.l4_sel >= 0 ? x.l4_sel : x.sel;
            }
        }
        if (ATTRIB) {
#pragma unroll
            for (int f = 0; f < FPT; ++f) {
                rule[f] = col[f] < 0 || dn[f] ? -1
                          : rules[f] != nullptr ? __ldg(rules[f] + col[f])
                          : p.gathered ? 0 : -1;
            }
        }
        if (full) {
            uint32_t pv = 0, pr = 0, pl = 0;
#pragma unroll
            for (int f = 0; f < FPT; ++f) {
                pv |= (uint32_t)(uint8_t)v[f] << (8 * f);
                pr |= (uint32_t)red[f] << (8 * f);
                if (ATTRIB) pl |= (uint32_t)(fs[f].l4_sel >= 0) << (8 * f);
            }
            *reinterpret_cast<uint32_t*>(p.verdict + i0) = pv;
            *reinterpret_cast<uint32_t*>(p.redirect + i0) = pr;
            if (ATTRIB) {
                *reinterpret_cast<int4*>(p.rule_out + i0) = make_int4(rule[0], rule[1], rule[2], rule[3]);
                *reinterpret_cast<uint32_t*>(p.l4x_out + i0) = pl;
            }
        } else {
#pragma unroll
            for (int f = 0; f < FPT; ++f) {
                if (i0 + f >= p.b) continue;
                p.verdict[i0 + f] = v[f];
                p.redirect[i0 + f] = red[f] ? 1 : 0;
                if (ATTRIB) {
                    p.rule_out[i0 + f] = rule[f];
                    p.l4x_out[i0 + f] = fs[f].l4_sel >= 0 ? 1 : 0;
                }
            }
        }
#pragma unroll
        for (int f = 0; f < FPT; ++f) {
            if (i0 + f >= p.b) continue;
            if (cnt != nullptr && ep[f] >= 0 && ep[f] < p.ep_count) {
                atomicAdd(&cnt[ep[f] * 3 + (v[f] - 1)], 1);
            }
            if (ATTRIB && hit != nullptr && rule[f] >= 0) {
                atomicAdd(&hit[min(rule[f], max(p.n_hits - 1, 0))], 1);
            }
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < cnt_cells; e += THREADS) {
        if (s_cnt[e]) atomicAdd(&p.counters[e], s_cnt[e]);
    }
    for (int e = threadIdx.x; e < hit_cells; e += THREADS) {
        if (s_hits[e]) atomicAdd(&p.hits[e], s_hits[e]);
    }
}

bool aligned(const void* ptr, int bytes) { return ((uintptr_t)ptr % bytes) == 0; }

// SM count and blocks an SM holds, per (device, entry, shared bytes):
// asked once, not at every launch
std::mutex cache_mu;
struct Fit {
    int device, attrib;
    size_t smem;
    int sms, per_sm;
};
Fit fits[32];
int n_fits = 0;

template <bool ATTRIB>
int grid_fit(int device, size_t smem, int& sms, int& per_sm) {
    std::lock_guard<std::mutex> hold(cache_mu);
    for (int i = 0; i < n_fits; ++i) {
        if (fits[i].device == device && fits[i].attrib == ATTRIB && fits[i].smem == smem) {
            sms = fits[i].sms;
            per_sm = fits[i].per_sm;
            return 0;
        }
    }
    auto kern = policymap_verdict_kernel<ATTRIB>;
    int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err) return err;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err) return err;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (err) return err;
    if (n_fits < 32) fits[n_fits++] = Fit{device, ATTRIB, smem, sms, per_sm};
    return 0;
}

template <bool ATTRIB>
int launch(Params& p, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (p.bits.n < 1 || p.bits.n > MAX_SHARDS) return (int)cudaErrorInvalidValue;
    if (ATTRIB && p.rules.n != p.bits.n) return (int)cudaErrorInvalidValue;
    // report this launch's error, not one an earlier runtime call left
    // behind (a sticky fault stays and shows after the launch)
    (void)cudaGetLastError();
    if (p.b == 0) return 0;
    p.staged_all = p.c <= COLS_STAGED;
    p.shared_counters = p.counters != nullptr && p.ep_count * 3 <= HIST_MAX;
    p.shared_hits = ATTRIB && p.hits != nullptr && p.n_hits <= HITS_SHARED_MAX;
    const int cs = p.staged_all ? p.c : CHUNK;
    const size_t smem = (size_t)((p.shared_counters ? p.ep_count * 3 : 0) +
                                 (p.shared_hits ? p.n_hits : 0)) * sizeof(int) +
                        (size_t)cs * COL_BYTES;
    p.vec = aligned(p.src, 16) && aligned(p.ep, 16) && aligned(p.dport, 16) &&
            aligned(p.proto, 16) && aligned(p.denied, 4) && aligned(p.verdict, 4) &&
            aligned(p.redirect, 4) && aligned(p.rule_out, 16) && aligned(p.l4x_out, 4);
    int sms = 0, per_sm = 0;
    err = grid_fit<ATTRIB>(device, smem, sms, per_sm);
    if (err) return err;
    const int64_t per_block = (int64_t)THREADS * FPT;
    const int64_t blocks = std::min<int64_t>((p.b + per_block - 1) / per_block,
                                             (int64_t)sms * std::max(per_sm, 1));
    p.rounds = (p.b + blocks * per_block - 1) / (blocks * per_block);
    policymap_verdict_kernel<ATTRIB><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

Params columns(ShardList bits, int words, int gathered, const int32_t* col_ep,
               const int32_t* col_port, const int32_t* col_proto, const uint8_t* col_is_l3,
               int c, const int32_t* src_rows, const int32_t* ep_idx, const int32_t* dport,
               const int32_t* proto, const uint8_t* denied_pf, int8_t* verdict,
               uint8_t* redirect, int32_t* counters, int ep_count, int64_t b) {
    Params p{};
    p.bits = bits;
    p.words = words;
    p.gathered = gathered;
    p.col_ep = col_ep;
    p.col_port = col_port;
    p.col_proto = col_proto;
    p.col_is_l3 = col_is_l3;
    p.c = c;
    p.src = src_rows;
    p.ep = ep_idx;
    p.dport = dport;
    p.proto = proto;
    p.denied = denied_pf;
    p.verdict = verdict;
    p.redirect = redirect;
    p.counters = counters;
    p.ep_count = ep_count;
    p.b = b;
    return p;
}

}  // namespace

CILIUM_API int cilium_policymap_verdict(
    ShardList bits, int words, int gathered, const int32_t* col_ep, const int32_t* col_port,
    const int32_t* col_proto, const uint8_t* col_is_l3, int c, const int32_t* src_rows,
    const int32_t* ep_idx, const int32_t* dport, const int32_t* proto,
    const uint8_t* denied_pf, int8_t* verdict, uint8_t* redirect, int32_t* counters,
    int ep_count, int64_t b, int device, void* stream) {
    Params p = columns(bits, words, gathered, col_ep, col_port, col_proto, col_is_l3, c,
                       src_rows, ep_idx, dport, proto, denied_pf, verdict, redirect, counters,
                       ep_count, b);
    return launch<false>(p, device, stream);
}

CILIUM_API int cilium_policymap_verdict_attrib(
    ShardList bits, ShardList rules, int words, int gathered, const int32_t* col_ep,
    const int32_t* col_port, const int32_t* col_proto, const uint8_t* col_is_l3, int c,
    const int32_t* src_rows, const int32_t* ep_idx, const int32_t* dport,
    const int32_t* proto, const uint8_t* denied_pf, int8_t* verdict, uint8_t* redirect,
    int32_t* rule_out, uint8_t* l4x_out, int32_t* counters, int ep_count, int32_t* hits,
    int n_hits, int64_t b, int device, void* stream) {
    Params p = columns(bits, words, gathered, col_ep, col_port, col_proto, col_is_l3, c,
                       src_rows, ep_idx, dport, proto, denied_pf, verdict, redirect, counters,
                       ep_count, b);
    p.rules = rules;
    p.rule_out = rule_out;
    p.l4x_out = l4x_out;
    p.hits = hits;
    p.n_hits = n_hits;
    return launch<true>(p, device, stream);
}
