// K10 ct_step: the device-resident conntrack step.
//
// Replaces cilium_tpu/datapath/device_ct.py:166,182 ct_step /
// _ct_step_impl (with _probe :138, _hash_tuple :95, _mix32 :84,
// _flip_kc_words :124) and the CT part of datapath/pipeline.py:406
// process_flows_ct: the allow_new mask, the established override of
// the verdict and redirect, and the per-endpoint counters.
//
// The table is seven [C] int32 arrays (six key words, the expiry), C a
// power of two; a slot is live iff exp > now. Each lane hashes its six
// key words (the murmur3 fmix32 chain) and probes 8 consecutive slots
// (mod C) for the forward tuple, and 8 for the flipped reply tuple
// (sport/dport swapped, direction bit inverted):
//
//   fwd / rep   = first live slot of the window holding the key, or -1
//   established = fwd >= 0 || rep >= 0;  a hit refreshes exp = now + life
//   target      = first slot of the forward window with exp <= now
//   allow_new   = verdict == FORWARD && !redirect && valid
//   insert      = allow_new && !established && target exists
//
// It computes what _ct_step_impl computes under the intended semantics:
// lanes that neither refresh nor insert write nothing (the reference
// writes slot C-1 for them, ROADMAP queue C), and of several lanes that
// insert into one slot the highest lane index wins, which is what the
// reference's scatter keeps. Two entries, one thread per lane:
//
//   ct_probe_claim  probe both windows, refresh the hits, find the
//                   target, and claim it: atomicMax(&owner[slot], lane).
//   ct_commit       the lane with owner[slot] == lane writes the six
//                   words and exp = now + life and resets owner[slot] to
//                   -1; every lane writes its final verdict (FORWARD
//                   when established) and redirect (cleared when
//                   established), and the valid lanes whose ep_idx lies
//                   in [0, EP) are added to the [EP, 3] counters through
//                   a shared histogram, as K4 does, so the integer sums
//                   do not depend on the order of the atomics.
//
// The kernel boundary between the entries is the grid-wide barrier
// between the last claim and the first commit. owner is -1 before and
// after every step. Two races inside ct_probe_claim are harmless:
// - A refresh only rewrites a slot that is already live, to another
//   live value (now + life > now), and two lanes that hit one slot
//   carry the same key and so the same protocol: they write the same
//   value. A probe's match and a free-slot test therefore read the same
//   answer before and after any refresh, which is why the free test
//   can run in this pass, although the reference runs it after the
//   refresh scatter. A free slot is never written in this pass.
// - Claims touch only owner. A losing lane in ct_commit reads either
//   the winner's id or -1, and never its own id.
//
// Bound: bytes, as this run's data needs them. Of each window the step
// must read exp up to its first match (all 8 slots when there is none),
// kc_lo (the first key word compared) of the live slots among those,
// and the five other key words of the matching slot; it writes exp of
// the refreshed slots and all seven words of the inserted ones. Each is
// counted as the distinct 32-byte sectors it falls in, once, plus the
// flows in and the results out once (chip_smoke.py ct_step_bytes). A
// window covers one or two sectors of an array, so on a table whose
// probed slots are mostly expired a window costs one or two sectors of
// exp; one 32-byte record per slot would make that eight.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CT_PROBES = 8;
constexpr int LIFE_TCP_S = 21600;
constexpr int LIFE_OTHER_S = 60;
constexpr int HIST_MAX = 6144;  // shared histogram cells (24 KB)

struct Table {
    int32_t* ka_hi;
    int32_t* ka_lo;
    int32_t* kb_hi;
    int32_t* kb_lo;
    int32_t* kc_hi;
    int32_t* kc_lo;
    int32_t* exp;
    int32_t* owner;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

__device__ __forceinline__ uint32_t hash_tuple(const uint32_t* w) {
    uint32_t h = mix32(w[0]);
#pragma unroll
    for (int k = 1; k < 6; ++k) h = mix32(h ^ w[k]);
    return h;
}

// Plain loads of exp: ct_probe_claim writes it (refreshes) while other
// lanes read it, so it must not go through the read-only cache.
__device__ __forceinline__ bool key_at(const Table& t, uint32_t s, const uint32_t* w) {
    return (uint32_t)t.kc_lo[s] == w[5] && (uint32_t)t.kc_hi[s] == w[4] &&
           (uint32_t)t.kb_lo[s] == w[3] && (uint32_t)t.kb_hi[s] == w[2] &&
           (uint32_t)t.ka_lo[s] == w[1] && (uint32_t)t.ka_hi[s] == w[0];
}

__device__ __forceinline__ void load_words(const int32_t* const* q, int64_t i, uint32_t* w) {
#pragma unroll
    for (int k = 0; k < 6; ++k) w[k] = (uint32_t)q[k][i];
}

struct Query {
    const int32_t* w[6];
};

__global__ void __launch_bounds__(THREADS) ct_probe_claim_kernel(
    Table t, uint32_t cmask, Query q,
    const int32_t* __restrict__ proto,      // [B]
    const int8_t* __restrict__ verdict,     // [B] policy verdict
    const uint8_t* __restrict__ redirect,   // [B]
    const uint8_t* __restrict__ valid,      // [B]
    int now,
    uint8_t* __restrict__ established,      // [B] out
    int32_t* __restrict__ target,           // [B] out: claimed slot or -1
    int64_t b) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= b) return;
    uint32_t w[6];
    load_words(q.w, i, w);

    // forward window: the first live match and the first free slot
    const uint32_t h = hash_tuple(w);
    int fwd = -1, ins = -1;
#pragma unroll
    for (int p = 0; p < CT_PROBES; ++p) {
        const uint32_t s = (h + (uint32_t)p) & cmask;
        if (t.exp[s] > now) {
            if (fwd < 0 && key_at(t, s, w)) fwd = (int)s;
        } else if (ins < 0) {
            ins = (int)s;
        }
    }

    // reply window: the flipped kc words (the JAX _flip_kc_words)
    const uint32_t sp = ((w[4] & 0x1FFu) << 7) | (w[5] >> 25);
    const uint32_t dp = (w[5] >> 9) & 0xFFFFu;
    const uint32_t pr = (w[5] >> 1) & 0xFFu;
    const uint32_t dr = w[5] & 1u;
    const uint32_t ep = w[4] >> 9;
    uint32_t f[6] = {w[0], w[1], w[2], w[3], (ep << 9) | (dp >> 7),
                     ((dp & 0x7Fu) << 25) | (sp << 9) | (pr << 1) | (dr ^ 1u)};
    const uint32_t hr = hash_tuple(f);
    int rep = -1;
#pragma unroll
    for (int p = 0; p < CT_PROBES; ++p) {
        const uint32_t s = (hr + (uint32_t)p) & cmask;
        if (rep < 0 && t.exp[s] > now && key_at(t, s, f)) rep = (int)s;
    }

    const bool est = fwd >= 0 || rep >= 0;
    const int exp_new = now + (proto[i] == 6 ? LIFE_TCP_S : LIFE_OTHER_S);
    if (fwd >= 0) t.exp[fwd] = exp_new;
    if (rep >= 0) t.exp[rep] = exp_new;

    const bool allow = verdict[i] == 1 && !redirect[i] && valid[i];
    int tgt = -1;
    if (allow && !est && ins >= 0) {
        tgt = ins;
        atomicMax(&t.owner[ins], (int)i);
    }
    established[i] = est ? 1 : 0;
    target[i] = tgt;
}

__global__ void __launch_bounds__(THREADS) ct_commit_kernel(
    Table t, Query q,
    const int32_t* __restrict__ proto,        // [B]
    int now,
    const int32_t* __restrict__ target,       // [B]
    const uint8_t* __restrict__ established,  // [B]
    int8_t* __restrict__ verdict,             // [B] in/out
    uint8_t* __restrict__ redirect,           // [B] in/out
    const int32_t* __restrict__ ep_idx,       // [B]
    const uint8_t* __restrict__ valid,        // [B]
    int32_t* __restrict__ counters,           // [EP, 3]
    int ep_count, int shared_hist, int64_t b) {
    extern __shared__ int hist[];
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    const bool live = i < b;
    const int hist_cells = ep_count * 3;
    if (shared_hist) {
        for (int e = threadIdx.x; e < hist_cells; e += THREADS) hist[e] = 0;
        __syncthreads();
    }

    int v = 0;
    if (live) {
        const int s = target[i];
        if (s >= 0 && t.owner[s] == (int)i) {
            uint32_t w[6];
            load_words(q.w, i, w);
            t.ka_hi[s] = (int32_t)w[0];
            t.ka_lo[s] = (int32_t)w[1];
            t.kb_hi[s] = (int32_t)w[2];
            t.kb_lo[s] = (int32_t)w[3];
            t.kc_hi[s] = (int32_t)w[4];
            t.kc_lo[s] = (int32_t)w[5];
            t.exp[s] = now + (proto[i] == 6 ? LIFE_TCP_S : LIFE_OTHER_S);
            t.owner[s] = -1;
        }
        const bool est = established[i] != 0;
        v = est ? 1 : verdict[i];
        verdict[i] = (int8_t)v;
        if (est) redirect[i] = 0;
    }
    const int ep = live ? ep_idx[i] : -1;
    const bool counted = live && valid[i] && ep >= 0 && ep < ep_count && v >= 1 && v <= 3;
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

Table make_table(int32_t* ka_hi, int32_t* ka_lo, int32_t* kb_hi, int32_t* kb_lo,
                 int32_t* kc_hi, int32_t* kc_lo, int32_t* exp, int32_t* owner) {
    return Table{ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo, exp, owner};
}

}  // namespace

CILIUM_API int cilium_ct_probe_claim(
    int32_t* ka_hi, int32_t* ka_lo, int32_t* kb_hi, int32_t* kb_lo, int32_t* kc_hi,
    int32_t* kc_lo, int32_t* exp, int32_t* owner, int64_t c,
    const int32_t* q_ka_hi, const int32_t* q_ka_lo, const int32_t* q_kb_hi,
    const int32_t* q_kb_lo, const int32_t* q_kc_hi, const int32_t* q_kc_lo,
    const int32_t* proto, const int8_t* verdict, const uint8_t* redirect,
    const uint8_t* valid, int now, uint8_t* established, int32_t* target, int64_t b,
    int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    const Table t = make_table(ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo, exp, owner);
    const Query q{{q_ka_hi, q_ka_lo, q_kb_hi, q_kb_lo, q_kc_hi, q_kc_lo}};
    const int64_t blocks = (b + THREADS - 1) / THREADS;
    ct_probe_claim_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        t, (uint32_t)(c - 1), q, proto, verdict, redirect, valid, now, established, target,
        b);
    return (int)cudaGetLastError();
}

CILIUM_API int cilium_ct_commit(
    int32_t* ka_hi, int32_t* ka_lo, int32_t* kb_hi, int32_t* kb_lo, int32_t* kc_hi,
    int32_t* kc_lo, int32_t* exp, int32_t* owner,
    const int32_t* q_ka_hi, const int32_t* q_ka_lo, const int32_t* q_kb_hi,
    const int32_t* q_kb_lo, const int32_t* q_kc_hi, const int32_t* q_kc_lo,
    const int32_t* proto, int now, const int32_t* target, const uint8_t* established,
    int8_t* verdict, uint8_t* redirect, const int32_t* ep_idx, const uint8_t* valid,
    int32_t* counters, int ep_count, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    const Table t = make_table(ka_hi, ka_lo, kb_hi, kb_lo, kc_hi, kc_lo, exp, owner);
    const Query q{{q_ka_hi, q_ka_lo, q_kb_hi, q_kb_lo, q_kc_hi, q_kc_lo}};
    const int shared_hist = ep_count * 3 <= HIST_MAX;
    const size_t smem = shared_hist ? (size_t)ep_count * 3 * sizeof(int) : 0;
    const int64_t blocks = (b + THREADS - 1) / THREADS;
    ct_commit_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
        t, q, proto, now, target, established, verdict, redirect, ep_idx, valid, counters,
        ep_count, shared_hist, b);
    return (int)cudaGetLastError();
}
