// K9 lb_translate: VIP -> backend translation of the egress LB stage.
//
// Replaces cilium_tpu/lb/device.py:51 lb_translate (bpf/lib/lb.h
// lb4_lookup_service / lb4_local). The function, the address width L (4
// or 16 int32 bytes) a template parameter:
//
//   fe   = lowest frontend f with fe_port[f] == dport,
//          fe_proto[f] in {0, proto} and
//          fe_bytes[f, :] == peer[:]            (0 when none matches)
//   slen = fe_seq_len[fe]
//   idx  = fhash floor-mod max(slen, 1)         (sign of the divisor)
//   be   = fe_seq[fe, min(idx, S - 1)]
//   ok   = hit && slen > 0;  no_backend = hit && slen == 0
//   new_bytes / new_port = be's row when ok, else the input
//   revnat = fe_revnat[fe] when hit (a no-backend frontend included)
//
// The JAX step takes jnp.argmax of the [B, F] match row, so the lowest
// matching index wins. Its gathers are plain x[idx] gathers, which count
// a negative index from the end and then clamp into the table; the
// kernel does the same with be, so it never reads out of bounds. F, NB
// and S are never 0 (the wrapper refuses them; the pipeline skips a
// family with no frontends).
//
// Two entries, one launch each per call, as the reference's datapath
// finds a service with one hash-map probe (lb4_lookup_service) where the
// JAX step compares every flow with every frontend:
//
//   lb_index_build  one thread per frontend inserts its key (the L
//                   address words, the port and fe_proto, hashed as full
//                   32-bit words: a word outside [0, 255] aliases no
//                   other) into an open-addressing index of N >= 2F
//                   slots (a power of two), which the entry first fills
//                   with -1 (one memset on the stream).
//                   A slot is claimed with atomicCAS(-1 -> f); a slot
//                   whose frontend carries an equal key takes
//                   atomicMin(f); any other slot sends the thread on to
//                   the next (linear probing). A slot's key never
//                   changes once claimed (only equal keys lower its
//                   value), so every thread of one key stops at the same
//                   slot, which ends holding that key's lowest frontend;
//                   the load is at most 1/2, so every chain ends in an
//                   empty slot.
//   lb_translate    one thread per flow probes the key (peer, dport,
//                   proto) and, when proto != 0, (peer, dport, 0): each
//                   probe walks the chain from the key's home slot,
//                   compares the flow with the candidate frontend's row
//                   and stops at a match or an empty slot. The smaller
//                   of the two frontends found is the lowest matching
//                   one. Then the selection and the backend gathers.
//
// Bound: bytes. The function reads the flows (peer, dport, proto, fhash)
// and writes the results once, and reads the small tables; the index and
// the tables (8 KB and 49 KB at the bench's 1 024 v4 frontends) stay in
// L2, so a flow costs its own bytes and O(1) expected dependent L2 reads
// where a scan made O(F) compares. Rows move in 16-byte loads and stores
// when every address table is 16-byte aligned.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// the hash of a key's address words and port; the protocol is mixed in
// last, so a flow hashes its address once for both of its probes
template <int L>
__device__ __forceinline__ uint32_t addr_port_hash(const int32_t* a, int32_t port) {
    uint32_t h = mix32((uint32_t)a[0]);
#pragma unroll
    for (int k = 1; k < L; ++k) h = mix32(h ^ (uint32_t)a[k]);
    return mix32(h ^ (uint32_t)port);
}

__device__ __forceinline__ uint32_t key_hash(uint32_t addr_port, int32_t proto) {
    return mix32(addr_port ^ (uint32_t)proto);
}

template <int L, bool VEC>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src, int32_t* a) {
    if (VEC) {
#pragma unroll
        for (int k = 0; k < L; k += 4) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(src + k));
            a[k] = v.x;
            a[k + 1] = v.y;
            a[k + 2] = v.z;
            a[k + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < L; ++k) a[k] = __ldg(src + k);
    }
}

template <int L, bool VEC>
__device__ __forceinline__ void store_row(int32_t* __restrict__ dst, const int32_t* a) {
    if (VEC) {
#pragma unroll
        for (int k = 0; k < L; k += 4)
            *reinterpret_cast<int4*>(dst + k) = make_int4(a[k], a[k + 1], a[k + 2], a[k + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < L; ++k) dst[k] = a[k];
    }
}

// does frontend g carry the key (a, port, proto)?
template <int L, bool VEC>
__device__ __forceinline__ bool key_is(const int32_t* __restrict__ fe_bytes,
                                       const int32_t* __restrict__ fe_port,
                                       const int32_t* __restrict__ fe_proto, int g,
                                       const int32_t* a, int32_t port, int32_t proto) {
    if (__ldg(fe_port + g) != port || __ldg(fe_proto + g) != proto) return false;
    int32_t r[L];
    load_row<L, VEC>(fe_bytes + (int64_t)g * L, r);
    bool eq = true;
#pragma unroll
    for (int k = 0; k < L; ++k) eq = eq && r[k] == a[k];
    return eq;
}

template <int L, bool VEC>
__global__ void __launch_bounds__(THREADS) lb_index_build_kernel(
    const int32_t* __restrict__ fe_bytes,    // [F, L]
    const int32_t* __restrict__ fe_port,     // [F]
    const int32_t* __restrict__ fe_proto,    // [F]
    int f,
    int32_t* __restrict__ index,             // [N] -1 = empty, else a frontend
    uint32_t nmask) {
    const int g = blockIdx.x * THREADS + threadIdx.x;
    if (g >= f) return;
    int32_t a[L];
    load_row<L, VEC>(fe_bytes + (int64_t)g * L, a);
    const int32_t port = __ldg(fe_port + g), proto = __ldg(fe_proto + g);
    uint32_t s = key_hash(addr_port_hash<L>(a, port), proto) & nmask;
    for (uint32_t n = 0; n <= nmask; ++n, s = (s + 1) & nmask) {
        const int cur = atomicCAS(index + s, -1, g);
        if (cur < 0) return;  // claimed
        if (key_is<L, VEC>(fe_bytes, fe_port, fe_proto, cur, a, port, proto)) {
            atomicMin(index + s, g);
            return;
        }
    }
}

// the frontend the index holds for the key, or INT_MAX when it has none;
// the index was written by the launch before, so it is read-only here
template <int L, bool VEC>
__device__ __forceinline__ int probe(const int32_t* __restrict__ index, uint32_t nmask,
                                     const int32_t* __restrict__ fe_bytes,
                                     const int32_t* __restrict__ fe_port,
                                     const int32_t* __restrict__ fe_proto,
                                     uint32_t h, const int32_t* a, int32_t port, int32_t proto) {
    uint32_t s = h & nmask;
    for (uint32_t n = 0; n <= nmask; ++n, s = (s + 1) & nmask) {
        const int g = __ldg(index + s);
        if (g < 0) break;
        if (key_is<L, VEC>(fe_bytes, fe_port, fe_proto, g, a, port, proto)) return g;
    }
    return 0x7FFFFFFF;
}

template <int L, bool VEC>
__global__ void __launch_bounds__(THREADS) lb_translate_kernel(
    const int32_t* __restrict__ index,       // [N]
    uint32_t nmask,
    const int32_t* __restrict__ fe_bytes,    // [F, L]
    const int32_t* __restrict__ fe_port,     // [F]
    const int32_t* __restrict__ fe_proto,    // [F]
    const int32_t* __restrict__ fe_seq,      // [F, S]
    int s,
    const int32_t* __restrict__ fe_seq_len,  // [F]
    const int32_t* __restrict__ fe_revnat,   // [F]
    const int32_t* __restrict__ be_bytes,    // [NB, L]
    const int32_t* __restrict__ be_port,     // [NB]
    int nb,
    const int32_t* __restrict__ peer,        // [B, L]
    const int32_t* __restrict__ dport,       // [B]
    const int32_t* __restrict__ proto,       // [B]
    const int32_t* __restrict__ fhash,       // [B]
    int32_t* __restrict__ new_bytes,         // [B, L]
    int32_t* __restrict__ new_port,          // [B]
    int32_t* __restrict__ revnat,            // [B]
    uint8_t* __restrict__ ok_out,            // [B] bool
    uint8_t* __restrict__ no_backend_out,    // [B] bool
    int64_t b) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= b) return;
    int32_t a[L];
    load_row<L, VEC>(peer + i * L, a);
    const int32_t dp = __ldg(dport + i), pr = __ldg(proto + i);
    const int32_t fh = __ldg(fhash + i);

    const uint32_t hap = addr_port_hash<L>(a, dp);
    int found = probe<L, VEC>(index, nmask, fe_bytes, fe_port, fe_proto, key_hash(hap, pr), a,
                              dp, pr);
    if (pr != 0)
        found = min(found, probe<L, VEC>(index, nmask, fe_bytes, fe_port, fe_proto,
                                         key_hash(hap, 0), a, dp, 0));

    const bool hit = found != 0x7FFFFFFF;
    const int fe = hit ? found : 0;
    const int slen = __ldg(fe_seq_len + fe);
    const int m = slen > 1 ? slen : 1;
    int idx = fh % m;
    if (idx < 0) idx += m;  // floor modulo: m > 0
    if (idx > s - 1) idx = s - 1;
    int be = __ldg(fe_seq + (int64_t)fe * s + idx);
    if (be < 0) be += nb;
    be = be < 0 ? 0 : (be > nb - 1 ? nb - 1 : be);
    const bool ok = hit && slen > 0;
    if (ok) load_row<L, VEC>(be_bytes + (int64_t)be * L, a);
    store_row<L, VEC>(new_bytes + i * L, a);
    new_port[i] = ok ? __ldg(be_port + be) : dp;
    revnat[i] = hit ? __ldg(fe_revnat + fe) : 0;
    ok_out[i] = ok;
    no_backend_out[i] = hit && slen == 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool valid_slots(int64_t n, int f) {
    return n >= 2 * (int64_t)f && (n & (n - 1)) == 0 && n <= (int64_t)1 << 30;
}

}  // namespace

CILIUM_API int cilium_lb_index_build(
    const int32_t* fe_bytes, const int32_t* fe_port, const int32_t* fe_proto, int f, int l,
    int32_t* index, int64_t n_slots, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    (void)cudaGetLastError();  // a stale error is not this launch's
    if (f <= 0 || (l != 4 && l != 16) || !valid_slots(n_slots, f))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    err = (int)cudaMemsetAsync(index, 0xFF, (size_t)n_slots * sizeof(int32_t), st);  // all -1
    if (err) return err;
    const unsigned blocks = (unsigned)((f + THREADS - 1) / THREADS);
    const uint32_t nmask = (uint32_t)(n_slots - 1);
    const bool vec = aligned16(fe_bytes);
    if (l == 4) {
        if (vec) lb_index_build_kernel<4, true><<<blocks, THREADS, 0, st>>>(
            fe_bytes, fe_port, fe_proto, f, index, nmask);
        else lb_index_build_kernel<4, false><<<blocks, THREADS, 0, st>>>(
            fe_bytes, fe_port, fe_proto, f, index, nmask);
    } else {
        if (vec) lb_index_build_kernel<16, true><<<blocks, THREADS, 0, st>>>(
            fe_bytes, fe_port, fe_proto, f, index, nmask);
        else lb_index_build_kernel<16, false><<<blocks, THREADS, 0, st>>>(
            fe_bytes, fe_port, fe_proto, f, index, nmask);
    }
    return (int)cudaGetLastError();
}

CILIUM_API int cilium_lb_translate(
    const int32_t* index, int64_t n_slots,
    const int32_t* fe_bytes, const int32_t* fe_port, const int32_t* fe_proto,
    const int32_t* fe_seq, int s, const int32_t* fe_seq_len, const int32_t* fe_revnat,
    int f, const int32_t* be_bytes, const int32_t* be_port, int nb, int l,
    const int32_t* peer, const int32_t* dport, const int32_t* proto, const int32_t* fhash,
    int32_t* new_bytes, int32_t* new_port, int32_t* revnat, uint8_t* ok,
    uint8_t* no_backend, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    (void)cudaGetLastError();  // a stale error is not this launch's
    if (b == 0) return 0;
    if (f <= 0 || nb <= 0 || s <= 0 || (l != 4 && l != 16) || !valid_slots(n_slots, f))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (b + THREADS - 1) / THREADS;
    const uint32_t nmask = (uint32_t)(n_slots - 1);
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec = aligned16(fe_bytes) && aligned16(be_bytes) && aligned16(peer) &&
                     aligned16(new_bytes);
#define LB_LAUNCH(LL, V)                                                                   \
    lb_translate_kernel<LL, V><<<(unsigned)blocks, THREADS, 0, st>>>(                     \
        index, nmask, fe_bytes, fe_port, fe_proto, fe_seq, s, fe_seq_len, fe_revnat,      \
        be_bytes, be_port, nb, peer, dport, proto, fhash, new_bytes, new_port, revnat, ok, \
        no_backend, b)
    if (l == 4) {
        if (vec) LB_LAUNCH(4, true);
        else LB_LAUNCH(4, false);
    } else {
        if (vec) LB_LAUNCH(16, true);
        else LB_LAUNCH(16, false);
    }
#undef LB_LAUNCH
    return (int)cudaGetLastError();
}
