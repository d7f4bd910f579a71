// K9 lb_translate: VIP -> backend translation of the egress LB stage.
//
// Replaces cilium_tpu/lb/device.py:51 lb_translate (bpf/lib/lb.h
// lb4_lookup_service / lb4_local). One thread per flow, the address
// width L (4 or 16 int32 bytes) a template parameter:
//
//   fe   = first frontend f with fe_port[f] == dport,
//          (fe_proto[f] == 0 || fe_proto[f] == proto) and
//          fe_bytes[f, :] == peer[:]            (0 when none matches)
//   slen = fe_seq_len[fe]
//   idx  = fhash floor-mod max(slen, 1)         (sign of the divisor)
//   be   = fe_seq[fe, min(idx, S - 1)]
//   ok   = hit && slen > 0;  no_backend = hit && slen == 0
//   new_bytes / new_port = be's row when ok, else the input
//   revnat = fe_revnat[fe] when hit (a no-backend frontend included)
//
// The JAX step takes jnp.argmax of the [B, F] match row, so the lowest
// matching index wins: the scan stops at the first match. Its gathers
// are plain x[idx] gathers, which count a negative index from the end
// and then clamp into the table; the kernel does the same with be, so
// it never reads out of bounds. F, NB and S are never 0 (the wrapper
// refuses them; the pipeline skips a family with no frontends).
//
// Bound: operations. Each flow compares its port, protocol and L bytes
// against every frontend up to its first match (all F when it matches
// none), int32 compares on the CUDA cores; the bytes moved (the flow
// in, the result out, the small tables) are far fewer. The frontend
// columns are staged through shared memory in tiles of TILE, so each
// block reads each table entry once; the compare checks the port
// first, which rejects most frontends with one load, and the block
// stops loading tiles once every live thread has found its frontend.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;

template <int L>
__global__ void __launch_bounds__(THREADS) lb_translate_kernel(
    const int32_t* __restrict__ fe_bytes,    // [F, L]
    const int32_t* __restrict__ fe_port,     // [F]
    const int32_t* __restrict__ fe_proto,    // [F]
    const int32_t* __restrict__ fe_seq,      // [F, S]
    int s,
    const int32_t* __restrict__ fe_seq_len,  // [F]
    const int32_t* __restrict__ fe_revnat,   // [F]
    int f,
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
    __shared__ int32_t s_bytes[TILE * L];
    __shared__ int32_t s_port[TILE];
    __shared__ int32_t s_proto[TILE];

    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    const bool live = i < b;
    int32_t a[L];
    int32_t dp = 0, pr = 0;
    if (live) {
#pragma unroll
        for (int k = 0; k < L; ++k) a[k] = __ldg(peer + i * L + k);
        dp = __ldg(dport + i);
        pr = __ldg(proto + i);
    }
    int found = live ? -1 : 0;  // a dead lane never holds the block
    for (int base = 0; base < f; base += TILE) {
        if (!__syncthreads_or(found < 0)) break;
        const int n = min(TILE, f - base);
        for (int j = threadIdx.x; j < n * L; j += THREADS)
            s_bytes[j] = __ldg(fe_bytes + (int64_t)base * L + j);
        for (int j = threadIdx.x; j < n; j += THREADS) {
            s_port[j] = __ldg(fe_port + base + j);
            s_proto[j] = __ldg(fe_proto + base + j);
        }
        __syncthreads();
        if (found < 0) {
            for (int j = 0; j < n; ++j) {
                if (s_port[j] != dp) continue;
                const int fp = s_proto[j];
                if (fp != 0 && fp != pr) continue;
                bool eq = true;
#pragma unroll
                for (int k = 0; k < L; ++k) eq = eq && s_bytes[j * L + k] == a[k];
                if (eq) {
                    found = base + j;
                    break;
                }
            }
        }
        __syncthreads();
    }
    if (!live) return;

    const bool hit = found >= 0;
    const int fe = hit ? found : 0;
    const int slen = __ldg(fe_seq_len + fe);
    const int m = slen > 1 ? slen : 1;
    int idx = __ldg(fhash + i) % m;
    if (idx < 0) idx += m;  // floor modulo: m > 0
    if (idx > s - 1) idx = s - 1;
    int be = __ldg(fe_seq + (int64_t)fe * s + idx);
    if (be < 0) be += nb;
    be = be < 0 ? 0 : (be > nb - 1 ? nb - 1 : be);
    const bool ok = hit && slen > 0;
#pragma unroll
    for (int k = 0; k < L; ++k) new_bytes[i * L + k] = ok ? __ldg(be_bytes + (int64_t)be * L + k) : a[k];
    new_port[i] = ok ? __ldg(be_port + be) : dp;
    revnat[i] = hit ? __ldg(fe_revnat + fe) : 0;
    ok_out[i] = ok;
    no_backend_out[i] = hit && slen == 0;
}

}  // namespace

CILIUM_API int cilium_lb_translate(
    const int32_t* fe_bytes, const int32_t* fe_port, const int32_t* fe_proto,
    const int32_t* fe_seq, int s, const int32_t* fe_seq_len, const int32_t* fe_revnat,
    int f, const int32_t* be_bytes, const int32_t* be_port, int nb, int l,
    const int32_t* peer, const int32_t* dport, const int32_t* proto, const int32_t* fhash,
    int32_t* new_bytes, int32_t* new_port, int32_t* revnat, uint8_t* ok,
    uint8_t* no_backend, int64_t b, int device, void* stream) {
    int err = cilium_set_device(device);
    if (err) return err;
    if (b == 0) return (int)cudaGetLastError();
    if (f <= 0 || nb <= 0 || s <= 0 || (l != 4 && l != 16)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (b + THREADS - 1) / THREADS;
    cudaStream_t st = (cudaStream_t)stream;
    if (l == 4) {
        lb_translate_kernel<4><<<(unsigned)blocks, THREADS, 0, st>>>(
            fe_bytes, fe_port, fe_proto, fe_seq, s, fe_seq_len, fe_revnat, f, be_bytes,
            be_port, nb, peer, dport, proto, fhash, new_bytes, new_port, revnat, ok,
            no_backend, b);
    } else {
        lb_translate_kernel<16><<<(unsigned)blocks, THREADS, 0, st>>>(
            fe_bytes, fe_port, fe_proto, fe_seq, s, fe_seq_len, fe_revnat, f, be_bytes,
            be_port, nb, peer, dport, proto, fhash, new_bytes, new_port, revnat, ok,
            no_backend, b);
    }
    return (int)cudaGetLastError();
}
