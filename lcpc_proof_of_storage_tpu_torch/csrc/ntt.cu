// K1: forward number-theoretic transform over a prime field, for sm_90a,
// and K4's inverse entry.
//
// K1 replaces: lcpc_proof_of_storage_tpu/ops/ntt_pallas3.py, ntt_pallas3
// (the four-step kernels _kernel_a / _call_a and _kernel_b / _call_b).
// Computes what ops/ntt.py ntt computes: (batch, n, L) 16-bit limbs ->
// natural-order evaluations at w^0 .. w^(n-1), for any power-of-two n >= 2.
// Input positions at or past n_nonzero are read as zero.  It also serves
// the forward half of K4 (ops/ntt_pallas2.py, _in_tile_call /
// _large_pair_call with the zero-pad skip): the same function.
//
// K4 inverse (lcpc_ntt_inverse) replaces the inverse half of
// ops/ntt_pallas2.py ntt_pallas2(inverse=True) (_in_tile_call /
// _large_pair_call with the n^-1 scale) and computes what ops/ntt.py intt
// computes: evaluations -> coefficients.  It packs with the bit-reversal
// (no zero tail), runs the same log2(n) stage launches with the w^-j
// twiddles in Montgomery form, and fuses the n^-1 scale into the unpack as
// one Montgomery product by n^-1 * 2^(32W) mod p.  Its bound and its
// design are K1's: each stage reads and writes the whole word matrix.
//
// Layout: the limbs are packed into W = L/2 32-bit words per element (one
// launch, which also applies the bit-reversal permutation and the zero
// tail), then log2(n) radix-2 DIT stages run over global memory, one launch
// each, then one launch unpacks back to canonical 16-bit limbs.
//
// Arithmetic: a butterfly is y = x1 * tw; (x0 + y, x0 - y) mod p.  The
// twiddles are stored in Montgomery form (w^j * R mod p, R = 2^(32W)), so
// mont_mul(x1, w^j R) = x1 * w^j mod p and the data itself stays in normal
// form: no conversion in or out, and every value stays canonical, so the
// output is bit-equal to the plain Barrett version.
//
// What bounds it on the H100: each stage reads and writes the whole
// (batch, n, W) word matrix, 134 MB at the 2^20 ft255 commit (128 rows of
// n = 2^15, W = 8), so the 15 stages move 4 GB, 1.2 ms at the data sheet's
// 3.35 TB/s.  Measured on an NVIDIA H100 80GB HBM3 at 700 W, a stage takes
// 0.348 ms (0.77 TB/s) and the whole transform 6.4 ms, of which the
// unpack is 0.84 ms.  The stages run well below the bandwidth bound; the
// likely bound is the 64-bit carry chains of the multi-word arithmetic
// (not measured alone).  The four_step and fused_small routes keep a tile
// in shared memory across its stages (ntt_tile.cu KT); PERF.md sets their
// times beside K1's.  32-bit carry arithmetic (add.cc / madc) is the other
// known next step.
//
// lcpc_ntt_stages runs K1's stage launches from a given stage on, then its
// unpack, on words another kernel has already ordered and partly
// transformed: the fused_small route's stages with half >= its tile
// (ops/ntt_pallas.py _stage_call, K6).  It is counted as K1.

#include <cstdint>
#include <cuda_runtime.h>

#include "montgomery.cuh"

namespace {

// (batch, n, 2W) int32 limbs -> (batch, n, W) words, bit-reversed, tail zeroed
template <int W>
__global__ void ntt_pack_bitrev(const int32_t* __restrict__ in, uint32_t* __restrict__ out,
                                int log_n, int n_nonzero, int64_t total) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    int64_t n = (int64_t)1 << log_n;
    int64_t b = t >> log_n;
    uint32_t j = (uint32_t)(t & (n - 1));
    uint32_t src = __brev(j) >> (32 - log_n);
    uint32_t* o = out + t * W;
    if ((int64_t)src < n_nonzero) {
        const int32_t* s = in + (b * n + src) * (2 * W);
#pragma unroll
        for (int w = 0; w < W; ++w)
            o[w] = ((uint32_t)s[2 * w] & 0xFFFFu) | ((uint32_t)s[2 * w + 1] << 16);
    } else {
#pragma unroll
        for (int w = 0; w < W; ++w) o[w] = 0;
    }
}

// one radix-2 DIT stage (half = 2^s) over all rows, in place
template <int W>
__global__ void ntt_stage(uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                          int log_n, int s, Mod<W> m, int64_t total) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    int64_t b = t >> (log_n - 1);
    int64_t r = t & (((int64_t)1 << (log_n - 1)) - 1);
    int64_t k = r & (((int64_t)1 << s) - 1);
    int64_t j0 = ((r >> s) << (s + 1)) + k;
    int64_t j1 = j0 + ((int64_t)1 << s);
    uint32_t* row = x + (b << log_n) * W;
    const uint32_t* w = tw + (k << (log_n - 1 - s)) * W;
    uint32_t a[W], c[W], wv[W], y[W], lo[W], hi[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
        a[i] = row[j0 * W + i];
        c[i] = row[j1 * W + i];
        wv[i] = w[i];
    }
    mont_mul<W>(y, c, wv, m);
    add_mod<W>(lo, a, y, m);
    sub_mod<W>(hi, a, y, m);
#pragma unroll
    for (int i = 0; i < W; ++i) {
        row[j0 * W + i] = lo[i];
        row[j1 * W + i] = hi[i];
    }
}

// (batch, n, W) words -> (batch, n, 2W) int32 limbs
template <int W>
__global__ void ntt_unpack(const uint32_t* __restrict__ x, int32_t* __restrict__ out,
                           int64_t total) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        uint32_t v = x[t * W + w];
        out[t * 2 * W + 2 * w] = (int32_t)(v & 0xFFFFu);
        out[t * 2 * W + 2 * w + 1] = (int32_t)(v >> 16);
    }
}

// (batch, n, W) words -> (batch, n, 2W) int32 limbs of x * s mod p, where
// s holds n^-1 * 2^(32W) mod p (so mont_mul gives x * n^-1)
template <int W>
__global__ void ntt_unpack_scale(const uint32_t* __restrict__ x, int32_t* __restrict__ out,
                                 Mod<W> m, Words<W> s, int64_t total) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    uint32_t a[W], y[W];
#pragma unroll
    for (int w = 0; w < W; ++w) a[w] = x[t * W + w];
    mont_mul<W>(y, a, s.w, m);
#pragma unroll
    for (int w = 0; w < W; ++w) {
        out[t * 2 * W + 2 * w] = (int32_t)(y[w] & 0xFFFFu);
        out[t * 2 * W + 2 * w + 1] = (int32_t)(y[w] >> 16);
    }
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t total) {
    return (unsigned)((total + kThreads - 1) / kThreads);
}


template <int W>
int ntt_forward(const int32_t* in, int32_t* out, uint32_t* work, const uint32_t* tw,
                int batch, int log_n, int n_nonzero, const uint32_t* p_host,
                cudaStream_t stream) {
    Mod<W> m = make_mod<W>(p_host);
    int64_t n = (int64_t)1 << log_n;
    int64_t elems = (int64_t)batch * n;
    ntt_pack_bitrev<W><<<blocks_for(elems), kThreads, 0, stream>>>(in, work, log_n,
                                                                   n_nonzero, elems);
    int64_t flies = elems / 2;
    for (int s = 0; s < log_n; ++s)
        ntt_stage<W><<<blocks_for(flies), kThreads, 0, stream>>>(work, tw, log_n, s, m,
                                                                 flies);
    ntt_unpack<W><<<blocks_for(elems), kThreads, 0, stream>>>(work, out, elems);
    return (int)cudaGetLastError();
}

// K1's stages s0 .. log_n-1 over (batch, n, W) words already in the
// transform's order, in place, then its unpack: the fused_small route's
// stages with half >= its tile (ntt_pallas.py _stage_call).
template <int W>
int ntt_stages(uint32_t* work, int32_t* out, const uint32_t* tw, int batch, int log_n,
               int s0, const uint32_t* p_host, cudaStream_t stream) {
    Mod<W> m = make_mod<W>(p_host);
    int64_t elems = (int64_t)batch << log_n;
    int64_t flies = elems / 2;
    for (int s = s0; s < log_n; ++s)
        ntt_stage<W><<<blocks_for(flies), kThreads, 0, stream>>>(work, tw, log_n, s, m, flies);
    ntt_unpack<W><<<blocks_for(elems), kThreads, 0, stream>>>(work, out, elems);
    return (int)cudaGetLastError();
}

template <int W>
int ntt_inverse(const int32_t* in, int32_t* out, uint32_t* work, const uint32_t* tw_inv,
                int batch, int log_n, const uint32_t* p_host, const uint32_t* n_inv_mont,
                cudaStream_t stream) {
    Mod<W> m = make_mod<W>(p_host);
    Words<W> s;
    for (int i = 0; i < W; ++i) s.w[i] = n_inv_mont[i];
    int64_t n = (int64_t)1 << log_n;
    int64_t elems = (int64_t)batch * n;
    ntt_pack_bitrev<W><<<blocks_for(elems), kThreads, 0, stream>>>(in, work, log_n, (int)n,
                                                                   elems);
    int64_t flies = elems / 2;
    for (int st = 0; st < log_n; ++st)
        ntt_stage<W><<<blocks_for(flies), kThreads, 0, stream>>>(work, tw_inv, log_n, st, m,
                                                                 flies);
    ntt_unpack_scale<W><<<blocks_for(elems), kThreads, 0, stream>>>(work, out, m, s, elems);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in, out: (batch, 2^log_n, 2W) int32 limbs; work: (batch, 2^log_n, W) words;
// tw: (2^(log_n-1), W) words of w^j * 2^(32W) mod p; p_host: W host words of p.
// Returns the cudaGetLastError() code after the launches (0 on success).
int lcpc_ntt_forward(const void* in, void* out, void* work, const void* tw, int batch,
                     int log_n, int n_nonzero, int W, const void* p_host, void* stream) {
    auto i = static_cast<const int32_t*>(in);
    auto o = static_cast<int32_t*>(out);
    auto wk = static_cast<uint32_t*>(work);
    auto t = static_cast<const uint32_t*>(tw);
    auto p = static_cast<const uint32_t*>(p_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 2: return ntt_forward<2>(i, o, wk, t, batch, log_n, n_nonzero, p, st);
        case 4: return ntt_forward<4>(i, o, wk, t, batch, log_n, n_nonzero, p, st);
        case 6: return ntt_forward<6>(i, o, wk, t, batch, log_n, n_nonzero, p, st);
        case 8: return ntt_forward<8>(i, o, wk, t, batch, log_n, n_nonzero, p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// in, out: (batch, 2^log_n, 2W) int32 limbs; work: (batch, 2^log_n, W) words;
// tw_inv: (2^(log_n-1), W) words of w^-j * 2^(32W) mod p; p_host, n_inv_mont:
// W host words of p and of n^-1 * 2^(32W) mod p.  Returns the
// cudaGetLastError() code after the launches (0 on success).
int lcpc_ntt_inverse(const void* in, void* out, void* work, const void* tw_inv, int batch,
                     int log_n, int W, const void* p_host, const void* n_inv_mont,
                     void* stream) {
    auto i = static_cast<const int32_t*>(in);
    auto o = static_cast<int32_t*>(out);
    auto wk = static_cast<uint32_t*>(work);
    auto t = static_cast<const uint32_t*>(tw_inv);
    auto p = static_cast<const uint32_t*>(p_host);
    auto s = static_cast<const uint32_t*>(n_inv_mont);
    auto st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 2: return ntt_inverse<2>(i, o, wk, t, batch, log_n, p, s, st);
        case 4: return ntt_inverse<4>(i, o, wk, t, batch, log_n, p, s, st);
        case 6: return ntt_inverse<6>(i, o, wk, t, batch, log_n, p, s, st);
        case 8: return ntt_inverse<8>(i, o, wk, t, batch, log_n, p, s, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// work: (batch, 2^log_n, W) words, transformed in place by the stages s0 ..
// log_n-1; out: (batch, 2^log_n, 2W) int32 limbs; tw: as lcpc_ntt_forward's
// (or lcpc_ntt_inverse's).  Returns the cudaGetLastError() code.
int lcpc_ntt_stages(void* work, void* out, const void* tw, int batch, int log_n, int s0,
                    int W, const void* p_host, void* stream) {
    auto wk = static_cast<uint32_t*>(work);
    auto o = static_cast<int32_t*>(out);
    auto t = static_cast<const uint32_t*>(tw);
    auto p = static_cast<const uint32_t*>(p_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 2: return ntt_stages<2>(wk, o, t, batch, log_n, s0, p, st);
        case 4: return ntt_stages<4>(wk, o, t, batch, log_n, s0, p, st);
        case 6: return ntt_stages<6>(wk, o, t, batch, log_n, s0, p, st);
        case 8: return ntt_stages<8>(wk, o, t, batch, log_n, s0, p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* lcpc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
