// KT: radix-2 DIT stages inside tiles held in shared memory, and KM: an
// elementwise modular product, for sm_90a.
//
// KT (lcpc_ntt_tile) replaces, in lcpc_proof_of_storage_tpu/ops/:
//   * ntt_pallas2.py _in_tile_call_mul (K4f, the four-step's second pass):
//     each value times its diagonal twiddle w_n^(j1 k2) (_gmul_block), then
//     the packed n1-point sub-NTTs;
//   * ntt_pallas.py _fused_small_call (K6): every stage whose half is below
//     the tile, in one pass;
//   * and runs the four-step's first pass, the packed n2-point sub-NTTs
//     (ntt_pallas2.py _in_tile_call).
// It computes: over `count` values, in aligned runs of 2^s1 (a run is one
// sub-transform, or one tile of a larger transform's bit-reversed input),
// optionally each value times diag[its position mod n] (Montgomery words,
// so one mont_mul gives the plain product), then the DIT stages s0 .. s1-1.
// Stage s of any sub-length reads the twiddle of a 2^log_n transform at
// k << (log_n - 1 - s), K1's own table: w_m = w_n^(n/m).  Input is 16-bit
// limbs or packed words, output either, so the routes pack and unpack on
// the way through instead of in passes of their own.
//
// KM (lcpc_mul_mod) replaces ntt_pallas.py mul_mod_pallas (an (N, L) x
// (N, L) product) and _scale_call (the inverse's x * n^-1): out[i] = a[i] *
// b[i mod b_rows] mod p on (N, L) limbs, any N.  b is in normal form, so it
// takes two Montgomery products: t = a b R^-1, then t (R^2 mod p) R^-1.
//
// Design: a block of 256 threads holds a span of max(2^s1, 1024) values in
// dynamic shared memory, word-major with rows of span + 1 words (the pad
// keeps the W words of one value in W banks).  It loads the span once
// (packing limbs, multiplying by the diagonal), runs the stages with a
// __syncthreads() between them, one butterfly a thread at a time, and
// writes the span once.  A span of 2048 values at W = 8 takes 64 KB and
// 4096 takes 128 KB: above 48 KB the entry raises the kernel's dynamic
// shared memory limit first and returns that call's error if it fails.
//
// What bounds it on the H100: both its bytes and its operations.  At the
// Ligero 2^20 commit's (128, 32768, 16) ft255 the four-step's two passes
// read and write 805 MB (limbs in and words out, then words in and limbs
// out), 0.240 ms at 3.35 TB/s, and their 13 stages (after 2 pruned) are
// 2^21 butterflies each of about 4 W^2 + 8 W 32-bit operations, 8.7 G in
// all, 0.26 ms at 33.5 T integer operations/s.  KM is bound by its bytes.
// Both take the carry-chain arithmetic of montgomery.cuh, as K1 does; their
// time is in their value-at-a-time loads and stores (load_value /
// store_value: 4-byte accesses at a value's stride) more than in the
// arithmetic, which the switch from 64-bit sums to 32-bit carry chains
// moved little (PERF.md).  chip_smoke.py measures them beside K1.

#include <cstdint>
#include <cuda_runtime.h>

#include "montgomery.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kMinLogSpan = 10;   // a block holds at least 1024 values
constexpr int kDefaultSmem = 48 * 1024;

template <int W>
__device__ __forceinline__ void load_value(uint32_t v[W], const void* in, int64_t g,
                                           int in_limbs) {
    if (in_limbs) {
        const int32_t* s = static_cast<const int32_t*>(in) + g * (2 * W);
#pragma unroll
        for (int w = 0; w < W; ++w)
            v[w] = ((uint32_t)s[2 * w] & 0xFFFFu) | ((uint32_t)s[2 * w + 1] << 16);
    } else {
        const uint32_t* s = static_cast<const uint32_t*>(in) + g * W;
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = s[w];
    }
}

template <int W>
__device__ __forceinline__ void store_value(void* out, int64_t g, const uint32_t v[W],
                                            int out_limbs) {
    if (out_limbs) {
        int32_t* o = static_cast<int32_t*>(out) + g * (2 * W);
#pragma unroll
        for (int w = 0; w < W; ++w) {
            o[2 * w] = (int32_t)(v[w] & 0xFFFFu);
            o[2 * w + 1] = (int32_t)(v[w] >> 16);
        }
    } else {
        uint32_t* o = static_cast<uint32_t*>(out) + g * W;
#pragma unroll
        for (int w = 0; w < W; ++w) o[w] = v[w];
    }
}

// one block: values [blockIdx.x * span, + span) of the count
template <int W>
__global__ void __launch_bounds__(kTileThreads)
ntt_tile(const void* __restrict__ in, void* __restrict__ out, const uint32_t* __restrict__ tw,
         const uint32_t* __restrict__ diag, int64_t count, int log_n, int s0, int s1,
         int log_span, int in_limbs, int out_limbs, Mod<W> m) {
    extern __shared__ uint32_t sm[];
    const int ld = (1 << log_span) + 1;
    const int64_t base = (int64_t)blockIdx.x << log_span;
    const int64_t left = count - base;
    const int here = left < ((int64_t)1 << log_span) ? (int)left : 1 << log_span;
    const int64_t row_mask = ((int64_t)1 << log_n) - 1;

    for (int e = threadIdx.x; e < here; e += blockDim.x) {
        const int64_t g = base + e;
        uint32_t v[W];
        load_value<W>(v, in, g, in_limbs);
        if (diag != nullptr) {
            uint32_t d[W], y[W];
            const uint32_t* dp = diag + (g & row_mask) * W;
#pragma unroll
            for (int w = 0; w < W; ++w) d[w] = dp[w];
            mont_mul<W>(y, v, d, m);
#pragma unroll
            for (int w = 0; w < W; ++w) v[w] = y[w];
        }
#pragma unroll
        for (int w = 0; w < W; ++w) sm[w * ld + e] = v[w];
    }
    __syncthreads();

    for (int s = s0; s < s1; ++s) {
        const int half = 1 << s;
        for (int f = threadIdx.x; f < here / 2; f += blockDim.x) {
            const int k = f & (half - 1);
            const int j0 = ((f >> s) << (s + 1)) + k;
            const int j1 = j0 + half;
            const uint32_t* wp = tw + ((int64_t)k << (log_n - 1 - s)) * W;
            uint32_t a[W], c[W], wv[W], y[W], lo[W], hi[W];
#pragma unroll
            for (int w = 0; w < W; ++w) {
                a[w] = sm[w * ld + j0];
                c[w] = sm[w * ld + j1];
                wv[w] = wp[w];
            }
            mont_mul<W>(y, c, wv, m);
            add_mod<W>(lo, a, y, m);
            sub_mod<W>(hi, a, y, m);
#pragma unroll
            for (int w = 0; w < W; ++w) {
                sm[w * ld + j0] = lo[w];
                sm[w * ld + j1] = hi[w];
            }
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < here; e += blockDim.x) {
        uint32_t v[W];
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = sm[w * ld + e];
        store_value<W>(out, base + e, v, out_limbs);
    }
}

template <int W>
int ntt_tile_launch(const void* in, void* out, const uint32_t* tw, const uint32_t* diag,
                    int64_t count, int log_n, int s0, int s1, int in_limbs, int out_limbs,
                    const uint32_t* p_host, cudaStream_t stream) {
    Mod<W> m = make_mod<W>(p_host);
    const int log_span = s1 > kMinLogSpan ? s1 : kMinLogSpan;
    const int64_t span = (int64_t)1 << log_span;
    const size_t smem = (size_t)W * (span + 1) * sizeof(uint32_t);
    if (smem > (size_t)kDefaultSmem) {
        cudaError_t err = cudaFuncSetAttribute(
            ntt_tile<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned blocks = (unsigned)((count + span - 1) / span);
    ntt_tile<W><<<blocks, kTileThreads, smem, stream>>>(in, out, tw, diag, count, log_n, s0,
                                                        s1, log_span, in_limbs, out_limbs, m);
    return (int)cudaGetLastError();
}

// out[i] = a[i] * b[i mod b_rows] mod p, (N, 2W) int32 limbs
template <int W>
__global__ void mul_mod_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                               int32_t* __restrict__ out, int64_t n, int b_rows, Mod<W> m,
                               Words<W> r2) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[W], y[W], t[W], r[W];
    load_value<W>(x, a, i, 1);
    load_value<W>(y, b, b_rows == 1 ? 0 : i % b_rows, 1);
    mont_mul<W>(t, x, y, m);      // a b R^-1
    mont_mul<W>(r, t, r2.w, m);   // a b
    store_value<W>(out, i, r, 1);
}

template <int W>
int mul_mod_launch(const int32_t* a, const int32_t* b, int32_t* out, int n, int b_rows,
                   const uint32_t* p_host, const uint32_t* r2_host, cudaStream_t stream) {
    Mod<W> m = make_mod<W>(p_host);
    Words<W> r2;
    for (int i = 0; i < W; ++i) r2.w[i] = r2_host[i];
    const unsigned blocks = (unsigned)(((int64_t)n + kTileThreads - 1) / kTileThreads);
    mul_mod_kernel<W><<<blocks, kTileThreads, 0, stream>>>(a, b, out, n, b_rows, m, r2);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: `count` values as (count, 2W) int32 limbs (in_limbs) or (count, W)
// words; out likewise by out_limbs (a buffer apart from in); tw: (2^(log_n-1),
// W) Montgomery words of w^j (or w^-j); diag: null, or (2^log_n, W)
// Montgomery words multiplied in before the stages; stages s0 .. s1-1 on
// runs of 2^s1 values, count a multiple of 2^s1, 2^s1 <= 4096.  Returns the
// cudaGetLastError() code (0 on success).
int lcpc_ntt_tile(const void* in, void* out, const void* tw, const void* diag, int count,
                  int log_n, int s0, int s1, int in_limbs, int out_limbs, int W,
                  const void* p_host, void* stream) {
    if (count <= 0 || s0 < 0 || s1 < s0 || s1 > 12 || s1 > log_n || count % (1 << s1))
        return (int)cudaErrorInvalidValue;
    auto t = static_cast<const uint32_t*>(tw);
    auto d = static_cast<const uint32_t*>(diag);
    auto p = static_cast<const uint32_t*>(p_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 2: return ntt_tile_launch<2>(in, out, t, d, count, log_n, s0, s1, in_limbs,
                                          out_limbs, p, st);
        case 4: return ntt_tile_launch<4>(in, out, t, d, count, log_n, s0, s1, in_limbs,
                                          out_limbs, p, st);
        case 6: return ntt_tile_launch<6>(in, out, t, d, count, log_n, s0, s1, in_limbs,
                                          out_limbs, p, st);
        case 8: return ntt_tile_launch<8>(in, out, t, d, count, log_n, s0, s1, in_limbs,
                                          out_limbs, p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// a, out: (n, 2W) int32 limbs; b: (b_rows, 2W); p_host, r2_host: W host
// words of p and of 2^(64W) mod p.  Returns the cudaGetLastError() code.
int lcpc_mul_mod(const void* a, const void* b, void* out, int n, int b_rows, int W,
                 const void* p_host, const void* r2_host, void* stream) {
    if (n <= 0 || b_rows <= 0) return (int)cudaErrorInvalidValue;
    auto x = static_cast<const int32_t*>(a);
    auto y = static_cast<const int32_t*>(b);
    auto o = static_cast<int32_t*>(out);
    auto p = static_cast<const uint32_t*>(p_host);
    auto r2 = static_cast<const uint32_t*>(r2_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 2: return mul_mod_launch<2>(x, y, o, n, b_rows, p, r2, st);
        case 4: return mul_mod_launch<4>(x, y, o, n, b_rows, p, r2, st);
        case 6: return mul_mod_launch<6>(x, y, o, n, b_rows, p, r2, st);
        case 8: return mul_mod_launch<8>(x, y, o, n, b_rows, p, r2, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
