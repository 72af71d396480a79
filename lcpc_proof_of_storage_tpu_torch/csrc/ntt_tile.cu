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
// b[i mod b_rows] mod p on (N, L) limbs, any N.
//
// What bounds them on the H100.  KT: its operations where it runs many
// stages (the four-step's pass B, 7 stages and the diagonal product, at the
// Ligero 2^20 commit's (128, 32768, 16) ft255: 0.140 ms at 33.5 T 32-bit
// operations/s, no product counted where the twiddle is 1), its bytes where it runs few (pass A, limbs in and words
// out, 6 stages: 0.120 ms at 3.35 TB/s; chip_smoke.py tile_bound).  KM: its
// bytes, 0.160 ms at (4194304, 16) x (1, 16).  The design before this one,
// on the same carry chains, ran at 20-24 % of those bounds: each value
// moved as W or 2W separate 4-byte accesses at a stride of 4W or 8W bytes,
// one radix-2 stage a __syncthreads(), each butterfly's twiddle through the
// ordinary load path, no minimum of blocks an SM, and KM took two
// Montgomery products a value even for one broadcast row.
//
// KT's design is K1's pass (ntt.cu) on one stage group [s0, s1) whose tiles
// are whole runs, contiguous in memory, with the pieces of ntt_pass.cuh:
//   * a block of 256 threads holds T = 2^log_span / 2^s1 consecutive runs,
//     2^11 values at W >= 6 and 2^10 at W <= 4 as K1's blocks (or one run,
//     if longer), word-major in dynamic shared memory with rows of 2^log_span
//     + 1 words; T is halved while the grid would have fewer than 256 blocks,
//     so the four-step's 2^7 .. 2^10 sub-lengths fill the card (the plan is
//     ops/ntt.py tile_plan's, passed in as log_span);
//   * the prologue reads each value with 16-byte loads (8-byte at W = 2, 6
//     for words), a warp on 32 consecutive values, packs limbs into words,
//     and multiplies in the diagonal twiddle, read through the read-only
//     path, before the value reaches shared memory; the epilogue unpacks and
//     writes the same way;
//   * the stages run two at a time in registers (radix 4: four values v, v +
//     h, v + 2h, v + 3h a thread, three twiddles through __ldg), with one
//     __syncthreads() a pair; an odd last stage runs radix 2.  Stage st's
//     twiddle for the value at run position v is (v mod 2^st) << (log_n - 1
//     - st): a run holds all its positions, so no tile index enters.  Three
//     of the four butterflies of stages 0 and 1 have the twiddle 1 and take
//     no product: a call from stage 0 (the four-step's pass B, the inverse
//     tile) runs a kernel of its own that does them first (as one branch in
//     the stage loop, it cost the calls from stage 2 about 8 % on the H100);
//   * __launch_bounds__(256, 3) at W >= 6 (four blocks at W <= 4), as K1:
//     three blocks of 2^11 values (66 KB each) fit an SM at W = 8.
// Tiles of 2^11 (fused_small's, 11 stages) and 2^12 (TILE_MAX) are held
// whole by one block, not split into two stage groups: a split needs a
// buffer between its launches that the entry does not have, and 2^11 values
// are already K1's block.  2^12 values at W = 8 take 128 KB, so one block an
// SM: no path runs that tile (ops/ntt.py FUSED_TILE is 2^11).
//
// KM's design: a byte-bound elementwise kernel.  One grid of as many blocks
// as fit the card at once walks the values (a grid-stride loop, several
// values a thread), each value's 2W limbs with W/2 16-byte loads and
// stores.  A broadcast row (b_rows = 1, the inverse's n^-1) is read once a
// thread and turned into Montgomery form in registers, b R = mont_mul(b, R^2
// mod p), so each value takes one product, a (b R) R^-1 = a b; there is no
// index arithmetic on that path.  The wave's size is asked of the runtime
// once a device and form.  Otherwise each value takes its own row of
// b (i mod b_rows in 32 bits, skipped when b_rows = N) and two products, t =
// a b R^-1, then t (R^2 mod p) R^-1.  b R is computed on the card, not on
// the host: b is a device tensor, and reading it back would synchronise
// every call.
//
// Measured by chip_smoke.py ntt_tile_kernels on an NVIDIA H100 80GB HBM3 at
// 700 W, this design beside the one before it in one call (two processes
// each, CUDA-event means of 20 calls), ft255 at the Ligero 2^20 commit's
// shapes: pass A 0.319-0.322 ms (was 0.571-0.574; bound 0.120, bytes), pass
// B 0.429-0.430 (0.855-0.858; 0.140, operations), the fused_small tile
// 0.448-0.453 (0.816-0.819; 0.172), its inverse 0.475-0.477 (0.882-0.883;
// 0.188); on a (32, 2^20, 16) batch of the 2^29 commit 2.910-2.918,
// 4.068-4.079, 3.248-3.254 and 3.436-3.445 ms (5.60-5.61, 7.67, 6.16, 6.63;
// bounds 1.218, 1.602, 1.378, 1.507, operations).
// KM 0.252-0.254 ms at (4194304, 16) x (1, 16), 2.1 TB/s (0.804; bound 0.160,
// bytes), 2.010-2.022 ms on the batch (6.33; 1.282), 0.023-0.041 ms at
// (100003, 16) x (100003, 16) (0.026-0.043).  KT sits at 2.3-3.1x its bound,
// about K1's ratio (2.6-3.2x).  ptxas: KT 78-80 registers at W = 6, 8 (at W = 8 the
// stage-0 form spills 16 bytes), 56-64 at W = 4, 40 at W = 2; KM 22-44.

#include <cstdint>
#include <cuda_runtime.h>

#include "montgomery.cuh"
#include "ntt_pass.cuh"

namespace {

using namespace ntt_pass;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kDefaultSmem = 48 * 1024;

struct Tile {
    const void* in;         // (count, 2W) limbs (in_limbs) or (count, W) words
    void* out;              // likewise by out_limbs; a buffer apart from in
    const uint32_t* tw;     // (2^(log_n-1), W) Montgomery words of w^j (or w^-j)
    const uint32_t* diag;   // null, or (2^log_n, W) Montgomery words
    int64_t count;
    int log_n, s0, s1;
    int log_span;           // log2 of the values a block holds: whole runs
    int in_limbs, out_limbs;
};

// stages st and st + 1 on the four values x0..x3 at v, v + h, v + 2h, v + 3h
// (h = 2^st in the transform's order): twiddle j0 pairs (x0, x1) and (x2,
// x3) at stage st, then j1 pairs (x0, x2) and j2 (x1, x3) at stage st + 1
template <int W>
__device__ __forceinline__ void radix4(uint32_t x0[W], uint32_t x1[W], uint32_t x2[W],
                                       uint32_t x3[W], const uint32_t* __restrict__ tw,
                                       int64_t j0, int64_t j1, int64_t j2, const Mod<W>& m) {
    uint32_t wv[W];
    load_tw<W>(wv, tw, j0);
    butterfly<W>(x0, x1, wv, m);
    butterfly<W>(x2, x3, wv, m);
    load_tw<W>(wv, tw, j1);
    butterfly<W>(x0, x2, wv, m);
    load_tw<W>(wv, tw, j2);
    butterfly<W>(x1, x3, wv, m);
}

// (a, b) <- (a + b, a - b): the butterfly whose twiddle is w^0 = 1
template <int W>
__device__ __forceinline__ void butterfly_one(uint32_t a[W], uint32_t b[W], const Mod<W>& m) {
    uint32_t s[W];
    add_mod<W>(s, a, b, m);
    sub_mod<W>(b, a, b, m);
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = s[i];
}

// radix4 at stages 0 and 1 (h = 1): the twiddles of (x0, x1), (x2, x3) and
// (x0, x2) are w^0 = 1, so only (x1, x3) takes a product, by twiddle j2
template <int W>
__device__ __forceinline__ void radix4_first(uint32_t x0[W], uint32_t x1[W], uint32_t x2[W],
                                             uint32_t x3[W], const uint32_t* __restrict__ tw,
                                             int64_t j2, const Mod<W>& m) {
    uint32_t wv[W];
    butterfly_one<W>(x0, x1, m);
    butterfly_one<W>(x2, x3, m);
    butterfly_one<W>(x0, x2, m);
    load_tw<W>(wv, tw, j2);
    butterfly<W>(x1, x3, wv, m);
}

// the runs [blockIdx.x * 2^log_span, + 2^log_span) of the count; kFromZero:
// s0 = 0, stages 0 and 1 first as radix4_first (a kernel of its own, so the
// other form keeps its registers)
template <int W, bool kFromZero>
__global__ void __launch_bounds__(kThreads, W <= 4 ? 4 : 3)
ntt_tile(Tile a, Mod<W> m) {
    extern __shared__ uint32_t sm[];
    const int ld = (1 << a.log_span) + 1;
    const int64_t base = (int64_t)blockIdx.x << a.log_span;
    const int64_t left = a.count - base;
    const int here = left < ((int64_t)1 << a.log_span) ? (int)left : 1 << a.log_span;
    const int64_t row_mask = ((int64_t)1 << a.log_n) - 1;

    // prologue: load, pack, the diagonal product
    for (int e = threadIdx.x; e < here; e += blockDim.x) {
        const int64_t g = base + e;
        uint32_t v[W];
        if (a.in_limbs)
            load_limbs<W>(v, static_cast<const int32_t*>(a.in) + g * (2 * W));
        else
            load_words<W>(v, static_cast<const uint32_t*>(a.in) + g * W);
        if (a.diag != nullptr) {
            uint32_t d[W], y[W];
            load_tw<W>(d, a.diag, g & row_mask);
            mont_mul<W>(y, v, d, m);
#pragma unroll
            for (int w = 0; w < W; ++w) v[w] = y[w];
        }
        store_smem<W>(sm, ld, e, v);
    }
    __syncthreads();

    // the stages two at a time; blocks of 4h never straddle a run (4h <= 2^s1)
    int st = a.s0;
    if (kFromZero && a.s1 >= 2) {
        for (int f = threadIdx.x; f < (here >> 2); f += blockDim.x) {
            const int v = f << 2;
            uint32_t x0[W], x1[W], x2[W], x3[W];
            load_smem<W>(x0, sm, ld, v);
            load_smem<W>(x1, sm, ld, v + 1);
            load_smem<W>(x2, sm, ld, v + 2);
            load_smem<W>(x3, sm, ld, v + 3);
            radix4_first<W>(x0, x1, x2, x3, a.tw, (int64_t)1 << (a.log_n - 2), m);
            store_smem<W>(sm, ld, v, x0);
            store_smem<W>(sm, ld, v + 1, x1);
            store_smem<W>(sm, ld, v + 2, x2);
            store_smem<W>(sm, ld, v + 3, x3);
        }
        __syncthreads();
        st = 2;
    }
    for (; st + 1 < a.s1; st += 2) {
        const int h = 1 << st;
        const int shift = a.log_n - 1 - st;
        for (int f = threadIdx.x; f < (here >> 2); f += blockDim.x) {
            const int kk = f & (h - 1);
            const int v = ((f >> st) << (st + 2)) + kk;
            uint32_t x0[W], x1[W], x2[W], x3[W];
            load_smem<W>(x0, sm, ld, v);
            load_smem<W>(x1, sm, ld, v + h);
            load_smem<W>(x2, sm, ld, v + 2 * h);
            load_smem<W>(x3, sm, ld, v + 3 * h);
            radix4<W>(x0, x1, x2, x3, a.tw, (int64_t)kk << shift, (int64_t)kk << (shift - 1),
                      (int64_t)(kk + h) << (shift - 1), m);
            store_smem<W>(sm, ld, v, x0);
            store_smem<W>(sm, ld, v + h, x1);
            store_smem<W>(sm, ld, v + 2 * h, x2);
            store_smem<W>(sm, ld, v + 3 * h, x3);
        }
        __syncthreads();
    }
    if (st < a.s1) {
        const int h = 1 << st;
        for (int f = threadIdx.x; f < (here >> 1); f += blockDim.x) {
            const int kk = f & (h - 1);
            const int v = ((f >> st) << (st + 1)) + kk;
            uint32_t x0[W], x1[W], wv[W];
            load_smem<W>(x0, sm, ld, v);
            load_smem<W>(x1, sm, ld, v + h);
            if (kFromZero && st == 0) {
                butterfly_one<W>(x0, x1, m);
            } else {
                load_tw<W>(wv, a.tw, (int64_t)kk << (a.log_n - 1 - st));
                butterfly<W>(x0, x1, wv, m);
            }
            store_smem<W>(sm, ld, v, x0);
            store_smem<W>(sm, ld, v + h, x1);
        }
        __syncthreads();
    }

    // epilogue: words or limbs, 16-byte stores
    for (int e = threadIdx.x; e < here; e += blockDim.x) {
        const int64_t g = base + e;
        uint32_t v[W];
        load_smem<W>(v, sm, ld, e);
        if (a.out_limbs)
            store_limbs<W>(static_cast<int32_t*>(a.out) + g * (2 * W), v);
        else
            store_words<W>(static_cast<uint32_t*>(a.out) + g * W, v);
    }
}

template <int W>
int ntt_tile_launch(const void* in, void* out, const uint32_t* tw, const uint32_t* diag,
                    int64_t count, int log_n, int s0, int s1, int log_span, int in_limbs,
                    int out_limbs, const uint32_t* p_host, cudaStream_t stream) {
    const size_t smem = (size_t)W * (((size_t)1 << log_span) + 1) * sizeof(uint32_t);
    const auto kernel = s0 == 0 ? ntt_tile<W, true> : ntt_tile<W, false>;
    if (smem > (size_t)kDefaultSmem) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    Tile a;
    a.in = in, a.out = out, a.tw = tw, a.diag = diag;
    a.count = count;
    a.log_n = log_n, a.s0 = s0, a.s1 = s1;
    a.log_span = log_span;
    a.in_limbs = in_limbs, a.out_limbs = out_limbs;
    const unsigned blocks = (unsigned)((count + (1 << log_span) - 1) >> log_span);
    kernel<<<blocks, kThreads, smem, stream>>>(a, make_mod<W>(p_host));
    return (int)cudaGetLastError();
}

// out[i] = a[i] * b[i mod b_rows] mod p on (n, 2W) int32 limbs; kBroadcast: b_rows = 1
template <int W, bool kBroadcast>
__global__ void __launch_bounds__(kThreads)
mul_mod_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, int n, int b_rows, Mod<W> m, Words<W> r2) {
    uint32_t bm[W];
    if constexpr (kBroadcast) {
        uint32_t y[W];
        load_limbs<W>(y, b);
        mont_mul<W>(bm, y, r2.w, m);   // b R mod p
    }
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        uint32_t x[W], r[W];
        load_limbs<W>(x, a + i * (2 * W));
        if constexpr (kBroadcast) {
            mont_mul<W>(r, x, bm, m);      // a (b R) R^-1 = a b
        } else {
            const uint32_t row = b_rows == n ? (uint32_t)i : (uint32_t)i % (uint32_t)b_rows;
            uint32_t y[W];
            load_limbs<W>(y, b + (int64_t)row * (2 * W));
            mul_normal<W>(r, x, y, r2.w, m);
        }
        store_limbs<W>(out + i * (2 * W), r);
    }
}

// one wave: as many blocks as the card holds at once, at most one a 256
// values; the wave's size is asked once a device (and kernel form)
template <int W, bool kBroadcast>
int mul_mod_grid(const int32_t* a, const int32_t* b, int32_t* out, int n, int b_rows,
                 const Mod<W>& m, const Words<W>& r2, cudaStream_t stream) {
    static int waves[kMaxDevices];   // 0: not asked yet
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (waves[dev] == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, mul_mod_kernel<W, kBroadcast>, kThreads, 0);
        if (err != cudaSuccess) return (int)err;
        waves[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int64_t wanted = ((int64_t)n + kThreads - 1) / kThreads;
    const int64_t wave = waves[dev];
    const unsigned blocks = (unsigned)(wanted < wave ? wanted : wave);
    mul_mod_kernel<W, kBroadcast><<<blocks, kThreads, 0, stream>>>(a, b, out, n, b_rows, m, r2);
    return (int)cudaGetLastError();
}

template <int W>
int mul_mod_launch(const int32_t* a, const int32_t* b, int32_t* out, int n, int b_rows,
                   const uint32_t* p_host, const uint32_t* r2_host, cudaStream_t stream) {
    Mod<W> m = make_mod<W>(p_host);
    Words<W> r2;
    for (int i = 0; i < W; ++i) r2.w[i] = r2_host[i];
    return b_rows == 1 ? mul_mod_grid<W, true>(a, b, out, n, b_rows, m, r2, stream)
                       : mul_mod_grid<W, false>(a, b, out, n, b_rows, m, r2, stream);
}

}  // namespace

extern "C" {

// in: `count` values as (count, 2W) int32 limbs (in_limbs) or (count, W)
// words; out likewise by out_limbs (a buffer apart from in); tw: (2^(log_n-1),
// W) Montgomery words of w^j (or w^-j); diag: null, or (2^log_n, W)
// Montgomery words multiplied in before the stages; stages s0 .. s1-1 on
// runs of 2^s1 values, count a multiple of 2^s1, 2^s1 <= 4096; a block holds
// 2^log_span values, whole runs (s1 <= log_span <= 12; ops/ntt.py
// tile_plan); every pointer 16-byte aligned.  Returns the
// cudaGetLastError() code (0 on success).
int lcpc_ntt_tile(const void* in, void* out, const void* tw, const void* diag, int count,
                  int log_n, int s0, int s1, int log_span, int in_limbs, int out_limbs, int W,
                  const void* p_host, void* stream) {
    if (count <= 0 || s0 < 0 || s1 < s0 || s1 > 12 || s1 > log_n || count % (1 << s1)
            || log_span < s1 || log_span > 12)
        return (int)cudaErrorInvalidValue;
    auto t = static_cast<const uint32_t*>(tw);
    auto d = static_cast<const uint32_t*>(diag);
    auto p = static_cast<const uint32_t*>(p_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 2: return ntt_tile_launch<2>(in, out, t, d, count, log_n, s0, s1, log_span,
                                          in_limbs, out_limbs, p, st);
        case 4: return ntt_tile_launch<4>(in, out, t, d, count, log_n, s0, s1, log_span,
                                          in_limbs, out_limbs, p, st);
        case 6: return ntt_tile_launch<6>(in, out, t, d, count, log_n, s0, s1, log_span,
                                          in_limbs, out_limbs, p, st);
        case 8: return ntt_tile_launch<8>(in, out, t, d, count, log_n, s0, s1, log_span,
                                          in_limbs, out_limbs, p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// a, out: (n, 2W) int32 limbs; b: (b_rows, 2W); p_host, r2_host: W host
// words of p and of 2^(64W) mod p; every pointer 16-byte aligned.  Returns
// the cudaGetLastError() code.
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
