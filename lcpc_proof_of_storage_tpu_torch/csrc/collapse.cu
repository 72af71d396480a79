// K3 and K3p: tensor collapse v_t = sum_i t[t, i] * M[i, :] mod p, for
// sm_90a.
//
// Replaces: lcpc_proof_of_storage_tpu/ops/collapse_pallas.py,
// collapse_tensors_natural (_natural_kernel / _natural_call) together with
// its in-kernel reduction, ops/expander_pallas.py _barrett_rows (K3); and
// collapse_tensors (_collapse_kernel / _collapse_call, the packed kernel that
// core/streamed.py collapse_streamed calls once per row batch) with that
// caller's per-batch field add (K3p: the same entry given an accumulator).
// The TPU's packed limb-pair layout only halved VMEM bytes; here both entries
// read the coefficient matrix as stored, int32 limbs or the streamed
// commitment's 16-bit limbs.
//
// What bounds it on the H100.  Counted in 32-bit words (W = L/2), a row and
// output take W^2 multiply-adds; the matrix is read once.  At the 2^29 ft255
// prove batch, (128, 262144, 16) 16-bit limbs and T = 2, the bytes (1.07 GB,
// 0.32 ms at 3.35 TB/s) bound it, the operations (4.3 G, 0.26 ms at 33.5 T
// 32-bit integer operations/s) close behind; at the Ligero 2^20 prove,
// (128, 8192, 16) int32 and T = 2, the bytes too (67 MB, 0.020 ms), and there
// only 8192 x 2 outputs share the 132 SMs.
//
// The design.  A thread owns a column j and sums T_TILE tensors at once (2
// at W >= 6, 4 below; more tensors take more grid rows), so each M[i, j] is
// loaded once a row and tile, in 16-byte vectors: four int4 for an int32
// ft255 element (then packed to words, pack16), two for a 16-bit one, which
// already is 8 words (uint2 vectors where an element is not a multiple of 16
// bytes).  Products go into an exact Wide sum (wide.cuh mac: W^2 IMAD.WIDE on
// carry chains and 2W adds, a quarter of the L^2 products of 16-bit
// digits).  The block stages
// the tensors' rows t[:, i0:i0+64, :] as words in shared memory, so every
// warp reads them from there (one broadcast a word).  Where the outputs are
// few (collapse_row_warps: Ligero 2^20 and the PoS left-multiply each have
// 16384), the block's 8 warps split a column group's rows between them (warp
// r sums rows i = r mod row_warps, up to 8): each folds its exact partial
// sum into shared memory, and for each tensor one warp adds the partials
// (add_wide), reduces once (wide.cuh reduce_wide) and, for K3p, adds the
// accumulator mod p (out may alias acc_in: each output is read and written by
// the same thread).  No atomics, no second pass: at the paths' shapes, 8 row
// warps a column group give at least 2048 warps.
//
// What is left: on the 2^29 prove batch the kernel runs at about 2.6x its
// byte bound (chip_smoke.py), with W^2 IMAD.WIDE a row and tensor beside
// its loads and a block-wide barrier every 64 rows; PERF.md section 7 has
// the integer tensor cores as the next step.

#include <cstdint>
#include <cuda_runtime.h>

#include "wide.cuh"

namespace {

constexpr int kThreads = kCollapseWarps * 32;

// M[i, j]'s W words, from L int32 limbs (16-byte aligned: L % 4 == 0)
template <int W>
__device__ __forceinline__ void load_element(const int32_t* m, uint32_t (&w)[W]) {
    const int4* v = reinterpret_cast<const int4*>(m);
#pragma unroll
    for (int q = 0; q < W / 2; ++q) {
        const int4 e = v[q];
        w[2 * q] = pack16((uint32_t)e.x, (uint32_t)e.y);
        w[2 * q + 1] = pack16((uint32_t)e.z, (uint32_t)e.w);
    }
}

// from L 16-bit limbs: the words themselves, little-endian
template <int W>
__device__ __forceinline__ void load_element(const uint16_t* m, uint32_t (&w)[W]) {
    if constexpr (W % 4 == 0) {
        const uint4* v = reinterpret_cast<const uint4*>(m);
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
            const uint4 e = v[q];
            w[4 * q] = e.x;
            w[4 * q + 1] = e.y;
            w[4 * q + 2] = e.z;
            w[4 * q + 3] = e.w;
        }
    } else {
        const uint2* v = reinterpret_cast<const uint2*>(m);
#pragma unroll
        for (int q = 0; q < W / 2; ++q) {
            const uint2 e = v[q];
            w[2 * q] = e.x;
            w[2 * q + 1] = e.y;
        }
    }
}

// one output: reduce the sum, add the accumulator mod p (K3p), store limbs
template <int W>
__device__ __forceinline__ void finish(const uint32_t (&z)[2 * W + 1], const Barrett<W>& k,
                                       const Mod<W>& m, const int32_t* acc_in, int32_t* out) {
    uint32_t r[W];
    reduce_wide<W>(z, k, r);
    if (acc_in != nullptr) {
        uint32_t a[W], s[W];
        load_element<W>(acc_in, a);
        add_mod<W>(s, r, a, m);
#pragma unroll
        for (int i = 0; i < W; ++i) r[i] = s[i];
    }
    int4* o = reinterpret_cast<int4*>(out);
#pragma unroll
    for (int q = 0; q < W / 2; ++q)
        o[q] = make_int4((int)(r[2 * q] & 0xFFFFu), (int)(r[2 * q] >> 16),
                         (int)(r[2 * q + 1] & 0xFFFFu), (int)(r[2 * q + 1] >> 16));
}

// C: int32_t (one-shot commits) or uint16_t (the streamed commitment's
// 16-bit storage).  Grid: (column groups of 32 * (8 / rw), tensor tiles of TT).
// Warp (cg, r) of a block: column group cg, rows i = r mod rw.
template <int W, int TT, typename C>
__global__ void __launch_bounds__(kThreads) collapse(const C* __restrict__ coeffs,
                                                     const int32_t* __restrict__ tv,
                                                     const int32_t* acc_in, int32_t* out,
                                                     int rows, int npr, int T, int rw,
                                                     Barrett<W> k, Mod<W> m) {
    constexpr int L = 2 * W;
    constexpr int Z = 2 * W + 1;
    extern __shared__ uint32_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cg = warp / rw, wr = warp - cg * rw;
    const int64_t j = ((int64_t)blockIdx.x * (kCollapseWarps / rw) + cg) * 32 + lane;
    const bool live = j < npr;
    const int t0 = blockIdx.y * TT;
    const int nt = min(TT, T - t0);

    Wide<W> s[TT];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) wide_zero<W>(s[tt]);
    uint32_t* tw = smem;   // [TT][kCollapseChunk][W] words of the staged rows
    for (int i0 = 0; i0 < rows; i0 += kCollapseChunk) {
        const int n = min(kCollapseChunk, rows - i0);
        __syncthreads();
        for (int e = threadIdx.x; e < TT * kCollapseChunk * W; e += kThreads) {
            const int tt = e / (kCollapseChunk * W), ii = e / W % kCollapseChunk, w = e % W;
            uint32_t v = 0;
            if (tt < nt && ii < n) {
                const int32_t* src = tv + ((int64_t)(t0 + tt) * rows + i0 + ii) * L + 2 * w;
                v = pack16((uint32_t)src[0], (uint32_t)src[1]);
            }
            tw[e] = v;
        }
        __syncthreads();
        if (!live) continue;
#pragma unroll 4
        for (int ii = wr; ii < n; ii += rw) {
            uint32_t mw[W];
            load_element<W>(coeffs + ((int64_t)(i0 + ii) * npr + j) * L, mw);
#pragma unroll
            for (int tt = 0; tt < TT; ++tt) {
                if (tt < nt) {
                    uint32_t t[W];
                    const uint32_t* src = tw + (tt * kCollapseChunk + ii) * W;
#pragma unroll
                    for (int w = 0; w < W; ++w) t[w] = src[w];
                    mac<W>(s[tt], t, mw);
                }
            }
        }
    }

    if (rw == 1) {
        if (!live) return;
#pragma unroll
        for (int tt = 0; tt < TT; ++tt) {
            if (tt < nt) {
                uint32_t z[Z];
                fold<W>(s[tt], z);
                const int64_t o = ((int64_t)(t0 + tt) * npr + j) * L;
                finish<W>(z, k, m, acc_in ? acc_in + o : nullptr, out + o);
            }
        }
        return;
    }
    // the row warps' partial sums: part[warp][tt][word][lane]
    __syncthreads();
    uint32_t* part = smem;
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
        uint32_t z[Z];
        fold<W>(s[tt], z);
#pragma unroll
        for (int d = 0; d < Z; ++d) part[((warp * TT + tt) * Z + d) * 32 + lane] = z[d];
    }
    __syncthreads();
    if (!live) return;
    for (int tt = wr; tt < nt; tt += rw) {
        const uint32_t* first = part + ((cg * rw * TT + tt) * Z) * 32 + lane;
        uint32_t z[Z];
#pragma unroll
        for (int d = 0; d < Z; ++d) z[d] = first[d * 32];
        for (int q = 1; q < rw; ++q) add_wide<W>(z, first + q * TT * Z * 32, 32);
        const int64_t o = ((int64_t)(t0 + tt) * npr + j) * L;
        finish<W>(z, k, m, acc_in ? acc_in + o : nullptr, out + o);
    }
}

template <int W, typename C>
int launch(const void* coeffs, const int32_t* t, const int32_t* acc, int32_t* out, int rows,
           int npr, int T, const uint32_t* p_host, const uint32_t* mu_host, int mu_len,
           cudaStream_t st) {
    constexpr int TT = collapse_t_tile(W);
    Barrett<W> k;
    if (!make_barrett<W>(k, p_host, mu_host, mu_len)) return (int)cudaErrorInvalidValue;
    const Mod<W> m = make_mod<W>(k.p);
    const int rw = collapse_row_warps(rows, npr, T, W);
    const int64_t cols_a_block = 32 * (kCollapseWarps / rw);
    const dim3 grid((unsigned)((npr + cols_a_block - 1) / cols_a_block),
                    (unsigned)((T + TT - 1) / TT));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    // shared memory: the staged rows, then the row warps' partial sums
    constexpr size_t kStage = (size_t)TT * kCollapseChunk * W;
    constexpr size_t kParts = (size_t)kCollapseWarps * TT * (2 * W + 1) * 32;
    static_assert(4 * kParts <= 48 * 1024 && kStage <= kParts, "fits the default 48 KB");
    const size_t smem = 4 * (rw > 1 ? kParts : kStage);
    auto kernel = collapse<W, TT, C>;
    kernel<<<grid, kThreads, smem, st>>>(static_cast<const C*>(coeffs), t, acc, out, rows, npr,
                                         T, rw, k, m);
    return (int)cudaGetLastError();
}

template <typename C>
int dispatch(const void* coeffs, const void* t, const void* acc, void* out, int rows, int npr,
             int T, int L, const void* p_host, const void* mu_host, int mu_len, void* stream) {
    auto tv = static_cast<const int32_t*>(t);
    auto a = static_cast<const int32_t*>(acc);
    auto o = static_cast<int32_t*>(out);
    auto p = static_cast<const uint32_t*>(p_host);
    auto mu = static_cast<const uint32_t*>(mu_host);
    auto st = static_cast<cudaStream_t>(stream);
    if (rows < 0 || (uint32_t)rows > kMaxTerms) return (int)cudaErrorInvalidValue;
    switch (L) {
        case 4: return launch<2, C>(coeffs, tv, a, o, rows, npr, T, p, mu, mu_len, st);
        case 8: return launch<4, C>(coeffs, tv, a, o, rows, npr, T, p, mu, mu_len, st);
        case 12: return launch<6, C>(coeffs, tv, a, o, rows, npr, T, p, mu, mu_len, st);
        case 16: return launch<8, C>(coeffs, tv, a, o, rows, npr, T, p, mu, mu_len, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// coeffs: (rows, npr, L) limbs, int32 (coeff_bits 32) or 16-bit (16), 16-byte
// aligned (8 where L % 8 != 0 and 16-bit); t: (T, rows, L) int32 limbs; acc:
// null (K3), or (T, npr, L) canonical int32 limbs added mod p (K3p, the
// streamed collapse's step); out: (T, npr, L) int32 canonical limbs, which
// may be acc itself; acc and out 16-byte aligned; p_host: L host limbs of p;
// mu_host: mu_len host limbs of floor(2^(16 (2L+2)) / p).
int lcpc_collapse(const void* coeffs, int coeff_bits, const void* t, const void* acc,
                  void* out, int rows, int npr, int T, int L, const void* p_host,
                  const void* mu_host, int mu_len, void* stream) {
    if (coeff_bits == 32)
        return dispatch<int32_t>(coeffs, t, acc, out, rows, npr, T, L, p_host, mu_host, mu_len,
                                 stream);
    if (coeff_bits == 16)
        return dispatch<uint16_t>(coeffs, t, acc, out, rows, npr, T, L, p_host, mu_host,
                                  mu_len, stream);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
