// K5: one Brakedown expander level y = A x mod p, for sm_90a.
//
// Replaces: lcpc_proof_of_storage_tpu/ops/expander_pallas.py, both regimes
// of the TPU kernel: the one-pass kernel (_onepass_kernel / _onepass_call,
// all K gather slots in one VMEM pass, in-kernel carry and Barrett) and the
// group kernel (_group_kernel[_packed] / _group_call[_packed], G = 8 slots a
// pass with the raw-digit accumulator aliased through HBM), which the TPU
// needed when K > 2^15 / L because it summed digits in uint32.  Here one
// kernel covers every K up to wide.cuh kMaxTerms.
//
// A is stored in row-gather form, rows ordered by their slot count
// (ops/expander.py GatherTables): table row r is output row order[r], its
// slots s < counts[r] hold the input column idx[s, r] and the value
// vals[s, :, r] as W 32-bit words; y[b, order[r]] = sum_s vals[s, r] *
// x[b, idx[s, r]].
//
// What bounds it on the H100, at the 2^21 ft255 SdigCode3 encode (b = 18
// batch rows, 12 levels, 2,040,699 nonzeros a batch row).  Counted in 32-bit
// words (W = 8), a slot product is 64 multiply-adds: 18 * 2.04 M products
// are 4.7 G integer operations, 0.140 ms at 33.5 T 32-bit integer
// operations/s; the bytes (x 209 MB, used table slots 73 MB, y 71 MB) take
// 0.10 ms at 3.35 TB/s.  So the operations bound it, and the design goes
// after the instructions a product takes and the lanes that idle:
//
// - Word products: the slot's value and each gathered x element (read with
//   int4 loads from the (b, cols, L) limbs and packed to words, pack16) are
//   W words, and wide.cuh mac sums their exact product on carry chains: W^2
//   IMAD.WIDE and 2W adds, a quarter of the L^2 products of 16-bit digits.
//   The reduction runs once an output (reduce_wide).
// - Balanced rows: a thread sums one table row, so a warp runs as long as
//   its longest row.  The tables are built with rows ordered by slot count
//   (longest first), so the 32 rows of a warp have near-equal counts: slot
//   use (nonzeros over the slot iterations the warps run, chip_smoke.py
//   prints it) rose from 0.7276 in the tables' own row order to 0.9947 at
//   2^21.
// - Reuse across the batch: each thread sums expander_b_tile batch rows at
//   once, so a slot's index and value, 36 bytes at ft255, are loaded once
//   for all of them.  At W >= 6 that is one batch row below 32 (62 registers, eight
//   blocks an SM) and two from 32 on, where the table reads start to count;
//   8 / W below W = 6.  The grid is (row tiles, batch tiles), row tiles
//   fastest, so the blocks in flight share a batch tile's x.
//
// What is left: the gathers.  Each slot product gathers one 64-byte x
// element (16 limbs in int32, twice the value's 32 bytes) from anywhere in
// x, 2.35 GB at 2^21 and 37 GB at the 2^25 commit (b = 143), while x itself
// (135 MB on the widest 2^21 level) outgrows the 50 MB L2.  A prefetch of
// the next slot's gathers into registers, and larger batch tiles, were
// slower on an H100 in a side-by-side trial.

#include <cstdint>
#include <cuda_runtime.h>

#include "wide.cuh"

namespace {

constexpr int kThreads = 128;

// x[b, j]'s W words from its L int32 limbs (16-byte aligned)
template <int W>
__device__ __forceinline__ void load_x(const int4* e, uint32_t (&w)[W]) {
#pragma unroll
    for (int q = 0; q < W / 2; ++q) {
        const int4 v = e[q];
        w[2 * q] = pack16((uint32_t)v.x, (uint32_t)v.y);
        w[2 * q + 1] = pack16((uint32_t)v.z, (uint32_t)v.w);
    }
}

template <int W, int BT>
__global__ void __launch_bounds__(kThreads) expander_matvec(
    const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
    const uint32_t* __restrict__ vals, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ order, int32_t* __restrict__ out, int b, int cols, int rows,
    Barrett<W> k) {
    constexpr int E = W / 2;   // int4 an element
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= rows) return;
    const int b0 = blockIdx.y * BT;
    const int nb = min(BT, b - b0);
    const int64_t bstride = (int64_t)cols * E;
    const int4* xb = reinterpret_cast<const int4*>(x) + b0 * bstride;

    Wide<W> s[BT];
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) wide_zero<W>(s[bb]);
    const int n = counts[r];
    int j = n > 0 ? idx[r] : 0;
    for (int q = 0; q < n; ++q) {
        const int jn = q + 1 < n ? idx[(int64_t)(q + 1) * rows + r] : 0;
        uint32_t v[W];
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = vals[((int64_t)q * W + w) * rows + r];
        const int4* xe = xb + (int64_t)j * E;
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
            if (bb < nb) {
                uint32_t a[W];
                load_x<W>(xe + bb * bstride, a);
                mac<W>(s[bb], v, a);
            }
        }
        j = jn;
    }

    const int row = order[r];
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) {
        if (bb < nb) {
            uint32_t z[2 * W + 1], y[W];
            fold<W>(s[bb], z);
            reduce_wide<W>(z, k, y);
            int4* o = reinterpret_cast<int4*>(out + ((int64_t)(b0 + bb) * rows + row) * 2 * W);
#pragma unroll
            for (int e = 0; e < E; ++e)
                o[e] = make_int4((int)(y[2 * e] & 0xFFFFu), (int)(y[2 * e] >> 16),
                                 (int)(y[2 * e + 1] & 0xFFFFu), (int)(y[2 * e + 1] >> 16));
        }
    }
}

template <int W, int BT>
int launch_tile(const int32_t* x, const int32_t* idx, const uint32_t* vals, const int32_t* counts,
                const int32_t* order, int32_t* out, int b, int cols, int rows,
                const Barrett<W>& k, cudaStream_t st) {
    const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads), (unsigned)((b + BT - 1) / BT));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    expander_matvec<W, BT><<<grid, kThreads, 0, st>>>(x, idx, vals, counts, order, out, b, cols,
                                                      rows, k);
    return (int)cudaGetLastError();
}

template <int W>
int launch(const int32_t* x, const int32_t* idx, const uint32_t* vals, const int32_t* counts,
           const int32_t* order, int32_t* out, int b, int cols, int rows,
           const uint32_t* p_host, const uint32_t* mu_host, int mu_len, cudaStream_t st) {
    Barrett<W> k;
    if (!make_barrett<W>(k, p_host, mu_host, mu_len)) return (int)cudaErrorInvalidValue;
    if constexpr (W >= 6) {
        if (expander_b_tile(W, b) == 2)
            return launch_tile<W, 2>(x, idx, vals, counts, order, out, b, cols, rows, k, st);
        return launch_tile<W, 1>(x, idx, vals, counts, order, out, b, cols, rows, k, st);
    } else {
        return launch_tile<W, expander_b_tile(W, 1)>(x, idx, vals, counts, order, out, b, cols,
                                                     rows, k, st);
    }
}

}  // namespace

extern "C" {

// x: (b, cols, L) int32 canonical limbs, 16-byte aligned; idx: (K, rows)
// int32; vals: (K, L/2, rows) 32-bit words; counts: (rows,) int32 slots in use
// (each <= K); order: (rows,) int32, the output row of each table row; out:
// (b, rows, L) int32 canonical limbs; p_host: L host limbs of p; mu_host:
// mu_len host limbs of floor(2^(16 (2L+2)) / p).
int lcpc_expander_matvec(const void* x, const void* idx, const void* vals, const void* counts,
                         const void* order, void* out, int b, int cols, int rows, int L,
                         const void* p_host, const void* mu_host, int mu_len, void* stream) {
    auto xv = static_cast<const int32_t*>(x);
    auto iv = static_cast<const int32_t*>(idx);
    auto vv = static_cast<const uint32_t*>(vals);
    auto cv = static_cast<const int32_t*>(counts);
    auto ov = static_cast<const int32_t*>(order);
    auto o = static_cast<int32_t*>(out);
    auto p = static_cast<const uint32_t*>(p_host);
    auto mu = static_cast<const uint32_t*>(mu_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (L) {
        case 4: return launch<2>(xv, iv, vv, cv, ov, o, b, cols, rows, p, mu, mu_len, st);
        case 8: return launch<4>(xv, iv, vv, cv, ov, o, b, cols, rows, p, mu, mu_len, st);
        case 12: return launch<6>(xv, iv, vv, cv, ov, o, b, cols, rows, p, mu, mu_len, st);
        case 16: return launch<8>(xv, iv, vv, cv, ov, o, b, cols, rows, p, mu, mu_len, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
