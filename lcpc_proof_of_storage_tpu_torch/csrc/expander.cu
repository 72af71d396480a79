// K5: one Brakedown expander level y = A x mod p, for sm_90a.
//
// Replaces: lcpc_proof_of_storage_tpu/ops/expander_pallas.py, both regimes
// of the TPU kernel: the one-pass kernel (_onepass_kernel / _onepass_call,
// all K gather slots in one VMEM pass, in-kernel carry and Barrett) and the
// group kernel (_group_kernel[_packed] / _group_call[_packed], G = 8 slots a
// pass with the raw-digit accumulator aliased through HBM), which the TPU
// needed when K > 2^15 / L because it summed digits in uint32.
//
// A is stored in row-gather form (ops/expander.py GatherTables): for output
// row r, slots k < counts[r] hold the input column idx[k, r] and the value
// vals[k, :, r]; y[b, r] = sum_k vals[k, r] * x[b, idx[k, r]].  One thread
// per output (b, r) sums the exact 16x16-bit limb products of its slots into
// 2L 64-bit digit accumulators (one IMAD.WIDE each) and finishes with the
// carry and truncated Barrett of barrett.cuh, shared with K3.
//
// Slot bound: a slot adds at most L products below 2^32 to a digit, so K
// slots stay below K * L * 2^32; with K <= 2^26 (ops/expander.py MAX_SLOTS)
// and L <= 16 that is < 2^62, exact in 64 bits, and the value is below
// 2^26 * p^2 < b^(2L+2), inside the Barrett's width.  One kernel therefore
// covers every K up to 2^26: there is no one-pass / group split.
//
// Layout and threads.  vals is (K, L, rows) and idx (K, rows), so the 32
// threads of a warp (32 neighbouring rows) read 32 neighbouring words of
// each table row; x is (b, cols, L) and each slot gathers one whole element
// (L*4 bytes, 16-byte aligned) with int4 loads.  The grid is (b, row tiles)
// with b the fastest index, so the b blocks of one row tile run together
// and read its table entries from DRAM once, then from L2.  No limb-pair
// packing: the TPU packed pairs to halve VMEM bytes, which buys nothing here.
//
// What bounds it on the H100, at the 2^21 ft255 SdigCode3 encode (18 rows,
// 12 levels, 2,040,699 nonzeros a row, 181,786 input and 61,260 output
// elements a row, 3.56 M padded slots).  Operations are counted as for every
// kernel of the port, in 32-bit words: a slot product of two 8-word elements
// is 64 multiply-adds, so 18 * 2.04 M products are 2.35 G multiply-adds =
// 4.7 G integer operations, 0.140 ms at the card's 33.5 T 32-bit integer
// operations/s (64 INT32 lanes an SM, half its FP32 lanes); the bytes (x
// 209 MB, used table slots 139 MB, y 71 MB) take 0.125 ms at 3.35 TB/s.  So
// the bound is 0.14 ms, by operations.  This kernel multiplies 16-bit
// digits, four times as many products as words, one IMAD.WIDE each
// (prediction before the first run: 1.5-4 ms for the 12 levels).

#include <cstdint>
#include <cuda_runtime.h>

#include "barrett.cuh"

namespace {

template <int L>
__global__ void expander_matvec(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ vals,
                                const int32_t* __restrict__ counts, int32_t* __restrict__ out,
                                int cols, int rows, BarrettConsts<L> k) {
    static_assert(L % 4 == 0, "an element is whole int4 words");
    const int bi = blockIdx.x;
    const int r = blockIdx.y * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    const int4* xb = reinterpret_cast<const int4*>(x + (int64_t)bi * cols * L);

    uint64_t acc[2 * L];
#pragma unroll
    for (int d = 0; d < 2 * L; ++d) acc[d] = 0;
    const int n = counts[r];
    for (int s = 0; s < n; ++s) {
        const int j = idx[(int64_t)s * rows + r];
        const int32_t* vs = vals + (int64_t)s * L * rows + r;
        uint32_t v[L], a[L];
#pragma unroll
        for (int t = 0; t < L; ++t) v[t] = (uint32_t)vs[(int64_t)t * rows];
        const int4* xe = xb + (int64_t)j * (L / 4);
#pragma unroll
        for (int q = 0; q < L / 4; ++q) {
            const int4 w = xe[q];
            a[4 * q] = (uint32_t)w.x;
            a[4 * q + 1] = (uint32_t)w.y;
            a[4 * q + 2] = (uint32_t)w.z;
            a[4 * q + 3] = (uint32_t)w.w;
        }
#pragma unroll
        for (int t = 0; t < L; ++t)
#pragma unroll
            for (int c = 0; c < L; ++c) acc[t + c] += (uint64_t)v[t] * a[c];
    }
    reduce_digit_sums<L>(acc, k, out + ((int64_t)bi * rows + r) * L);
}

constexpr int kThreads = 128;

template <int L>
int launch(const int32_t* x, const int32_t* idx, const int32_t* vals, const int32_t* counts,
           int32_t* out, int b, int cols, int rows, const uint32_t* p_host,
           const uint32_t* mu_host, int mu_len, cudaStream_t st) {
    BarrettConsts<L> k;
    if (!load_barrett_consts<L>(k, p_host, mu_host, mu_len)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)b, (unsigned)((rows + kThreads - 1) / kThreads));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    expander_matvec<L><<<grid, kThreads, 0, st>>>(x, idx, vals, counts, out, cols, rows, k);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (b, cols, L) int32 canonical limbs, 16-byte aligned; idx: (K, rows)
// int32; vals: (K, L, rows) int32 limbs; counts: (rows,) int32 slots in use
// (each <= K); out: (b, rows, L) int32 canonical limbs; p_host: L host limbs of
// p; mu_host: mu_len host limbs of floor(2^(16 (2L+2)) / p).
int lcpc_expander_matvec(const void* x, const void* idx, const void* vals, const void* counts,
                         void* out, int b, int cols, int rows, int L, const void* p_host,
                         const void* mu_host, int mu_len, void* stream) {
    auto xv = static_cast<const int32_t*>(x);
    auto iv = static_cast<const int32_t*>(idx);
    auto vv = static_cast<const int32_t*>(vals);
    auto cv = static_cast<const int32_t*>(counts);
    auto o = static_cast<int32_t*>(out);
    auto p = static_cast<const uint32_t*>(p_host);
    auto mu = static_cast<const uint32_t*>(mu_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (L) {
        case 4: return launch<4>(xv, iv, vv, cv, o, b, cols, rows, p, mu, mu_len, st);
        case 8: return launch<8>(xv, iv, vv, cv, o, b, cols, rows, p, mu, mu_len, st);
        case 12: return launch<12>(xv, iv, vv, cv, o, b, cols, rows, p, mu, mu_len, st);
        case 16: return launch<16>(xv, iv, vv, cv, o, b, cols, rows, p, mu, mu_len, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
