// K3 and K3p: tensor collapse v_t = sum_i t[t, i] * M[i, :] mod p, for
// sm_90a.
//
// Replaces: lcpc_proof_of_storage_tpu/ops/collapse_pallas.py,
// collapse_tensors_natural (_natural_kernel / _natural_call) together with
// its in-kernel reduction, ops/expander_pallas.py _barrett_rows (K3); and
// collapse_tensors (_collapse_kernel / _collapse_call, the packed kernel that
// core/streamed.py collapse_streamed calls once per row batch) with that
// caller's per-batch field add (K3p: the same entry given an accumulator).  The TPU's packed
// limb-pair layout only halved VMEM bytes; here both entries read the
// coefficient matrix as stored, int32 limbs or the streamed commitment's
// 16-bit limbs.
//
// One thread per output element (t, j).  It walks all rows i, adding the
// exact 16x16-bit limb products t[t, i, a] * M[i, j, b] into 2L 64-bit digit
// accumulators.  A row adds less than L * 2^32 to a digit, so the sums stay
// exact for any row count below 2^28 (the wrapper enforces 2^27): there is
// no per-chunk row bound like the TPU kernel's 2048 rows and no partial sums
// to combine.  The accumulators are then carry-normalised and reduced by
// barrett.cuh (the truncated Barrett of fields/limb.py at width 2L+2, shared
// with K5), so the output is canonical and bit-equal to LimbField.dot.
//
// What bounds it on the H100: at the 2^20 ft255 prove the matrix is
// (128, 8192, 16) limbs = 64 MB read once per call, 19 us at the data
// sheet's 3.35 TB/s; counted in 32-bit words (W = 8), a row and element take
// W^2 = 64 multiply-adds, 0.27 G integer operations for T = 2, 8 us at the
// card's 33.5 T 32-bit integer operations/s.  So the bound is 19 us, by
// bytes.  The kernel multiplies 16-bit digits (L^2 = 256 64-bit
// multiply-adds a row and element, four times the word count) and has only
// 16384 threads to spread over 132 SMs (measured on an NVIDIA H100 80GB HBM3
// at 700 W: 0.16 ms in the profiler, 0.23 ms per call with the launch).
// Splitting the rows over threads (a second reduction pass) is the next
// step.  Neighbouring threads read neighbouring 64-byte elements of the same
// row, so the matrix reads are coalesced.  K3p at the 2^29 ft255 prove reads
// the (2048, 262144, 16) 16-bit matrix once over 16 row batches, 17.2 GB,
// 5.1 ms at 3.35 TB/s: measured 1.50 ms a 128-row batch (bound 0.34 ms), so
// about 24 ms of a 0.80 s pass whose host copies into pinned memory set the
// pace (same card).

#include "barrett.cuh"

namespace {

__device__ __forceinline__ uint32_t limb(int32_t v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t limb(uint16_t v) { return (uint32_t)v; }

// C: the coefficient limb type, int32_t (one-shot commits) or uint16_t (the
// streamed commitment's 16-bit storage).  acc: null, or (T, npr, L)
// canonical limbs added mod p to the result (r + acc < 2p: one conditional
// subtraction); out may alias acc.
template <int L, typename C>
__global__ void collapse(const C* __restrict__ coeffs, const int32_t* __restrict__ tv,
                         const int32_t* acc_in, int32_t* out, int rows, int npr, int T,
                         BarrettConsts<L> k) {
    int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (int64_t)T * npr) return;
    const int64_t ti = idx / npr, j = idx - ti * npr;

    uint64_t acc[2 * L];
#pragma unroll
    for (int d = 0; d < 2 * L; ++d) acc[d] = 0;
    for (int i = 0; i < rows; ++i) {
        const C* m = coeffs + ((int64_t)i * npr + j) * L;
        const int32_t* t = tv + (ti * rows + i) * L;
        uint32_t mv[L], tl[L];
#pragma unroll
        for (int a = 0; a < L; ++a) {
            mv[a] = limb(m[a]);
            tl[a] = (uint32_t)t[a];
        }
#pragma unroll
        for (int a = 0; a < L; ++a)
#pragma unroll
            for (int b = 0; b < L; ++b) acc[a + b] += (uint64_t)(tl[a] * mv[b]);
    }
    int32_t r[L];
    reduce_digit_sums<L>(acc, k, r);
    if (acc_in != nullptr) {
        const int32_t* av = acc_in + idx * L;
        uint32_t s[L + 1], d[L + 1];
        uint32_t carry = 0;
#pragma unroll
        for (int a = 0; a < L; ++a) {
            uint32_t v = (uint32_t)r[a] + (uint32_t)av[a] + carry;
            s[a] = v & 0xFFFFu;
            carry = v >> 16;
        }
        s[L] = carry;
        int32_t borrow = 0;
#pragma unroll
        for (int a = 0; a <= L; ++a) {
            int32_t v = (int32_t)s[a] - (int32_t)(a < L ? k.p[a] : 0u) - borrow;
            borrow = v < 0;
            d[a] = (uint32_t)(v & 0xFFFF);
        }
#pragma unroll
        for (int a = 0; a < L; ++a) r[a] = (int32_t)(borrow ? s[a] : d[a]);
    }
#pragma unroll
    for (int a = 0; a < L; ++a) out[idx * L + a] = r[a];
}

constexpr int kThreads = 128;

template <int L, typename C>
int launch(const void* coeffs, const int32_t* t, const int32_t* acc, int32_t* out, int rows,
           int npr, int T, const uint32_t* p_host, const uint32_t* mu_host, int mu_len,
           cudaStream_t st) {
    BarrettConsts<L> k;
    if (!load_barrett_consts<L>(k, p_host, mu_host, mu_len)) return (int)cudaErrorInvalidValue;
    int64_t total = (int64_t)T * npr;
    unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    collapse<L, C><<<blocks, kThreads, 0, st>>>(static_cast<const C*>(coeffs), t, acc, out,
                                                 rows, npr, T, k);
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
    switch (L) {
        case 4: return launch<4, C>(coeffs, tv, a, o, rows, npr, T, p, mu, mu_len, st);
        case 8: return launch<8, C>(coeffs, tv, a, o, rows, npr, T, p, mu, mu_len, st);
        case 12: return launch<12, C>(coeffs, tv, a, o, rows, npr, T, p, mu, mu_len, st);
        case 16: return launch<16, C>(coeffs, tv, a, o, rows, npr, T, p, mu, mu_len, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// coeffs: (rows, npr, L) limbs, int32 (coeff_bits 32) or 16-bit (16);
// t: (T, rows, L) int32 limbs; acc: null (K3), or (T, npr, L) canonical
// int32 limbs added mod p (K3p, the streamed collapse's step); out: (T, npr,
// L) int32 canonical limbs, which may be acc itself; p_host: L host limbs of
// p; mu_host: mu_len host limbs of floor(2^(16 (2L+2)) / p).
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
