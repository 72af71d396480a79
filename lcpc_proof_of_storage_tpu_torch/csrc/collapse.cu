// K3: tensor collapse v_t = sum_i t[t, i] * M[i, :] mod p, for sm_90a.
//
// Replaces: lcpc_proof_of_storage_tpu/ops/collapse_pallas.py,
// collapse_tensors_natural (_natural_kernel / _natural_call) together with
// its in-kernel reduction, ops/expander_pallas.py _barrett_rows.
//
// One thread per output element (t, j).  It walks all rows i, adding the
// exact 16x16-bit limb products t[t, i, a] * M[i, j, b] into 2L 64-bit digit
// accumulators.  A row adds less than L * 2^32 to a digit, so the sums stay
// exact for any row count below 2^28 (the wrapper enforces 2^27): there is
// no per-chunk row bound like the TPU kernel's 2048 rows and no partial sums
// to combine.  The accumulators are then carry-normalised to 2L+2 16-bit
// digits and reduced with the truncated Barrett of fields/limb.py
// (barrett_reduce at width 2L+2, three conditional subtractions), so the
// output is canonical and bit-equal to LimbField.dot.
//
// What bounds it on the H100: at the 2^20 ft255 prove the matrix is
// (128, 8192, 16) limbs = 64 MB read once per call, 19 us at the data
// sheet's 3.35 TB/s; the L^2 = 256 64-bit multiply-adds per row and
// element are about 0.8 G integer operations for T = 2, so the kernel is
// bound by integer throughput and by the 16384 threads it has to spread
// over 132 SMs (measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.16 ms in
// the profiler, 0.23 ms per call with the launch).  Splitting the rows
// over threads (a second reduction pass) is the next step.  Neighbouring
// threads read neighbouring 64-byte elements of the same row, so the
// matrix reads are coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int L>
struct Consts {
    uint32_t p[L];
    uint32_t mu[L + 4];  // floor(2^(16 (2L+2)) / p) in 16-bit limbs, zero padded
};

template <int L>
__global__ void collapse(const int32_t* __restrict__ coeffs, const int32_t* __restrict__ tv,
                         int32_t* __restrict__ out, int rows, int npr, int T, Consts<L> k) {
    constexpr int M = 2 * L + 2;   // digits of the reduced-from value
    constexpr int Q = M - L + 1;   // digits of q1 = floor(z / b^(L-1))
    constexpr int MU = L + 4;
    int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (int64_t)T * npr) return;
    const int64_t ti = idx / npr, j = idx - ti * npr;

    uint64_t acc[2 * L];
#pragma unroll
    for (int d = 0; d < 2 * L; ++d) acc[d] = 0;
    for (int i = 0; i < rows; ++i) {
        const int32_t* m = coeffs + ((int64_t)i * npr + j) * L;
        const int32_t* t = tv + (ti * rows + i) * L;
        uint32_t mv[L], tl[L];
#pragma unroll
        for (int a = 0; a < L; ++a) {
            mv[a] = (uint32_t)m[a];
            tl[a] = (uint32_t)t[a];
        }
#pragma unroll
        for (int a = 0; a < L; ++a)
#pragma unroll
            for (int b = 0; b < L; ++b) acc[a + b] += (uint64_t)(tl[a] * mv[b]);
    }

    // z: the exact sum as M canonical 16-bit digits
    uint32_t z[M];
    uint64_t carry = 0;
#pragma unroll
    for (int d = 0; d < M; ++d) {
        uint64_t s = carry + (d < 2 * L ? acc[d] : 0);
        z[d] = (uint32_t)(s & 0xFFFFu);
        carry = s >> 16;
    }

    // q = floor(floor(z / b^(L-1)) * mu / b^(M-L+1))
    uint64_t qw[Q + MU];
#pragma unroll
    for (int d = 0; d < Q + MU; ++d) qw[d] = 0;
#pragma unroll
    for (int a = 0; a < Q; ++a)
#pragma unroll
        for (int b = 0; b < MU; ++b) qw[a + b] += (uint64_t)(z[L - 1 + a] * k.mu[b]);
    uint32_t q[MU];
    carry = 0;
#pragma unroll
    for (int d = 0; d < Q + MU; ++d) {
        uint64_t s = carry + qw[d];
        if (d >= Q) q[d - Q] = (uint32_t)(s & 0xFFFFu);
        carry = s >> 16;
    }

    // r = (z - q * p) mod b^(L+1), then r < 4p: three conditional subtractions
    uint64_t qp[L + 1];
#pragma unroll
    for (int d = 0; d <= L; ++d) qp[d] = 0;
#pragma unroll
    for (int a = 0; a < MU; ++a)
#pragma unroll
        for (int b = 0; b < L; ++b)
            if (a + b <= L) qp[a + b] += (uint64_t)(q[a] * k.p[b]);
    uint32_t r[L + 1];
    carry = 0;
    int64_t borrow = 0;
#pragma unroll
    for (int d = 0; d <= L; ++d) {
        uint64_t s = carry + qp[d];
        carry = s >> 16;
        int64_t v = (int64_t)z[d] - (int64_t)(s & 0xFFFFu) - borrow;
        borrow = v < 0;
        r[d] = (uint32_t)(v & 0xFFFF);
    }
#pragma unroll
    for (int rep = 0; rep < 3; ++rep) {
        uint32_t dd[L + 1];
        borrow = 0;
#pragma unroll
        for (int d = 0; d <= L; ++d) {
            int64_t v = (int64_t)r[d] - (d < L ? k.p[d] : 0u) - borrow;
            borrow = v < 0;
            dd[d] = (uint32_t)(v & 0xFFFF);
        }
        if (borrow == 0) {
#pragma unroll
            for (int d = 0; d <= L; ++d) r[d] = dd[d];
        }
    }
    int32_t* o = out + idx * L;
#pragma unroll
    for (int d = 0; d < L; ++d) o[d] = (int32_t)r[d];
}

constexpr int kThreads = 128;

template <int L>
int launch(const int32_t* coeffs, const int32_t* t, int32_t* out, int rows, int npr, int T,
           const uint32_t* p_host, const uint32_t* mu_host, int mu_len, cudaStream_t st) {
    if (mu_len > L + 4) return (int)cudaErrorInvalidValue;
    Consts<L> k;
    for (int i = 0; i < L; ++i) k.p[i] = p_host[i];
    for (int i = 0; i < L + 4; ++i) k.mu[i] = i < mu_len ? mu_host[i] : 0u;
    int64_t total = (int64_t)T * npr;
    unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    collapse<L><<<blocks, kThreads, 0, st>>>(coeffs, t, out, rows, npr, T, k);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// coeffs: (rows, npr, L) int32 limbs; t: (T, rows, L) int32 limbs;
// out: (T, npr, L) int32 canonical limbs; p_host: L host limbs of p;
// mu_host: mu_len host limbs of floor(2^(16 (2L+2)) / p).
int lcpc_collapse(const void* coeffs, const void* t, void* out, int rows, int npr, int T,
                  int L, const void* p_host, const void* mu_host, int mu_len, void* stream) {
    auto c = static_cast<const int32_t*>(coeffs);
    auto tv = static_cast<const int32_t*>(t);
    auto o = static_cast<int32_t*>(out);
    auto p = static_cast<const uint32_t*>(p_host);
    auto mu = static_cast<const uint32_t*>(mu_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (L) {
        case 4: return launch<4>(c, tv, o, rows, npr, T, p, mu, mu_len, st);
        case 8: return launch<8>(c, tv, o, rows, npr, T, p, mu, mu_len, st);
        case 12: return launch<12>(c, tv, o, rows, npr, T, p, mu, mu_len, st);
        case 16: return launch<16>(c, tv, o, rows, npr, T, p, mu, mu_len, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
