// Reduction of 64-bit digit sums mod p, shared by K3 (collapse.cu) and K5
// (expander.cu).
//
// Both kernels sum exact 16x16-bit limb products into 2L 64-bit digit
// accumulators.  reduce_digit_sums carry-normalises them to M = 2L+2
// canonical 16-bit digits z and reduces z mod p with the truncated Barrett of
// fields/limb.py (barrett_reduce at width 2L+2; the reference's
// ops/expander_pallas.py _barrett_rows): q = floor(floor(z / b^(L-1)) * mu /
// b^(M-L+1)) with mu = floor(b^M / p), r = (z - q p) mod b^(L+1) < 4p, then
// three conditional subtractions.  The output is canonical, bit-equal to
// LimbField.dot on the same sums.  Exact while z < b^M, that is while the
// digit sums come from fewer than 2^32 products of canonical values, and
// while each 64-bit digit sum stays below 2^63 (the callers' row and slot
// bounds).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int L>
struct BarrettConsts {
    uint32_t p[L];
    uint32_t mu[L + 4];  // floor(2^(16 (2L+2)) / p) in 16-bit limbs, zero padded
};

// Fill the constants from host limbs; false if mu has more limbs than fit.
template <int L>
inline bool load_barrett_consts(BarrettConsts<L>& k, const uint32_t* p_host,
                                const uint32_t* mu_host, int mu_len) {
    if (mu_len > L + 4) return false;
    for (int i = 0; i < L; ++i) k.p[i] = p_host[i];
    for (int i = 0; i < L + 4; ++i) k.mu[i] = i < mu_len ? mu_host[i] : 0u;
    return true;
}

template <int L>
__device__ __forceinline__ void reduce_digit_sums(const uint64_t (&acc)[2 * L],
                                                  const BarrettConsts<L>& k,
                                                  int32_t* __restrict__ o) {
    constexpr int M = 2 * L + 2;   // digits of the reduced-from value
    constexpr int Q = M - L + 1;   // digits of q1 = floor(z / b^(L-1))
    constexpr int MU = L + 4;

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
#pragma unroll
    for (int d = 0; d < L; ++d) o[d] = (int32_t)r[d];
}
