// Multi-word Montgomery arithmetic mod p, shared by K1 / K4 (ntt.cu) and
// KT / KM (ntt_tile.cu).
//
// A field value is W = L/2 32-bit words, least significant first, canonical
// (< p).  add_mod and sub_mod keep it canonical; mont_mul(a, b) is
// a * b * 2^(-32W) mod p (CIOS), canonical for canonical inputs, so a
// product by a constant stored in Montgomery form (c * 2^(32W) mod p) is the
// plain product a * c mod p and no value ever leaves the normal form.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <int W>
struct Mod {
    uint32_t p[W];
    uint32_t pinv;  // -p^{-1} mod 2^32
};

template <int W>
__device__ __forceinline__ void add_mod(uint32_t r[W], const uint32_t a[W],
                                        const uint32_t b[W], const Mod<W>& m) {
    uint32_t s[W];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        c = (uint64_t)a[i] + b[i] + (c >> 32);
        s[i] = (uint32_t)c;
    }
    uint32_t carry = (uint32_t)(c >> 32);
    uint32_t d[W];
    int64_t br = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        int64_t v = (int64_t)s[i] - m.p[i] - br;
        d[i] = (uint32_t)v;
        br = v < 0;
    }
    bool ge = carry || br == 0;
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = ge ? d[i] : s[i];
}

template <int W>
__device__ __forceinline__ void sub_mod(uint32_t r[W], const uint32_t a[W],
                                        const uint32_t b[W], const Mod<W>& m) {
    uint32_t d[W];
    int64_t br = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        int64_t v = (int64_t)a[i] - b[i] - br;
        d[i] = (uint32_t)v;
        br = v < 0;
    }
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        c = (uint64_t)d[i] + (br ? m.p[i] : 0u) + (c >> 32);
        r[i] = (uint32_t)c;
    }
}

// Montgomery product a * b * 2^(-32W) mod p (CIOS), canonical for a, b < p.
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t r[W], const uint32_t a[W],
                                         const uint32_t b[W], const Mod<W>& m) {
    uint32_t t[W + 2];
#pragma unroll
    for (int i = 0; i < W + 2; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            c = (uint64_t)a[j] * b[i] + t[j] + (c >> 32);
            t[j] = (uint32_t)c;
        }
        uint64_t s = (uint64_t)t[W] + (c >> 32);
        t[W] = (uint32_t)s;
        t[W + 1] = (uint32_t)(s >> 32);
        uint32_t q = t[0] * m.pinv;
        c = (uint64_t)q * m.p[0] + t[0];
#pragma unroll
        for (int j = 1; j < W; ++j) {
            c = (uint64_t)q * m.p[j] + t[j] + (c >> 32);
            t[j - 1] = (uint32_t)c;
        }
        s = (uint64_t)t[W] + (c >> 32);
        t[W - 1] = (uint32_t)s;
        t[W] = t[W + 1] + (uint32_t)(s >> 32);
    }
    // t < 2p: subtract p once if t >= p
    uint32_t d[W];
    int64_t br = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        int64_t v = (int64_t)t[i] - m.p[i] - br;
        d[i] = (uint32_t)v;
        br = v < 0;
    }
    bool ge = t[W] != 0 || br == 0;
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = ge ? d[i] : t[i];
}

// W words passed to a kernel by value
template <int W>
struct Words {
    uint32_t w[W];
};

// host: the constants of p from its W host words
template <int W>
Mod<W> make_mod(const uint32_t* p_host) {
    Mod<W> m;
    for (int i = 0; i < W; ++i) m.p[i] = p_host[i];
    uint32_t inv = m.p[0];  // Newton: inv = p0^{-1} mod 2^32
    for (int i = 0; i < 5; ++i) inv *= 2u - m.p[0] * inv;
    m.pinv = 0u - inv;
    return m;
}
