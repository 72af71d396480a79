// Multi-word Montgomery arithmetic mod p on 32-bit carry chains, shared by
// K1 / K4 (ntt.cu) and KT / KM (ntt_tile.cu).
//
// Replaces the limb arithmetic of the NTT kernels in
// lcpc_proof_of_storage_tpu/ops/ (ntt_pallas3.py _call_a / _call_b,
// ntt_pallas2.py _in_tile_call / _large_pair_call, ntt_pallas.py), which
// multiply 16-bit limbs in 32-bit lanes with a Barrett reduction: here a field
// value is W = L/2 32-bit words, least significant first, canonical (< p).
// add_mod and sub_mod keep it canonical; mont_mul(a, b) is a * b * 2^(-32W)
// mod p, canonical for canonical inputs, so a product by a constant stored in
// Montgomery form (c * 2^(32W) mod p) is the plain product a * c mod p and no
// value ever leaves the normal form.
//
// Every carry runs through the PTX carry flag: add.cc / addc.cc / addc,
// sub.cc / subc.cc / subc, mad.lo.cc / madc.lo.cc / madc.hi.cc / madc.hi,
// one instruction a 32-bit word (namespace cc below), where the version
// before this one carried through 64-bit sums and sign tests.
//
// mont_mul is the even/odd form of word-serial Montgomery multiplication
// (the one sppark's mont_t uses).  Each row i adds a * b[i] and m * p (m =
// t[0] * -p^-1 mod 2^32) to an accumulator kept as two W-word halves: E holds
// the products of the even words a[0], a[2], ... (a product of a[2k] fills
// the word pair 2k, 2k+1) and O those of the odd words, one word up.  So each
// half takes its W/2 products as one unbroken mad.lo / madc.hi chain with no
// add between the lo and hi halves of a product, where CIOS would need two
// chains (the lo halves, then the hi halves) and an add to join them.  The
// one-word shift of each row is the swap of E and O: the new O takes the old
// E two words down inside its first chain (madc_n_rshift).  Cost: 4 W^2
// multiply-adds and about 5 W adds a product, then one conditional subtract.
// It needs W even (2, 4, 6, 8 here) and p < 2^(32W - 1): then every row's
// sum, before its shift, is below 2^(32(W+1)), so O's chains never carry out
// and E's carry out goes into O's top word (ft63, ft127, ft191, ft255 and
// ft253_192 all leave their top bit free).  W = 2 takes the same path.
//
// ptxas turns each mad.lo / madc.hi pair into one IMAD.WIDE with carry.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, K1 runs at
// 3.2x its operations bound at the Ligero 2^20 commit's shape (0.80 ms, from
// 6.39 ms on 64-bit sums), and KT at 2.3-3.1x its own.  KM is bound by its
// bytes, not by this arithmetic: one product a value (by b R mod p) at
// (4194304, 16) x (1, 16) takes 0.25 ms, 2.1 TB/s (ntt_tile.cu).
//
// With a host compiler (no __CUDACC__) the cc functions emulate the carry
// flag, so the same source is checked against Python integers on a CPU
// (tests/test_torch_montgomery.py).

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define LCPC_DEV __device__ __forceinline__
#else
#define LCPC_DEV inline
#endif

template <int W>
struct Mod {
    uint32_t p[W];
    uint32_t pinv;  // -p^{-1} mod 2^32
};

// One PTX instruction each.  The carry flag CC links the instructions of a
// chain: a chain starts with an instruction that only writes it (add.cc,
// sub.cc, mad.lo.cc) and ends with one that only reads it (addc, subc, madc.hi).
namespace cc {
#if defined(__CUDACC__)
#define LCPC_ASM2(op) \
    uint32_t r;       \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); \
    return r;
#define LCPC_ASM3(op) \
    uint32_t r;       \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;
LCPC_DEV uint32_t add_cc(uint32_t a, uint32_t b) { LCPC_ASM2("add.cc.u32") }
LCPC_DEV uint32_t addc_cc(uint32_t a, uint32_t b) { LCPC_ASM2("addc.cc.u32") }
LCPC_DEV uint32_t addc(uint32_t a, uint32_t b) { LCPC_ASM2("addc.u32") }
LCPC_DEV uint32_t sub_cc(uint32_t a, uint32_t b) { LCPC_ASM2("sub.cc.u32") }
LCPC_DEV uint32_t subc_cc(uint32_t a, uint32_t b) { LCPC_ASM2("subc.cc.u32") }
LCPC_DEV uint32_t subc(uint32_t a, uint32_t b) { LCPC_ASM2("subc.u32") }
LCPC_DEV uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { LCPC_ASM3("mad.lo.cc.u32") }
LCPC_DEV uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { LCPC_ASM3("madc.lo.cc.u32") }
LCPC_DEV uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) { LCPC_ASM3("madc.hi.cc.u32") }
LCPC_DEV uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { LCPC_ASM3("madc.hi.u32") }
LCPC_DEV uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
#undef LCPC_ASM2
#undef LCPC_ASM3
#else
inline thread_local uint32_t flag = 0;
inline uint32_t set(uint64_t s) {
    flag = (uint32_t)(s >> 32) & 1u;
    return (uint32_t)s;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) { return set((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return set((uint64_t)a + b + flag); }
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + flag; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return set((uint64_t)a - b); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) { return set((uint64_t)a - b - flag); }
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - flag; }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return set((uint64_t)(a * b) + c);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return set((uint64_t)(a * b) + c + flag);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return set((((uint64_t)a * b) >> 32) + c + flag);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)(((uint64_t)a * b) >> 32) + c + flag;
}
inline uint32_t mul_hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
#endif
}  // namespace cc

template <int W>
LCPC_DEV void add_mod(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                      const Mod<W>& m) {
    uint32_t s[W], d[W];
    s[0] = cc::add_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < W - 1; ++i) s[i] = cc::addc_cc(a[i], b[i]);
    s[W - 1] = cc::addc(a[W - 1], b[W - 1]);  // a + b < 2p < 2^(32W)
    d[0] = cc::sub_cc(s[0], m.p[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) d[i] = cc::subc_cc(s[i], m.p[i]);
    const uint32_t below = cc::subc(0u, 0u);  // all ones when s < p
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = below ? s[i] : d[i];
}

template <int W>
LCPC_DEV void sub_mod(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                      const Mod<W>& m) {
    uint32_t d[W];
    d[0] = cc::sub_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) d[i] = cc::subc_cc(a[i], b[i]);
    const uint32_t mask = cc::subc(0u, 0u);  // all ones when a < b
    r[0] = cc::add_cc(d[0], m.p[0] & mask);
#pragma unroll
    for (int i = 1; i < W - 1; ++i) r[i] = cc::addc_cc(d[i], m.p[i] & mask);
    r[W - 1] = cc::addc(d[W - 1], m.p[W - 1] & mask);
}

namespace mont {

// acc = a[0], a[2], ... times bi, the product of a[2k] on the words 2k, 2k+1
template <int W>
LCPC_DEV void mul_n(uint32_t acc[W], const uint32_t* a, uint32_t bi) {
#pragma unroll
    for (int j = 0; j < W; j += 2) {
        acc[j] = a[j] * bi;
        acc[j + 1] = cc::mul_hi(a[j], bi);
    }
}

// acc += a[0], a[2], ... times bi, one chain; its carry out is left in CC
template <int W>
LCPC_DEV void cmad_n(uint32_t acc[W], const uint32_t* a, uint32_t bi) {
    acc[0] = cc::mad_lo_cc(a[0], bi, acc[0]);
    acc[1] = cc::madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
    for (int j = 2; j < W; j += 2) {
        acc[j] = cc::madc_lo_cc(a[j], bi, acc[j]);
        acc[j + 1] = cc::madc_hi_cc(a[j], bi, acc[j + 1]);
    }
}

// acc = (acc two words down) + a[0], a[2], ... times bi + CC, one chain
template <int W>
LCPC_DEV void madc_n_rshift(uint32_t acc[W], const uint32_t* a, uint32_t bi) {
#pragma unroll
    for (int j = 0; j < W - 2; j += 2) {
        acc[j] = cc::madc_lo_cc(a[j], bi, acc[j + 2]);
        acc[j + 1] = cc::madc_hi_cc(a[j], bi, acc[j + 3]);
    }
    acc[W - 2] = cc::madc_lo_cc(a[W - 2], bi, 0u);
    acc[W - 1] = cc::madc_hi(a[W - 2], bi, 0u);
}

// one row: (even, odd) holds t = even + odd * 2^32 (after the previous
// row's reduction, not yet shifted, unless first); adds a * bi and m * p
template <int W>
LCPC_DEV void mad_n_redc(uint32_t even[W], uint32_t odd[W], const uint32_t a[W], uint32_t bi,
                         const Mod<W>& m, bool first) {
    if (first) {
        mul_n<W>(odd, a + 1, bi);
        mul_n<W>(even, a, bi);
    } else {
        even[0] = cc::add_cc(even[0], odd[1]);
        madc_n_rshift<W>(odd, a + 1, bi);
        cmad_n<W>(even, a, bi);
        odd[W - 1] = cc::addc(odd[W - 1], 0u);
    }
    const uint32_t mi = even[0] * m.pinv;
    cmad_n<W>(odd, m.p + 1, mi);
    cmad_n<W>(even, m.p, mi);
    odd[W - 1] = cc::addc(odd[W - 1], 0u);
}

}  // namespace mont

// Montgomery product a * b * 2^(-32W) mod p, canonical for a, b < p < 2^(32W-1).
template <int W>
LCPC_DEV void mont_mul(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                       const Mod<W>& m) {
    static_assert(W % 2 == 0 && W >= 2, "mont_mul takes an even number of words");
    uint32_t even[W], odd[W];
#pragma unroll
    for (int i = 0; i < W; i += 2) {
        mont::mad_n_redc<W>(even, odd, a, b[i], m, i == 0);
        mont::mad_n_redc<W>(odd, even, a, b[i + 1], m, false);
    }
    // the last row's shift: t = odd (words 0 .. W-1, word 0 zero) / 2^32 + even
    uint32_t t[W], d[W];
    t[0] = cc::add_cc(even[0], odd[1]);
#pragma unroll
    for (int i = 1; i < W - 1; ++i) t[i] = cc::addc_cc(even[i], odd[i + 1]);
    t[W - 1] = cc::addc(even[W - 1], 0u);
    // t < 2p: subtract p once if t >= p
    d[0] = cc::sub_cc(t[0], m.p[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) d[i] = cc::subc_cc(t[i], m.p[i]);
    const uint32_t below = cc::subc(0u, 0u);
#pragma unroll
    for (int i = 0; i < W; ++i) r[i] = below ? t[i] : d[i];
}

// a b mod p for a, b in normal form, given r2 = R^2 mod p (R = 2^(32W)):
// two products, t = a b R^-1, then t R^2 R^-1.  (KM's broadcast row takes
// one a value: b R = mont_mul(b, r2) once, then mont_mul(a, b R) = a b.)
template <int W>
LCPC_DEV void mul_normal(uint32_t r[W], const uint32_t a[W], const uint32_t b[W],
                         const uint32_t r2[W], const Mod<W>& m) {
    uint32_t t[W];
    mont_mul<W>(t, a, b, m);
    mont_mul<W>(r, t, r2, m);
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
