// Exact sums of products of W-word values and their one reduction mod p,
// shared by K3 / K3p (collapse.cu) and K5 (expander.cu), with the two
// kernels' launch plans.
//
// A field value here is W = L/2 32-bit words, least significant first, read
// from the boundary format of 16-bit limbs (two limbs a word, pack16).  Both
// kernels sum many products a * b of such values (a table value times a
// gathered input in K5, a tensor entry times a matrix entry in the collapse)
// and reduce the sum once at the end.
//
// mac<W>(s, a, b) adds the exact product a * b to a Wide<W> sum s: 2W words
// w and W+1 carry counters c, where c[k] counts the carries into word W+k.
// Row i of the schoolbook product (b[i] times a) is two carry chains, one
// PTX instruction a word: the products of the even words a[0], a[2], ... each
// fill a word pair i+2m, i+2m+1, disjoint, so they go on w[i .. i+W-1] as
// one unbroken mad.lo.cc / madc.hi.cc chain; the odd words' products go on
// w[i+1 .. i+W] as a second.  Each chain's carry out is added to its
// counter (addc), never carried further up the sum, so a product costs W^2
// multiply-add pairs (ptxas fuses each pair into one IMAD.WIDE with carry)
// and 2W adds.  fold<W> turns w and c into the sum's 2W+1 words.
//
// Exactness.  A product adds at most one carry to each chain's counter and
// so at most 2 to any counter; below 2^31 products no counter wraps.  Any
// two W-word values multiply to less than 2^(64W), so the sum of fewer than
// 2^31 products is below 2^(64W+31) < 2^(32(2W+1)): its 2W+1 words hold it
// exactly, for canonical inputs or not.  kMaxTerms = 2^31 - 1 is therefore
// the most products one sum may take; ops/expander.py MAX_SLOTS (slots a
// row) and ops/collapse.py MAX_ROWS (rows) are this number.  The collapse
// adds the folded sums of a column's row groups (add_wide): their total is
// still a sum of at most kMaxTerms products.
//
// reduce_wide<W> is the truncated Barrett of fields/limb.py barrett_reduce
// on 32-bit words instead of 16-bit limbs: for z < b^M, b = 2^32, M = 2W+1,
// and p with b^(W-1) <= p < b^W (all five fields), q1 = floor(z / b^(W-1)),
// q = floor(q1 * mu / b^(W+2)) with mu = floor(b^M / p) (the W+2 words of
// the 16-bit mu that fields/limb.py gives for width 4W+2, so the kernels'
// arguments are the ones they always took), r = (z - q p) mod b^(W+1).
// Since z/p - q1 mu / b^(W+2) < b^(W-1)/p + z/b^M < 2, q is at most 2 below
// floor(z/p): r < 3p, and two conditional subtractions leave the canonical
// residue, bit-equal to LimbField.dot whatever the order of the sum.  Why
// Barrett and not Montgomery: the sum is up to 2^(64W+31), far above REDC's
// p * 2^(32W) input range, so Montgomery would first fold the top words and
// then needs every table value or tensor pre-scaled by 2^(32W); Barrett
// takes the sum as it is, from the constants the callers already pass, and
// it runs once an output, where the sums cost W^2 multiply-adds a term.
//
// With a host compiler (no __CUDACC__) the carry flag is emulated
// (montgomery.cuh cc), so tests/test_torch_wide.py checks this header against
// Python integers on a CPU.

#pragma once

#include <cstdint>

#include "montgomery.cuh"

constexpr uint32_t kMaxTerms = 0x7FFFFFFFu;   // products one sum holds exactly

// word of two canonical 16-bit limbs
LCPC_DEV uint32_t pack16(uint32_t lo, uint32_t hi) {
#if defined(__CUDACC__)
    return __byte_perm(lo, hi, 0x5410);
#else
    return (lo & 0xFFFFu) | (hi << 16);
#endif
}

template <int W>
struct Wide {
    uint32_t w[2 * W];   // words 0 .. 2W-1
    uint32_t c[W + 1];   // c[k]: carries into word W+k
};

template <int W>
LCPC_DEV void wide_zero(Wide<W>& s) {
#pragma unroll
    for (int i = 0; i < 2 * W; ++i) s.w[i] = 0;
#pragma unroll
    for (int i = 0; i <= W; ++i) s.c[i] = 0;
}

// s += a * b, exact
template <int W>
LCPC_DEV void mac(Wide<W>& s, const uint32_t (&a)[W], const uint32_t (&b)[W]) {
    static_assert(W % 2 == 0 && W >= 2, "mac takes an even number of words");
#pragma unroll
    for (int i = 0; i < W; ++i) {
        const uint32_t bi = b[i];
        s.w[i] = cc::mad_lo_cc(a[0], bi, s.w[i]);
        s.w[i + 1] = cc::madc_hi_cc(a[0], bi, s.w[i + 1]);
#pragma unroll
        for (int j = 2; j < W; j += 2) {
            s.w[i + j] = cc::madc_lo_cc(a[j], bi, s.w[i + j]);
            s.w[i + j + 1] = cc::madc_hi_cc(a[j], bi, s.w[i + j + 1]);
        }
        s.c[i] = cc::addc(s.c[i], 0u);
        s.w[i + 1] = cc::mad_lo_cc(a[1], bi, s.w[i + 1]);
        s.w[i + 2] = cc::madc_hi_cc(a[1], bi, s.w[i + 2]);
#pragma unroll
        for (int j = 3; j < W; j += 2) {
            s.w[i + j] = cc::madc_lo_cc(a[j], bi, s.w[i + j]);
            s.w[i + j + 1] = cc::madc_hi_cc(a[j], bi, s.w[i + j + 1]);
        }
        s.c[i + 1] = cc::addc(s.c[i + 1], 0u);
    }
}

// the sum as 2W+1 words
template <int W>
LCPC_DEV void fold(const Wide<W>& s, uint32_t (&z)[2 * W + 1]) {
#pragma unroll
    for (int i = 0; i < W; ++i) z[i] = s.w[i];
    z[W] = cc::add_cc(s.w[W], s.c[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) z[W + i] = cc::addc_cc(s.w[W + i], s.c[i]);
    z[2 * W] = cc::addc(s.c[W], 0u);
}

// z += y, both 2W+1 words (the sum of both below 2^(32(2W+1))); y's words
// lie `stride` words apart
template <int W>
LCPC_DEV void add_wide(uint32_t (&z)[2 * W + 1], const uint32_t* y, int stride) {
    z[0] = cc::add_cc(z[0], y[0]);
#pragma unroll
    for (int i = 1; i < 2 * W; ++i) z[i] = cc::addc_cc(z[i], y[i * stride]);
    z[2 * W] = cc::addc(z[2 * W], y[2 * W * stride]);
}

template <int W>
struct Barrett {
    uint32_t p[W];
    uint32_t mu[W + 2];   // floor(2^(32(2W+1)) / p)
};

// host: the constants from the 16-bit limbs of p (2W) and of mu (mu_len);
// false if mu has more words than W+2
template <int W>
inline bool make_barrett(Barrett<W>& k, const uint32_t* p_limbs, const uint32_t* mu_limbs,
                         int mu_len) {
    if (mu_len > 2 * (W + 2)) return false;
    for (int i = 0; i < W; ++i) k.p[i] = (p_limbs[2 * i] & 0xFFFFu) | (p_limbs[2 * i + 1] << 16);
    for (int i = 0; i < W + 2; ++i) {
        const uint32_t lo = 2 * i < mu_len ? mu_limbs[2 * i] : 0u;
        const uint32_t hi = 2 * i + 1 < mu_len ? mu_limbs[2 * i + 1] : 0u;
        k.mu[i] = (lo & 0xFFFFu) | (hi << 16);
    }
    return true;
}

// r = z mod p, canonical
template <int W>
LCPC_DEV void reduce_wide(const uint32_t (&z)[2 * W + 1], const Barrett<W>& k,
                          uint32_t (&r)[W]) {
    constexpr int Q = W + 2;   // words of q1 = floor(z / b^(W-1)), of mu and of q
    uint32_t prod[2 * Q];      // q1 * mu; q is its top Q words
#pragma unroll
    for (int d = 0; d < 2 * Q; ++d) prod[d] = 0;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; j < Q; ++j) {
            const uint64_t t = (uint64_t)z[W - 1 + i] * k.mu[j] + prod[i + j] + carry;
            prod[i + j] = (uint32_t)t;
            carry = t >> 32;
        }
        prod[i + Q] = (uint32_t)carry;
    }
    // q p mod b^(W+1): q's words 0 .. W
    uint32_t qp[W + 1];
#pragma unroll
    for (int d = 0; d <= W; ++d) qp[d] = 0;
#pragma unroll
    for (int i = 0; i <= W; ++i) {
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; i + j <= W; ++j) {
            const uint64_t t = (uint64_t)prod[Q + i] * (j < W ? k.p[j] : 0u) + qp[i + j] + carry;
            qp[i + j] = (uint32_t)t;
            carry = t >> 32;
        }
    }
    // x = (z - q p) mod b^(W+1) < 3p, then subtract p while x >= p
    uint32_t x[W + 1];
    uint64_t borrow = 0;
#pragma unroll
    for (int d = 0; d <= W; ++d) {
        const uint64_t t = (uint64_t)z[d] - qp[d] - borrow;
        x[d] = (uint32_t)t;
        borrow = t >> 63;
    }
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {
        uint32_t y[W + 1];
        borrow = 0;
#pragma unroll
        for (int d = 0; d <= W; ++d) {
            const uint64_t t = (uint64_t)x[d] - (d < W ? k.p[d] : 0u) - borrow;
            y[d] = (uint32_t)t;
            borrow = t >> 63;
        }
#pragma unroll
        for (int d = 0; d <= W; ++d) x[d] = borrow ? x[d] : y[d];
    }
#pragma unroll
    for (int d = 0; d < W; ++d) r[d] = x[d];
}

// The kernels' launch plans (host), mirrored in Python for the CPU tests.

// K5: batch rows a thread sums at once, each slot's table entry loaded once
// for all of them (ops/expander.py b_tile).  At W >= 6 one keeps the most
// blocks in flight, two halve the table reads, which pays from 32 batch rows
// a level on.
constexpr int expander_b_tile(int W, int b) { return W >= 6 ? (b >= 32 ? 2 : 1) : 8 / W; }

// The collapse: a block is kCollapseWarps warps; tensors a thread sums at
// once (ops/collapse.py T_TILE); rows staged in shared memory at a time.
constexpr int kCollapseWarps = 8;
constexpr int kCollapseChunk = 64;
// a chunk starts at a multiple of every row-warp count, so row warp r sums
// the rows i = r mod row_warps of every chunk
static_assert(kCollapseChunk % kCollapseWarps == 0, "chunks keep the rows' warps");
constexpr int collapse_t_tile(int W) { return W <= 4 ? 4 : 2; }

// The collapse's row warps (1, 2, 4 or 8: warp r of a column group sums the
// rows i = r mod row_warps): doubled while the grid's warps stay below 32 a
// streaming multiprocessor of an H100 (132 of them) and every row warp keeps
// at least 4 rows (ops/collapse.py collapse_plan).
constexpr int64_t kCollapseTargetWarps = 132 * 32;
inline int collapse_row_warps(int rows, int npr, int T, int W) {
    const int64_t t_tiles = (T + collapse_t_tile(W) - 1) / collapse_t_tile(W);
    const int64_t col_warps = (npr + 31) / 32 * t_tiles;
    int rw = 1;
    while (rw < kCollapseWarps && col_warps * rw < kCollapseTargetWarps && rows >= 8 * rw)
        rw *= 2;
    return rw;
}
