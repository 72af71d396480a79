// Device pieces shared by the stage-group passes of K1 / K4 (ntt.cu) and
// the tile kernel KT (ntt_tile.cu): the values a block holds, a value's W
// words to and from global memory in 16- or 8-byte pieces (packed words, or
// the 16-bit limbs of the boundary format two words at a time), to and from
// shared memory held word-major, a twiddle through the read-only path, and
// the radix-2 butterfly.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "montgomery.cuh"

namespace ntt_pass {

// log2 of the values a block holds: 1024 at W <= 4, 2048 at W >= 6
constexpr int log_block(int W) { return W <= 4 ? 10 : 11; }

// W words of one value from / to global memory, in 16- or 8-byte pieces
template <int W>
__device__ __forceinline__ void load_words(uint32_t v[W], const uint32_t* p) {
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
            const uint4 t = reinterpret_cast<const uint4*>(p)[q];
            v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < W / 2; ++q) {
            const uint2 t = reinterpret_cast<const uint2*>(p)[q];
            v[2 * q] = t.x, v[2 * q + 1] = t.y;
        }
    }
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t v[W]) {
    if constexpr (W % 4 == 0) {
#pragma unroll
        for (int q = 0; q < W / 4; ++q)
            reinterpret_cast<uint4*>(p)[q] =
                make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
        for (int q = 0; q < W / 2; ++q)
            reinterpret_cast<uint2*>(p)[q] = make_uint2(v[2 * q], v[2 * q + 1]);
    }
}

// the 2W int32 limbs of one value (W / 2 pieces of 16 bytes) <-> W words
template <int W>
__device__ __forceinline__ void load_limbs(uint32_t v[W], const int32_t* p) {
#pragma unroll
    for (int q = 0; q < W / 2; ++q) {
        const int4 t = reinterpret_cast<const int4*>(p)[q];
        v[2 * q] = ((uint32_t)t.x & 0xFFFFu) | ((uint32_t)t.y << 16);
        v[2 * q + 1] = ((uint32_t)t.z & 0xFFFFu) | ((uint32_t)t.w << 16);
    }
}

template <int W>
__device__ __forceinline__ void store_limbs(int32_t* p, const uint32_t v[W]) {
#pragma unroll
    for (int q = 0; q < W / 2; ++q)
        reinterpret_cast<int4*>(p)[q] =
            make_int4((int32_t)(v[2 * q] & 0xFFFFu), (int32_t)(v[2 * q] >> 16),
                      (int32_t)(v[2 * q + 1] & 0xFFFFu), (int32_t)(v[2 * q + 1] >> 16));
}

// a value's W words in shared memory, word-major with rows of ld words
template <int W>
__device__ __forceinline__ void load_smem(uint32_t v[W], const uint32_t* sm, int ld, int i) {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = sm[w * ld + i];
}

template <int W>
__device__ __forceinline__ void store_smem(uint32_t* sm, int ld, int i, const uint32_t v[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) sm[w * ld + i] = v[w];
}

// twiddle j of the (n/2, W) table, through the read-only path
template <int W>
__device__ __forceinline__ void load_tw(uint32_t v[W], const uint32_t* __restrict__ tw,
                                        int64_t j) {
    if constexpr (W % 4 == 0) {
        const uint4* p = reinterpret_cast<const uint4*>(tw + j * W);
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
            const uint4 t = __ldg(p + q);
            v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
        }
    } else {
        const uint2* p = reinterpret_cast<const uint2*>(tw + j * W);
#pragma unroll
        for (int q = 0; q < W / 2; ++q) {
            const uint2 t = __ldg(p + q);
            v[2 * q] = t.x, v[2 * q + 1] = t.y;
        }
    }
}

// (a, b) <- (a + b w, a - b w), w a twiddle in Montgomery form
template <int W>
__device__ __forceinline__ void butterfly(uint32_t a[W], uint32_t b[W], const uint32_t w[W],
                                          const Mod<W>& m) {
    uint32_t y[W], s[W];
    mont_mul<W>(y, b, w, m);
    add_mod<W>(s, a, y, m);
    sub_mod<W>(b, a, y, m);
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = s[i];
}

}  // namespace ntt_pass
