// K2: Blake3 column leaves and the Merkle tree, and the streamed commit's
// chunk chaining values, for sm_90a.  The shared pieces (compression, the
// leaf message's loads, the plans) are in blake3.cuh.
//
// Replaces: lcpc_proof_of_storage_tpu/ops/blake3_pallas.py, _hash_kernel /
// _hash_call (driven by hash_columns_pallas and hash_columns_auto), the
// Merkle layers that ops/blake3_jax.py merkle_parents runs as XLA ops, and
// the XLA chunk_cvs_words / merge_chunk_cvs pair of ops/blake3_jax.py that
// core/streamed.py hashes its row batches with.
//
// lcpc_blake3_leaves: one thread per (column, chunk) of the leaf messages
// (or per aligned group of chunks past kLeafThreads chunks a message): a
// block holds `cols` neighbouring columns x their `slots` chunks, keeps the
// chunk CVs in shared memory and merges each column's CVs there, pairwise
// with the odd node carried up (blake3.cuh).  Neighbouring threads take
// neighbouring columns of the same chunk, so a warp's 16-byte loads read
// neighbouring elements of a row.  At the 2^20 ft255 commit, 128 rows of
// 32768 columns: five chunks a column, 163840 threads, the longest one 16
// compressions and then 3 parents.
//
// lcpc_blake3_tree: the (2 np2 - 1, 8) Merkle array whose first np2 rows
// hold the leaves (zero past n_cols) is filled in place, layer k at row
// tree_layer_row(np2, k).  A parent is blake3(left || right) as a single-
// chunk 64-byte message with CHUNK_START | CHUNK_END | ROOT, not Blake3's
// PARENT mode (the reference hashes concatenated digests with a fresh
// hasher, lib.rs:800-806).  One launch builds up to kTreeLevels layers
// above layer level0: a block takes 2^levels nodes, builds their subtree's
// layers in shared memory with one barrier a layer, and writes each layer's
// slice to its rows.  ops/blake3.py tree_plan launches it once below 2^10
// leaves and twice up to 2^20, where the second launch's one block builds
// the layers above the first launch's subtree roots.
//
// lcpc_blake3_chunk_cvs: the same chunks, for one row batch of a streamed
// commit.  A batch's part of each column message (the 32 zero bytes before
// row 0 in the first batch only, then the batch's reprs, zero past its
// last row) covers k whole chunks, the last one tail_len bytes long when it
// is the message's partial last chunk.  One thread per (column, chunk)
// compresses that chunk with its global counter and writes its CV; no
// ROOT flag, since a streamed column spans at least two chunks.
//
// lcpc_blake3_merge_cvs: one thread per column merges all of that column's
// chunk CVs into its leaf digest with Blake3's subtree stack.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// blake3_kernels, PERF.md): the leaves 0.119-0.124 ms at (128, 32768, 16)
// ft255 (bound 0.080 ms by their bytes; one thread a column took 0.243) and
// 1.14 ms at the Brakedown 2^25 commit's (143, 357697, 16) (bound 0.98;
// 1.78 before).  The tree alone 0.026-0.047 ms over 2^15 leaves and 0.088
// ms over 2^20, two launches each (15 and 20 launches, 0.34-0.48 and
// 0.57-1.03 ms with the concatenation, before).  The chunk-CV entry 1.16 ms
// on a 2^29 ft255 batch (32 rows of 2^20 columns, bound 0.65 ms by its
// bytes) and the merge of 65 chunks of 2^20 columns 2.48 ms (bound 1.60 ms,
// by its compressions).

#include <cstdint>
#include <cuda_runtime.h>

#include "blake3.cuh"

namespace {

using namespace b3;

// word g of column c's part of a message: `prefix` zero words, then W repr
// words per row of the (n_rows, n_cols, 2W) limb matrix, zero past its end
template <int W>
__device__ __forceinline__ uint32_t msg_word(const int32_t* __restrict__ comm, int64_t g,
                                             int prefix, int64_t n_rows, int64_t n_cols,
                                             int64_t c, bool big_endian) {
    if (g < prefix) return 0;
    int64_t e = (g - prefix) / W;
    int ww = (int)((g - prefix) - e * W);
    if (e >= n_rows) return 0;
    const int32_t* el = comm + (e * n_cols + c) * (2 * W);
    int vw = big_endian ? W - 1 - ww : ww;
    uint32_t v = ((uint32_t)el[2 * vw] & 0xFFFFu) | ((uint32_t)el[2 * vw + 1] << 16);
    return big_endian ? __byte_perm(v, 0, 0x0123) : v;
}

// CV of the chunk of clen bytes that starts at word word0 of column c's part
template <int W>
__device__ __forceinline__ void chunk_cv(uint32_t cv[8], const int32_t* __restrict__ comm,
                                         int64_t word0, int prefix, int64_t n_rows,
                                         int64_t n_cols, int64_t c, bool big_endian,
                                         int64_t clen, uint64_t counter, uint32_t last_flags) {
    const int nblocks = clen > 64 ? (int)((clen + 63) / 64) : 1;
    load_iv(cv);
    for (int bl = 0; bl < nblocks; ++bl) {
        uint32_t block[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
            block[i] = msg_word<W>(comm, word0 + bl * 16 + i, prefix, n_rows, n_cols, c,
                                   big_endian);
        uint32_t flags = 0;
        if (bl == 0) flags |= CHUNK_START;
        if (bl == nblocks - 1) flags |= CHUNK_END | last_flags;
        const int64_t blen = clen - (int64_t)bl * 64;
        compress(cv, cv, block, counter, (uint32_t)(blen < 64 ? blen : 64), flags);
    }
}

// blockDim = p.slots * p.cols; thread (slot, col) at slot * p.cols + col
template <int W, bool GROUPED>
__global__ void __launch_bounds__(kLeafThreads)
blake3_leaves(const int32_t* __restrict__ comm, uint32_t* __restrict__ out, int n_rows,
              int n_cols, int big_endian, LeafPlan p) {
    __shared__ uint32_t sh[8][kLeafThreads];   // word i of thread t's node at sh[i][t]
    const int t = threadIdx.x;
    const int slot = t / p.cols;
    const int64_t c = (int64_t)blockIdx.x * p.cols + (t - slot * p.cols);
    const bool live = c < n_cols;
    uint32_t cv[8];
    if (live) leaf_slot_cv<W, GROUPED>(cv, comm, n_rows, n_cols, c, big_endian != 0, p, slot);
    for (int s = 1; s < p.slots; s *= 2) {
        if (slot % s == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) sh[i][t] = cv[i];
        }
        __syncthreads();
        if (live && merges_at(slot, s, p.slots)) {
            uint32_t right[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) right[i] = sh[i][t + s * p.cols];
            parent_cv(cv, cv, right, merge_flags(s, p.slots));
        }
        __syncthreads();
    }
    if (live && slot == 0) {
        uint4* o = reinterpret_cast<uint4*>(out + c * 8);
        o[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
        o[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
    }
}

// block b takes nodes [b 2^levels, (b + 1) 2^levels) of layer level0 and
// builds `levels` layers above them; blockDim = 2^(levels - 1)
__global__ void __launch_bounds__(kTreeThreads)
blake3_tree(uint32_t* __restrict__ nodes, long long np2, int level0, int levels) {
    __shared__ uint4 buf[2][kTreeThreads][2];   // layer l's nodes in buf[l & 1]
    const int t = threadIdx.x;
    for (int l = 1; l <= levels; ++l) {
        const int n = 1 << (levels - l);          // this block's nodes of layer level0 + l
        if (t < n) {
            uint32_t blk[16], h[8];
            if (l == 1) {
                const uint4* src = reinterpret_cast<const uint4*>(
                    nodes + (tree_layer_row(np2, level0) + ((int64_t)blockIdx.x << levels)
                             + 2 * t) * 8);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const uint4 v = __ldg(src + q);
                    blk[4 * q] = v.x; blk[4 * q + 1] = v.y; blk[4 * q + 2] = v.z;
                    blk[4 * q + 3] = v.w;
                }
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const uint4 v = buf[(l - 1) & 1][2 * t + q / 2][q % 2];
                    blk[4 * q] = v.x; blk[4 * q + 1] = v.y; blk[4 * q + 2] = v.z;
                    blk[4 * q + 3] = v.w;
                }
            }
            uint32_t iv[8];
            load_iv(iv);
            compress(h, iv, blk, 0, 64, CHUNK_START | CHUNK_END | ROOT);
            const uint4 lo = make_uint4(h[0], h[1], h[2], h[3]);
            const uint4 hi = make_uint4(h[4], h[5], h[6], h[7]);
            uint4* dst = reinterpret_cast<uint4*>(
                nodes + (tree_layer_row(np2, level0 + l) + (int64_t)blockIdx.x * n + t) * 8);
            dst[0] = lo;
            dst[1] = hi;
            buf[l & 1][t][0] = lo;
            buf[l & 1][t][1] = hi;
        }
        __syncthreads();
    }
}

// out: the (n_cols, ld, 8) CV array, advanced to this batch's first chunk
template <int W>
__global__ void blake3_chunk_cvs(const int32_t* __restrict__ comm, uint32_t* __restrict__ out,
                                 int rows_b, int n_cols, int k, int ld, long long chunk0,
                                 int first, int tail_len, int big_endian) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)n_cols * k) return;
    const int64_t j = t / n_cols, c = t - j * n_cols;
    uint32_t cv[8];
    chunk_cv<W>(cv, comm, j * 256, first ? 8 : 0, rows_b, n_cols, c, big_endian != 0,
                j == k - 1 ? tail_len : 1024, (uint64_t)(chunk0 + j), 0);
    uint32_t* o = out + (c * ld + j) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = cv[i];
}

__global__ void blake3_merge_cvs(const uint32_t* __restrict__ cvs, uint32_t* __restrict__ out,
                                 int n_cols, int nchunks) {
    int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n_cols) return;
    CvStack stack;
    uint32_t cv[8];
    for (int64_t ch = 0; ch < nchunks; ++ch) {
        const uint32_t* in = cvs + (c * nchunks + ch) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = in[i];
        if (ch < nchunks - 1) stack.push(cv, (uint64_t)ch + 1);
    }
    stack.finish(cv, ROOT);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[c * 8 + i] = cv[i];
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t threads) {
    return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <int W>
void launch_leaves(const int32_t* in, uint32_t* o, int n_rows, int n_cols, int big_endian,
                   const LeafPlan& p, cudaStream_t st) {
    const unsigned blocks = (unsigned)((n_cols + p.cols - 1) / p.cols);
    const unsigned threads = (unsigned)(p.slots * p.cols);
    if (p.group > 1)
        blake3_leaves<W, true><<<blocks, threads, 0, st>>>(in, o, n_rows, n_cols, big_endian, p);
    else
        blake3_leaves<W, false><<<blocks, threads, 0, st>>>(in, o, n_rows, n_cols, big_endian, p);
}

}  // namespace

extern "C" {

// comm: (n_rows, n_cols, 2W) int32 limbs, 16-byte aligned; out: (n_cols, 8)
// words, 16-byte aligned.
int lcpc_blake3_leaves(const void* comm, void* out, int n_rows, int n_cols, int W,
                       int big_endian, void* stream) {
    if (n_rows < 0 || n_cols < 1 || ((uintptr_t)comm | (uintptr_t)out) % 16)
        return (int)cudaErrorInvalidValue;
    auto in = static_cast<const int32_t*>(comm);
    auto o = static_cast<uint32_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    const LeafPlan p = leaf_plan(n_rows, W);
    switch (W) {
        case 2: launch_leaves<2>(in, o, n_rows, n_cols, big_endian, p, st); break;
        case 4: launch_leaves<4>(in, o, n_rows, n_cols, big_endian, p, st); break;
        case 6: launch_leaves<6>(in, o, n_rows, n_cols, big_endian, p, st); break;
        case 8: launch_leaves<8>(in, o, n_rows, n_cols, big_endian, p, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// nodes: the (2 np2 - 1, 8) Merkle array, 16-byte aligned; fills layers
// level0 + 1 .. level0 + levels from layer level0, 1 <= levels <= kTreeLevels.
int lcpc_blake3_tree(void* nodes, long long np2, int level0, int levels, void* stream) {
    if (np2 < 2 || (np2 & (np2 - 1)) || level0 < 0 || levels < 1 || levels > kTreeLevels
        || level0 + levels > 62 || (np2 >> level0) >> levels < 1
        || (uintptr_t)nodes % 16)
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((np2 >> level0) >> levels);
    blake3_tree<<<blocks, 1u << (levels - 1), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(nodes), np2, level0, levels);
    return (int)cudaGetLastError();
}

// comm: one (rows_b, n_cols, 2W) int32 limb batch; out: the (n_cols, ld, 8)
// CV array, whose columns chunk0 .. chunk0 + k - 1 receive the batch's k
// chunk CVs.  first: the batch starts at row 0 (32 zero bytes before it);
// tail_len: byte length of its last chunk (1024 unless the message ends).
int lcpc_blake3_chunk_cvs(const void* comm, void* out, int rows_b, int n_cols, int k, int ld,
                          long long chunk0, int first, int tail_len, int W, int big_endian,
                          void* stream) {
    if (k < 1 || tail_len < 1 || tail_len > 1024 || chunk0 < 0 || chunk0 + k > ld)
        return (int)cudaErrorInvalidValue;
    auto in = static_cast<const int32_t*>(comm);
    auto o = static_cast<uint32_t*>(out) + chunk0 * 8;
    auto st = static_cast<cudaStream_t>(stream);
    unsigned blocks = blocks_for((int64_t)n_cols * k);
#define LCPC_CHUNK_CVS(WW) \
    blake3_chunk_cvs<WW><<<blocks, kThreads, 0, st>>>(in, o, rows_b, n_cols, k, ld, chunk0, \
                                                      first, tail_len, big_endian)
    switch (W) {
        case 2: LCPC_CHUNK_CVS(2); break;
        case 4: LCPC_CHUNK_CVS(4); break;
        case 6: LCPC_CHUNK_CVS(6); break;
        case 8: LCPC_CHUNK_CVS(8); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef LCPC_CHUNK_CVS
    return (int)cudaGetLastError();
}

// cvs: (n_cols, nchunks, 8) words, nchunks >= 2; out: (n_cols, 8) digests.
int lcpc_blake3_merge_cvs(const void* cvs, void* out, int n_cols, int nchunks, void* stream) {
    if (nchunks < 2) return (int)cudaErrorInvalidValue;
    blake3_merge_cvs<<<blocks_for(n_cols), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(cvs), static_cast<uint32_t*>(out), n_cols, nchunks);
    return (int)cudaGetLastError();
}

}  // extern "C"
