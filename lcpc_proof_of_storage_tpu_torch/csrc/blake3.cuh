// Blake3 pieces of K2 (blake3.cu): the compression function, a column leaf's
// message read straight from the limb matrix, the leaves' launch plan and
// the merge order inside a block, and the Merkle array's layer offsets.
//
// A leaf is blake3(32 zero bytes || repr(M[0, c]) || ... || repr(M[n-1, c]))
// over column c of an (n_rows, n_cols, 2W) matrix of 16-bit limbs held in
// int32 (lcpc-2d/src/lib.rs:752-753).  A repr is the element's 4W bytes,
// little-endian, or big-endian for ft253_192.  Word g of the message is 0
// for g < 8, else word (g - 8) mod W of element (g - 8) / W.
//
// leaf_block<W> reads one 64-byte block (16 words) of that message: every
// element it touches with W/2 16-byte loads (its 2W limbs), each pair of
// limbs packed into a word by one byte permute, which also reverses the
// bytes of a big-endian repr.  For W = 2, 4, 8 a block is 16 / W whole
// elements (the 8 prefix words are whole elements too); for W = 6 a block
// starts 0, 2 or 4 words into an element and takes words of four.
//
// The leaves' plan (leaf_plan, mirrored by ops/blake3.py leaf_plan): a
// message of nchunks 1024-byte chunks is spread over `slots` threads, one
// chunk each, or, past kLeafThreads chunks, an aligned power-of-two group of
// `group` chunks each; a block holds `cols` neighbouring columns x slots,
// the power of two that fills at most kLeafThreads threads.  The slots' CVs
// merge in the block at strides 1, 2, 4, ...: slot i (a multiple of 2s)
// takes the parent of itself and slot i + s, and the odd slot is carried.
// That is the pairwise merge with the odd node carried up of
// ops/blake3_pallas.py:112-126 and merge_chunk_cvs: node i of level l covers
// chunks [i 2^l, min((i + 1) 2^l, nchunks)) both ways, and so does a
// group's own left-leaning subtree.  Only the last parent carries ROOT; a
// one-chunk message carries it on its chunk's last block.
//
// With a host compiler (no __CUDACC__) the loads and the byte permute are
// plain C++, so tests/test_torch_blake3_tree.py runs this header against
// crypto/blake3_ref.py and the Python mirrors on a CPU.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define LCPC_B3 __host__ __device__ __forceinline__
#else
#include <cstring>
#define LCPC_B3 inline
#endif

namespace b3 {

constexpr uint32_t CHUNK_START = 1, CHUNK_END = 2, PARENT = 4, ROOT = 8;
constexpr int kMaxDepth = 40;            // subtree CVs a stack holds
constexpr int kLeafThreads = 256;        // threads of a leaves block, at most
constexpr int kTreeLevels = 10;          // Merkle levels one tree launch builds
constexpr int kTreeThreads = 1 << (kTreeLevels - 1);

LCPC_B3 void load_iv(uint32_t x[8]) {
    x[0] = 0x6A09E667u; x[1] = 0xBB67AE85u; x[2] = 0x3C6EF372u; x[3] = 0xA54FF53Au;
    x[4] = 0x510E527Fu; x[5] = 0x9B05688Cu; x[6] = 0x1F83D9ABu; x[7] = 0x5BE0CD19u;
}

LCPC_B3 uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// the bytes of (y:x) selected by the low nibbles of s, as __byte_perm
LCPC_B3 uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDA_ARCH__)
    return __byte_perm(x, y, s);
#else
    const uint64_t xy = (uint64_t)y << 32 | x;
    uint32_t r = 0;
    for (int i = 0; i < 4; ++i)
        r |= (uint32_t)((xy >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
    return r;
#endif
}

// four int32 at a 16-byte aligned address, one vector load
LCPC_B3 void load16(uint32_t r[4], const int32_t* p) {
#if defined(__CUDA_ARCH__)
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    r[0] = (uint32_t)v.x; r[1] = (uint32_t)v.y; r[2] = (uint32_t)v.z; r[3] = (uint32_t)v.w;
#else
    memcpy(r, p, 16);
#endif
}

LCPC_B3 void g(uint32_t v[16], int a, int b, int c, int d, uint32_t mx, uint32_t my) {
    v[a] = v[a] + v[b] + mx;
    v[d] = rotr(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr(v[b] ^ v[c], 12);
    v[a] = v[a] + v[b] + my;
    v[d] = rotr(v[d] ^ v[a], 8);
    v[c] = v[c] + v[d];
    v[b] = rotr(v[b] ^ v[c], 7);
}

// first 8 output words of the Blake3 compression function; out may be cv
LCPC_B3 void compress(uint32_t out[8], const uint32_t cv[8], const uint32_t block[16],
                      uint64_t counter, uint32_t block_len, uint32_t flags) {
    uint32_t v[16], m[16], iv[8];
    load_iv(iv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = cv[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[8 + i] = iv[i];
    v[12] = (uint32_t)counter;
    v[13] = (uint32_t)(counter >> 32);
    v[14] = block_len;
    v[15] = flags;
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = block[i];
#pragma unroll
    for (int r = 0; r < 7; ++r) {
        g(v, 0, 4, 8, 12, m[0], m[1]);
        g(v, 1, 5, 9, 13, m[2], m[3]);
        g(v, 2, 6, 10, 14, m[4], m[5]);
        g(v, 3, 7, 11, 15, m[6], m[7]);
        g(v, 0, 5, 10, 15, m[8], m[9]);
        g(v, 1, 6, 11, 12, m[10], m[11]);
        g(v, 2, 7, 8, 13, m[12], m[13]);
        g(v, 3, 4, 9, 14, m[14], m[15]);
        // message permutation {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8}
        uint32_t t[16] = {m[2], m[6], m[3], m[10], m[7], m[0], m[4], m[13],
                          m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = t[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = v[i] ^ v[i + 8];
}

// blake3 of the 64-byte message left || right, flags CHUNK_START | CHUNK_END
// | ROOT for a Merkle parent, PARENT (| ROOT) inside a message's tree
LCPC_B3 void parent_cv(uint32_t out[8], const uint32_t left[8], const uint32_t right[8],
                       uint32_t flags) {
    uint32_t block[16], iv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        block[i] = left[i];
        block[8 + i] = right[i];
    }
    load_iv(iv);
    compress(out, iv, block, 0, 64, flags);
}

// Blake3's stack of subtree CVs over a run of chunk CVs, in order
struct CvStack {
    uint32_t s[kMaxDepth][8];
    int depth = 0;

    // push the CV of the run's chunk number total - 1 (not its last),
    // merging every subtree it completes
    LCPC_B3 void push(uint32_t cv[8], uint64_t total) {
        for (; (total & 1) == 0; total >>= 1) {
            --depth;
            parent_cv(cv, s[depth], cv, PARENT);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s[depth][i] = cv[i];
        ++depth;
    }

    // fold the run's last CV into the stack; root_flag on the final parent
    LCPC_B3 void finish(uint32_t cv[8], uint32_t root_flag) {
        while (depth > 0) {
            --depth;
            parent_cv(cv, s[depth], cv, PARENT | (depth == 0 ? root_flag : 0));
        }
    }
};

// the W little-endian repr words of the element whose 2W limbs start at el
template <int W>
LCPC_B3 void element_words(uint32_t w[W], const int32_t* el, bool big_endian) {
    uint32_t limb[2 * W];
#pragma unroll
    for (int q = 0; q < W / 2; ++q) load16(limb + 4 * q, el + 4 * q);
#pragma unroll
    for (int vw = 0; vw < W; ++vw) {
        if (big_endian)
            w[W - 1 - vw] = byte_perm(limb[2 * vw], limb[2 * vw + 1], 0x0145);
        else
            w[vw] = byte_perm(limb[2 * vw], limb[2 * vw + 1], 0x5410);
    }
}

template <int W>
LCPC_B3 void element_or_zero(uint32_t w[W], const int32_t* comm, int64_t e, int64_t n_rows,
                             int64_t n_cols, int64_t c, bool big_endian) {
    if (e >= 0 && e < n_rows) {
        element_words<W>(w, comm + (e * n_cols + c) * (2 * W), big_endian);
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) w[i] = 0;
    }
}

template <int W, int OFF>
LCPC_B3 void take16(uint32_t blk[16], const uint32_t w[4 * W]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) blk[i] = w[OFF + i];
}

// words g0 .. g0 + 15 of column c's leaf message (g0 a multiple of 16)
template <int W>
LCPC_B3 void leaf_block(uint32_t blk[16], const int32_t* comm, int64_t g0, int64_t n_rows,
                        int64_t n_cols, int64_t c, bool big_endian) {
    if constexpr (16 % W == 0) {
        const int64_t e0 = (g0 - 8) / W;   // exact: W divides 8 and 16
#pragma unroll
        for (int k = 0; k < 16 / W; ++k)
            element_or_zero<W>(blk + k * W, comm, e0 + k, n_rows, n_cols, c, big_endian);
    } else {
        const int64_t r = g0 - 8;
        const int64_t e0 = (r >= 0 ? r : r - (W - 1)) / W;   // floor
        const int off = (int)(r - e0 * W);                     // 0, 2 or 4 for W = 6
        uint32_t w[4 * W];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            element_or_zero<W>(w + k * W, comm, e0 + k, n_rows, n_cols, c, big_endian);
        if (off == 0)
            take16<W, 0>(blk, w);
        else if (off == 2)
            take16<W, 2>(blk, w);
        else
            take16<W, 4>(blk, w);
    }
}

// CV of chunk ch of column c's leaf message of msg_len bytes
template <int W>
LCPC_B3 void leaf_chunk_cv(uint32_t cv[8], const int32_t* comm, int64_t n_rows, int64_t n_cols,
                           int64_t c, bool big_endian, int64_t msg_len, int64_t ch,
                           uint32_t last_flags) {
    const int64_t rest = msg_len - ch * 1024;
    const int clen = (int)(rest < 1024 ? rest : 1024);
    const int nblocks = clen > 64 ? (clen + 63) / 64 : 1;
    load_iv(cv);
    for (int bl = 0; bl < nblocks; ++bl) {
        uint32_t blk[16];
        leaf_block<W>(blk, comm, ch * 256 + bl * 16, n_rows, n_cols, c, big_endian);
        uint32_t flags = bl == 0 ? CHUNK_START : 0;
        if (bl == nblocks - 1) flags |= CHUNK_END | last_flags;
        const int blen = clen - bl * 64;
        compress(cv, cv, blk, (uint64_t)ch, (uint32_t)(blen < 64 ? blen : 64), flags);
    }
}

struct LeafPlan {
    int64_t msg_len;   // bytes of a column's message
    int64_t nchunks;
    int64_t group;     // chunks a thread (a power of two)
    int slots;         // threads a column
    int cols;          // columns a block (a power of two)
};

LCPC_B3 LeafPlan leaf_plan(int64_t n_rows, int W) {
    LeafPlan p;
    p.msg_len = 32 + n_rows * 4 * W;
    p.nchunks = p.msg_len > 1024 ? (p.msg_len + 1023) / 1024 : 1;
    p.group = 1;
    while ((p.nchunks + p.group - 1) / p.group > kLeafThreads) p.group *= 2;
    p.slots = (int)((p.nchunks + p.group - 1) / p.group);
    p.cols = 1;
    while (2 * p.cols * p.slots <= kLeafThreads) p.cols *= 2;
    return p;
}

// the CV of slot `slot` of column c: its chunk, or its group's subtree (no
// ROOT: the block merge adds the root), or the whole one-chunk message
template <int W, bool GROUPED>
LCPC_B3 void leaf_slot_cv(uint32_t cv[8], const int32_t* comm, int64_t n_rows, int64_t n_cols,
                          int64_t c, bool big_endian, const LeafPlan& p, int slot) {
    if constexpr (!GROUPED) {
        leaf_chunk_cv<W>(cv, comm, n_rows, n_cols, c, big_endian, p.msg_len, slot,
                         p.nchunks == 1 ? ROOT : 0);
    } else {
        const int64_t ch0 = slot * p.group;
        const int64_t ch1 = ch0 + p.group < p.nchunks ? ch0 + p.group : p.nchunks;
        CvStack stack;
        for (int64_t ch = ch0; ch < ch1; ++ch) {
            leaf_chunk_cv<W>(cv, comm, n_rows, n_cols, c, big_endian, p.msg_len, ch, 0);
            if (ch < ch1 - 1) stack.push(cv, (uint64_t)(ch - ch0 + 1));
        }
        stack.finish(cv, 0);
    }
}

// at stride s of the block merge: whether slot takes the parent of itself
// and slot + s, and that parent's flags
LCPC_B3 bool merges_at(int slot, int s, int slots) {
    return slot % (2 * s) == 0 && slot + s < slots;
}
LCPC_B3 uint32_t merge_flags(int s, int slots) { return PARENT | (2 * s >= slots ? ROOT : 0); }

// first row of layer k of the (2 np2 - 1, 8) Merkle array: the leaves at
// row 0, then each layer of parents (lcpc-2d/src/lib.rs:685-694)
LCPC_B3 int64_t tree_layer_row(int64_t np2, int k) { return 2 * np2 - 2 * (np2 >> k); }

}  // namespace b3
