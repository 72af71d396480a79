// K2: Blake3 column leaves and Merkle parents, and the streamed commit's
// chunk chaining values, for sm_90a.
//
// Replaces: lcpc_proof_of_storage_tpu/ops/blake3_pallas.py, _hash_kernel /
// _hash_call (driven by hash_columns_pallas and hash_columns_auto), the
// Merkle layer that ops/blake3_jax.py merkle_parents runs as XLA ops, and
// the XLA chunk_cvs_words / merge_chunk_cvs pair of ops/blake3_jax.py that
// core/streamed.py hashes its row batches with.
//
// lcpc_blake3_leaves: one thread per column c of an (n_rows, n_cols, 2W)
// limb matrix hashes the message 32 zero bytes || repr(M[0, c]) || ... ||
// repr(M[n_rows-1, c]) (the reference's zero-block leaf prefix,
// lcpc-2d/src/lib.rs:752-753).  A repr is the element's 4W bytes, little-
// endian, or big-endian for ft253_192.  The thread walks the message in
// 1024-byte chunks (chunk counter, CHUNK_START / CHUNK_END per chunk, ROOT
// only when the message is a single chunk) and merges the chunk chaining
// values with Blake3's stack of subtree CVs, which is the left-leaning tree
// the reference builds.
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
// chunk CVs into its leaf digest with the same subtree stack.
//
// lcpc_blake3_parents: one thread per parent; a parent is blake3(left ||
// right) as a single-chunk 64-byte message with CHUNK_START | CHUNK_END |
// ROOT, not Blake3's PARENT mode (the reference hashes concatenated digests
// with a fresh hasher, lib.rs:800-806).
//
// What bounds it on the H100: compression arithmetic.  At the 2^20 ft255
// commit the leaves are 32768 columns of 5 chunks (80 compressions each),
// so one thread per column fills only about an eighth of the card's
// thread slots; splitting each column's chunks over threads is the next
// step.  The column reads are coalesced: neighbouring threads read
// neighbouring 64-byte elements of the same row.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W: 0.27 ms for those 32768 leaves, 0.25 ms for
// all 15 Merkle layers above them.  The chunk-CV entry puts neighbouring
// columns on neighbouring threads too; at the 2^29 ft255 commit a 32-row
// batch is one chunk of each of 2^20 columns, 2 GiB of int32 limbs read
// once (0.65 ms at 3.35 TB/s) for 16 compressions a thread: measured 1.16 ms
// a batch, and 2.48 ms for the merge of 65 chunks of 2^20 columns (bound
// 1.60 ms, by its compressions).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void load_iv(uint32_t x[8]) {
    x[0] = 0x6A09E667u; x[1] = 0xBB67AE85u; x[2] = 0x3C6EF372u; x[3] = 0xA54FF53Au;
    x[4] = 0x510E527Fu; x[5] = 0x9B05688Cu; x[6] = 0x1F83D9ABu; x[7] = 0x5BE0CD19u;
}
constexpr uint32_t CHUNK_START = 1, CHUNK_END = 2, PARENT = 4, ROOT = 8;
constexpr int kMaxDepth = 40;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

__device__ __forceinline__ void g(uint32_t v[16], int a, int b, int c, int d, uint32_t mx,
                                  uint32_t my) {
    v[a] = v[a] + v[b] + mx;
    v[d] = rotr(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr(v[b] ^ v[c], 12);
    v[a] = v[a] + v[b] + my;
    v[d] = rotr(v[d] ^ v[a], 8);
    v[c] = v[c] + v[d];
    v[b] = rotr(v[b] ^ v[c], 7);
}

// first 8 output words of the Blake3 compression function
__device__ __forceinline__ void compress(uint32_t out[8], const uint32_t cv[8],
                                         const uint32_t block[16], uint64_t counter,
                                         uint32_t block_len, uint32_t flags) {
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

__device__ __forceinline__ void parent_cv(uint32_t out[8], const uint32_t left[8],
                                          const uint32_t right[8], uint32_t flags) {
    uint32_t block[16], iv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        block[i] = left[i];
        block[8 + i] = right[i];
    }
    load_iv(iv);
    compress(out, iv, block, 0, 64, flags);
}

// Blake3's stack of subtree CVs over a message's chunk CVs, in order
struct CvStack {
    uint32_t s[kMaxDepth][8];
    int depth = 0;

    // push the CV of chunk number total - 1 (not the last chunk), merging
    // every subtree it completes
    __device__ __forceinline__ void push(uint32_t cv[8], uint64_t total) {
        for (; (total & 1) == 0; total >>= 1) {
            --depth;
            parent_cv(cv, s[depth], cv, PARENT);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s[depth][i] = cv[i];
        ++depth;
    }

    // fold the last chunk's CV into the stack; the final parent is the root
    __device__ __forceinline__ void finish(uint32_t cv[8]) {
        while (depth > 0) {
            --depth;
            parent_cv(cv, s[depth], cv, PARENT | (depth == 0 ? ROOT : 0));
        }
    }
};

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

template <int W>
__global__ void blake3_leaves(const int32_t* __restrict__ comm, uint32_t* __restrict__ out,
                              int n_rows, int n_cols, int big_endian) {
    int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n_cols) return;
    const int64_t msg_len = 32 + (int64_t)n_rows * 4 * W;
    const int64_t nchunks = msg_len > 1024 ? (msg_len + 1023) / 1024 : 1;
    CvStack stack;
    uint32_t cv[8];
    for (int64_t ch = 0; ch < nchunks; ++ch) {
        const int64_t clen = ch == nchunks - 1 ? msg_len - ch * 1024 : 1024;
        chunk_cv<W>(cv, comm, ch * 256, 8, n_rows, n_cols, c, big_endian != 0, clen,
                    (uint64_t)ch, nchunks == 1 ? ROOT : 0);
        if (ch < nchunks - 1) stack.push(cv, (uint64_t)ch + 1);
    }
    stack.finish(cv);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[c * 8 + i] = cv[i];
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
    stack.finish(cv);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[c * 8 + i] = cv[i];
}

__global__ void blake3_parents(const uint32_t* __restrict__ nodes, uint32_t* __restrict__ out,
                               int n_parents) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_parents) return;
    uint32_t block[16], h[8], iv[8];
#pragma unroll
    for (int j = 0; j < 16; ++j) block[j] = nodes[i * 16 + j];
    load_iv(iv);
    compress(h, iv, block, 0, 64, CHUNK_START | CHUNK_END | ROOT);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i * 8 + j] = h[j];
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t threads) {
    return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// comm: (n_rows, n_cols, 2W) int32 limbs; out: (n_cols, 8) words.
int lcpc_blake3_leaves(const void* comm, void* out, int n_rows, int n_cols, int W,
                       int big_endian, void* stream) {
    auto in = static_cast<const int32_t*>(comm);
    auto o = static_cast<uint32_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    unsigned blocks = blocks_for(n_cols);
    switch (W) {
        case 2: blake3_leaves<2><<<blocks, kThreads, 0, st>>>(in, o, n_rows, n_cols, big_endian); break;
        case 4: blake3_leaves<4><<<blocks, kThreads, 0, st>>>(in, o, n_rows, n_cols, big_endian); break;
        case 6: blake3_leaves<6><<<blocks, kThreads, 0, st>>>(in, o, n_rows, n_cols, big_endian); break;
        case 8: blake3_leaves<8><<<blocks, kThreads, 0, st>>>(in, o, n_rows, n_cols, big_endian); break;
        default: return (int)cudaErrorInvalidValue;
    }
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

// nodes: (2 n_parents, 8) words; out: (n_parents, 8) words.
int lcpc_blake3_parents(const void* nodes, void* out, int n_parents, void* stream) {
    blake3_parents<<<blocks_for(n_parents), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(nodes), static_cast<uint32_t*>(out), n_parents);
    return (int)cudaGetLastError();
}

}  // extern "C"
