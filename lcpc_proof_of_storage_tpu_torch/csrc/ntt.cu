// K1: forward number-theoretic transform over a prime field, for sm_90a,
// and K4's inverse entry, as stage-group passes through shared memory.
//
// K1 replaces: lcpc_proof_of_storage_tpu/ops/ntt_pallas3.py, ntt_pallas3
// (the four-step kernels _kernel_a / _call_a at :546 and _kernel_b / _call_b
// at :564).  Computes what ops/ntt.py ntt computes: (batch, n, L) 16-bit
// limbs -> natural-order evaluations at w^0 .. w^(n-1), for any power-of-two
// n >= 2.  Input positions at or past n_nonzero are read as zero.  It also
// serves the forward half of K4 (ops/ntt_pallas2.py, _in_tile_call at :323 /
// _large_pair_call at :348 with the zero-pad skip): the same function.
//
// K4 inverse (lcpc_ntt_inverse) replaces the inverse half of
// ops/ntt_pallas2.py ntt_pallas2(inverse=True) (_in_tile_call :323 /
// _large_pair_call :348 with the n^-1 scale) and computes what ops/ntt.py
// intt computes: evaluations -> coefficients.  The same passes with the w^-j
// twiddles, no zero tail, and one Montgomery product by n^-1 * 2^(32W) mod p
// in the last pass's epilogue.
//
// lcpc_ntt_stages runs the passes from a given stage on, over words another
// kernel has already ordered and partly transformed, and unpacks: the
// fused_small route's stages with half >= its tile (ops/ntt_pallas.py
// _stage_call, K6).  It is counted as K1.
//
// The pass plan.  The radix-2 DIT stages 0 .. log2(n)-1 of a row held in
// bit-reversed order split into P = ceil(log2(n) / kMaxStages) groups of
// consecutive stages, the first (log2(n) mod P) groups one stage longer than
// the rest (ops/ntt.py ntt_pass_plan mirrors this rule).  With kMaxStages =
// 10, n <= 2^10 takes one pass, 2^11 .. 2^20 two (2^15: stages 0..7, 8..14;
// 2^20: 0..9, 10..19) and 2^21 .. 2^30 three.  One launch runs one group
// [s_lo, s_hi), k = s_hi - s_lo stages, on tiles of 2^k values: the elements
// j = hi * 2^s_hi + i * 2^s_lo + lo (i < 2^k) of a row in transform order,
// one tile for each (row, hi, lo); stage s pairs i and i + 2^(s - s_lo) and
// reads the twiddle ((i mod 2^(s-s_lo)) * 2^s_lo + lo) << (log2(n) - 1 - s)
// of K1's table (w^j in Montgomery form) through the read-only path.  A
// block holds T tiles with consecutive tile ids (lo fastest), 2^11 values in
// all at W >= 6 and 2^10 at W <= 4, so a warp's loads cover T consecutive
// elements; T is halved while the grid would have fewer than 256 blocks.
// The values sit word-major in dynamic shared memory, rows of T * 2^k + 1
// words (the pad puts a value's W words in W banks).  A thread takes four
// values i, i + h, i + 2h, i + 3h through two stages in registers (radix 4:
// half the shared-memory traffic and barriers of one stage at a time, and
// two independent products in flight), with a __syncthreads() between stage
// pairs; an odd last stage runs radix 2 (the loads and stores and the
// butterfly are in ntt_pass.cuh, shared with KT).  2048 values of W = 8 words
// take 66 KB, past the 48 KB default: the entry raises the kernel's limit
// first and returns that call's error.  Occupancy: __launch_bounds__(256, 3) at W
// >= 6 holds ptxas to 80 registers at W = 8, so three blocks (24 warps) fit
// an SM by registers and by shared memory (198 KB of 228); at W <= 4, four.
//
// The first pass's prologue reads the natural-order rows as they are stored:
// rows of n_in values (n_nonzero <= n_in <= n; n_in = n but for
// lcpc_ntt_forward_rows), each value 2W int32 limbs, packed into words, or 2W
// 16-bit limbs.  The 16-bit storage of a value is its W little-endian words
// byte for byte (limbs 2w and 2w + 1 are the halves of word w: what
// ops/ntt.py pack_words makes of them), so those are loaded as words, with
// no mask or shift.  Tile id c (of n / 2^k in a row) is the tile whose
// elements are x[c + u * n / 2^k], u < 2^k, placed at bit-reversed slots
// rev_k(u) (so the block's T tiles read T consecutive elements), and it
// reads only the np2(n_nonzero) head: the skip = log2(n / np2(n_nonzero))
// pruned stages become a duplicating gather (slot j holds x[rev(j & ~(2^skip
// - 1))], zero at or past n_nonzero, made in registers: nothing past a row's
// n_in values is read, so the rows need no zero pad), as KT and ops/ntt.py
// _skip_for do.  Each pass between writes words in place to the (batch, n,
// W) work buffer; the last pass's epilogue unpacks to int32 limbs (times
// n^-1 for the inverse) in natural order and, given out16, stores each value
// a second time as its W words: the (batch, n, L) 16-bit rows that the
// streamed commit keeps (core/streamed.py), which may be a row slice of a
// larger matrix.  Before, the streamed commit widened its 16-bit rows, wrote
// them into a zeroed int32 pad of width n and narrowed K1's output with two
// shifts, a subtract and a cast, each a pass over the batch in device memory.
//
// What bounds it on the H100: the operations.  At the Ligero 2^20 ft255
// commit, (128, 32768, 16) with n_nonzero 8192, 13 stages of 2^21
// butterflies at about 4 W^2 + 8 W 32-bit operations each (8 W where the
// twiddle is 1, one butterfly in 2^s at stage s) are 8.5 G operations,
// 0.252 ms at 33.5 T/s; the limbs in and out are 0.54 GB, 0.160
// ms at 3.35 TB/s (chip_smoke.py ntt_bound).  The two passes move the words
// twice more, 0.27 GB.  The design before this one launched once a stage,
// reading and writing the whole word matrix every stage (15 round trips, 4
// GB), with the arithmetic carried through 64-bit sums.  ptxas turns each
// mad.lo / madc.hi pair of montgomery.cuh into one IMAD.WIDE with carry.
// Above the bound remain the passes' loads and stores, which a block does
// not overlap with its own stages, the shared-memory traffic and the
// barriers (chip_smoke.py times each pass alone).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.80 ms
// at that commit's shape (the per-stage design: 6.39 ms), 0.43 ms of it the
// last pass alone; 7.31 ms on a (32, 2^20, 16) batch of the 2^29 commit
// (64.4 ms), bound 2.82 ms; K4's inverse 0.89 ms at (128, 32768, 16)
// (6.44 ms), bound 0.30 ms.  lcpc_ntt_forward_rows on a (32, 2^19, 16) batch
// of the 2^28 streamed commit, rows of 2^17 16-bit values in, int32 and
// 16-bit limbs out: 3.56-3.63 ms, where the widen, pad, K1 and narrow it
// replaced took 7.72-7.75 ms; bound 1.33 ms (operations).  ptxas: 80, 80, 58
// and 32 registers at W = 8, 6, 4, 2, and at W = 8 an 8-byte spill under the
// three-block bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "montgomery.cuh"
#include "ntt_pass.cuh"

namespace {

using namespace ntt_pass;

constexpr int kThreads = 256;
constexpr int kMaxStages = 10;   // stages a pass runs: tiles of at most 2^10 values
constexpr int kMinBlocks = 256;  // halve T while the grid has fewer blocks
constexpr int kDefaultSmem = 48 * 1024;

struct Pass {
    const void* in;       // limbs of the natural-order rows (in_limbs), else words
    void* out;            // limbs (out_limbs), else words; may be `in`
    void* out16;          // the last pass: also the values as 16-bit limbs here, or null
    const uint32_t* tw;   // (n/2, W) Montgomery words of w^j (or w^-j)
    int log_n, s_lo, s_hi;
    int s_first;          // the first stage run: stages [s_first, s_hi), s_first >= s_lo
    int log_t;            // log2 of the tiles a block holds
    int64_t tiles;        // batch * n / 2^(s_hi - s_lo)
    int in_limbs;         // the first pass: the prologue's gather
    int in16;             // ... of 16-bit limbs (a value's W words), else of int32 limbs
    int64_t n_in;         // ... from rows of n_in values (n_nonzero <= n_in <= n)
    int skip, n_nonzero;  // the prologue's pruned stages and zero tail
    int out_limbs;
    int scale;            // multiply by `s` (n^-1 in Montgomery form) before unpacking
};

// one group of stages over the T tiles of block blockIdx.x
template <int W>
__global__ void __launch_bounds__(kThreads, W <= 4 ? 4 : 3)
ntt_pass(Pass a, Mod<W> m, Words<W> s) {
    extern __shared__ uint32_t sm[];
    const int k = a.s_hi - a.s_lo;
    const int T = 1 << a.log_t;
    const int tile_len = 1 << k;
    const int ld = (T << k) + 1;
    const int64_t tile0 = (int64_t)blockIdx.x << a.log_t;
    const int here = a.tiles - tile0 < T ? (int)(a.tiles - tile0) : T;
    const int log_tpr = a.log_n - k;  // tiles in a row: n / 2^k
    const int64_t n = (int64_t)1 << a.log_n;

    // tile t of the block: its row and its element j = hi * 2^s_hi + i * 2^s_lo + lo
    auto tile_row = [&](int t) { return (tile0 + t) >> log_tpr; };
    auto tile_base = [&](int t) -> int64_t {  // hi * 2^s_hi + lo
        const int64_t r = (tile0 + t) & (((int64_t)1 << log_tpr) - 1);
        if (a.in_limbs)  // the first pass: tile id r reads natural column r, hi = rev(r)
            return (int64_t)(log_tpr ? __brev((uint32_t)r) >> (32 - log_tpr) : 0) << a.s_hi;
        return ((r >> a.s_lo) << a.s_hi) | (r & ((1 << a.s_lo) - 1));
    };

    if (a.in_limbs) {
        // prologue: element (t, u) is x[row, c + u * 2^log_tpr], c = the tile id
        // in its row, placed at slot rev_k(u) and its 2^skip' - 1 successors
        const int dup = a.skip < k ? a.skip : k;
        const int64_t np2_mask = ((int64_t)1 << (a.log_n - a.skip)) - 1;
        for (int e = threadIdx.x; e < (T << (k - dup)); e += blockDim.x) {
            const int t = e & (T - 1), u = e >> a.log_t;
            if (t >= here) continue;
            const int64_t c = (tile0 + t) & (((int64_t)1 << log_tpr) - 1);
            const int64_t src = ((int64_t)u << log_tpr | c) & np2_mask;
            uint32_t v[W];
            if (src < a.n_nonzero) {
                const int64_t at = tile_row(t) * a.n_in + src;
                if (a.in16)
                    load_words<W>(v, static_cast<const uint32_t*>(a.in) + at * W);
                else
                    load_limbs<W>(v, static_cast<const int32_t*>(a.in) + at * (2 * W));
            } else {
#pragma unroll
                for (int w = 0; w < W; ++w) v[w] = 0;
            }
            const int slot = k ? (int)(__brev((uint32_t)u) >> (32 - k)) : 0;
            for (int d = 0; d < (1 << dup); ++d) {
#pragma unroll
                for (int w = 0; w < W; ++w) sm[w * ld + (t << k) + slot + d] = v[w];
            }
        }
    } else {
        // words: a tile of the first group is a contiguous run (i fastest),
        // of a later group a column of T consecutive elements (t fastest)
        const uint32_t* x = static_cast<const uint32_t*>(a.in);
        const bool run = a.s_lo == 0;
        for (int e = threadIdx.x; e < (T << k); e += blockDim.x) {
            const int t = run ? e >> k : e & (T - 1);
            const int i = run ? e & (tile_len - 1) : e >> a.log_t;
            if (t >= here) continue;
            const int64_t j = tile_base(t) + ((int64_t)i << a.s_lo);
            uint32_t v[W];
            load_words<W>(v, x + (tile_row(t) * n + j) * W);
#pragma unroll
            for (int w = 0; w < W; ++w) sm[w * ld + (t << k) + i] = v[w];
        }
    }
    __syncthreads();

    // the stages two at a time: a thread takes the four values i, i + h,
    // i + 2h, i + 3h (h = 2^(st - s_lo)) through stages st and st + 1 in
    // registers; an odd last stage runs radix-2
    const int lo_mask = (1 << a.s_lo) - 1;
    int st = a.s_first;
    for (; st + 1 < a.s_hi; st += 2) {
        const int ls = st - a.s_lo;
        const int h = 1 << ls;
        const int shift = a.log_n - 1 - st;
        for (int f = threadIdx.x; f < (T << (k - 2)); f += blockDim.x) {
            const int t = f >> (k - 2);
            if (t >= here) continue;
            const int q = f & ((tile_len >> 2) - 1);
            const int kk = q & (h - 1);
            const int v = (t << k) + ((q >> ls) << (ls + 2)) + kk;
            const int64_t lo = (int)(tile0 + t) & lo_mask;
            uint32_t x0[W], x1[W], x2[W], x3[W], wv[W];
            load_smem<W>(x0, sm, ld, v);
            load_smem<W>(x1, sm, ld, v + h);
            load_smem<W>(x2, sm, ld, v + 2 * h);
            load_smem<W>(x3, sm, ld, v + 3 * h);
            load_tw<W>(wv, a.tw, (((int64_t)kk << a.s_lo) | lo) << shift);
            butterfly<W>(x0, x1, wv, m);
            butterfly<W>(x2, x3, wv, m);
            load_tw<W>(wv, a.tw, (((int64_t)kk << a.s_lo) | lo) << (shift - 1));
            butterfly<W>(x0, x2, wv, m);
            load_tw<W>(wv, a.tw, (((int64_t)(kk + h) << a.s_lo) | lo) << (shift - 1));
            butterfly<W>(x1, x3, wv, m);
            store_smem<W>(sm, ld, v, x0);
            store_smem<W>(sm, ld, v + h, x1);
            store_smem<W>(sm, ld, v + 2 * h, x2);
            store_smem<W>(sm, ld, v + 3 * h, x3);
        }
        __syncthreads();
    }
    if (st < a.s_hi) {
        const int ls = st - a.s_lo;
        const int h = 1 << ls;
        for (int f = threadIdx.x; f < (T << (k - 1)); f += blockDim.x) {
            const int t = f >> (k - 1);
            if (t >= here) continue;
            const int q = f & ((tile_len >> 1) - 1);
            const int kk = q & (h - 1);
            const int v = (t << k) + ((q >> ls) << (ls + 1)) + kk;
            const int64_t lo = (int)(tile0 + t) & lo_mask;
            uint32_t x0[W], x1[W], wv[W];
            load_smem<W>(x0, sm, ld, v);
            load_smem<W>(x1, sm, ld, v + h);
            load_tw<W>(wv, a.tw, (((int64_t)kk << a.s_lo) | lo) << (a.log_n - 1 - st));
            butterfly<W>(x0, x1, wv, m);
            store_smem<W>(sm, ld, v, x0);
            store_smem<W>(sm, ld, v + h, x1);
        }
        __syncthreads();
    }

    // epilogue: the tiles back to their elements, as words or (scaled) limbs
    const bool run = a.s_lo == 0;
    for (int e = threadIdx.x; e < (T << k); e += blockDim.x) {
        const int t = run ? e >> k : e & (T - 1);
        const int i = run ? e & (tile_len - 1) : e >> a.log_t;
        if (t >= here) continue;
        const int64_t g = tile_row(t) * n + tile_base(t) + ((int64_t)i << a.s_lo);
        uint32_t v[W];
#pragma unroll
        for (int w = 0; w < W; ++w) v[w] = sm[w * ld + (t << k) + i];
        if (a.scale) {
            uint32_t y[W];
            mont_mul<W>(y, v, s.w, m);
#pragma unroll
            for (int w = 0; w < W; ++w) v[w] = y[w];
        }
        if (a.out_limbs) {
            store_limbs<W>(static_cast<int32_t*>(a.out) + g * (2 * W), v);
            if (a.out16) store_words<W>(static_cast<uint32_t*>(a.out16) + g * W, v);
        } else
            store_words<W>(static_cast<uint32_t*>(a.out) + g * W, v);
    }
}

// the pass plan's group g of P: [lo, hi) (ops/ntt.py ntt_pass_plan)
inline void pass_group(int log_n, int g, int* lo, int* hi) {
    const int P = (log_n + kMaxStages - 1) / kMaxStages;
    const int q = log_n / P, r = log_n % P;
    *lo = g * q + (g < r ? g : r);
    *hi = *lo + q + (g < r ? 1 : 0);
}

// every pass of a transform: the first reads `in` (int32 or, with in16, 16-bit
// limbs of rows of n_in values with the prologue's gather, or words), the ones
// between work in place on `work`, the last writes `out` as limbs (times n^-1
// when `scale` is given) and, if given, `out16` as 16-bit limbs; stages from
// `start` on
template <int W>
int ntt_passes(const void* in, int32_t* out, uint32_t* out16, uint32_t* work,
               const uint32_t* tw, int batch, int log_n, int start, int in_limbs, int in16,
               int64_t n_in, int skip, int n_nonzero, const Mod<W>& m, const Words<W>* scale,
               cudaStream_t stream) {
    const int P = (log_n + kMaxStages - 1) / kMaxStages;
    for (int g = 0; g < P; ++g) {
        int lo, hi;
        pass_group(log_n, g, &lo, &hi);
        const bool first = g == 0, last = g == P - 1;
        if (!last && !(first && in_limbs) && hi <= start) continue;  // nothing to do
        const int k = hi - lo;
        const int64_t tiles = (int64_t)batch << (log_n - k);
        int log_t = log_block(W) - k;
        while (log_t > 0 && ((tiles + (1 << log_t) - 1) >> log_t) < kMinBlocks) --log_t;
        Pass a;
        a.in = first && in_limbs ? in : work;
        a.out = last ? (void*)out : (void*)work;
        a.out16 = last ? (void*)out16 : nullptr;
        a.tw = tw;
        a.log_n = log_n, a.s_lo = lo, a.s_hi = hi;
        a.s_first = start > lo ? start : lo;
        a.log_t = log_t;
        a.tiles = tiles;
        a.in_limbs = first && in_limbs;
        a.in16 = in16, a.n_in = n_in;
        a.skip = skip, a.n_nonzero = n_nonzero;
        a.out_limbs = last;
        a.scale = last && scale != nullptr;
        Words<W> s{};
        if (scale) s = *scale;
        const size_t smem = (size_t)W * (((size_t)1 << (log_t + k)) + 1) * sizeof(uint32_t);
        if (smem > (size_t)kDefaultSmem) {
            cudaError_t err = cudaFuncSetAttribute(
                ntt_pass<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        const unsigned blocks = (unsigned)((tiles + (1 << log_t) - 1) >> log_t);
        ntt_pass<W><<<blocks, kThreads, smem, stream>>>(a, m, s);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

// log2(n / np2(n_nonzero)): the stages that only duplicate values when the
// positions at or past n_nonzero are zero (ops/ntt.py _skip_for)
inline int skip_for(int log_n, int n_nonzero) {
    if (n_nonzero <= 0 || n_nonzero >= (1 << log_n)) return 0;
    int log_np2 = 0;
    while ((1 << log_np2) < n_nonzero) ++log_np2;
    return log_n - log_np2;
}

template <int W>
int ntt_forward(const void* in, int32_t* out, uint32_t* out16, uint32_t* work,
                const uint32_t* tw, int batch, int log_n, int64_t n_in, int n_nonzero,
                int in16, const uint32_t* p_host, cudaStream_t stream) {
    const int skip = skip_for(log_n, n_nonzero);
    return ntt_passes<W>(in, out, out16, work, tw, batch, log_n, skip, 1, in16, n_in, skip,
                         n_nonzero, make_mod<W>(p_host), nullptr, stream);
}

template <int W>
int ntt_stages(uint32_t* work, int32_t* out, const uint32_t* tw, int batch, int log_n,
               int s0, const uint32_t* p_host, cudaStream_t stream) {
    return ntt_passes<W>(work, out, nullptr, work, tw, batch, log_n, s0, 0, 0, 1 << log_n, 0,
                         1 << log_n, make_mod<W>(p_host), nullptr, stream);
}

template <int W>
int ntt_inverse(const int32_t* in, int32_t* out, uint32_t* work, const uint32_t* tw_inv,
                int batch, int log_n, const uint32_t* p_host, const uint32_t* n_inv_mont,
                cudaStream_t stream) {
    Words<W> s;
    for (int i = 0; i < W; ++i) s.w[i] = n_inv_mont[i];
    return ntt_passes<W>(in, out, nullptr, work, tw_inv, batch, log_n, 0, 1, 0, 1 << log_n, 0,
                         1 << log_n, make_mod<W>(p_host), &s, stream);
}

}  // namespace

extern "C" {

// in: (batch, n_in, 2W) int32 limbs or, with in16, (batch, n_in, 2W) 16-bit limbs,
// read as zero at or past n_nonzero (n_nonzero <= n_in <= 2^log_n); out:
// (batch, 2^log_n, 2W) int32 limbs; out16: null, or (batch, 2^log_n, 2W) 16-bit
// limbs that the last pass also writes; work, tw, p_host: as lcpc_ntt_forward's.
// Returns the first CUDA error of the passes' launches (0 on success).
int lcpc_ntt_forward_rows(const void* in, void* out, void* out16, void* work, const void* tw,
                          int batch, int log_n, int n_in, int n_nonzero, int in16, int W,
                          const void* p_host, void* stream) {
    if (batch <= 0 || log_n < 1 || log_n > 30 || n_in < 1 || n_in > (1 << log_n) ||
        n_nonzero < 0 || n_nonzero > n_in)
        return (int)cudaErrorInvalidValue;
    auto o = static_cast<int32_t*>(out);
    auto o16 = static_cast<uint32_t*>(out16);
    auto wk = static_cast<uint32_t*>(work);
    auto t = static_cast<const uint32_t*>(tw);
    auto p = static_cast<const uint32_t*>(p_host);
    auto st = static_cast<cudaStream_t>(stream);
    const int nz = n_nonzero;
    switch (W) {
        case 2: return ntt_forward<2>(in, o, o16, wk, t, batch, log_n, n_in, nz, in16, p, st);
        case 4: return ntt_forward<4>(in, o, o16, wk, t, batch, log_n, n_in, nz, in16, p, st);
        case 6: return ntt_forward<6>(in, o, o16, wk, t, batch, log_n, n_in, nz, in16, p, st);
        case 8: return ntt_forward<8>(in, o, o16, wk, t, batch, log_n, n_in, nz, in16, p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// in, out: (batch, 2^log_n, 2W) int32 limbs; work: (batch, 2^log_n, W) words;
// tw: (2^(log_n-1), W) words of w^j * 2^(32W) mod p; p_host: W host words of p.
// Returns the first CUDA error of the passes' launches (0 on success).
int lcpc_ntt_forward(const void* in, void* out, void* work, const void* tw, int batch,
                     int log_n, int n_nonzero, int W, const void* p_host, void* stream) {
    if (batch <= 0 || log_n < 1 || log_n > 30) return (int)cudaErrorInvalidValue;
    return lcpc_ntt_forward_rows(in, out, nullptr, work, tw, batch, log_n, 1 << log_n,
                                 n_nonzero, 0, W, p_host, stream);
}

// in, out: (batch, 2^log_n, 2W) int32 limbs; work: (batch, 2^log_n, W) words;
// tw_inv: (2^(log_n-1), W) words of w^-j * 2^(32W) mod p; p_host, n_inv_mont:
// W host words of p and of n^-1 * 2^(32W) mod p.  Returns the first CUDA
// error of the passes' launches (0 on success).
int lcpc_ntt_inverse(const void* in, void* out, void* work, const void* tw_inv, int batch,
                     int log_n, int W, const void* p_host, const void* n_inv_mont,
                     void* stream) {
    if (batch <= 0 || log_n < 1 || log_n > 30) return (int)cudaErrorInvalidValue;
    auto i = static_cast<const int32_t*>(in);
    auto o = static_cast<int32_t*>(out);
    auto wk = static_cast<uint32_t*>(work);
    auto t = static_cast<const uint32_t*>(tw_inv);
    auto p = static_cast<const uint32_t*>(p_host);
    auto s = static_cast<const uint32_t*>(n_inv_mont);
    auto st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 2: return ntt_inverse<2>(i, o, wk, t, batch, log_n, p, s, st);
        case 4: return ntt_inverse<4>(i, o, wk, t, batch, log_n, p, s, st);
        case 6: return ntt_inverse<6>(i, o, wk, t, batch, log_n, p, s, st);
        case 8: return ntt_inverse<8>(i, o, wk, t, batch, log_n, p, s, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// work: (batch, 2^log_n, W) words in transform order with the stages before s0
// done, transformed in place by the passes of the stages s0 .. log_n-1; out:
// (batch, 2^log_n, 2W) int32 limbs; tw: as lcpc_ntt_forward's (or
// lcpc_ntt_inverse's).  Returns the first CUDA error (0 on success).
int lcpc_ntt_stages(void* work, void* out, const void* tw, int batch, int log_n, int s0,
                    int W, const void* p_host, void* stream) {
    if (batch <= 0 || log_n < 1 || log_n > 30 || s0 < 0 || s0 >= log_n)
        return (int)cudaErrorInvalidValue;
    auto wk = static_cast<uint32_t*>(work);
    auto o = static_cast<int32_t*>(out);
    auto t = static_cast<const uint32_t*>(tw);
    auto p = static_cast<const uint32_t*>(p_host);
    auto st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 2: return ntt_stages<2>(wk, o, t, batch, log_n, s0, p, st);
        case 4: return ntt_stages<4>(wk, o, t, batch, log_n, s0, p, st);
        case 6: return ntt_stages<6>(wk, o, t, batch, log_n, s0, p, st);
        case 8: return ntt_stages<8>(wk, o, t, batch, log_n, s0, p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* lcpc_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
