// Host library of the PyTorch port: the protocol's sequential host work.
//
// A copy of the JAX package's native/posnative.cc cut to the entry points
// the port calls: Blake3 of byte strings and the verifier's Merkle path
// folds, BLAKE2b-256 of byte strings and the Merkle layers of either digest
// (the generic-digest commit), ChaCha keystream blocks, Keccak-f[1600] and
// the STROBE-128 duplex under the merlin transcript, and the Brakedown matgen walk with its
// Montgomery-to-limbs conversion.  Each function keeps the reference's
// semantics bit for bit; the Python modules that call it keep a pure-Python
// fallback for machines without a C++ compiler.
//
// Built by native/__init__.py at first use:
//   g++ -O3 -fopenmp -shared -fPIC posnative.cc -o libposnative.so

#include <cstdint>
#include <cstring>

extern "C" {
// ---------------------------------------------------------------------------
// Blake3 (portable implementation, default hash mode)
// ---------------------------------------------------------------------------

static const uint32_t B3_IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};
static const uint8_t B3_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13,
                                    1, 11, 12, 5, 9, 14, 15, 8};
enum { CHUNK_START = 1, CHUNK_END = 2, PARENT = 4, ROOT = 8 };

static inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void b3_compress(const uint32_t cv[8], const uint32_t block[16],
                        uint64_t counter, uint32_t block_len, uint32_t flags,
                        uint32_t out[16]) {
  uint32_t v[16];
  uint32_t m[16];
  for (int i = 0; i < 8; i++) v[i] = cv[i];
  for (int i = 0; i < 4; i++) v[8 + i] = B3_IV[i];
  v[12] = (uint32_t)counter;
  v[13] = (uint32_t)(counter >> 32);
  v[14] = block_len;
  v[15] = flags;
  for (int i = 0; i < 16; i++) m[i] = block[i];

#define G(a, b, c, d, mx, my)                      \
  v[a] = v[a] + v[b] + (mx);                       \
  v[d] = rotr32(v[d] ^ v[a], 16);                  \
  v[c] = v[c] + v[d];                              \
  v[b] = rotr32(v[b] ^ v[c], 12);                  \
  v[a] = v[a] + v[b] + (my);                       \
  v[d] = rotr32(v[d] ^ v[a], 8);                   \
  v[c] = v[c] + v[d];                              \
  v[b] = rotr32(v[b] ^ v[c], 7);

  for (int r = 0; r < 7; r++) {
    G(0, 4, 8, 12, m[0], m[1]);
    G(1, 5, 9, 13, m[2], m[3]);
    G(2, 6, 10, 14, m[4], m[5]);
    G(3, 7, 11, 15, m[6], m[7]);
    G(0, 5, 10, 15, m[8], m[9]);
    G(1, 6, 11, 12, m[10], m[11]);
    G(2, 7, 8, 13, m[12], m[13]);
    G(3, 4, 9, 14, m[14], m[15]);
    if (r < 6) {
      uint32_t t[16];
      for (int i = 0; i < 16; i++) t[i] = m[B3_PERM[i]];
      memcpy(m, t, sizeof(t));
    }
  }
#undef G
  for (int i = 0; i < 8; i++) {
    out[i] = v[i] ^ v[i + 8];
    out[i + 8] = v[i + 8] ^ cv[i];
  }
}

static void b3_load_block(const uint8_t* p, size_t len, uint32_t block[16]) {
  uint8_t tmp[64];
  memset(tmp, 0, 64);
  memcpy(tmp, p, len);
  for (int i = 0; i < 16; i++) {
    block[i] = (uint32_t)tmp[4 * i] | ((uint32_t)tmp[4 * i + 1] << 8) |
               ((uint32_t)tmp[4 * i + 2] << 16) |
               ((uint32_t)tmp[4 * i + 3] << 24);
  }
}

// CV of one chunk (<= 1024 bytes); root flag applied if is_root.
static void b3_chunk_cv(const uint8_t* data, size_t len, uint64_t counter,
                        int is_root, uint32_t cv_out[8]) {
  uint32_t cv[8];
  memcpy(cv, B3_IV, sizeof(cv));
  size_t nblocks = len == 0 ? 1 : (len + 63) / 64;
  for (size_t b = 0; b < nblocks; b++) {
    size_t blen = len == 0 ? 0 : (b == nblocks - 1 ? len - 64 * b : 64);
    uint32_t flags = 0;
    if (b == 0) flags |= CHUNK_START;
    if (b == nblocks - 1) {
      flags |= CHUNK_END;
      if (is_root) flags |= ROOT;
    }
    uint32_t block[16], out[16];
    b3_load_block(data + 64 * b, blen, block);
    b3_compress(cv, block, counter, (uint32_t)blen, flags, out);
    memcpy(cv, out, 32);
  }
  memcpy(cv_out, cv, 32);
}

static void b3_parent(const uint32_t l[8], const uint32_t r[8], int is_root,
                      uint32_t out_cv[8]) {
  uint32_t block[16], out[16];
  memcpy(block, l, 32);
  memcpy(block + 8, r, 32);
  b3_compress(B3_IV, block, 0, 64, PARENT | (is_root ? ROOT : 0), out);
  memcpy(out_cv, out, 32);
}

void pos_blake3(const uint8_t* data, size_t len, uint8_t out[32]) {
  // incremental pairwise-with-carry merge (== left-leaning chunk tree)
  uint32_t stack[64][8];
  int depth = 0;
  size_t nchunks = len <= 1024 ? 1 : (len + 1023) / 1024;
  if (nchunks == 1) {
    uint32_t cv[8];
    b3_chunk_cv(data, len, 0, 1, cv);
    memcpy(out, cv, 32);
    return;
  }
  for (size_t c = 0; c < nchunks; c++) {
    size_t clen = c == nchunks - 1 ? len - 1024 * c : 1024;
    uint32_t cv[8];
    b3_chunk_cv(data + 1024 * c, clen, c, 0, cv);
    memcpy(stack[depth++], cv, 32);
    size_t total = c + 1;
    // the final chunk never merges eagerly (it carries the ROOT merge)
    if (c == nchunks - 1) break;
    while ((total & 1) == 0) {
      b3_parent(stack[depth - 2], stack[depth - 1], 0, stack[depth - 2]);
      depth--;
      total >>= 1;
    }
  }
  while (depth > 1) {
    b3_parent(stack[depth - 2], stack[depth - 1], depth == 2, stack[depth - 2]);
    depth--;
  }
  memcpy(out, stack[0], 32);
}

// Hash n_msgs equal-length messages laid out contiguously.
void pos_blake3_many(const uint8_t* data, size_t n_msgs, size_t msg_len,
                     uint8_t* out) {
  for (size_t i = 0; i < n_msgs; i++) {
    pos_blake3(data + i * msg_len, msg_len, out + 32 * i);
  }
}

// Merkle path folds, leaf -> root, for k columns at once (the verifier's
// ColumnPath check, lcpc-2d/src/lib.rs:1010-1030): h = H(h||sib) or
// H(sib||h) by the column index bit at each level.  Each 64-byte parent
// message is a single Blake3 chunk, so fold entirely in C — one call
// replaces the per-level python staging (~39-77 ms for a Brakedown 2^25
// proof's 6593 x 13 fold).
// leaves: (k, 32); sibs: (k, depth, 32); cols: (k,) i64; out: (k, 32).
void pos_fold_paths(const uint8_t* leaves, const uint8_t* sibs,
                    const int64_t* cols, int64_t k, int64_t depth,
                    uint8_t* out) {
#pragma omp parallel for schedule(static) if (k > 64)
  for (int64_t i = 0; i < k; i++) {
    uint8_t msg[64];
    uint8_t h[32];
    memcpy(h, leaves + 32 * i, 32);
    int64_t c = cols[i];
    for (int64_t l = 0; l < depth; l++) {
      const uint8_t* sib = sibs + (i * depth + l) * 32;
      if ((c & 1) == 0) {
        memcpy(msg, h, 32);
        memcpy(msg + 32, sib, 32);
      } else {
        memcpy(msg, sib, 32);
        memcpy(msg + 32, h, 32);
      }
      uint32_t cv[8];
      b3_chunk_cv(msg, 64, 0, 1, cv);
      memcpy(h, cv, 32);
      c >>= 1;
    }
    memcpy(out + 32 * i, h, 32);
  }
}

// ---------------------------------------------------------------------------
// BLAKE2b-256 (RFC 7693) — the reference's alternate digest type parameter
// (LcCommit<Blake2b, E>; doc/benchmark-results/sdig-ligero-isz-
// microbenchmarks ran commit_Ft255_Blake2b_16).  Batch form feeds the
// generic-digest commit path (crypto/digest.py hash_many).
// ---------------------------------------------------------------------------

static const uint64_t B2B_IV[8] = {
    0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
    0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
    0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t b2b_rotr(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

static void b2b_compress(uint64_t h[8], const uint8_t* block, uint64_t t,
                         int last) {
  uint64_t m[16], v[16];
  memcpy(m, block, 128);
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = B2B_IV[i];
  v[12] ^= t;            // low counter word (messages < 2^64 bytes)
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; r++) {
    const uint8_t* s = B2B_SIGMA[r];
#define B2B_G(a, b, c, d, x, y)                        \
  v[a] = v[a] + v[b] + (x); v[d] = b2b_rotr(v[d] ^ v[a], 32); \
  v[c] = v[c] + v[d];       v[b] = b2b_rotr(v[b] ^ v[c], 24); \
  v[a] = v[a] + v[b] + (y); v[d] = b2b_rotr(v[d] ^ v[a], 16); \
  v[c] = v[c] + v[d];       v[b] = b2b_rotr(v[b] ^ v[c], 63);
    B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]])
    B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]])
    B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]])
    B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]])
    B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]])
    B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]])
    B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]])
    B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]])
#undef B2B_G
  }
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

// BLAKE2b with 32-byte output, no key (== hashlib.blake2b(digest_size=32)).
void pos_blake2b_256(const uint8_t* data, size_t len, uint8_t out[32]) {
  uint64_t h[8];
  for (int i = 0; i < 8; i++) h[i] = B2B_IV[i];
  h[0] ^= 0x01010000ull ^ 32;          // param block: digest_len=32, fanout=depth=1
  size_t off = 0;
  while (len - off > 128) {
    b2b_compress(h, data + off, (uint64_t)(off + 128), 0);
    off += 128;
  }
  uint8_t last[128];
  size_t rem = len - off;              // 0 < rem <= 128 unless len == 0
  memset(last, 0, 128);
  if (len) memcpy(last, data + off, rem);
  b2b_compress(h, last, (uint64_t)len, 1);
  memcpy(out, h, 32);
}

void pos_blake2b_many(const uint8_t* data, size_t n_msgs, size_t msg_len,
                      uint8_t* out) {
#pragma omp parallel for schedule(static) if (n_msgs > 16)
  for (size_t i = 0; i < n_msgs; i++) {
    pos_blake2b_256(data + i * msg_len, msg_len, out + 32 * i);
  }
}

// Merkle layers of BLAKE2b-256, in place: nodes is the (2*np2 - 1, 32)
// Merkle array of core/commit.py with its np2 leaves (zero digests past
// n_cols) filled; each layer's parents H(left || right) follow the layer
// below, the root last (lcpc-2d/src/lib.rs:685-694, 777-815).  OpenMP
// across the parents of a layer.
void pos_merkle_layers(uint8_t* nodes, int64_t np2) {
  uint8_t* layer = nodes;
  for (int64_t width = np2; width > 1; width /= 2) {
    uint8_t* parents = layer + 32 * width;
#pragma omp parallel for schedule(static) if (width > 512)
    for (int64_t i = 0; i < width / 2; i++) {
      pos_blake2b_256(layer + 64 * i, 64, parents + 32 * i);
    }
    layer = parents;
  }
}

// ---------------------------------------------------------------------------
// ChaCha (rand_chacha layout: 64-bit counter words 12-13, stream words 14-15)
// ---------------------------------------------------------------------------

void pos_chacha_blocks(const uint8_t key[32], uint64_t stream,
                       uint64_t counter0, size_t nblocks, int rounds,
                       uint8_t* out) {
  static const uint32_t C[4] = {0x61707865u, 0x3320646Eu, 0x79622D32u,
                                0x6B206574u};
  uint32_t k[8];
  for (int i = 0; i < 8; i++) {
    k[i] = (uint32_t)key[4 * i] | ((uint32_t)key[4 * i + 1] << 8) |
           ((uint32_t)key[4 * i + 2] << 16) | ((uint32_t)key[4 * i + 3] << 24);
  }
#pragma omp parallel for schedule(static) if (nblocks > 4096)
  for (size_t b = 0; b < nblocks; b++) {
    uint64_t ctr = counter0 + b;
    uint32_t s[16];
    for (int i = 0; i < 4; i++) s[i] = C[i];
    for (int i = 0; i < 8; i++) s[4 + i] = k[i];
    s[12] = (uint32_t)ctr;
    s[13] = (uint32_t)(ctr >> 32);
    s[14] = (uint32_t)stream;
    s[15] = (uint32_t)(stream >> 32);
    uint32_t x[16];
    memcpy(x, s, sizeof(s));
#define QR(a, b, c, d)                    \
  x[a] += x[b]; x[d] = rotr32(x[d] ^ x[a], 16); \
  x[c] += x[d]; x[b] = rotr32(x[b] ^ x[c], 20); \
  x[a] += x[b]; x[d] = rotr32(x[d] ^ x[a], 24); \
  x[c] += x[d]; x[b] = rotr32(x[b] ^ x[c], 25);
    for (int r = 0; r < rounds; r += 2) {
      QR(0, 4, 8, 12) QR(1, 5, 9, 13) QR(2, 6, 10, 14) QR(3, 7, 11, 15)
      QR(0, 5, 10, 15) QR(1, 6, 11, 12) QR(2, 7, 8, 13) QR(3, 4, 9, 14)
    }
#undef QR
    uint8_t* o = out + 64 * b;
    for (int i = 0; i < 16; i++) {
      uint32_t w = x[i] + s[i];
      o[4 * i] = (uint8_t)w;
      o[4 * i + 1] = (uint8_t)(w >> 8);
      o[4 * i + 2] = (uint8_t)(w >> 16);
      o[4 * i + 3] = (uint8_t)(w >> 24);
    }
  }
}

// ---------------------------------------------------------------------------
// Keccak-f[1600]
// ---------------------------------------------------------------------------

static const int KECCAK_RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55,
                                   20, 3,  10, 43, 25, 39, 41, 45, 15,
                                   21, 8,  18, 2,  61, 56, 14};
static inline uint64_t rotl64(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

void pos_keccak_f1600(uint64_t a[25]) {
  // generate round constants with the spec LFSR
  uint64_t rc_lfsr = 1;
  for (int rnd = 0; rnd < 24; rnd++) {
    uint64_t c[5], d[5], b[25];
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], KECCAK_RHO[x + 5 * y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    // iota via LFSR
    uint64_t rc = 0;
    for (int j = 0; j < 7; j++) {
      // bit = lfsr output
      uint64_t bit = rc_lfsr & 1;
      rc |= bit << ((1u << j) - 1);
      rc_lfsr <<= 1;
      if (rc_lfsr & 0x100) rc_lfsr ^= 0x171;
    }
    a[0] ^= rc;
  }
}

// ---------------------------------------------------------------------------
// STROBE-128 duplex (merlin transcript fast path)
// ---------------------------------------------------------------------------
//
// Mirrors crypto/strobe.py (merlin-2.0/src/strobe.rs semantics): the state
// layout, begin-op framing, and the state_bytes() snapshot must stay
// bit-identical with the pure-python implementation (test oracle).

enum {
  STROBE_R = 166,
  SF_I = 1, SF_A = 2, SF_C = 4, SF_T = 8, SF_M = 16, SF_K = 32,
};

struct PosStrobe {
  alignas(8) uint8_t state[200];
  uint8_t pos, pos_begin, cur_flags;
};

static void strobe_run_f(PosStrobe* s) {
  s->state[s->pos] ^= s->pos_begin;
  s->state[s->pos + 1] ^= 0x04;
  s->state[STROBE_R + 1] ^= 0x80;
  pos_keccak_f1600((uint64_t*)s->state);
  s->pos = 0;
  s->pos_begin = 0;
}

static void strobe_absorb(PosStrobe* s, const uint8_t* d, size_t n) {
  for (size_t i = 0; i < n; i++) {
    s->state[s->pos++] ^= d[i];
    if (s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_squeeze(PosStrobe* s, uint8_t* o, size_t n) {
  for (size_t i = 0; i < n; i++) {
    o[i] = s->state[s->pos];
    s->state[s->pos++] = 0;
    if (s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_begin_op(PosStrobe* s, uint8_t flags) {
  uint8_t hdr[2] = {s->pos_begin, flags};
  s->pos_begin = s->pos + 1;
  s->cur_flags = flags;
  strobe_absorb(s, hdr, 2);
  if ((flags & (SF_C | SF_K)) && s->pos != 0) strobe_run_f(s);
}

PosStrobe* pos_strobe_new(const uint8_t* label, size_t label_len) {
  PosStrobe* s = new PosStrobe;
  memset(s->state, 0, 200);
  const uint8_t init[6] = {1, STROBE_R + 2, 1, 0, 1, 96};
  memcpy(s->state, init, 6);
  memcpy(s->state + 6, "STROBEv1.0.2", 12);
  pos_keccak_f1600((uint64_t*)s->state);
  s->pos = 0;
  s->pos_begin = 0;
  s->cur_flags = 0;
  strobe_begin_op(s, SF_M | SF_A);   // meta_ad(label, more=false)
  strobe_absorb(s, label, label_len);
  return s;
}

void pos_strobe_meta_ad(PosStrobe* s, const uint8_t* d, size_t n, int more) {
  if (!more) strobe_begin_op(s, SF_M | SF_A);
  strobe_absorb(s, d, n);
}

void pos_strobe_ad(PosStrobe* s, const uint8_t* d, size_t n, int more) {
  if (!more) strobe_begin_op(s, SF_A);
  strobe_absorb(s, d, n);
}

void pos_strobe_prf(PosStrobe* s, uint8_t* out, size_t n, int more) {
  if (!more) strobe_begin_op(s, SF_I | SF_A | SF_C);
  strobe_squeeze(s, out, n);
}

// merlin append_message(label, msg), `count` times over equal-length
// messages laid out contiguously: meta_ad(label) / meta_ad(len_le32, more)
// / ad(msg) per message.  One native call replaces 3*count python STROBE
// ops (the transcript cost of appending a collapsed row's coefficients).
void pos_strobe_append_batch(PosStrobe* s, const uint8_t* label,
                             size_t label_len, const uint8_t* msgs,
                             size_t msg_len, size_t count) {
  uint8_t len_le[4] = {
      (uint8_t)msg_len, (uint8_t)(msg_len >> 8),
      (uint8_t)(msg_len >> 16), (uint8_t)(msg_len >> 24)};
  for (size_t i = 0; i < count; i++) {
    strobe_begin_op(s, SF_M | SF_A);
    strobe_absorb(s, label, label_len);
    strobe_absorb(s, len_le, 4);
    strobe_begin_op(s, SF_A);
    strobe_absorb(s, msgs + i * msg_len, msg_len);
  }
}

PosStrobe* pos_strobe_clone(const PosStrobe* s) {
  PosStrobe* n = new PosStrobe;
  memcpy(n, s, sizeof(PosStrobe));
  return n;
}

// 203-byte snapshot: state || pos || pos_begin || cur_flags (test oracle).
void pos_strobe_state(const PosStrobe* s, uint8_t* out) {
  memcpy(out, s->state, 200);
  out[200] = s->pos;
  out[201] = s->pos_begin;
  out[202] = s->cur_flags;
}

void pos_strobe_free(PosStrobe* s) { delete s; }

// ---------------------------------------------------------------------------
// Brakedown matgen walk (matgen.rs:115-188 draw-by-draw semantics)
// ---------------------------------------------------------------------------
// Exact sequential walk over a peeked ChaCha u64 window.  Per column:
// uniform rejection draws (rand 0.8 widening multiply: accept when the low
// 64 bits of v*range <= zone) until d DISTINCT rows, then sort; then k-word
// field attempts (top word masked to the field's bit width, accept when the
// masked repr is in (0, p)) until d accepted.  Outputs the sorted rows and
// the accepted masked reprs (Montgomery form; the host converts repr*R^-1
// mod p vectorized).  Returns the number of u64 words consumed, or -1 when
// the window ran out (caller re-peeks a bigger window and retries).
int64_t pos_matgen_walk(const uint64_t* w, int64_t nwords,
                        int64_t n, int64_t d,
                        uint64_t range, uint64_t zone, uint64_t low,
                        int32_t k, uint64_t top_mask,
                        const uint64_t* p_words,
                        int64_t* rows_out,      // n*d
                        uint64_t* reprs_out) {  // n*d*k
  if (k < 1 || k > 8 || d < 1) return -2;
  int64_t i = 0;
  for (int64_t c = 0; c < n; c++) {
    int64_t* rows = rows_out + c * d;
    int64_t cnt = 0;
    while (cnt < d) {
      if (i >= nwords) return -1;
      uint64_t v = w[i++];
      unsigned __int128 m = (unsigned __int128)v * range;
      if ((uint64_t)m <= zone) {
        int64_t x = (int64_t)(low + (uint64_t)(m >> 64));
        bool dup = false;
        for (int64_t j = 0; j < cnt; j++)
          if (rows[j] == x) { dup = true; break; }
        if (!dup) rows[cnt++] = x;
      }
    }
    for (int64_t a = 1; a < d; a++) {  // insertion sort (d is small)
      int64_t key = rows[a];
      int64_t b = a - 1;
      while (b >= 0 && rows[b] > key) { rows[b + 1] = rows[b]; b--; }
      rows[b + 1] = key;
    }
    uint64_t* reprs = reprs_out + (uint64_t)(c * d) * k;
    int64_t got = 0;
    while (got < d) {
      if (i + k > nwords) return -1;
      uint64_t tmp[8];
      for (int32_t j = 0; j < k; j++) tmp[j] = w[i + j];
      i += k;
      tmp[k - 1] &= top_mask;
      int cmp = 0;
      for (int32_t j = k - 1; j >= 0; j--) {
        if (tmp[j] < p_words[j]) { cmp = -1; break; }
        if (tmp[j] > p_words[j]) { cmp = 1; break; }
      }
      bool nz = false;
      for (int32_t j = 0; j < k; j++)
        if (tmp[j]) { nz = true; break; }
      if (cmp < 0 && nz) {
        uint64_t* outp = reprs + got * k;
        for (int32_t j = 0; j < k; j++) outp[j] = tmp[j];
        got++;
      }
    }
  }
  return i;
}

// Montgomery REDC over M k-limb reprs: value = repr * R^-1 mod p with
// R = 2^(64k), pinv = -p^-1 mod 2^64; emits 16-bit limbs (uint32, L16 per
// value) directly — the framework's canonical host layout — skipping the
// u64 intermediate.  reprs are already < p (matgen's acceptance condition),
// so one final conditional subtract suffices.
void pos_mont_redc_limbs(const uint64_t* reprs, int64_t M, int32_t k,
                         const uint64_t* p_words, uint64_t pinv,
                         int32_t L16, uint32_t* limbs_out) {
  if (k < 1 || k > 8 || L16 < 1 || L16 > 4 * k) return;
#pragma omp parallel for schedule(static) if (M > 16384)
  for (int64_t r = 0; r < M; r++) {
    uint64_t T[17] = {0};
    const uint64_t* a = reprs + r * k;
    for (int32_t j = 0; j < k; j++) T[j] = a[j];
    for (int32_t i = 0; i < k; i++) {
      uint64_t m = T[i] * pinv;
      unsigned __int128 carry = 0;
      for (int32_t j = 0; j < k; j++) {
        unsigned __int128 s =
            (unsigned __int128)m * p_words[j] + T[i + j] + carry;
        T[i + j] = (uint64_t)s;
        carry = s >> 64;
      }
      int32_t t = i + k;
      while (carry) {
        unsigned __int128 s = (unsigned __int128)T[t] + carry;
        T[t] = (uint64_t)s;
        carry = s >> 64;
        t++;
      }
    }
    // result in T[k..2k); subtract p if >= p
    int cmp = 0;
    for (int32_t j = k - 1; j >= 0; j--) {
      if (T[k + j] < p_words[j]) { cmp = -1; break; }
      if (T[k + j] > p_words[j]) { cmp = 1; break; }
    }
    uint64_t v[8];
    if (cmp >= 0) {
      unsigned __int128 borrow = 0;
      for (int32_t j = 0; j < k; j++) {
        unsigned __int128 s = (unsigned __int128)T[k + j] - p_words[j] - borrow;
        v[j] = (uint64_t)s;
        borrow = (s >> 64) ? 1 : 0;
      }
    } else {
      for (int32_t j = 0; j < k; j++) v[j] = T[k + j];
    }
    uint32_t* o = limbs_out + r * L16;
    for (int32_t t = 0; t < L16; t++)
      o[t] = (uint32_t)((v[t >> 2] >> (16 * (t & 3))) & 0xFFFF);
  }
}

}  // extern "C"
