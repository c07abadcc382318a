// Host-side serving hot path in C++: batch tokenization + rerank-pair
// shaping for the offline SimpleTokenizer.
//
// Why native: every serving batch tokenizes ~B*top_k (query, chunk) pairs
// on the host before the rerank dispatch (models/reranker.py:116), and this
// environment gives the host ONE CPU core — the Python regex+hashlib loop
// sits directly on the serving critical path (bench.py's honest loop).
// The reference delegates the same work to the Rust `tokenizers` wheel
// (SURVEY.md §0 "Tokenization" row); this is the first-party equivalent
// for the dependency-free fallback tokenizer.
//
// Parity contract (tests/unit/test_native_hostkit.py): for any text whose
// codepoints fit the BMP this produces byte-identical output to the
// pure-Python SimpleTokenizer — the BLAKE2b-derived stable hash ids
// (RFC 7693, digest_length=8, little-endian), the regex word/punct split,
// str.lower() casing, and the pair budget split. Unicode semantics come
// from tables generated by Python itself (hostkit.py::_unicode_tables →
// tt_set_tables), so parity holds by construction; only astral-plane
// chars, the context-sensitive U+03A3, and embedded NULs take the Python
// path.
//
// Build: g++ -O2 -shared -fPIC (native/build.py); loaded via ctypes
// (native/hostkit.py). No external dependencies.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// BLAKE2b (RFC 7693), fixed: no key, digest_length configurable (we use 8
// to match hashlib.blake2b(..., digest_size=8)).
// ---------------------------------------------------------------------------

namespace {

static const uint64_t BLAKE2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t BLAKE2B_SIGMA[12][16] = {
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

static inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

struct Blake2bState {
  uint64_t h[8];
  uint64_t t0;
  uint8_t buf[128];
  size_t buflen;
};

static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts only (x86-64 / aarch64-le)
  return v;
}

static void blake2b_compress(Blake2bState* S, const uint8_t* block,
                             uint64_t f0) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; ++i) m[i] = load64(block + i * 8);
  for (int i = 0; i < 8; ++i) v[i] = S->h[i];
  for (int i = 0; i < 8; ++i) v[i + 8] = BLAKE2B_IV[i];
  v[12] ^= S->t0;  // t1 stays 0: inputs far below 2^64 bytes
  v[14] ^= f0;
#define G(r, i, a, b, c, d)                      \
  do {                                           \
    a = a + b + m[BLAKE2B_SIGMA[r][2 * i]];      \
    d = rotr64(d ^ a, 32);                       \
    c = c + d;                                   \
    b = rotr64(b ^ c, 24);                       \
    a = a + b + m[BLAKE2B_SIGMA[r][2 * i + 1]];  \
    d = rotr64(d ^ a, 16);                       \
    c = c + d;                                   \
    b = rotr64(b ^ c, 63);                       \
  } while (0)
  for (int r = 0; r < 12; ++r) {
    G(r, 0, v[0], v[4], v[8], v[12]);
    G(r, 1, v[1], v[5], v[9], v[13]);
    G(r, 2, v[2], v[6], v[10], v[14]);
    G(r, 3, v[3], v[7], v[11], v[15]);
    G(r, 4, v[0], v[5], v[10], v[15]);
    G(r, 5, v[1], v[6], v[11], v[12]);
    G(r, 6, v[2], v[7], v[8], v[13]);
    G(r, 7, v[3], v[4], v[9], v[14]);
  }
#undef G
  for (int i = 0; i < 8; ++i) S->h[i] ^= v[i] ^ v[i + 8];
}

// 8-byte BLAKE2b digest of `len` bytes at `data`, as a little-endian u64
// (== int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
// "little")).
static uint64_t blake2b8_u64(const uint8_t* data, size_t len) {
  Blake2bState S;
  for (int i = 0; i < 8; ++i) S.h[i] = BLAKE2B_IV[i];
  S.h[0] ^= 0x01010000ULL ^ 8ULL;  // depth=1, fanout=1, digest_length=8
  S.t0 = 0;
  S.buflen = 0;
  // full blocks (keep the last block for the final call, even when exact)
  while (len > 128) {
    S.t0 += 128;
    blake2b_compress(&S, data, 0);
    data += 128;
    len -= 128;
  }
  uint8_t last[128];
  std::memset(last, 0, sizeof last);
  std::memcpy(last, data, len);
  S.t0 += len;
  blake2b_compress(&S, last, ~0ULL);
  return S.h[0];  // first 8 bytes of the digest, already little-endian
}

// ---------------------------------------------------------------------------
// Unicode (BMP) tokenizer: replicates SimpleTokenizer's  \w+|[^\w\s]  regex
// and str.lower() hashing for any text whose codepoints fit the Basic
// Multilingual Plane. Parity is BY CONSTRUCTION: the per-codepoint
// word/space classification and the 1-2-codepoint lowercase mapping are
// generated in Python from the host's own `re` module and str.lower()
// (hostkit.py::_unicode_tables) and installed via tt_set_tables — this
// file encodes no Unicode knowledge of its own. Characters the tables
// cannot express exactly (astral plane, and U+03A3 whose lowercase is
// context-sensitive: Final_Sigma) are class FALLBACK and bounce the whole
// call back to Python.
// ---------------------------------------------------------------------------

enum : uint8_t { CLS_OTHER = 0, CLS_WORD = 1, CLS_SPACE = 2, CLS_FALLBACK = 3 };

static uint8_t g_cls[0x10000];
static uint16_t g_lo1[0x10000];
static uint16_t g_lo2[0x10000];
static bool g_tables_set = false;

// Decode one UTF-8 scalar; advances *s. Returns the codepoint, or -1 for
// anything the BMP tables cannot answer (4-byte sequences / malformed
// input — the Python caller encoded valid UTF-8, so malformed means a
// >BMP char).
static inline int32_t u8_next(const uint8_t** s) {
  uint8_t c = **s;
  if (c < 0x80) {
    *s += 1;
    return c;
  }
  if ((c >> 5) == 0x6) {
    int32_t cp = ((c & 0x1F) << 6) | ((*s)[1] & 0x3F);
    *s += 2;
    return cp;
  }
  if ((c >> 4) == 0xE) {
    int32_t cp = ((c & 0x0F) << 12) | (((*s)[1] & 0x3F) << 6) | ((*s)[2] & 0x3F);
    *s += 3;
    return cp;
  }
  return -1;  // 4-byte lead (astral) or malformed
}

static inline void u8_append(std::string* out, uint32_t cp) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

static inline void append_lower(std::string* out, int32_t cp) {
  u8_append(out, g_lo1[cp]);
  if (g_lo2[cp]) u8_append(out, g_lo2[cp]);
}

struct TokenizerParams {
  int64_t vocab_size;
  int32_t pad_id, cls_id, sep_id, n_special;
};

struct Tok {
  int32_t start, end;  // [start, end) in CHARACTER (codepoint) offsets
  int32_t id;
};

// Tokenize into hash ids + char offsets; stops after max_tokens tokens
// when max_tokens >= 0 (every batch consumer slices to a budget
// < max_length, so later tokens are never observable). Mirrors _token_id:
// blake2b8(utf8(lower(token))) % (vocab - n_special) + n_special.
// Returns false when the text needs the Python path (astral char,
// context-sensitive casing).
static bool encode_tokens(const char* text, const TokenizerParams& P,
                          int64_t max_tokens, std::vector<Tok>* out) {
  const uint8_t* s = reinterpret_cast<const uint8_t*>(text);
  uint64_t span = static_cast<uint64_t>(P.vocab_size - P.n_special);
  int32_t ci = 0;  // character index
  std::string low;
  while (*s && (max_tokens < 0 ||
                static_cast<int64_t>(out->size()) < max_tokens)) {
    int32_t cp = u8_next(&s);
    if (cp < 0) return false;
    uint8_t cls = g_cls[cp];
    if (cls == CLS_FALLBACK) return false;
    if (cls == CLS_SPACE) {
      ++ci;
      continue;
    }
    int32_t start = ci;
    low.clear();
    append_lower(&low, cp);
    ++ci;
    if (cls == CLS_WORD) {
      while (*s) {
        const uint8_t* save = s;
        int32_t cp2 = u8_next(&s);
        if (cp2 < 0) return false;
        if (g_cls[cp2] == CLS_FALLBACK) return false;
        if (g_cls[cp2] != CLS_WORD) {
          s = save;
          break;
        }
        append_lower(&low, cp2);
        ++ci;
      }
    }
    uint64_t h = blake2b8_u64(
        reinterpret_cast<const uint8_t*>(low.data()), low.size());
    out->push_back(Tok{start, ci,
                       static_cast<int32_t>(P.n_special + (h % span))});
  }
  return true;
}

using TokenCache = std::unordered_map<std::string, std::vector<Tok>>;

// Returns nullptr when the text needs the Python path.
static const std::vector<Tok>* cached_encode(const char* text,
                                             const TokenizerParams& P,
                                             int64_t max_tokens,
                                             TokenCache* cache) {
  auto it = cache->find(text);
  if (it != cache->end()) return &it->second;
  std::vector<Tok> toks;
  if (!encode_tokens(text, P, max_tokens, &toks)) return nullptr;
  return &cache->emplace(text, std::move(toks)).first->second;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Install the Python-generated BMP tables (see hostkit.py::_unicode_tables):
// cls[65536] word/space/other/fallback classes, lo1/lo2[65536] the 1-2
// codepoint lowercase expansion. Must be called once after load; every
// tokenize entry point returns the fallback code until then.
void tt_set_tables(const uint8_t* cls, const uint16_t* lo1,
                   const uint16_t* lo2) {
  std::memcpy(g_cls, cls, sizeof g_cls);
  std::memcpy(g_lo1, lo1, sizeof g_lo1);
  std::memcpy(g_lo2, lo2, sizeof g_lo2);
  g_tables_set = true;
}

// Parity probe for tests: hash one token string the way _token_id does
// (ASCII lowering only — callers lowercase non-ASCII before the call).
int64_t tt_token_id(const char* token, int64_t vocab_size, int32_t n_special) {
  size_t len = std::strlen(token);
  std::string low(token, len);
  for (auto& ch : low)
    if (ch >= 'A' && ch <= 'Z') ch += 32;
  uint64_t h = blake2b8_u64(reinterpret_cast<const uint8_t*>(low.data()), len);
  return n_special +
         static_cast<int64_t>(h % static_cast<uint64_t>(vocab_size - n_special));
}

// Tokenize text into ids + [start, end) CHARACTER offsets — the
// hierarchical chunker's hot call (index/chunker.py cuts chunk text at
// token boundaries; one Python hashlib call per token made this the
// build-path bottleneck on a single host core). Caller allocates
// out_ids/out_starts/out_ends with capacity `cap` (character count is a
// safe upper bound: every token consumes >= 1 char). Returns the token
// count, -1 when the text needs the Python tokenizer (tables unset,
// astral-plane char, context-sensitive casing), or -2 if cap was too
// small.
int64_t tt_encode_offsets(const char* text, int64_t vocab_size,
                          int32_t n_special, int32_t* out_ids,
                          int32_t* out_starts, int32_t* out_ends,
                          int64_t cap) {
  if (!g_tables_set) return -1;
  TokenizerParams P{vocab_size, 0, 0, 0, n_special};
  std::vector<Tok> toks;
  if (!encode_tokens(text, P, -1, &toks)) return -1;
  if (static_cast<int64_t>(toks.size()) > cap) return -2;
  for (size_t i = 0; i < toks.size(); ++i) {
    out_ids[i] = toks[i].id;
    out_starts[i] = toks[i].start;
    out_ends[i] = toks[i].end;
  }
  return static_cast<int64_t>(toks.size());
}

// Batch-encode `n` texts (optionally as (text, pair) cross-encoder inputs)
// into caller-allocated (n, max_length) int32 arrays. Replicates
// tokenizer.py::_batch_encode exactly for ASCII inputs:
//   single: <s> a[:L-2] </s>
//   pair:   <s> a[:a_budget] </s></s> b[:L-4-a_budget] </s>
//           a_budget = min(len(a), max(1, (L-4)//2))
// out_ids must be pre-filled with pad_id and out_mask with 0 by the caller
// (numpy does both in one vectorized op).
// Returns 0 on success, -1 when any input needs the Python tokenizer
// (tables unset, astral-plane char, context-sensitive casing) — the
// caller then discards the partially-written arrays and falls back.
int tt_encode_batch(const char** texts, const char** pairs, int32_t n,
                    int32_t max_length, int64_t vocab_size, int32_t pad_id,
                    int32_t cls_id, int32_t sep_id, int32_t n_special,
                    int32_t* out_ids, int32_t* out_mask) {
  (void)pad_id;  // caller pre-fills; kept in the ABI for self-description
  if (!g_tables_set) return -1;
  TokenizerParams P{vocab_size, pad_id, cls_id, sep_id, n_special};
  TokenCache cache;
  cache.reserve(static_cast<size_t>(n) * 2);
  for (int i = 0; i < n; ++i) {
    int32_t* row = out_ids + static_cast<int64_t>(i) * max_length;
    int32_t* mrow = out_mask + static_cast<int64_t>(i) * max_length;
    const std::vector<Tok>* ap =
        cached_encode(texts[i], P, max_length, &cache);
    if (ap == nullptr) return -1;
    const std::vector<Tok>& a = *ap;
    // Python builds the full seq then truncates with seq[:max_length]
    // (tokenizer.py::_batch_encode). emit() reproduces that truncation at
    // write time, so rows narrower than the special-token skeleton (tiny
    // max_length) never write past the row. py_take() reproduces Python's
    // a[:stop] for negative stop (stop+len, floored at 0).
    int pos = 0;
    auto emit = [&](int32_t v) {
      if (pos < max_length) {
        row[pos] = v;
        mrow[pos] = 1;
        ++pos;
      }
    };
    auto py_take = [](int len, int stop) {
      if (stop < 0) stop += len;
      if (stop < 0) stop = 0;
      return stop < len ? stop : len;
    };
    emit(cls_id);
    if (pairs == nullptr) {
      int take = py_take(static_cast<int>(a.size()), max_length - 2);
      for (int j = 0; j < take; ++j) emit(a[j].id);
      emit(sep_id);
    } else {
      const std::vector<Tok>* bp =
          cached_encode(pairs[i], P, max_length, &cache);
      if (bp == nullptr) return -1;
      const std::vector<Tok>& b = *bp;
      // (max_length-4)/2: C trunc-division differs from Python floor for
      // negative operands, but both land below 1 there and max(1, ·)
      // clamps, so the budgets agree for every max_length.
      int half = (max_length - 4) / 2;
      if (half < 1) half = 1;
      int a_budget = static_cast<int>(a.size()) < half
                         ? static_cast<int>(a.size())
                         : half;
      int b_take = py_take(static_cast<int>(b.size()),
                           max_length - 4 - a_budget);
      for (int j = 0; j < a_budget; ++j) emit(a[j].id);
      emit(sep_id);
      emit(sep_id);
      for (int j = 0; j < b_take; ++j) emit(b[j].id);
      emit(sep_id);
    }
  }
  return 0;
}

}  // extern "C"
