// Native CIDEr-D scorer of the PyTorch port, with a plain C interface
// (loaded with ctypes by boficap_tpu_torch/native/__init__.py; no Python
// or PyTorch header is included).
//
// The RL stage scores a few hundred sampled captions against n-gram
// document frequencies every training step, on the host, between the
// sampler and the update.  The pure-Python scorer (rewards/cider.py)
// costs more than the card's step at the reference's RL batch, so this is
// the port's native hot spot on the host.  The scoring core (n-gram
// hashing, tf-idf vectors, the clipped similarity with its length penalty)
// is the JAX package's native/ciderd.cpp line for line, so the scores are
// the same doubles; only the binding differs (C entry points over flat
// buffers instead of the CPython API).
//
// Captions are space-joined token strings (rewards/self_critical.py
// array_to_str).  N-grams are hashed with a 64-bit FNV-1a over the token
// bytes with separators; collisions at n <= 4, vocab ~10k are negligible
// (and identical between df build and scoring).
//
// C API (every entry returns 0, or an error code for bfc_ciderd_error):
//   bfc_ciderd_set_df(keys, key_off, n, vals, ref_len)
//       install a cached document-frequency table: n keys, key i the
//       space-joined n-gram keys[key_off[i]:key_off[i+1]] (UTF-8), its df
//       vals[i]; ref_len = number of corpus images.
//   bfc_ciderd_clear_df()
//   bfc_ciderd_score(cands, cand_off, n, refs, ref_off, refs_of, out)
//       CIDEr-D of n candidate strings (cands[cand_off[i]:cand_off[i+1]]),
//       candidate i against the reference strings refs_of[i] ..
//       refs_of[i+1]-1 (each refs[ref_off[j]:ref_off[j+1]]); out[n]
//       doubles.  With no installed df, the df is built from the refs of
//       THIS call (df mode 'corpus'), as the Python scorer does.
//   bfc_ciderd_score_ids(cands, N, Lc, cand_width, refs, M, R, Lr,
//                        ref_counts, ref_width, img_idx, out)
//       the same scores straight from int32 id arrays: cands [N, Lc],
//       cand_width [N] (a row's true width before zero padding), refs
//       [M, R, Lr] (each image's reference bank), ref_counts [M],
//       ref_width [M], img_idx [N] (candidate i scores against image
//       img_idx[i]'s references).  Tokens are hashed by their DECIMAL
//       DIGITS with the string path's separator, so hashes (and cached-df
//       lookups) are bit-identical to bfc_ciderd_score on array_to_str
//       output.  A row stops at its first 0 INCLUSIVE (array_to_str's
//       convention); a row without a 0 in its true width takes every
//       token.  Corpus mode builds df per CANDIDATE (each candidate's ref
//       set counts once) with ref_len = N, the string path's alignment.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kN = 4;
constexpr double kSigma = 6.0;

using NgramCounts = std::unordered_map<uint64_t, int>;
using CountsN = std::array<NgramCounts, kN>;

struct Vec {
  std::unordered_map<uint64_t, double> w[kN];
  double norm[kN] = {0, 0, 0, 0};
  int length = 0;
};

struct State {
  std::unordered_map<uint64_t, double> df;
  double log_ref_len = 0.0;
  bool has_df = false;
};

State g_state;

inline uint64_t fnv1a(const char* s, size_t len, uint64_t h) {
  for (size_t i = 0; i < len; ++i) {
    h ^= (unsigned char)s[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// tokenize by spaces; emit (ngram_hash, n_index) counts for n = 1..4
void count_ngrams(const std::string& sent, CountsN& out) {
  std::vector<std::pair<size_t, size_t>> toks;  // (start, len)
  size_t i = 0;
  while (i < sent.size()) {
    while (i < sent.size() && sent[i] == ' ') ++i;
    size_t start = i;
    while (i < sent.size() && sent[i] != ' ') ++i;
    if (i > start) toks.emplace_back(start, i - start);
  }
  const uint64_t seed = 1469598103934665603ULL;
  for (size_t a = 0; a < toks.size(); ++a) {
    uint64_t h = seed;
    for (int n = 0; n < kN && a + n < toks.size(); ++n) {
      h = fnv1a(sent.data() + toks[a + n].first, toks[a + n].second, h);
      h = fnv1a("\x1f", 1, h);  // token separator
      out[n][h] += 1;
    }
  }
}

// hash one int32 token by its decimal digits + the token separator —
// byte-identical to hashing str(int(x)) inside a space-joined sentence
// (count_ngrams tokenizes on spaces, then hashes token bytes + "\x1f")
inline uint64_t hash_token(int32_t v, uint64_t h) {
  char buf[13];  // sign + 10 digits + sep
  int p = 0;
  if (v < 0) {
    buf[p++] = '-';
    // avoid INT_MIN overflow: format via int64
  }
  int64_t a = v < 0 ? -static_cast<int64_t>(v) : v;
  char digits[12];
  int d = 0;
  do {
    digits[d++] = char('0' + (a % 10));
    a /= 10;
  } while (a);
  while (d) buf[p++] = digits[--d];
  h = fnv1a(buf, size_t(p), h);
  return fnv1a("\x1f", 1, h);
}

// token run = row[0:width] truncated at the first 0 INCLUSIVE
// (array_to_str keeps the terminating '0' token)
inline size_t id_run(const int32_t* row, size_t width) {
  for (size_t i = 0; i < width; ++i)
    if (row[i] == 0) return i + 1;
  return width;
}

void count_ngrams_ids(const int32_t* row, size_t width, CountsN& out) {
  const size_t ntok = id_run(row, width);
  const uint64_t seed = 1469598103934665603ULL;
  for (size_t a = 0; a < ntok; ++a) {
    uint64_t h = seed;
    for (int n = 0; n < kN && a + n < ntok; ++n) {
      h = hash_token(row[a + n], h);
      out[n][h] += 1;
    }
  }
}

Vec to_vec(const CountsN& counts, const State& st) {
  Vec v;
  for (int n = 0; n < kN; ++n) {
    for (const auto& kv : counts[n]) {
      auto it = st.df.find(kv.first);
      double df = it == st.df.end() ? 0.0 : it->second;
      double idf = st.log_ref_len - std::log(std::max(1.0, df));
      double w = double(kv.second) * idf;
      v.w[n][kv.first] = w;
      v.norm[n] += w * w;
      if (n == 0) v.length += kv.second;
    }
    v.norm[n] = std::sqrt(v.norm[n]);
  }
  return v;
}

double sim(const Vec& h, const Vec& r) {
  double total = 0.0;
  double delta = double(h.length - r.length);
  double pen = std::exp(-(delta * delta) / (2 * kSigma * kSigma));
  for (int n = 0; n < kN; ++n) {
    double s = 0.0;
    for (const auto& kv : h.w[n]) {
      auto it = r.w[n].find(kv.first);
      if (it != r.w[n].end())
        s += std::min(kv.second, it->second) * it->second;  // D-clipping
    }
    if (h.norm[n] != 0 && r.norm[n] != 0) s /= h.norm[n] * r.norm[n];
    total += s * pen;
  }
  return total / kN;
}

void set_df_table(const char* keys, const int64_t* key_off, int n,
                  const double* vals, double ref_len) {
  g_state.df.clear();
  g_state.has_df = false;
  for (int i = 0; i < n; ++i) {
    std::string k(keys + key_off[i], size_t(key_off[i + 1] - key_off[i]));
    // hash the space-joined ngram the same way count_ngrams does
    CountsN tmp;
    count_ngrams(k, tmp);
    int ntok = 0;
    bool in = false;
    for (char c : k) {
      if (c != ' ' && !in) { ++ntok; in = true; }
      if (c == ' ') in = false;
    }
    if (ntok < 1 || ntok > kN) continue;
    // the level (ntok-1) map holds exactly one entry: the whole ngram
    for (const auto& kv : tmp[ntok - 1]) g_state.df[kv.first] = vals[i];
  }
  g_state.log_ref_len = std::log(std::max(ref_len, 1.0));
  g_state.has_df = true;
}

}  // namespace

extern "C" {

enum {
  BFC_OK = 0,
  BFC_BAD_ARGUMENT = 1,
  BFC_REF_RANGE = 2,
  BFC_CAND_RANGE = 3,
};

const char* bfc_ciderd_error(int code) {
  switch (code) {
    case BFC_OK: return "ok";
    case BFC_BAD_ARGUMENT: return "negative count or null buffer";
    case BFC_REF_RANGE: return "ref_counts/ref_width out of range";
    case BFC_CAND_RANGE: return "cand_width/img_idx out of range";
  }
  return "unknown error";
}

int bfc_ciderd_set_df(const char* keys, const int64_t* key_off, int n,
                      const double* vals, double ref_len) {
  if (n < 0 || (n > 0 && (!keys || !key_off || !vals))) {
    g_state.df.clear();
    g_state.has_df = false;
    return BFC_BAD_ARGUMENT;
  }
  set_df_table(keys, key_off, n, vals, ref_len);
  return BFC_OK;
}

int bfc_ciderd_clear_df() {
  g_state.df.clear();
  g_state.has_df = false;
  return BFC_OK;
}

int bfc_ciderd_score(const char* cands, const int64_t* cand_off, int n,
                     const char* refs, const int64_t* ref_off,
                     const int64_t* refs_of, double* out) {
  if (n < 0) return BFC_BAD_ARGUMENT;
  if (n == 0) return BFC_OK;
  if (!cands || !cand_off || !refs_of || !out) return BFC_BAD_ARGUMENT;

  // pre-count every sentence once
  std::vector<CountsN> cand_counts(n);
  std::vector<std::vector<CountsN>> ref_counts(n);
  for (int i = 0; i < n; ++i) {
    std::string s(cands + cand_off[i], size_t(cand_off[i + 1] - cand_off[i]));
    count_ngrams(s, cand_counts[i]);
    int64_t m = refs_of[i + 1] - refs_of[i];
    if (m < 0) return BFC_BAD_ARGUMENT;
    ref_counts[i].resize(size_t(m));
    for (int64_t j = 0; j < m; ++j) {
      int64_t r = refs_of[i] + j;
      std::string rs(refs + ref_off[r], size_t(ref_off[r + 1] - ref_off[r]));
      count_ngrams(rs, ref_counts[i][size_t(j)]);
    }
  }

  State local;
  const State* st = &g_state;
  if (!g_state.has_df) {
    // corpus mode: df over THIS call's reference sets (document = image;
    // identical ref lists share hashing so duplicates count per image)
    for (int i = 0; i < n; ++i) {
      std::unordered_map<uint64_t, char> seen;
      for (auto& rc : ref_counts[i])
        for (int nn = 0; nn < kN; ++nn)
          for (const auto& kv : rc[nn]) seen[kv.first] = 1;
      for (const auto& kv : seen) local.df[kv.first] += 1.0;
    }
    local.log_ref_len = std::log(std::max(double(n), 1.0));
    st = &local;
  }

  for (int i = 0; i < n; ++i) {
    Vec hv = to_vec(cand_counts[i], *st);
    double s = 0.0;
    size_t m = ref_counts[i].size();
    for (size_t j = 0; j < m; ++j) s += sim(hv, to_vec(ref_counts[i][j], *st));
    if (m) s /= double(m);
    out[i] = s * 10.0;
  }
  return BFC_OK;
}

int bfc_ciderd_score_ids(const int32_t* cands, int N, int Lc,
                         const int32_t* cand_width, const int32_t* refs,
                         int M, int R, int Lr, const int32_t* ref_counts_in,
                         const int32_t* ref_width, const int32_t* img_idx,
                         double* out) {
  if (N < 0 || Lc < 0 || M < 0 || R < 0 || Lr < 0) return BFC_BAD_ARGUMENT;

  // count each image's ref set ONCE (the string path re-counts it per
  // candidate: at train_sample_n = 5 that is 5x the ref hashing work)
  std::vector<std::vector<CountsN>> ref_counts(static_cast<size_t>(M));
  for (int m = 0; m < M; ++m) {
    int cnt = ref_counts_in[m];
    int width = ref_width[m];
    if (cnt < 0 || cnt > R || width < 0 || width > Lr) return BFC_REF_RANGE;
    ref_counts[m].resize(size_t(cnt));
    for (int j = 0; j < cnt; ++j)
      count_ngrams_ids(refs + (int64_t(m) * R + j) * Lr, size_t(width),
                       ref_counts[m][size_t(j)]);
  }
  std::vector<CountsN> cand_counts(static_cast<size_t>(N));
  for (int i = 0; i < N; ++i) {
    int width = cand_width[i];
    int m = img_idx[i];
    if (width < 0 || width > Lc || m < 0 || m >= M) return BFC_CAND_RANGE;
    count_ngrams_ids(cands + int64_t(i) * Lc, size_t(width), cand_counts[i]);
  }

  State local;
  const State* st = &g_state;
  if (!g_state.has_df) {
    // corpus mode, aligned with score(): df increments once per CANDIDATE
    // per unique ngram of that candidate's ref set; ref_len = N.  The
    // per-image unique set is computed once and added idx-count times.
    std::vector<std::unordered_map<uint64_t, char>> uniq(
        static_cast<size_t>(M));
    std::vector<int> uses(static_cast<size_t>(M), 0);
    for (int i = 0; i < N; ++i) ++uses[img_idx[i]];
    for (int m = 0; m < M; ++m) {
      if (!uses[m]) continue;
      for (auto& rcs : ref_counts[m])
        for (int nn = 0; nn < kN; ++nn)
          for (const auto& kv : rcs[nn]) uniq[m][kv.first] = 1;
      for (const auto& kv : uniq[m]) local.df[kv.first] += double(uses[m]);
    }
    local.log_ref_len = std::log(std::max(double(N), 1.0));
    st = &local;
  }

  // ref tf-idf vectors once per image (string path: once per candidate)
  std::vector<std::vector<Vec>> ref_vecs(static_cast<size_t>(M));
  for (int m = 0; m < M; ++m) {
    ref_vecs[m].reserve(ref_counts[m].size());
    for (auto& rcs : ref_counts[m]) ref_vecs[m].push_back(to_vec(rcs, *st));
  }

  for (int i = 0; i < N; ++i) {
    Vec hv = to_vec(cand_counts[i], *st);
    const auto& rv = ref_vecs[img_idx[i]];
    double s = 0.0;
    for (const Vec& r : rv) s += sim(hv, r);
    if (!rv.empty()) s /= double(rv.size());
    out[i] = s * 10.0;
  }
  return BFC_OK;
}

}  // extern "C"
