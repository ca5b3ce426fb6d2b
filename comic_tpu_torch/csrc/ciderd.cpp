// Native CIDEr-D scorer for SCST rewards (the port's own copy of
// comic_tpu's native/ciderd.cpp; built with g++ at first use by
// comic_tpu_torch/evaluation/cider_native.py, bound through ctypes).
//
// The SCST reward loop scores (beam+1) x batch hypotheses against ~5
// references per image on the host every training step (the reference's
// common/scst/cider_ruotianluo/, invoked from train_fn.py:243-248). The
// n-gram counting and tf-idf similarity run here in C++. Scores match the
// pure-Python comic_tpu_torch.evaluation.cider.CiderD bit for bit in
// double precision.
//
// Algorithm (CIDEr-D, Vedantam et al. CVPR 2015):
//   g_n[w]  = count(w) * (log N - log max(df_w, 1))        n = 1..4
//   sim_n   = sum_w min(g_h[w], g_r[w]) * g_r[w] / (|g_h| |g_r|)
//             * exp(-(len_h - len_r)^2 / (2 * 6^2))
//   score   = 10 * mean_n mean_refs sim_n
//
// Document frequencies come either from a preloaded table (the scst-words
// IDF cache) or from the references passed with each call (corpus mode).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxN = 4;
constexpr double kSigma = 6.0;

// FNV-1a 64-bit over the ngram's words joined by '\x1f'.
inline uint64_t fnv1a(const char* data, size_t len, uint64_t h = 1469598103934665603ULL) {
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

struct NgramCounts {
  // per n: hash -> count
  std::unordered_map<uint64_t, double> counts[kMaxN];
  int length = 0;
};

void split_words(const std::string& s, std::vector<std::string>* out) {
  out->clear();
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && s[i] == ' ') ++i;
    size_t j = i;
    while (j < s.size() && s[j] != ' ') ++j;
    if (j > i) out->push_back(s.substr(i, j - i));
    i = j;
  }
}

void count_ngrams(const std::string& sent, NgramCounts* nc) {
  std::vector<std::string> words;
  split_words(sent, &words);
  nc->length = static_cast<int>(words.size());
  for (int n = 1; n <= kMaxN; ++n) {
    auto& m = nc->counts[n - 1];
    for (int i = 0; i + n <= static_cast<int>(words.size()); ++i) {
      uint64_t h = 1469598103934665603ULL;
      for (int k = 0; k < n; ++k) {
        h = fnv1a(words[i + k].data(), words[i + k].size(), h);
        h = fnv1a("\x1f", 1, h);
      }
      m[h] += 1.0;
    }
  }
}

struct Vec {
  std::unordered_map<uint64_t, double> v[kMaxN];
  double norm[kMaxN] = {0, 0, 0, 0};
  int length = 0;
};

struct CiderD {
  std::unordered_map<uint64_t, double> df;
  double log_n = 0.0;
  bool has_df = false;

  void tfidf(const NgramCounts& nc, double log_ref, Vec* out) const {
    out->length = nc.length;
    for (int n = 0; n < kMaxN; ++n) {
      double norm2 = 0.0;
      for (const auto& kv : nc.counts[n]) {
        auto it = df.find(kv.first);
        double d = (it == df.end()) ? 0.0 : it->second;
        double idf = log_ref - std::log(std::max(d, 1.0));
        double val = kv.second * idf;
        out->v[n][kv.first] = val;
        norm2 += val * val;
      }
      out->norm[n] = std::sqrt(norm2);
    }
  }

  double sim(const Vec& h, const Vec& r) const {
    // The reference's Gaussian-penalty "length" is the BIGRAM token count
    // (ciderD_scorer.py:151-152: `if n == 1: length += term_freq`), i.e.
    // max(words - 1, 0) — differs from word count only for < 2-word
    // sentences, which SCST rollouts can produce. Match it exactly.
    double hl = h.length > 0 ? h.length - 1 : 0;
    double rl = r.length > 0 ? r.length - 1 : 0;
    double delta = hl - rl;
    double penalty = std::exp(-(delta * delta) / (2.0 * kSigma * kSigma));
    double acc = 0.0;
    for (int n = 0; n < kMaxN; ++n) {
      if (h.norm[n] == 0.0 || r.norm[n] == 0.0) continue;
      double dot = 0.0;
      for (const auto& kv : h.v[n]) {
        auto it = r.v[n].find(kv.first);
        if (it == r.v[n].end()) continue;
        dot += std::min(kv.second, it->second) * it->second;
      }
      acc += dot / (h.norm[n] * r.norm[n]) * penalty;
    }
    return acc / kMaxN;
  }
};

// split a blob on `sep` into strings
void split_blob(const char* blob, char sep, std::vector<std::string>* out) {
  out->clear();
  const char* p = blob;
  const char* start = p;
  for (;; ++p) {
    if (*p == sep || *p == '\0') {
      out->emplace_back(start, p - start);
      if (*p == '\0') break;
      start = p + 1;
    }
  }
}

}  // namespace

extern "C" {

void* ciderd_create() { return new CiderD(); }

void ciderd_destroy(void* handle) { delete static_cast<CiderD*>(handle); }

// Load the IDF cache: `ngrams_blob` is '\n'-separated ngrams, each ngram's
// words separated by '\x1f'; vals[i] is its document frequency.
void ciderd_set_df(void* handle, const char* ngrams_blob, const double* vals,
                   long count, double ref_len) {
  auto* c = static_cast<CiderD*>(handle);
  c->df.clear();
  std::vector<std::string> grams;
  split_blob(ngrams_blob, '\n', &grams);
  for (long i = 0; i < count && i < static_cast<long>(grams.size()); ++i) {
    uint64_t h = fnv1a(grams[i].data(), grams[i].size());
    // re-hash with the trailing separator to match count_ngrams framing
    h = fnv1a("\x1f", 1, h);
    c->df[h] = vals[i];
  }
  c->log_n = ref_len;
  c->has_df = true;
}

// Score hypotheses against grouped references.
//   hypos_blob: n_hypos sentences separated by '\n'
//   refs_blob:  n_hypos GROUPS separated by '\x1e'; refs within a group
//               separated by '\n'
// Without a preloaded IDF table, document frequencies are computed from
// the UNIQUE reference groups in this call (corpus mode; N = number of
// distinct groups, matching the Python scorer's joint gts dict).
//   group_ids: length n_hypos; hypotheses sharing a group id share refs
//              and the group counts once toward N.
void ciderd_score(void* handle, const char* hypos_blob, const char* refs_blob,
                  const long* group_ids, long n_hypos, double* out_scores) {
  auto* c = static_cast<CiderD*>(handle);
  std::vector<std::string> hypos, groups;
  split_blob(hypos_blob, '\n', &hypos);
  split_blob(refs_blob, '\x1e', &groups);

  // Parse reference groups (unique by group id).
  std::unordered_map<long, std::vector<NgramCounts>> ref_counts;
  std::unordered_map<long, size_t> group_index;
  for (long i = 0; i < n_hypos; ++i) {
    long g = group_ids[i];
    if (ref_counts.count(g)) continue;
    group_index[g] = static_cast<size_t>(i);
    std::vector<std::string> refs;
    split_blob(groups[i].c_str(), '\n', &refs);
    auto& v = ref_counts[g];
    v.resize(refs.size());
    for (size_t r = 0; r < refs.size(); ++r) count_ngrams(refs[r], &v[r]);
  }

  double log_ref = c->log_n;
  const std::unordered_map<uint64_t, double>* df_ptr = &c->df;
  std::unordered_map<uint64_t, double> corpus_df;
  if (!c->has_df) {
    // corpus mode: every hypothesis's reference set counts as its own
    // document, even when groups repeat (the SCST joint gts dict repeats
    // each image's refs per hypothesis — scorers.py:72-78 semantics)
    for (long i = 0; i < n_hypos; ++i) {
      const auto& group = ref_counts[group_ids[i]];
      std::unordered_map<uint64_t, bool> seen;
      for (const auto& nc : group)
        for (int n = 0; n < kMaxN; ++n)
          for (const auto& g : nc.counts[n]) seen[g.first] = true;
      for (const auto& s : seen) corpus_df[s.first] += 1.0;
    }
    log_ref = std::log(std::max<double>(n_hypos, 1));
    df_ptr = &corpus_df;
  }

  CiderD scorer;
  scorer.df = *df_ptr;  // copy; tables are small relative to call rate
  scorer.log_n = log_ref;

  // Precompute reference tf-idf vectors per group.
  std::unordered_map<long, std::vector<Vec>> ref_vecs;
  for (const auto& kv : ref_counts) {
    auto& vecs = ref_vecs[kv.first];
    vecs.resize(kv.second.size());
    for (size_t r = 0; r < kv.second.size(); ++r)
      scorer.tfidf(kv.second[r], log_ref, &vecs[r]);
  }

  for (long i = 0; i < n_hypos; ++i) {
    NgramCounts hc;
    count_ngrams(hypos[i], &hc);
    Vec hv;
    scorer.tfidf(hc, log_ref, &hv);
    const auto& vecs = ref_vecs[group_ids[i]];
    double acc = 0.0;
    for (const auto& rv : vecs) acc += scorer.sim(hv, rv);
    out_scores[i] = vecs.empty() ? 0.0 : 10.0 * acc / vecs.size();
  }
}

}  // extern "C"
