// Native host ops for vln_magic_tpu_torch.
//
// Host-side counterparts of the reference's C++/CUDA/Cython extensions
// (reference: map_nav_src/fairseq/clib/libbleu/libbleu.cpp — BLEU n-gram
// counting; clib/libnat/edit_dist.cpp + clib/libnat_cuda/edit_dist.cu —
// (batched) Levenshtein distance; data/data_utils_fast.pyx batch_by_size —
// token-bucketed batching), the same source as vln_magic_tpu/native/.
// They run on the host beside the GPU, over a C ABI for ctypes
// (native/__init__.py builds this file with g++ at first use).  Fresh
// implementations of the textbook algorithms — nothing is ported.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// BLEU n-gram counting: accumulate match/total counts for orders 1..4 into
// counts[8] = {match1, total1, ..., match4, total4}.  Clipped matching
// against reference n-gram multiplicities (standard corpus BLEU).
// ---------------------------------------------------------------------------

static inline uint64_t hash_ngram(const int32_t* toks, int start, int n) {
  uint64_t h = 1469598103934665603ull;  // FNV-1a
  for (int i = 0; i < n; ++i) {
    h ^= static_cast<uint64_t>(static_cast<uint32_t>(toks[start + i]));
    h *= 1099511628211ull;
  }
  return h;
}

void bleu_count(const int32_t* hyp, int hyp_len, const int32_t* ref,
                int ref_len, int64_t* counts) {
  for (int n = 1; n <= 4; ++n) {
    std::unordered_map<uint64_t, int> ref_ngrams;
    for (int i = 0; i + n <= ref_len; ++i) ref_ngrams[hash_ngram(ref, i, n)]++;
    int64_t match = 0;
    int64_t total = std::max(hyp_len - n + 1, 0);
    std::unordered_map<uint64_t, int> used;
    for (int i = 0; i + n <= hyp_len; ++i) {
      uint64_t h = hash_ngram(hyp, i, n);
      auto it = ref_ngrams.find(h);
      if (it != ref_ngrams.end() && used[h] < it->second) {
        used[h]++;
        match++;
      }
    }
    counts[2 * (n - 1)] += match;
    counts[2 * (n - 1) + 1] += total;
  }
}

// ---------------------------------------------------------------------------
// Batched Levenshtein distance over padded int sequences.
// a: [bsz, max_a], b: [bsz, max_b]; out: [bsz].
// ---------------------------------------------------------------------------

void edit_distance_batch(const int32_t* a, const int32_t* a_lens,
                         const int32_t* b, const int32_t* b_lens, int bsz,
                         int max_a, int max_b, int32_t* out) {
  std::vector<int32_t> prev(max_b + 1), cur(max_b + 1);
  for (int s = 0; s < bsz; ++s) {
    const int32_t* ra = a + static_cast<int64_t>(s) * max_a;
    const int32_t* rb = b + static_cast<int64_t>(s) * max_b;
    const int la = a_lens[s], lb = b_lens[s];
    for (int j = 0; j <= lb; ++j) prev[j] = j;
    for (int i = 1; i <= la; ++i) {
      cur[0] = i;
      for (int j = 1; j <= lb; ++j) {
        const int sub = prev[j - 1] + (ra[i - 1] != rb[j - 1] ? 1 : 0);
        cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
      }
      std::swap(prev, cur);
    }
    out[s] = prev[lb];
  }
}

// ---------------------------------------------------------------------------
// Levenshtein alignment ops ("suggested edits" in the libnat sense): fill
// out[i] with 0=keep, 1=substitute, 2=insert-into-a, 3=delete-from-a along
// the optimal path, written against sequence b's positions.
// Returns the edit distance.
// ---------------------------------------------------------------------------

int32_t edit_ops(const int32_t* a, int la, const int32_t* b, int lb,
                 int32_t* ops, int max_ops) {
  std::vector<std::vector<int32_t>> d(la + 1, std::vector<int32_t>(lb + 1));
  for (int i = 0; i <= la; ++i) d[i][0] = i;
  for (int j = 0; j <= lb; ++j) d[0][j] = j;
  for (int i = 1; i <= la; ++i)
    for (int j = 1; j <= lb; ++j)
      d[i][j] = std::min({d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + (a[i - 1] != b[j - 1] ? 1 : 0)});
  // backtrace
  std::vector<int32_t> rev;
  int i = la, j = lb;
  while (i > 0 || j > 0) {
    if (i > 0 && j > 0 &&
        d[i][j] == d[i - 1][j - 1] + (a[i - 1] != b[j - 1] ? 1 : 0)) {
      rev.push_back(a[i - 1] == b[j - 1] ? 0 : 1);
      --i; --j;
    } else if (j > 0 && d[i][j] == d[i][j - 1] + 1) {
      rev.push_back(2);  // insert b[j-1] into a
      --j;
    } else {
      rev.push_back(3);  // delete a[i-1]
      --i;
    }
  }
  const int n = std::min<int>(rev.size(), max_ops);
  for (int k = 0; k < n; ++k) ops[k] = rev[rev.size() - 1 - k];
  return d[la][lb];
}

// ---------------------------------------------------------------------------
// Token-bucketed batching: group indices (assumed sorted by length by the
// caller or not) into batches capped by max_tokens (batch_len * size) and
// max_sentences.  out_batch_ids[i] = batch index of sample i.
// Returns the number of batches.
// ---------------------------------------------------------------------------

int32_t batch_by_size(const int32_t* lengths, int n, int max_tokens,
                      int max_sentences, int32_t* out_batch_ids) {
  int32_t batch = 0;
  int count = 0;
  int max_len = 0;
  for (int i = 0; i < n; ++i) {
    const int cand_max = std::max(max_len, lengths[i]);
    const bool overflow =
        count > 0 && ((max_sentences > 0 && count + 1 > max_sentences) ||
                      (max_tokens > 0 && cand_max * (count + 1) > max_tokens));
    if (overflow) {
      ++batch;
      count = 0;
      max_len = 0;
    }
    out_batch_ids[i] = batch;
    ++count;
    max_len = std::max(max_len, lengths[i]);
  }
  return batch + 1;
}

}  // extern "C"
