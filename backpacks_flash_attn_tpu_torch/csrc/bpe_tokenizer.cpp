// Native GPT-2 byte-level BPE encoder: the hot merge loop of
// utils/tokenizer.py:_bpe as a C library (reference counterpart: the HF
// tokenizers Rust fast path the reference gets via AutoTokenizer,
// run_simlex.py:318). The Python side keeps the regex pre-split and the
// byte<->unicode tables; words arrive here as RAW BYTES (vocab and merges
// are converted to raw-byte form by the wrapper, utils/fast_tokenizer.py),
// so symbols are byte strings and no unicode handling happens in C++.
//
// C ABI (ctypes-friendly, no exceptions cross the boundary):
//   bptok_new(tok_blob, tok_offsets, tok_ids, n_tokens,
//             merge_blob, merge_offsets, n_merges) -> handle
//   bptok_encode(handle, words_blob, word_offsets, n_words,
//                out_ids, max_out) -> n_ids (>=0) | -1 overflow | -2 unknown
//   bptok_cache_size(handle) -> entries in the word cache
//   bptok_free(handle)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    size_t a = h(p.first);
    return a ^ (h(p.second) + 0x9e3779b97f4a7c15ull + (a << 6) + (a >> 2));
  }
};

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      ranks;
  std::unordered_map<std::string, std::vector<int32_t>> cache;

  // Greedy lowest-rank pair merging over byte symbols — semantics identical
  // to utils/tokenizer.py:_bpe (merge ALL occurrences of the best pair per
  // round, left to right). Returns false on a vocab miss.
  bool encode_word(const std::string& w, std::vector<int32_t>* out) {
    auto hit = cache.find(w);
    if (hit != cache.end()) {
      out->insert(out->end(), hit->second.begin(), hit->second.end());
      return true;
    }
    std::vector<std::string> word;
    word.reserve(w.size());
    for (char c : w) word.emplace_back(1, c);

    const int32_t kNoRank = INT32_MAX;
    while (word.size() > 1) {
      int32_t best_rank = kNoRank;
      size_t best_i = 0;
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        auto it = ranks.find({word[i], word[i + 1]});
        if (it != ranks.end() && it->second < best_rank) {
          best_rank = it->second;
          best_i = i;
        }
      }
      if (best_rank == kNoRank) break;
      const std::string first = word[best_i];
      const std::string second = word[best_i + 1];
      std::vector<std::string> merged;
      merged.reserve(word.size());
      for (size_t i = 0; i < word.size();) {
        if (i + 1 < word.size() && word[i] == first &&
            word[i + 1] == second) {
          merged.push_back(first + second);
          i += 2;
        } else {
          merged.push_back(word[i]);
          i += 1;
        }
      }
      word.swap(merged);
    }

    std::vector<int32_t> ids;
    ids.reserve(word.size());
    for (const auto& sym : word) {
      auto it = vocab.find(sym);
      if (it == vocab.end()) return false;
      ids.push_back(it->second);
    }
    out->insert(out->end(), ids.begin(), ids.end());
    cache.emplace(w, std::move(ids));
    return true;
  }
};

std::string slice(const char* blob, const int32_t* offsets, int32_t i) {
  return std::string(blob + offsets[i], blob + offsets[i + 1]);
}

}  // namespace

extern "C" {

void* bptok_new(const char* tok_blob, const int32_t* tok_offsets,
                const int32_t* tok_ids, int32_t n_tokens,
                const char* merge_blob, const int32_t* merge_offsets,
                int32_t n_merges) {
  auto* t = new (std::nothrow) Tokenizer();
  if (!t) return nullptr;
  t->vocab.reserve(n_tokens);
  for (int32_t i = 0; i < n_tokens; ++i)
    t->vocab.emplace(slice(tok_blob, tok_offsets, i), tok_ids[i]);
  t->ranks.reserve(n_merges);
  for (int32_t i = 0; i < n_merges; ++i)
    t->ranks.emplace(std::make_pair(slice(merge_blob, merge_offsets, 2 * i),
                                    slice(merge_blob, merge_offsets,
                                          2 * i + 1)),
                     i);
  return t;
}

void bptok_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

int32_t bptok_encode(void* handle, const char* words_blob,
                     const int32_t* word_offsets, int32_t n_words,
                     int32_t* out_ids, int32_t max_out) {
  auto* t = static_cast<Tokenizer*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(word_offsets[n_words] - word_offsets[0]);
  for (int32_t i = 0; i < n_words; ++i) {
    if (!t->encode_word(slice(words_blob, word_offsets, i), &ids)) return -2;
  }
  if (static_cast<int32_t>(ids.size()) > max_out) return -1;
  std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

int32_t bptok_cache_size(void* handle) {
  return static_cast<int32_t>(
      static_cast<Tokenizer*>(handle)->cache.size());
}

}  // extern "C"
