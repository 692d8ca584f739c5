// Batch WordPiece encoder: the C++ hot path of the host tokenization
// pipeline (fedcola_tpu_torch/data/tokenizer.py is the reference implementation
// and fallback).
//
// The reference tokenizes every caption/abstract with HF BertTokenizer in
// Python inside DataLoader workers; here whole datasets are encoded once at
// load time, so a multi-threaded native encoder removes the dominant host
// cost (50k COCO captions).  ASCII-only strings take this path; anything
// with non-ASCII bytes falls back to the Python implementation so Unicode
// normalisation semantics stay exact.
//
// Exposed C ABI (loaded via ctypes, no pybind11 dependency):
//   wp_build(vocab_blob, vocab_len)            -> handle
//   wp_free(handle)
//   wp_encode_batch(handle, texts, offsets, n, max_len,
//                   cls, sep, pad, unk, out, n_threads)

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> map;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// 0x7F (DEL) passes str.isascii() on the Python side but is a Unicode
// control char there — treat it as control here too so both paths drop it.
inline bool is_control(unsigned char c) {
  return (c < 32 || c == 127) && !is_space(c);
}

// Greedy longest-match-first WordPiece over one lower-cased word.
void wordpiece(const Vocab& v, const std::string& word, int32_t unk,
               std::vector<int32_t>& out) {
  if (word.size() > 100) {
    out.push_back(unk);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  std::string sub;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      sub.assign(start > 0 ? "##" : "", start > 0 ? 2 : 0);
      sub.append(word, start, end - start);
      auto it = v.map.find(sub);
      if (it != v.map.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out.push_back(unk);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

void encode_one(const Vocab& v, const char* text, int64_t len,
                int32_t max_len, int32_t cls, int32_t sep, int32_t pad,
                int32_t unk, int32_t* out) {
  std::vector<int32_t> ids;
  ids.reserve(max_len);
  std::string word;
  auto flush_word = [&]() {
    if (!word.empty()) {
      wordpiece(v, word, unk, ids);
      word.clear();
    }
  };
  for (int64_t i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c == 0 || is_control(c)) continue;
    if (is_space(c)) {
      flush_word();
    } else if (is_ascii_punct(c)) {
      flush_word();
      word.push_back(static_cast<char>(c));
      flush_word();
    } else {
      if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
      word.push_back(static_cast<char>(c));
    }
  }
  flush_word();
  if (max_len < 2) return;  // no room for [CLS]/[SEP]; caller validates
  int32_t n = static_cast<int32_t>(ids.size());
  if (n > max_len - 2) n = max_len - 2;
  out[0] = cls;
  for (int32_t i = 0; i < n; ++i) out[1 + i] = ids[i];
  out[1 + n] = sep;
  for (int32_t i = n + 2; i < max_len; ++i) out[i] = pad;
}

}  // namespace

extern "C" {

void* wp_build(const char* vocab_blob, int64_t vocab_len) {
  auto* v = new Vocab();
  int32_t idx = 0;
  const char* p = vocab_blob;
  const char* end = vocab_blob + vocab_len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t n = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    if (n > 0) v->map.emplace(std::string(p, n), idx);
    ++idx;
    if (!nl) break;
    p = nl + 1;
  }
  return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// texts: concatenated bytes; offsets: [n+1] int64 boundaries into texts.
// out: [n, max_len] int32 (row-major, caller-allocated).
void wp_encode_batch(void* handle, const char* texts, const int64_t* offsets,
                     int64_t n, int32_t max_len, int32_t cls, int32_t sep,
                     int32_t pad, int32_t unk, int32_t* out,
                     int32_t n_threads) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      encode_one(v, texts + offsets[i], offsets[i + 1] - offsets[i], max_len,
                 cls, sep, pad, unk, out + i * max_len);
    }
  };
  if (n_threads == 1 || n < 256) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
