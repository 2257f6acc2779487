// wordpiece.cpp — native WordPiece tokenizer of the MedTok host data path
// (medtok_tpu_torch's own copy of csrc/wordpiece.cpp, built with g++ by
// medtok_tpu_torch/data/host_build.py).
//
// Replaces the per-code HF tokenizer call of the reference's dataset
// (dataset_creator.py:278-282) on the 600K-description sweep. Implements
// bert-base-uncased BasicTokenizer + WordPiece semantics for ASCII text
// (lowercase, punctuation split, greedy longest-match with "##"
// continuations, [CLS]/[SEP] wrap, [UNK] fallback). Texts containing
// non-ASCII bytes are REJECTED (return -1) so the Python binding can fall
// back to the full-Unicode implementation — medical code descriptions are
// overwhelmingly ASCII, so the fast path covers nearly everything.
//
// C ABI for ctypes; vocabulary stored in a hash map keyed by token string.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// Word-level memo: WordPiece is a pure function of the lowercased word, and
// medical-code descriptions repeat a small vocabulary of words massively
// (HF fast tokenizers keep the same cache). Memoizing word -> piece ids
// turns the O(len^2) greedy substring search into one hash lookup for every
// repeated word — ~10x on the 600K-description sweep.
// One memo per worker thread (thread_local), so no locks.
namespace {
struct WordMemo {
  std::unordered_map<std::string, std::vector<int32_t>> map;
  uint64_t owner_gen = ~uint64_t{0};  // reset when the vocab changes
};
}  // namespace

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> map;
  int32_t unk = -1, cls = -1, sep = -1, pad = -1;
  int max_chars_per_word = 100;
  uint64_t gen = 0;  // unique per build — keys the thread_local word memos
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Core single-text encode; returns ids written or -1 on non-ASCII input.
int64_t encode_one(const Vocab* v, const char* text, int64_t text_len,
                   int32_t* out, int64_t max_len) {
  // reject non-ASCII and control chars other than whitespace
  for (int64_t i = 0; i < text_len; i++) {
    unsigned char c = text[i];
    if (c >= 0x80) return -1;
  }

  std::vector<int32_t> ids;
  ids.push_back(v->cls);

  // basic-tokenize: lowercase, split on whitespace and punctuation
  std::vector<std::string> words;
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      words.push_back(cur);
      cur.clear();
    }
  };
  for (int64_t i = 0; i < text_len; i++) {
    unsigned char c = text[i];
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c < 0x20 ||
        c == 0x7f) {
      flush();
    } else if (is_ascii_punct(c)) {
      flush();
      words.emplace_back(1, static_cast<char>(c));
    } else {
      cur.push_back(static_cast<char>(
          (c >= 'A' && c <= 'Z') ? c - 'A' + 'a' : c));
    }
  }
  flush();

  // wordpiece greedy longest-match-first, memoized per word
  thread_local WordMemo memo;
  if (memo.owner_gen != v->gen) {
    memo.map.clear();
    memo.owner_gen = v->gen;
  }
  std::string sub;
  for (const auto& w : words) {
    auto mit = memo.map.find(w);
    if (mit != memo.map.end()) {
      ids.insert(ids.end(), mit->second.begin(), mit->second.end());
      continue;
    }
    std::vector<int32_t> piece_ids;
    if (static_cast<int>(w.size()) > v->max_chars_per_word) {
      piece_ids.push_back(v->unk);
    } else {
      size_t start = 0;
      bool ok = true;
      while (start < w.size()) {
        size_t stop = w.size();
        int32_t found = -1;
        while (start < stop) {
          sub.clear();
          if (start > 0) sub = "##";
          sub.append(w, start, stop - start);
          auto it = v->map.find(sub);
          if (it != v->map.end()) {
            found = it->second;
            break;
          }
          stop--;
        }
        if (found < 0) {
          ok = false;
          break;
        }
        piece_ids.push_back(found);
        start = stop;
      }
      if (!ok) {
        piece_ids.clear();
        piece_ids.push_back(v->unk);
      }
    }
    ids.insert(ids.end(), piece_ids.begin(), piece_ids.end());
    memo.map.emplace(w, std::move(piece_ids));
  }

  // truncate to max_len-1 then append [SEP] (Python encode semantics)
  if (static_cast<int64_t>(ids.size()) > max_len - 1) {
    ids.resize(max_len - 1);
  }
  ids.push_back(v->sep);
  int64_t n = static_cast<int64_t>(ids.size());
  memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-separated token strings, id = line index.
void* medtok_wp_build(const char* vocab_blob, int64_t blob_len) {
  static std::atomic<uint64_t> next_gen{1};
  auto* v = new Vocab();
  v->gen = next_gen.fetch_add(1);
  int32_t id = 0;
  const char* p = vocab_blob;
  const char* end = vocab_blob + blob_len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t len = (nl ? nl : end) - p;
    std::string tok(p, len);
    if (!tok.empty() && tok.back() == '\r') tok.pop_back();
    v->map.emplace(tok, id);
    if (tok == "[UNK]") v->unk = id;
    else if (tok == "[CLS]") v->cls = id;
    else if (tok == "[SEP]") v->sep = id;
    else if (tok == "[PAD]") v->pad = id;
    id++;
    p = nl ? nl + 1 : end;
  }
  return v;
}

void medtok_wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Encode ASCII text -> ids. Returns the number of ids written (<= max_out,
// truncated to max_len-1 then [SEP] appended, matching the Python encode),
// or -1 if the text contains non-ASCII bytes (caller falls back).
int64_t medtok_wp_encode(const void* handle, const char* text, int64_t text_len,
                         int32_t* out, int64_t max_len) {
  return encode_one(static_cast<const Vocab*>(handle), text, text_len, out,
                    max_len);
}

// Batch encode with an internal thread pool. texts are concatenated in
// `blob`; text i spans [offsets[i], offsets[i+1]). Writes ids to
// out + i*max_len and the id count (or -1 for non-ASCII rejects, which the
// Python side re-encodes with the full-Unicode fallback) to out_lens[i].
// num_threads <= 0 means hardware_concurrency. Returns the reject count.
int64_t medtok_wp_encode_batch(const void* handle, const char* blob,
                               const int64_t* offsets, int64_t num_texts,
                               int32_t* out, int64_t* out_lens,
                               int64_t max_len, int32_t num_threads) {
  const auto* v = static_cast<const Vocab*>(handle);
  int nt = num_threads > 0
               ? num_threads
               : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (static_cast<int64_t>(nt) > num_texts) nt = static_cast<int>(num_texts);

  std::atomic<int64_t> next(0), rejects(0);
  auto worker = [&]() {
    // dynamic chunks: descriptions vary in length, so static striding
    // would leave stragglers on one thread
    constexpr int64_t kChunk = 256;
    for (;;) {
      int64_t begin = next.fetch_add(kChunk);
      if (begin >= num_texts) return;
      int64_t end = begin + kChunk < num_texts ? begin + kChunk : num_texts;
      for (int64_t i = begin; i < end; i++) {
        int64_t n = encode_one(v, blob + offsets[i],
                               offsets[i + 1] - offsets[i],
                               out + i * max_len, max_len);
        out_lens[i] = n;
        if (n < 0) rejects.fetch_add(1);
      }
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; t++) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return rejects.load();
}

}  // extern "C"
