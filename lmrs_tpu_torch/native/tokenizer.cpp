// Native tokenizer engine: greedy highest-score BPE merge loop.
//
// C++ equivalent of the reference's encode hot loop
// (reference: src/tokenizer.rs:110-134) — the O(n^2-per-merge) scored-merge
// scan dominates prompt encoding for long prompts; this implementation is
// bit-identical to the pure-Python loop in lmrs_tpu_torch/tokenizer.py
// (leftmost strict-greater-score pair merges first).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency):
//   lmrs_tok_from_buffer(data, len)  — parse a tokenizer.bin image
//   lmrs_tok_merge(tok, ids, n)      — in-place merge; returns new length
//   lmrs_tok_lookup(tok, utf8, len)  — exact vocab lookup (or -1)
//   lmrs_tok_free(tok)
//
// Built at first use by lmrs_tpu_torch/native/__init__.py (g++ -O2
// -shared -fPIC, no make).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::vector<std::string> vocab;
  std::vector<float> scores;
  // text -> lowest id (mirrors the Python dict.setdefault in id order)
  std::unordered_map<std::string, uint32_t> lookup;
  uint32_t bos = 0, eos = 0;
};

}  // namespace

extern "C" {

void* lmrs_tok_from_buffer(const uint8_t* data, uint64_t len) {
  if (len < 16) return nullptr;
  auto* tok = new Tokenizer();
  uint32_t vocab_size, max_len;
  std::memcpy(&vocab_size, data, 4);
  std::memcpy(&max_len, data + 4, 4);
  std::memcpy(&tok->bos, data + 8, 4);
  std::memcpy(&tok->eos, data + 12, 4);
  uint64_t off = 16;
  tok->vocab.reserve(vocab_size);
  tok->scores.reserve(vocab_size);
  for (uint32_t i = 0; i < vocab_size; ++i) {
    if (off + 8 > len) { delete tok; return nullptr; }
    float score;
    uint32_t slen;
    std::memcpy(&score, data + off, 4);
    std::memcpy(&slen, data + off + 4, 4);
    off += 8;
    if (off + slen > len) { delete tok; return nullptr; }
    tok->vocab.emplace_back(reinterpret_cast<const char*>(data + off), slen);
    off += slen;
    tok->scores.push_back(score);
    tok->lookup.emplace(tok->vocab.back(), i);  // emplace keeps lowest id
  }
  return tok;
}

void lmrs_tok_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

int64_t lmrs_tok_lookup(void* handle, const char* utf8, uint64_t len) {
  auto* tok = static_cast<Tokenizer*>(handle);
  auto it = tok->lookup.find(std::string(utf8, len));
  return it == tok->lookup.end() ? -1 : static_cast<int64_t>(it->second);
}

// Greedy scored merge, identical semantics to reference src/tokenizer.rs:
// 110-134: each round, merge the adjacent pair whose concatenation exists
// in the vocab with the strictly highest score; leftmost wins ties.
// Returns the new token count (<= n).  Ids >= vocab size never merge.
int64_t lmrs_tok_merge(void* handle, uint32_t* ids, int64_t n) {
  auto* tok = static_cast<Tokenizer*>(handle);
  const auto nv = static_cast<uint32_t>(tok->vocab.size());
  std::vector<uint32_t> t(ids, ids + n);
  std::string merged;
  for (;;) {
    float best_score = -1e10f;
    int64_t best_idx = -1;
    uint32_t best_id = 0;
    for (int64_t i = 0; i + 1 < static_cast<int64_t>(t.size()); ++i) {
      if (t[i] >= nv || t[i + 1] >= nv) continue;
      merged.assign(tok->vocab[t[i]]);
      merged += tok->vocab[t[i + 1]];
      auto it = tok->lookup.find(merged);
      if (it != tok->lookup.end() && tok->scores[it->second] > best_score) {
        best_score = tok->scores[it->second];
        best_id = it->second;
        best_idx = i;
      }
    }
    if (best_idx < 0) break;
    t[best_idx] = best_id;
    t.erase(t.begin() + best_idx + 1);
  }
  std::memcpy(ids, t.data(), t.size() * sizeof(uint32_t));
  return static_cast<int64_t>(t.size());
}

// ---------------------------------------------------------------------------
// Q4 byte repack: file layout (adjacent-pair nibbles) → runtime layout
// (group-half nibbles; see lmrs_tpu_torch/quant.py).  One streaming pass,
// for a host-side repack of many GB where numpy on one core takes minutes.
// `data` is n bytes of packed rows whose row length divides into groups of
// group_size/2 bytes; the transform is local to each group.
void lmrs_q4_repack(const uint8_t* src, uint8_t* dst, uint64_t n,
                    uint32_t group_size) {
  const uint64_t gb = group_size / 2;  // bytes per group
  const uint64_t hb = gb / 2;          // source bytes per half-group
  for (uint64_t g0 = 0; g0 < n; g0 += gb) {
    const uint8_t* s = src + g0;       // s[k] holds natural values 2k, 2k+1
    uint8_t* d = dst + g0;
    // output byte j pairs natural values j and j+gb; consecutive output
    // bytes (2k, 2k+1) draw from source bytes k and k+hb — branch-free,
    // auto-vectorizable
    for (uint64_t k = 0; k < hb; ++k) {
      const uint8_t a = s[k];
      const uint8_t b = s[k + hb];
      // XOR 0x80 bias: the runtime convention stores u ^ 0x80 so the
      // device-side int8 view reads u - 128 (see lmrs_tpu_torch/quant.py)
      d[2 * k] =
          static_cast<uint8_t>(((a & 0x0F) | ((b & 0x0F) << 4)) ^ 0x80);
      d[2 * k + 1] = static_cast<uint8_t>(((a >> 4) | (b & 0xF0)) ^ 0x80);
    }
  }
}

}  // extern "C"
