// Native BPE tokenizer with the Encode/Decode/TokenToId/IdToToken surface of
// the reference's tokenizers_cpp facade (cpp/tokenizers-cpp/include/
// tokenizers_cpp.h:25-48).  The reference backs that surface with a Rust HF
// tokenizer + vendored sentencepiece; Rust isn't in this image, so this is a
// from-scratch C++ BPE engine covering both schemes the model catalog needs:
//
//  - "bytelevel": GPT-2/BLOOM style byte-level BPE (byte<->unicode alphabet,
//    GPT-2-style pre-tokenization).
//  - "metaspace": sentencepiece-style BPE (llama/mistral): spaces become
//    U+2581, per-word BPE over codepoints, <0xXX> byte fallback.
//
// The model blob is NOT tokenizer.json — the Python facade
// (distributed_inference_demo_tpu_torch/tokenizer.py) lowers tokenizer.json into a
// simple line-based exchange format so the C++ side has no JSON dependency.
// A byte-identical pure-Python implementation of the same spec lives next to
// the facade; tests assert equivalence of all three (C++, Python, HF).
//
// C ABI (ctypes), mirroring the reference's tokenizers_c.h.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// UTF-8 helpers
// ---------------------------------------------------------------------------

// Append codepoint as UTF-8.
void append_utf8(std::string& s, uint32_t cp) {
  if (cp < 0x80) {
    s.push_back((char)cp);
  } else if (cp < 0x800) {
    s.push_back((char)(0xC0 | (cp >> 6)));
    s.push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    s.push_back((char)(0xE0 | (cp >> 12)));
    s.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    s.push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    s.push_back((char)(0xF0 | (cp >> 18)));
    s.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    s.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    s.push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// Decode the UTF-8 codepoint at s[i]; advances i. Invalid bytes yield the
// byte value itself (caller handles fallback).
uint32_t next_cp(const std::string& s, size_t& i) {
  unsigned char c = s[i];
  uint32_t cp;
  int extra;
  if (c < 0x80) { cp = c; extra = 0; }
  else if ((c >> 5) == 0x6) { cp = c & 0x1F; extra = 1; }
  else if ((c >> 4) == 0xE) { cp = c & 0x0F; extra = 2; }
  else if ((c >> 3) == 0x1E) { cp = c & 0x07; extra = 3; }
  else { ++i; return c; }
  if (i + extra >= s.size()) { ++i; return c; }
  for (int k = 1; k <= extra; ++k) {
    unsigned char cc = s[i + k];
    if ((cc >> 6) != 0x2) { ++i; return c; }
    cp = (cp << 6) | (cc & 0x3F);
  }
  i += extra + 1;
  return cp;
}

// Split a UTF-8 string into per-codepoint strings.
std::vector<std::string> split_cps(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    size_t start = i;
    next_cp(s, i);
    out.push_back(s.substr(start, i - start));
  }
  return out;
}

// ---------------------------------------------------------------------------
// GPT-2 byte <-> unicode alphabet (the byte-level scheme's symbol space).
// Matches huggingface/transformers bytes_to_unicode().
// ---------------------------------------------------------------------------

struct ByteAlphabet {
  std::string byte_to_sym[256];          // byte -> UTF-8 symbol
  std::unordered_map<uint32_t, int> sym_to_byte;  // codepoint -> byte

  ByteAlphabet() {
    std::vector<int> bs;
    for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
    for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
    for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
    std::vector<uint32_t> cs(bs.begin(), bs.end());
    int n = 0;
    for (int b = 0; b < 256; ++b) {
      if (std::find(bs.begin(), bs.end(), b) == bs.end()) {
        bs.push_back(b);
        cs.push_back(256 + n);
        ++n;
      }
    }
    for (size_t i = 0; i < bs.size(); ++i) {
      std::string sym;
      append_utf8(sym, cs[i]);
      byte_to_sym[bs[i]] = sym;
      sym_to_byte[cs[i]] = bs[i];
    }
  }
};

const ByteAlphabet& byte_alphabet() {
  static ByteAlphabet a;
  return a;
}

// ---------------------------------------------------------------------------
// Tokenizer model
// ---------------------------------------------------------------------------

struct Tok {
  // config
  std::string scheme;  // "bytelevel" | "metaspace" | "none"
  bool byte_fallback = false;
  bool prepend = false;       // metaspace: prepend U+2581 at sequence start
  int unk_id = -1;
  // model
  std::unordered_map<std::string, int> vocab;
  std::vector<std::string> id_to_tok;
  std::unordered_map<std::string, int> merge_rank;  // "left\x01right" -> rank
  std::unordered_map<std::string, int> specials;    // token -> id
  std::vector<std::string> special_list;            // longest-first
  // result buffers (mirrors the reference Rust TokenizerWrapper's buffer
  // ownership, lib.rs:8-95)
  std::vector<int32_t> ids_buf;
  std::string str_buf;
};

std::string merge_key(const std::string& a, const std::string& b) {
  std::string k = a;
  k.push_back('\x01');
  k += b;
  return k;
}

// Apply BPE merges to a symbol sequence; returns token strings.
std::vector<std::string> bpe(const Tok& t, std::vector<std::string> syms) {
  if (syms.size() < 2) return syms;
  while (true) {
    int best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < syms.size(); ++i) {
      auto it = t.merge_rank.find(merge_key(syms[i], syms[i + 1]));
      if (it != t.merge_rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    syms[best_i] += syms[best_i + 1];
    syms.erase(syms.begin() + best_i + 1);
  }
  return syms;
}

// Emit token ids for one BPE'd word, with unk/byte-fallback handling.
void emit(const Tok& t, const std::vector<std::string>& toks,
          std::vector<int32_t>& out) {
  for (const auto& tok : toks) {
    auto it = t.vocab.find(tok);
    if (it != t.vocab.end()) {
      out.push_back(it->second);
    } else if (t.byte_fallback) {
      static const char* hex = "0123456789ABCDEF";
      for (unsigned char b : tok) {
        std::string fb = "<0x";
        fb.push_back(hex[b >> 4]);
        fb.push_back(hex[b & 0xF]);
        fb += ">";
        auto fit = t.vocab.find(fb);
        if (fit != t.vocab.end()) out.push_back(fit->second);
        else if (t.unk_id >= 0) out.push_back(t.unk_id);
      }
    } else if (t.unk_id >= 0) {
      out.push_back(t.unk_id);
    }
  }
}

// ---------------------------------------------------------------------------
// Pre-tokenizers
// ---------------------------------------------------------------------------

bool is_ws(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == 0x0B ||
         cp == 0x0C || cp == 0xA0 || cp == 0x2028 || cp == 0x2029 ||
         (cp >= 0x2000 && cp <= 0x200A);
}
bool is_digit(uint32_t cp) { return cp >= '0' && cp <= '9'; }
bool is_letter(uint32_t cp) {
  // ASCII letters exactly; non-ASCII non-whitespace approximated as letters
  // (full \p{L} tables are out of scope; identical rule in the Python twin).
  return (cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z') ||
         (cp >= 0x80 && !is_ws(cp));
}

// GPT-2-style pre-tokenization over codepoints (simplified \p{L}/\p{N}):
//   's|'t|'re|'ve|'m|'ll|'d | ?L+ | ?N+ | ?[^ws L N]+ | ws+(?!\S) | ws+
std::vector<std::string> pretok_gpt2(const std::string& text) {
  std::vector<uint32_t> cps;
  std::vector<std::string> raw;  // utf-8 per cp
  size_t i = 0;
  while (i < text.size()) {
    size_t s = i;
    cps.push_back(next_cp(text, i));
    raw.push_back(text.substr(s, i - s));
  }
  std::vector<std::string> out;
  size_t n = cps.size(), p = 0;
  auto take = [&](size_t a, size_t b) {
    std::string w;
    for (size_t k = a; k < b; ++k) w += raw[k];
    out.push_back(w);
  };
  while (p < n) {
    // contractions
    if (cps[p] == '\'' && p + 1 < n) {
      uint32_t c1 = cps[p + 1] | 0x20;  // lowercase ASCII
      if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') {
        take(p, p + 2); p += 2; continue;
      }
      if (p + 2 < n) {
        uint32_t c2 = cps[p + 2] | 0x20;
        if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
            (c1 == 'l' && c2 == 'l')) {
          take(p, p + 3); p += 3; continue;
        }
      }
    }
    size_t start = p;
    bool lead_space = (cps[p] == ' ' && p + 1 < n && !is_ws(cps[p + 1]));
    size_t q = p + (lead_space ? 1 : 0);
    if (q < n && is_letter(cps[q])) {
      while (q < n && is_letter(cps[q])) ++q;
      take(start, q); p = q; continue;
    }
    if (q < n && is_digit(cps[q])) {
      while (q < n && is_digit(cps[q])) ++q;
      take(start, q); p = q; continue;
    }
    if (q < n && !is_ws(cps[q])) {  // punctuation run (apostrophes included;
      // contractions were already matched above, so a remaining ' is punct)
      while (q < n && !is_ws(cps[q]) && !is_letter(cps[q]) && !is_digit(cps[q]))
        ++q;
      take(start, q); p = q; continue;
    }
    // whitespace run: \s+(?!\S) — leave the last ws char to the next token
    // when a non-ws follows the run (it then joins that token via " ?", or
    // stands alone if it isn't a plain space).
    size_t w = p;
    while (w < n && is_ws(cps[w])) ++w;
    if (w < n && w - p > 1) { take(p, w - 1); p = w - 1; }
    else { take(p, w); p = w; }
  }
  return out;
}

// Metaspace pre-tokenization: replace ' ' with U+2581, optionally prepend,
// split so each piece starts at a U+2581 boundary.
std::vector<std::string> pretok_metaspace(const std::string& text,
                                          bool prepend) {
  std::string meta = "\xE2\x96\x81";  // U+2581
  std::string s;
  if (prepend && !text.empty() && text.compare(0, 1, " ") != 0) s += meta;
  size_t i = 0;
  while (i < text.size()) {
    if (text[i] == ' ') { s += meta; ++i; }
    else { s.push_back(text[i]); ++i; }
  }
  std::vector<std::string> pieces;
  std::vector<std::string> cps = split_cps(s);
  std::string cur;
  for (auto& c : cps) {
    if (c == meta && !cur.empty()) { pieces.push_back(cur); cur.clear(); }
    cur += c;
  }
  if (!cur.empty()) pieces.push_back(cur);
  return pieces;
}

// ---------------------------------------------------------------------------
// Encode / Decode
// ---------------------------------------------------------------------------

void encode_plain(const Tok& t, const std::string& text,
                  std::vector<int32_t>& out) {
  if (t.scheme == "bytelevel") {
    const ByteAlphabet& alpha = byte_alphabet();
    for (const auto& word : pretok_gpt2(text)) {
      std::vector<std::string> syms;
      for (unsigned char b : word) syms.push_back(alpha.byte_to_sym[b]);
      emit(t, bpe(t, std::move(syms)), out);
    }
  } else if (t.scheme == "metaspace") {
    for (const auto& word : pretok_metaspace(text, t.prepend)) {
      emit(t, bpe(t, split_cps(word)), out);
    }
  } else {  // "none": whole text as one BPE word over codepoints
    emit(t, bpe(t, split_cps(text)), out);
  }
}

void encode(const Tok& t, const std::string& text, std::vector<int32_t>& out) {
  // split out special tokens first (longest match wins)
  size_t pos = 0;
  std::string pending;
  while (pos < text.size()) {
    bool matched = false;
    for (const auto& sp : t.special_list) {
      if (text.compare(pos, sp.size(), sp) == 0) {
        if (!pending.empty()) { encode_plain(t, pending, out); pending.clear(); }
        out.push_back(t.specials.at(sp));
        pos += sp.size();
        matched = true;
        break;
      }
    }
    if (!matched) { pending.push_back(text[pos]); ++pos; }
  }
  if (!pending.empty()) encode_plain(t, pending, out);
}

std::string decode(const Tok& t, const int32_t* ids, uint64_t n,
                   bool skip_special) {
  std::string joined;
  std::vector<uint8_t> bytes;
  auto flush_pending = [&]() {};
  (void)flush_pending;
  if (t.scheme == "bytelevel") {
    for (uint64_t i = 0; i < n; ++i) {
      if (ids[i] < 0 || (size_t)ids[i] >= t.id_to_tok.size()) continue;
      const std::string& tok = t.id_to_tok[ids[i]];
      bool special = t.specials.count(tok) > 0;
      if (special) {
        if (!skip_special) joined += tok;
        continue;
      }
      const ByteAlphabet& alpha = byte_alphabet();
      size_t j = 0;
      while (j < tok.size()) {
        uint32_t cp = next_cp(tok, j);
        auto it = alpha.sym_to_byte.find(cp);
        if (it != alpha.sym_to_byte.end()) joined.push_back((char)it->second);
        else append_utf8(joined, cp);
      }
    }
    return joined;
  }
  // metaspace / none: concat tokens, then <0xXX> fallback and U+2581 -> ' '
  for (uint64_t i = 0; i < n; ++i) {
    if (ids[i] < 0 || (size_t)ids[i] >= t.id_to_tok.size()) continue;
    const std::string& tok = t.id_to_tok[ids[i]];
    bool special = t.specials.count(tok) > 0;
    if (special) {
      if (!skip_special) joined += tok;
      continue;
    }
    if (tok.size() == 6 && tok.compare(0, 3, "<0x") == 0 && tok[5] == '>') {
      auto hexval = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        return -1;
      };
      int hi = hexval(tok[3]), lo = hexval(tok[4]);
      if (hi >= 0 && lo >= 0) { joined.push_back((char)(hi * 16 + lo)); continue; }
    }
    joined += tok;
  }
  if (t.scheme == "metaspace") {
    std::string meta = "\xE2\x96\x81";
    std::string out;
    size_t i = 0;
    while (i < joined.size()) {
      if (joined.compare(i, meta.size(), meta) == 0) {
        out.push_back(' ');
        i += meta.size();
      } else {
        out.push_back(joined[i]);
        ++i;
      }
    }
    if (t.prepend && !out.empty() && out[0] == ' ') out.erase(0, 1);
    return out;
  }
  return joined;
}

// ---------------------------------------------------------------------------
// Blob parsing (the exchange format written by the Python facade)
// ---------------------------------------------------------------------------

Tok* parse_blob(const std::string& blob) {
  auto* t = new Tok();
  std::istringstream in(blob);
  std::string line;
  auto fields = [](const std::string& l) {
    std::vector<std::string> f;
    size_t p = 0;
    while (true) {
      size_t q = l.find('\t', p);
      if (q == std::string::npos) { f.push_back(l.substr(p)); break; }
      f.push_back(l.substr(p, q - p));
      p = q + 1;
    }
    return f;
  };
  // unescape \n \t \\ in token strings
  auto unesc = [](const std::string& s) {
    std::string o;
    for (size_t i = 0; i < s.size(); ++i) {
      if (s[i] == '\\' && i + 1 < s.size()) {
        char c = s[++i];
        o.push_back(c == 'n' ? '\n' : c == 't' ? '\t' : c);
      } else o.push_back(s[i]);
    }
    return o;
  };
  int64_t ntok = -1, nmerge = -1, nspecial = -1;
  try {
    while (std::getline(in, line)) {
      auto f = fields(line);
      if (f.empty() || f[0].empty()) continue;
      if (f[0] == "scheme") t->scheme = f.at(1);
      else if (f[0] == "fallback") t->byte_fallback = f.at(1) == "1";
      else if (f[0] == "prepend") t->prepend = f.at(1) == "1";
      else if (f[0] == "unk") t->unk_id = std::stoi(f.at(1));
      else if (f[0] == "ntok") {
        ntok = std::stoll(f.at(1));
        for (int64_t i = 0; i < ntok; ++i) {
          if (!std::getline(in, line)) throw std::runtime_error("eof");
          auto vf = fields(line);
          int id = std::stoi(vf.at(0));
          std::string tok = unesc(vf.at(1));
          if ((int64_t)t->id_to_tok.size() <= id) t->id_to_tok.resize(id + 1);
          t->id_to_tok[id] = tok;
          t->vocab[tok] = id;
        }
      } else if (f[0] == "nmerge") {
        nmerge = std::stoll(f.at(1));
        for (int64_t i = 0; i < nmerge; ++i) {
          if (!std::getline(in, line)) throw std::runtime_error("eof");
          auto mf = fields(line);
          t->merge_rank[merge_key(unesc(mf.at(0)), unesc(mf.at(1)))] = (int)i;
        }
      } else if (f[0] == "nspecial") {
        nspecial = std::stoll(f.at(1));
        for (int64_t i = 0; i < nspecial; ++i) {
          if (!std::getline(in, line)) throw std::runtime_error("eof");
          auto sf = fields(line);
          int id = std::stoi(sf.at(0));
          std::string tok = unesc(sf.at(1));
          t->specials[tok] = id;
          if ((int64_t)t->id_to_tok.size() <= id) t->id_to_tok.resize(id + 1);
          t->id_to_tok[id] = tok;
          t->vocab[tok] = id;
        }
      }
    }
  } catch (...) {
    delete t;
    return nullptr;
  }
  if (ntok < 0) { delete t; return nullptr; }
  t->special_list.reserve(t->specials.size());
  for (auto& kv : t->specials) t->special_list.push_back(kv.first);
  std::sort(t->special_list.begin(), t->special_list.end(),
            [](const std::string& a, const std::string& b) {
              return a.size() > b.size();
            });
  return t;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI (shape mirrors the reference's tokenizers_c.h)
// ---------------------------------------------------------------------------

extern "C" {

void* dwt_tok_new(const char* blob, uint64_t len) {
  return parse_blob(std::string(blob, len));
}

void dwt_tok_free(void* h) { delete static_cast<Tok*>(h); }

// Encode text; result stays in the handle's buffer until the next call.
void dwt_tok_encode(void* h, const char* text, uint64_t len) {
  auto* t = static_cast<Tok*>(h);
  t->ids_buf.clear();
  encode(*t, std::string(text, len), t->ids_buf);
}

uint64_t dwt_tok_ids_len(void* h) {
  return static_cast<Tok*>(h)->ids_buf.size();
}

const int32_t* dwt_tok_ids(void* h) {
  return static_cast<Tok*>(h)->ids_buf.data();
}

void dwt_tok_decode(void* h, const int32_t* ids, uint64_t n,
                    int skip_special) {
  auto* t = static_cast<Tok*>(h);
  t->str_buf = decode(*t, ids, n, skip_special != 0);
}

uint64_t dwt_tok_str_len(void* h) {
  return static_cast<Tok*>(h)->str_buf.size();
}

const char* dwt_tok_str(void* h) {
  return static_cast<Tok*>(h)->str_buf.data();
}

int32_t dwt_tok_token_to_id(void* h, const char* tok, uint64_t len) {
  auto* t = static_cast<Tok*>(h);
  auto it = t->vocab.find(std::string(tok, len));
  return it == t->vocab.end() ? -1 : it->second;
}

// Writes the token string into the handle's buffer; returns 0 on bad id.
int dwt_tok_id_to_token(void* h, int32_t id) {
  auto* t = static_cast<Tok*>(h);
  if (id < 0 || (size_t)id >= t->id_to_tok.size()) return 0;
  t->str_buf = t->id_to_tok[id];
  return 1;
}

uint64_t dwt_tok_vocab_size(void* h) {
  return static_cast<Tok*>(h)->id_to_tok.size();
}

}  // extern "C"
