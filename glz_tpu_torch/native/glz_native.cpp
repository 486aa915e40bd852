// glz-tpu native host library.
//
// Fast host-side paths for the codec: histogram, canonical bit-stream
// encode, table-driven multi-stream decode, and the HuffWord tokenizer.
// These replace the reference's serial per-byte loops
// (encoder.h:136-150 histogram; canonical_huff_encoder.cc:270-285 encode;
// cc:519-568 table decode; tokenizer.h:118-172 splitter) with cache-friendly
// buffered implementations, and back the Python host backend through ctypes
// (glz_tpu/utils/native.py).  The TPU path is JAX/Pallas; this is the
// host/runtime side of the framework.
//
// Build: python native/build.py  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <cstddef>

#include <algorithm>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- histogram
void glz_histogram(const uint8_t* data, size_t n, int64_t out[256]) {
  int64_t h[4][256];
  memset(h, 0, sizeof(h));
  size_t i = 0;
  for (; i + 4 <= n; i += 4) {
    h[0][data[i]]++;
    h[1][data[i + 1]]++;
    h[2][data[i + 2]]++;
    h[3][data[i + 3]]++;
  }
  for (; i < n; i++) h[0][data[i]]++;
  for (int k = 0; k < 256; k++)
    out[k] = h[0][k] + h[1][k] + h[2][k] + h[3][k];
}

// ------------------------------------------------------------------- encode
// MSB-first bit stream encode of n byte symbols using per-symbol
// left-justified codes (lj[b] = code << (32-len)) and lengths.
// Returns total bits written.  out must hold at least (32n+63)/8 bytes and
// be zero-initialised by the caller.  Also records per-stream bit counts.
uint64_t glz_encode_bytes(const uint8_t* data, uint64_t n,
                          const uint32_t* lj, const uint8_t* lens,
                          uint64_t stream_symbols,
                          uint64_t* stream_bits,  // [ceil(n/stream_symbols)]
                          uint8_t* out) {
  uint64_t acc = 0;      // bit accumulator, top-aligned
  uint32_t nbits = 0;    // valid bits in acc
  uint64_t out_pos = 0;  // bytes written
  uint64_t total_bits = 0;
  uint64_t stream_acc = 0;
  uint64_t stream_idx = 0;
  for (uint64_t i = 0; i < n; i++) {
    if (i && (i % stream_symbols) == 0) {
      stream_bits[stream_idx++] = stream_acc;
      stream_acc = 0;
    }
    uint8_t b = data[i];
    uint32_t len = lens[b];
    acc |= (uint64_t)lj[b] << (32 - nbits);
    nbits += len;
    stream_acc += len;
    total_bits += len;
    while (nbits >= 8) {
      out[out_pos++] = (uint8_t)(acc >> 56);
      acc <<= 8;
      nbits -= 8;
    }
  }
  stream_bits[stream_idx++] = stream_acc;
  if (nbits) {
    // final partial byte, 1-padded (reference flush_bits, buffer.h:277-281)
    uint8_t last = (uint8_t)(acc >> 56);
    last |= (uint8_t)((1u << (8 - nbits)) - 1);
    out[out_pos++] = last;
  }
  return total_bits;
}

// ------------------------------------------------------------------- decode
// Table-driven decode of one stream: n_syms symbols starting at start_bit.
// lut[idx] = (len << 16) | sym for len <= table_bits; sym 0xFFFF = escape
// to the cfind slow path over left-justified first codes (the reference's
// TableCanonicalHuffDecoder generalised, cc:519-568).
void glz_decode_stream(const uint8_t* payload, uint64_t payload_bytes,
                       uint64_t start_bit, uint64_t n_syms,
                       const uint32_t* lut, uint32_t table_bits,
                       const uint32_t* fc_lj,   // [34]
                       const uint32_t* start_pos,
                       const uint32_t* symbols,
                       uint8_t* out) {
  uint64_t pos = start_bit;
  const uint32_t shift = 32 - table_bits;
  for (uint64_t i = 0; i < n_syms; i++) {
    uint64_t byte = pos >> 3;
    uint32_t phase = (uint32_t)(pos & 7);
    uint64_t window;
    if (byte + 8 <= payload_bytes) {
      memcpy(&window, payload + byte, 8);
      window = __builtin_bswap64(window);
    } else {
      window = 0;
      for (int k = 0; k < 8; k++)
        window = (window << 8) | (byte + k < payload_bytes ? payload[byte + k] : 0xFF);
    }
    uint32_t v = (uint32_t)(window >> (32 - phase));
    uint32_t entry = lut[v >> shift];
    uint32_t len = entry >> 16;
    uint32_t sym = entry & 0xFFFF;
    if (sym == 0xFFFF) {
      while (v < fc_lj[len]) len++;
      sym = symbols[start_pos[len] + ((v - fc_lj[len]) >> (32 - len))];
    }
    out[i] = (uint8_t)sym;
    pos += len;
  }
}

// Decode all streams of a container (byte mode).
void glz_decode_streams(const uint8_t* payload, uint64_t payload_bytes,
                        const uint64_t* stream_bits, uint64_t n_streams,
                        uint64_t stream_symbols, uint64_t n_total,
                        const uint32_t* lut, uint32_t table_bits,
                        const uint32_t* fc_lj, const uint32_t* start_pos,
                        const uint32_t* symbols, uint8_t* out) {
  uint64_t start = 0;
  for (uint64_t s = 0; s < n_streams; s++) {
    uint64_t lo = s * stream_symbols;
    uint64_t hi = lo + stream_symbols;
    if (hi > n_total) hi = n_total;
    if (lo >= n_total) break;
    glz_decode_stream(payload, payload_bytes, start, hi - lo, lut, table_bits,
                      fc_lj, start_pos, symbols, out + lo);
    start += stream_bits[s];
  }
}

// ----------------------------------------------------- token-symbol streams
// HuffWord host paths: encode/decode u32 token-id streams with per-token
// dictionary alternation (reference WriteEncode / alternating decode,
// canonical_huffword.h:374-433, 615-640).  dict of token i = (i ^ phase0)&1.
uint64_t glz_encode_tokens(const uint32_t* ids, uint64_t n, uint32_t phase0,
                           const uint32_t* lj0, const uint8_t* len0,
                           const uint32_t* lj1, const uint8_t* len1,
                           uint64_t stream_tokens, uint64_t* stream_bits,
                           uint8_t* out) {
  uint64_t acc = 0;
  uint32_t nbits = 0;
  uint64_t out_pos = 0, total_bits = 0, stream_acc = 0, stream_idx = 0;
  for (uint64_t i = 0; i < n; i++) {
    if (i && (i % stream_tokens) == 0) {
      stream_bits[stream_idx++] = stream_acc;
      stream_acc = 0;
    }
    uint32_t id = ids[i];
    uint32_t d = ((uint32_t)i ^ phase0) & 1u;
    uint32_t len = d ? len1[id] : len0[id];
    uint32_t lj = d ? lj1[id] : lj0[id];
    acc |= (uint64_t)lj << (32 - nbits);
    nbits += len;
    stream_acc += len;
    total_bits += len;
    while (nbits >= 8) {
      out[out_pos++] = (uint8_t)(acc >> 56);
      acc <<= 8;
      nbits -= 8;
    }
  }
  stream_bits[stream_idx++] = stream_acc;
  if (nbits) {
    uint8_t last = (uint8_t)(acc >> 56);
    last |= (uint8_t)((1u << (8 - nbits)) - 1);
    out[out_pos++] = last;
  }
  return total_bits;
}

// Decode token streams: per-dict (fc_lj, offsets, symbols) canonical decode
// using the fused index formula sym = symbols[(v>>(32-len)) + offset[len]].
void glz_decode_tokens(const uint8_t* payload, uint64_t payload_bytes,
                       const uint64_t* stream_bits, uint64_t n_streams,
                       uint64_t stream_tokens, uint64_t n_total,
                       uint32_t phase0,
                       const uint32_t* fc0, const uint32_t* off0,
                       const uint32_t* sym0, uint32_t min0,
                       const uint32_t* fc1, const uint32_t* off1,
                       const uint32_t* sym1, uint32_t min1,
                       uint32_t* out) {
  uint64_t start = 0;
  for (uint64_t s = 0; s < n_streams; s++) {
    uint64_t lo = s * stream_tokens;
    uint64_t hi = lo + stream_tokens;
    if (hi > n_total) hi = n_total;
    if (lo >= n_total) break;
    uint64_t pos = start;
    for (uint64_t i = lo; i < hi; i++) {
      uint64_t byte = pos >> 3;
      uint32_t phase = (uint32_t)(pos & 7);
      uint64_t window;
      if (byte + 8 <= payload_bytes) {
        memcpy(&window, payload + byte, 8);
        window = __builtin_bswap64(window);
      } else {
        window = 0;
        for (int k = 0; k < 8; k++)
          window = (window << 8) |
                   (byte + k < payload_bytes ? payload[byte + k] : 0xFF);
      }
      uint32_t v = (uint32_t)(window >> (32 - phase));
      uint32_t d = ((uint32_t)i ^ phase0) & 1u;
      const uint32_t* fc = d ? fc1 : fc0;
      const uint32_t* off = d ? off1 : off0;
      const uint32_t* sym = d ? sym1 : sym0;
      uint32_t len = d ? min1 : min0;
      while (v < fc[len]) len++;
      out[i] = sym[(uint32_t)((v >> (32 - len)) + off[len])];
      pos += len;
    }
    start += stream_bits[s];
  }
}

// ------------------------------------------------------- .crs2 EOF decoding
// Reference canonical byte format: single stream terminated by symbol 256
// (canonical_huff_encoder.cc:422-461 fast decoder).  Returns bytes written.
uint64_t glz_decode_crs2(const uint8_t* payload, uint64_t payload_bytes,
                         const uint32_t* fc_lj, const uint32_t* start_pos,
                         const int64_t* symbols, uint32_t min_len,
                         uint32_t max_len, uint8_t* out, uint64_t out_cap) {
  uint64_t pos = 0, n = 0;
  uint64_t total_bits = payload_bytes * 8;
  while (n < out_cap && pos < total_bits) {
    uint64_t byte = pos >> 3;
    uint32_t phase = (uint32_t)(pos & 7);
    uint64_t window;
    if (byte + 8 <= payload_bytes) {
      memcpy(&window, payload + byte, 8);
      window = __builtin_bswap64(window);
    } else {
      window = 0;
      for (int k = 0; k < 8; k++)
        window = (window << 8) |
                 (byte + k < payload_bytes ? payload[byte + k] : 0xFF);
    }
    uint32_t v = (uint32_t)(window >> (32 - phase));
    uint32_t len = min_len;
    while (len <= max_len && v < fc_lj[len]) len++;
    if (len > max_len) break;
    int64_t sym = symbols[start_pos[len] + ((v - fc_lj[len]) >> (32 - len))];
    if (sym == 256) break;  // EOF mark
    out[n++] = (uint8_t)sym;
    pos += len;
  }
  return n;
}

// ---------------------------------------------------------------- tokenizer
// Wordlike mask + token boundaries (semantics: glz_tpu/utils/tokenizer.py).
// Returns the number of tokens; bounds[t] = start of token t (bounds has
// capacity n+1; bounds[T] = n).
uint64_t glz_tokenize(const uint8_t* data, uint64_t n,
                      uint64_t* bounds, uint8_t* first_is_word) {
  if (n == 0) { *first_is_word = 0; return 0; }
  static uint8_t alnum[256], hyph[256];
  static int init_done = 0;
  if (!init_done) {
    for (int c = 0; c < 256; c++) {
      alnum[c] = (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
                 (c >= 'A' && c <= 'Z');
      hyph[c] = (c == '\'' || c == '-' || c == '_');
    }
    init_done = 1;
  }
  uint64_t t = 0;
  uint8_t prev_a = 1;  // stream start counts as "ntoken empty"
  uint8_t w_prev = 2;  // sentinel
  for (uint64_t i = 0; i < n; i++) {
    uint8_t a = alnum[data[i]];
    uint8_t nxt = (i + 1 < n) ? alnum[data[i + 1]] : 0;
    uint8_t w = a | (hyph[data[i]] & nxt & prev_a);
    if (w != w_prev) {
      bounds[t++] = i;
      w_prev = w;
      if (t == 1) *first_is_word = w;
    }
    prev_a = a;
  }
  bounds[t] = n;
  return t;
}

// -------------------------------------------------------------- detokenize
// Token-id stream -> original bytes (inverse of the tokenizer; reference
// decode_file reassembles strings one symbol at a time,
// canonical_huffword.h:615-640).  Token i draws from dictionary
// (i & 1) ^ first_dict; dictionaries are (offsets[n+1], blob) pools.
// With out == nullptr, returns the total byte count (size query);
// otherwise writes the stream and returns bytes written.
uint64_t glz_detokenize(const uint32_t* ids, uint64_t T, uint32_t first_dict,
                        const uint64_t* off0, const uint8_t* blob0,
                        const uint64_t* off1, const uint8_t* blob1,
                        uint8_t* out) {
  const uint64_t* offs[2] = {off0, off1};
  const uint8_t* blobs[2] = {blob0, blob1};
  uint64_t o = 0;
  if (!out) {
    for (uint64_t i = 0; i < T; i++) {
      const uint64_t* off = offs[(i & 1) ^ first_dict];
      o += off[ids[i] + 1] - off[ids[i]];
    }
    return o;
  }
  for (uint64_t i = 0; i < T; i++) {
    uint32_t d = (uint32_t)(i & 1) ^ first_dict;
    uint64_t s = offs[d][ids[i]];
    uint64_t len = offs[d][ids[i] + 1] - s;
    memcpy(out + o, blobs[d] + s, len);
    o += len;
  }
  return o;
}

// ------------------------------------------------------------ vocabulary
// One hash pass over one token class (the reference fills an unordered_map
// per class the same way, encoder.h:155-166 CalcFrequency) followed by a
// deterministic (length, content) sort for the canonical id order the
// containers store (the reference's hash-iteration-order ids are
// nondeterministic, canonical_huffword.h:191 — ours are reproducible).
// Replaces the numpy key-matrix + np.unique path in
// glz_tpu/utils/tokenizer._class_vocab, which sorts tens of millions of
// 24-byte keys (~40 s per class at 100 MB input vs ~2 s here).
//
// data/bounds: from glz_tokenize.  cls: token parity (token i belongs when
// (i & 1) == cls).  Outputs, all in rank order: tok_lens (u32, caller
// capacity >= class token count), counts (u64, same), blob (caller
// capacity >= total class bytes), blob_len_out.  ids[i] is written for this
// class's positions only.  Returns the vocabulary size.
static inline uint64_t vocab_hash(const uint8_t* p, size_t n) {
  uint64_t h = 1469598103934665603ULL ^ (n * 0x9E3779B97F4A7C15ULL);
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    h = (h ^ v) * 1099511628211ULL;
    p += 8;
    n -= 8;
  }
  if (n) {
    uint64_t v = 0;
    memcpy(&v, p, n);
    h = (h ^ v) * 1099511628211ULL;
  }
  return h ^ (h >> 32);
}

uint64_t glz_build_vocab(const uint8_t* data,
                         const uint64_t* bounds, uint64_t T, uint32_t cls,
                         uint64_t cap_tokens,
                         uint32_t* ids, uint32_t* tok_lens, uint64_t* counts,
                         uint8_t* blob, uint64_t* blob_len_out) {
  // open-addressing hash table keyed by (offset, len) into `data`; 3-5x
  // faster than std::unordered_map<string_view> for short tokens, and the
  // two class passes run concurrently from Python (ctypes drops the GIL)
  constexpr uint32_t EMPTY = 0xFFFFFFFFu;
  size_t cap = 1 << 16;
  std::vector<uint64_t> kpos(cap);
  std::vector<uint32_t> klen(cap, EMPTY), val(cap);
  std::vector<uint64_t> uniq_pos;
  std::vector<uint32_t> uniq_len;
  std::vector<uint64_t> cnt;
  size_t used = 0, mask = cap - 1;

  auto grow = [&]() {
    size_t ncap = cap * 2, nmask = ncap - 1;
    std::vector<uint64_t> nkpos(ncap);
    std::vector<uint32_t> nklen(ncap, EMPTY), nval(ncap);
    for (size_t i = 0; i < cap; i++) {
      if (klen[i] == EMPTY) continue;
      size_t j = vocab_hash(data + kpos[i], klen[i]) & nmask;
      while (nklen[j] != EMPTY) j = (j + 1) & nmask;
      nkpos[j] = kpos[i]; nklen[j] = klen[i]; nval[j] = val[i];
    }
    kpos.swap(nkpos); klen.swap(nklen); val.swap(nval);
    cap = ncap; mask = nmask;
  };

  for (uint64_t i = cls; i < T; i += 2) {
    const uint64_t pos = bounds[i];
    const uint32_t len = (uint32_t)(bounds[i + 1] - pos);
    const uint8_t* tok = data + pos;
    size_t j = vocab_hash(tok, len) & mask;
    uint32_t id;
    for (;;) {
      if (klen[j] == EMPTY) {
        id = (uint32_t)uniq_pos.size();
        kpos[j] = pos; klen[j] = len; val[j] = id;
        uniq_pos.push_back(pos);
        uniq_len.push_back(len);
        cnt.push_back(0);
        if (++used * 10 >= cap * 7) grow();
        break;
      }
      if (klen[j] == len && !memcmp(data + kpos[j], tok, len)) {
        id = val[j];
        break;
      }
      j = (j + 1) & mask;
    }
    cnt[id]++;
    ids[i] = id;
  }
  const uint64_t V = uniq_pos.size();
  if (V > cap_tokens) {  // caller's output buffers too small: report only
    *blob_len_out = 0;
    return V;
  }
  std::vector<std::string_view> uniq(V);
  for (uint64_t r = 0; r < V; r++)
    uniq[r] = std::string_view(reinterpret_cast<const char*>(data) + uniq_pos[r],
                               uniq_len[r]);
  // deterministic ids: rank by (length, content) — matches the numpy
  // key-matrix order (length byte leads the key there too)
  std::vector<uint32_t> order(V);
  for (uint64_t r = 0; r < V; r++) order[r] = (uint32_t)r;
  std::sort(order.begin(), order.end(), [&](uint32_t a, uint32_t b) {
    if (uniq[a].size() != uniq[b].size()) return uniq[a].size() < uniq[b].size();
    return uniq[a] < uniq[b];
  });
  std::vector<uint32_t> rank(V);
  uint64_t o = 0;
  for (uint64_t r = 0; r < V; r++) {
    uint32_t tmp = order[r];
    rank[tmp] = (uint32_t)r;
    tok_lens[r] = (uint32_t)uniq[tmp].size();
    counts[r] = cnt[tmp];
    memcpy(blob + o, uniq[tmp].data(), uniq[tmp].size());
    o += uniq[tmp].size();
  }
  *blob_len_out = o;
  for (uint64_t i = cls; i < T; i += 2) ids[i] = rank[ids[i]];
  return V;
}

// Fused per-token entry-word gather for the HuffWord lockstep encode:
// out[i] = tbl[(i & 1) ^ flip][ids[i]] — replaces two boolean-mask numpy
// gathers (~1 s at 49M tokens) with one sequential pass.
void glz_gather_entries(const uint32_t* ids, uint64_t T, uint32_t flip,
                        const uint32_t* tbl0, const uint32_t* tbl1,
                        uint32_t* out) {
  const uint32_t* tbls[2] = {tbl0, tbl1};
  for (uint64_t i = 0; i < T; i++) out[i] = tbls[(i & 1) ^ flip][ids[i]];
}

// Decode-side: canonical rank -> token id through the parity dictionary's
// bucket-sorted symbol table (clamped for garbage ranks from corrupt
// payloads; the checksum catches those downstream).
void glz_map_ranks(const uint32_t* ranks, uint64_t T, uint32_t flip,
                   const int32_t* sym0, uint64_t n0,
                   const int32_t* sym1, uint64_t n1, uint32_t* out) {
  const int32_t* syms[2] = {sym0, sym1};
  const uint64_t ns[2] = {n0 ? n0 - 1 : 0, n1 ? n1 - 1 : 0};
  for (uint64_t i = 0; i < T; i++) {
    uint32_t d = (uint32_t)(i & 1) ^ flip;
    uint64_t r = ranks[i];
    if (r > ns[d]) r = ns[d];
    out[i] = (uint32_t)syms[d][r];
  }
}

}  // extern "C"
