// A zstd decoder (RFC 8878) and the CRC-32C, in plain C++ for the host.
//
// The port reads the JAX package's orbax checkpoints (utils/orbax.py)
// without orbax, tensorstore or a zstd module: their OCDBT manifests and
// B+tree nodes and their zarr chunks are zstd frames, and the manifests and
// nodes end in a CRC-32C.  This library decodes:
//   - frames, concatenated, skippable frames among them, with and without a
//     content size, with the xxh64 content checksum checked when present;
//   - raw, RLE and compressed blocks;
//   - literals raw, RLE, Huffman-coded in 1 or 4 streams (the tree given
//     directly or FSE-coded) and treeless (the previous block's tree);
//   - sequences with predefined, RLE, FSE-coded and repeated tables, repeat
//     offsets, and matches reaching back over earlier blocks of the frame.
// Dictionaries are out of scope: a frame that names one is refused.  Every
// read is bounds-checked; malformed input fails with a message and the
// offset into the input where it was found, and nothing is read outside
// the input.  Built with g++ at first use (utils/zstd.py); plain C entry
// points for ctypes.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  size_t offset;
  std::string what;
};

[[noreturn]] void fail(size_t offset, const std::string& what) {
  throw Error{offset, what};
}

constexpr size_t BLOCK_MAX = 128 * 1024;
constexpr uint32_t MAGIC = 0xFD2FB528u;

inline uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
         (uint32_t)p[3] << 24;
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---- xxh64 (the frame checksum) ----

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint64_t round64(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}
inline uint64_t merge64(uint64_t acc, uint64_t v) {
  return (acc ^ round64(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = round64(v1, le64(p));
      v2 = round64(v2, le64(p + 8));
      v3 = round64(v3, le64(p + 16));
      v4 = round64(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ round64(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t)le32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ *p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bit readers ----

// A view of bytes [base, base + n) of the input, `base` its offset there.
struct Span {
  const uint8_t* p;
  size_t n;
  size_t base;
};

// Bits lo .. lo + nb - 1 of a little-endian bit string of n bytes (nb <=
// 57), the bits outside [0, 8n) read as 0.
inline uint64_t bits_at(const Span& s, long long lo, int nb) {
  if (nb == 0) return 0;
  if (lo < 0) {
    const int have = (int)(lo + nb);
    return have <= 0 ? 0 : bits_at(s, 0, have) << (int)(-lo);
  }
  const size_t byte = (size_t)(lo >> 3);
  uint64_t v = 0;
  if (byte + 8 <= s.n) {
    std::memcpy(&v, s.p + byte, 8);
  } else {
    for (size_t i = 0; i < 8 && byte + i < s.n; ++i)
      v |= (uint64_t)s.p[byte + i] << (8 * i);
  }
  return (v >> (lo & 7)) & ((1ull << nb) - 1);
}

// The backward streams (Huffman literals, FSE weights, sequences): read from
// the last bit down, after the highest set bit of the last byte, which marks
// the end.  Bits below the start read as 0; `pos` then goes negative.
struct BackBits {
  Span s;
  long long pos;
  BackBits(const Span& span) : s(span) {
    if (s.n == 0) fail(s.base, "empty bitstream");
    const uint8_t last = s.p[s.n - 1];
    if (last == 0) fail(s.base + s.n - 1, "bitstream without its end mark");
    pos = (long long)(s.n - 1) * 8 + highbit(last);
  }
  uint64_t peek(int nb) const { return bits_at(s, pos - nb, nb); }
  uint64_t read(int nb) {
    const uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
  void expect_end(const char* what) const {
    if (pos != 0) fail(s.base, std::string(what) + " not consumed exactly");
  }
};

// ---- FSE ----

struct FseEntry {
  uint8_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool valid = false;
};

// Builds the decoding table of normalised counts norm[0..n) (-1: a
// "less than 1" probability) at accuracy `log`.
void fse_build(FseTable& table, const int16_t* norm, int n, int log,
               size_t off) {
  const int size = 1 << log;
  table.log = log;
  table.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(n);
  int high = size - 1;
  for (int s = 0; s < n; ++s) {
    if (norm[s] == -1) {
      table.t[high--].symbol = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      table.t[pos].symbol = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail(off, "FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    const int s = table.t[u].symbol;
    const int x = next[s]++;
    const int nb = log - highbit((uint32_t)x);
    table.t[u].bits = (uint8_t)nb;
    table.t[u].base = (uint16_t)((x << nb) - size);
  }
  table.valid = true;
}

// Reads an FSE table description from the front of `s`; returns the bytes
// it took.
size_t fse_read(FseTable& table, const Span& s, int max_log, int max_symbol) {
  const long long total = (long long)s.n * 8;
  long long pos = 0;
  auto read = [&](int nb) {
    const uint64_t v = bits_at(s, pos, nb);
    pos += nb;
    if (pos > total) fail(s.base, "truncated FSE table description");
    return v;
  };
  const int log = (int)read(4) + 5;
  if (log > max_log)
    fail(s.base, "FSE accuracy log " + std::to_string(log) + " above " +
                     std::to_string(max_log));
  int16_t norm[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  int symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int repeat;
      do {
        repeat = (int)read(2);
        for (int i = 0; i < repeat; ++i) {
          if (symbol > max_symbol) fail(s.base, "FSE symbol out of range");
          norm[symbol++] = 0;
        }
      } while (repeat == 3);
      if (symbol > max_symbol) break;
    }
    const int max = 2 * threshold - 1 - remaining;
    int count;
    const int low = (int)bits_at(s, pos, nb - 1);
    if (low < max) {
      count = low;
      read(nb - 1);
    } else {
      count = (int)read(nb);
      if (count >= threshold) count -= max;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = (int16_t)count;
    previous0 = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(s.base, "FSE distribution does not sum to 1");
  fse_build(table, norm, symbol, log, s.base);
  return (size_t)((pos + 7) / 8);
}

void fse_rle(FseTable& table, uint8_t symbol) {
  table.log = 0;
  table.t.assign(1, FseEntry{symbol, 0, 0});
  table.valid = true;
}

// ---- Huffman ----

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;  // by the max_bits-bit prefix
  bool valid = false;
};

// Reads a Huffman tree description from the front of `s`; returns the
// bytes it took.
size_t huf_read(HufTable& huf, const Span& s) {
  if (s.n < 1) fail(s.base, "truncated Huffman tree description");
  const int header = s.p[0];
  uint8_t weights[256];
  int n = 0;
  size_t used;
  if (header >= 128) {
    n = header - 127;
    used = 1 + (size_t)(n + 1) / 2;
    if (used > s.n) fail(s.base, "truncated Huffman weights");
    for (int i = 0; i < n; ++i) {
      const uint8_t b = s.p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    used = 1 + (size_t)header;
    if (header == 0 || used > s.n)
      fail(s.base, "truncated FSE-coded Huffman weights");
    const Span body{s.p + 1, (size_t)header, s.base + 1};
    FseTable table;
    const size_t head = fse_read(table, body, 6, 255);
    if (head >= body.n) fail(body.base, "Huffman weights without a stream");
    BackBits bits(Span{body.p + head, body.n - head, body.base + head});
    int st[2] = {(int)bits.read(table.log), (int)bits.read(table.log)};
    for (int k = 0;; k ^= 1) {
      if (n >= 255) fail(body.base, "too many Huffman weights");
      const FseEntry& e = table.t[st[k]];
      weights[n++] = e.symbol;
      st[k] = e.base + (int)bits.read(e.bits);
      if (bits.pos < 0) {
        if (n >= 255) fail(body.base, "too many Huffman weights");
        weights[n++] = table.t[st[k ^ 1]].symbol;
        break;
      }
    }
  }
  // the last symbol's weight completes the sum to a power of 2
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) {
    if (weights[i] > 12) fail(s.base, "Huffman weight above 12");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(s.base, "Huffman weights all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 12) fail(s.base, "Huffman code longer than 12 bits");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail(s.base, "Huffman weights do not complete");
  weights[n++] = (uint8_t)(highbit(rest) + 1);
  huf.max_bits = max_bits;
  huf.symbol.assign(1u << max_bits, 0);
  huf.bits.assign(1u << max_bits, 0);
  uint32_t start = 0;
  for (int w = 1; w <= max_bits; ++w) {
    const uint32_t len = 1u << (w - 1);
    for (int sym = 0; sym < n; ++sym) {
      if (weights[sym] != w) continue;
      for (uint32_t j = 0; j < len; ++j) {
        huf.symbol[start + j] = (uint8_t)sym;
        huf.bits[start + j] = (uint8_t)(max_bits + 1 - w);
      }
      start += len;
    }
  }
  if (start != (1u << max_bits)) fail(s.base, "Huffman table incomplete");
  huf.valid = true;
  return used;
}

void huf_stream(const HufTable& huf, const Span& s, uint8_t* out, size_t n) {
  BackBits bits(s);
  for (size_t i = 0; i < n; ++i) {
    const uint32_t k = (uint32_t)bits.peek(huf.max_bits);
    out[i] = huf.symbol[k];
    bits.pos -= huf.bits[k];
  }
  bits.expect_end("Huffman stream");
}

// ---- sequences ----

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,
    12, 13, 14, 15, 16, 18, 20,  22,  24,  28,  32,   40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  FseTable ll, of, ml;
  HufTable huf;
  uint64_t rep[3] = {1, 4, 8};
};

// Reads the table of one sequence field in `mode`; returns the bytes taken.
size_t seq_table(FseTable& table, int mode, const Span& s,
                 const int16_t* defaults, int n_defaults, int default_log,
                 int max_log, int max_symbol, const char* name) {
  switch (mode) {
    case 0:
      fse_build(table, defaults, n_defaults, default_log, s.base);
      return 0;
    case 1:
      if (s.n < 1) fail(s.base, std::string("truncated RLE ") + name);
      if (s.p[0] > max_symbol) fail(s.base, std::string(name) + " RLE symbol");
      fse_rle(table, s.p[0]);
      return 1;
    case 2:
      return fse_read(table, s, max_log, max_symbol);
    default:
      if (!table.valid)
        fail(s.base, std::string("repeated ") + name + " table without one");
      return 0;
  }
}

// ---- blocks and frames ----

// Decodes the literals section at the front of `s` into `lit`; returns the
// bytes it took.
size_t literals(FrameState& st, const Span& s, std::vector<uint8_t>& lit) {
  if (s.n < 1) fail(s.base, "truncated literals header");
  const uint8_t* p = s.p;
  const int type = p[0] & 3, format = (p[0] >> 2) & 3;
  if (type < 2) {
    size_t head, size;
    if ((format & 1) == 0) {
      head = 1;
      size = p[0] >> 3;
    } else if (format == 1) {
      head = 2;
      if (s.n < head) fail(s.base, "truncated literals header");
      size = (p[0] >> 4) + ((size_t)p[1] << 4);
    } else {
      head = 3;
      if (s.n < head) fail(s.base, "truncated literals header");
      size = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
    }
    if (size > BLOCK_MAX) fail(s.base, "literals above the block size");
    const size_t body = type == 0 ? size : 1;
    if (head + body > s.n) fail(s.base, "truncated literals");
    if (type == 0)
      lit.assign(p + head, p + head + size);
    else
      lit.assign(size, p[head]);
    return head + body;
  }
  size_t head, regen, comp;
  int streams = format == 0 ? 1 : 4;
  if (format < 2) {
    head = 3;
    if (s.n < head) fail(s.base, "truncated literals header");
    const uint32_t h = p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
    regen = (h >> 4) & 0x3FF;
    comp = (h >> 14) & 0x3FF;
  } else if (format == 2) {
    head = 4;
    if (s.n < head) fail(s.base, "truncated literals header");
    const uint32_t h = le32(p);
    regen = (h >> 4) & 0x3FFF;
    comp = (h >> 18) & 0x3FFF;
  } else {
    head = 5;
    if (s.n < head) fail(s.base, "truncated literals header");
    const uint64_t h = le32(p) | (uint64_t)p[4] << 32;
    regen = (h >> 4) & 0x3FFFF;
    comp = (h >> 22) & 0x3FFFF;
  }
  if (regen > BLOCK_MAX) fail(s.base, "literals above the block size");
  if (head + comp > s.n) fail(s.base, "truncated compressed literals");
  Span body{p + head, comp, s.base + head};
  if (type == 2) {
    const size_t tree = huf_read(st.huf, body);
    body = Span{body.p + tree, body.n - tree, body.base + tree};
  } else if (!st.huf.valid) {
    fail(s.base, "treeless literals without an earlier Huffman tree");
  }
  lit.resize(regen);
  if (streams == 1) {
    huf_stream(st.huf, body, lit.data(), regen);
  } else {
    if (body.n < 6) fail(body.base, "truncated literals jump table");
    size_t sizes[4] = {(size_t)(body.p[0] | body.p[1] << 8),
                       (size_t)(body.p[2] | body.p[3] << 8),
                       (size_t)(body.p[4] | body.p[5] << 8), 0};
    const size_t used = 6 + sizes[0] + sizes[1] + sizes[2];
    if (used > body.n) fail(body.base, "literals jump table past the end");
    sizes[3] = body.n - used;
    const size_t part = (regen + 3) / 4;
    if (3 * part > regen) fail(body.base, "too few literals for 4 streams");
    size_t at = 6, out = 0;
    for (int k = 0; k < 4; ++k) {
      const size_t len = k < 3 ? part : regen - 3 * part;
      huf_stream(st.huf, Span{body.p + at, sizes[k], body.base + at},
                 lit.data() + out, len);
      at += sizes[k];
      out += len;
    }
  }
  return head + comp;
}

void compressed_block(FrameState& st, const Span& s, std::vector<uint8_t>& out,
                      size_t frame_start) {
  std::vector<uint8_t> lit;
  size_t at = literals(st, s, lit);
  if (at >= s.n) fail(s.base + at, "truncated sequences header");
  const uint8_t* p = s.p;
  size_t nseq = p[at];
  if (nseq < 128) {
    at += 1;
  } else if (nseq < 255) {
    if (at + 2 > s.n) fail(s.base + at, "truncated sequences header");
    nseq = ((nseq - 128) << 8) + p[at + 1];
    at += 2;
  } else {
    if (at + 3 > s.n) fail(s.base + at, "truncated sequences header");
    nseq = p[at + 1] + ((size_t)p[at + 2] << 8) + 0x7F00;
    at += 3;
  }
  const size_t block_start = out.size();
  size_t lit_at = 0;
  if (nseq > 0) {
    if (at >= s.n) fail(s.base + at, "truncated sequence modes");
    const uint8_t modes = p[at++];
    if (modes & 3) fail(s.base + at - 1, "reserved sequence mode bits set");
    auto rest = [&]() { return Span{p + at, s.n - at, s.base + at}; };
    at += seq_table(st.ll, modes >> 6, rest(), LL_DEFAULT, 36, 6, 9, 35,
                    "literal length");
    at += seq_table(st.of, (modes >> 4) & 3, rest(), OF_DEFAULT, 29, 5, 8, 31,
                    "offset");
    at += seq_table(st.ml, (modes >> 2) & 3, rest(), ML_DEFAULT, 53, 6, 9, 52,
                    "match length");
    if (at >= s.n) fail(s.base + at, "sequences without a bitstream");
    BackBits bits(rest());
    uint32_t sl = (uint32_t)bits.read(st.ll.log);
    uint32_t so = (uint32_t)bits.read(st.of.log);
    uint32_t sm = (uint32_t)bits.read(st.ml.log);
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry& el = st.ll.t[sl];
      const FseEntry& eo = st.of.t[so];
      const FseEntry& em = st.ml.t[sm];
      if (el.symbol > 35 || em.symbol > 52 || eo.symbol > 31)
        fail(bits.s.base, "sequence code out of range");
      const uint64_t ov = (1ull << eo.symbol) + bits.read(eo.symbol);
      const size_t ml = ML_BASE[em.symbol] + (size_t)bits.read(ML_BITS[em.symbol]);
      const size_t ll = LL_BASE[el.symbol] + (size_t)bits.read(LL_BITS[el.symbol]);
      if (i + 1 < nseq) {
        sl = el.base + (uint32_t)bits.read(el.bits);
        sm = em.base + (uint32_t)bits.read(em.bits);
        so = eo.base + (uint32_t)bits.read(eo.bits);
      }
      uint64_t offset;
      if (ov > 3) {
        offset = ov - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      } else {
        const int idx = (int)ov - 1 + (ll == 0);
        if (idx == 0) {
          offset = st.rep[0];
        } else {
          offset = idx == 3 ? st.rep[0] - 1 : st.rep[idx];
          if (idx > 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = offset;
        }
      }
      if (ll > lit.size() - lit_at)
        fail(bits.s.base, "sequence takes more literals than decoded");
      out.insert(out.end(), lit.begin() + lit_at, lit.begin() + lit_at + ll);
      lit_at += ll;
      if (offset == 0 || offset > out.size() - frame_start)
        fail(bits.s.base, "match offset before the frame's start");
      if (out.size() - block_start + ml > BLOCK_MAX)
        fail(bits.s.base, "block decodes above the block size");
      const size_t o = out.size();
      out.resize(o + ml);
      uint8_t* d = out.data();
      if (offset >= ml) {
        std::memcpy(d + o, d + o - offset, ml);
      } else {
        for (size_t j = 0; j < ml; ++j) d[o + j] = d[o + j - offset];
      }
    }
    bits.expect_end("sequence bitstream");
  } else if (at != s.n) {
    fail(s.base + at, "bytes after a block without sequences");
  }
  out.insert(out.end(), lit.begin() + lit_at, lit.end());
  if (out.size() - block_start > BLOCK_MAX)
    fail(s.base, "block decodes above the block size");
}

// Decodes one frame at `at` (its magic already checked); returns the
// offset after it.
size_t frame(const uint8_t* src, size_t n, size_t at,
             std::vector<uint8_t>& out) {
  const size_t start = at;
  at += 4;
  if (at >= n) fail(at, "truncated frame header");
  const uint8_t desc = src[at++];
  const int fcs_flag = desc >> 6, single = (desc >> 5) & 1;
  const int checksum = (desc >> 2) & 1, dict_flag = desc & 3;
  if (desc & 8) fail(at - 1, "reserved frame header bit set");
  uint64_t window = 0;
  if (!single) {
    if (at >= n) fail(at, "truncated frame header");
    const uint8_t wd = src[at++];
    const uint64_t base = 1ull << (10 + (wd >> 3));
    window = base + (base >> 3) * (wd & 7);
  }
  const int dict_bytes[4] = {0, 1, 2, 4};
  if (at + dict_bytes[dict_flag] > n) fail(at, "truncated frame header");
  uint32_t dict = 0;
  for (int i = 0; i < dict_bytes[dict_flag]; ++i)
    dict |= (uint32_t)src[at + i] << (8 * i);
  if (dict != 0)
    fail(at, "frame needs dictionary " + std::to_string(dict) +
                 "; dictionaries are not supported");
  at += dict_bytes[dict_flag];
  const int fcs_bytes[4] = {single ? 1 : 0, 2, 4, 8};
  const int nf = fcs_bytes[fcs_flag];
  if (at + nf > n) fail(at, "truncated frame header");
  uint64_t fcs = 0;
  for (int i = 0; i < nf; ++i) fcs |= (uint64_t)src[at + i] << (8 * i);
  if (nf == 2) fcs += 256;
  at += nf;
  if (single) window = fcs;
  (void)window;
  const size_t frame_start = out.size();
  if (nf && fcs < (1ull << 30)) out.reserve(frame_start + (size_t)fcs);
  FrameState st;
  for (bool last = false; !last;) {
    if (at + 3 > n) fail(at, "truncated block header");
    const uint32_t h = src[at] | src[at + 1] << 8 | src[at + 2] << 16;
    const size_t head = at;
    at += 3;
    last = h & 1;
    const int type = (h >> 1) & 3;
    const size_t size = h >> 3;
    if (type == 3) fail(head, "reserved block type");
    if (size > BLOCK_MAX) fail(head, "block above the block size");
    if (type == 1) {
      if (at + 1 > n) fail(at, "truncated RLE block");
      out.insert(out.end(), size, src[at]);
      at += 1;
    } else {
      if (at + size > n) fail(at, "truncated block");
      if (type == 0)
        out.insert(out.end(), src + at, src + at + size);
      else
        compressed_block(st, Span{src + at, size, at}, out, frame_start);
      at += size;
    }
  }
  const size_t produced = out.size() - frame_start;
  if (nf && produced != fcs)
    fail(start, "frame decodes to " + std::to_string(produced) +
                    " bytes, its header says " + std::to_string(fcs));
  if (checksum) {
    if (at + 4 > n) fail(at, "truncated frame checksum");
    const uint32_t want = le32(src + at);
    const uint32_t got =
        (uint32_t)xxh64(out.data() + frame_start, produced, 0);
    if (want != got) fail(at, "frame checksum mismatch");
    at += 4;
  }
  return at;
}

void decompress(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  if (n == 0) fail(0, "no zstd frame");
  size_t at = 0;
  while (at < n) {
    if (at + 4 > n) fail(at, "truncated frame magic");
    const uint32_t magic = le32(src + at);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (at + 8 > n) fail(at, "truncated skippable frame");
      const uint64_t size = le32(src + at + 4);
      if (size > n - at - 8) fail(at, "truncated skippable frame");
      at += 8 + (size_t)size;
    } else if (magic == MAGIC) {
      at = frame(src, n, at, out);
    } else {
      fail(at, "not a zstd frame");
    }
  }
}

struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[i] = c;
    }
  }
};

}  // namespace

// Decodes all frames of src[0:n].  On success returns a malloc'd buffer of
// *out_len bytes (free it with tszstd_free; null for 0 bytes); on failure
// returns null, sets *err_off to the input offset and writes the message
// (NUL-terminated, cut to err_cap) to err.
extern "C" void* tszstd_decompress(const void* src, long long n,
                                   long long* out_len, long long* err_off,
                                   char* err, long long err_cap) {
  *out_len = 0;
  *err_off = -1;
  if (err_cap > 0) err[0] = 0;
  try {
    std::vector<uint8_t> out;
    decompress((const uint8_t*)src, (size_t)n, out);
    *out_len = (long long)out.size();
    if (out.empty()) return nullptr;
    void* buf = std::malloc(out.size());
    if (!buf) fail(0, "out of memory");
    std::memcpy(buf, out.data(), out.size());
    return buf;
  } catch (const Error& e) {
    *err_off = (long long)e.offset;
    if (err_cap > 0) {
      std::strncpy(err, e.what.c_str(), (size_t)err_cap - 1);
      err[err_cap - 1] = 0;
    }
  } catch (const std::bad_alloc&) {
    *err_off = 0;
    if (err_cap > 0) {
      std::strncpy(err, "out of memory", (size_t)err_cap - 1);
      err[err_cap - 1] = 0;
    }
  }
  return nullptr;
}

extern "C" void tszstd_free(void* p) { std::free(p); }

// The CRC-32C (Castagnoli) of data[0:n].
extern "C" uint32_t tszstd_crc32c(const void* data, long long n) {
  static const CrcTable table;  // built once, thread-safe
  const uint8_t* p = (const uint8_t*)data;
  uint32_t c = 0xFFFFFFFFu;
  for (long long i = 0; i < n; ++i) c = table.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

