// clair3_tpu_torch native bzip2 decoder (decode-only).
//
// Serves two CRAM needs with one codec (the reference gets both from
// htslib/libbz2, reference README.md:127):
//   * CRAM block compression method 2 (bzip2), clair3t_cram.cc
//   * the adaptive-arithmetic codec's EXT transform, which IS bzip2
//     (clair3t_arith.cc F_EXT; behavioral oracle io/arith.py:320-323)
//
// Self-contained implementation of the bzip2 stream format: stream header
// "BZh1".."BZh9", per-block 48-bit magics, symbol-map + MTF/RLE2 Huffman
// stage (2..6 group tables, 50-symbol selector runs), inverse
// Burrows-Wheeler transform via the classic cftab/tt walk, and the final
// RLE1 (4-equal-bytes + count) expansion.  CRCs are validated (block and
// stream) since archival CRAM is exactly where silent corruption matters.
// The Python twin/oracle is the stdlib `bz2` module (differential:
// tests/test_native_cram.py).

#include "common.h"

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int MAX_GROUPS = 6;
constexpr int MAX_ALPHA = 258;  // nInUse(<=256) + 2 run symbols
constexpr int GROUP_SIZE = 50;

struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;   // byte position
  int bit = 0;      // bits consumed of d[pos] (MSB first)
  bool fail = false;

  uint32_t get(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; i++) {
      if (pos >= n) {
        fail = true;
        return 0;
      }
      v = (v << 1) | ((d[pos] >> (7 - bit)) & 1);
      if (++bit == 8) {
        bit = 0;
        pos++;
      }
    }
    return v;
  }
};

struct HuffTable {
  // canonical limit/base/perm decode (the libbzip2 scheme)
  int32_t limit[24];
  int32_t base[24];
  int32_t perm[MAX_ALPHA];
  int min_len;
};

void build_table(const uint8_t* lens, int n_sym, HuffTable* t) {
  int min_len = 32, max_len = 0;
  for (int i = 0; i < n_sym; i++) {
    if (lens[i] < min_len) min_len = lens[i];
    if (lens[i] > max_len) max_len = lens[i];
  }
  t->min_len = min_len;
  int pp = 0;
  for (int l = min_len; l <= max_len; l++)
    for (int i = 0; i < n_sym; i++)
      if (lens[i] == l) t->perm[pp++] = i;
  int32_t count[24] = {0};
  for (int i = 0; i < n_sym; i++) count[lens[i] + 1]++;
  for (int l = 1; l < 24; l++) count[l] += count[l - 1];
  int32_t vec = 0;
  for (int l = min_len; l <= max_len; l++) {
    vec += count[l + 1] - count[l];
    t->limit[l] = vec - 1;
    vec <<= 1;
  }
  for (int l = min_len + 1; l <= max_len; l++)
    t->base[l] = ((t->limit[l - 1] + 1) << 1) - count[l];
  for (int l = max_len + 1; l < 24; l++) t->limit[l] = 0x7fffffff;
  t->base[min_len] = 0;
}

int huff_decode(BitReader& br, const HuffTable& t, int n_sym) {
  int l = t.min_len;
  int32_t v = (int32_t)br.get(l);
  while (!br.fail) {
    if (l > 23) return -1;
    if (v <= t.limit[l]) {
      int32_t idx = v - t.base[l];
      // corrupt streams can drive the index anywhere: bound it
      if (idx < 0 || idx >= n_sym) return -1;
      return t.perm[idx];
    }
    v = (v << 1) | (int32_t)br.get(1);
    l++;
  }
  return -1;
}

uint32_t crc32_bz(uint32_t crc, const uint8_t* p, size_t n) {
  // bzip2 uses the MSB-first (big-endian bit order) CRC-32 variant
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i << 24;
      for (int k = 0; k < 8; k++)
        c = (c & 0x80000000u) ? (c << 1) ^ 0x04c11db7u : (c << 1);
      table[i] = c;
    }
    init = true;
  }
  for (size_t i = 0; i < n; i++)
    crc = (crc << 8) ^ table[((crc >> 24) ^ p[i]) & 0xff];
  return crc;
}

// one block's Huffman+MTF+RLE2 stage into the BWT buffer; returns length
// or -1
int64_t decode_block_symbols(BitReader& br, int block_max,
                             std::vector<uint8_t>& bwt, uint32_t* orig_ptr) {
  *orig_ptr = br.get(24);

  // symbol map
  uint8_t in_use[256] = {0};
  uint16_t used16 = (uint16_t)br.get(16);
  for (int i = 0; i < 16; i++) {
    if (used16 & (0x8000u >> i)) {
      uint16_t m = (uint16_t)br.get(16);
      for (int j = 0; j < 16; j++)
        if (m & (0x8000u >> j)) in_use[i * 16 + j] = 1;
    }
  }
  uint8_t seq_to_unseq[256];
  int n_in_use = 0;
  for (int i = 0; i < 256; i++)
    if (in_use[i]) seq_to_unseq[n_in_use++] = (uint8_t)i;
  if (n_in_use == 0 || br.fail) return -1;
  int alpha = n_in_use + 2;

  int n_groups = (int)br.get(3);
  if (n_groups < 2 || n_groups > MAX_GROUPS) return -1;
  int n_selectors = (int)br.get(15);
  if (n_selectors < 1 || n_selectors > 32767) return -1;

  // selectors, MTF over group ids
  std::vector<uint8_t> selectors(n_selectors);
  {
    uint8_t pos[MAX_GROUPS];
    for (int i = 0; i < n_groups; i++) pos[i] = (uint8_t)i;
    for (int s = 0; s < n_selectors; s++) {
      int j = 0;
      while (br.get(1)) {
        if (++j >= n_groups || br.fail) return -1;
      }
      uint8_t tmp = pos[j];
      while (j > 0) {
        pos[j] = pos[j - 1];
        j--;
      }
      pos[0] = tmp;
      selectors[s] = tmp;
    }
  }

  // per-group delta-coded code lengths + tables
  HuffTable tables[MAX_GROUPS];
  {
    uint8_t lens[MAX_ALPHA];
    for (int g = 0; g < n_groups; g++) {
      int cur = (int)br.get(5);
      for (int s = 0; s < alpha; s++) {
        for (;;) {
          if (cur < 1 || cur > 20 || br.fail) return -1;
          if (!br.get(1)) break;
          cur += br.get(1) ? -1 : 1;
        }
        lens[s] = (uint8_t)cur;
      }
      build_table(lens, alpha, &tables[g]);
    }
  }

  // MTF/RLE2 decode
  uint8_t mtf[256];
  for (int i = 0; i < n_in_use; i++) mtf[i] = seq_to_unseq[i];
  int eob = alpha - 1;
  int group_pos = 0, group_no = -1;
  const HuffTable* gt = nullptr;
  int64_t nblock = 0;
  int64_t run = 0;
  int run_bit = 0;
  bwt.clear();
  bwt.reserve(block_max);
  auto next_sym = [&]() -> int {
    if (group_pos == 0) {
      if (++group_no >= n_selectors) return -2;
      group_pos = GROUP_SIZE;
      gt = &tables[selectors[group_no]];
    }
    group_pos--;
    return huff_decode(br, *gt, alpha);
  };
  for (;;) {
    int sym = next_sym();
    if (sym < 0) return -1;
    if (sym <= 1) {  // RUNA / RUNB: bijective base-2 run length
      run += (int64_t)(sym + 1) << run_bit;
      run_bit++;
      continue;
    }
    if (run > 0) {
      if (nblock + run > block_max) return -1;
      uint8_t b = mtf[0];
      for (int64_t i = 0; i < run; i++) bwt.push_back(b);
      nblock += run;
      run = 0;
      run_bit = 0;
    }
    if (sym == eob) break;
    // MTF lookup: value at index sym-1 moves to front
    int j = sym - 1;
    if (j >= n_in_use) return -1;
    uint8_t b = mtf[j];
    memmove(mtf + 1, mtf, j);
    mtf[0] = b;
    if (nblock + 1 > block_max) return -1;
    bwt.push_back(b);
    nblock++;
  }
  if (br.fail || *orig_ptr >= (uint32_t)nblock) return -1;
  return nblock;
}

// inverse BWT + RLE1 straight into `out`
bool ibwt_rle1(const std::vector<uint8_t>& bwt, uint32_t orig_ptr,
               std::vector<uint8_t>& out, uint32_t* block_crc) {
  int64_t n = (int64_t)bwt.size();
  int64_t cftab[257] = {0};
  for (int64_t i = 0; i < n; i++) cftab[bwt[i] + 1]++;
  for (int i = 1; i <= 256; i++) cftab[i] += cftab[i - 1];
  std::vector<uint32_t> tt(n);
  {
    int64_t c[256];
    memcpy(c, cftab, sizeof(int64_t) * 256);
    for (int64_t i = 0; i < n; i++) tt[c[bwt[i]]++] = (uint32_t)i;
  }
  uint32_t p = tt[orig_ptr];
  uint32_t crc = 0xffffffffu;
  int run_count = 0;
  int last = -1;
  for (int64_t i = 0; i < n; i++) {
    uint8_t b = bwt[p];
    p = tt[p];
    if (run_count == 4) {
      // RLE1: the byte after 4 equal bytes is an extra repeat count
      for (int k = 0; k < b; k++) out.push_back((uint8_t)last);
      if (b) crc = crc32_bz(crc, &out[out.size() - b], b);
      run_count = 0;
      last = -1;
      continue;
    }
    run_count = (b == last) ? run_count + 1 : 1;
    last = b;
    out.push_back(b);
    crc = crc32_bz(crc, &b, 1);
  }
  *block_crc = ~crc;
  return true;
}

}  // namespace

// Decode a complete bzip2 stream (possibly multi-block).  Returns the
// decompressed size, or -1 on any structural/CRC error (callers fall back
// to the Python oracle).  `out`/`out_cap`: caller-provided buffer; pass
// out=nullptr to size-probe? No — CRAM blocks carry raw_size, so the
// caller always knows the capacity.
extern "C" int64_t clair3t_bzip2_decode(const uint8_t* data, int64_t n,
                                        uint8_t* out, int64_t out_cap) {
  if (n < 10 || data[0] != 'B' || data[1] != 'Z' || data[2] != 'h') return -1;
  int level = data[3] - '0';
  if (level < 1 || level > 9) return -1;
  int block_max = level * 100000 + 10;  // +10: RLE2 runs may spill slightly

  BitReader br{data, (size_t)n};
  br.get(32);  // skip "BZh?" (already validated)

  std::vector<uint8_t> result;
  result.reserve((size_t)out_cap);
  std::vector<uint8_t> bwt;
  uint32_t stream_crc = 0;
  for (;;) {
    uint64_t magic = ((uint64_t)br.get(24) << 24) | br.get(24);
    if (br.fail) return -1;
    if (magic == 0x177245385090ull) {  // stream end
      uint32_t want = br.get(32);
      if (br.fail || stream_crc != want) return -1;
      break;
    }
    if (magic != 0x314159265359ull) return -1;
    uint32_t want_crc = br.get(32);
    if (br.get(1)) return -1;  // "randomized" blocks are long-deprecated
    uint32_t orig_ptr;
    int64_t nblock = decode_block_symbols(br, block_max, bwt, &orig_ptr);
    if (nblock < 0) return -1;
    uint32_t got_crc;
    if (!ibwt_rle1(bwt, orig_ptr, result, &got_crc)) return -1;
    if (got_crc != want_crc) return -1;
    if ((int64_t)result.size() > out_cap) return -1;
    stream_crc = ((stream_crc << 1) | (stream_crc >> 31)) ^ got_crc;
  }
  if ((int64_t)result.size() > out_cap) return -1;
  memcpy(out, result.data(), result.size());
  return (int64_t)result.size();
}
