// rANS 4x8 decoder (CRAM 3.0 block method 4) — native fast path for
// io/rans.py (the Python implementation is the oracle; differential tests
// in tests/test_cram.py).  Layout documented in io/rans.py.

#include <cstdint>
#include <cstring>

namespace {

const uint32_t RANS_L = 1u << 23;
const int TF_SHIFT = 12;
const uint32_t TOTFREQ = 1u << TF_SHIFT;

struct FreqTable {
  uint32_t F[256];
  uint32_t C[257];
  uint8_t sym[1u << TF_SHIFT];
};

// RLE frequency table (io/rans.py:_read_freq_table)
bool read_freq_table(const uint8_t* data, size_t len, size_t* p_io,
                     FreqTable* t) {
  memset(t->F, 0, sizeof t->F);
  size_t p = *p_io;
  if (p >= len) return false;
  int j = data[p++];
  int rle = 0;
  while (true) {
    if (p >= len) return false;
    uint32_t f = data[p];
    if (f >= 128) {
      if (p + 1 >= len) return false;
      f = ((f & 0x7F) << 8) | data[p + 1];
      p += 2;
    } else {
      p += 1;
    }
    t->F[j] = f;
    if (rle) {
      rle--;
      j++;
    } else {
      if (p >= len) return false;
      int nxt = data[p];
      if (nxt == j + 1) {
        j = nxt;
        p++;
        if (p >= len) return false;
        rle = data[p++];
      } else {
        j = nxt;
        p++;
      }
    }
    if (j == 0) break;
  }
  t->C[0] = 0;
  for (int s = 0; s < 256; s++) t->C[s + 1] = t->C[s] + t->F[s];
  if (t->C[256] > TOTFREQ) return false;
  for (int s = 0; s < 256; s++)
    for (uint32_t k = 0; k < t->F[s]; k++) t->sym[t->C[s] + k] = (uint8_t)s;
  *p_io = p;
  return true;
}

inline uint32_t read_u32(const uint8_t* d) {
  uint32_t v;
  memcpy(&v, d, 4);
  return v;
}

int decode_o0(const uint8_t* data, size_t len, uint8_t* out, size_t out_sz) {
  size_t p = 0;
  static thread_local FreqTable t;
  if (!read_freq_table(data, len, &p, &t)) return 1;
  if (p + 16 > len) return 1;
  uint32_t st[4];
  for (int k = 0; k < 4; k++) st[k] = read_u32(data + p + 4 * k);
  p += 16;
  for (size_t i = 0; i < out_sz; i++) {
    uint32_t& x = st[i & 3];
    uint32_t slot = x & (TOTFREQ - 1);
    uint8_t s = t.sym[slot];
    out[i] = s;
    x = t.F[s] * (x >> TF_SHIFT) + slot - t.C[s];
    while (x < RANS_L && p < len) x = (x << 8) | data[p++];
  }
  return 0;
}

int decode_o1(const uint8_t* data, size_t len, uint8_t* out, size_t out_sz) {
  size_t p = 0;
  if (p >= len) return 1;
  // context tables, allocated lazily (256 x ~5KB = 1.3MB worst case)
  static thread_local FreqTable* tabs = nullptr;
  if (!tabs) tabs = new FreqTable[256];
  bool present[256] = {false};
  int ctx = data[p++];
  int rle = 0;
  while (true) {
    if (!read_freq_table(data, len, &p, &tabs[ctx])) return 1;
    present[ctx] = true;
    if (rle) {
      rle--;
      ctx++;
    } else {
      if (p >= len) return 1;
      int nxt = data[p];
      if (nxt == ctx + 1) {
        ctx = nxt;
        p++;
        if (p >= len) return 1;
        rle = data[p++];
      } else {
        ctx = nxt;
        p++;
      }
    }
    if (ctx == 0) break;
  }
  if (p + 16 > len) return 1;
  uint32_t st[4];
  for (int k = 0; k < 4; k++) st[k] = read_u32(data + p + 4 * k);
  p += 16;
  size_t isz4 = out_sz >> 2;
  size_t pos[4] = {0, isz4, 2 * isz4, 3 * isz4};
  uint8_t last[4] = {0, 0, 0, 0};

  auto step = [&](int q) -> bool {
    FreqTable& t = tabs[last[q]];
    if (!present[last[q]]) return false;
    uint32_t& x = st[q];
    uint32_t slot = x & (TOTFREQ - 1);
    uint8_t s = t.sym[slot];
    out[pos[q]] = s;
    x = t.F[s] * (x >> TF_SHIFT) + slot - t.C[s];
    while (x < RANS_L && p < len) x = (x << 8) | data[p++];
    last[q] = s;
    pos[q]++;
    return true;
  };

  for (size_t i = 0; i < isz4; i++)
    for (int q = 0; q < 4; q++)
      if (!step(q)) return 1;
  while (pos[3] < out_sz)
    if (!step(3)) return 1;
  return 0;
}

}  // namespace

extern "C" {

// payload: order byte + comp_sz u32 + out_sz u32 + stream.
// out must hold out_sz bytes (caller reads sizes first). Returns 0 on ok.
int clair3t_rans_decode(const uint8_t* payload, int64_t payload_len,
                        uint8_t* out, int64_t out_sz) {
  if (payload_len < 9) return 1;
  uint8_t order = payload[0];
  uint32_t comp_sz = read_u32(payload + 1);
  uint32_t raw_sz = read_u32(payload + 5);
  if ((int64_t)raw_sz != out_sz) return 1;
  if (out_sz == 0) return 0;
  if (9 + (int64_t)comp_sz > payload_len) return 1;
  const uint8_t* data = payload + 9;
  if (order == 0) return decode_o0(data, comp_sz, out, (size_t)out_sz);
  if (order == 1) return decode_o1(data, comp_sz, out, (size_t)out_sz);
  return 1;
}

}  // extern "C"

#include "inflate.h"

extern "C" {

// Raw-DEFLATE decode (test/interop hook for the fast BGZF inflate path,
// inflate.h). Returns 1 on success, 0 on structural failure.
int clair3t_raw_inflate(const uint8_t* in, int64_t in_len,
                        uint8_t* out, int64_t out_len) {
  return c3t_inflate::raw_inflate(in, (size_t)in_len, out, (size_t)out_len)
             ? 1 : 0;
}

}  // extern "C"
