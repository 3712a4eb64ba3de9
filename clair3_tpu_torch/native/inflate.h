// Fast raw-DEFLATE decoder for BGZF blocks (clair3_tpu_torch native IO hot path).
//
// BGZF gives us (compressed bytes, exact uncompressed size) per 64 KiB
// block, which permits a simpler and faster decoder than zlib's streaming
// inflate: a 64-bit lookahead bit buffer refilled with one unaligned 8-byte
// load, two-level Huffman tables whose entries carry the fully decoded
// action (literal byte / length base + extra-bit count / distance base),
// and 8-byte chunked match copies.  Any structural error returns false and
// the caller falls back to zlib (inflate_blocks_parallel in common.h), so
// this path never silently produces wrong output: the final position checks
// guarantee exactly out_len bytes were produced from within the input.
//
// Reference semantics: RFC 1951.  (The reference toolchain links htslib's
// zlib path; this replaces it for speed, differential-tested against zlib
// in tests/test_native_inflate.py.)

#ifndef CLAIR3T_INFLATE_H_
#define CLAIR3T_INFLATE_H_

#include <cstdint>
#include <cstring>

namespace c3t_inflate {

constexpr int kLitlenBits = 10;   // primary table bits
constexpr int kDistBits = 8;
constexpr int kMaxCodeLen = 15;

// Entry layout (uint32):
//   bits 0-5   total code length in bits
//   bit 31     literal        -> byte at bits 8-15
//   bit 30     length symbol  -> base at bits 8-16, extra-bit count 17-21
//   bit 29     end of block
//   bit 28     subtable ptr   -> offset bits 8-23, subtable bits 24-27
//   0          invalid
// Distance entries: base at bits 8-22, extra-bit count at 23-27 (no flag);
// SUB/invalid encodings shared.
constexpr uint32_t kLit = 1u << 31;
constexpr uint32_t kLen = 1u << 30;
constexpr uint32_t kEob = 1u << 29;
constexpr uint32_t kSub = 1u << 28;

struct HuffTable {
  uint32_t primary[1 << kLitlenBits];
  uint32_t sub[1 << kMaxCodeLen];
  int table_bits;
};

static const uint16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t kLenExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
    8193, 12289, 16385, 24577};
static const uint8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

enum class Kind { Litlen, Dist, CodeLen };

inline uint32_t make_payload(Kind kind, int sym) {
  switch (kind) {
    case Kind::Litlen:
      if (sym < 256) return kLit | ((uint32_t)sym << 8);
      if (sym == 256) return kEob;
      if (sym <= 285)
        return kLen | ((uint32_t)kLenBase[sym - 257] << 8)
                    | ((uint32_t)kLenExtra[sym - 257] << 17);
      return 0;  // 286/287: reserved, invalid on use
    case Kind::Dist:
      if (sym < 30)
        return ((uint32_t)kDistBase[sym] << 8)
               | ((uint32_t)kDistExtra[sym] << 23);
      return 0;  // 30/31 reserved
    case Kind::CodeLen:
    default:
      return (uint32_t)sym << 8;  // raw symbol
  }
}

inline uint32_t rev_bits(uint32_t v, int n) {
  // byte-table reverse, composed
  static const uint8_t R[16] = {0x0, 0x8, 0x4, 0xC, 0x2, 0xA, 0x6, 0xE,
                                0x1, 0x9, 0x5, 0xD, 0x3, 0xB, 0x7, 0xF};
  uint32_t r = (uint32_t)R[v & 15] << 12 | (uint32_t)R[(v >> 4) & 15] << 8 |
               (uint32_t)R[(v >> 8) & 15] << 4 | (uint32_t)R[(v >> 12) & 15];
  return r >> (16 - n);
}

// Build a canonical-Huffman decode table from code lengths.
inline bool build_table(HuffTable* t, const uint8_t* lens, int n,
                        int table_bits, Kind kind,
                        bool allow_incomplete = false) {
  t->table_bits = table_bits;
  int count[kMaxCodeLen + 1] = {0};
  for (int i = 0; i < n; i++) count[lens[i]]++;
  count[0] = 0;
  int total = 0, max_len = 0;
  uint32_t left = 1;
  for (int l = 1; l <= kMaxCodeLen; l++) {
    left <<= 1;
    if ((uint32_t)count[l] > left) return false;  // oversubscribed
    left -= count[l];
    if (count[l]) max_len = l;
    total += count[l];
  }
  const uint32_t table_size = 1u << table_bits;
  if (total == 0) {
    memset(t->primary, 0, table_size * sizeof(uint32_t));
    return true;
  }
  if (total == 1) {
    // single symbol: any bit pattern decodes it, consuming 1 bit
    int sym = 0;
    for (int i = 0; i < n; i++)
      if (lens[i]) { sym = i; break; }
    uint32_t entry = make_payload(kind, sym) | 1u;
    if (!(entry & ~0x3Fu) && kind != Kind::CodeLen) entry = 0;  // reserved sym
    for (uint32_t i = 0; i < table_size; i++) t->primary[i] = entry;
    return true;
  }
  // incomplete codes: some encoders emit under-subscribed distance codes;
  // unfilled slots stay invalid and only error on use
  if (left != 0 && !allow_incomplete) return false;

  uint32_t code = 0;
  uint32_t first_code[kMaxCodeLen + 1];
  int offs[kMaxCodeLen + 1];
  int sym_count = 0;
  for (int l = 1; l <= kMaxCodeLen; l++) {
    first_code[l] = code;
    offs[l] = sym_count;
    code = (code + count[l]) << 1;
    sym_count += count[l];
  }
  static thread_local uint16_t sorted[288 + 32];
  {
    int pos[kMaxCodeLen + 1];
    memcpy(pos, offs, sizeof(pos));
    for (int i = 0; i < n; i++)
      if (lens[i]) sorted[pos[lens[i]]++] = (uint16_t)i;
  }

  memset(t->primary, 0, table_size * sizeof(uint32_t));

  if (max_len <= table_bits) {
    for (int idx = 0; idx < sym_count; idx++) {
      int sym = sorted[idx];
      int l = lens[sym];
      uint32_t c = first_code[l] + (uint32_t)(idx - offs[l]);
      uint32_t rc = rev_bits(c, l);
      uint32_t entry = make_payload(kind, sym) | (uint32_t)l;
      if (!(entry & ~0x3Fu) && kind != Kind::CodeLen) entry = 0;  // reserved
      for (uint32_t j = rc; j < table_size; j += 1u << l) t->primary[j] = entry;
    }
    return true;
  }

  // long codes: subtables keyed by the primary index
  static thread_local uint8_t slot_max[1 << kLitlenBits];
  memset(slot_max, 0, table_size);
  for (int idx = 0; idx < sym_count; idx++) {
    int sym = sorted[idx];
    int l = lens[sym];
    if (l <= table_bits) continue;
    uint32_t rc = rev_bits(first_code[l] + (uint32_t)(idx - offs[l]), l);
    uint32_t slot = rc & (table_size - 1);
    if (l > slot_max[slot]) slot_max[slot] = (uint8_t)l;
  }
  uint32_t sub_off = 0;
  static thread_local uint32_t slot_sub[1 << kLitlenBits];
  for (uint32_t s = 0; s < table_size; s++) {
    if (slot_max[s]) {
      int sb = slot_max[s] - table_bits;
      slot_sub[s] = sub_off;
      t->primary[s] = kSub | ((uint32_t)sb << 24) | (sub_off << 8);
      uint32_t sz = 1u << sb;
      if (sub_off + sz > (1u << kMaxCodeLen)) return false;
      memset(t->sub + sub_off, 0, sz * sizeof(uint32_t));
      sub_off += sz;
    }
  }
  for (int idx = 0; idx < sym_count; idx++) {
    int sym = sorted[idx];
    int l = lens[sym];
    uint32_t c = first_code[l] + (uint32_t)(idx - offs[l]);
    uint32_t rc = rev_bits(c, l);
    uint32_t entry = make_payload(kind, sym) | (uint32_t)l;
    if (!(entry & ~0x3Fu) && kind != Kind::CodeLen) entry = 0;
    if (l <= table_bits) {
      for (uint32_t j = rc; j < table_size; j += 1u << l) t->primary[j] = entry;
    } else {
      uint32_t slot = rc & (table_size - 1);
      int sb = slot_max[slot] - table_bits;
      uint32_t hi = rc >> table_bits;
      uint32_t base = slot_sub[slot];
      for (uint32_t j = hi; j < (1u << sb); j += 1u << (l - table_bits))
        t->sub[base + j] = entry;
    }
  }
  return true;
}

struct BitReader {
  const uint8_t* in;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  bool overrun = false;

  // one unaligned 8-byte load tops the buffer up to >= 56 valid bits
  inline void refill() {
    if (in + 8 <= end) {
      uint64_t w;
      memcpy(&w, in, 8);
      buf |= w << nbits;
      in += (63 - nbits) >> 3;
      nbits |= 56;
    } else {
      while (nbits <= 56 && in < end) {
        buf |= (uint64_t)(*in++) << nbits;
        nbits += 8;
      }
    }
  }

  inline uint32_t peek(int n) const { return (uint32_t)(buf & ((1u << n) - 1)); }

  inline void consume(int n) {
    buf >>= n;
    nbits -= n;
  }

  inline uint32_t get(int n) {
    if (nbits < n) refill();
    if (nbits < n) { overrun = true; return 0; }
    uint32_t v = (uint32_t)(buf & ((1ull << n) - 1));
    consume(n);
    return v;
  }

  void align_byte() { consume(nbits & 7); }
};

// Resolve one table entry from >= kMaxCodeLen buffered/zero bits.
// Returns 0 (invalid) or the final non-SUB entry; does NOT consume.
inline uint32_t lookup(const BitReader& br, const HuffTable& t) {
  uint32_t e = t.primary[(uint32_t)(br.buf & ((1u << t.table_bits) - 1))];
  if (e & kSub) {
    uint32_t sb = (e >> 24) & 0xF;
    uint32_t idx = (uint32_t)((br.buf >> t.table_bits) & ((1u << sb) - 1));
    e = t.sub[((e >> 8) & 0xFFFF) + idx];
  }
  return e;
}

// Decode one complete raw-deflate stream producing exactly out_len bytes.
inline bool raw_inflate(const uint8_t* in, size_t in_len,
                        uint8_t* out, size_t out_len) {
  BitReader br{in, in + in_len};
  size_t op = 0;

  static thread_local HuffTable litlen_t, dist_t;
  bool bfinal = false;
  while (!bfinal) {
    br.refill();
    bfinal = br.get(1);
    uint32_t btype = br.get(2);
    if (br.overrun) return false;

    if (btype == 0) {  // stored
      br.align_byte();
      while (br.nbits >= 8) {  // hand whole buffered bytes back
        br.nbits -= 8;
        br.in--;
      }
      br.buf = 0;
      br.nbits = 0;
      if (br.in + 4 > br.end) return false;
      uint32_t len = br.in[0] | (br.in[1] << 8);
      uint32_t nlen = br.in[2] | (br.in[3] << 8);
      if ((len ^ 0xFFFF) != nlen) return false;
      br.in += 4;
      if (br.in + len > br.end || op + len > out_len) return false;
      memcpy(out + op, br.in, len);
      br.in += len;
      op += len;
      continue;
    }

    if (btype == 1) {  // fixed Huffman (distance code spans 32 symbols)
      uint8_t ll[288], dl[32];
      for (int i = 0; i < 144; i++) ll[i] = 8;
      for (int i = 144; i < 256; i++) ll[i] = 9;
      for (int i = 256; i < 280; i++) ll[i] = 7;
      for (int i = 280; i < 288; i++) ll[i] = 8;
      for (int i = 0; i < 32; i++) dl[i] = 5;
      if (!build_table(&litlen_t, ll, 288, kLitlenBits, Kind::Litlen))
        return false;
      if (!build_table(&dist_t, dl, 32, kDistBits, Kind::Dist)) return false;
    } else if (btype == 2) {  // dynamic
      uint32_t hlit = br.get(5) + 257;
      uint32_t hdist = br.get(5) + 1;
      uint32_t hclen = br.get(4) + 4;
      if (br.overrun || hlit > 286 || hdist > 30) return false;
      static const uint8_t ord[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                      11, 4, 12, 3, 13, 2, 14, 1, 15};
      uint8_t cl_lens[19] = {0};
      for (uint32_t i = 0; i < hclen; i++) cl_lens[ord[i]] = (uint8_t)br.get(3);
      if (br.overrun) return false;
      HuffTable cl_t;
      if (!build_table(&cl_t, cl_lens, 19, 7, Kind::CodeLen)) return false;
      uint8_t lens[288 + 30] = {0};
      uint32_t i = 0;
      while (i < hlit + hdist) {
        br.refill();
        uint32_t e = lookup(br, cl_t);
        int l = (int)(e & 0x3F);
        if (!e || br.nbits < l) return false;
        br.consume(l);
        uint32_t sym = (e >> 8) & 0xFF;
        if (sym < 16) {
          lens[i++] = (uint8_t)sym;
        } else if (sym == 16) {
          if (i == 0) return false;
          uint32_t rep = 3 + br.get(2);
          uint8_t v = lens[i - 1];
          while (rep-- && i < hlit + hdist) lens[i++] = v;
        } else if (sym == 17) {
          uint32_t rep = 3 + br.get(3);
          while (rep-- && i < hlit + hdist) lens[i++] = 0;
        } else {
          uint32_t rep = 11 + br.get(7);
          while (rep-- && i < hlit + hdist) lens[i++] = 0;
        }
        if (br.overrun) return false;
      }
      if (!build_table(&litlen_t, lens, (int)hlit, kLitlenBits, Kind::Litlen))
        return false;
      if (!build_table(&dist_t, lens + hlit, (int)hdist, kDistBits, Kind::Dist,
                       /*allow_incomplete=*/true))
        return false;
    } else {
      return false;
    }

    // block symbol loop: one refill covers litlen + extra + dist + extra
    // (15+5+15+13 = 48 <= 56) or up to 3 literals (45 <= 56)
    for (;;) {
      br.refill();
      uint32_t e = lookup(br, litlen_t);

      // literal fast path: up to 3 literals per refill
      int lits = 3;
      while (e & kLit) {
        int l = (int)(e & 0x3F);
        if (br.nbits < l) return false;
        br.consume(l);
        if (op >= out_len) return false;
        out[op++] = (uint8_t)(e >> 8);
        if (--lits == 0) break;
        e = lookup(br, litlen_t);
      }
      if (e & kLit) continue;  // 3 literals consumed; refill and go again

      {
        int l = (int)(e & 0x3F);
        if (!e || br.nbits < l) return false;
        if (e & kEob) {
          br.consume(l);
          break;
        }
        // length symbol: base + extra bits, fused from the entry
        uint32_t extra = (e >> 17) & 0x1F;
        uint32_t len = (e >> 8) & 0x1FF;
        br.consume(l);
        if (br.nbits < (int)extra) br.refill();
        if (br.nbits < (int)extra) return false;
        len += br.peek(extra);
        br.consume(extra);

        if (br.nbits < kMaxCodeLen + 13) br.refill();
        uint32_t de = lookup(br, dist_t);
        int dlb = (int)(de & 0x3F);
        if (!de || br.nbits < dlb) return false;
        uint32_t dextra = (de >> 23) & 0x1F;
        uint32_t dist = (de >> 8) & 0x7FFF;
        br.consume(dlb);
        if (br.nbits < (int)dextra) br.refill();
        if (br.nbits < (int)dextra) return false;
        dist += br.peek(dextra);
        br.consume(dextra);

        if (dist > op || op + len > out_len) return false;
        const uint8_t* src = out + op - dist;
        uint8_t* dst = out + op;
        op += len;
        if (dist == 1) {
          memset(dst, src[0], len);  // run-length match (e.g. quality runs)
        } else if (dist >= 8 && op + 8 <= out_len) {
          size_t k = 0;
          do {
            memcpy(dst + k, src + k, 8);
            k += 8;
          } while (k < len);
        } else if (dist < 8 && len > 16) {
          // small period: seed one period then double it with memcpy
          memcpy(dst, src, dist);
          size_t k = dist;
          while (k < len) {
            size_t chunk = k < len - k ? k : len - k;
            memcpy(dst + k, dst, chunk);
            k += chunk;
          }
        } else {
          for (uint32_t k = 0; k < len; k++) dst[k] = src[k];
        }
      }
    }
    if (br.overrun) return false;
  }
  return op == out_len;
}

}  // namespace c3t_inflate

#endif  // CLAIR3T_INFLATE_H_
