// Native rANS-Nx16 decoder (CRAM 3.1 block compression method 5) and the
// tok3 name-tokeniser decoder (method 8, rANS-backed streams).
//
// Ports of the validated Python implementations in io/rans_nx16.py and
// io/tok3.py (differential-tested against them); used by the native CRAM
// converter (clair3t_cram.cc) so CRAM 3.1 files also convert natively.
// Decode-only: the writers stay in Python.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" int clair3t_arith_decode(const uint8_t* payload,
                                    int64_t payload_len, uint8_t* out,
                                    int64_t out_sz);

namespace nx16 {

constexpr uint32_t RANS_L = 1u << 15;

constexpr int F_ORDER1 = 0x01;
constexpr int F_N32 = 0x02;
constexpr int F_STRIPE = 0x04;
constexpr int F_NOSZ = 0x08;
constexpr int F_CAT = 0x10;
constexpr int F_RLE = 0x20;
constexpr int F_PACK = 0x40;

struct Cur {
  const uint8_t* d;
  size_t n;
  size_t p = 0;
  bool fail = false;
  uint8_t u8() {
    if (p >= n) { fail = true; return 0; }
    return d[p++];
  }
};

uint64_t read_uint7(Cur& c) {
  uint64_t v = 0;
  for (;;) {
    uint8_t b = c.u8();
    v = (v << 7) | (b & 0x7F);
    if (!(b & 0x80) || c.fail) return v;
  }
}

// --- alphabet + frequency tables ---

bool decode_alphabet(Cur& c, std::vector<int>* syms) {
  syms->clear();
  int rle = 0;
  int sym = c.u8();
  int last = sym;
  for (;;) {
    if (c.fail || syms->size() > 256) return false;
    syms->push_back(sym);
    if (rle) {
      rle--;
      sym++;
    } else {
      sym = c.u8();
      if (sym == last + 1) rle = c.u8();
    }
    last = sym;
    if (sym == 0) break;
  }
  return !c.fail;
}

void normalize(uint32_t* F, uint32_t total) {
  uint64_t t = 0;
  for (int i = 0; i < 256; i++) t += F[i];
  if (t == 0) return;
  uint64_t acc = 0;
  int big = 0;
  for (int i = 0; i < 256; i++) {
    if (F[i]) {
      uint64_t nf = (uint64_t)F[i] * total / t;
      if (nf < 1) nf = 1;
      F[i] = (uint32_t)nf;
      acc += nf;
    }
    if (F[i] > F[big]) big = i;
  }
  F[big] += (uint32_t)(total - acc);
}

struct Table0 {
  uint32_t F[256];
  uint32_t C[257];
  uint8_t sym[4096];
};

bool read_freqs_o0(Cur& c, Table0* t) {
  std::vector<int> syms;
  if (!decode_alphabet(c, &syms)) return false;
  memset(t->F, 0, sizeof(t->F));
  for (int s : syms) {
    if (s < 0 || s > 255) return false;
    t->F[s] = (uint32_t)read_uint7(c);
  }
  if (c.fail) return false;
  normalize(t->F, 4096);
  t->C[0] = 0;
  for (int i = 0; i < 256; i++) t->C[i + 1] = t->C[i] + t->F[i];
  if (t->C[256] != 4096) return false;
  for (int s = 0; s < 256; s++)
    for (uint32_t j = t->C[s]; j < t->C[s + 1]; j++) t->sym[j] = (uint8_t)s;
  return true;
}

bool rans0_decode(Cur& c, size_t out_sz, int N, uint8_t* out) {
  Table0 t;
  if (!read_freqs_o0(c, &t)) return false;
  std::vector<uint32_t> R(N);
  for (int j = 0; j < N; j++) {
    if (c.p + 4 > c.n) return false;
    memcpy(&R[j], c.d + c.p, 4);
    c.p += 4;
  }
  for (size_t i = 0; i < out_sz; i++) {
    int j = (int)(i % N);
    uint32_t x = R[j];
    uint32_t slot = x & 4095;
    uint8_t s = t.sym[slot];
    out[i] = s;
    x = t.F[s] * (x >> 12) + slot - t.C[s];
    if (x < RANS_L && c.p + 2 <= c.n) {
      x = (x << 16) | (c.d[c.p] | ((uint32_t)c.d[c.p + 1] << 8));
      c.p += 2;
    }
    R[j] = x;
  }
  return true;
}

struct Table1 {
  // per-context tables, allocated lazily over present contexts
  std::vector<uint32_t> F;    // 256 per ctx
  std::vector<uint32_t> C;    // 257 per ctx
  std::vector<uint8_t> sym;   // (1<<shift) per ctx
  std::vector<int> ctx_index; // 256 -> dense index or -1
  int shift = 12;
};

bool read_freqs_o1(Cur& c, Table1* t) {
  uint8_t comp = c.u8();
  t->shift = comp >> 4;
  if (t->shift < 1 || t->shift > 15) return false;
  std::vector<uint8_t> tbl;
  Cur src{nullptr, 0};
  if (comp & 1) {
    uint64_t u_len = read_uint7(c);
    uint64_t c_len = read_uint7(c);
    if (c.fail || u_len > (1u << 24)) return false;
    tbl.resize(u_len);
    Cur cc{c.d + c.p, c.n - c.p};
    if (!rans0_decode(cc, u_len, 4, tbl.data())) return false;
    c.p += c_len;
    if (c.p > c.n) return false;
    src = Cur{tbl.data(), tbl.size()};
  } else {
    src = Cur{c.d + c.p, c.n - c.p};
  }
  std::vector<int> alpha;
  if (!decode_alphabet(src, &alpha)) return false;
  uint32_t total = 1u << t->shift;
  t->ctx_index.assign(256, -1);
  int n_ctx = 0;
  std::vector<std::vector<uint32_t>> rows;
  for (int ci : alpha) {
    std::vector<uint32_t> row(256, 0);
    uint64_t sum = 0;
    for (int s : alpha) {
      row[s] = (uint32_t)read_uint7(src);
      sum += row[s];
    }
    if (src.fail) return false;
    if (sum) {
      normalize(row.data(), total);
      t->ctx_index[ci] = n_ctx++;
      rows.push_back(std::move(row));
    }
  }
  t->F.assign((size_t)n_ctx * 256, 0);
  t->C.assign((size_t)n_ctx * 257, 0);
  t->sym.assign((size_t)n_ctx * total, 0);
  for (int k = 0; k < n_ctx; k++) {
    uint32_t* F = t->F.data() + (size_t)k * 256;
    uint32_t* C = t->C.data() + (size_t)k * 257;
    uint8_t* sym = t->sym.data() + (size_t)k * total;
    memcpy(F, rows[k].data(), 256 * 4);
    C[0] = 0;
    for (int i = 0; i < 256; i++) C[i + 1] = C[i] + F[i];
    if (C[256] != total) return false;
    for (int s = 0; s < 256; s++)
      for (uint32_t j = C[s]; j < C[s + 1]; j++) sym[j] = (uint8_t)s;
  }
  if (!(comp & 1)) c.p += src.p;
  return true;
}

bool rans1_decode(Cur& c, size_t out_sz, int N, uint8_t* out) {
  Table1 t;
  if (!read_freqs_o1(c, &t)) return false;
  std::vector<uint32_t> R(N);
  for (int j = 0; j < N; j++) {
    if (c.p + 4 > c.n) return false;
    memcpy(&R[j], c.d + c.p, 4);
    c.p += 4;
  }
  uint32_t total = 1u << t.shift;
  uint32_t mask = total - 1;
  size_t isz = out_sz / N;
  std::vector<size_t> pos(N);
  std::vector<int> last(N, 0);
  for (int j = 0; j < N; j++) pos[j] = (size_t)j * isz;

  auto dec = [&](int j) -> bool {
    int ci = t.ctx_index[last[j]];
    if (ci < 0) return false;
    const uint32_t* F = t.F.data() + (size_t)ci * 256;
    const uint32_t* C = t.C.data() + (size_t)ci * 257;
    const uint8_t* sym = t.sym.data() + (size_t)ci * total;
    uint32_t x = R[j];
    uint32_t slot = x & mask;
    uint8_t s = sym[slot];
    out[pos[j]] = s;
    x = F[s] * (x >> t.shift) + slot - C[s];
    if (x < RANS_L && c.p + 2 <= c.n) {
      x = (x << 16) | (c.d[c.p] | ((uint32_t)c.d[c.p + 1] << 8));
      c.p += 2;
    }
    R[j] = x;
    last[j] = s;
    pos[j]++;
    return true;
  };

  for (size_t i = 0; i < isz; i++)
    for (int j = 0; j < N; j++)
      if (!dec(j)) return false;
  while (pos[N - 1] < out_sz)
    if (!dec(N - 1)) return false;
  return true;
}

bool decompress(const uint8_t* in, size_t in_len, uint8_t* out,
                size_t out_len, int depth = 0);

bool decode_stripe(Cur& c, size_t out_sz, uint8_t* out, int depth) {
  int X = c.u8();
  if (c.fail || X <= 0 || X > 64) return false;
  std::vector<uint64_t> clens(X);
  for (int j = 0; j < X; j++) clens[j] = read_uint7(c);
  if (c.fail) return false;
  std::vector<uint8_t> sub;
  for (int j = 0; j < X; j++) {
    size_t ulen = out_sz / X + ((out_sz % X) > (size_t)j ? 1 : 0);
    if (c.p + clens[j] > c.n) return false;
    sub.resize(ulen);
    if (!decompress(c.d + c.p, clens[j], sub.data(), ulen, depth + 1))
      return false;
    c.p += clens[j];
    for (size_t i = 0; i < ulen; i++) out[i * X + j] = sub[i];
  }
  return true;
}

bool decompress(const uint8_t* in, size_t in_len, uint8_t* out,
                size_t out_len, int depth) {
  // adversarial nested stripes must not recurse unboundedly
  if (depth > 2) return false;
  Cur c{in, in_len};
  int flags = c.u8();
  size_t out_sz = out_len;
  if (!(flags & F_NOSZ)) {
    out_sz = (size_t)read_uint7(c);
    if (out_sz != out_len) return false;
  }
  if (c.fail) return false;
  if (flags & F_STRIPE) return decode_stripe(c, out_sz, out, depth);
  int N = (flags & F_N32) ? 32 : 4;

  // PACK meta
  bool has_pack = flags & F_PACK;
  uint8_t pmap[16];
  int nsym = 0;
  size_t final_len = out_sz;
  if (has_pack) {
    nsym = c.u8();
    if (nsym > 16) return false;
    for (int i = 0; i < nsym; i++) pmap[i] = c.u8();
    size_t packed_sz = (size_t)read_uint7(c);
    // bit-packing never expands: a lying packed length must not drive a
    // giant stage allocation
    if (c.fail || packed_sz > out_sz) return false;
    out_sz = packed_sz;
  }
  // RLE meta
  bool has_rle = flags & F_RLE;
  std::vector<uint8_t> rle_meta;
  size_t rle_out_len = 0;
  if (has_rle) {
    rle_out_len = out_sz;
    uint64_t rle_meta_len = read_uint7(c);
    out_sz = (size_t)read_uint7(c);  // literal length
    // every literal yields >=1 expanded byte, so the literal stream can
    // never exceed the expanded output; the meta holds the symbol list +
    // one varint run per literal
    if (c.fail || out_sz > rle_out_len ||
        rle_meta_len / 2 > rle_out_len * 2 + 1024)
      return false;
    if (rle_meta_len & 1) {
      size_t mlen = (size_t)((rle_meta_len - 1) / 2);
      if (c.p + mlen > c.n) return false;
      rle_meta.assign(c.d + c.p, c.d + c.p + mlen);
      c.p += mlen;
    } else {
      uint64_t c_meta_len = read_uint7(c);
      rle_meta.resize(rle_meta_len / 2);
      Cur mc{c.d + c.p, c.n - c.p};
      if (!rans0_decode(mc, rle_meta.size(), N, rle_meta.data())) return false;
      c.p += c_meta_len;
      if (c.p > c.n) return false;
    }
  }

  std::vector<uint8_t> stage;
  uint8_t* target = out;
  if (has_pack || has_rle) {
    stage.resize(out_sz);
    target = stage.data();
  }
  if (flags & F_CAT) {
    if (c.p + out_sz > c.n) return false;
    memcpy(target, c.d + c.p, out_sz);
  } else if (out_sz == 0) {
    // nothing
  } else if (flags & F_ORDER1) {
    if (!rans1_decode(c, out_sz, N, target)) return false;
  } else {
    if (!rans0_decode(c, out_sz, N, target)) return false;
  }

  if (has_rle) {
    std::vector<uint8_t> expanded(rle_out_len);
    size_t mp = 0;
    if (rle_meta.empty()) return false;
    int m = rle_meta[mp++];
    if (m == 0) m = 256;
    uint8_t in_rle[256] = {0};
    for (int i = 0; i < m; i++) {
      if (mp >= rle_meta.size()) return false;
      in_rle[rle_meta[mp++]] = 1;
    }
    size_t j = 0;
    for (size_t i = 0; i < out_sz; i++) {
      uint8_t b = target[i];
      if (j >= rle_out_len) return false;
      expanded[j++] = b;
      if (in_rle[b]) {
        uint64_t run = 0;
        for (;;) {
          if (mp >= rle_meta.size()) return false;
          uint8_t rb = rle_meta[mp++];
          run = (run << 7) | (rb & 0x7F);
          if (!(rb & 0x80)) break;
        }
        if (j + run > rle_out_len) return false;
        memset(expanded.data() + j, b, run);
        j += run;
      }
    }
    if (j != rle_out_len) return false;
    out_sz = rle_out_len;
    if (has_pack) {
      stage = std::move(expanded);
      target = stage.data();
    } else {
      memcpy(out, expanded.data(), rle_out_len);
      return true;
    }
  }

  if (has_pack) {
    size_t fl = final_len;
    // the unpack loop indexes target[(fl-1) >> shift]; a lying packed
    // length must fail cleanly, not read past the stage buffer
    if (nsym > 1 && fl > 0) {
      int shift = nsym <= 2 ? 3 : (nsym <= 4 ? 2 : 1);
      if (((fl - 1) >> shift) >= out_sz) return false;
    }
    if (nsym <= 1) {
      if (nsym == 0 && fl > 0) return false;
      memset(out, nsym ? pmap[0] : 0, fl);
    } else if (nsym <= 2) {
      for (size_t i = 0; i < fl; i++)
        out[i] = pmap[(target[i >> 3] >> (i & 7)) & 1];
    } else if (nsym <= 4) {
      for (size_t i = 0; i < fl; i++)
        out[i] = pmap[(target[i >> 2] >> ((i & 3) * 2)) & 3];
    } else {
      for (size_t i = 0; i < fl; i++)
        out[i] = pmap[(target[i >> 1] >> ((i & 1) * 4)) & 15];
    }
  }
  return true;
}

}  // namespace nx16

extern "C" {

// Decode an rANS-Nx16 payload into exactly out_sz bytes. Returns 0 on ok.
int clair3t_rans_nx16_decode(const uint8_t* payload, int64_t payload_len,
                             uint8_t* out, int64_t out_sz) {
  if (payload_len <= 0 || out_sz < 0) return 1;
  try {
    return nx16::decompress(payload, (size_t)payload_len, out,
                            (size_t)out_sz)
               ? 0 : 1;
  } catch (...) {  // bad_alloc etc. from corrupt length fields
    return 1;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// tok3 name tokeniser (decode; port of io/tok3.py, rANS-backed streams only
// — arith-backed streams return failure and the caller falls back)
// ---------------------------------------------------------------------------

namespace tok3 {

using nx16::Cur;
using nx16::read_uint7;

constexpr int N_TYPE = 0, N_ALPHA = 1, N_CHAR = 2, N_DZLEN = 3, N_DIGITS0 = 4,
              N_DUP = 5, N_DIFF = 6, N_DIGITS = 7, N_DDELTA = 8,
              N_DDELTA0 = 9, N_MATCH = 10, N_NOP = 11, N_END = 12;
constexpr int NTYPES = 13;
constexpr uint8_t T_NEW = 0x80, T_DUP_STREAM = 0x40;

struct Stream {
  std::vector<uint8_t> buf;
  size_t p = 0;
  bool present = false;

  bool byte(int* v) {
    if (p >= buf.size()) return false;
    *v = buf[p++];
    return true;
  }
  bool u32(uint32_t* v) {
    if (p + 4 > buf.size()) return false;
    memcpy(v, buf.data() + p, 4);
    p += 4;
    return true;
  }
  bool cstr(std::string* s) {
    size_t q = p;
    while (q < buf.size() && buf[q]) q++;
    if (q >= buf.size()) return false;
    s->assign((const char*)buf.data() + p, q - p);
    p = q + 1;
    return true;
  }
};

struct Token {
  int type;
  std::string text;
};

bool decompress(const uint8_t* in, size_t in_len, std::vector<uint8_t>* out) {
  Cur c{in, in_len};
  uint64_t ulen = read_uint7(c);
  uint64_t nnames = read_uint7(c);
  int use_arith = c.u8();
  // each name occupies >=1 output byte (incl. its separator); corrupt
  // counts must not drive giant vector allocations
  if (c.fail || nnames > ulen || ulen > (uint64_t)1 << 40) return false;

  // read token streams
  std::vector<std::vector<Stream>> B;  // [pos][type]
  int t = -1;
  while (c.p < c.n) {
    uint8_t ttype = c.u8();
    int typ = ttype & 63;
    if (typ >= NTYPES) return false;
    if (ttype & T_NEW) t++;
    if (t < 0) return false;
    if ((size_t)t >= B.size()) B.resize(t + 1, std::vector<Stream>(NTYPES));
    if (ttype & T_DUP_STREAM) {
      int dup_pos = c.u8();
      int dup_type = c.u8();
      if (c.fail || dup_pos >= (int)B.size() || dup_type >= NTYPES ||
          !B[dup_pos][dup_type].present)
        return false;
      B[t][typ].buf = B[dup_pos][dup_type].buf;
      B[t][typ].present = true;
    } else {
      uint64_t clen = read_uint7(c);
      if (c.fail || c.p + clen > c.n) return false;
      // each stream is a full rANS-Nx16 (or arith) payload with its own
      // size header; the F_NOSZ bit is 0x08 in both codecs
      Cur probe{c.d + c.p, clen};
      int flags = probe.u8();
      uint64_t usz = 0;
      if (!(flags & nx16::F_NOSZ)) usz = read_uint7(probe);
      if (probe.fail) return false;
      B[t][typ].buf.resize(usz);
      if (use_arith) {
        if (clair3t_arith_decode(c.d + c.p, (int64_t)clen,
                                 B[t][typ].buf.data(), (int64_t)usz) != 0)
          return false;
      } else if (!nx16::decompress(c.d + c.p, clen, B[t][typ].buf.data(),
                                   usz)) {
        return false;
      }
      B[t][typ].present = true;
      c.p += clen;
    }
  }

  auto get = [&](int pos, int typ) -> Stream* {
    if (pos < 0 || pos >= (int)B.size() || !B[pos][typ].present) return nullptr;
    return &B[pos][typ];
  };

  std::vector<std::string> names(nnames);
  std::vector<std::vector<Token>> toks(nnames);
  for (uint64_t n = 0; n < nnames; n++) {
    Stream* ts = get(0, N_TYPE);
    int ntype;
    if (!ts || !ts->byte(&ntype)) return false;
    if (ntype == N_DUP) {
      Stream* ds = get(0, N_DUP);
      uint32_t dist;
      if (!ds || !ds->u32(&dist) || dist == 0 || dist > n) return false;
      names[n] = names[n - dist];
      toks[n] = toks[n - dist];
      continue;
    }
    if (ntype != N_DIFF) return false;
    Stream* fs = get(0, N_DIFF);
    uint32_t dist;
    if (!fs || !fs->u32(&dist)) return false;
    const std::vector<Token>* prev =
        (dist > 0 && dist <= n) ? &toks[n - dist] : nullptr;
    std::string name;
    std::vector<Token> tk;
    for (int pos = 1;; pos++) {
      Stream* ps = get(pos, N_TYPE);
      int typ;
      if (!ps || !ps->byte(&typ)) return false;
      if (typ == N_END) break;
      Token tok{typ, ""};
      switch (typ) {
        case N_NOP:
          break;
        case N_MATCH: {
          if (!prev || pos - 1 >= (int)prev->size()) return false;
          tok = (*prev)[pos - 1];
          name += tok.text;
          break;
        }
        case N_ALPHA: {
          Stream* s = get(pos, N_ALPHA);
          if (!s || !s->cstr(&tok.text)) return false;
          name += tok.text;
          break;
        }
        case N_CHAR: {
          Stream* s = get(pos, N_CHAR);
          int b;
          if (!s || !s->byte(&b)) return false;
          tok.text.assign(1, (char)b);
          name += tok.text;
          break;
        }
        case N_DIGITS: {
          Stream* s = get(pos, N_DIGITS);
          uint32_t v;
          if (!s || !s->u32(&v)) return false;
          tok.text = std::to_string(v);
          name += tok.text;
          break;
        }
        case N_DIGITS0: {
          Stream* s = get(pos, N_DIGITS0);
          Stream* zs = get(pos, N_DZLEN);
          uint32_t v;
          int ln;
          if (!s || !s->u32(&v) || !zs || !zs->byte(&ln)) return false;
          std::string d = std::to_string(v);
          if ((int)d.size() < ln) d.insert(0, ln - d.size(), '0');
          tok.text = d;
          name += d;
          break;
        }
        case N_DDELTA: {
          Stream* s = get(pos, N_DDELTA);
          int dlt;
          if (!s || !s->byte(&dlt) || !prev || pos - 1 >= (int)prev->size())
            return false;
          uint64_t v = strtoull((*prev)[pos - 1].text.c_str(), nullptr, 10) + dlt;
          tok.type = N_DIGITS;
          tok.text = std::to_string(v);
          name += tok.text;
          break;
        }
        case N_DDELTA0: {
          Stream* s = get(pos, N_DDELTA0);
          int dlt;
          if (!s || !s->byte(&dlt) || !prev || pos - 1 >= (int)prev->size())
            return false;
          const std::string& pt = (*prev)[pos - 1].text;
          uint64_t v = strtoull(pt.c_str(), nullptr, 10) + dlt;
          std::string d = std::to_string(v);
          if (d.size() < pt.size()) d.insert(0, pt.size() - d.size(), '0');
          tok.type = N_DIGITS0;
          tok.text = d;
          name += d;
          break;
        }
        default:
          return false;
      }
      tk.push_back(std::move(tok));
    }
    names[n] = std::move(name);
    toks[n] = std::move(tk);
  }

  out->clear();
  for (auto& nm : names) {
    out->insert(out->end(), nm.begin(), nm.end());
    out->push_back(0);
  }
  if (out->size() != ulen) {
    // '\n'-separated writer variant
    std::vector<uint8_t> alt;
    for (auto& nm : names) {
      alt.insert(alt.end(), nm.begin(), nm.end());
      alt.push_back('\n');
    }
    if (alt.size() != ulen) return false;
    *out = std::move(alt);
  }
  return true;
}

}  // namespace tok3

extern "C" {

// Decode a tok3 payload into exactly out_sz bytes. Returns 0 on ok.
int clair3t_tok3_decode(const uint8_t* payload, int64_t payload_len,
                        uint8_t* out, int64_t out_sz) {
  if (payload_len <= 0 || out_sz < 0) return 1;
  try {
    std::vector<uint8_t> buf;
    if (!tok3::decompress(payload, (size_t)payload_len, &buf)) return 1;
    if ((int64_t)buf.size() != out_sz) return 1;
    memcpy(out, buf.data(), out_sz);
    return 0;
  } catch (...) {
    return 1;
  }
}

}  // extern "C"
