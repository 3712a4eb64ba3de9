// Native decoder for the CRAM 3.1 adaptive arithmetic codec (block
// compression method 6) — a port of the validated Python implementation in
// io/arith.py (reference behavior: htslib cram/arith_dynamic.c).
//
// Decode-only: CRAM writing stays on the Python side.  The EXT transform
// (0x80) is an embedded bzip2 stream, decoded by clair3t_bzip2.cc.
//
// Used twice by the native CRAM -> BAM converter: method-6 blocks, and
// arith-backed tok3 name-token streams (clair3t_rans_nx16.cc).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

extern "C" int64_t clair3t_bzip2_decode(const uint8_t* data, int64_t n,
                                        uint8_t* out, int64_t out_cap);

namespace c3arith {

constexpr int F_ORDER1 = 0x01;
constexpr int F_STRIPE = 0x04;
constexpr int F_NOSZ = 0x08;
constexpr int F_CAT = 0x10;
constexpr int F_RLE = 0x20;
constexpr int F_PACK = 0x40;
constexpr int F_EXT = 0x80;

constexpr uint32_t kMaxTotal = (1u << 16) - 16;
constexpr uint32_t kStep = 16;

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

inline uint64_t read_uint7(Cur& c) {
  uint64_t v = 0;
  for (int k = 0; k < 10; k++) {
    uint8_t b = c.u8();
    if (c.fail) return 0;
    v = (v << 7) | (b & 0x7F);
    if (!(b & 0x80)) return v;
  }
  c.fail = true;
  return 0;
}

// Shelwien/Subbotin byte-wise range decoder (io/arith.py RangeDecoder):
// 32-bit range, primed with five bytes (the first is the encoder's zero
// cache).
struct RangeDecoder {
  Cur* c;
  uint32_t range = 0xFFFFFFFF;
  uint32_t code = 0;

  explicit RangeDecoder(Cur* cur) : c(cur) {
    uint64_t x = 0;
    for (int i = 0; i < 5; i++) x = (x << 8) | byte();
    code = (uint32_t)x;
  }

  inline uint8_t byte() {
    // reads past the payload end return 0 (matching the Python decoder)
    return c->p < c->n ? c->d[c->p++] : 0;
  }

  inline uint32_t get_freq(uint32_t tot) {
    range /= tot;
    uint32_t f = code / range;
    return f < tot - 1 ? f : tot - 1;
  }

  inline void decode(uint32_t cum, uint32_t freq) {
    code -= cum * range;
    range *= freq;
    while (range < (1u << 24)) {
      range <<= 8;
      code = (code << 8) | byte();
    }
  }
};

// Adaptive symbol model (htslib c_simple_model.h semantics): +16 per hit,
// halving renormalize past 2^16-16, one bubble step toward the front.
struct SimpleModel {
  std::vector<uint16_t> freqs;
  std::vector<uint16_t> syms;
  uint32_t total;

  void init(int nsym) {
    freqs.assign(nsym, 1);
    syms.resize(nsym);
    for (int i = 0; i < nsym; i++) syms[i] = (uint16_t)i;
    total = (uint32_t)nsym;
  }

  inline void bump(size_t x) {
    freqs[x] += kStep;
    total += kStep;
    if (total > kMaxTotal) {
      total = 0;
      for (auto& f : freqs) {
        f -= f >> 1;
        total += f;
      }
    }
    if (x > 0 && freqs[x] > freqs[x - 1]) {
      std::swap(freqs[x], freqs[x - 1]);
      std::swap(syms[x], syms[x - 1]);
    }
  }

  inline int decode(RangeDecoder& rc) {
    uint32_t f = rc.get_freq(total);
    size_t x = 0;
    uint32_t acc = 0;
    while (acc + freqs[x] <= f) acc += freqs[x++];
    rc.decode(acc, freqs[x]);
    int sym = syms[x];
    bump(x);
    return sym;
  }
};

bool o0_decode(Cur& c, size_t out_sz, uint8_t* out) {
  int nsym = c.u8();
  if (c.fail) return false;
  if (nsym == 0) nsym = 256;
  SimpleModel model;
  model.init(nsym);
  RangeDecoder rc(&c);
  for (size_t i = 0; i < out_sz; i++) out[i] = (uint8_t)model.decode(rc);
  return true;
}

bool o1_decode(Cur& c, size_t out_sz, uint8_t* out) {
  int nsym = c.u8();
  if (c.fail) return false;
  if (nsym == 0) nsym = 256;
  std::vector<SimpleModel> models(nsym);
  for (auto& m : models) m.init(nsym);
  RangeDecoder rc(&c);
  int last = 0;
  for (size_t i = 0; i < out_sz; i++) {
    if (last >= nsym) return false;
    last = models[last].decode(rc);
    out[i] = (uint8_t)last;
  }
  return true;
}

bool rle_decode(Cur& c, size_t out_sz, int order, uint8_t* out) {
  int nsym = c.u8();
  if (c.fail) return false;
  if (nsym == 0) nsym = 256;
  std::vector<SimpleModel> lits(order ? nsym : 1);
  for (auto& m : lits) m.init(nsym);
  // run models: one per literal, then shared continuation contexts
  std::vector<SimpleModel> runs(nsym + 2);
  for (auto& m : runs) m.init(256);
  RangeDecoder rc(&c);
  size_t i = 0;
  int last = 0;
  while (i < out_sz) {
    int b = lits[order ? last : 0].decode(rc);
    last = b;
    out[i++] = (uint8_t)b;
    uint64_t run = 0;
    int rctx = b;
    for (;;) {
      int part = runs[rctx].decode(rc);
      run += (uint64_t)part;
      rctx = (rctx == b) ? nsym : nsym + 1;
      if (part != 255) break;
    }
    if (i + run > out_sz) return false;
    memset(out + i, b, run);
    i += run;
  }
  return true;
}

bool decompress(const uint8_t* in, size_t in_len, uint8_t* out,
                size_t out_len, int depth = 0) {
  // the spec nests transforms at most one level (stripe of plain streams);
  // an adversarial payload of nested stripes must not recurse unboundedly
  if (depth > 2) return false;
  Cur c{in, in_len};
  int flags = c.u8();
  if (c.fail) return false;
  size_t out_sz = out_len;
  if (!(flags & F_NOSZ)) {
    out_sz = (size_t)read_uint7(c);
    if (c.fail || out_sz != out_len) return false;
  }

  if (flags & F_STRIPE) {
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

  bool has_pack = flags & F_PACK;
  uint8_t pmap[256];
  int nsym = 0;
  size_t final_len = out_sz;
  if (has_pack) {
    nsym = c.u8();
    if (c.fail || nsym > 16) return false;
    for (int i = 0; i < nsym; i++) pmap[i] = c.u8();
    out_sz = (size_t)read_uint7(c);
    // bit-packing never expands: a lying packed length must not drive a
    // giant stage allocation (std::bad_alloc aborts across the C ABI)
    if (c.fail || out_sz > final_len) return false;
  }

  std::vector<uint8_t> stage;
  uint8_t* target = out;
  if (has_pack) {
    stage.resize(out_sz);
    target = stage.data();
  }

  if (flags & F_CAT) {
    if (c.p + out_sz > c.n) return false;
    memcpy(target, c.d + c.p, out_sz);
  } else if (flags & F_EXT) {
    // EXT = embedded bzip2 (io/arith.py:320-323)
    if (c.p > c.n) return false;
    if (clair3t_bzip2_decode(c.d + c.p, (int64_t)(c.n - c.p), target,
                             (int64_t)out_sz) != (int64_t)out_sz)
      return false;
  } else if (out_sz == 0) {
    // nothing
  } else if (flags & F_RLE) {
    if (!rle_decode(c, out_sz, flags & F_ORDER1, target)) return false;
  } else if (flags & F_ORDER1) {
    if (!o1_decode(c, out_sz, target)) return false;
  } else {
    if (!o0_decode(c, out_sz, target)) return false;
  }

  if (has_pack) {  // same bit-unpack as rANS-Nx16 (io/rans_nx16.py)
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

}  // namespace c3arith

// ---------------------------------------------------------------------------
// fqzcomp quality codec (CRAM 3.1 method 7) — decode-only port of
// io/fqzcomp.py (reference behavior: htslib cram/fqzcomp_qual.c).
// Shares the range coder and adaptive model above.
// ---------------------------------------------------------------------------

namespace c3fqz {

using c3arith::Cur;
using c3arith::RangeDecoder;
using c3arith::SimpleModel;

constexpr int kVers = 5;
constexpr int GFLAG_MULTI_PARAM = 1;
constexpr int GFLAG_HAVE_STAB = 2;
constexpr int GFLAG_DO_REV = 4;
constexpr int PFLAG_DO_DEDUP = 2;
constexpr int PFLAG_DO_LEN = 4;
constexpr int PFLAG_DO_SEL = 8;
constexpr int PFLAG_HAVE_QMAP = 16;
constexpr int PFLAG_HAVE_PTAB = 32;
constexpr int PFLAG_HAVE_DTAB = 64;
constexpr int PFLAG_HAVE_QTAB = 128;

// monotone-array RLE (htslib read_array)
bool read_array(Cur& c, int* values, int size) {
  int z = 0, j = 0;
  while (z < size) {
    uint64_t run = 0;
    for (;;) {
      uint8_t r = c.u8();
      if (c.fail) return false;
      run += r;
      if (r != 255) break;
    }
    while (run > 0 && z < size) {
      values[z++] = j;
      run--;
    }
    j++;
    if (j > 1 << 20) return false;  // corrupt-stream backstop
  }
  return true;
}

struct Param {
  uint32_t context = 0;
  int pflags = 0;
  int max_sym = 64;
  int qbits = 12, qshift = 5;
  int qloc = 0, sloc = 0, ploc = 0, dloc = 0;
  uint8_t qmap[256] = {0};
  int qtab[256];
  int ptab[1024] = {0};
  int dtab[256] = {0};
  uint32_t qmask = 0;
  int nsym = 0;
  int fixed_len = 0;
};

bool read_param(Cur& c, Param* pm) {
  for (int i = 0; i < 256; i++) pm->qtab[i] = i;
  uint8_t lo = c.u8(), hi = c.u8();
  pm->context = lo | ((uint32_t)hi << 8);
  pm->pflags = c.u8();
  pm->max_sym = c.u8();
  uint8_t x = c.u8();
  pm->qbits = x >> 4;
  pm->qshift = x & 15;
  x = c.u8();
  pm->qloc = x >> 4;
  pm->sloc = x & 15;
  x = c.u8();
  pm->ploc = x >> 4;
  pm->dloc = x & 15;
  if (c.fail) return false;
  if (pm->pflags & PFLAG_HAVE_QMAP) {
    for (int i = 0; i < pm->max_sym; i++) pm->qmap[i] = c.u8();
    if (c.fail) return false;
  }
  if (pm->pflags & PFLAG_HAVE_QTAB) {
    if (!read_array(c, pm->qtab, 256)) return false;
  }
  if (pm->pflags & PFLAG_HAVE_PTAB) {
    if (!read_array(c, pm->ptab, 1024)) return false;
  }
  if (pm->pflags & PFLAG_HAVE_DTAB) {
    if (!read_array(c, pm->dtab, 256)) return false;
  }
  pm->qmask = (1u << pm->qbits) - 1;
  pm->nsym = pm->max_sym > 0 ? pm->max_sym : 256;
  return true;
}

// lazily-allocated per-context quality models (up to 2^16 contexts)
struct QualModels {
  int nsym;
  std::vector<SimpleModel*> slots;

  explicit QualModels(int n) : nsym(n), slots(1 << 16, nullptr) {}
  ~QualModels() {
    for (auto* m : slots) delete m;
  }

  SimpleModel& get(uint32_t ctx) {
    auto*& m = slots[ctx & 0xFFFF];
    if (!m) {
      m = new SimpleModel();
      m->init(nsym);
    }
    return *m;
  }
};

struct State {
  int p = 0;
  int delta = 0;
  int prevq = 0;
  uint32_t qctx = 0;
  int s = 0;
};

inline uint32_t update_ctx(const Param& pm, State& st, int q) {
  st.qctx = (st.qctx << pm.qshift) + (uint32_t)pm.qtab[q];
  uint32_t last = pm.context;
  last += (st.qctx & pm.qmask) << pm.qloc;
  if (pm.pflags & PFLAG_HAVE_PTAB)
    last += (uint32_t)pm.ptab[st.p < 1023 ? st.p : 1023] << pm.ploc;
  if (pm.pflags & PFLAG_HAVE_DTAB)
    last += (uint32_t)pm.dtab[st.delta < 255 ? st.delta : 255] << pm.dloc;
  if (pm.pflags & PFLAG_DO_SEL) last += (uint32_t)st.s << pm.sloc;
  st.p--;
  if (st.prevq != q) st.delta++;
  st.prevq = q;
  return last & 0xFFFF;
}

bool decompress(const uint8_t* in, size_t in_len, uint8_t* out,
                size_t out_sz) {
  Cur c{in, in_len};
  if (c.u8() != kVers) return false;
  int gflags = c.u8();
  if (c.fail) return false;
  int nparam = 1;
  if (gflags & GFLAG_MULTI_PARAM) nparam = c.u8();
  if (c.fail || nparam < 1 || nparam > 255) return false;
  int max_sel = nparam > 1 ? nparam - 1 : 0;
  int stab[256];
  for (int i = 0; i < 256; i++) stab[i] = i;
  if (gflags & GFLAG_HAVE_STAB) {
    max_sel = c.u8();
    if (c.fail || !read_array(c, stab, 256)) return false;
  }
  std::vector<Param> params(nparam);
  for (int i = 0; i < nparam; i++)
    if (!read_param(c, &params[i])) return false;

  std::vector<std::unique_ptr<QualModels>> quals;
  for (auto& pm : params)
    quals.emplace_back(new QualModels(pm.nsym));
  SimpleModel model_len[4];
  for (auto& m : model_len) m.init(256);
  SimpleModel model_rev, model_dup, model_sel;
  model_rev.init(2);
  model_dup.init(2);
  model_sel.init(max_sel + 1);

  RangeDecoder rc(&c);
  struct Rec { size_t start, len; int rev; };
  std::vector<Rec> recs;
  State st;
  Param* pm = &params[0];
  QualModels* qm = quals[0].get();
  uint32_t ctx = pm->context;
  int64_t rec_len = 0;
  bool first_len = true;
  size_t i = 0;
  while (i < out_sz) {
    if (st.p == 0) {  // new record
      int s = 0;
      if (max_sel > 0) s = model_sel.decode(rc);
      int x = stab[s];
      if (x < 0 || x >= nparam) return false;
      pm = &params[x];
      qm = quals[x].get();
      if (first_len || (pm->pflags & PFLAG_DO_LEN)) {
        rec_len = (int64_t)model_len[0].decode(rc) |
                  ((int64_t)model_len[1].decode(rc) << 8) |
                  ((int64_t)model_len[2].decode(rc) << 16) |
                  ((int64_t)model_len[3].decode(rc) << 24);
        first_len = false;
        pm->fixed_len = (int)rec_len;
      } else {
        rec_len = pm->fixed_len;
      }
      if (rec_len <= 0 || i + (size_t)rec_len > out_sz) return false;
      int rev = 0;
      if (gflags & GFLAG_DO_REV) rev = model_rev.decode(rc);
      recs.push_back({i, (size_t)rec_len, rev});
      if (pm->pflags & PFLAG_DO_DEDUP) {
        if (model_dup.decode(rc)) {
          if (recs.size() < 2) return false;
          const Rec& prev = recs[recs.size() - 2];
          if (prev.len != (size_t)rec_len) return false;
          memcpy(out + i, out + prev.start, rec_len);
          i += rec_len;
          continue;
        }
      }
      st = State();
      st.p = (int)rec_len;
      st.s = s;
      ctx = pm->context;
    }
    int q = qm->get(ctx).decode(rc);
    out[i++] = (pm->pflags & PFLAG_HAVE_QMAP) ? pm->qmap[q] : (uint8_t)q;
    ctx = update_ctx(*pm, st, q);
  }

  if (gflags & GFLAG_DO_REV) {
    for (const Rec& r : recs)
      if (r.rev) {
        uint8_t* a = out + r.start;
        uint8_t* b = a + r.len - 1;
        while (a < b) std::swap(*a++, *b--);
      }
  }
  return true;
}

}  // namespace c3fqz

extern "C" {

// Decode an adaptive-arithmetic payload into exactly out_sz bytes.
// Returns 0 on success, 1 on failure/unsupported (caller falls back).
int clair3t_arith_decode(const uint8_t* payload, int64_t payload_len,
                         uint8_t* out, int64_t out_sz) {
  if (payload_len <= 0 || out_sz < 0) return 1;
  try {
    return c3arith::decompress(payload, (size_t)payload_len, out,
                               (size_t)out_sz)
               ? 0
               : 1;
  } catch (...) {  // bad_alloc etc. from corrupt length fields
    return 1;
  }
}

// Decode an fqzcomp quality payload into exactly out_sz bytes.
// Returns 0 on success, 1 on failure (caller falls back).
int clair3t_fqzcomp_decode(const uint8_t* payload, int64_t payload_len,
                           uint8_t* out, int64_t out_sz) {
  if (payload_len <= 0 || out_sz < 0) return 1;
  try {
    return c3fqz::decompress(payload, (size_t)payload_len, out,
                             (size_t)out_sz)
               ? 0
               : 1;
  } catch (...) {
    return 1;
  }
}

}  // extern "C"
