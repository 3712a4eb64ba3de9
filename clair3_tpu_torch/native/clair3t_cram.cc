// clair3_tpu_torch native CRAM 3.0 -> indexed BAM converter.
//
// Production fast path for CRAM input (the Python reader in io/cram.py is
// the behavioral oracle; differential tests assert identical records).  The
// reference reads CRAM through htslib (reference: README.md:127); this is a
// self-contained reimplementation: container/slice parsing, the FULL block
// codec matrix (raw / gzip via the fast inflate / bzip2 / lzma / rANS 4x8 /
// rANS Nx16 / adaptive arithmetic incl. the EXT=embedded-bzip2 transform /
// fqzcomp / tok3 — clair3t_{rans,rans_nx16,arith,bzip2,xz}.cc), record
// codecs (EXTERNAL / HUFFMAN / BETA / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP),
// read-feature reconstruction against the reference FASTA, and streaming
// BGZF BAM output with an on-the-fly BAI index.
//
// Anything unsupported (exotic record codecs, unsorted records, corrupt
// streams) returns a nonzero error and the Python wrapper falls back to
// the pure-Python converter, so capability is never lost.

#include "common.h"

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

extern "C" int clair3t_rans_decode(const uint8_t* payload, int64_t payload_len,
                                   uint8_t* out, int64_t out_sz);
extern "C" int64_t clair3t_bzip2_decode(const uint8_t* data, int64_t n,
                                        uint8_t* out, int64_t out_cap);
extern "C" int64_t clair3t_xz_decode(const uint8_t* data, int64_t n,
                                     uint8_t* out, int64_t out_cap);
extern "C" int clair3t_rans_nx16_decode(const uint8_t* payload,
                                        int64_t payload_len, uint8_t* out,
                                        int64_t out_sz);
extern "C" int clair3t_arith_decode(const uint8_t* payload,
                                    int64_t payload_len, uint8_t* out,
                                    int64_t out_sz);
extern "C" int clair3t_fqzcomp_decode(const uint8_t* payload,
                                      int64_t payload_len, uint8_t* out,
                                      int64_t out_sz);
extern "C" int clair3t_tok3_decode(const uint8_t* payload, int64_t payload_len,
                                   uint8_t* out, int64_t out_sz);

namespace {

using c3t::Buf;

// error codes (mirrored in native/__init__.py for messages)
enum {
  OK = 0,
  E_IO = 1,
  E_MAGIC = 2,
  E_UNSUPPORTED = 3,   // fall back to Python
  E_CORRUPT = 4,
  E_UNSORTED = 5,      // fall back to Python (it sorts)
  E_REF = 6,
};

// ---------------------------------------------------------------------------
// ITF8 / LTF8
// ---------------------------------------------------------------------------

struct Cur {
  const uint8_t* d;
  size_t n;
  size_t p = 0;
  bool fail = false;

  uint8_t u8() {
    if (p >= n) { fail = true; return 0; }
    return d[p++];
  }
  bool take(size_t k, const uint8_t** out) {
    if (p + k > n) { fail = true; return false; }
    *out = d + p;
    p += k;
    return true;
  }
};

int64_t read_itf8(Cur& c) {
  uint32_t b0 = c.u8();
  uint32_t v;
  if (b0 < 0x80) v = b0;
  else if (b0 < 0xC0) v = ((b0 & 0x7F) << 8) | c.u8();
  else if (b0 < 0xE0) { v = (b0 & 0x3F) << 16; v |= (uint32_t)c.u8() << 8; v |= c.u8(); }
  else if (b0 < 0xF0) { v = (b0 & 0x1F) << 24; v |= (uint32_t)c.u8() << 16; v |= (uint32_t)c.u8() << 8; v |= c.u8(); }
  else {
    v = (b0 & 0x0F) << 28;
    v |= (uint32_t)c.u8() << 20;
    v |= (uint32_t)c.u8() << 12;
    v |= (uint32_t)c.u8() << 4;
    v |= c.u8() & 0x0F;
  }
  return (int32_t)v;  // negative int32 wraps
}

int64_t read_ltf8(Cur& c) {
  uint32_t b0 = c.u8();
  int nn = 0;
  while (nn < 8 && ((b0 << nn) & 0x80)) nn++;
  if (nn == 0) return b0;
  uint64_t v;
  if (nn < 8) {
    v = b0 & (0xFF >> (nn + 1));
    for (int k = 0; k < nn; k++) v = (v << 8) | c.u8();
  } else {
    v = 0;
    for (int k = 0; k < 8; k++) v = (v << 8) | c.u8();
  }
  return (int64_t)v;
}

// ---------------------------------------------------------------------------
// block decompression
// ---------------------------------------------------------------------------

bool gunzip_block(const uint8_t* in, size_t in_len, uint8_t* out, size_t out_len) {
  // gzip wrapper: magic, flags, optional extras, then raw deflate
  if (in_len < 18 || in[0] != 0x1f || in[1] != 0x8b || in[2] != 8) return false;
  uint8_t flg = in[3];
  size_t p = 10;
  if (flg & 4) {  // FEXTRA
    if (p + 2 > in_len) return false;
    uint16_t xlen = in[p] | (in[p + 1] << 8);
    p += 2 + xlen;
  }
  if (flg & 8) { while (p < in_len && in[p]) p++; p++; }   // FNAME
  if (flg & 16) { while (p < in_len && in[p]) p++; p++; }  // FCOMMENT
  if (flg & 2) p += 2;                                      // FHCRC
  if (p >= in_len) return false;
  if (c3t_inflate::raw_inflate(in + p, in_len - p - 8, out, out_len))
    return true;
  // fallback: zlib with gzip wrapping
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(in);
  zs.avail_in = (uInt)in_len;
  zs.next_out = out;
  zs.avail_out = (uInt)out_len;
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return ret == Z_STREAM_END && zs.avail_out == 0;
}

struct Block {
  int method = 0;
  int ctype = 0;
  int64_t cid = 0;
  Buf data;
};

int read_block(Cur& c, Block* b) {
  b->method = c.u8();
  b->ctype = c.u8();
  b->cid = read_itf8(c);
  int64_t comp_sz = read_itf8(c);
  int64_t raw_sz = read_itf8(c);
  // lying block sizes must not drive multi-GB allocations (bad_alloc
  // aborts across the C ABI); real CRAM slices are << 1 GB
  if (c.fail || comp_sz < 0 || raw_sz < 0 || raw_sz > (1ll << 31))
    return E_CORRUPT;
  const uint8_t* comp;
  if (!c.take((size_t)comp_sz, &comp)) return E_CORRUPT;
  c.p += 4;  // CRC32 (not verified, matching the Python reader)
  b->data.resize(raw_sz);
  switch (b->method) {
    case 0:  // raw
      if (comp_sz != raw_sz) return E_CORRUPT;
      memcpy(b->data.data(), comp, raw_sz);
      return OK;
    case 1:  // gzip
      return gunzip_block(comp, comp_sz, b->data.data(), raw_sz) ? OK : E_CORRUPT;
    case 2:  // bzip2 (clair3t_bzip2.cc; oracle: stdlib bz2)
      return clair3t_bzip2_decode(comp, comp_sz, b->data.data(), raw_sz)
                     == raw_sz
                 ? OK : E_CORRUPT;
    case 3:  // lzma/.xz (clair3t_xz.cc; oracle: stdlib lzma)
      return clair3t_xz_decode(comp, comp_sz, b->data.data(), raw_sz)
                     == raw_sz
                 ? OK : E_CORRUPT;
    case 4:  // rANS 4x8
      return clair3t_rans_decode(comp, comp_sz, b->data.data(), raw_sz) == 0
                 ? OK : E_CORRUPT;
    case 5:  // rANS Nx16 (CRAM 3.1)
      return clair3t_rans_nx16_decode(comp, comp_sz, b->data.data(), raw_sz)
                     == 0
                 ? OK : E_UNSUPPORTED;
    case 6:  // adaptive arithmetic (CRAM 3.1; incl. EXT = embedded bzip2)
      return clair3t_arith_decode(comp, comp_sz, b->data.data(), raw_sz) == 0
                 ? OK : E_UNSUPPORTED;
    case 7:  // fqzcomp quality codec (CRAM 3.1)
      return clair3t_fqzcomp_decode(comp, comp_sz, b->data.data(), raw_sz) == 0
                 ? OK : E_UNSUPPORTED;
    case 8:  // tok3 name tokeniser (CRAM 3.1; rANS or arith streams)
      return clair3t_tok3_decode(comp, comp_sz, b->data.data(), raw_sz) == 0
                 ? OK : E_UNSUPPORTED;
    default:
      return E_UNSUPPORTED;  // unknown method id -> Python path
  }
}

// ---------------------------------------------------------------------------
// record codecs
// ---------------------------------------------------------------------------

struct CoreBits {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t p = 0;
  int bit = 0;
  bool fail = false;

  uint32_t read(int nbits) {
    uint32_t v = 0;
    for (int k = 0; k < nbits; k++) {
      if (p >= n) { fail = true; return v; }
      v = (v << 1) | ((d[p] >> (7 - bit)) & 1);
      if (++bit == 8) { bit = 0; p++; }
    }
    return v;
  }
};

struct Ext {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t p = 0;
};

struct Codec;
using CodecPtr = std::unique_ptr<Codec>;

struct Codec {
  int id = 0;
  // EXTERNAL / BYTE_ARRAY_STOP
  int64_t content_id = 0;
  uint8_t stop = 0;
  // HUFFMAN (canonical, mirrors io/cram.py Codec._build_huffman)
  std::vector<int64_t> alphabet;
  std::vector<int> bit_lens;
  std::vector<std::pair<uint64_t, int64_t>> dec;  // (len<<32|code) -> sym
  int max_len = 0;
  // BETA
  int64_t offset = 0;
  int nbits = 0;
  // BYTE_ARRAY_LEN
  CodecPtr len_codec, val_codec;
};

constexpr int C_EXTERNAL = 1, C_HUFFMAN = 3, C_BYTE_ARRAY_LEN = 4,
              C_BYTE_ARRAY_STOP = 5, C_BETA = 6;

int parse_codec(Cur& c, CodecPtr* out);

int build_huffman(Codec* cd) {
  size_t m = cd->alphabet.size();
  std::vector<size_t> order(m);
  for (size_t i = 0; i < m; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    return cd->bit_lens[a] < cd->bit_lens[b];
  });
  uint64_t code = 0;
  int prev_len = 0;
  cd->max_len = 0;
  for (size_t k = 0; k < m; k++) {
    size_t i = order[k];
    int ln = cd->bit_lens[i];
    if (ln > 32) return E_UNSUPPORTED;
    code <<= (ln - prev_len);
    cd->dec.emplace_back(((uint64_t)ln << 32) | code, cd->alphabet[i]);
    prev_len = ln;
    code += 1;
    if (ln > cd->max_len) cd->max_len = ln;
  }
  std::sort(cd->dec.begin(), cd->dec.end());
  return OK;
}

int parse_codec_params(int cid, Cur& pc, Codec* cd) {
  cd->id = cid;
  switch (cid) {
    case C_EXTERNAL:
      cd->content_id = read_itf8(pc);
      break;
    case C_HUFFMAN: {
      int64_t n = read_itf8(pc);
      if (n < 0 || n > 1'000'000) return E_CORRUPT;
      for (int64_t i = 0; i < n; i++) cd->alphabet.push_back(read_itf8(pc));
      int64_t n2 = read_itf8(pc);
      if (n2 != n) return E_CORRUPT;
      for (int64_t i = 0; i < n; i++) cd->bit_lens.push_back((int)read_itf8(pc));
      if (pc.fail) return E_CORRUPT;
      return build_huffman(cd);
    }
    case C_BETA:
      cd->offset = read_itf8(pc);
      cd->nbits = (int)read_itf8(pc);
      break;
    case C_BYTE_ARRAY_LEN: {
      int rc = parse_codec(pc, &cd->len_codec);
      if (rc) return rc;
      rc = parse_codec(pc, &cd->val_codec);
      if (rc) return rc;
      break;
    }
    case C_BYTE_ARRAY_STOP:
      cd->stop = pc.u8();
      cd->content_id = read_itf8(pc);
      break;
    default:
      return E_UNSUPPORTED;  // gamma/golomb/subexp -> Python path
  }
  return pc.fail ? E_CORRUPT : OK;
}

int parse_codec(Cur& c, CodecPtr* out) {
  int64_t cid = read_itf8(c);
  int64_t plen = read_itf8(c);
  if (c.fail || plen < 0) return E_CORRUPT;
  const uint8_t* params;
  if (!c.take((size_t)plen, &params)) return E_CORRUPT;
  *out = std::make_unique<Codec>();
  Cur pc{params, (size_t)plen};
  return parse_codec_params((int)cid, pc, out->get());
}

struct Slice;

int64_t codec_int(const Codec& cd, CoreBits& core, std::map<int64_t, Ext>& ext,
                  bool* ok);

int64_t huffman_int(const Codec& cd, CoreBits& core, bool* ok) {
  if (cd.max_len == 0) return cd.alphabet.empty() ? (*ok = false, 0) : cd.alphabet[0];
  uint64_t code = 0;
  for (int ln = 1; ln <= cd.max_len; ln++) {
    code = (code << 1) | core.read(1);
    uint64_t key = ((uint64_t)ln << 32) | code;
    auto it = std::lower_bound(cd.dec.begin(), cd.dec.end(),
                               std::make_pair(key, INT64_MIN));
    if (it != cd.dec.end() && it->first == key) return it->second;
    if (core.fail) break;
  }
  *ok = false;
  return 0;
}

int64_t ext_itf8(Ext& e, bool* ok) {
  Cur c{e.d, e.n, e.p};
  int64_t v = read_itf8(c);
  if (c.fail) { *ok = false; return 0; }
  e.p = c.p;
  return v;
}

int64_t codec_int(const Codec& cd, CoreBits& core, std::map<int64_t, Ext>& ext,
                  bool* ok) {
  switch (cd.id) {
    case C_EXTERNAL: {
      auto it = ext.find(cd.content_id);
      if (it == ext.end()) { *ok = false; return 0; }
      return ext_itf8(it->second, ok);
    }
    case C_HUFFMAN:
      return huffman_int(cd, core, ok);
    case C_BETA: {
      int64_t v = (int64_t)core.read(cd.nbits) - cd.offset;
      if (core.fail) *ok = false;
      return v;
    }
    default:
      *ok = false;
      return 0;
  }
}

int codec_byte(const Codec& cd, CoreBits& core, std::map<int64_t, Ext>& ext,
               bool* ok) {
  if (cd.id == C_EXTERNAL) {
    auto it = ext.find(cd.content_id);
    if (it == ext.end() || it->second.p >= it->second.n) { *ok = false; return 0; }
    return it->second.d[it->second.p++];
  }
  return (int)codec_int(cd, core, ext, ok);
}

bool codec_bytes(const Codec& cd, CoreBits& core, std::map<int64_t, Ext>& ext,
                 int64_t length, std::string* out) {
  out->clear();
  if (cd.id == C_BYTE_ARRAY_STOP) {
    auto it = ext.find(cd.content_id);
    if (it == ext.end()) return false;
    Ext& e = it->second;
    size_t q = e.p;
    while (q < e.n && e.d[q] != cd.stop) q++;
    if (q >= e.n) return false;
    out->assign((const char*)e.d + e.p, q - e.p);
    e.p = q + 1;
    return true;
  }
  if (cd.id == C_BYTE_ARRAY_LEN) {
    bool ok = true;
    int64_t n = codec_int(*cd.len_codec, core, ext, &ok);
    if (!ok || n < 0) return false;
    const Codec& vc = *cd.val_codec;
    if (vc.id == C_EXTERNAL) {
      auto it = ext.find(vc.content_id);
      if (it == ext.end()) return false;
      Ext& e = it->second;
      if (e.p + (size_t)n > e.n) return false;
      out->assign((const char*)e.d + e.p, (size_t)n);
      e.p += (size_t)n;
      return true;
    }
    for (int64_t i = 0; i < n; i++) {
      int b = codec_byte(vc, core, ext, &ok);
      if (!ok) return false;
      out->push_back((char)b);
    }
    return true;
  }
  if (cd.id == C_EXTERNAL) {
    if (length < 0) return false;
    auto it = ext.find(cd.content_id);
    if (it == ext.end()) return false;
    Ext& e = it->second;
    if (e.p + (size_t)length > e.n) return false;
    out->assign((const char*)e.d + e.p, (size_t)length);
    e.p += (size_t)length;
    return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// compression header
// ---------------------------------------------------------------------------

struct CompHeader {
  bool rn_preserved = true;
  bool ap_delta = true;
  bool ref_required = true;
  uint8_t sub_matrix[5] = {0, 0, 0, 0, 0};
  std::vector<std::vector<std::pair<std::string, char>>> tag_dict;
  std::map<std::string, CodecPtr> data_series;
  std::map<int64_t, CodecPtr> tag_codecs;

  const Codec* ds(const char* key) const {
    auto it = data_series.find(key);
    return it == data_series.end() ? nullptr : it->second.get();
  }
};

int parse_comp_header(const Buf& data, CompHeader* h) {
  Cur c{data.data(), data.size()};
  read_itf8(c);  // preservation map byte size
  int64_t n = read_itf8(c);
  for (int64_t i = 0; i < n && !c.fail; i++) {
    const uint8_t* k;
    if (!c.take(2, &k)) return E_CORRUPT;
    std::string key((const char*)k, 2);
    if (key == "RN") h->rn_preserved = c.u8() != 0;
    else if (key == "AP") h->ap_delta = c.u8() != 0;
    else if (key == "RR") h->ref_required = c.u8() != 0;
    else if (key == "SM") {
      const uint8_t* sm;
      if (!c.take(5, &sm)) return E_CORRUPT;
      memcpy(h->sub_matrix, sm, 5);
    } else if (key == "TD") {
      int64_t blen = read_itf8(c);
      const uint8_t* blob;
      if (blen < 0 || !c.take((size_t)blen, &blob)) return E_CORRUPT;
      // NUL-separated lines of 3-byte (tag,tag,type) triplets
      size_t q = 0;
      while (q < (size_t)blen) {
        size_t e = q;
        while (e < (size_t)blen && blob[e] != 0) e++;
        std::vector<std::pair<std::string, char>> tags;
        for (size_t t = q; t + 3 <= e; t += 3)
          tags.emplace_back(std::string((const char*)blob + t, 2), (char)blob[t + 2]);
        h->tag_dict.push_back(std::move(tags));
        q = e + 1;
      }
      if (h->tag_dict.empty()) h->tag_dict.push_back({});
    } else {
      return E_UNSUPPORTED;
    }
  }
  read_itf8(c);  // data-series map byte size
  n = read_itf8(c);
  for (int64_t i = 0; i < n && !c.fail; i++) {
    const uint8_t* k;
    if (!c.take(2, &k)) return E_CORRUPT;
    CodecPtr cd;
    int rc = parse_codec(c, &cd);
    if (rc) return rc;
    h->data_series[std::string((const char*)k, 2)] = std::move(cd);
  }
  read_itf8(c);  // tag-encoding map byte size
  n = read_itf8(c);
  for (int64_t i = 0; i < n && !c.fail; i++) {
    int64_t key = read_itf8(c);
    CodecPtr cd;
    int rc = parse_codec(c, &cd);
    if (rc) return rc;
    h->tag_codecs[key] = std::move(cd);
  }
  return c.fail ? E_CORRUPT : OK;
}

// substitution matrix: code -> base given the reference base
char sub_base(const CompHeader& h, char ref_base, int code) {
  static const char* B5 = "ACGTN";
  const char* r5 = strchr(B5, toupper(ref_base));
  int r = r5 ? (int)(r5 - B5) : 4;
  uint8_t row = h.sub_matrix[r];
  int k = 0;
  for (int bi = 0; bi < 5; bi++) {
    if (bi == r) continue;
    if (((row >> (6 - 2 * k)) & 3) == code) return B5[bi];
    k++;
  }
  return 'N';
}

// ---------------------------------------------------------------------------
// reference FASTA (fai-backed contig loads)
// ---------------------------------------------------------------------------

struct FastaRef {
  struct Contig { int64_t length, offset, linebases, linewidth; };
  std::map<std::string, Contig> contigs;
  std::string path;
  std::map<std::string, std::string> cache;

  bool open(const char* fa_path) {
    path = fa_path;
    std::string fai = path + ".fai";
    FILE* fp = fopen(fai.c_str(), "rb");
    if (!fp) return false;
    char line[4096];
    while (fgets(line, sizeof(line), fp)) {
      char name[2048];
      long long ln, off, lb, lw;
      if (sscanf(line, "%2047s %lld %lld %lld %lld", name, &ln, &off, &lb, &lw) == 5)
        contigs[name] = {ln, off, lb, lw};
    }
    fclose(fp);
    return !contigs.empty();
  }

  const std::string* fetch(const std::string& name) {
    auto it = cache.find(name);
    if (it != cache.end()) return &it->second;
    auto ct = contigs.find(name);
    if (ct == contigs.end()) return nullptr;
    const Contig& c = ct->second;
    FILE* fp = fopen(path.c_str(), "rb");
    if (!fp) return nullptr;
    int64_t nlines = (c.length + c.linebases - 1) / c.linebases;
    int64_t fbytes = c.length + nlines * (c.linewidth - c.linebases);
    std::string raw(fbytes, 0);
    fseek(fp, (long)c.offset, SEEK_SET);
    size_t got = fread(raw.data(), 1, fbytes, fp);
    fclose(fp);
    if ((int64_t)got != fbytes) return nullptr;
    std::string seq;
    seq.reserve(c.length);
    for (char ch : raw)
      if (ch != '\n' && ch != '\r') seq.push_back((char)toupper(ch));
    seq.resize(c.length);
    auto ins = cache.emplace(name, std::move(seq));
    return &ins.first->second;
  }
};

// ---------------------------------------------------------------------------
// BGZF BAM writer + BAI
// ---------------------------------------------------------------------------

struct BgzfOut {
  FILE* fp = nullptr;
  Buf pending;                       // uncompressed bytes not yet flushed
  uint64_t upos = 0;                 // total uncompressed bytes flushed
  std::vector<std::pair<uint64_t, uint64_t>> blocks;  // (ustart, file offset)

  bool open(const char* path) {
    fp = fopen(path, "wb");
    return fp != nullptr;
  }

  void write(const void* d, size_t k) {
    const uint8_t* b = (const uint8_t*)d;
    pending.insert(pending.end(), b, b + k);
    // batch so the per-block deflates run on a thread pool
    const size_t batch = 60000 * (size_t)c3t::default_inflate_threads() * 2;
    if (pending.size() >= batch) flush_pending(pending.size() / 60000 * 60000);
  }

  // compress `k` pending bytes as 60000-byte BGZF blocks (parallel deflate)
  // and write them in order
  bool flush_pending(size_t k) {
    if (k == 0 || pending.empty()) return true;
    k = std::min(k, pending.size());
    size_t n_blk = (k + 59999) / 60000;
    struct Out { std::vector<uint8_t> comp; uint32_t crc, isize; };
    std::vector<Out> outs(n_blk);
    int n_threads = std::min<int>(c3t::default_inflate_threads(), (int)n_blk);
    auto work = [&](int t) {
      for (size_t b = t; b < n_blk; b += n_threads) {
        size_t lo = b * 60000;
        size_t len = std::min<size_t>(60000, k - lo);
        uLongf bound = compressBound(len) + 64;
        outs[b].comp.resize(bound);
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        deflateInit2(&zs, 4, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);
        zs.next_in = pending.data() + lo;
        zs.avail_in = (uInt)len;
        zs.next_out = outs[b].comp.data();
        zs.avail_out = (uInt)bound;
        deflate(&zs, Z_FINISH);
        outs[b].comp.resize(bound - zs.avail_out);
        deflateEnd(&zs);
        outs[b].crc = crc32(0, pending.data() + lo, (uInt)len);
        outs[b].isize = (uint32_t)len;
      }
    };
    if (n_threads <= 1) {
      work(0);
    } else {
      std::vector<std::thread> ths;
      for (int t = 0; t < n_threads; t++) ths.emplace_back(work, t);
      for (auto& th : ths) th.join();
    }
    for (size_t b = 0; b < n_blk; b++) {
      blocks.emplace_back(upos, (uint64_t)ftell(fp));
      size_t clen = outs[b].comp.size();
      uint16_t bsize = (uint16_t)(clen + 25);  // total block size - 1
      uint8_t hdr[18] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff,
                         6, 0, 'B', 'C', 2, 0,
                         (uint8_t)(bsize & 0xFF), (uint8_t)(bsize >> 8)};
      fwrite(hdr, 1, 18, fp);
      fwrite(outs[b].comp.data(), 1, clen, fp);
      fwrite(&outs[b].crc, 4, 1, fp);
      fwrite(&outs[b].isize, 4, 1, fp);
      upos += outs[b].isize;
    }
    pending.erase(pending.begin(), pending.begin() + k);
    return true;
  }

  uint64_t voff_at(uint64_t u) const {
    // binary search the block containing uncompressed position u
    size_t lo = 0, hi = blocks.empty() ? 0 : blocks.size() - 1;
    while (lo < hi) {
      size_t mid = (lo + hi + 1) / 2;
      if (blocks[mid].first <= u) lo = mid;
      else hi = mid - 1;
    }
    if (blocks.empty()) return 0;
    return (blocks[lo].second << 16) | (u - blocks[lo].first);
  }

  void close_with_eof() {
    while (!pending.empty()) flush_pending(pending.size());
    static const uint8_t kEof[28] = {
        0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00, 0x42,
        0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0, 0, 0, 0, 0, 0, 0, 0};
    fwrite(kEof, 1, 28, fp);
    fclose(fp);
    fp = nullptr;
  }
};

int reg2bin(int64_t beg, int64_t end) {
  end -= 1;
  if (beg >> 14 == end >> 14) return (int)(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return (int)(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return (int)(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return (int)(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return (int)(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

struct RecIndex {
  int32_t tid;
  int64_t pos, end;     // 0-based, end exclusive (>= pos+1)
  uint64_t ustart, uend;
};

bool write_bai(const char* bai_path, int n_ref,
               const std::vector<RecIndex>& recs, const BgzfOut& out) {
  std::vector<std::map<int, std::vector<std::pair<uint64_t, uint64_t>>>> bins(n_ref);
  std::vector<std::map<int64_t, uint64_t>> linear(n_ref);
  for (const auto& r : recs) {
    if (r.tid < 0 || r.tid >= n_ref) continue;
    uint64_t vb = out.voff_at(r.ustart);
    uint64_t ve = out.voff_at(r.uend);
    int b = reg2bin(r.pos, r.end);
    auto& lst = bins[r.tid][b];
    if (!lst.empty() && lst.back().second >= vb)
      lst.back().second = std::max(lst.back().second, ve);
    else
      lst.emplace_back(vb, ve);
    for (int64_t w = r.pos >> 14; w <= (r.end - 1) >> 14; w++) {
      auto it = linear[r.tid].find(w);
      if (it == linear[r.tid].end() || vb < it->second) linear[r.tid][w] = vb;
    }
  }
  FILE* fp = fopen(bai_path, "wb");
  if (!fp) return false;
  fwrite("BAI\x01", 1, 4, fp);
  int32_t nr = n_ref;
  fwrite(&nr, 4, 1, fp);
  for (int rid = 0; rid < n_ref; rid++) {
    int32_t nbin = (int32_t)bins[rid].size();
    fwrite(&nbin, 4, 1, fp);
    for (auto& [b, chunks] : bins[rid]) {
      uint32_t bb = (uint32_t)b;
      int32_t nch = (int32_t)chunks.size();
      fwrite(&bb, 4, 1, fp);
      fwrite(&nch, 4, 1, fp);
      for (auto& [cb, ce] : chunks) {
        fwrite(&cb, 8, 1, fp);
        fwrite(&ce, 8, 1, fp);
      }
    }
    int32_t n_intv = 0;
    std::vector<uint64_t> ioff;
    if (!linear[rid].empty()) {
      n_intv = (int32_t)(linear[rid].rbegin()->first + 1);
      uint64_t prev = 0;
      for (int64_t w = 0; w < n_intv; w++) {
        auto it = linear[rid].find(w);
        if (it != linear[rid].end()) prev = it->second;
        ioff.push_back(prev);
      }
    }
    fwrite(&n_intv, 4, 1, fp);
    for (uint64_t v : ioff) fwrite(&v, 8, 1, fp);
  }
  fclose(fp);
  return true;
}

// ---------------------------------------------------------------------------
// record decode -> BAM serialization
// ---------------------------------------------------------------------------

int8_t nt16_of(char c) {
  static int8_t tab[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) tab[i] = 15;  // N
    const char* s = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 16; i++) {
      tab[(uint8_t)s[i]] = (int8_t)i;
      tab[(uint8_t)tolower(s[i])] = (int8_t)i;
    }
    init = true;
  }
  return tab[(uint8_t)c];
}

constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3, OP_S = 4, OP_H = 5,
              OP_P = 6;

struct CigBuild {
  std::vector<uint32_t> ops;
  void add(int op, int64_t ln) {
    if (ln <= 0) return;
    if (!ops.empty() && (int)(ops.back() & 0xF) == op)
      ops.back() += (uint32_t)(ln << 4);
    else
      ops.push_back((uint32_t)((ln << 4) | op));
  }
};

struct DecodedRec {
  std::string qname;
  uint16_t flag;
  int32_t tid;
  int64_t pos0;
  uint8_t mapq;
  std::vector<uint32_t> cigar;
  std::string seq;
  std::string qual;   // raw phred bytes (0xFF when absent)
  std::string tags;   // BAM aux wire format
  int32_t next_tid;
  int64_t next_pos0;
  int64_t tlen;
  int64_t ref_end0;   // pos0 + ref span (>= pos0+1)
};

// one slice's worth of decoding state
struct SliceCtx {
  const CompHeader* comp;
  CoreBits core;
  std::map<int64_t, Ext> ext;
  int32_t slice_ref_id;
  int64_t slice_start1;
  const std::string* embedded_ref = nullptr;
  int64_t embedded_off = 0;
};

char ref_base_at(SliceCtx& sc, FastaRef* fa,
                 const std::vector<std::string>& refs, int tid, int64_t pos0,
                 bool* ok) {
  if (sc.embedded_ref && tid == sc.slice_ref_id) {
    int64_t i = pos0 - sc.embedded_off;
    if (i >= 0 && i < (int64_t)sc.embedded_ref->size())
      return (char)toupper((*sc.embedded_ref)[i]);
    return 'N';
  }
  if (!fa || tid < 0 || tid >= (int)refs.size()) {
    *ok = false;  // reference required but unavailable -> caller falls back
    return 'N';
  }
  const std::string* seq = fa->fetch(refs[tid]);
  if (!seq) { *ok = false; return 'N'; }
  if (pos0 < 0 || pos0 >= (int64_t)seq->size()) return 'N';
  return (*seq)[pos0];
}

}  // namespace

extern "C" {

// Convert a CRAM 3.0 file to an indexed BAM.  Returns 0 on success; any
// nonzero code means "use the Python fallback" (unsupported feature,
// unsorted records) or a hard error.
static int cram_to_bam_impl(const char* cram_path, const char* ref_fa,
                            const char* out_bam);

int clair3t_cram_to_bam(const char* cram_path, const char* ref_fa,
                        const char* out_bam) {
  try {
    return cram_to_bam_impl(cram_path, ref_fa, out_bam);
  } catch (...) {  // bad_alloc etc. from corrupt size fields
    return E_CORRUPT;
  }
}

static int cram_to_bam_impl(const char* cram_path, const char* ref_fa,
                            const char* out_bam) {
  FILE* fp = fopen(cram_path, "rb");
  if (!fp) return E_IO;
  uint8_t magic[6];
  if (fread(magic, 1, 6, fp) != 6 || memcmp(magic, "CRAM", 4) != 0) {
    fclose(fp);
    return E_MAGIC;
  }
  if (magic[4] != 3 && magic[4] != 2) { fclose(fp); return E_UNSUPPORTED; }
  fseek(fp, 20, SEEK_CUR);  // file id

  auto read_container = [&](Buf* payload, bool* eof) -> int {
    *eof = false;
    uint8_t len4[4];
    if (fread(len4, 1, 4, fp) != 4) { *eof = true; return OK; }
    int32_t length;
    memcpy(&length, len4, 4);
    // bounded header chunk
    uint8_t hdr[1024];
    size_t got = fread(hdr, 1, sizeof(hdr), fp);
    Cur c{hdr, got};
    int64_t ref_seq_id = read_itf8(c);
    read_itf8(c);  // start
    read_itf8(c);  // span
    int64_t n_records = read_itf8(c);
    read_ltf8(c);  // counter
    read_ltf8(c);  // bases
    int64_t n_blocks = read_itf8(c);
    int64_t n_land = read_itf8(c);
    for (int64_t i = 0; i < n_land; i++) read_itf8(c);
    c.p += 4;  // crc
    if (c.fail) return E_CORRUPT;
    fseek(fp, (long)c.p - (long)got, SEEK_CUR);
    if (ref_seq_id == -1 && n_records == 0 && n_blocks == 1 && length <= 15) {
      *eof = true;  // EOF container
      return OK;
    }
    payload->resize(length);
    if (length > 0 && fread(payload->data(), 1, length, fp) != (size_t)length)
      return E_CORRUPT;
    return OK;
  };

  // ---- SAM header container ----
  Buf payload;
  bool eof = false;
  int rc = read_container(&payload, &eof);
  if (rc || eof) { fclose(fp); return rc ? rc : E_CORRUPT; }
  Cur pc{payload.data(), payload.size()};
  Block hdr_block;
  rc = read_block(pc, &hdr_block);
  if (rc || hdr_block.ctype != 0 || hdr_block.data.size() < 4) {
    fclose(fp);
    return rc ? rc : E_CORRUPT;
  }
  int32_t text_len;
  memcpy(&text_len, hdr_block.data.data(), 4);
  if (text_len < 0 || (size_t)text_len + 4 > hdr_block.data.size()) {
    fclose(fp);
    return E_CORRUPT;
  }
  std::string header_text((const char*)hdr_block.data.data() + 4, text_len);

  // refs from @SQ lines
  std::vector<std::string> refs;
  std::vector<int64_t> ref_lens;
  {
    size_t q = 0;
    while (q < header_text.size()) {
      size_t e = header_text.find('\n', q);
      if (e == std::string::npos) e = header_text.size();
      std::string line = header_text.substr(q, e - q);
      if (line.rfind("@SQ", 0) == 0) {
        std::string name;
        int64_t ln = 0;
        size_t f = 0;
        while (f < line.size()) {
          size_t t = line.find('\t', f + 1);
          if (t == std::string::npos) t = line.size();
          std::string field = line.substr(f + (f ? 1 : 0), t - f - (f ? 1 : 0));
          if (field.rfind("SN:", 0) == 0) name = field.substr(3);
          else if (field.rfind("LN:", 0) == 0) ln = atoll(field.c_str() + 3);
          f = t;
        }
        if (!name.empty()) {
          refs.push_back(name);
          ref_lens.push_back(ln);
        }
      }
      q = e + 1;
    }
  }

  FastaRef fasta;
  bool have_fa = ref_fa && ref_fa[0] && fasta.open(ref_fa);

  // ---- BAM output ----
  BgzfOut out;
  if (!out.open(out_bam)) { fclose(fp); return E_IO; }
  {
    Buf bh;
    auto put = [&](const void* d, size_t k) {
      const uint8_t* b = (const uint8_t*)d;
      bh.insert(bh.end(), b, b + k);
    };
    put("BAM\x01", 4);
    int32_t lt = (int32_t)header_text.size();
    put(&lt, 4);
    put(header_text.data(), header_text.size());
    int32_t nr = (int32_t)refs.size();
    put(&nr, 4);
    for (size_t i = 0; i < refs.size(); i++) {
      int32_t ln_name = (int32_t)refs[i].size() + 1;
      put(&ln_name, 4);
      put(refs[i].c_str(), ln_name);
      int32_t rl = (int32_t)ref_lens[i];
      put(&rl, 4);
    }
    out.write(bh.data(), bh.size());
  }

  std::vector<RecIndex> index;
  int64_t counter = 0;
  int32_t last_tid = -2;
  int64_t last_wpos = -1;

  // ---- data containers ----
  for (;;) {
    rc = read_container(&payload, &eof);
    if (rc) { fclose(fp); return rc; }
    if (eof) break;
    Cur c{payload.data(), payload.size()};
    Block comp_block;
    rc = read_block(c, &comp_block);
    if (rc) { fclose(fp); return rc; }
    if (comp_block.ctype != 1) { fclose(fp); return E_CORRUPT; }
    CompHeader comp;
    rc = parse_comp_header(comp_block.data, &comp);
    if (rc) { fclose(fp); return rc; }

    while (c.p < c.n) {
      Block sl_block;
      rc = read_block(c, &sl_block);
      if (rc) { fclose(fp); return rc; }
      if (sl_block.ctype != 2) { fclose(fp); return E_CORRUPT; }
      Cur sc_cur{sl_block.data.data(), sl_block.data.size()};
      int64_t sl_ref = read_itf8(sc_cur);
      int64_t sl_start = read_itf8(sc_cur);
      read_itf8(sc_cur);  // span
      int64_t sl_nrec = read_itf8(sc_cur);
      read_ltf8(sc_cur);  // counter
      int64_t sl_nblocks = read_itf8(sc_cur);
      int64_t n_ids = read_itf8(sc_cur);
      for (int64_t i = 0; i < n_ids; i++) read_itf8(sc_cur);
      int64_t emb_ref_id = read_itf8(sc_cur);
      if (sc_cur.fail) { fclose(fp); return E_CORRUPT; }

      SliceCtx sc;
      sc.comp = &comp;
      sc.slice_ref_id = (int32_t)sl_ref;
      sc.slice_start1 = sl_start;

      std::vector<Block> ext_blocks;
      ext_blocks.reserve(sl_nblocks);
      Block core_block;
      bool have_core = false;
      for (int64_t b = 0; b < sl_nblocks; b++) {
        Block blk;
        rc = read_block(c, &blk);
        if (rc) { fclose(fp); return rc; }
        if (blk.ctype == 5) {
          core_block = std::move(blk);
          have_core = true;
        } else {
          ext_blocks.push_back(std::move(blk));
        }
      }
      if (have_core) {
        sc.core.d = core_block.data.data();
        sc.core.n = core_block.data.size();
      }
      std::string embedded;
      for (auto& blk : ext_blocks) {
        sc.ext[blk.cid] = Ext{blk.data.data(), blk.data.size()};
        if (emb_ref_id >= 0 && blk.cid == emb_ref_id) {
          embedded.assign((const char*)blk.data.data(), blk.data.size());
        }
      }
      if (!embedded.empty()) {
        sc.embedded_ref = &embedded;
        sc.embedded_off = sl_start - 1;
      }

      // required series
      const Codec* BF = comp.ds("BF");
      const Codec* CF = comp.ds("CF");
      const Codec* RL = comp.ds("RL");
      const Codec* AP = comp.ds("AP");
      const Codec* RG = comp.ds("RG");
      if (!BF || !CF || !RL || !AP) { fclose(fp); return E_UNSUPPORTED; }

      int64_t last_pos1 = sl_start;
      bool ok = true;
      for (int64_t i = 0; i < sl_nrec; i++) {
        DecodedRec r;
        int64_t bf = codec_int(*BF, sc.core, sc.ext, &ok);
        int64_t cf = codec_int(*CF, sc.core, sc.ext, &ok);
        int64_t tid = sl_ref;
        if (sl_ref == -2) {
          const Codec* RI = comp.ds("RI");
          if (!RI) { fclose(fp); return E_UNSUPPORTED; }
          tid = codec_int(*RI, sc.core, sc.ext, &ok);
        }
        int64_t rl = codec_int(*RL, sc.core, sc.ext, &ok);
        int64_t ap = codec_int(*AP, sc.core, sc.ext, &ok);
        int64_t pos1 = comp.ap_delta ? last_pos1 + ap : ap;
        if (comp.ap_delta) last_pos1 = pos1;
        if (RG) codec_int(*RG, sc.core, sc.ext, &ok);
        if (!ok || rl < 0) { fclose(fp); return E_CORRUPT; }

        std::string qname;
        bool have_name = false;
        if (comp.rn_preserved) {
          const Codec* RN = comp.ds("RN");
          if (!RN || !codec_bytes(*RN, sc.core, sc.ext, -1, &qname)) {
            fclose(fp);
            return E_UNSUPPORTED;
          }
          have_name = true;
        }
        uint16_t flag = (uint16_t)bf;
        int64_t next_tid = -1, next_pos0 = -1, tlen = 0;
        if (cf & 0x2) {  // detached
          const Codec* MF = comp.ds("MF");
          if (!MF) { fclose(fp); return E_UNSUPPORTED; }
          int64_t mf = codec_int(*MF, sc.core, sc.ext, &ok);
          if (!comp.rn_preserved) {
            const Codec* RN = comp.ds("RN");
            if (!RN || !codec_bytes(*RN, sc.core, sc.ext, -1, &qname)) {
              fclose(fp);
              return E_UNSUPPORTED;
            }
            have_name = true;
          }
          const Codec* NS = comp.ds("NS");
          const Codec* NP = comp.ds("NP");
          const Codec* TS = comp.ds("TS");
          if (!NS || !NP || !TS) { fclose(fp); return E_UNSUPPORTED; }
          next_tid = codec_int(*NS, sc.core, sc.ext, &ok);
          next_pos0 = codec_int(*NP, sc.core, sc.ext, &ok) - 1;
          tlen = codec_int(*TS, sc.core, sc.ext, &ok);
          if (mf & 0x1) flag |= 0x20;
          if (mf & 0x2) flag |= 0x8;
        } else if (cf & 0x4) {
          const Codec* NF = comp.ds("NF");
          if (!NF) { fclose(fp); return E_UNSUPPORTED; }
          codec_int(*NF, sc.core, sc.ext, &ok);
        }
        if (!have_name) {
          char buf[32];
          snprintf(buf, sizeof(buf), "cram.%lld", (long long)(counter + i));
          qname = buf;
        }

        // tags
        const Codec* TL = comp.ds("TL");
        if (!TL) { fclose(fp); return E_UNSUPPORTED; }
        int64_t tl = codec_int(*TL, sc.core, sc.ext, &ok);
        if (!ok || tl < 0 || tl >= (int64_t)comp.tag_dict.size()) {
          fclose(fp);
          return E_CORRUPT;
        }
        for (auto& [tname, ttyp] : comp.tag_dict[tl]) {
          int64_t key = ((int64_t)(uint8_t)tname[0] << 16) |
                        ((int64_t)(uint8_t)tname[1] << 8) | (uint8_t)ttyp;
          auto tc = comp.tag_codecs.find(key);
          if (tc == comp.tag_codecs.end()) { fclose(fp); return E_UNSUPPORTED; }
          std::string raw;
          if (!codec_bytes(*tc->second, sc.core, sc.ext, -1, &raw)) {
            fclose(fp);
            return E_CORRUPT;
          }
          r.tags += tname;
          r.tags += ttyp;
          r.tags += raw;
        }

        r.flag = flag;
        r.tid = (int32_t)tid;
        r.pos0 = pos1 - 1;
        r.next_tid = (int32_t)next_tid;
        r.next_pos0 = next_pos0;
        r.tlen = tlen;
        r.qname = std::move(qname);

        if (!(bf & 0x4)) {  // mapped
          const Codec* FN = comp.ds("FN");
          const Codec* FC = comp.ds("FC");
          const Codec* FP = comp.ds("FP");
          const Codec* MQ = comp.ds("MQ");
          if (!FN || !FC || !FP || !MQ) { fclose(fp); return E_UNSUPPORTED; }
          int64_t fn = codec_int(*FN, sc.core, sc.ext, &ok);
          if (!ok || fn < 0) { fclose(fp); return E_CORRUPT; }

          std::string seq(rl, 'N');
          std::map<int64_t, uint8_t> qover;
          CigBuild cig;
          int64_t read_i = 0;
          int64_t ref_i = pos1 - 1;
          int64_t fpos = 0;
          bool ref_ok = true;

          auto fill_match = [&](int64_t nmatch) {
            if (nmatch <= 0) return;
            for (int64_t k = 0; k < nmatch; k++)
              seq[read_i + k] =
                  ref_base_at(sc, have_fa ? &fasta : nullptr, refs,
                              (int)tid, ref_i + k, &ref_ok);
            cig.add(OP_M, nmatch);
            read_i += nmatch;
            ref_i += nmatch;
          };

          for (int64_t f = 0; f < fn; f++) {
            int fc = codec_byte(*FC, sc.core, sc.ext, &ok);
            fpos += codec_int(*FP, sc.core, sc.ext, &ok);
            if (!ok) { fclose(fp); return E_CORRUPT; }
            if (fpos - 1 > rl) { fclose(fp); return E_CORRUPT; }
            fill_match((fpos - 1) - read_i);  // no-op when fpos lags read_i
            std::string bytes_payload;
            switch (fc) {
              case 'B': {
                const Codec* BA = comp.ds("BA");
                const Codec* QS = comp.ds("QS");
                if (!BA || !QS) { fclose(fp); return E_UNSUPPORTED; }
                int base = codec_byte(*BA, sc.core, sc.ext, &ok);
                int q = codec_byte(*QS, sc.core, sc.ext, &ok);
                if (read_i >= rl) { fclose(fp); return E_CORRUPT; }
                seq[read_i] = (char)base;
                qover[read_i] = (uint8_t)q;
                cig.add(OP_M, 1);
                read_i++;
                ref_i++;
                break;
              }
              case 'X': {
                const Codec* BS = comp.ds("BS");
                if (!BS) { fclose(fp); return E_UNSUPPORTED; }
                int code = (int)codec_int(*BS, sc.core, sc.ext, &ok);
                if (read_i >= rl) { fclose(fp); return E_CORRUPT; }
                char rb = ref_base_at(sc, have_fa ? &fasta : nullptr, refs,
                                      (int)tid, ref_i, &ref_ok);
                seq[read_i] = sub_base(comp, rb, code);
                cig.add(OP_M, 1);
                read_i++;
                ref_i++;
                break;
              }
              case 'I': {
                const Codec* IN = comp.ds("IN");
                if (!IN || !codec_bytes(*IN, sc.core, sc.ext, -1, &bytes_payload)) {
                  fclose(fp);
                  return E_UNSUPPORTED;
                }
                if (read_i + (int64_t)bytes_payload.size() > rl) {
                  fclose(fp);
                  return E_CORRUPT;
                }
                memcpy(&seq[read_i], bytes_payload.data(), bytes_payload.size());
                cig.add(OP_I, bytes_payload.size());
                read_i += bytes_payload.size();
                break;
              }
              case 'i': {
                const Codec* BA = comp.ds("BA");
                if (!BA) { fclose(fp); return E_UNSUPPORTED; }
                int base = codec_byte(*BA, sc.core, sc.ext, &ok);
                if (read_i >= rl) { fclose(fp); return E_CORRUPT; }
                seq[read_i] = (char)base;
                cig.add(OP_I, 1);
                read_i++;
                break;
              }
              case 'S': {
                const Codec* SC = comp.ds("SC");
                if (!SC || !codec_bytes(*SC, sc.core, sc.ext, -1, &bytes_payload)) {
                  fclose(fp);
                  return E_UNSUPPORTED;
                }
                if (read_i + (int64_t)bytes_payload.size() > rl) {
                  fclose(fp);
                  return E_CORRUPT;
                }
                memcpy(&seq[read_i], bytes_payload.data(), bytes_payload.size());
                cig.add(OP_S, bytes_payload.size());
                read_i += bytes_payload.size();
                break;
              }
              case 'D': {
                const Codec* DL = comp.ds("DL");
                if (!DL) { fclose(fp); return E_UNSUPPORTED; }
                int64_t d = codec_int(*DL, sc.core, sc.ext, &ok);
                cig.add(OP_D, d);
                ref_i += d;
                break;
              }
              case 'N': {
                const Codec* RS = comp.ds("RS");
                if (!RS) { fclose(fp); return E_UNSUPPORTED; }
                int64_t d = codec_int(*RS, sc.core, sc.ext, &ok);
                cig.add(OP_N, d);
                ref_i += d;
                break;
              }
              case 'H': {
                const Codec* HC = comp.ds("HC");
                if (!HC) { fclose(fp); return E_UNSUPPORTED; }
                cig.add(OP_H, codec_int(*HC, sc.core, sc.ext, &ok));
                break;
              }
              case 'P': {
                const Codec* PD = comp.ds("PD");
                if (!PD) { fclose(fp); return E_UNSUPPORTED; }
                cig.add(OP_P, codec_int(*PD, sc.core, sc.ext, &ok));
                break;
              }
              case 'Q': {
                const Codec* QS = comp.ds("QS");
                if (!QS) { fclose(fp); return E_UNSUPPORTED; }
                qover[fpos - 1] = (uint8_t)codec_byte(*QS, sc.core, sc.ext, &ok);
                break;
              }
              case 'b': {
                const Codec* BB = comp.ds("BB");
                if (!BB || !codec_bytes(*BB, sc.core, sc.ext, -1, &bytes_payload)) {
                  fclose(fp);
                  return E_UNSUPPORTED;
                }
                if (read_i + (int64_t)bytes_payload.size() > rl) {
                  fclose(fp);
                  return E_CORRUPT;
                }
                memcpy(&seq[read_i], bytes_payload.data(), bytes_payload.size());
                cig.add(OP_M, bytes_payload.size());
                read_i += bytes_payload.size();
                ref_i += bytes_payload.size();
                break;
              }
              case 'q': {
                const Codec* QQ = comp.ds("QQ");
                if (!QQ || !codec_bytes(*QQ, sc.core, sc.ext, -1, &bytes_payload)) {
                  fclose(fp);
                  return E_UNSUPPORTED;
                }
                for (size_t k = 0; k < bytes_payload.size(); k++)
                  qover[fpos - 1 + (int64_t)k] = (uint8_t)bytes_payload[k];
                break;
              }
              default:
                fclose(fp);
                return E_UNSUPPORTED;
            }
            if (!ok) { fclose(fp); return E_CORRUPT; }
          }
          fill_match(rl - read_i);
          if (!ref_ok) { fclose(fp); return E_REF; }

          r.mapq = (uint8_t)codec_int(*MQ, sc.core, sc.ext, &ok);
          if (cf & 0x1) {
            const Codec* QS = comp.ds("QS");
            if (!QS || !codec_bytes(*QS, sc.core, sc.ext, rl, &r.qual)) {
              fclose(fp);
              return E_UNSUPPORTED;
            }
          } else {
            r.qual.assign(rl, (char)0xFF);
            for (auto& [k, q] : qover)
              if (k >= 0 && k < rl) r.qual[k] = (char)q;
          }
          r.seq = std::move(seq);
          r.cigar = std::move(cig.ops);
          r.ref_end0 = ref_i > r.pos0 ? ref_i : r.pos0 + 1;
        } else {  // unmapped
          r.mapq = 0;
          if (cf & 0x8) {
            r.seq.assign(rl, 'N');
          } else {
            const Codec* BA = comp.ds("BA");
            if (!BA || !codec_bytes(*BA, sc.core, sc.ext, rl, &r.seq)) {
              fclose(fp);
              return E_UNSUPPORTED;
            }
          }
          if (cf & 0x1) {
            const Codec* QS = comp.ds("QS");
            if (!QS || !codec_bytes(*QS, sc.core, sc.ext, rl, &r.qual)) {
              fclose(fp);
              return E_UNSUPPORTED;
            }
          } else {
            r.qual.assign(rl, (char)0xFF);
          }
          r.ref_end0 = r.pos0 + 1;
        }
        if (!ok) { fclose(fp); return E_CORRUPT; }

        // coordinate-order check (Python fallback sorts; we stream)
        if (r.tid >= 0) {
          if (last_tid >= 0 &&
              (r.tid < last_tid || (r.tid == last_tid && r.pos0 < last_wpos))) {
            fclose(fp);
            return E_UNSORTED;
          }
          last_tid = r.tid;
          last_wpos = r.pos0;
        }

        // ---- serialize to BAM ----
        uint64_t ustart = out.upos + out.pending.size();
        int32_t l_qname = (int32_t)r.qname.size() + 1;
        int32_t l_seq = (int32_t)r.seq.size();
        int32_t block_size =
            32 + l_qname + 4 * (int32_t)r.cigar.size() + (l_seq + 1) / 2 +
            l_seq + (int32_t)r.tags.size();
        uint8_t fixed[36];
        memcpy(fixed, &block_size, 4);
        int32_t tid32 = r.tid, pos32 = (int32_t)r.pos0;
        memcpy(fixed + 4, &tid32, 4);
        memcpy(fixed + 8, &pos32, 4);
        fixed[12] = (uint8_t)l_qname;
        fixed[13] = r.mapq;
        uint16_t bin = (uint16_t)(r.tid >= 0 ? reg2bin(r.pos0, r.ref_end0)
                                             : 4680);
        memcpy(fixed + 14, &bin, 2);
        uint16_t ncig = (uint16_t)r.cigar.size();
        memcpy(fixed + 16, &ncig, 2);
        memcpy(fixed + 18, &r.flag, 2);
        memcpy(fixed + 20, &l_seq, 4);
        int32_t ntid32 = r.next_tid, npos32 = (int32_t)r.next_pos0;
        int32_t tlen32 = (int32_t)r.tlen;
        memcpy(fixed + 24, &ntid32, 4);
        memcpy(fixed + 28, &npos32, 4);
        memcpy(fixed + 32, &tlen32, 4);
        out.write(fixed, 36);
        out.write(r.qname.c_str(), l_qname);
        if (!r.cigar.empty()) out.write(r.cigar.data(), 4 * r.cigar.size());
        Buf packed((l_seq + 1) / 2);
        if (!packed.empty()) memset(packed.data(), 0, packed.size());
        for (int32_t k = 0; k < l_seq; k++) {
          uint8_t nib = (uint8_t)nt16_of(r.seq[k]);
          packed[k >> 1] |= (k & 1) ? nib : (nib << 4);
        }
        out.write(packed.data(), packed.size());
        out.write(r.qual.data(), r.qual.size());
        out.write(r.tags.data(), r.tags.size());
        uint64_t uend = out.upos + out.pending.size();
        index.push_back({r.tid, r.pos0, r.ref_end0, ustart, uend});
      }
      counter += sl_nrec;
    }
  }
  fclose(fp);
  out.close_with_eof();

  std::string bai = std::string(out_bam) + ".bai";
  if (!write_bai(bai.c_str(), (int)refs.size(), index, out)) return E_IO;
  return OK;
}

}  // extern "C"
