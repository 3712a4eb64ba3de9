// clair3_tpu_torch native tabix indexer: the uncompressed .tbi payload of a
// coordinate-sorted BGZF VCF.
//
// C++ counterpart of the Python indexer in clair3_tpu_torch/io/tabix.py
// (tabix_payload_python, the behavioral oracle; tests/test_torch_tabix_native.py
// asserts byte-identical payloads).  The file is walked block by block as the
// Python reader walks it and inflated whole, then rows are found with memchr
// in the inflated text.  Each row is indexed at the virtual offset of its
// first byte (in the first non-empty block that holds it, however many blocks
// the row spans) up to the virtual offset one past its newline, written as
// (block << 16) | (offset + 1) in the newline's block; empty rows, `#` rows and
// a last row without a newline are not indexed.  A row spans
// [POS - 1, POS - 1 + max(1, len(REF))); a bin's chunks are merged only where
// the last one ends where the next begins; bins are written in ascending
// order and the 16 kb linear index is filled forward from 0.
//
// Whatever the Python indexer would read otherwise, or reject, is declined
// (error 2), so that the caller runs the Python indexer, which then builds
// the same index or raises what it raises: a row with fewer than four
// columns, a POS that is not plain decimal digits in [1, 2^31).  A file that
// is not BGZF as the Python reader walks it is declined too (error 1).  The
// contig names are returned as they stand; the caller checks that they
// decode as UTF-8.

#include "common.h"

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

using c3t::BlockJob;
using c3t::Buf;

namespace {

struct TabixOut {
  uint8_t* data;   // the uncompressed .tbi payload
  int64_t n;
  int32_t error;   // 0 ok, 1 not read as BGZF, 2 a row for the Python indexer
};

constexpr int kLinearShift = 14;  // 16 kb windows
constexpr int64_t kMaxPos = int64_t(1) << 31;
constexpr uint64_t kUnset = ~uint64_t(0);  // a window no row reached

using Chunks = std::vector<std::pair<uint64_t, uint64_t>>;

struct Ref {
  std::string name;
  std::unordered_map<uint32_t, Chunks> bins;
  std::vector<uint64_t> linear;   // window -> smallest virtual offset
};

uint32_t reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (beg >> 14);
  if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (beg >> 17);
  if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (beg >> 20);
  if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (beg >> 23);
  if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (beg >> 26);
  return 0;
}

// The file's blocks as the Python reader walks them: a header of 12 bytes,
// the extra field with its BC subfield, the payload, an 8-byte trailer;
// fewer than 12 bytes left end the file.  `jobs` place each block's text in
// `text`; `file_offs` hold where each block starts in the file.
bool read_blocks(const char* path, Buf* text, std::vector<BlockJob>* jobs,
                 std::vector<uint64_t>* file_offs) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  Buf comp;
  fseek(fp, 0, SEEK_END);
  long fsize = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  if (fsize < 0) {
    fclose(fp);
    return false;
  }
  comp.resize(fsize);
  bool ok = fsize == 0 || fread(comp.data(), 1, fsize, fp) == (size_t)fsize;
  fclose(fp);
  if (!ok) return false;

  size_t total = 0, off = 0;
  while (comp.size() - off >= 12) {
    uint16_t xlen;
    memcpy(&xlen, comp.data() + off + 10, 2);
    if (off + 12 + xlen > comp.size()) return false;
    const uint8_t* extra = comp.data() + off + 12;
    int64_t bsize = -1;
    for (size_t e = 0; e + 4 <= xlen;) {
      uint16_t slen;
      memcpy(&slen, extra + e + 2, 2);
      if (extra[e] == 'B' && extra[e + 1] == 'C' && slen == 2) {
        if (e + 6 > xlen) return false;
        uint16_t bs;
        memcpy(&bs, extra + e + 4, 2);
        bsize = (int64_t)bs + 1;
      }
      e += 4 + slen;
    }
    if (bsize < 12 + (int64_t)xlen + 8 || off + (size_t)bsize > comp.size())
      return false;
    size_t comp_off = off + 12 + xlen, comp_len = bsize - 12 - xlen - 8;
    uint32_t isize;
    memcpy(&isize, comp.data() + off + bsize - 4, 4);
    // an empty block is not inflated: its payload has to be no payload or
    // the empty final deflate block, as the EOF block's is
    if (isize == 0 && comp_len != 0 &&
        !(comp_len == 2 && comp[comp_off] == 3 && comp[comp_off + 1] == 0))
      return false;
    jobs->push_back({comp_off, comp_len, total, isize});
    file_offs->push_back(off);
    total += isize;
    off += bsize;
  }
  text->resize(total);
  return c3t::inflate_blocks_parallel(comp.data(), *jobs, text->data(),
                                      c3t::default_inflate_threads());
}

// POS as plain decimal digits in [1, 2^31); false for anything else
bool parse_pos(const uint8_t* s, const uint8_t* e, int64_t* pos) {
  if (s == e || e - s > 10) return false;
  int64_t v = 0;
  for (; s < e; ++s) {
    if (*s < '0' || *s > '9') return false;
    v = v * 10 + (*s - '0');
  }
  if (v < 1 || v >= kMaxPos) return false;
  *pos = v;
  return true;
}

void put32(std::vector<uint8_t>* out, uint32_t v) {
  out->insert(out->end(), reinterpret_cast<uint8_t*>(&v), reinterpret_cast<uint8_t*>(&v) + 4);
}

void put64(std::vector<uint8_t>* out, uint64_t v) {
  out->insert(out->end(), reinterpret_cast<uint8_t*>(&v), reinterpret_cast<uint8_t*>(&v) + 8);
}

std::vector<uint8_t> serialize(const std::deque<Ref>& refs) {
  std::vector<uint8_t> out = {'T', 'B', 'I', 1};
  put32(&out, (uint32_t)refs.size());
  // format=2 (VCF), col_seq=1, col_beg=2, col_end=0, meta='#', skip=0
  for (uint32_t v : {2u, 1u, 2u, 0u, (uint32_t)'#', 0u}) put32(&out, v);
  size_t l_nm = 0;
  for (const Ref& r : refs) l_nm += r.name.size() + 1;
  put32(&out, (uint32_t)l_nm);
  for (const Ref& r : refs) out.insert(out.end(), r.name.c_str(), r.name.c_str() + r.name.size() + 1);
  for (const Ref& r : refs) {
    std::vector<uint32_t> keys;
    keys.reserve(r.bins.size());
    for (const auto& kv : r.bins) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());
    put32(&out, (uint32_t)keys.size());
    for (uint32_t b : keys) {
      const Chunks& chunks = r.bins.at(b);
      put32(&out, b);
      put32(&out, (uint32_t)chunks.size());
      for (const auto& c : chunks) {
        put64(&out, c.first);
        put64(&out, c.second);
      }
    }
    put32(&out, (uint32_t)r.linear.size());
    uint64_t prev = 0;
    for (size_t w = 0; w < r.linear.size(); ++w) {
      if (r.linear[w] != kUnset) prev = r.linear[w];
      put64(&out, prev);
    }
  }
  return out;
}

}  // namespace

extern "C" {

TabixOut* clair3t_tabix_index(const char* path) {
  auto* out = new TabixOut();
  memset(out, 0, sizeof(TabixOut));
  Buf text;
  std::vector<BlockJob> blocks;
  std::vector<uint64_t> file_offs;
  if (!read_blocks(path, &text, &blocks, &file_offs)) {
    out->error = 1;
    return out;
  }
  std::deque<Ref> refs;
  std::unordered_map<std::string, int> ref_id;
  int rid = -1;                     // the last row's contig
  size_t bi = 0, ni = 0;            // blocks of the row's first byte and of its newline
  const uint8_t* base = text.data();
  const uint8_t* end_all = base + text.size();
  for (const uint8_t* p = base; p < end_all;) {
    const uint8_t* nl = static_cast<const uint8_t*>(memchr(p, '\n', end_all - p));
    if (!nl) break;  // a last row without a newline is not indexed
    const uint8_t* next = nl + 1;
    if (nl == p || *p == '#') {
      p = next;
      continue;
    }
    // CHROM, POS, ID, REF: the first four tab-separated columns
    const uint8_t* t1 = static_cast<const uint8_t*>(memchr(p, '\t', nl - p));
    const uint8_t* t2 = t1 ? static_cast<const uint8_t*>(memchr(t1 + 1, '\t', nl - t1 - 1)) : nullptr;
    const uint8_t* t3 = t2 ? static_cast<const uint8_t*>(memchr(t2 + 1, '\t', nl - t2 - 1)) : nullptr;
    int64_t pos1;
    if (!t3 || !parse_pos(t1 + 1, t2, &pos1)) {
      out->error = 2;
      return out;
    }
    const uint8_t* t4 = static_cast<const uint8_t*>(memchr(t3 + 1, '\t', nl - t3 - 1));
    const int64_t ref_len = (t4 ? t4 : nl) - (t3 + 1);
    const int64_t beg = pos1 - 1;
    const int64_t end = beg + std::max<int64_t>(1, ref_len);

    // the row's virtual offsets: its first byte, one past its newline
    const size_t s = p - base, e = nl - base;
    // the text ends with the last block, so a block holds each of s and e
    while (s >= blocks[bi].out_off + blocks[bi].isize) ++bi;
    while (e >= blocks[ni].out_off + blocks[ni].isize) ++ni;
    const uint64_t voff = (file_offs[bi] << 16) | (uint64_t)(s - blocks[bi].out_off);
    const uint64_t end_voff = (file_offs[ni] << 16) | (uint64_t)(e + 1 - blocks[ni].out_off);

    const size_t name_len = t1 - p;
    if (rid < 0 || refs[rid].name.size() != name_len ||
        memcmp(refs[rid].name.data(), p, name_len) != 0) {
      std::string name(reinterpret_cast<const char*>(p), name_len);
      auto it = ref_id.find(name);
      if (it == ref_id.end()) {
        it = ref_id.emplace(name, (int)refs.size()).first;
        refs.emplace_back();
        refs.back().name = std::move(name);
      }
      rid = it->second;
    }
    Ref& ref = refs[rid];
    Chunks& chunks = ref.bins[reg2bin(beg, end)];
    if (!chunks.empty() && chunks.back().second == voff)
      chunks.back().second = end_voff;
    else
      chunks.emplace_back(voff, end_voff);
    const int64_t w_end = ((end - 1) >> kLinearShift) + 1;
    if ((int64_t)ref.linear.size() < w_end) ref.linear.resize(w_end, kUnset);
    for (int64_t w = beg >> kLinearShift; w < w_end; ++w)
      ref.linear[w] = std::min(ref.linear[w], voff);
    p = next;
  }
  std::vector<uint8_t> payload = serialize(refs);
  out->n = (int64_t)payload.size();
  out->data = static_cast<uint8_t*>(malloc(payload.size()));
  memcpy(out->data, payload.data(), payload.size());
  return out;
}

void clair3t_tabix_free(TabixOut* out) {
  if (!out) return;
  free(out->data);
  delete out;
}

}  // extern "C"
