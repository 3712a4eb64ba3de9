// Shared native helpers: BGZF decompression and BAM record iteration.
// Self-contained (zlib only); see clair3_tpu_torch/io/bam.py for the Python
// reference implementation of the same formats.
#pragma once

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "inflate.h"

namespace c3t {

// allocator that skips value-initialization: BGZF decode buffers are fully
// overwritten by inflate, so the default zero-fill of vector::resize is a
// wasted pass over tens of MB
template <typename T>
struct NoInitAlloc : std::allocator<T> {
  template <typename U>
  struct rebind { using other = NoInitAlloc<U>; };
  NoInitAlloc() = default;
  template <typename U>
  NoInitAlloc(const NoInitAlloc<U>&) {}
  template <typename U, typename... Args>
  void construct(U* p, Args&&... args) {
    if constexpr (sizeof...(Args) > 0)
      ::new ((void*)p) U(std::forward<Args>(args)...);
  }
};

using Buf = std::vector<uint8_t, NoInitAlloc<uint8_t>>;

// Parallel inflate of pre-scanned BGZF blocks.  Each block is independent;
// a header scan collects (compressed offset/len, output offset), then a
// small thread pool inflates into the preallocated output.
struct BlockJob {
  size_t comp_off;
  size_t comp_len;
  size_t out_off;
  uint32_t isize;
};

inline bool inflate_blocks_parallel(const uint8_t* comp,
                                    const std::vector<BlockJob>& jobs,
                                    uint8_t* out, int n_threads) {
  if (jobs.empty()) return true;
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min<int>(n_threads, (int)jobs.size());
  std::vector<uint8_t> failed(n_threads, 0);
  auto work = [&](int t) {
    for (size_t i = t; i < jobs.size(); i += n_threads) {
      const BlockJob& j = jobs[i];
      if (j.isize == 0) continue;
      // fast path: own raw-deflate decoder (~1.5-2x zlib, inflate.h);
      // structural failure falls back to zlib below
      if (c3t_inflate::raw_inflate(comp + j.comp_off, j.comp_len,
                                   out + j.out_off, j.isize))
        continue;
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) { failed[t] = 1; continue; }
      zs.next_in = const_cast<uint8_t*>(comp + j.comp_off);
      zs.avail_in = (uInt)j.comp_len;
      zs.next_out = out + j.out_off;
      zs.avail_out = j.isize;
      int ret = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (ret != Z_STREAM_END || zs.avail_out != 0) failed[t] = 1;
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  for (auto f : failed)
    if (f) return false;
  return true;
}

inline int default_inflate_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? std::min(4u, hw) : 1;
}

constexpr uint16_t kFilterFlag = 2316;  // UNMAP|MUNMAP|SECONDARY|SUPPLEMENTARY
inline const char* kSeqNt16 = "=ACMGRSVTWYHKDBN";

inline bool bgzf_read_all(const char* path, Buf* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  Buf comp;
  fseek(fp, 0, SEEK_END);
  long fsize = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  comp.resize(fsize);
  if (fsize > 0 && fread(comp.data(), 1, fsize, fp) != (size_t)fsize) {
    fclose(fp);
    return false;
  }
  fclose(fp);

  // pass 1: scan block headers
  std::vector<BlockJob> jobs;
  size_t total = 0;
  size_t off = 0;
  while (off + 18 <= comp.size()) {
    if (comp[off] != 0x1f || comp[off + 1] != 0x8b) return false;
    uint16_t xlen;
    memcpy(&xlen, comp.data() + off + 10, 2);
    if (off + 12 + xlen + 8 > comp.size()) return false;  // truncated header
    size_t extra = off + 12;
    int bsize = -1;
    size_t eoff = 0;
    while (eoff + 4 <= xlen) {
      uint8_t si1 = comp[extra + eoff], si2 = comp[extra + eoff + 1];
      uint16_t slen;
      memcpy(&slen, comp.data() + extra + eoff + 2, 2);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        uint16_t bs;
        memcpy(&bs, comp.data() + extra + eoff + 4, 2);
        bsize = bs + 1;
      }
      eoff += 4 + slen;
    }
    if (bsize < (int)(12 + xlen + 8) || off + (size_t)bsize > comp.size())
      return false;  // corrupt size / truncated block
    uint32_t isize;
    memcpy(&isize, comp.data() + off + bsize - 4, 4);
    jobs.push_back({off + 12 + xlen, (size_t)(bsize - 12 - xlen - 8), total, isize});
    total += isize;
    off += bsize;
  }

  // pass 2: parallel inflate
  out->resize(total);
  return inflate_blocks_parallel(comp.data(), jobs, out->data(),
                                 default_inflate_threads());
}

// decompress only blocks with file offset in [coffset_begin, coffset_end]
inline bool bgzf_read_range(const char* path, uint64_t coffset_begin,
                            uint64_t coffset_end, Buf* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  if (fseek(fp, (long)coffset_begin, SEEK_SET) != 0) {
    fclose(fp);
    return false;
  }
  // read the compressed window in one go, then scan + parallel inflate.
  // The last needed block's size is unknown until its header is read, so
  // read up to coffset_end + 64KiB (max BGZF block size).
  fseek(fp, 0, SEEK_END);
  uint64_t fsize = (uint64_t)ftell(fp);
  uint64_t read_end = coffset_end + 65536 < fsize ? coffset_end + 65536 : fsize;
  fseek(fp, (long)coffset_begin, SEEK_SET);
  Buf comp(read_end - coffset_begin);
  if (!comp.empty() && fread(comp.data(), 1, comp.size(), fp) != comp.size()) {
    fclose(fp);
    return false;
  }
  fclose(fp);

  std::vector<BlockJob> jobs;
  size_t total = 0;
  size_t off = 0;
  while (coffset_begin + off <= coffset_end && off + 18 <= comp.size()) {
    if (comp[off] != 0x1f || comp[off + 1] != 0x8b) return false;
    uint16_t xlen;
    memcpy(&xlen, comp.data() + off + 10, 2);
    if (off + 12 + xlen + 8 > comp.size()) return false;  // truncated header
    int bsize = -1;
    size_t eoff = 0;
    while (eoff + 4 <= xlen) {
      uint16_t slen;
      memcpy(&slen, comp.data() + off + 12 + eoff + 2, 2);
      if (comp[off + 12 + eoff] == 'B' && comp[off + 12 + eoff + 1] == 'C' && slen == 2) {
        uint16_t bs;
        memcpy(&bs, comp.data() + off + 12 + eoff + 4, 2);
        bsize = bs + 1;
      }
      eoff += 4 + slen;
    }
    if (bsize < (int)(12 + xlen + 8) || off + (size_t)bsize > comp.size())
      return false;
    uint32_t isize;
    memcpy(&isize, comp.data() + off + bsize - 4, 4);
    jobs.push_back({off + 12 + xlen, (size_t)(bsize - 12 - xlen - 8), total, isize});
    total += isize;
    off += bsize;
  }
  out->resize(total);
  return inflate_blocks_parallel(comp.data(), jobs, out->data(),
                                 default_inflate_threads());
}

struct BamView {
  Buf data;
  std::vector<std::string> refs;
  std::vector<int32_t> ref_lens;
  size_t records_off = 0;

  // indexed load: only the blocks covering [voff_begin, voff_end]; record
  // parsing starts at voff_begin's in-block offset.  Caller supplies tid.
  bool load_range(const char* path, uint64_t voff_begin, uint64_t voff_end) {
    if (!bgzf_read_range(path, voff_begin >> 16, voff_end >> 16, &data))
      return false;
    records_off = voff_begin & 0xFFFF;
    return records_off <= data.size();
  }

  // multi-range indexed load: inflate each [vb, ve] chunk, trim to the
  // exact virtual offsets, and concatenate (chunks are record-aligned by
  // construction, so the result is a contiguous record stream).  Two-pass:
  // scan every window's BGZF headers first, size `data` once, then decode
  // interior blocks straight into their final position — the per-window
  // bounce buffer + concat copy of the naive scheme doubles memory traffic
  // on a 200+ MB chunk and showed up as ~half of load wall time on the
  // chromosome-scale soak.
  bool load_ranges(const char* path, const uint64_t* voffs, int n_win) {
    data.clear();
    records_off = 0;
    FILE* fp = fopen(path, "rb");
    if (!fp) return false;
    fseek(fp, 0, SEEK_END);
    uint64_t fsize = (uint64_t)ftell(fp);
    struct Win {
      Buf comp;
      std::vector<BlockJob> jobs;  // out_off relative to window decode start
      size_t head = 0;             // logical keep-range within the window
      size_t end_off = 0;
      size_t out_base = 0;         // where the kept bytes land in `data`
    };
    std::vector<Win> wins((size_t)n_win);
    size_t total_kept = 0;
    for (int w = 0; w < n_win; w++) {
      Win& win = wins[w];
      uint64_t vb = voffs[2 * w], ve = voffs[2 * w + 1];
      uint64_t cb = vb >> 16, ce = ve >> 16;
      size_t head = vb & 0xFFFF, tail = ve & 0xFFFF;
      // read the compressed window (+64KiB so the last block is complete)
      uint64_t read_end = ce + 65536 < fsize ? ce + 65536 : fsize;
      if (fseek(fp, (long)cb, SEEK_SET) != 0) { fclose(fp); return false; }
      win.comp.resize(read_end - cb);
      if (!win.comp.empty() &&
          fread(win.comp.data(), 1, win.comp.size(), fp) != win.comp.size()) {
        fclose(fp);
        return false;
      }
      const Buf& comp = win.comp;
      size_t total = 0;
      size_t off = 0;
      size_t last_block_out = 0;  // uncompressed offset of ce's block
      bool saw_last = false;
      while (cb + off <= ce && off + 18 <= comp.size()) {
        if (comp[off] != 0x1f || comp[off + 1] != 0x8b) { fclose(fp); return false; }
        uint16_t xlen;
        memcpy(&xlen, comp.data() + off + 10, 2);
        if (off + 12 + xlen + 8 > comp.size()) { fclose(fp); return false; }
        int bsize = -1;
        size_t eoff = 0;
        while (eoff + 4 <= xlen) {
          uint16_t slen;
          memcpy(&slen, comp.data() + off + 12 + eoff + 2, 2);
          if (comp[off + 12 + eoff] == 'B' && comp[off + 12 + eoff + 1] == 'C' && slen == 2) {
            uint16_t bs;
            memcpy(&bs, comp.data() + off + 12 + eoff + 4, 2);
            bsize = bs + 1;
          }
          eoff += 4 + slen;
        }
        if (bsize < (int)(12 + xlen + 8) || off + (size_t)bsize > comp.size()) {
          fclose(fp);
          return false;
        }
        uint32_t isize;
        memcpy(&isize, comp.data() + off + bsize - 4, 4);
        if (cb + off == ce) {
          last_block_out = total;
          saw_last = true;
          if (tail == 0) break;  // range ends at this block's start
        }
        win.jobs.push_back({off + 12 + xlen, (size_t)(bsize - 12 - xlen - 8), total, isize});
        total += isize;
        off += bsize;
      }
      size_t end_off = saw_last ? last_block_out + tail : total;
      if (end_off > total) end_off = total;
      if (head > end_off) head = end_off;
      win.head = head;
      win.end_off = end_off;
      win.out_base = total_kept;
      total_kept += end_off - head;
    }
    fclose(fp);
    if (n_win == 1) {
      // single window: head bytes stay in place, trimmed logically via
      // records_off, so every block is "interior" and decodes in place
      records_off = wins[0].head;
      wins[0].head = 0;
      total_kept = wins[0].end_off;
    }
    data.resize(total_kept);
    Buf scratch;
    for (auto& win : wins) {
      std::vector<BlockJob> direct;
      direct.reserve(win.jobs.size());
      for (const BlockJob& j : win.jobs) {
        if (j.isize == 0) continue;
        size_t b0 = j.out_off, b1 = b0 + j.isize;
        if (b1 <= win.head || b0 >= win.end_off) continue;  // fully trimmed
        if (b0 >= win.head && b1 <= win.end_off) {
          direct.push_back(
              {j.comp_off, j.comp_len, win.out_base + (b0 - win.head), j.isize});
          continue;
        }
        // boundary block: decode to scratch, copy the kept intersection
        scratch.resize(j.isize);
        std::vector<BlockJob> one{{j.comp_off, j.comp_len, 0, j.isize}};
        if (!inflate_blocks_parallel(win.comp.data(), one, scratch.data(), 1))
          return false;
        size_t s0 = std::max(b0, win.head), s1 = std::min(b1, win.end_off);
        memcpy(data.data() + win.out_base + (s0 - win.head),
               scratch.data() + (s0 - b0), s1 - s0);
      }
      if (!inflate_blocks_parallel(win.comp.data(), direct, data.data(),
                                   default_inflate_threads()))
        return false;
    }
    return true;
  }

  bool load(const char* path) {
    if (!bgzf_read_all(path, &data)) return false;
    if (data.size() < 8 || memcmp(data.data(), "BAM\x01", 4) != 0) return false;
    int32_t l_text;
    memcpy(&l_text, data.data() + 4, 4);
    size_t off = 8 + l_text;
    int32_t n_ref;
    memcpy(&n_ref, data.data() + off, 4);
    off += 4;
    for (int i = 0; i < n_ref; i++) {
      int32_t l_name;
      memcpy(&l_name, data.data() + off, 4);
      off += 4;
      refs.emplace_back((const char*)data.data() + off, l_name - 1);
      off += l_name;
      int32_t l_ref;
      memcpy(&l_ref, data.data() + off, 4);
      off += 4;
      ref_lens.push_back(l_ref);
    }
    records_off = off;
    return true;
  }

  int tid_of(const char* name) const {
    for (size_t i = 0; i < refs.size(); i++)
      if (refs[i] == name) return (int)i;
    return -1;
  }
};

struct RecView {
  int32_t tid, pos;
  uint8_t mapq;
  uint16_t flag;
  int32_t l_seq;
  const uint32_t* cigar;
  uint16_t n_cigar;
  const uint8_t* seq;   // 4-bit packed
  const uint8_t* qual;
  const char* qname;
  const uint8_t* tags;
  size_t tags_len;
};

inline char seq_base(const RecView& r, int64_t qp) {
  return kSeqNt16[(r.seq[qp >> 1] >> ((~qp & 1) << 2)) & 0xF];
}

template <typename F>
void for_each_record(const BamView& bam, F cb) {
  size_t off = bam.records_off;
  const uint8_t* d = bam.data.data();
  size_t n = bam.data.size();
  while (off + 4 <= n) {
    int32_t block_size;
    memcpy(&block_size, d + off, 4);
    if (block_size < 32 || off + 4 + (size_t)block_size > n) return;  // truncated
    size_t p = off + 4;
    RecView r;
    memcpy(&r.tid, d + p, 4);
    memcpy(&r.pos, d + p + 4, 4);
    uint8_t l_qname = d[p + 8];
    r.mapq = d[p + 9];
    memcpy(&r.n_cigar, d + p + 12, 2);
    memcpy(&r.flag, d + p + 14, 2);
    memcpy(&r.l_seq, d + p + 16, 4);
    // validate the variable-length sections fit inside the record
    size_t need = 32ull + l_qname + 4ull * r.n_cigar +
                  ((size_t)r.l_seq + 1) / 2 + (size_t)r.l_seq;
    if (r.l_seq < 0 || need > (size_t)block_size) {
      off += 4 + block_size;  // skip malformed record
      continue;
    }
    size_t q = p + 32;
    r.qname = (const char*)(d + q);
    q += l_qname;
    r.cigar = (const uint32_t*)(d + q);
    q += 4ull * r.n_cigar;
    r.seq = d + q;
    q += (r.l_seq + 1) / 2;
    r.qual = d + q;
    q += r.l_seq;
    r.tags = d + q;
    r.tags_len = (off + 4 + block_size) - q;
    if (!cb(r)) return;
    off += 4 + block_size;
  }
}

inline int64_t ref_span(const RecView& r) {
  int64_t span = 0;
  for (int i = 0; i < r.n_cigar; i++) {
    uint32_t op = r.cigar[i] & 0xF, len = r.cigar[i] >> 4;
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += len;
  }
  return span;
}

// xorshift64* PRNG shared with the Python extractor for identical read
// subsampling decisions (seeded per candidate).
struct XorShift64 {
  uint64_t state;
  explicit XorShift64(uint64_t seed) : state(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    uint64_t x = state;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    state = x;
    return x * 0x2545F4914F6CDD1Dull;
  }
  // unbiased-enough bounded draw for shuffling
  uint64_t below(uint64_t n) { return next() % n; }
};

}  // namespace c3t
