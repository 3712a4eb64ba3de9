// clair3_tpu_torch native host extractor: BGZF + BAM decoding and pileup feature
// counting with candidate selection.
//
// This is the production fast path for the TPU-VM host feed; the numpy
// implementation in clair3_tpu_torch/pileup/extractor.py is the behavioral oracle
// (differential tests assert bit-identical outputs).  Semantics follow the
// reference C extractor (reference: src/clair3_pileup.c) as documented
// there: 18-channel per-column counts, ref-column negation, AF/depth/
// majority/tie-break candidate rules, contiguous-flank gating, alt-info
// strings, gVCF per-position ref/total counts.
//
// Self-contained: BGZF via zlib, BAM record layout per SAM spec 4.2.
// Region fetch is a linear scan with early exit on coordinate-sorted input
// (index support can be added without changing this API).

#include "common.h"

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

using c3t::BamView;
using c3t::RecView;
using c3t::for_each_record;
using c3t::ref_span;
using c3t::kFilterFlag;
using c3t::kSeqNt16;

namespace {

constexpr int kFeat = 18;
constexpr int kRevOff = 9;
constexpr int kFwdInsAll = 4, kFwdInsBest = 5;
constexpr int kFwdDelAll = 6, kFwdDelBest = 7, kFwdDel = 8;
constexpr int kFlank = 16;

int base_index(char b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

// 4-bit BAM nibble ("=ACMGRSVTWYHKDBN") -> ACGT channel index, -1 otherwise
constexpr int8_t kNt16ToIdx[16] = {
    -1, 0, 1, -1, 2, -1, -1, -1, 3, -1, -1, -1, -1, -1, -1, -1};

// Counting-pass temp layout: 12 x uint32 per column (48 B vs the 76 B/pos
// of the 18-ch int32 matrix + depth): smaller hot window, no per-base
// depth increment (depth is the channel sum at finalize), and safe at any
// real depth — amplicon runs exceed 65k reads per column, so a 16-bit
// counter would wrap silently.  Channels: A C G T N fwd | A C G T N rev |
// del-span fwd | del-span rev.
constexpr int kTmpFeat = 12;
constexpr int kTmpN = 4;       // ambiguous-base channel (depth only)
constexpr int kTmpRev = 5;
constexpr int kTmpDelF = 10, kTmpDelR = 11;
// nibble -> temp channel: non-ACGT collapses to the N channel
constexpr int8_t kNt16ToTmp[16] = {
    kTmpN, 0, 1, kTmpN, 2, kTmpN, kTmpN, kTmpN,
    3, kTmpN, kTmpN, kTmpN, kTmpN, kTmpN, kTmpN, kTmpN};

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// pileup
// ---------------------------------------------------------------------------

struct PileupOut {
  int32_t* counts;
  int32_t* depth;
  int64_t* pos_ref_count;
  int64_t* pos_total_count;
  char** alt_infos;
  int64_t* cand_pos;
  int32_t n_candidates;
  int32_t L;
  int32_t error;  // 0 ok, 1 file error, 2 contig not found
  int32_t external;  // bit 1: counts/depth caller-owned; bit 2: gVCF arrays
};

struct ColIndels {
  std::map<int, int> dels_f, dels_r;          // del_len -> count
  std::map<std::string, int> ins_f, ins_r;    // ins_seq -> count
};

// Count one genome subrange [sub_s, sub_e) into the shared arrays.  Shards
// write only their own disjoint column slice (counts/depth indexed by
// global `start`), so no synchronization is needed; per-shard indel maps
// have disjoint keys and are merged after the join.  A read spanning a
// shard boundary is counted by every shard it overlaps, each clipping to
// its own window — summing to exactly the single-thread result.
//
void count_subrange(const BamView& bam, int tid, int min_mq,
                    int64_t start, int64_t sub_s, int64_t sub_e,
                    uint32_t* tmp,
                    std::unordered_map<int64_t, ColIndels>* indels) {
  for_each_record(bam, [&](const RecView& r) -> bool {
    if (r.tid != tid) return r.tid <= tid;  // stop once past our contig
    if (r.pos >= sub_e) return false;       // coordinate-sorted early exit
    if (r.flag & kFilterFlag) return true;
    if (r.mapq < min_mq) return true;
    if (r.l_seq == 0) return true;  // SEQ '*' records carry no bases
    int64_t rend = r.pos + ref_span(r);
    if (rend <= sub_s) return true;

    bool rev = r.flag & 0x10;
    int strand = rev ? kTmpRev : 0;
    int64_t rpos = r.pos;
    int64_t qpos = 0;
    for (int ci = 0; ci < r.n_cigar; ci++) {
      uint32_t op = r.cigar[ci] & 0xF;
      int64_t len = r.cigar[ci] >> 4;
      if (op == 0 || op == 7 || op == 8) {  // M =X
        int64_t lo = std::max(rpos, sub_s), hi = std::min(rpos + len, sub_e);
        uint32_t* cp = tmp + (lo - start) * kTmpFeat + strand;
        int64_t qp = qpos + (lo - rpos);
        int64_t p = lo;
        if (p < hi && (qp & 1)) {  // align qp to a packed-byte boundary
          cp[kNt16ToTmp[r.seq[qp >> 1] & 0xF]]++;
          p++; qp++; cp += kTmpFeat;
        }
        for (; p + 1 < hi; p += 2, qp += 2, cp += 2 * kTmpFeat) {
          uint8_t byte = r.seq[qp >> 1];  // two bases per fetch
          cp[kNt16ToTmp[byte >> 4]]++;
          cp[kTmpFeat + kNt16ToTmp[byte & 0xF]]++;
        }
        if (p < hi) {
          cp[kNt16ToTmp[(r.seq[qp >> 1] >> ((~qp & 1) << 2)) & 0xF]]++;
        }
        rpos += len;
        qpos += len;
      } else if (op == 1) {  // I at anchor rpos-1
        int64_t anchor = rpos - 1;
        if (anchor >= sub_s && anchor < sub_e && anchor >= r.pos) {
          std::string seq;
          seq.reserve(len);
          for (int64_t k = 0; k < len; k++) {
            int64_t qp = qpos + k;
            seq.push_back(kSeqNt16[(r.seq[qp >> 1] >> ((~qp & 1) << 2)) & 0xF]);
          }
          auto& col = (*indels)[anchor - start];
          (rev ? col.ins_r : col.ins_f)[seq]++;
        }
        qpos += len;
      } else if (op == 2) {  // D
        int64_t anchor = rpos - 1;
        if (anchor >= sub_s && anchor < sub_e && anchor >= r.pos) {
          auto& col = (*indels)[anchor - start];
          (rev ? col.dels_r : col.dels_f)[(int)len]++;
        }
        int64_t lo = std::max(rpos, sub_s), hi = std::min(rpos + len, sub_e);
        uint32_t* cp = tmp + (lo - start) * kTmpFeat + (rev ? kTmpDelR : kTmpDelF);
        for (int64_t p = lo; p < hi; p++, cp += kTmpFeat) (*cp)++;
        rpos += len;
      } else if (op == 3) {
        rpos += len;
      } else if (op == 4) {
        qpos += len;
      }
    }
    return true;
  });
}

}  // namespace

extern "C" {

// `counts_ext`/`depth_ext` (and for gVCF `pos_ref_ext`/`pos_tot_ext`) let
// the caller supply zero-initialized output buffers (e.g. numpy arrays):
// the extractor then writes results in place — no internal allocation and
// no copy-out, which saves two full passes over the L x 18 matrix.
PileupOut* clair3t_pileup(
    const char* bam_path, const char* ctg, int64_t start, int64_t end,
    const char* ref_seq, int64_t ref_offset,
    int min_mq, int min_depth, double min_snp_af, double min_indel_af,
    int max_indel_length, int call_snp_only, int want_gvcf, int call_ht,
    const uint64_t* voffs, int n_win, int tid_hint, int n_threads,
    int32_t* counts_ext, int32_t* depth_ext,
    int64_t* pos_ref_ext, int64_t* pos_tot_ext) {
  // CLAIR3T_PROFILE=1: per-phase wall times on stderr (observability)
  const bool profile = getenv("CLAIR3T_PROFILE") != nullptr;
  auto t_start = std::chrono::steady_clock::now();
  auto lap = [&](const char* phase) {
    if (!profile) return;
    auto now = std::chrono::steady_clock::now();
    fprintf(stderr, "[clair3t_pileup] %s %.1f ms\n", phase,
            std::chrono::duration<double, std::milli>(now - t_start).count());
    t_start = now;
  };
  auto* out = new PileupOut();
  memset(out, 0, sizeof(PileupOut));
  const int64_t L = end - start;
  out->L = (int32_t)L;
  const bool external = counts_ext != nullptr && depth_ext != nullptr;
  out->external = external ? 1 : 0;

  BamView bam;
  int tid;
  if (n_win > 0) {  // indexed chunk-list load (tid supplied by the caller)
    if (!bam.load_ranges(bam_path, voffs, n_win)) {
      out->error = 1;
      return out;
    }
    tid = tid_hint;
  } else {
    if (!bam.load(bam_path)) {
      out->error = 1;
      return out;
    }
    tid = bam.tid_of(ctg);
    if (tid < 0) {
      out->error = 2;
      return out;
    }
  }

  std::vector<int32_t> counts_own, depth_own;
  int32_t* counts;
  int32_t* depth;
  if (external) {
    counts = counts_ext;  // caller guarantees zero-initialized
    depth = depth_ext;
  } else {
    counts_own.assign((size_t)L * kFeat, 0);
    depth_own.assign(L, 0);
    counts = counts_own.data();
    depth = depth_own.data();
  }
  std::unordered_map<int64_t, ColIndels> indels;
  lap("load");
  std::vector<uint32_t> tmp((size_t)L * kTmpFeat, 0);

  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? (int)hw : 1;
  }
  // genome-subrange sharding; below ~64kb per shard the re-scan of record
  // headers outweighs the counting win
  int shards = (int)std::min<int64_t>(n_threads, std::max<int64_t>(1, L / 65536));
  if (shards <= 1) {
    count_subrange(bam, tid, min_mq, start, start, end, tmp.data(), &indels);
  } else {
    std::vector<std::unordered_map<int64_t, ColIndels>> shard_indels(shards);
    std::vector<std::thread> workers;
    for (int t = 0; t < shards; t++) {
      int64_t sub_s = start + L * t / shards;
      int64_t sub_e = start + L * (t + 1) / shards;
      workers.emplace_back(count_subrange, std::cref(bam), tid, min_mq,
                           start, sub_s, sub_e, tmp.data(), &shard_indels[t]);
    }
    for (auto& w : workers) w.join();
    for (auto& m : shard_indels)
      for (auto& [idx, col] : m) indels[idx] = std::move(col);
  }

  lap("count");
  // finalize indel summary channels (+ bitmap so the candidate pass can
  // skip the hash lookup on the vast indel-free majority of columns)
  std::vector<uint8_t> has_indel(L, 0);
  for (auto& [idx, col] : indels) {
    has_indel[idx] = 1;
    int64_t fa = 0, fb = 0, ra = 0, rb = 0;
    for (auto& [len, c] : col.dels_f) { fa += c; fb = std::max<int64_t>(fb, c); }
    for (auto& [len, c] : col.dels_r) { ra += c; rb = std::max<int64_t>(rb, c); }
    counts[idx * kFeat + kFwdDelAll] = fa;
    counts[idx * kFeat + kFwdDelBest] = fb;
    counts[idx * kFeat + kFwdDelAll + kRevOff] = ra;
    counts[idx * kFeat + kFwdDelBest + kRevOff] = rb;
    fa = fb = ra = rb = 0;
    for (auto& [seq, c] : col.ins_f) { fa += c; fb = std::max<int64_t>(fb, c); }
    for (auto& [seq, c] : col.ins_r) { ra += c; rb = std::max<int64_t>(rb, c); }
    counts[idx * kFeat + kFwdInsAll] = fa;
    counts[idx * kFeat + kFwdInsBest] = fb;
    counts[idx * kFeat + kFwdInsAll + kRevOff] = ra;
    counts[idx * kFeat + kFwdInsBest + kRevOff] = rb;
  }

  if (want_gvcf) {
    if (pos_ref_ext && pos_tot_ext) {
      out->pos_ref_count = pos_ref_ext;
      out->pos_total_count = pos_tot_ext;
      out->external |= 2;  // bit 2: gVCF arrays caller-owned
    } else {
      out->pos_ref_count = new int64_t[L]();
      out->pos_total_count = new int64_t[L]();
    }
  }

  std::vector<char*> alt_infos;
  std::vector<int64_t> cand_pos;
  int64_t contiguous = 0;
  int64_t pre_pos = -2;
  const int64_t ref_len = (int64_t)strlen(ref_seq);
  static const ColIndels kEmpty;

  // single fused pass: scatter the packed temp row into the 18-channel
  // matrix (with ref-column negation applied in place), derive depth as the
  // 12-channel sum, and run candidate selection — one read of tmp, one
  // write of counts, no re-read
  for (int64_t idx = 0; idx < L; idx++) {
    const uint32_t* t = tmp.data() + idx * kTmpFeat;
    uint64_t d_sum = 0;
    for (int k = 0; k < kTmpFeat; k++) d_sum += t[k];
    if (!d_sum) continue;
    depth[idx] = (int32_t)d_sum;
    int64_t pos = start + idx;
    contiguous = (pre_pos + 1 == pos) ? contiguous + 1 : 0;
    pre_pos = pos;

    int64_t roff = pos - ref_offset;
    char ref_base = (roff >= 0 && roff < ref_len) ? (char)toupper(ref_seq[roff]) : 'N';
    int ref_idx_raw = base_index(ref_base);
    bool ref_in_acgt = ref_idx_raw >= 0;
    int ref_idx = ref_in_acgt ? ref_idx_raw : 0;

    int32_t* row = counts + idx * kFeat;
    row[0] = t[0]; row[1] = t[1]; row[2] = t[2]; row[3] = t[3];
    row[kRevOff + 0] = t[kTmpRev + 0];
    row[kRevOff + 1] = t[kTmpRev + 1];
    row[kRevOff + 2] = t[kTmpRev + 2];
    row[kRevOff + 3] = t[kTmpRev + 3];
    row[kFwdDel] = t[kTmpDelF];
    row[kFwdDel + kRevOff] = t[kTmpDelR];
    int64_t forward_sum = row[0] + row[1] + row[2] + row[3];
    int64_t reverse_sum = row[kRevOff] + row[kRevOff + 1] + row[kRevOff + 2] + row[kRevOff + 3];
    int64_t ref_count = 0, alt_count = 0, all_alt_count = 0;
    char major_alt = '\0';
    static const char kBases[] = "ACGT";
    for (int i = 0; i < 4; i++) {
      int64_t cur = row[i] + row[i + kRevOff];
      if (i == ref_idx) {
        ref_count = cur;
      } else if (cur > alt_count) {
        alt_count = cur;
        major_alt = kBases[i];
        all_alt_count += alt_count;  // reference quirk (clair3_pileup.c:365)
      }
    }

    const ColIndels& col =
        has_indel[idx] ? indels.find(idx)->second : kEmpty;
    int64_t del_count = 0, ins_count = 0;
    for (auto& [len, c] : col.dels_f) del_count += c;
    for (auto& [len, c] : col.dels_r) del_count += c;
    for (auto& [s, c] : col.ins_f) ins_count += c;
    for (auto& [s, c] : col.ins_r) ins_count += c;

    // negate the ref-base columns
    row[ref_idx] = (int32_t)-forward_sum;
    row[ref_idx + kRevOff] = (int32_t)-reverse_sum;

    int64_t col_depth = std::max<int32_t>(1, depth[idx]);
    bool pass_min_depth = col_depth >= min_depth;
    bool non_ref_majority =
        ref_count < alt_count || ref_count < ins_count || ref_count < del_count;
    bool ref_alt_equal =
        ref_count > 0 && ref_count == alt_count && major_alt != '\0' && ref_base < major_alt;
    bool pass_af;
    if (call_snp_only) {
      pass_af = (double)alt_count / col_depth >= min_snp_af;
    } else {
      pass_af = non_ref_majority || ref_alt_equal ||
                (double)alt_count / col_depth >= min_snp_af ||
                (double)del_count / col_depth >= min_indel_af ||
                (double)ins_count / col_depth >= min_indel_af;
    }
    pass_af = pass_af && pass_min_depth && ref_in_acgt;
    if (!call_ht) pass_af = pass_af && contiguous >= kFlank;

    if (pass_af) {
      std::string s;
      char head[64];
      snprintf(head, sizeof(head), "%lld-%lld-%c-",
               (long long)(pos + 1), (long long)col_depth, ref_base);
      s = head;
      int64_t ref_depth = ref_count;
      for (int i = 0; i < 4; i++) {
        if (i == ref_idx) continue;
        int64_t alt_sum = row[i] + row[i + kRevOff];
        if (alt_sum > 0) {
          char buf[32];
          snprintf(buf, sizeof(buf), "X%c %lld ", kBases[i], (long long)alt_sum);
          s += buf;
        }
      }
      // merged per-length deletion counts, ascending (std::map is sorted)
      std::map<int, int64_t> del_all;
      for (auto& [len, c] : col.dels_f) del_all[len] += c;
      for (auto& [len, c] : col.dels_r) del_all[len] += c;
      for (auto& [dlen, c] : del_all) {
        ref_depth -= c;
        if (c > 0 && dlen <= max_indel_length) {
          s += 'D';
          for (int k = 0; k < dlen; k++) {
            int64_t rp = roff + 1 + k;
            s += (rp >= 0 && rp < ref_len) ? (char)toupper(ref_seq[rp]) : 'N';
          }
          char buf[32];
          snprintf(buf, sizeof(buf), " %lld ", (long long)c);
          s += buf;
        }
      }
      std::map<std::string, int64_t> ins_all;
      for (auto& [seq, c] : col.ins_f) ins_all[seq] += c;
      for (auto& [seq, c] : col.ins_r) ins_all[seq] += c;
      for (auto& [seq, c] : ins_all) {
        ref_depth -= c;
        if ((int)seq.size() <= max_indel_length) {
          s += 'I';
          s += ref_base;
          s += seq;
          char buf[32];
          snprintf(buf, sizeof(buf), " %lld ", (long long)c);
          s += buf;
        }
      }
      if (ref_depth > 0) {
        char buf[32];
        snprintf(buf, sizeof(buf), "R%c %lld ", ref_base, (long long)ref_depth);
        s += buf;
      }
      char* cs = new char[s.size() + 1];
      memcpy(cs, s.c_str(), s.size() + 1);
      alt_infos.push_back(cs);
      cand_pos.push_back(pos);
    }

    if (want_gvcf) {
      out->pos_ref_count[idx] = ref_count;
      out->pos_total_count[idx] = ref_count + all_alt_count + del_count + ins_count;
    }
  }

  lap("candidates");
  if (external) {
    out->counts = counts;  // caller-owned, written in place
    out->depth = depth;
  } else {
    out->counts = new int32_t[(size_t)L * kFeat];
    memcpy(out->counts, counts, (size_t)L * kFeat * sizeof(int32_t));
    out->depth = new int32_t[L];
    memcpy(out->depth, depth, L * sizeof(int32_t));
  }
  out->n_candidates = (int32_t)alt_infos.size();
  out->alt_infos = new char*[alt_infos.size()];
  out->cand_pos = new int64_t[alt_infos.size()];
  for (size_t i = 0; i < alt_infos.size(); i++) {
    out->alt_infos[i] = alt_infos[i];
    out->cand_pos[i] = cand_pos[i];
  }
  return out;
}

void clair3t_pileup_free(PileupOut* out) {
  if (!out) return;
  if (!(out->external & 1)) {
    delete[] out->counts;
    delete[] out->depth;
  }
  if (!(out->external & 2)) {
    delete[] out->pos_ref_count;
    delete[] out->pos_total_count;
  }
  for (int i = 0; i < out->n_candidates; i++) delete[] out->alt_infos[i];
  delete[] out->alt_infos;
  delete[] out->cand_pos;
  delete out;
}

}  // extern "C"
