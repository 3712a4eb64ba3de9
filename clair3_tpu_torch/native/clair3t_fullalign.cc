// clair3_tpu_torch native full-alignment extractor.
//
// C++ counterpart of clair3_tpu_torch/fullalign/extractor.py (the behavioral
// oracle; differential tests assert bit-identical tensors/alt-info).
// Semantics follow the reference C extractor
// (reference: src/clair3_full_alignment_dwell.c): per-read flanking info
// from one CIGAR walk, WhatsHap-style haplotagging (overhang-10 local
// realignment scored by Levenshtein distance, per-phase-set cost votes),
// haplotype-sorted rows with xorshift down-sampling / center padding, the
// 8(+dwell)-channel int8 matrix, AF channel, and alt-info strings.

#include "common.h"

#include <chrono>
#include <cstdlib>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

using c3t::BamView;
using c3t::RecView;
using c3t::XorShift64;
using c3t::for_each_record;
using c3t::kFilterFlag;
using c3t::ref_span;
using c3t::seq_base;

namespace {

constexpr int kFlank = 16;
constexpr int kPositions = 33;
constexpr int kOverhang = 10;
constexpr int kMinHaplotagMq = 20;
constexpr int8_t kHapVal[3] = {60, 30, 90};
constexpr int8_t kInsVal = -50;
constexpr int8_t kDelVal = -100;

int8_t base_val(char c) {
  switch (c) {
    case 'A': case 'N': return 100;
    case 'C': return 25;
    case 'G': return 75;
    case 'T': return 50;
    default: return 0;
  }
}

int acgt_idx(char c) {
  switch (c) {
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return 0;  // A and non-ACGT both map to 0 (reference acgt2num)
  }
}

int norm_mq(int mq) { return mq < 60 ? (int)(100 * mq / 60.0) : 100; }
int norm_bq(int bq) { return bq < 40 ? (int)(100 * bq / 40.0) : 100; }
int norm_af(double af) { return af < 1.0 ? (int)(100 * af) : 100; }

int levenshtein(const std::string& a, const std::string& b) {
  if (a == b) return 0;
  if (a.empty()) return (int)b.size();
  if (b.empty()) return (int)a.size();
  std::vector<int> prev(b.size() + 1), cur(b.size() + 1);
  for (size_t j = 0; j <= b.size(); j++) prev[j] = (int)j;
  for (size_t i = 1; i <= a.size(); i++) {
    cur[0] = (int)i;
    for (size_t j = 1; j <= b.size(); j++) {
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1])});
    }
    std::swap(prev, cur);
  }
  return prev[b.size()];
}

struct Variant {
  int64_t position;  // 0-based
  char ref_base, alt_base;
  int genotype;      // 1 = 0|1, 2 = 1|0
  int phase_set;
};

struct PosEntry {       // per covered flanking position of one read
  char base;            // matched base char, 0 = not covered, '-' = deleted
  int8_t bq;
  int32_t signal;
  int32_t del_len;      // deletion anchored here
  int32_t ins_idx;      // -1 or index into ReadInfo.ins_seqs
};

struct ReadInfo {
  int64_t pos, read_end;
  uint8_t mapq;
  bool rev;
  int haplotype = 0;
  // flanking-position entries in ascending key order: the CIGAR walk visits
  // reference positions monotonically, so append/back-update replaces the
  // per-position hash map (which dominated the extraction profile)
  std::vector<std::pair<int64_t, PosEntry>> entries;
  std::vector<std::pair<std::string, int32_t>> ins_seqs;  // (seq, signal sum)

  PosEntry& entry_at(int64_t p) {
    if (!entries.empty() && entries.back().first == p)
      return entries.back().second;
    entries.emplace_back(p, PosEntry{});
    return entries.back().second;
  }
};

struct CandStats {
  int64_t depth = 0;
  int64_t acgt[4] = {0, 0, 0, 0};
  std::map<std::string, int64_t> ins_counter;
  std::map<int, int64_t> del_counter;
};

// --- haplotagging (ports of fullalign/extractor.py:_cigar_prefix_length etc)

struct CigarView {
  const uint32_t* ops;
  int n;
};

void cigar_prefix_length(const CigarView& cg, int64_t reference_bases,
                         int left_idx, int right_idx, int64_t consumed,
                         bool reverse, int64_t* ref_out, int64_t* query_out) {
  int64_t ref_pos = 0, query_pos = 0;
  for (int i = left_idx; i < right_idx; i++) {
    int index = reverse ? left_idx + right_idx - i - 1 : i;
    uint32_t op = cg.ops[index] & 0xF;
    int64_t length = cg.ops[index] >> 4;
    if (i == left_idx) length = consumed;
    if (length == 0) continue;
    if (op == 0 || op == 7 || op == 8) {
      query_pos += length;
      ref_pos += length;
      if (ref_pos >= reference_bases) {
        *ref_out = reference_bases;
        *query_out = query_pos + reference_bases - ref_pos;
        return;
      }
    } else if (op == 2) {
      ref_pos += length;
      if (ref_pos >= reference_bases) {
        *ref_out = reference_bases;
        *query_out = query_pos;
        return;
      }
    } else if (op == 1) {
      query_pos += length;
    } else if (op == 3) {
      *ref_out = reference_bases;
      *query_out = query_pos;
      return;
    }
  }
  *ref_out = ref_pos;
  *query_out = query_pos;
}

std::string query_sub(const RecView& r, int64_t start, int64_t end) {
  std::string s;
  if (end <= start) return s;
  s.reserve(end - start);
  for (int64_t q = start; q < end; q++) s.push_back(seq_base(r, q));
  return s;
}

int realign_allele(const Variant& v, const RecView& r, int cigar_index,
                   int64_t consumed, int64_t query_pos,
                   const char* ref_seq, int64_t ref_len, int64_t ref_start) {
  CigarView cg{r.cigar, r.n_cigar};
  int64_t middle_length = r.cigar[cigar_index] >> 4;
  int64_t left_consumed = consumed > 0 ? consumed : 0;
  int64_t right_consumed = consumed < middle_length ? middle_length - consumed : 0;
  int64_t left_ref = 0, left_query = 0, right_ref = 0, right_query = 0;
  cigar_prefix_length(cg, kOverhang, 0, cigar_index + 1, left_consumed, true,
                      &left_ref, &left_query);
  cigar_prefix_length(cg, kOverhang + 1, cigar_index, r.n_cigar, right_consumed,
                      false, &right_ref, &right_query);
  int64_t qst = query_pos - left_query;
  int64_t qen = query_pos + right_query;
  if (qen == qst) return 0;
  int64_t rst = v.position - left_ref - ref_start;
  int64_t ren = v.position + right_ref - ref_start;
  if (rst < 0) rst = 0;
  if (ren > ref_len) ren = ref_len;
  if (rst > ren) rst = ren;  // variant outside the fetched window
  if (qst < 0) qst = 0;
  if (qen > r.l_seq) qen = r.l_seq;
  if (qst > qen) qst = qen;
  std::string query = query_sub(r, qst, qen);
  std::string ref(ref_seq + rst, ref_seq + ren);
  std::string alt = ref;
  if (left_ref < (int64_t)alt.size()) alt[left_ref] = v.alt_base;
  int d_ref = levenshtein(query, ref);
  int d_alt = levenshtein(query, alt);
  if (d_ref < d_alt) return 1;
  if (d_ref > d_alt) return 2;
  return 0;
}

int haplotag_read(const RecView& r, const std::vector<Variant>& variants,
                  const char* ref_seq, int64_t ref_len, int64_t ref_start) {
  std::map<int, int> cost;
  size_t j = 0, n = variants.size();
  int64_t ref_pos = r.pos, query_pos = 0;
  while (j < n && variants[j].position < ref_pos) j++;

  auto vote = [&](int allele, const Variant& v) {
    if (allele == 0) return;
    cost[v.phase_set] += (allele == v.genotype) ? 1 : -1;
  };

  for (int i = 0; i < r.n_cigar; i++) {
    uint32_t op = r.cigar[i] & 0xF;
    int64_t length = r.cigar[i] >> 4;
    if (op == 0 || op == 7 || op == 8) {
      while (j < n && variants[j].position < ref_pos + length) {
        const Variant& v = variants[j];
        vote(realign_allele(v, r, i, v.position - ref_pos,
                            query_pos + v.position - ref_pos,
                            ref_seq, ref_len, ref_start), v);
        j++;
      }
      query_pos += length;
      ref_pos += length;
    } else if (op == 1) {
      if (j < n && variants[j].position == ref_pos) {
        const Variant& v = variants[j];
        vote(realign_allele(v, r, i, 0, query_pos, ref_seq, ref_len, ref_start), v);
        j++;
      }
      query_pos += length;
    } else if (op == 2) {
      while (j < n && variants[j].position < ref_pos + length) {
        const Variant& v = variants[j];
        vote(realign_allele(v, r, i, v.position - ref_pos, query_pos,
                            ref_seq, ref_len, ref_start), v);
        j++;
      }
      ref_pos += length;
    } else if (op == 3) {
      while (j < n && variants[j].position < ref_pos + length) j++;
      ref_pos += length;
    } else if (op == 4) {
      query_pos += length;
    }
  }

  if (cost.empty()) return 0;
  int max_v = 0, min_v = 0;
  for (auto& [ps, c] : cost) {
    max_v = std::max(max_v, c);
    min_v = std::min(min_v, c);
  }
  if (max_v == 0 && min_v == 0) return 0;
  return (max_v > -min_v) ? 1 : 2;
}

// mv:B:c dwell tag -> per-base signal block counts
bool mv_signals(const RecView& r, std::vector<int32_t>* out) {
  const uint8_t* t = r.tags;
  size_t n = r.tags_len;
  size_t off = 0;
  while (off + 3 <= n) {
    char tag0 = t[off], tag1 = t[off + 1], typ = t[off + 2];
    off += 3;
    size_t skip = 0;
    bool is_mv = tag0 == 'm' && tag1 == 'v' && typ == 'B';
    switch (typ) {
      case 'A': case 'c': case 'C': skip = 1; break;
      case 's': case 'S': skip = 2; break;
      case 'i': case 'I': case 'f': skip = 4; break;
      case 'Z': case 'H': {
        while (off + skip < n && t[off + skip]) skip++;
        skip++;
        break;
      }
      case 'B': {
        char sub = t[off];
        uint32_t count;
        memcpy(&count, t + off + 1, 4);
        size_t isz = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
        if (is_mv && count > 1 && (sub == 'c' || sub == 'C') && r.l_seq > 0) {
          out->assign(r.l_seq, 0);
          int64_t base_index = -1;
          for (uint32_t k = 1; k < count; k++) {
            int8_t mv = (int8_t)t[off + 5 + k];
            if (mv != 0) {
              base_index++;
              if (base_index >= r.l_seq) break;
              (*out)[base_index] += 1;
            } else {
              if (base_index < 0) continue;
              if (base_index >= r.l_seq) break;
              (*out)[base_index] += 1;
            }
          }
          if (r.flag & 0x10) std::reverse(out->begin(), out->end());
          return true;
        }
        skip = 5 + (size_t)count * isz;
        break;
      }
      default:
        return false;  // unknown tag type; bail
    }
    off += skip;
  }
  return false;
}

struct FaOut {
  int8_t* matrix;
  char** alt_infos;
  int64_t* cand_pos;
  int32_t n_cand, depth, positions, channels, error;
  int32_t external;  // nonzero: matrix is caller-owned (written in place)
};

}  // namespace

extern "C" {

FaOut* clair3t_fullalign(
    const char* bam_path, const char* ctg,
    const char* ref_seq, int64_t ref_offset,
    const int64_t* candidates, int32_t n_cand,
    const int64_t* var_pos, const char* var_ref, const char* var_alt,
    const int32_t* var_gt, const int32_t* var_ps, int32_t n_var,
    int need_haplotagging, int min_mq, int matrix_depth,
    int max_indel_length, int enable_dwell, uint64_t seed,
    const uint64_t* voffs, int n_win, int tid_hint,
    int8_t* matrix_ext) {
  // CLAIR3T_PROFILE=1: per-phase wall times on stderr (observability)
  const bool profile = getenv("CLAIR3T_PROFILE") != nullptr;
  auto t_start = std::chrono::steady_clock::now();
  auto lap = [&](const char* phase) {
    if (!profile) return;
    auto now = std::chrono::steady_clock::now();
    fprintf(stderr, "[clair3t_fullalign] %s %.1f ms\n", phase,
            std::chrono::duration<double, std::milli>(now - t_start).count());
    t_start = now;
  };
  auto* out = new FaOut();
  memset(out, 0, sizeof(FaOut));
  out->external = matrix_ext != nullptr;
  const int channels = enable_dwell ? 9 : 8;
  out->n_cand = n_cand;
  out->depth = matrix_depth;
  out->positions = kPositions;
  out->channels = channels;

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
  lap("load");
  const int64_t ref_len = (int64_t)strlen(ref_seq);

  std::vector<Variant> variants(n_var);
  for (int i = 0; i < n_var; i++)
    variants[i] = {var_pos[i], var_ref[i], var_alt[i], var_gt[i], var_ps[i]};
  std::sort(variants.begin(), variants.end(),
            [](const Variant& a, const Variant& b) { return a.position < b.position; });

  std::vector<int64_t> cands(candidates, candidates + n_cand);
  std::sort(cands.begin(), cands.end());
  // flanking-position membership and candidate lookup as flat bitmaps over
  // the covered span: the per-base hash probes in the CIGAR walk dominated
  // the extraction profile
  const int64_t flank_lo =
      n_cand ? std::max<int64_t>(0, cands.front() - kFlank) : 0;
  const int64_t flank_hi = n_cand ? cands.back() + kFlank + 1 : 0;
  std::vector<uint8_t> in_flank(flank_hi - flank_lo, 0);
  std::vector<int32_t> cand_at(flank_hi - flank_lo, -1);
  for (int i = 0; i < n_cand; i++) {
    for (int64_t p = std::max<int64_t>(0, cands[i] - kFlank);
         p <= cands[i] + kFlank; p++)
      in_flank[p - flank_lo] = 1;
    cand_at[cands[i] - flank_lo] = i;
  }
  auto is_flank = [&](int64_t p) -> bool {
    return p >= flank_lo && p < flank_hi && in_flank[p - flank_lo];
  };
  auto cand_of = [&](int64_t p) -> int {
    return (p >= flank_lo && p < flank_hi) ? cand_at[p - flank_lo] : -1;
  };

  std::vector<CandStats> stats(n_cand);
  std::vector<std::vector<int>> cand_overlaps(n_cand);
  std::vector<ReadInfo> infos;
  std::unordered_set<std::string> seen_names;
  const int64_t region_start = n_cand ? cands.front() - kFlank : 0;
  const int64_t region_end = n_cand ? cands.back() + kFlank + 1 : 0;

  for_each_record(bam, [&](const RecView& r) -> bool {
    if (r.tid != tid) return r.tid <= tid;
    if (r.pos >= region_end) return false;
    if (r.flag & kFilterFlag) return true;
    if (r.mapq < min_mq) return true;
    if (r.l_seq == 0) return true;  // SEQ '*' records carry no bases
    int64_t rend = r.pos + ref_span(r);
    if (rend <= region_start) return true;
    std::string qname(r.qname);
    if (!seen_names.insert(qname).second) return true;

    // overlap any candidate window [c-kFlank, c+kFlank]?
    auto it = std::lower_bound(cands.begin(), cands.end(), r.pos - kFlank);
    if (it == cands.end() || *it - kFlank >= rend) return true;
    {  // record this read against every candidate window it overlaps
      int j = (int)infos.size();
      for (auto c = it; c != cands.end() && *c - kFlank < rend; ++c)
        cand_overlaps[c - cands.begin()].push_back(j);
    }

    ReadInfo info;
    info.pos = r.pos;
    info.read_end = rend;
    info.mapq = r.mapq;
    info.rev = r.flag & 0x10;

    if (need_haplotagging && !variants.empty() && r.mapq >= kMinHaplotagMq)
      info.haplotype = haplotag_read(r, variants, ref_seq, ref_len, ref_offset);

    std::vector<int32_t> signals;
    bool have_signals = enable_dwell && mv_signals(r, &signals);

    int64_t ref_pos = r.pos, query_pos = 0;
    for (int ci = 0; ci < r.n_cigar; ci++) {
      uint32_t op = r.cigar[ci] & 0xF;
      int64_t length = r.cigar[ci] >> 4;
      if (op == 0 || op == 7 || op == 8) {
        for (int64_t k = 0; k < length; k++) {
          int64_t p = ref_pos + k;
          if (!is_flank(p)) continue;
          int64_t qp = query_pos + k;
          PosEntry& e = info.entry_at(p);
          e.base = seq_base(r, qp);
          e.bq = (int8_t)norm_bq(r.qual[qp]);
          e.signal = (have_signals && qp < (int64_t)signals.size()) ? signals[qp] : 0;
          int ci2 = cand_of(p);
          if (ci2 >= 0) {
            stats[ci2].acgt[acgt_idx(e.base)]++;
            stats[ci2].depth++;
          }
        }
        ref_pos += length;
        query_pos += length;
      } else if (op == 2) {
        int64_t anchor = ref_pos - 1;
        if (anchor >= r.pos && is_flank(anchor)) {
          info.entry_at(anchor).del_len = (int32_t)length;
          int ci2 = cand_of(anchor);
          if (ci2 >= 0) stats[ci2].del_counter[(int)length]++;
        }
        for (int64_t p = ref_pos; p < ref_pos + length; p++) {
          if (!is_flank(p)) continue;
          info.entry_at(p).base = '-';  // deleted marker
          int ci2 = cand_of(p);
          if (ci2 >= 0) stats[ci2].depth++;
        }
        ref_pos += length;
      } else if (op == 1) {
        int64_t anchor = ref_pos - 1;
        if (anchor >= r.pos && is_flank(anchor)) {
          std::string seq = query_sub(r, query_pos, query_pos + length);
          int32_t sig = 0;
          if (have_signals) {
            int64_t hi = std::min<int64_t>(query_pos + length, signals.size());
            for (int64_t q = query_pos; q < hi; q++) sig += signals[q];
          }
          info.ins_seqs.emplace_back(seq, sig);
          info.entry_at(anchor).ins_idx = (int32_t)info.ins_seqs.size();  // 1-based
          int ci2 = cand_of(anchor);
          if (ci2 >= 0) stats[ci2].ins_counter[seq]++;
        }
        query_pos += length;
      } else if (op == 3) {
        ref_pos += length;
      } else if (op == 4) {
        query_pos += length;
      }
    }
    infos.push_back(std::move(info));
    return true;
  });
  lap("collect");

  // reads arrive coordinate-sorted; stable order matches the Python oracle
  size_t total = (size_t)n_cand * matrix_depth * kPositions * channels;
  // caller-supplied buffer (zeroed numpy array) avoids alloc + copy-out
  int8_t* matrix = matrix_ext ? matrix_ext : new int8_t[total]();
  char** alt_infos = new char*[n_cand];
  int64_t* cand_pos_out = new int64_t[n_cand];

  // per-candidate fill is independent (disjoint matrix slices, per-candidate
  // RNG seed, read-only infos/stats) -> shard candidates across threads
  auto fill_candidate = [&](int i) {
    std::vector<int> overlaps;
    int64_t cand = cands[i];
    cand_pos_out[i] = cand;
    int64_t start_pos = cand - kFlank;
    int64_t end_pos = cand + kFlank + 1;
    overlaps = cand_overlaps[i];
    if ((int)overlaps.size() > matrix_depth) {
      uint64_t cseed = seed ^ (uint64_t)((uint64_t)cand * 0x100000001B3ull);
      XorShift64 rng(cseed);
      for (int k = (int)overlaps.size() - 1; k > 0; k--) {
        int j = (int)rng.below(k + 1);
        std::swap(overlaps[k], overlaps[j]);
      }
      overlaps.resize(matrix_depth);
    }
    std::sort(overlaps.begin(), overlaps.end(), [&](int a, int b) {
      if (infos[a].haplotype != infos[b].haplotype)
        return infos[a].haplotype < infos[b].haplotype;
      return a < b;
    });
    std::vector<int> rows(matrix_depth, -1);
    if ((int)overlaps.size() < matrix_depth) {
      int pad = matrix_depth - (int)overlaps.size();
      int prefix = pad >> 1;
      for (size_t k = 0; k < overlaps.size(); k++) rows[prefix + k] = overlaps[k];
    } else {
      for (int k = 0; k < matrix_depth; k++) rows[k] = overlaps[k];
    }

    struct RowAlt { char alt_base = 0; int ins_idx = -1; int read = -1; int del_len = 0; };
    std::vector<RowAlt> row_alts(matrix_depth);
    int64_t depth_stats = stats[i].depth;
    int8_t* cmat = matrix + (size_t)i * matrix_depth * kPositions * channels;

    for (int d = 0; d < matrix_depth; d++) {
      int j = rows[d];
      if (j < 0) continue;
      const ReadInfo& info = infos[j];
      int8_t hap_v = kHapVal[info.haplotype];
      int8_t strand_v = info.rev ? 100 : 50;
      int8_t mq_v = (int8_t)norm_mq(info.mapq);
      int8_t* rmat = cmat + (size_t)d * kPositions * channels;

      auto eit = std::lower_bound(
          info.entries.begin(), info.entries.end(), start_pos,
          [](const std::pair<int64_t, PosEntry>& a, int64_t v) {
            return a.first < v;
          });
      for (; eit != info.entries.end() && eit->first < end_pos; ++eit) {
        int p = (int)(eit->first - start_pos);
        int64_t cp = eit->first;
        const PosEntry& e = eit->second;
        if (e.base == '-') continue;  // deleted columns stay all-zero
        if (e.base == 0) continue;
        int64_t roff = cp - ref_offset;
        char ref_base = (roff >= 0 && roff < ref_len) ? (char)toupper(ref_seq[roff]) : 'N';
        int8_t ref_v = base_val(ref_base);
        int8_t alt_v = 0;
        bool is_center = p == kFlank;
        int32_t sig = e.signal;
        if (e.ins_idx > 0) {
          const auto& [ins_seq, ins_sig] = info.ins_seqs[e.ins_idx - 1];
          if (p < kPositions - 1) {
            int max_ins = std::min<int>((int)ins_seq.size(), kPositions - p);
            for (int k = 0; k < max_ins; k++)
              rmat[(size_t)(p + k) * channels + 6] = base_val(ins_seq[k]);
          }
          if (is_center) {
            row_alts[d] = {e.base, e.ins_idx - 1, j, 0};
          }
          alt_v = kInsVal;
          if (enable_dwell) sig += ins_sig;
        } else if (e.del_len > 0) {
          if (is_center) row_alts[d] = {0, -1, j, e.del_len};
          alt_v = kDelVal;
        } else if (ref_base != e.base) {
          if (is_center) row_alts[d] = {e.base, -1, j, 0};
          alt_v = base_val(e.base);
        }
        int8_t* cell = rmat + (size_t)p * channels;
        cell[0] = ref_v;
        cell[1] = alt_v;
        cell[2] = strand_v;
        cell[3] = mq_v;
        cell[4] = e.bq;
        cell[7] = hap_v;
        if (enable_dwell) cell[8] = (int8_t)sig;
      }
    }

    // AF channel
    for (int d = 0; d < matrix_depth; d++) {
      const RowAlt& ra = row_alts[d];
      if (ra.alt_base == 0 && ra.ins_idx < 0 && ra.del_len == 0) continue;
      int af_v = 0;
      if (ra.ins_idx >= 0 && ra.read >= 0) {
        const std::string& seq = infos[ra.read].ins_seqs[ra.ins_idx].first;
        auto cit = stats[i].ins_counter.find(seq);
        if (cit != stats[i].ins_counter.end() && cit->second > 0 && depth_stats > 0)
          af_v = norm_af((double)cit->second / depth_stats);
      } else if (ra.del_len > 0) {
        auto cit = stats[i].del_counter.find(ra.del_len);
        if (cit != stats[i].del_counter.end() && cit->second > 0 && depth_stats > 0)
          af_v = norm_af((double)cit->second / depth_stats);
      } else if (ra.alt_base != 0) {
        if (depth_stats > 0)
          af_v = norm_af((double)stats[i].acgt[acgt_idx(ra.alt_base)] / depth_stats);
      }
      if (af_v > 0) {
        int8_t* rmat = cmat + (size_t)d * kPositions * channels;
        for (int p = 0; p < kPositions; p++) {
          if (rmat[(size_t)p * channels] != 0)
            rmat[(size_t)p * channels + 5] = (int8_t)af_v;
        }
      }
    }

    // alt-info string: X (ACGT order, skip ref) + I + D + R
    int64_t roff = cand - ref_offset;
    char center_ref = (roff >= 0 && roff < ref_len) ? (char)toupper(ref_seq[roff]) : 'N';
    int ref_idx = acgt_idx(center_ref);
    int64_t ref_count = stats[i].acgt[ref_idx];
    std::string s;
    char buf[64];
    snprintf(buf, sizeof(buf), "%lld-", (long long)depth_stats);
    s = buf;
    static const char kBases[] = "ACGT";
    for (int b = 0; b < 4; b++) {
      if (b != ref_idx && stats[i].acgt[b] > 0) {
        snprintf(buf, sizeof(buf), "X%c %lld ", kBases[b], (long long)stats[i].acgt[b]);
        s += buf;
      }
    }
    for (auto& [seq, val] : stats[i].ins_counter) {
      ref_count -= val;
      if ((int)seq.size() <= max_indel_length) {
        s += 'I';
        s += center_ref;
        s += seq;
        snprintf(buf, sizeof(buf), " %lld ", (long long)val);
        s += buf;
      }
    }
    for (auto& [dlen, val] : stats[i].del_counter) {
      ref_count -= val;
      if (dlen <= max_indel_length) {
        s += 'D';
        for (int k = 0; k < dlen; k++) {
          int64_t rp = roff + 1 + k;
          s += (rp >= 0 && rp < ref_len) ? (char)toupper(ref_seq[rp]) : 'N';
        }
        snprintf(buf, sizeof(buf), " %lld ", (long long)val);
        s += buf;
      }
    }
    if (ref_count > 0) {
      snprintf(buf, sizeof(buf), "R%c %lld ", center_ref, (long long)ref_count);
      s += buf;
    }
    char* cs = new char[s.size() + 1];
    memcpy(cs, s.c_str(), s.size() + 1);
    alt_infos[i] = cs;
  };

  {
    unsigned hw = std::thread::hardware_concurrency();
    int n_threads = hw ? (int)hw : 1;
    if (const char* env = getenv("CLAIR3T_FA_THREADS")) {
      int v = atoi(env);
      if (v > 0) n_threads = v;
    }
    int shards = (int)std::min<long long>(n_threads,
                                          std::max<long long>(1, n_cand / 64));
    if (shards <= 1) {
      for (int i = 0; i < n_cand; i++) fill_candidate(i);
    } else {
      std::vector<std::thread> workers;
      for (int t = 0; t < shards; t++)
        workers.emplace_back([&, t]() {
          for (int i = (int)((long long)n_cand * t / shards);
               i < (int)((long long)n_cand * (t + 1) / shards); i++)
            fill_candidate(i);
        });
      for (auto& w : workers) w.join();
    }
  }

  lap("fill");
  out->matrix = matrix;
  out->alt_infos = alt_infos;
  out->cand_pos = cand_pos_out;
  return out;
}

void clair3t_fullalign_free(FaOut* out) {
  if (!out) return;
  if (!out->external) delete[] out->matrix;
  for (int i = 0; i < out->n_cand; i++)
    if (out->alt_infos) delete[] out->alt_infos[i];
  delete[] out->alt_infos;
  delete[] out->cand_pos;
  delete out;
}

}  // extern "C"
