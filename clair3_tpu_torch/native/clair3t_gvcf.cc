// Native gVCF non-variant block builder.
//
// Byte-identical C++ port of clair3_tpu_torch/gvcf.py (NonVariantBlockWriter +
// reference_likelihood), itself row-identical to the reference's
// variantInfoCalculator (preprocess/utils.py:348-626) including its
// production quirks: truncated LOG_10 = 2.3025, the CFFI log10sumexp whose
// out-of-bounds max scan effectively pins the scaling max to 0.0, and the
// min-raw-GQ field on merged blocks.
//
// Streaming API: a heap-owned state object lives across ctypes calls so
// blocks can span chunk boundaries exactly like the Python writer.
// Differential tests: tests/test_native_gvcf.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

const double LOG_10 = 2.3025;  // truncated, matching the reference
const double LOG_2 = 0.3010;  // truncated literal (preprocess/utils.py:19)

// Python round(x, 6): correctly-rounded decimal conversion and back.
double py_round6(double x) {
  if (!std::isfinite(x)) return x;
  char buf[64];
  snprintf(buf, sizeof buf, "%.6f", x);
  return strtod(buf, nullptr);
}

struct LikResult {
  bool valid_pl;
  int gq;
  int binned_gq;
  int pls[3];
};

// reference_likelihood (gvcf.py:46-91) with the m=0 log10sumexp semantics
LikResult reference_likelihood_uncached(long long n_ref, long long n_total,
                                        double p_err, int gq_bin_size,
                                        int max_gq) {
  double lp[3];
  if (n_total == 0) {
    lp[0] = lp[1] = lp[2] = -1.0;
  } else {
    double logp = std::log(p_err) / LOG_10;
    double log1p_ = std::log1p(-p_err) / LOG_10;
    long long n_alt = n_total - n_ref;
    lp[0] = (double)n_ref * log1p_ + (double)n_alt * logp;
    lp[1] = -(double)n_total * LOG_2;
    lp[2] = (double)n_ref * logp + (double)n_alt * log1p_;
  }
  // _log10sumexp with effective m = 0 (gvcf.py:29-41)
  double s = pow(10.0, lp[0]) + pow(10.0, lp[1]) + pow(10.0, lp[2]);
  double lse;
  if (s == 0.0)
    lse = -INFINITY;
  else
    lse = std::log(s) / LOG_10;
  lse = py_round6(lse);
  double norm[3];
  for (int i = 0; i < 3; i++) norm[i] = std::min(lp[i] - lse, 0.0);

  // _log10p_to_phred (gvcf.py:39-43)
  double ptrue = pow(10.0, norm[0]);
  double phred0 = (ptrue == 1.0)
                      ? 50.0
                      : py_round6(-10.0 * (std::log(1.0 - ptrue) / LOG_10));
  LikResult r;
  long long g = (long long)phred0;  // int() truncation
  if (g > max_gq) g = max_gq;
  r.gq = (int)g;
  r.binned_gq = r.gq >= 1 ? ((r.gq - 1) / gq_bin_size) * gq_bin_size + 1 : 0;
  r.valid_pl = norm[0] == std::max(norm[0], std::max(norm[1], norm[2]));
  double ph[3] = {-10 * norm[0], -10 * norm[1], -10 * norm[2]};
  double mn = std::min(ph[0], std::min(ph[1], ph[2]));
  for (int i = 0; i < 3; i++) {
    double d = ph[i] - mn;
    // Python int() of a possibly-inf double: inf - inf = nan cannot occur
    // (mn finite when any ph finite); inf stays inf -> clamp like CPython
    // would raise; unreachable for valid inputs, guard anyway
    if (!std::isfinite(d)) d = 0;
    r.pls[i] = (int)(long long)d;
  }
  return r;
}

struct Site {
  long long pos;
  char ref;
  bool valid_pl;  // gt 0/0 vs ./.
  int gq, binned_gq;
  int pls[3];
  long long dp;
};

struct GvcfState {
  double p_err;
  int gq_bin_size;
  bool bp_resolution;
  std::unordered_map<long long, LikResult> memo;  // (n_ref<<24)|n_tot? see key()
  std::unordered_map<std::string, long long> contig_lengths;

  std::string chrom;          // current block's contig
  bool open = false;
  Site head;
  bool retain = false;
  std::vector<Site> block;    // retained sites (./., bp_resolution)
  long long min_dp = 0, max_dp = 0;
  int min_raw_gq = 0;
  long long last_pos = 0;
  char last_ref = 0;

  std::vector<std::string> rows;

  LikResult lik(long long n_ref, long long n_total) {
    long long key = (n_ref << 32) | (n_total & 0xFFFFFFFFLL);
    auto it = memo.find(key);
    if (it != memo.end()) return it->second;
    LikResult r = reference_likelihood_uncached(n_ref, n_total, p_err,
                                                gq_bin_size, 50);
    if (memo.size() < 2000000) memo.emplace(key, r);
    return r;
  }

  void row_out(const std::string& chrom_, long long pos, char ref,
               const char* gt, int gq_field, long long min_dp_, long long end,
               const int* pls) {
    long long end_out = end;
    auto it = contig_lengths.find(chrom_);
    if (it != contig_lengths.end() && end == it->second - 1) end_out = it->second;
    char buf[256];
    snprintf(buf, sizeof buf,
             "%s\t%lld\t.\t%c\t<NON_REF>\t0\t.\tEND=%lld\tGT:GQ:MIN_DP:PL\t"
             "%s:%d:%lld:%d,%d,%d",
             chrom_.c_str(), pos, ref, end_out, gt, gq_field, min_dp_, pls[0],
             pls[1], pls[2]);
    rows.emplace_back(buf);
  }

  void flush() {
    if (!open) return;
    if ((bp_resolution || !head.valid_pl) && head.ref != 'N') {
      for (const Site& s : block)
        row_out(chrom, s.pos, s.ref, s.valid_pl ? "0/0" : "./.", s.binned_gq,
                s.dp, s.pos, s.pls);
    } else {
      long long end = last_pos;
      if (head.ref == 'N') {
        int zero[3] = {0, 0, 0};
        row_out(chrom, head.pos, 'N', "./.", 1, min_dp, end, zero);
      } else {
        // quirk preserved: GQ field carries the block's min raw GQ
        row_out(chrom, head.pos, head.ref, head.valid_pl ? "0/0" : "./.",
                min_raw_gq, min_dp, end, head.pls);
      }
    }
    open = false;
    block.clear();
  }

  void start_block(const std::string& chrom_, const Site& s) {
    chrom = chrom_;
    head = s;
    open = true;
    min_dp = max_dp = s.dp;
    min_raw_gq = s.gq;
    last_pos = s.pos;
    last_ref = s.ref;
    retain = bp_resolution || !s.valid_pl;
    block.clear();
    if (retain) block.push_back(s);
  }

  void add_site(const std::string& chrom_, long long pos, char ref_in,
                long long n_ref, long long n_total) {
    LikResult lr = lik(n_ref, n_total);
    char ref = ref_in;
    int gq = lr.gq, binned = lr.binned_gq;
    int pls[3] = {lr.pls[0], lr.pls[1], lr.pls[2]};
    bool valid = lr.valid_pl;
    if (ref != 'A' && ref != 'C' && ref != 'G' && ref != 'T') {
      ref = 'N';
      gq = 1;
      binned = 1;
      pls[0] = pls[1] = pls[2] = 0;
    }

    if (open) {
      // position continuity: a gap (a dist process feeds only its OWNED
      // strided chunks) must close the block, exactly like the Python twin
      bool breaks = pos != last_pos + 1 ||
                    binned != head.binned_gq || valid != head.valid_pl ||
                    chrom_ != chrom ||
                    (ref != last_ref && (ref == 'N' || last_ref == 'N'));
      if (!breaks) {
        long long dp = n_total;
        bool still_open = true;
        if (dp < min_dp) {
          if (max_dp > (long long)std::ceil((double)dp + (double)dp * 0.3)) {
            flush();
            still_open = false;
          } else {
            min_dp = dp;
          }
        } else if (dp > max_dp) {
          if (dp <= (long long)std::ceil((double)min_dp + (double)min_dp * 0.3)) {
            max_dp = dp;
          } else {
            flush();
            still_open = false;
          }
        }
        if (still_open) {
          min_raw_gq = std::min(min_raw_gq, gq);
          last_pos = pos;
          last_ref = ref;
          if (retain) {
            Site s{pos, ref, valid, gq, binned, {pls[0], pls[1], pls[2]}, n_total};
            block.push_back(s);
          }
          return;
        }
      } else {
        flush();
      }
    }
    Site s{pos, ref, valid, gq, binned, {pls[0], pls[1], pls[2]}, n_total};
    start_block(chrom_, s);
  }
};

}  // namespace

extern "C" {

GvcfState* clair3t_gvcf_new(double p_err, int gq_bin_size, int bp_resolution) {
  auto* st = new GvcfState();
  st->p_err = p_err;
  st->gq_bin_size = gq_bin_size;
  st->bp_resolution = bp_resolution;
  return st;
}

void clair3t_gvcf_set_contig_length(GvcfState* st, const char* name,
                                    int64_t length) {
  st->contig_lengths[name] = length;
}

// Feed one contiguous span of per-position counts.  ref_seq[i] is the
// (already upper-cased or raw) reference base at start_pos1 + i.
void clair3t_gvcf_feed(GvcfState* st, const char* chrom, int64_t start_pos1,
                       const char* ref_seq, const int64_t* n_ref,
                       const int64_t* n_total, int64_t n) {
  std::string c(chrom);
  for (int64_t i = 0; i < n; i++) {
    char b = ref_seq[i];
    if (b >= 'a' && b <= 'z') b = (char)(b - 'a' + 'A');
    st->add_site(c, start_pos1 + i, b, n_ref[i], n_total[i]);
  }
}

struct GvcfRows {
  char* data;   // '\n'-joined rows (incl. trailing '\n'); one blob so the
                // Python side does a single decode+split, not n_rows
  int64_t len;
  int32_t n;
};

// Drain completed rows (call any time; finish() flushes the open block).
GvcfRows* clair3t_gvcf_take_rows(GvcfState* st, int finish) {
  if (finish) st->flush();
  auto* out = new GvcfRows();
  size_t total = 0;
  for (auto& r : st->rows) total += r.size() + 1;
  out->data = new char[total ? total : 1];
  char* p = out->data;
  for (auto& r : st->rows) {
    memcpy(p, r.data(), r.size());
    p += r.size();
    *p++ = '\n';
  }
  out->len = (int64_t)total;
  out->n = (int32_t)st->rows.size();
  st->rows.clear();
  return out;
}

void clair3t_gvcf_rows_free(GvcfRows* r) {
  if (!r) return;
  delete[] r->data;
  delete r;
}

void clair3t_gvcf_free(GvcfState* st) { delete st; }

}  // extern "C"
