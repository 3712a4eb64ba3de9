// clair3_tpu_torch native read scan of the read-backed phaser: the allele
// (ref 0 / alt 1) each read of a contig region carries at the het SNPs.
//
// C++ counterpart of clair3_tpu_torch/io/bam.py BamReader.fetch followed by
// clair3_tpu_torch/phase/phaser.py read_alleles_at_snps on every read (the
// behavioral oracle; tests/test_torch_phase_native.py asserts identical
// alleles read for read).  The read set is fetch's: same contig, stop at the
// first read starting at or past `end`, drop `flag & kFilterFlag`,
// `mapq < min_mq` and reads whose reference end is at or before `start`.
// Alleles come only from M, = and X operations: the decoded base is compared
// byte for byte with the SNP's REF and ALT byte, and a base that is neither
// gives no allele.  Each aligned block finds its SNPs by binary search over
// the sorted positions, so a read costs one walk of its CIGAR, not of its
// bases.

#include "common.h"

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

using c3t::BamView;
using c3t::RecView;
using c3t::for_each_record;
using c3t::kFilterFlag;
using c3t::ref_span;
using c3t::seq_base;

namespace {

struct PhaseAllelesOut {
  int32_t* read;    // the read's ordinal among the reads kept
  int32_t* snp;     // index into the given positions
  int8_t* allele;   // 0 ref, 1 alt
  int64_t n;
  int32_t error;    // 0 ok, 1 file error, 2 a base past the read's sequence
};

}  // namespace

extern "C" {

// `snp_pos` holds `n_snps` sorted, distinct 0-based positions; `snp_ref` and
// `snp_alt` one byte each per position.  With `n_win` > 0 the region loads
// through the .bai windows in `voffs` (BamView::load_ranges), else the whole
// file loads; `tid` is the contig's index in the header either way.
PhaseAllelesOut* clair3t_phase_alleles(
    const char* bam_path, int tid, int64_t start, int64_t end,
    int min_mq,
    const int64_t* snp_pos, const char* snp_ref, const char* snp_alt,
    int64_t n_snps, const uint64_t* voffs, int n_win) {
  auto* out = new PhaseAllelesOut();
  memset(out, 0, sizeof(PhaseAllelesOut));
  BamView bam;
  bool loaded = n_win > 0 ? bam.load_ranges(bam_path, voffs, n_win)
                          : bam.load(bam_path);
  if (!loaded) {
    out->error = 1;
    return out;
  }
  const int64_t* pos_end = snp_pos + n_snps;
  std::vector<int32_t> reads, snps;
  std::vector<int8_t> alleles;
  int32_t kept = 0;
  for_each_record(bam, [&](const RecView& r) -> bool {
    if (r.tid != tid) return r.tid <= tid;  // stop once past our contig
    if (r.pos >= end) return false;         // coordinate-sorted early exit
    if (r.flag & kFilterFlag) return true;
    if (r.mapq < min_mq) return true;
    if (r.pos + ref_span(r) <= start) return true;
    const int32_t ordinal = kept++;
    const int64_t* s = std::lower_bound(snp_pos, pos_end, (int64_t)r.pos);
    int64_t ref_pos = r.pos, query_pos = 0;
    for (int ci = 0; ci < r.n_cigar && s != pos_end; ci++) {
      uint32_t op = r.cigar[ci] & 0xF;
      int64_t length = r.cigar[ci] >> 4;
      if (op == 0 || op == 7 || op == 8) {  // M = X
        const int64_t block_end = ref_pos + length;
        s = std::lower_bound(s, pos_end, ref_pos);
        for (; s != pos_end && *s < block_end; ++s) {
          int64_t qp = query_pos + (*s - ref_pos);
          if (qp >= r.l_seq) {
            out->error = 2;
            return false;
          }
          char base = seq_base(r, qp);
          int64_t k = s - snp_pos;
          if (base == snp_ref[k] || base == snp_alt[k]) {
            reads.push_back(ordinal);
            snps.push_back((int32_t)k);
            alleles.push_back(base == snp_ref[k] ? 0 : 1);
          }
        }
        ref_pos = block_end;
        query_pos += length;
      } else if (op == 2 || op == 3) {  // D N
        ref_pos += length;
      } else if (op == 1 || op == 4) {  // I S
        query_pos += length;
      }
    }
    return true;
  });
  if (out->error) return out;
  out->n = (int64_t)reads.size();
  out->read = new int32_t[reads.size()];
  out->snp = new int32_t[snps.size()];
  out->allele = new int8_t[alleles.size()];
  std::copy(reads.begin(), reads.end(), out->read);
  std::copy(snps.begin(), snps.end(), out->snp);
  std::copy(alleles.begin(), alleles.end(), out->allele);
  return out;
}

void clair3t_phase_alleles_free(PhaseAllelesOut* out) {
  if (!out) return;
  delete[] out->read;
  delete[] out->snp;
  delete[] out->allele;
  delete out;
}

}  // extern "C"
