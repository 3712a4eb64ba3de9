// Affine-gap local alignment (Gotoh / Smith-Waterman) with traceback.
// Native counterpart of clair3_tpu_torch/realign/align.py's pure-Python fallback;
// replaces the reference's vendored SSW (preprocess/realign/ssw.c) for the
// Illumina realignment path.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AlignOut {
  int32_t score;
  int32_t query_start, query_end;    // [start, end) of aligned query
  int32_t target_start, target_end;  // [start, end) of aligned target
  // CIGAR ops over the aligned region only (no clips): M=0 I=1 D=2
  uint32_t* cigar;                   // (len << 4) | op
  int32_t n_cigar;
};

}  // namespace

extern "C" {

AlignOut* clair3t_align(
    const char* query, int32_t qlen, const char* target, int32_t tlen,
    int32_t match, int32_t mismatch, int32_t gap_open, int32_t gap_extend) {
  // scores: mismatch/gap_open/gap_extend passed as positive penalties
  auto* out = new AlignOut();
  memset(out, 0, sizeof(AlignOut));
  if (qlen == 0 || tlen == 0) return out;

  const int32_t NEG = -1 << 28;
  std::vector<int32_t> H((qlen + 1) * (tlen + 1), 0);
  std::vector<int32_t> E((qlen + 1) * (tlen + 1), NEG);  // gap in query (D)
  std::vector<int32_t> F((qlen + 1) * (tlen + 1), NEG);  // gap in target (I)
  auto idx = [&](int i, int j) { return i * (tlen + 1) + j; };

  int32_t best = 0, bi = 0, bj = 0;
  for (int i = 1; i <= qlen; i++) {
    for (int j = 1; j <= tlen; j++) {
      int32_t e = std::max(H[idx(i, j - 1)] - gap_open, E[idx(i, j - 1)] - gap_extend);
      int32_t f = std::max(H[idx(i - 1, j)] - gap_open, F[idx(i - 1, j)] - gap_extend);
      int32_t s = (query[i - 1] == target[j - 1]) ? match : -mismatch;
      int32_t h = std::max({0, H[idx(i - 1, j - 1)] + s, e, f});
      E[idx(i, j)] = e;
      F[idx(i, j)] = f;
      H[idx(i, j)] = h;
      if (h > best) {
        best = h;
        bi = i;
        bj = j;
      }
    }
  }
  out->score = best;
  if (best == 0) return out;

  // traceback
  std::vector<uint32_t> rev_cigar;
  auto push = [&](int op, int len) {
    if (!rev_cigar.empty() && (int)(rev_cigar.back() & 0xF) == op)
      rev_cigar.back() += (uint32_t)len << 4;
    else
      rev_cigar.push_back(((uint32_t)len << 4) | op);
  };
  int i = bi, j = bj;
  int state = 0;  // 0=H, 1=E(del), 2=F(ins)
  while (i > 0 && j > 0) {
    if (state == 0) {
      int32_t h = H[idx(i, j)];
      if (h == 0) break;
      int32_t s = (query[i - 1] == target[j - 1]) ? match : -mismatch;
      if (h == H[idx(i - 1, j - 1)] + s) {
        push(0, 1);
        i--;
        j--;
      } else if (h == E[idx(i, j)]) {
        state = 1;
      } else {
        state = 2;
      }
    } else if (state == 1) {  // deletion: consumes target
      // E[i][j] = max(H[i][j-1] - open, E[i][j-1] - ext)
      push(2, 1);
      int32_t e_old = E[idx(i, j)];
      j--;
      state = (e_old == H[idx(i, j)] - gap_open) ? 0 : 1;
    } else {  // insertion: consumes query
      // F[i][j] = max(H[i-1][j] - open, F[i-1][j] - ext)
      push(1, 1);
      int32_t f_old = F[idx(i, j)];
      i--;
      state = (f_old == H[idx(i, j)] - gap_open) ? 0 : 2;
    }
  }
  out->query_start = i;
  out->query_end = bi;
  out->target_start = j;
  out->target_end = bj;
  out->n_cigar = (int32_t)rev_cigar.size();
  out->cigar = new uint32_t[rev_cigar.size()];
  for (size_t k = 0; k < rev_cigar.size(); k++)
    out->cigar[k] = rev_cigar[rev_cigar.size() - 1 - k];
  return out;
}

void clair3t_align_free(AlignOut* out) {
  if (!out) return;
  delete[] out->cigar;
  delete out;
}

}  // extern "C"
