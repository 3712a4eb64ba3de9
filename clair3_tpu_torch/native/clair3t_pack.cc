// Native compact-wire-form packers for the InferenceEngine submit path.
//
// These are single-pass C twins of the numpy packers in
// clair3_tpu_torch/ops/fa_compact.py (pack_fa_sparse) and
// clair3_tpu_torch/ops/pileup_compact.py (pack_pileup): same structure
// validation, same outputs (the Python packers are the differential
// oracles — tests/test_native_pack.py asserts byte identity).  The numpy
// versions make ~8 full passes over the batch in temporaries; one cache-
// friendly C pass per candidate is ~10x cheaper, and the pack runs on the
// engine's submitter thread for every production FA/pileup batch
// (pipeline/engine.py:_put_and_forward), so it is hot host-side code.
//
// Return codes: 0 = ok, 1 = structure violation (caller falls back to the
// dense wire form), 2 = sparse-entry overflow past kmax.

#include <cstdint>
#include <cstring>

namespace {

// Validates + packs one FA candidate [D, 33, C] int8.  Layout facts it
// relies on (reference: src/clair3_full_alignment_dwell.c:899-948 channel
// order ref/alt/strand/MQ/BQ/AF/insert/HP[/dwell]):
//   * strand(ch2) != 0 marks a filled cell; strand/MQ(ch3)/HP(ch7) are
//     constant over the filled cells of a read row, 0 elsewhere;
//   * AF(ch5) is constant over the cells where ref(ch0) != 0;
//   * ref(ch0) is constant down each filled column.
inline int pack_fa_one(const int8_t* m, int64_t D, int64_t C,
                       int8_t* bq, uint8_t* bitmask, int8_t* scalars,
                       int8_t* refcol, uint16_t* sidx, int8_t* sval,
                       int8_t* dwell, int64_t kmax, uint16_t pad_idx,
                       int64_t* count_out) {
  const int64_t P = 33;
  const int64_t sD = P * C;
  // pass A: per-row scalar maxima, per-column ref maxima, coverage bits,
  // dense BQ/dwell copies, sparse alt/insert collection.  Maxima run over
  // ALL cells (not just covered ones) to match the numpy oracle's
  // .max(axis=...) exactly — pass B then decides validity.
  int64_t k = 0;
  for (int64_t p = 0; p < P; p++) refcol[p] = INT8_MIN;
  for (int64_t d = 0; d < D; d++) {
    const int8_t* row = m + d * sD;
    int8_t strand = INT8_MIN, mq = INT8_MIN, hap = INT8_MIN, af = INT8_MIN;
    uint8_t* bits = bitmask + d * 5;
    memset(bits, 0, 5);
    int8_t* bq_row = bq + d * P;
    int8_t* dw_row = dwell ? dwell + d * P : nullptr;
    for (int64_t p = 0; p < P; p++) {
      const int8_t* cell = row + p * C;
      if (cell[2]) bits[p >> 3] |= (uint8_t)(1u << (7 - (p & 7)));
      if (cell[2] > strand) strand = cell[2];
      if (cell[3] > mq) mq = cell[3];
      if (cell[7] > hap) hap = cell[7];
      if (cell[5] > af) af = cell[5];
      if (cell[0] > refcol[p]) refcol[p] = cell[0];
      bq_row[p] = cell[4];
      if (dw_row) dw_row[p] = cell[8];
      if (cell[1]) {
        if (k == kmax) return 2;
        sidx[k] = (uint16_t)(((d * P + p) << 1) + 0);
        sval[k++] = cell[1];
      }
      if (cell[6]) {
        if (k == kmax) return 2;
        sidx[k] = (uint16_t)(((d * P + p) << 1) + 1);
        sval[k++] = cell[6];
      }
    }
    int8_t* sc = scalars + d * 4;
    sc[0] = strand;
    sc[1] = mq;
    sc[2] = hap;
    sc[3] = af;
  }
  // pass B: validate the derived channels cell by cell (the candidate is
  // ~D*33*C bytes, still in L1/L2 from pass A)
  for (int64_t d = 0; d < D; d++) {
    const int8_t* row = m + d * sD;
    const int8_t* sc = scalars + d * 4;
    for (int64_t p = 0; p < P; p++) {
      const int8_t* cell = row + p * C;
      int cov = cell[2] != 0;
      if (cell[2] != (cov ? sc[0] : 0)) return 1;
      if (cell[3] != (cov ? sc[1] : 0)) return 1;
      if (cell[7] != (cov ? sc[2] : 0)) return 1;
      if (cell[0] != (cov ? refcol[p] : 0)) return 1;
      if (cell[5] != (cell[0] != 0 ? sc[3] : 0)) return 1;
    }
  }
  for (int64_t i = k; i < kmax; i++) {
    sidx[i] = pad_idx;
    sval[i] = 0;
  }
  *count_out = k;
  return 0;
}

}  // namespace

extern "C" {

// Filled-depth band of [N, D, 33, C] int8: smallest [lo, hi) covering
// every nonzero row.  Scans row-bytes with early exit (the engine's
// numpy equivalent, chunk.any(axis=(0,2,3)), always reads the full
// batch); an all-zero batch reports the empty band lo = hi = D / 2.
void clair3t_fa_band(const int8_t* matrix, int64_t N, int64_t D, int64_t C,
                     int64_t* lo_out, int64_t* hi_out) {
  const int64_t row_bytes = 33 * C;
  const int64_t cand_bytes = D * row_bytes;
  auto row_nonzero = [&](int64_t d) {
    for (int64_t n = 0; n < N; n++) {
      const int8_t* row = matrix + n * cand_bytes + d * row_bytes;
      for (int64_t b = 0; b < row_bytes; b++)
        if (row[b]) return true;
    }
    return false;
  };
  int64_t lo = 0, hi = D;
  while (lo < hi && !row_nonzero(lo)) lo++;
  while (hi > lo && !row_nonzero(hi - 1)) hi--;
  if (lo == hi) lo = hi = D / 2;
  *lo_out = lo;
  *hi_out = hi;
}

// matrix [N, D, 33, C] int8 (C-contiguous, C in {8, 9}); packs the
// depth-row window [row_off, row_off + rows) of every candidate (pass
// row_off = 0, rows = D for the whole tensor — rows is the packed D').
// Outputs are caller-allocated: bq [N,rows,33] i8, bitmask [N,rows,5] u8,
// scalars [N,rows,4] i8, refcol [N,33] i8, sidx [N,kmax] u16, sval
// [N,kmax] i8, dwell [N,rows,33] i8 or NULL (required iff C == 9).
// max_count gets the largest per-candidate sparse entry count (for
// K-bucket narrowing in Python).  The caller guarantees rows outside the
// window are zero (the band from clair3t_fa_band).
int clair3t_fa_pack_sparse(const int8_t* matrix, int64_t N, int64_t D,
                           int64_t C, int64_t row_off, int64_t rows,
                           int8_t* bq, uint8_t* bitmask,
                           int8_t* scalars, int8_t* refcol, uint16_t* sidx,
                           int8_t* sval, int8_t* dwell, int64_t kmax,
                           int64_t* max_count) {
  if (C != 8 && C != 9) return 1;
  if ((C == 9) != (dwell != nullptr)) return 1;
  if (row_off < 0 || rows <= 0 || row_off + rows > D) return 1;
  int64_t pad = rows * 33 * 2;  // dummy scatter slot past the flat end
  if (pad >= 65535) return 1;
  int64_t worst = 0;
  for (int64_t n = 0; n < N; n++) {
    int64_t cnt = 0;
    int rc = pack_fa_one(matrix + (n * D + row_off) * 33 * C, rows, C,
                         bq + n * rows * 33,
                         bitmask + n * rows * 5, scalars + n * rows * 4,
                         refcol + n * 33, sidx + n * kmax, sval + n * kmax,
                         dwell ? dwell + n * rows * 33 : nullptr, kmax,
                         (uint16_t)pad, &cnt);
    if (rc) return rc;
    if (cnt > worst) worst = cnt;
  }
  *max_count = worst;
  return 0;
}

// matrix [N, 33, 18] int16 or int32 (elem = 2 or 4); packs to mags u8
// [N,33,18] + negidx i8 [N,33] (18 = no negated channel).  Validation
// mirrors pack_pileup's rebuild-and-compare: |v| <= 255 everywhere, and
// with negidx = first negative channel % 9, entries at channels
// {negidx, negidx+9} must be <= 0 and all others >= 0 (reference negation
// quirk: src/clair3_pileup.c:370-371).
int clair3t_pileup_pack(const void* matrix, int64_t N, int elem,
                        uint8_t* mags, int8_t* negidx) {
  if (elem != 2 && elem != 4) return 1;
  const int64_t P = 33, CH = 18;
  for (int64_t n = 0; n < N; n++) {
    for (int64_t p = 0; p < P; p++) {
      // widen to int64 before negating: -INT32_MIN is signed-overflow UB
      // and must reject via the >255 magnitude check, not wrap
      int64_t v[18];
      if (elem == 2) {
        const int16_t* src = (const int16_t*)matrix + (n * P + p) * CH;
        for (int c = 0; c < CH; c++) v[c] = src[c];
      } else {
        const int32_t* src = (const int32_t*)matrix + (n * P + p) * CH;
        for (int c = 0; c < CH; c++) v[c] = src[c];
      }
      int ni = 18;
      for (int c = 0; c < CH; c++)
        if (v[c] < 0) { ni = c % 9; break; }
      uint8_t* mg = mags + (n * P + p) * CH;
      for (int c = 0; c < CH; c++) {
        int64_t a = v[c] < 0 ? -v[c] : v[c];
        if (a > 255) return 1;
        int in_pat = (c == ni) || (c == ni + 9);
        if (in_pat ? (v[c] > 0) : (v[c] < 0)) return 1;
        mg[c] = (uint8_t)a;
      }
      negidx[n * P + p] = (int8_t)ni;
    }
  }
  return 0;
}

}  // extern "C"
