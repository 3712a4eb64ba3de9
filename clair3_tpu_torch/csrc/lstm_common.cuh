// Device code shared by the LSTM kernels of this directory: the BiLSTM
// recurrence (bilstm.cu), the pileup net's SIMT kernel (pileup_full.cu) and
// its tensor-core launches (pileup_tc.cu).  Everything is in an unnamed
// namespace: each source that includes it gets its own copy.
//
//   * conversion and rounding to the compute dtype (float or bf16);
//   * the gate and SELU functions, exact (expf, tanhf) and tanh.approx.f32;
//   * the tensor-core LSTM step: mma.sync m16n8k16, the recurrent products
//     h . wh from B fragments resident in shared memory, and the cell update
//     at K2's rounding point or at K1's;
//   * the pileup net's heads and softmax (SIMT).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int MAX_HEADS = 4;  // heads of the pileup net, at most

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float selu_f(float v) {
  const float scale = 1.0507009873554805f, alpha = 1.6732632423543772f;
  return scale * (v > 0.f ? v : alpha * (expf(v) - 1.f));
}

// tanh.approx.f32: one MUFU instruction (relative error ~2^-11, under bf16's
// 2^-9 rounding of h and c); the tensor-core step's gate arithmetic.  With
// expf/tanhf the gates took about half of K2's time (PERF.md, PR 6).
__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float sigmoid_approx(float v) {  // the tanh form, as the Pallas kernels
  return fmaf(0.5f, tanh_approx(0.5f * v), 0.5f);
}

// ---- the tensor-core LSTM step ----------------------------------------------
//
// Fragment positions (PTX ISA, mma.m16n8k16, lane = 4 g + q):
//   A [16 x 16]: a0 (g, 2q..2q+1), a1 (g + 8, 2q..), a2 (g, 2q + 8..),
//                a3 (g + 8, 2q + 8..)
//   B [16 x 8]:  b0 (k = 2q..2q+1, n = g), b1 (k = 2q + 8..2q + 9, n = g)
//   D [16 x 8]:  d0, d1 (g, 2q, 2q + 1), d2, d3 (g + 8, 2q, 2q + 1)
// A block holds BM = 32 batch rows (two m16 tiles) and H/16 warps; warp w
// owns hidden units [16w, 16w + 16) of all four gates.  Accumulator
// acc[mt][gate][sn][e] of warp w: row mt*16 + g + 8*(e >> 1), gate column
// gate*H + 16w + 8sn + 2q + (e & 1), so all four gates of a (row, unit)
// pair sit in one thread and the cell update runs in registers.  Packed
// weights (ops/bilstm.py::pack_wh_fragments): the B fragments of k16 step
// kk, warp w and gate at uint4 index ((kk * NW + w) * 4 + gate) * 32 + lane,
// both n8 tiles of the gate in one 16-byte load.

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of the m16 x k16 tile at (row, col) of a bf16 array with row
// stride ld (row = m16 base + g, col = k16 base + 2q)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int row,
                                       int col) {
  const bf16* p = tile + row * ld + col;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// one k16 step of the four gates for both m16 tiles; b[gate] holds its two n8 tiles
__device__ __forceinline__ void mma_gates(float (&acc)[2][4][2][4], const uint32_t (&a)[2][4],
                                          const uint4 (&b)[4]) {
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16(acc[mt][gate][0], a[mt], b[gate].x, b[gate].y);
      mma_bf16(acc[mt][gate][1], a[mt], b[gate].z, b[gate].w);
    }
}

// acc += h . wh[d]: h [BM, H] bf16 in shared memory (rows padded by 8
// elements, A-fragment loads free of bank conflicts), w_s the packed wh[d]
template <int H>
__device__ __forceinline__ void h_products(float (&acc)[2][4][2][4], const bf16* h_s,
                                           const uint4* w_s, int warp, int lane) {
  constexpr int NW = H / 16, HP = H + 8;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NW; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) load_a(a[mt], h_s, HP, mt * 16 + g, kk * 16 + 2 * q);
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      const uint4 b = w_s[((kk * NW + warp) * 4 + gate) * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][gate][0], a[mt], b.x, b.y);
        mma_bf16(acc[mt][gate][1], a[mt], b.z, b.w);
      }
    }
  }
}

// The cell update in registers, gates (i, f, g, o): c_new = f c + i g in
// float32, c kept rounded to bf16, h = o tanh(.) stored as bf16 pairs
// (h_new[mt][sn][row half]).  The one place K1 and K2 differ is the
// argument of that tanh:
//   kTanhOfRoundedC (K2, pallas_lstm._kernel): the rounded c;
//   otherwise (K1, pallas_pileup._lstm_gates): the unrounded c_new.
template <bool kTanhOfRoundedC>
__device__ __forceinline__ void cell_update(const float (&acc)[2][4][2][4], float (&c)[2][2][4],
                                            bf162 (&h_new)[2][2][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int sn = 0; sn < 2; ++sn) {
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c_new = sigmoid_approx(acc[mt][1][sn][e]) * c[mt][sn][e] +
                            sigmoid_approx(acc[mt][0][sn][e]) * tanh_approx(acc[mt][2][sn][e]);
        c[mt][sn][e] = round_to<bf16>(c_new);
        hv[e] = sigmoid_approx(acc[mt][3][sn][e]) *
                tanh_approx(kTanhOfRoundedC ? c[mt][sn][e] : c_new);
      }
      h_new[mt][sn][0] = __floats2bfloat162_rn(hv[0], hv[1]);
      h_new[mt][sn][1] = __floats2bfloat162_rn(hv[2], hv[3]);
    }
}

// ---- the pileup net's heads -------------------------------------------------

// The heads and the softmax of a block's ROWS rows, in SIMT, with the
// Pallas kernel's rounding points (pallas_pileup.py:176-187): per head
// t . w5 + b5 in float32, round, SELU, round; . wo + bo in float32, round;
// SELU; softmax in float32.  trunk_s [ROWS][D] holds the trunk rounded to
// T (every thread's writes: this syncs first); h5_s [ROWS][L5] and lg_s
// [ROWS][O] are scratch.  Writes probs [B, O] float32 for rows row0.. < B.
// Operands in T: w5 [NH, D, L5], b5 [NH, L5], wo [L5, O], bo [O], the heads
// side by side at column offsets hoff (hoff[NH] == O).
template <typename T, int ROWS, int NTHREADS>
__device__ void pileup_heads(const float* trunk_s, float* h5_s, float* lg_s,
                             const T* __restrict__ w5, const T* __restrict__ b5,
                             const T* __restrict__ wo, const T* __restrict__ bo, int D, int L5,
                             int NH, const int (&hoff)[MAX_HEADS + 1], float* probs, int row0,
                             int B) {
  constexpr int RG = 8;  // rows per SIMT item
  static_assert(ROWS % RG == 0, "a block's rows come in groups of RG");
  const int tid = threadIdx.x, O = hoff[NH];
  __syncthreads();  // the trunk in place
  for (int hd = 0; hd < NH; ++hd) {
    for (int i = tid; i < L5 * (ROWS / RG); i += NTHREADS) {
      const int m = i % L5, r0 = (i / L5) * RG;
      const T* __restrict__ w = w5 + (size_t)hd * D * L5 + m;
      const float bv = to_f(b5[hd * L5 + m]);
      float sum[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) sum[r] = bv;
      for (int n = 0; n < D; ++n) {
        const float wv = to_f(w[(size_t)n * L5]);
#pragma unroll
        for (int r = 0; r < RG; ++r) sum[r] += trunk_s[(r0 + r) * D + n] * wv;
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) h5_s[(r0 + r) * L5 + m] = round_to<T>(selu_f(round_to<T>(sum[r])));
    }
    __syncthreads();
    const int lo = hoff[hd], width = hoff[hd + 1] - lo;
    for (int i = tid; i < width * (ROWS / RG); i += NTHREADS) {
      const int cix = i % width, r0 = (i / width) * RG;
      const T* __restrict__ w = wo + lo + cix;
      const float bv = to_f(bo[lo + cix]);
      float sum[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) sum[r] = bv;
      for (int m = 0; m < L5; ++m) {
        const float wv = to_f(w[(size_t)m * O]);
#pragma unroll
        for (int r = 0; r < RG; ++r) sum[r] += h5_s[(r0 + r) * L5 + m] * wv;
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) lg_s[(r0 + r) * O + lo + cix] = selu_f(round_to<T>(sum[r]));
    }
    __syncthreads();
  }

  for (int i = tid; i < ROWS * NH; i += NTHREADS) {
    const int r = i / NH, hd = i % NH;
    if (row0 + r >= B) continue;
    const float* lg = lg_s + r * O;
    const int lo = hoff[hd], hi = hoff[hd + 1];
    float mx = lg[lo];
    for (int cix = lo + 1; cix < hi; ++cix) mx = fmaxf(mx, lg[cix]);
    float tot = 0.f;
    for (int cix = lo; cix < hi; ++cix) tot += expf(lg[cix] - mx);
    for (int cix = lo; cix < hi; ++cix) probs[(size_t)(row0 + r) * O + cix] = expf(lg[cix] - mx) / tot;
  }
}

}  // namespace
