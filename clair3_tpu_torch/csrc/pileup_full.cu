// The whole pileup net in one SIMT kernel, float32, for NVIDIA Hopper
// (sm_90a).  The route of ops/pileup_full.py by dtype: float32 runs this
// kernel; bf16 runs the three tensor-core launches of csrc/pileup_tc.cu,
// which take only the net's widths (C <= 32, T = 33, H1 = 128, H2 = 160,
// D = 128), and bf16 at other widths is refused.  Never a fallback.
//
// Replaces the TPU kernel clair3_tpu/ops/pallas_pileup.py:267
// pileup_full_pallas (_make_full_kernel -> _trunk_compute, _lstm_gates,
// _selu) and, with n_heads == 0, :195 pileup_trunk_pallas (_trunk_kernel),
// at compute_dtype float32.  Per candidate:
//   layer 1: BiLSTM(H1=128) over T=33, both directions per step
//            (gates = [x(t); x(T-1-t)] . wi1 + h1 . wh1 + b1), hidden
//            sequence kept;
//   layer 2: BiLSTM(H2=160) over that sequence, with the flatten and the
//            Dense-128 folded in:
//            acc += h_f(t) . wd[t, :H2] + h_b(T-1-t) . wd[T-1-t, H2:];
//   trunk = SELU(acc + bd); per head Dense-128 + SELU -> logits -> SELU ->
//   softmax (lstm_common.cuh's pileup_heads, shared with pileup_tc.cu).
//   Output [B, 24|90] float32 (or the trunk [B, D]).
//
// What bounds it on this card: about 24 M multiply-adds per candidate
// (layer 1 4.9 M, layer 2 17.6 M, dense 1.35 M) in 66 dependent steps, so a
// small batch is latency-bound, and the ~2.1 M weights (8.4 MB) are re-read
// from L2 by every block at every step.  Measured, each step is bound by
// latency and instruction issue (one thread per hidden unit, SIMT FMAs):
// 11.3 ms at B = 4096 (PERF.md).  bf16 bought nothing on this kernel
// (11.7 ms, PR 1), which is why bf16 has its own tensor-core route.
//
// Design (right and simple first):
//   * one block of NT threads owns BT batch rows and loops over the 66 steps
//     of both layers; blocks are independent (no state crosses the grid);
//   * a thread owns one hidden unit (direction d, index j) per step and
//     computes its four gate sums for all BT rows in registers, reading
//     the weight columns from device memory (coalesced across j, L2
//     resident) and the step's inputs from shared memory (broadcast);
//   * h (ping-pong) and c live in shared memory; c is touched only by the
//     thread that owns it;
//   * the layer-1 hidden sequence goes to a global scratch [T, B, 2*H1]
//     (it does not fit shared memory for a useful BT), written once and
//     read back by the same block after a barrier;
//   * the Dense-D accumulator is split by direction ([2, BT, D] in shared
//     memory, one thread per (direction, column)); it takes step t's h in
//     step t+1, reading the same ping-pong buffer as the gates;
//   * the heads and the softmax run at the end of the same block;
//   * rows past the batch are computed on zeros and never stored (the
//     caller's tensors are not padded).

#include "lstm_common.cuh"

namespace {

constexpr int BT = 8;     // batch rows per block
constexpr int NT = 320;   // threads per block: one per layer-2 hidden unit

struct Args {
  const float* x;                       // [B, T, C]
  const float *wi1, *wh1, *b1;          // [2, C, 4H1] [2, H1, 4H1] [2, 4H1]
  const float *wi2, *wh2, *b2;          // [2, 2H1, 4H2] [2, H2, 4H2] [2, 4H2]
  const float *wd, *bd;                 // [T, 2H2, D] [D]
  const float *w5, *b5;                 // [NH, D, L5] [NH, L5]
  const float *wo, *bo;                 // [L5, O] [O]: the heads side by side
  float* h1seq;                         // [T, B, 2H1] scratch
  float* out;                           // [B, O], or the trunk [B, D] if NH == 0
  int B, nT, C, H1, H2, D, L5, NH;      // nT: positions (33)
  int hoff[MAX_HEADS + 1];              // head column offsets; hoff[NH] == O
};

// Shared-memory carve-up: offsets in floats from the start of the block's
// dynamic shared memory.
struct Layout {
  size_t xs;     // step inputs [2][BT][CIN]
  size_t hs;     // h ping-pong [2][2][BT][H]
  size_t cs;     // c [2][BT][H]
  size_t acc;    // dense partial sums by direction [2][BT][D]
  size_t trunk;  // [BT][D]
  size_t h5;     // [BT][L5]
  size_t lg;     // logits after SELU [BT][O]
  size_t total;
};

__host__ __device__ inline Layout make_layout(int C, int H1, int H2, int D, int L5, int O) {
  const size_t XW = C > 2 * H1 ? C : 2 * H1;
  const size_t HM = H1 > H2 ? H1 : H2;
  Layout l;
  l.xs = 0;
  l.hs = l.xs + 2 * BT * XW;
  l.cs = l.hs + 2 * 2 * BT * HM;
  l.acc = l.cs + 2 * BT * HM;
  l.trunk = l.acc + 2 * BT * (size_t)D;
  l.h5 = l.trunk + BT * (size_t)D;
  l.lg = l.h5 + BT * (size_t)L5;
  l.total = l.lg + BT * (size_t)(O > 0 ? O : 1);
  return l;
}

struct Smem {
  float *xs, *hs, *cs, *acc, *trunk, *h5, *lg;
};

// One bidirectional layer over the block's BT rows.  layer 0 reads x and
// writes the hidden sequence; layer 1 reads the hidden sequence and
// accumulates the dense trunk.
__device__ void lstm_layer(const Args& a, const Smem& s, int layer, int row0) {
  const int tid = threadIdx.x;
  const int T_ = a.nT;
  const int H = layer == 0 ? a.H1 : a.H2;
  const int CIN = layer == 0 ? a.C : 2 * a.H1;
  const int G = 4 * H;
  const int HM = a.H1 > a.H2 ? a.H1 : a.H2;
  const float* __restrict__ wi = layer == 0 ? a.wi1 : a.wi2;
  const float* __restrict__ wh = layer == 0 ? a.wh1 : a.wh2;
  const float* __restrict__ bias = layer == 0 ? a.b1 : a.b2;

  for (int i = tid; i < 2 * BT * H; i += NT) {
    s.hs[i] = 0.f;  // buffer 0 holds h(-1)
    s.cs[i] = 0.f;
  }
  if (layer == 1)
    for (int i = tid; i < 2 * BT * a.D; i += NT) s.acc[i] = 0.f;

  int p = 0;  // ping-pong buffer holding h(t-1)
  for (int t = 0; t <= T_; ++t) {  // t == T only folds the last h into the dense
    if (t < T_) {
      for (int i = tid; i < 2 * BT * CIN; i += NT) {
        const int d = i / (BT * CIN);
        const int r = (i / CIN) % BT;
        const int k = i % CIN;
        const int row = row0 + r;
        const int tt = d ? T_ - 1 - t : t;
        float v = 0.f;
        if (row < a.B)
          v = layer == 0 ? a.x[((size_t)row * T_ + tt) * a.C + k]
                         : a.h1seq[((size_t)tt * a.B + row) * 2 * a.H1 + k];
        s.xs[i] = v;
      }
    }
    __syncthreads();
    const float* hprev = s.hs + (size_t)p * 2 * BT * HM;
    float* hnext = s.hs + (size_t)(1 - p) * 2 * BT * HM;

    if (layer == 1 && t > 0) {
      // the dense term of h(t-1): forward half at time t-1, backward half
      // at time T-t; (half, n) is owned by one thread for the whole layer
      const int st = t - 1;
      for (int pair = tid; pair < 2 * a.D; pair += NT) {
        const int half = pair / a.D;
        const int n = pair % a.D;
        const int trow = half ? T_ - 1 - st : st;
        const float* __restrict__ w = a.wd + ((size_t)trow * 2 * H + (size_t)half * H) * a.D + n;
        float sum[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) sum[r] = 0.f;
        for (int j = 0; j < H; ++j) {
          const float wv = w[(size_t)j * a.D];
#pragma unroll
          for (int r = 0; r < BT; ++r) sum[r] += hprev[(half * BT + r) * H + j] * wv;
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) s.acc[(half * BT + r) * a.D + n] += sum[r];
      }
    }

    if (t < T_) {
      for (int u = tid; u < 2 * H; u += NT) {
        const int d = u / H;
        const int j = u % H;
        float g[4][BT];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float bv = bias[(size_t)d * G + q * H + j];
#pragma unroll
          for (int r = 0; r < BT; ++r) g[q][r] = bv;
        }
        const float* __restrict__ wip = wi + (size_t)d * CIN * G + j;
        const float* xin = s.xs + (size_t)d * BT * CIN;
#pragma unroll 2
        for (int k = 0; k < CIN; ++k) {
          const float* wk = wip + (size_t)k * G;
          const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float xv = xin[r * CIN + k];
            g[0][r] += xv * w0;
            g[1][r] += xv * w1;
            g[2][r] += xv * w2;
            g[3][r] += xv * w3;
          }
        }
        const float* __restrict__ whp = wh + (size_t)d * H * G + j;
        const float* hin = hprev + (size_t)d * BT * H;
#pragma unroll 2
        for (int k = 0; k < H; ++k) {
          const float* wk = whp + (size_t)k * G;
          const float w0 = wk[0], w1 = wk[H], w2 = wk[2 * H], w3 = wk[3 * H];
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float hv = hin[r * H + k];
            g[0][r] += hv * w0;
            g[1][r] += hv * w1;
            g[2][r] += hv * w2;
            g[3][r] += hv * w3;
          }
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int idx = (d * BT + r) * H + j;
          const float c_new = sigmoid_f(g[1][r]) * s.cs[idx] + sigmoid_f(g[0][r]) * tanhf(g[2][r]);
          const float h_new = sigmoid_f(g[3][r]) * tanhf(c_new);
          s.cs[idx] = c_new;
          hnext[idx] = h_new;
          const int row = row0 + r;
          if (layer == 0 && row < a.B) {
            // torch bidirectional layout: feature = [h_fwd(t); h_bwd(t)]
            const int tt = d ? T_ - 1 - t : t;
            a.h1seq[((size_t)tt * a.B + row) * 2 * a.H1 + d * a.H1 + j] = h_new;
          }
        }
      }
    }
    __syncthreads();
    p = 1 - p;
  }
}

__global__ void __launch_bounds__(NT) pileup_full_kernel(Args a) {
  extern __shared__ float smem[];
  const Layout l = make_layout(a.C, a.H1, a.H2, a.D, a.L5, a.hoff[a.NH]);
  const Smem s = {smem + l.xs, smem + l.hs,    smem + l.cs, smem + l.acc,
                  smem + l.trunk, smem + l.h5, smem + l.lg};
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BT;

  lstm_layer(a, s, 0, row0);
  lstm_layer(a, s, 1, row0);

  for (int i = tid; i < BT * a.D; i += NT) {
    const int r = i / a.D;
    const int n = i % a.D;
    const float v = selu_f(s.acc[r * a.D + n] + s.acc[(BT + r) * a.D + n] + a.bd[n]);
    if (a.NH == 0) {
      const int row = row0 + r;
      if (row < a.B) a.out[(size_t)row * a.D + n] = v;
    } else {
      s.trunk[i] = v;
    }
  }
  if (a.NH == 0) return;
  pileup_heads<float, BT, NT>(s.trunk, s.h5, s.lg, a.w5, a.b5, a.wo, a.bo, a.D, a.L5, a.NH,
                              a.hoff, a.out, row0, a.B);
}

int launch(const void* const* p, int B, int T_, int C, int H1, int H2, int D, int L5,
           int n_heads, const int* hoff, cudaStream_t stream) {
  Args a;
  a.x = static_cast<const float*>(p[0]);
  a.wi1 = static_cast<const float*>(p[1]);
  a.wh1 = static_cast<const float*>(p[2]);
  a.b1 = static_cast<const float*>(p[3]);
  a.wi2 = static_cast<const float*>(p[4]);
  a.wh2 = static_cast<const float*>(p[5]);
  a.b2 = static_cast<const float*>(p[6]);
  a.wd = static_cast<const float*>(p[7]);
  a.bd = static_cast<const float*>(p[8]);
  a.w5 = static_cast<const float*>(p[9]);
  a.b5 = static_cast<const float*>(p[10]);
  a.wo = static_cast<const float*>(p[11]);
  a.bo = static_cast<const float*>(p[12]);
  a.h1seq = static_cast<float*>(const_cast<void*>(p[13]));
  a.out = static_cast<float*>(const_cast<void*>(p[14]));
  a.B = B; a.nT = T_; a.C = C; a.H1 = H1; a.H2 = H2; a.D = D; a.L5 = L5; a.NH = n_heads;
  for (int i = 0; i <= MAX_HEADS; ++i) a.hoff[i] = hoff[i];

  const size_t bytes = make_layout(C, H1, H2, D, L5, hoff[n_heads]).total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(pileup_full_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + BT - 1) / BT);
  pileup_full_kernel<<<grid, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every operand float32.  n_heads == 0 writes the trunk [B, D] to `out`;
// otherwise probabilities [B, hoff[n_heads]].  Returns cudaGetLastError()
// after the launch (0 on success).
int clair3t_pileup_full(int device, const void* x, const void* wi1,
                        const void* wh1, const void* b1, const void* wi2, const void* wh2,
                        const void* b2, const void* wd, const void* bd, const void* w5,
                        const void* b5, const void* wo, const void* bo, void* h1seq, void* out,
                        int B, int T, int C, int H1, int H2, int D, int L5, int n_heads,
                        int hoff0, int hoff1, int hoff2, int hoff3, int hoff4, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || n_heads < 0 || n_heads > MAX_HEADS) return (int)cudaErrorInvalidValue;
  const void* p[15] = {x, wi1, wh1, b1, wi2, wh2, b2, wd, bd, w5, b5, wo, bo, h1seq, out};
  const int hoff[MAX_HEADS + 1] = {hoff0, hoff1, hoff2, hoff3, hoff4};
  return launch(p, B, T, C, H1, H2, D, L5, n_heads, hoff, static_cast<cudaStream_t>(stream));
}

const char* clair3t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
