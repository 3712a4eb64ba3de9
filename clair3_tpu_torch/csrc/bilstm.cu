// One bidirectional LSTM layer's recurrence, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel clair3_tpu/ops/pallas_lstm.py::bilstm_pallas
// (_kernel).  Given the pre-projected inputs xw (4H gate inputs per row,
// step and direction) and the recurrent weights wh [2, H, 4H], each step t
// and direction d computes, for every batch row,
//   gates = float(xw[t, d]) + h . wh[d]          (float32 sums)
//   c = round(sigmoid(f) * c + sigmoid(i) * tanh(g))
//   h = round(sigmoid(o) * tanh(c))
// with gate order (i, f, g, o), h and c rounded to the input dtype (float or
// bf16) after every step, and writes h to hs.  The rounding points are
// pallas_lstm._kernel's: tanh reads the rounded c.
//
// Layout by strides (elements): xw[t][d][row][n] is at
// t*xs_t + d*xs_d + row*xs_b + n, hs[t][d][row][j] at t*hs_t + d*hs_d +
// row*hs_b + j.  The TPU layout ([T, 2, B, 4H] in, [T, 2, B, H] out, slot 1
// reversed in time) is one set; BiLSTM's is another ([B, T, 8H] from one
// addmm in, [B, T, 2H] in torch order out), with `reverse1` set: direction 1
// is stored in natural time, so its step t reads and writes time T-1-t.
//
// What bounds it on this card: 4H*H multiply-adds per row and step (64 K at
// H = 128, 102 K at H = 160) in T = 33 dependent steps; by the data sheet
// the bytes (xw read once, hs written once: 0.10 ms at B = 4096, H = 128).
//
// bf16 at H = 128 or 160, bilstm_tc_kernel (tensor cores):
//   * one block per (direction, tile of BM = 32 batch rows, two m16 tiles),
//     H/16 warps; warp w owns hidden units [16w, 16w + 16) of all four
//     gates: 8 n8 tiles of the gate dimension, 2 per gate.  Each thread's
//     accumulator fragments then hold i, f, g and o of the same (row, unit)
//     pairs, so the cell update runs in registers, and c lives there for the
//     block's life (as rounded bf16 values held in float);
//   * wh[d] in bf16 stays in shared memory for the whole sequence (128 KB at
//     H = 128, 200 KB at H = 160), loaded once in mma.sync B-fragment order
//     (packed on the host by ops/bilstm.py::pack_wh_fragments): each lane
//     reads its two n8 tiles of one gate as one 16-byte load, 32 lanes on
//     512 consecutive bytes, free of bank conflicts;
//   * h [BM, H] bf16 lives in shared memory, rows padded by 8 elements so
//     the A-fragment loads are free of bank conflicts;
//   * a step: the accumulators start from xw at their own positions (loaded
//     into registers one step ahead, so the loads are in flight for a whole
//     step), barrier, H/16 k-steps of 16 mma.sync m16n8k16 (bf16 products,
//     f32 sums) per warp, the cell update in registers, barrier, the new h
//     to shared memory and to hs.  One h buffer: a second does not fit at
//     H = 160 beside the 200 KB of weights.  The products and the cell
//     update are lstm_common.cuh's, shared with K1's tensor-core launches
//     (pileup_tc.cu), which differ only in the argument of h's tanh;
//   * the gate functions are tanh.approx.f32 (sigmoid(x) = 0.5 tanh(x/2) +
//     0.5), one MUFU instruction each: with expf/tanhf the gate arithmetic
//     took about half the kernel's time (measured by removing it), and the
//     outputs stay within 2 bf16 ulps of the exact twin.
//
// f32, and bf16 at other widths, bilstm_kernel (SIMT): one block per
// (direction, tile of BT batch rows), 4H threads: thread n owns gate column
// n and sums it for the BT rows in registers, reading wh[d][k][n] (L2
// resident: 256 KB at H = 128 in f32 does not fit in shared memory) and
// h[r][k] from shared memory; the gate sums go to shared memory, and after a
// barrier the threads apply the cell update to (row, unit) pairs.  Measured,
// a step is bound by instruction issue: each weight load feeds 8 shared-memory loads
// and 8 FMAs.  Rows past the batch are computed on zeros and never stored,
// in both kernels.

#include "lstm_common.cuh"

namespace {

constexpr int BT = 8;  // batch rows per block of the SIMT kernel

struct Strides {
  long long xt, xd, xb;  // xw: time, direction, row
  long long ht, hd, hb;  // hs: time, direction, row
};

// the time index step t of direction d reads and writes
__device__ __forceinline__ int time_of(int t, int d, int nT, int reverse1) {
  return reverse1 && d == 1 ? nT - 1 - t : t;
}

template <typename T>
__global__ void __launch_bounds__(1024)
bilstm_kernel(const T* __restrict__ xw, const T* __restrict__ wh, T* __restrict__ hs, int nT,
              int B, int H, Strides s, int reverse1) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* gs = smem;               // gate sums [BT][4H]
  float* h = gs + BT * G;         // [BT][H], rounded
  float* c = h + BT * H;          // [BT][H], rounded

  const int d = blockIdx.y;
  const int row0 = blockIdx.x * BT;
  const int n = threadIdx.x;      // gate column
  const T* __restrict__ w = wh + (size_t)d * H * G + n;

  for (int k = n; k < BT * H; k += G) {
    h[k] = 0.f;
    c[k] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < nT; ++t) {
    const int tt = time_of(t, d, nT, reverse1);
    const T* x_t = xw + tt * s.xt + d * s.xd;
    float sum[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) sum[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float wv = to_f(w[(size_t)k * G]);
#pragma unroll
      for (int r = 0; r < BT; ++r) sum[r] += h[r * H + k] * wv;
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = row0 + r;
      const float xv = row < B ? to_f(x_t[row * s.xb + n]) : 0.f;
      gs[r * G + n] = xv + sum[r];
    }
    __syncthreads();

    T* out_t = hs + tt * s.ht + d * s.hd;
    for (int k = n; k < BT * H; k += G) {
      const int r = k / H;
      const int j = k % H;
      const float* g = gs + r * G;
      const float c_new = round_to<T>(sigmoid_f(g[H + j]) * c[k] +
                                      sigmoid_f(g[j]) * tanhf(g[2 * H + j]));
      const float h_new = round_to<T>(sigmoid_f(g[3 * H + j]) * tanhf(c_new));
      c[k] = c_new;
      h[k] = h_new;
      const int row = row0 + r;
      if (row < B) out_t[row * s.hb + j] = from_f<T>(h_new);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_simt(const void* xw, const void* wh, void* hs, int nT, int B, int H,
                const Strides& s, int reverse1, cudaStream_t stream) {
  const size_t bytes = (size_t)BT * (4 * H + 2 * H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bilstm_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<T><<<grid, 4 * H, bytes, stream>>>(
      static_cast<const T*>(xw), static_cast<const T*>(wh), static_cast<T*>(hs), nT, B, H, s,
      reverse1);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ------------------------------------------

constexpr int BM = 32;  // batch rows per block: two m16 tiles

// fragment positions and the accumulators' layout: lstm_common.cuh
template <int H>
__global__ void __launch_bounds__(32 * (H / 16), 1)
bilstm_tc_kernel(const __nv_bfloat16* __restrict__ xw, const uint4* __restrict__ wpk,
                 __nv_bfloat16* __restrict__ hs, int nT, int B, Strides s, int reverse1) {
  constexpr int NW = H / 16;          // warps, and k16 steps
  constexpr int HP = H + 8;           // padded row of h in shared memory
  constexpr int WV = H * H / 2;       // uint4 of one direction's packed weights
  extern __shared__ __align__(16) unsigned char smem_tc[];
  uint4* w_s = reinterpret_cast<uint4*>(smem_tc);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem_tc + (size_t)WV * 16);

  const int d = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;

  const uint4* __restrict__ src = wpk + (size_t)d * WV;
  for (int i = threadIdx.x; i < WV; i += 32 * NW) w_s[i] = src[i];
  for (int i = threadIdx.x; i < BM * HP / 2; i += 32 * NW)
    reinterpret_cast<uint32_t*>(h_s)[i] = 0u;

  float c[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int sn = 0; sn < 2; ++sn)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][sn][e] = 0.f;

  const int unit0 = 16 * warp + 2 * q;  // + 8 s: this thread's first unit of each n8 tile
  // xw of one step at the accumulators' positions, as loaded (bf16 pairs)
  __nv_bfloat162 xv[2][2][4][2];  // mt, row half, gate, n8 tile
  auto load_x = [&](int t) {
    const __nv_bfloat16* x_t = xw + time_of(t, d, nT, reverse1) * s.xt + d * s.xd;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + mt * 16 + g + 8 * hf;
        const __nv_bfloat16* xr = x_t + row * s.xb + unit0;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
#pragma unroll
          for (int sn = 0; sn < 2; ++sn)
            xv[mt][hf][gate][sn] = row < B
                ? *reinterpret_cast<const __nv_bfloat162*>(xr + gate * H + 8 * sn)
                : __floats2bfloat162_rn(0.f, 0.f);
      }
  };
  load_x(0);
  for (int t = 0; t < nT; ++t) {
    const int tt = time_of(t, d, nT, reverse1);
    float acc[2][4][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
#pragma unroll
          for (int sn = 0; sn < 2; ++sn) {
            const float2 v = __bfloat1622float2(xv[mt][hf][gate][sn]);
            acc[mt][gate][sn][2 * hf] = v.x;
            acc[mt][gate][sn][2 * hf + 1] = v.y;
          }
    if (t + 1 < nT) load_x(t + 1);  // in flight for the whole step
    __syncthreads();  // h of step t - 1 (and, at t = 0, the weights) in place

    h_products<H>(acc, h_s, w_s, warp, lane);
    __nv_bfloat162 h_new[2][2][2];
    cell_update<true>(acc, c, h_new);  // tanh of the rounded c, as pallas_lstm._kernel
    __syncthreads();  // every warp has read h of step t - 1

    __nv_bfloat16* out_t = hs + tt * s.ht + d * s.hd;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + g + 8 * hf;
#pragma unroll
        for (int sn = 0; sn < 2; ++sn) {
          *reinterpret_cast<__nv_bfloat162*>(h_s + r * HP + unit0 + 8 * sn) =
              h_new[mt][sn][hf];
          if (row0 + r < B)
            *reinterpret_cast<__nv_bfloat162*>(out_t + (row0 + r) * s.hb + unit0 + 8 * sn) =
                h_new[mt][sn][hf];
        }
      }
  }
}

template <int H>
int launch_tc(const void* xw, const void* wpk, void* hs, int nT, int B, const Strides& s,
              int reverse1, cudaStream_t stream) {
  const size_t bytes = (size_t)H * H * 8 + (size_t)BM * (H + 8) * 2;
  cudaError_t e = cudaFuncSetAttribute(bilstm_tc_kernel<H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + BM - 1) / BM, 2);
  bilstm_tc_kernel<H><<<grid, 32 * (H / 16), bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(xw), static_cast<const uint4*>(wpk),
      static_cast<__nv_bfloat16*>(hs), nT, B, s, reverse1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (of xw, wh and hs).  Strides in elements, as
// in the header; the last dimension of xw and hs is contiguous.  packed = 0:
// wh is [2, H, 4H], SIMT kernel, 4H threads per block, so H <= 256.
// packed = 1: bf16, H = 128 or 160, wh is pack_wh_fragments(wh), tensor
// cores; xw, hs and their strides 4-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success).
int clair3t_bilstm(int dtype, int device, const void* xw, const void* wh, void* hs, int T,
                   int B, int H, long long xs_t, long long xs_d, long long xs_b,
                   long long hs_t, long long hs_d, long long hs_b, int reverse1, int packed,
                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (T <= 0 || B <= 0 || H <= 0 || 4 * H > 1024) return (int)cudaErrorInvalidValue;
  const Strides s{xs_t, xs_d, xs_b, hs_t, hs_d, hs_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (H == 128) return launch_tc<128>(xw, wh, hs, T, B, s, reverse1, st);
    if (H == 160) return launch_tc<160>(xw, wh, hs, T, B, s, reverse1, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch_simt<float>(xw, wh, hs, T, B, H, s, reverse1, st);
  if (dtype == 1) return launch_simt<__nv_bfloat16>(xw, wh, hs, T, B, H, s, reverse1, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
