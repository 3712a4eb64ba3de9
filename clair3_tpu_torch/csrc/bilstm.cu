// One bidirectional LSTM layer's recurrence, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel clair3_tpu/ops/pallas_lstm.py::bilstm_pallas
// (_kernel).  Given the pre-projected inputs xw [T, 2, B, 4H] (direction 1
// already reversed in time) and the recurrent weights wh [2, H, 4H], each
// step t and direction d computes, for every batch row,
//   gates = float(xw[t, d]) + h . wh[d]          (float32 sums)
//   c = round(sigmoid(f) * c + sigmoid(i) * tanh(g))
//   h = round(sigmoid(o) * tanh(c))
// with gate order (i, f, g, o), h and c rounded to the input dtype (float or
// bf16) after every step, and writes hs[t, d] = h (direction 1 still
// reversed).  The rounding points are pallas_lstm._kernel's: tanh reads the
// rounded c.
//
// What bounds it on this card: 4H*H multiply-adds per row and step (64 K at
// H = 128, 102 K at H = 160) in T = 33 dependent steps, with wh (256 KB at
// H = 128, 400 KB at H = 160 in float32) too large for one block's 227 KB of
// shared memory: every block re-reads it from L2 at every step, ~1/BT of it
// per row.  A small batch is latency-bound by the 33 steps.  Measured, a
// step is bound by issue, not by L2: each weight load feeds 8 shared-memory
// loads and 8 FMAs, and the bf16 build (half the L2 bytes) is no faster.
//
// Design (right and simple first; tensor cores come later):
//   * one block per (direction, tile of BT batch rows), 4H threads: thread
//     n owns gate column n and sums it for the BT rows in registers,
//     reading wh[d][k][n] (coalesced across n, L2 resident) and h[r][k]
//     from shared memory (a broadcast);
//   * the gate sums go to shared memory; after a barrier the threads apply
//     the cell update to (row, unit) pairs, c and h living in shared memory
//     as the rounded values;
//   * rows past the batch are computed on zeros and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BT = 8;  // batch rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T>
__global__ void __launch_bounds__(1024)
bilstm_kernel(const T* __restrict__ xw, const T* __restrict__ wh, T* __restrict__ hs, int nT,
              int B, int H) {
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
    const T* x_t = xw + ((size_t)t * 2 + d) * B * G;
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
      const float xv = row < B ? to_f(x_t[(size_t)row * G + n]) : 0.f;
      gs[r * G + n] = xv + sum[r];
    }
    __syncthreads();

    T* out_t = hs + ((size_t)t * 2 + d) * B * H;
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
      if (row < B) out_t[(size_t)row * H + j] = from_f<T>(h_new);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* xw, const void* wh, void* hs, int nT, int B, int H,
           cudaStream_t stream) {
  const size_t bytes = (size_t)BT * (4 * H + 2 * H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bilstm_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<T><<<grid, 4 * H, bytes, stream>>>(
      static_cast<const T*>(xw), static_cast<const T*>(wh), static_cast<T*>(hs), nT, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (of xw, wh and hs).  xw [T, 2, B, 4H],
// wh [2, H, 4H], hs [T, 2, B, H]; 4H threads per block, so H <= 256.
// Returns cudaGetLastError() after the launch (0 on success).
int clair3t_bilstm(int dtype, int device, const void* xw, const void* wh, void* hs, int T,
                   int B, int H, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (T <= 0 || B <= 0 || H <= 0 || 4 * H > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xw, wh, hs, T, B, H, s);
  if (dtype == 1) return launch<__nv_bfloat16>(xw, wh, hs, T, B, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
