// The full-alignment net's first ConvBNRelu, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel clair3_tpu/ops/pallas_fa.py::fa_conv1_pallas
// (_conv1_kernel over the _band_matrix).  Per output (b, f, i, j):
//   out = round(relu(b_eff[f] + sum_{dy,dx,c} x[b, 2i+dy-1, 2j+dx-1, c]
//                                            * w_eff[dy, dx, c, f]))
// a 3x3 convolution with stride 2 and zero padding 1, on the raw int8
// input; the wrapper (ops/fa_conv1.py) folds the /100, the conv bias and
// the inference BatchNorm into w_eff (compute dtype) and b_eff (float32)
// on the device.  Products accumulate in float32; the output is rounded
// once to the compute dtype (float or bf16) and written NCHW, the layout
// the port's FA net runs its later convolutions in.
//
// What bounds it on this card: 9*C (72 or 81) multiply-adds per output,
// 4.4 MFLOP per 55x33x8 sample against ~15 KB of int8 input and ~61 KB of
// bf16 output (~58 flop per byte, above the float32 ridge of ~20), so the
// FP32 pipes are the roofline.  This simple design is bound instead by its
// shared-memory reads, two per multiply-add (the input and the weight;
// neighbouring threads' inputs are 2 words apart, a 2-way bank conflict).
// The TPU's banded matmul spends 11x these FLOPs to fit its matrix unit
// and is not carried over.
//
// Design (right and simple first):
//   * one block per (sample, tile of RT output rows); blocks are
//     independent;
//   * the block stages the folded weights [3][3][C][F] and its 2*RT+1
//     input rows in shared memory, the rows as float in [row][c][col+1]
//     order with a zero column on each side and zero rows past the edges,
//     so the loop has no bounds checks and neighbouring threads (which
//     own neighbouring output columns j) read addresses 2 words apart;
//   * threads walk the block's outputs f-major, (row, j) minor, so the
//     NCHW stores of a warp are contiguous and its weight reads are
//     broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int RT = 8;     // output rows per block
constexpr int NT = 256;   // threads per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

template <typename T>
__global__ void __launch_bounds__(NT)
fa_conv1_kernel(const int8_t* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ out,
                int D, int W, int C, int F, int dout, int wout, int tiles) {
  extern __shared__ float smem[];
  const int WP = W + 2;                  // padded columns
  const int ROWS = 2 * RT + 1;
  float* ws = smem;                      // [3][3][C][F]
  float* xs = smem + 9 * C * F;          // [ROWS][C][WP]

  const int b = blockIdx.x / tiles;
  const int i0 = (blockIdx.x % tiles) * RT;
  const int nrow = min(RT, dout - i0);
  const int tid = threadIdx.x;

  for (int k = tid; k < 9 * C * F; k += NT) ws[k] = to_f(w[k]);
  // input rows 2*i0-1 .. 2*i0-1+ROWS-1; row r of the tile is 2*i0-1+r
  const int8_t* xb = x + (size_t)b * D * W * C;
  for (int k = tid; k < ROWS * C * WP; k += NT) {
    const int r = k / (C * WP);
    const int c = (k / WP) % C;
    const int cp = k % WP;               // padded column: input col cp-1
    const int row = 2 * i0 - 1 + r;
    const int col = cp - 1;
    float v = 0.f;
    if (row >= 0 && row < D && col >= 0 && col < W)
      v = (float)xb[((size_t)row * W + col) * C + c];
    xs[k] = v;
  }
  __syncthreads();

  const int per_f = nrow * wout;
  T* ob = out + (size_t)b * F * dout * wout;
  for (int k = tid; k < F * per_f; k += NT) {
    const int f = k / per_f;
    const int p = k % per_f;
    const int il = p / wout;
    const int j = p % wout;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* xr = xs + (size_t)(2 * il + dy) * C * WP + 2 * j;  // col 2j-1 padded
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* wr = ws + (size_t)(dy * 3 + dx) * C * F + f;
        for (int c = 0; c < C; ++c) acc += xr[c * WP + dx] * wr[c * F];
      }
    }
    const float v = fmaxf(acc + bias[f], 0.f);
    ob[((size_t)f * dout + i0 + il) * wout + j] = from_f<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int D,
           int W, int C, int F, cudaStream_t stream) {
  const int dout = (D + 1) / 2, wout = (W + 1) / 2;
  const int tiles = (dout + RT - 1) / RT;
  const size_t bytes = (size_t)(9 * C * F + (2 * RT + 1) * C * (W + 2)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fa_conv1_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)B * tiles);
  fa_conv1_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), D, W, C, F, dout, wout, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (of w and out).  x [B, D, W, C] int8,
// w [3, 3, C, F], bias [F] float32, out [B, F, ceil(D/2), ceil(W/2)].
// Returns cudaGetLastError() after the launch (0 on success).
int clair3t_fa_conv1(int dtype, int device, const void* x, const void* w, const void* bias,
                     void* out, int B, int D, int W, int C, int F, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || D <= 0 || W <= 0 || C <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, bias, out, B, D, W, C, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, bias, out, B, D, W, C, F, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
