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
// once to the compute dtype and written NCHW, the layout the port's FA net
// runs its later convolutions in.  These are the Pallas kernel's rounding
// points: an int8 value times a bf16 weight is exact in float32.
//
// Two routes, one per compute dtype.
//
// bf16 (the main path's route: the net's switch is bf16-only): an implicit
// GEMM on the tensor cores, fa_conv1_tc_kernel.
//   What bounds it: per 55x33x8 sample 476 outputs x 64 filters x 72 MACs
//   (4.4 MFLOP) against 14.5 KB of int8 input and 61 KB of bf16 output,
//   ~58 flop per byte, far below the bf16 tensor-core ridge (~295), so the
//   bound is memory: at B = 4096, 59.5 MB in + 249.6 MB out over 3.35 TB/s
//   = 0.092 ms (89x33x9: 0.152 ms).  The output is 80% of the bytes.
//   Design, per term of that bound:
//   * persistent blocks, one per SM, 12 warps, each walking over samples;
//   * input: a sample's tile is one contiguous D*W*C run of int8.  It is
//     copied with 16-byte cp.async (zero-filled past the tensor's end) into
//     a two-stage shared ring, so sample s+1 arrives while s computes;
//   * GEMM per sample, transposed: out^T[64 filters, M pixels] = W^T[64, K]
//     . X[K, M], M = ceil(D/2)*17, with mma.sync.m16n8k16 bf16 -> f32.  The
//     weights (A, 4 m16 tiles of filters) stay in registers for the whole
//     block; each warp takes n8 tiles of pixels and builds the B fragments
//     straight from the staged int8 tile (zero at the padding edge, two
//     int8 to bf16x2 per 32-bit register, exactly, by the float
//     magic-number trick), so the input is read from shared memory once
//     per use and never widened in device memory;
//   * K order: (dy, dx, c) for c < 8, two taps per k16 step, tap 9 zero,
//     5 steps (K = 80); for C = 9 one more step holds channel 8 of the nine
//     taps (K = 96, not 144: padding every tap to 16 channels would spend
//     1.8x the tensor-core work and registers for nothing).  The wrapper
//     packs w_eff into that [K, 64] bf16 matrix with zero rows for the
//     padding (ops/fa_conv1.py::pack_weights);
//   * epilogue: + b_eff, ReLU, one rounding to bf16, into a shared tile
//     that is the sample's NCHW [64][ceil(D/2)][17] block exactly (the
//     transposed GEMM puts two neighbouring pixels of one filter in one
//     register pair, one 32-bit store when M is even); then every thread
//     writes it out with 16-byte coalesced stores, which drain while the
//     next sample computes.
//   The FLOPs (18 GFLOP at B = 4096, ~9% of the bound time at the dense
//   bf16 peak) leave mma.sync headroom, so wgmma (64-row tiles from shared
//   memory, for compute-bound products) is not used: it would need the
//   input widened to bf16 in shared memory first, an extra pass over it.
//
// f32 (off the main path): a direct convolution, fa_conv1_kernel, bound by
//   its shared-memory reads (two per multiply-add; the FP32 pipes, 67
//   TFLOP/s, are the roofline at 0.27 ms for 55x33x8, B = 4096).  One block
//   per (sample, 8 output rows) stages the weights [3][3][C][F] and its 17
//   input rows as float in [row][c][col+1] order with zero padding, and
//   threads walk outputs f-major so a warp's NCHW stores are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: direct convolution

constexpr int RT = 8;     // output rows per block
constexpr int NT = 256;   // threads per block

__global__ void __launch_bounds__(NT)
fa_conv1_kernel(const int8_t* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                int D, int W, int C, int F, int dout, int wout, int tiles) {
  extern __shared__ float smem_f32[];
  const int WP = W + 2;                  // padded columns
  const int ROWS = 2 * RT + 1;
  float* ws = smem_f32;                  // [3][3][C][F]
  float* xs = smem_f32 + 9 * C * F;          // [ROWS][C][WP]

  const int b = blockIdx.x / tiles;
  const int i0 = (blockIdx.x % tiles) * RT;
  const int nrow = min(RT, dout - i0);
  const int tid = threadIdx.x;

  for (int k = tid; k < 9 * C * F; k += NT) ws[k] = w[k];
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
  float* ob = out + (size_t)b * F * dout * wout;
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
    ob[((size_t)f * dout + i0 + il) * wout + j] = fmaxf(acc + bias[f], 0.f);
  }
}

int launch_f32(const void* x, const void* w, const void* bias, void* out, int B, int D,
               int W, int C, int F, cudaStream_t stream) {
  const int dout = (D + 1) / 2, wout = (W + 1) / 2;
  const int tiles = (dout + RT - 1) / RT;
  const size_t bytes = (size_t)(9 * C * F + (2 * RT + 1) * C * (W + 2)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fa_conv1_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  fa_conv1_kernel<<<(unsigned)B * tiles, NT, bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), D, W, C, F, dout, wout, tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on the tensor cores

constexpr int TC_NT = 384;               // 12 warps
constexpr int TC_WARPS = TC_NT / 32;
constexpr int TC_F = 64;                 // filters: 4 m16 tiles
constexpr int TC_STAGES = 2;             // input ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past `valid` are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// bytes 0 and 1 of w (two int8, low first) -> bf16x2 (low first), exactly:
// 0x4B0000uu is the float 2^23 + u with u = v + 128, minus 2^23 + 128 is v
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  const float lo = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7640)) - 8388736.f;
  const float hi = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7641)) - 8388736.f;
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t ld_bf16x2(const unsigned short* w, int k_lo, int k_hi, int f) {
  return (uint32_t)__ldg(w + k_lo * TC_F + f) | ((uint32_t)__ldg(w + k_hi * TC_F + f) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 at channel c (and c+1 when `two`) of tap `tap` (3*dy + dx) around
// the pixel whose centre tap is at px; 0 where the tap falls in the padding
template <int C, bool two>
__device__ __forceinline__ uint32_t tap_bytes(const unsigned char* px, int W, uint32_t ok,
                                              int tap, int c) {
  if (tap > 8 || !((ok >> tap) & 1u)) return 0u;
  const int dy = tap / 3, dx = tap - 3 * (tap / 3);
  const unsigned char* q = px + ((dy - 1) * W + (dx - 1)) * C + c;
  if (!two) return q[0];
  if (C == 8) return *reinterpret_cast<const unsigned short*>(q);  // 2-aligned
  return (uint32_t)q[0] | ((uint32_t)q[1] << 8);
}

template <int C>
__global__ void __launch_bounds__(TC_NT, 1)
fa_conv1_tc_kernel(const int8_t* __restrict__ x, const unsigned short* __restrict__ wp,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                   int B, int D, int W, int dout, int wout, int stage_bytes) {
  constexpr int KS = C == 8 ? 5 : 6;     // k16 steps: 5 x 2 taps of 8 channels [+ channel 8]
  extern __shared__ __align__(16) unsigned char smem_tc[];
  unsigned char* ring = smem_tc;                                        // [TC_STAGES][stage_bytes]
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem_tc + TC_STAGES * stage_bytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group and thread in group
  const int M = dout * wout;
  const long long S = (long long)D * W * C;
  const long long total = S * B;

  // A = W^T fragments (filter rows, k columns), for the whole block
  uint32_t a[KS][4][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int f = mt * 16 + g, k = ks * 16 + 2 * t;
      a[ks][mt][0] = ld_bf16x2(wp, k, k + 1, f);
      a[ks][mt][1] = ld_bf16x2(wp, k, k + 1, f + 8);
      a[ks][mt][2] = ld_bf16x2(wp, k + 8, k + 9, f);
      a[ks][mt][3] = ld_bf16x2(wp, k + 8, k + 9, f + 8);
    }
  }
  float bias_r[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    bias_r[mt][0] = __ldg(bias + mt * 16 + g);
    bias_r[mt][1] = __ldg(bias + mt * 16 + g + 8);
  }

  // the 16-byte chunks covering sample s, into ring stage `stage`
  auto stage_in = [&](int s, int stage) {
    const long long start = (long long)s * S;
    const long long c0 = start & ~15LL;
    const int n = (int)((((start + S + 15) & ~15LL) - c0) >> 4);
    const uint32_t dst = smem_addr(ring + stage * stage_bytes);
    for (int k = tid; k < n; k += TC_NT) {
      const long long at = c0 + 16LL * k;
      const long long left = total - at;
      cp_async16(dst + 16 * k, x + at, left >= 16 ? 16 : (int)left);
    }
  };

  int it = 0;
  if ((int)blockIdx.x < B) stage_in(blockIdx.x, 0);
  cp_async_commit();
  for (int s = blockIdx.x; s < B; s += gridDim.x, ++it) {
    if (s + (int)gridDim.x < B) stage_in(s + gridDim.x, (it + 1) % TC_STAGES);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // sample s staged by every thread; os free again

    const unsigned char* xs = ring + (it % TC_STAGES) * stage_bytes + (int)((s * S) & 15);
    for (int nt = warp; nt * 8 < M; nt += TC_WARPS) {
      // B fragments: this lane's pixel is column g of the n8 tile
      const int p = nt * 8 + g;
      const int i = p / wout, j = p - (p / wout) * wout;
      const uint32_t rows = (p < M ? 0x038u : 0u) | (p < M && i > 0 ? 0x007u : 0u) |
                            (p < M && 2 * i + 1 < D ? 0x1C0u : 0u);
      const uint32_t cols = 0x092u | (j > 0 ? 0x049u : 0u) | (2 * j + 1 < W ? 0x124u : 0u);
      const uint32_t ok = rows & cols;     // bit 3*dy + dx: tap inside the input
      const unsigned char* px = xs + ((2 * i) * W + 2 * j) * C;
      uint32_t b[KS][2];
#pragma unroll
      for (int ks = 0; ks < 5; ++ks) {
        b[ks][0] = i8x2_to_bf16x2(tap_bytes<C, true>(px, W, ok, 2 * ks, 2 * t));
        b[ks][1] = i8x2_to_bf16x2(tap_bytes<C, true>(px, W, ok, 2 * ks + 1, 2 * t));
      }
      if (C == 9) {  // channel 8 of taps 2t, 2t+1 | tap 8
        b[KS - 1][0] = i8x2_to_bf16x2(tap_bytes<C, false>(px, W, ok, 2 * t, 8) |
                                      (tap_bytes<C, false>(px, W, ok, 2 * t + 1, 8) << 8));
        b[KS - 1][1] = i8x2_to_bf16x2(t == 0 ? tap_bytes<C, false>(px, W, ok, 8, 8) : 0u);
      }
      float acc[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_bf16(acc[mt], a[ks][mt], b[ks][0], b[ks][1]);
      }
      // D fragments: filter rows g, g+8 of each m tile; pixels pc, pc+1
      const int pc = nt * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = fmaxf(acc[mt][2 * h] + bias_r[mt][h], 0.f);
          const float v1 = fmaxf(acc[mt][2 * h + 1] + bias_r[mt][h], 0.f);
          __nv_bfloat16* o = os + (mt * 16 + g + 8 * h) * M + pc;
          if ((M & 1) == 0) {
            if (pc < M) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (pc < M) o[0] = __float2bfloat16(v0);
            if (pc + 1 < M) o[1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();   // the sample's NCHW block is complete in os

    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)s * TC_F * M);
    const uint4* src = reinterpret_cast<const uint4*>(os);
    for (int k = tid; k < TC_F * M / 8; k += TC_NT) dst[k] = src[k];
  }
  cp_async_wait<0>();
}

template <int C>
int launch_tc(const void* x, const void* wp, const void* bias, void* out, int B, int D, int W,
              int device, cudaStream_t stream) {
  const int dout = (D + 1) / 2, wout = (W + 1) / 2;
  const long long S = (long long)D * W * C;
  const int stage_bytes = (int)((S + 31) & ~15LL);
  const size_t bytes = (size_t)TC_STAGES * stage_bytes + (size_t)TC_F * dout * wout * 2;
  cudaError_t e = cudaFuncSetAttribute(fa_conv1_tc_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  fa_conv1_tc_kernel<C><<<B < sms ? B : sms, TC_NT, bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const unsigned short*>(wp),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, D, W, dout, wout,
      stage_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 (float32): w = w_eff [3, 3, C, F] float, any C and F.
// dtype 1 (bfloat16): w = the packed [K, 64] bf16 matrix of
//   ops/fa_conv1.py::pack_weights (K = 80 for C = 8, 96 for C = 9); C must
//   be 8 or 9 and F 64, x 16-byte aligned.
// x [B, D, W, C] int8, bias [F] float32, out [B, F, ceil(D/2), ceil(W/2)]
// in the compute dtype.  Returns cudaGetLastError() after the launch (0 on
// success).
int clair3t_fa_conv1(int dtype, int device, const void* x, const void* w, const void* bias,
                     void* out, int B, int D, int W, int C, int F, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || D <= 0 || W <= 0 || C <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(x, w, bias, out, B, D, W, C, F, s);
  if (dtype != 1 || F != TC_F || (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (C == 8) return launch_tc<8>(x, w, bias, out, B, D, W, device, s);
  if (C == 9) return launch_tc<9>(x, w, bias, out, B, D, W, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
