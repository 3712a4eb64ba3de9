// The pileup net on the tensor cores, for NVIDIA Hopper (sm_90a): three
// launches on one stream, for bf16 at the net's widths (C <= 32, T = 33,
// H1 = 128, H2 = 160, D = 128).
//
// Replaces the TPU kernels clair3_tpu/ops/pallas_pileup.py:267
// pileup_full_pallas (_make_full_kernel) and, with n_heads == 0, :195
// pileup_trunk_pallas (_trunk_kernel).  The rounding points are theirs:
//   gates = x(t) . wi + h . wh + b, summed in float32 (the input projection
//   is not rounded); sigmoid in its tanh form; c_new = f c + i g in float32,
//   h = o tanh(c_new) from the UNROUNDED c_new (pallas_pileup._lstm_gates;
//   K2's pallas_lstm takes tanh of the rounded c), then h and c stored in
//   bf16; the dense sums in float32; the heads round where the Pallas kernel
//   does (pallas_pileup.py:176-187).
//
//   L1 pileup_l1_tc_kernel:  x [B, T, C] -> h1seq [B, T, 2 H1] (torch order)
//   L2 pileup_l2_tc_kernel:  h1seq -> h2seq [B, T, 2 H2]
//   L3 pileup_head_kernel:   h2seq . wd [T 2H2, D] + bd, SELU -> the trunk
//                            [B, D] bf16, or heads + softmax -> [B, O] f32
//
// What bounds it on this card: ~24 M multiply-adds per candidate (0.20 ms of
// bf16 tensor-core peak at B = 4096) in 66 dependent steps.  Both
// directions' recurrent weights of a layer (256 KB at H1, 400 KB at H2) do
// not fit one SM's 227 KB, and layer 2 needs both directions of layer 1 at
// every step, so the layers are separate launches and the hidden sequences
// cross device memory (17 MB + 22 MB bf16 at B = 4096, written once, read
// once).  Layer 2's input weights wi2 (320 KB per direction) do not fit
// beside wh2 either: every block streams them from L2 at every step
// (33 x 256 blocks x 320 KB = 2.8 GB at B = 4096), which is what paces L2.
//
// Design, L1 and L2 (K2's tensor-core step, lstm_common.cuh, which
// csrc/bilstm.cu runs too; only the argument of h's tanh differs):
//   * one block per (tile of BM = 32 batch rows, direction); H/16 warps,
//     warp w owns hidden units [16w, 16w + 16) of all four gates, so each
//     thread's accumulators hold i, f, g, o of the same (row, unit) pairs:
//     the cell update and c stay in registers; the gates use
//     tanh.approx.f32, as K2's step;
//   * wh[d] (and at L1 wi1[d], C zero-padded to K = 32) stay in shared
//     memory for the block's life in mma.sync B-fragment order (packed once
//     per net by ops/pileup_full.py::pack_pileup_operands): one 16-byte load
//     per lane gives both n8 tiles of a gate;
//   * h [BM, H] bf16 lives in shared memory, rows padded by 8 elements
//     (A-fragment loads free of bank conflicts); mma.sync m16n8k16, bf16
//     products, float32 sums; two barriers per step;
//   * L1: x(t + 1) is read into registers during step t and staged in
//     shared memory after the step's second barrier;
//   * L2: the step's input rows [h1seq(tt)] (32 x 256) are staged by
//     cp.async right after the barrier that closes the previous step's
//     products, 16-byte chunk c of row r at c ^ (r & 7) (an XOR swizzle:
//     A-fragment loads free of bank conflicts without padding, which would
//     not fit); wi2[d] fragments come from L2 with 16-byte loads, one k16
//     step ahead, the first of the next step during the recurrent products.
// Design, L3: one block per 32 rows, 8 warps, warp w owns dense columns
// [16w, 16w + 16); the dense is one GEMM over K = T 2H2 (the Pallas sum in
// another order), A staged by cp.async one time step (320 columns) ahead,
// wd fragments from L2 in a ring of registers 10 k16 steps ahead; then the
// heads and the softmax in SIMT (< 1% of the work), lstm_common.cuh's
// pileup_heads, which the f32 kernel of csrc/pileup_full.cu runs too.
// Rows past the batch are computed on zeros and never stored.

#include "lstm_common.cuh"

namespace {

constexpr int BM = 32;         // batch rows per block: two m16 tiles
constexpr int H1 = 128;        // layer-1 units
constexpr int H2 = 160;        // layer-2 units
constexpr int KX = 32;         // layer-1 input channels, zero-padded
constexpr int KC = 2 * H2;     // dense columns per time step (320)
constexpr int D = 128;         // dense units
constexpr int HEAD_NT = 256;   // L3 threads: 8 warps x 16 dense columns

struct Offsets {
  int v[MAX_HEADS + 1];  // head column offsets; v[NH] == O
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with valid == 0 it writes zeros
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

// The fragment positions, the accumulators' layout, the products h . wh and
// the cell update are lstm_common.cuh's (K2's step); K1's cell takes tanh
// of the unrounded c_new: cell_update<false>.

// the accumulators start from the bias b[d] at their columns (read at
// every step from L1: held in registers it costs L2 16 of its 168)
template <int H>
__device__ __forceinline__ void init_acc(float (&acc)[2][4][2][4], const bf16* __restrict__ b,
                                         int d, int warp, int lane) {
  const int unit0 = 16 * warp + 2 * (lane & 3);
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
#pragma unroll
    for (int sn = 0; sn < 2; ++sn) {
      const float2 v = __bfloat1622float2(
          __ldg(reinterpret_cast<const bf162*>(b + d * 4 * H + gate * H + unit0 + 8 * sn)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][gate][sn][e] = e & 1 ? v.y : v.x;
    }
}

// the new h to shared memory and to seq [B, T, 2H] at time tt, half d
template <int H>
__device__ __forceinline__ void store_h(const bf162 (&h_new)[2][2][2], bf16* h_s, bf16* seq,
                                        int row0, int B, int nT, int tt, int d, int warp,
                                        int lane) {
  constexpr int HP = H + 8;
  const int g = lane >> 2, unit0 = 16 * warp + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + g + 8 * hf;
#pragma unroll
      for (int sn = 0; sn < 2; ++sn) {
        *reinterpret_cast<bf162*>(h_s + r * HP + unit0 + 8 * sn) = h_new[mt][sn][hf];
        if (row0 + r < B)
          *reinterpret_cast<bf162*>(seq + ((size_t)(row0 + r) * nT + tt) * 2 * H + d * H +
                                    unit0 + 8 * sn) = h_new[mt][sn][hf];
      }
    }
}

// ---- L1 -------------------------------------------------------------------

__global__ void __launch_bounds__(32 * (H1 / 16), 1)
pileup_l1_tc_kernel(const bf16* __restrict__ x, const uint4* __restrict__ wipk,
                    const uint4* __restrict__ whpk, const bf16* __restrict__ b1,
                    bf16* __restrict__ h1seq, int B, int nT, int C) {
  constexpr int H = H1, NW = H / 16, NT = 32 * NW, HP = H + 8, XP = KX + 8;
  constexpr int WHV = H * H / 2;   // uint4 of one direction's packed wh1
  constexpr int WIV = KX * H / 2;  // uint4 of one direction's packed wi1
  constexpr int XPT = BM * KX / NT;  // x elements each thread stages per step
  static_assert(XPT == 4, "the x stage gives each thread 4 columns of one row");
  extern __shared__ __align__(16) unsigned char smem_l1[];
  uint4* wh_s = reinterpret_cast<uint4*>(smem_l1);
  uint4* wi_s = wh_s + WHV;
  bf16* h_s = reinterpret_cast<bf16*>(wi_s + WIV);
  bf16* x_s = h_s + BM * HP;

  const int d = blockIdx.y, row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;

  for (int i = threadIdx.x; i < WHV; i += NT) wh_s[i] = whpk[(size_t)d * WHV + i];
  for (int i = threadIdx.x; i < WIV; i += NT) wi_s[i] = wipk[(size_t)d * WIV + i];
  for (int i = threadIdx.x; i < BM * HP / 2; i += NT) reinterpret_cast<uint32_t*>(h_s)[i] = 0u;

  // this thread stages columns [xk, xk + 4) of row xr of the step's x tile
  const int xr = threadIdx.x / (KX / XPT), xk = (threadIdx.x % (KX / XPT)) * XPT;
  const bool x_ok = row0 + xr < B;
  const bf16* __restrict__ xrow = x + (size_t)(x_ok ? row0 + xr : 0) * nT * C;
  bf16 xv[XPT];
  auto load_x = [&](int t) {
    const int tt = d ? nT - 1 - t : t;
#pragma unroll
    for (int j = 0; j < XPT; ++j)
      xv[j] = x_ok && xk + j < C ? xrow[tt * C + xk + j] : __float2bfloat16(0.f);
  };
  auto store_x = [&]() {
    bf162* dst = reinterpret_cast<bf162*>(x_s + xr * XP + xk);
    dst[0] = __halves2bfloat162(xv[0], xv[1]);
    dst[1] = __halves2bfloat162(xv[2], xv[3]);
  };

  float c[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int sn = 0; sn < 2; ++sn)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][sn][e] = 0.f;

  load_x(0);
  store_x();
  for (int t = 0; t < nT; ++t) {
    const int tt = d ? nT - 1 - t : t;
    float acc[2][4][2][4];
    init_acc<H>(acc, b1, d, warp, lane);
    if (t + 1 < nT) load_x(t + 1);  // in flight for the whole step
    __syncthreads();  // h(t - 1) and x(t) in place (at t = 0, the weights too)
#pragma unroll
    for (int kk = 0; kk < KX / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_a(a[mt], x_s, XP, mt * 16 + g, kk * 16 + 2 * q);
      uint4 b[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) b[gate] = wi_s[((kk * NW + warp) * 4 + gate) * 32 + lane];
      mma_gates(acc, a, b);
    }
    h_products<H>(acc, h_s, wh_s, warp, lane);
    bf162 h_new[2][2][2];
    cell_update<false>(acc, c, h_new);
    __syncthreads();  // every warp has read h(t - 1) and x(t)
    store_h<H>(h_new, h_s, h1seq, row0, B, nT, tt, d, warp, lane);
    if (t + 1 < nT) store_x();
  }
}

// ---- L2 -------------------------------------------------------------------

__global__ void __launch_bounds__(32 * (H2 / 16), 1)
pileup_l2_tc_kernel(const bf16* __restrict__ h1seq, const uint4* __restrict__ wipk,
                    const uint4* __restrict__ whpk, const bf16* __restrict__ b2,
                    bf16* __restrict__ h2seq, int B, int nT) {
  constexpr int H = H2, K = 2 * H1, NW = H / 16, NT = 32 * NW, HP = H + 8, KS = K / 16;
  constexpr int WHV = H * H / 2;  // uint4 of one direction's packed wh2
  constexpr int WIV = K * H / 2;  // uint4 of one direction's packed wi2
  constexpr int CH = K / 8;       // 16-byte chunks of a staged input row
  extern __shared__ __align__(16) unsigned char smem_l2[];
  uint4* wh_s = reinterpret_cast<uint4*>(smem_l2);
  bf16* h_s = reinterpret_cast<bf16*>(wh_s + WHV);
  bf16* in_s = h_s + BM * HP;  // [BM][K], chunk c of row r at c ^ (r & 7)

  const int d = blockIdx.y, row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;

  for (int i = threadIdx.x; i < WHV; i += NT) wh_s[i] = whpk[(size_t)d * WHV + i];
  for (int i = threadIdx.x; i < BM * HP / 2; i += NT) reinterpret_cast<uint32_t*>(h_s)[i] = 0u;

  // the step's input, [h1seq(tt)] of both layer-1 directions, by cp.async
  auto stage = [&](int t) {
    const int tt = d ? nT - 1 - t : t;
    for (int i = threadIdx.x; i < BM * CH; i += NT) {
      const int r = i / CH, cc = i % CH;
      const bool ok = row0 + r < B;
      const bf16* src = ok ? h1seq + ((size_t)(row0 + r) * nT + tt) * K + cc * 8 : h1seq;
      cp_async16(smem_addr(in_s + r * K + ((cc ^ (r & 7)) * 8)), src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // this warp's wi2[d] fragments: k16 step kk, gate at (kk * NW * 4 + gate) * 32
  const uint4* __restrict__ wi = wipk + (size_t)d * WIV + warp * 4 * 32 + lane;

  float c[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int sn = 0; sn < 2; ++sn)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][sn][e] = 0.f;

  stage(0);
  uint4 b[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) b[gate] = __ldg(wi + gate * 32);
  for (int t = 0; t < nT; ++t) {
    const int tt = d ? nT - 1 - t : t;
    float acc[2][4][2][4];
    init_acc<H>(acc, b2, d, warp, lane);
    cp_async_wait<0>();
    __syncthreads();  // h(t - 1) and the input of step t in place
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // one k16 step ahead; after the last, step 0 of the next time step
      const int kn = kk + 1 < KS ? kk + 1 : 0;
      uint4 nb[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) nb[gate] = __ldg(wi + (kn * NW * 4 + gate) * 32);
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // rows mt*16 + g and + 8 both have (r & 7) == g
        const bf16* p = in_s + (mt * 16 + g) * K + 2 * q;
        const int lo = ((2 * kk) ^ g) * 8, hi = ((2 * kk + 1) ^ g) * 8;
        a[mt][0] = ld_u32(p + lo);
        a[mt][1] = ld_u32(p + 8 * K + lo);
        a[mt][2] = ld_u32(p + hi);
        a[mt][3] = ld_u32(p + 8 * K + hi);
      }
      mma_gates(acc, a, b);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) b[gate] = nb[gate];
    }
    h_products<H>(acc, h_s, wh_s, warp, lane);
    bf162 h_new[2][2][2];
    cell_update<false>(acc, c, h_new);
    __syncthreads();  // every warp has read h(t - 1) and the input of step t
    if (t + 1 < nT) stage(t + 1);
    store_h<H>(h_new, h_s, h2seq, row0, B, nT, tt, d, warp, lane);
  }
}

// ---- L3 -------------------------------------------------------------------

__global__ void __launch_bounds__(HEAD_NT)
pileup_head_kernel(const bf16* __restrict__ h2seq, const uint4* __restrict__ wdpk,
                   const bf16* __restrict__ bd, const bf16* __restrict__ w5,
                   const bf16* __restrict__ b5, const bf16* __restrict__ wo,
                   const bf16* __restrict__ bo, void* out, int B, int nT, int L5, int NH,
                   Offsets hoff) {
  constexpr int KP = KC + 8;     // padded staged row
  constexpr int KSC = KC / 16;   // k16 steps per time step
  constexpr int CHB = KC / 8;    // 16-byte chunks per staged row
  extern __shared__ __align__(16) unsigned char smem_l3[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_l3);  // [2][BM][KP]

  const int row0 = blockIdx.x * BM, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const size_t K = (size_t)nT * KC;
  const int nks = nT * KSC;

  auto stage = [&](int ch) {  // columns [ch KC, (ch + 1) KC) of the block's rows
    bf16* dst = a_s + (ch & 1) * BM * KP;
    for (int i = tid; i < BM * CHB; i += HEAD_NT) {
      const int r = i / CHB, cc = i % CHB;
      const bool ok = row0 + r < B;
      const bf16* src = ok ? h2seq + (size_t)(row0 + r) * K + (size_t)ch * KC + cc * 8 : h2seq;
      cp_async16(smem_addr(dst + r * KP + cc * 8), src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // this warp's wd fragments: k16 step ks at ks * 8 * 32, loaded PF steps
  // ahead (a ring of registers: a load from L2 takes ~600 cycles, a k16
  // step's four mma far fewer)
  const uint4* __restrict__ wd = wdpk + warp * 32 + lane;
  constexpr int PF = 10;
  static_assert(KSC % PF == 0, "the ring turns once per PF k16 steps");

  float acc[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int sn = 0; sn < 2; ++sn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][sn][e] = 0.f;

  stage(0);
  uint4 ring[PF];
#pragma unroll
  for (int j = 0; j < PF; ++j) ring[j] = __ldg(wd + (size_t)(j < nks ? j : 0) * 8 * 32);
  for (int ch = 0; ch < nT; ++ch) {
    if (ch + 1 < nT) {
      stage(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch in place
    const bf16* tile = a_s + (ch & 1) * BM * KP;
    for (int k0 = 0; k0 < KSC; k0 += PF) {
#pragma unroll
      for (int j = 0; j < PF; ++j) {
        const int kk = k0 + j, ks = ch * KSC + kk;
        const uint4 b = ring[j];
        ring[j] = __ldg(wd + (size_t)(ks + PF < nks ? ks + PF : ks) * 8 * 32);
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) load_a(a[mt], tile, KP, mt * 16 + g, kk * 16 + 2 * q);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][0], a[mt], b.x, b.y);
          mma_bf16(acc[mt][1], a[mt], b.z, b.w);
        }
      }
    }
    __syncthreads();  // every warp has read chunk ch before chunk ch + 2 lands there
  }

  // trunk = SELU(acc + bd) at row mt*16 + g + 8 hf, column 16 warp + 8 sn + 2q (+1)
  float* trunk_s = reinterpret_cast<float*>(smem_l3);  // [BM][D], the stages are free
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int sn = 0; sn < 2; ++sn) {
        const int r = mt * 16 + g + 8 * hf, n = 16 * warp + 8 * sn + 2 * q;
        const float2 bv = __bfloat1622float2(*reinterpret_cast<const bf162*>(bd + n));
        const float v0 = selu_f(acc[mt][sn][2 * hf] + bv.x);
        const float v1 = selu_f(acc[mt][sn][2 * hf + 1] + bv.y);
        if (NH == 0) {
          if (row0 + r < B)
            *reinterpret_cast<bf162*>(static_cast<bf16*>(out) + (size_t)(row0 + r) * D + n) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          trunk_s[r * D + n] = round_to<bf16>(v0);
          trunk_s[r * D + n + 1] = round_to<bf16>(v1);
        }
      }
  if (NH == 0) return;
  float* h5_s = trunk_s + BM * D;  // [BM][L5]
  float* lg_s = h5_s + BM * L5;    // [BM][O], logits after SELU
  pileup_heads<bf16, BM, HEAD_NT>(trunk_s, h5_s, lg_s, w5, b5, wo, bo, D, L5, NH, hoff.v,
                                  static_cast<float*>(out), row0, B);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

int launch_l1(const void* x, const void* wipk, const void* whpk, const void* b1, void* h1seq,
              int B, int T, int C, cudaStream_t stream) {
  const size_t bytes = (size_t)8 * H1 * H1 + (size_t)8 * KX * H1 + (size_t)BM * (H1 + 8) * 2 +
                       (size_t)BM * (KX + 8) * 2;
  const int e = set_smem(pileup_l1_tc_kernel, bytes);
  if (e) return e;
  pileup_l1_tc_kernel<<<dim3((B + BM - 1) / BM, 2), 32 * (H1 / 16), bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint4*>(wipk),
      static_cast<const uint4*>(whpk), static_cast<const bf16*>(b1), static_cast<bf16*>(h1seq),
      B, T, C);
  return (int)cudaGetLastError();
}

int launch_l2(const void* h1seq, const void* wipk, const void* whpk, const void* b2,
              void* h2seq, int B, int T, cudaStream_t stream) {
  const size_t bytes = (size_t)8 * H2 * H2 + (size_t)BM * (H2 + 8) * 2 + (size_t)BM * 2 * H1 * 2;
  const int e = set_smem(pileup_l2_tc_kernel, bytes);
  if (e) return e;
  pileup_l2_tc_kernel<<<dim3((B + BM - 1) / BM, 2), 32 * (H2 / 16), bytes, stream>>>(
      static_cast<const bf16*>(h1seq), static_cast<const uint4*>(wipk),
      static_cast<const uint4*>(whpk), static_cast<const bf16*>(b2), static_cast<bf16*>(h2seq),
      B, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// L1: x [B, T, C] bf16 (C <= 32), wipk / whpk the packed wi1 (zero-padded
// to 32 rows) and wh1 of H1 = 128, b1 [2, 4 H1] -> h1seq [B, T, 2 H1] bf16.
// Returns cudaGetLastError() after the launch (0 on success).
int clair3t_pileup_l1_tc(int device, const void* x, const void* wipk, const void* whpk,
                         const void* b1, void* h1seq, int B, int T, int C, int H, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || T <= 0 || C <= 0 || C > KX || H != H1) return (int)cudaErrorInvalidValue;
  return launch_l1(x, wipk, whpk, b1, h1seq, B, T, C, static_cast<cudaStream_t>(stream));
}

// L2: h1seq [B, T, 2 H1] bf16, the packed wi2 [2, 2 H1, 4 H2] and wh2 of
// H2 = 160, b2 [2, 4 H2] -> h2seq [B, T, 2 H2] bf16.
int clair3t_pileup_l2_tc(int device, const void* h1seq, const void* wipk, const void* whpk,
                         const void* b2, void* h2seq, int B, int T, int Hin, int H,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || T <= 0 || Hin != H1 || H != H2) return (int)cudaErrorInvalidValue;
  return launch_l2(h1seq, wipk, whpk, b2, h2seq, B, T, static_cast<cudaStream_t>(stream));
}

// L3: h2seq [B, T, 2 H2] bf16, wdpk the packed dense [T 2 H2, D = 128], bd
// [D]; heads as in clair3t_pileup_full (w5 [NH, D, L5], b5 [NH, L5], wo
// [L5, O], bo [O], bf16).  n_heads == 0 writes the trunk [B, D] bf16 to
// `out`, otherwise probabilities [B, hoff[n_heads]] float32.
int clair3t_pileup_head(int device, const void* h2seq, const void* wdpk, const void* bd,
                        const void* w5, const void* b5, const void* wo, const void* bo, void* out,
                        int B, int T, int H, int Dn, int L5, int n_heads, int hoff0, int hoff1,
                        int hoff2, int hoff3, int hoff4, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || T <= 0 || H != H2 || Dn != D || n_heads < 0 || n_heads > MAX_HEADS ||
      (n_heads && L5 <= 0))
    return (int)cudaErrorInvalidValue;
  const Offsets hoff = {{hoff0, hoff1, hoff2, hoff3, hoff4}};
  const size_t stages = (size_t)2 * BM * (KC + 8) * 2;
  const size_t heads = n_heads ? (size_t)BM * (D + L5 + hoff.v[n_heads]) * 4 : 0;
  const size_t bytes = stages > heads ? stages : heads;
  const int err = set_smem(pileup_head_kernel, bytes);
  if (err) return err;
  pileup_head_kernel<<<(B + BM - 1) / BM, HEAD_NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h2seq), static_cast<const uint4*>(wdpk),
      static_cast<const bf16*>(bd), static_cast<const bf16*>(w5), static_cast<const bf16*>(b5),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo), out, B, T, L5, n_heads, hoff);
  return (int)cudaGetLastError();
}

}  // extern "C"
