// Top-1 expert FFN over per-expert token tiles ("run-length" layout):
// K1 (float weights), K4 (int8 weights) and K5 (packed int4 weights),
// each of the quantized formats weight-only or with per-token int8
// activations (a8: w8a8, w4a8).
//
// Replaces m3asr_tpu/ops/pallas_moe_runs.py::moe_experts_pallas_runs /
// _runs_kernel, fmts "f", "q8" and "q4". The wrapper
// (m3asr_tpu_torch/ops/moe_runs.py) sorts tokens by expert on the
// device and pads each expert's group to a multiple of TM rows, so every
// tile of TM rows belongs to one expert (tile_e[t]). For the tiles of
// each expert that has tokens:
//
//     hidden = silu(x_tile @ w1[e] + b1[e])      launch GEMM1 (SILU)
//     y_tile = hidden @ w2[e] + b2[e]            launch GEMM2
//
// with the quantized formats' scales applied to the partial sum of each
// scale group (the rounding contract of moe_common.cuh). The a8 modes add two
// launches of quant_rows: x is quantized per row once before GEMM1, and
// the hidden, kept in float32 between the launches as the TPU kernel keeps
// it (pallas_moe_runs.py:304-318), is quantized per full row before GEMM2.
//
// What bounds it on an H100: the bytes of the ACTIVE experts' weights
// (d=512, h=1024: 4 MiB per expert in fp32, 2 MiB in bf16, 1 MiB int8,
// 0.5 MiB int4, plus scales). At the serving token counts the FLOPs are
// small next to that. Each active expert's weights are read once per tile
// of that expert (one block per tile x column block; a heavy expert's
// tiles read the same slices at about the same time, from L2) and an idle
// expert's never: no tile maps to it. The grid is the static worst case
// of tiles; blocks past the last real tile (starts[E]) exit before
// touching memory, so the host never learns the routing.
//
// K1 (expert_tile_gemm) is built to stream those bytes. 20-60 tiles are
// real at the serving token counts, so a launch has a few hundred live
// blocks, each with little work: what counts is keeping enough loads in
// flight per block, and no block waiting on its own loads. Blocks are
// 32 rows x F_BN = 64 columns; d and h must be multiples of 64
// (moe_runs_f_col_block()). 128-column blocks were within a few percent
// either way at 63-1020 tokens (PERF.md, section 6), so K1 has one.
// - bf16 runs on the tensor cores: mma.sync m16n8k16 with float32 sums,
//   A fragments by ldmatrix from the staged activation slice, B fragments
//   by ldmatrix.trans from the staged row-major (BK, F_BN) weight slice. 4
//   warps; warp w owns all 32 rows x columns [16 w, 16 w + 16). BK = 64;
//   a 4-stage cp.async ring (16-byte copies) keeps three slices in flight
//   while one is multiplied. Shared rows are padded by 16 bytes, so the
//   8 rows of each ldmatrix phase fall in 8 different bank groups.
// - float32 runs on FMAs (no TF32: the port's precision decision). A
//   thread owns 4 rows x 4 columns, twice the outputs of the 2 x 4 tiles
//   of moe_common.cuh:
//   per 4 k, four float4 loads of activations (one per row) and four of
//   weights feed 64 FMAs. Each output keeps one accumulator, summed in
//   ascending k, as K8 sums (chip_smoke.py holds their outputs equal bit
//   for bit). BK = 32, a 3-stage cp.async ring; 128 threads. A warp
//   whose rows all lie past the tile's tokens (the run's padding; counts)
//   skips its FMAs: nothing reads those rows.
//   4 x 8 patches (half the threads) were slower at 63 and 511 tokens,
//   and a 4-stage ring no better overall (PERF.md, section 6).
// - TM stays 32 rows (the layout is K4/K5's too); two launches a call.
//
// K4/K5 (runs_gemm weight-only, runs_gemm_s8 a8) read a half to a
// quarter of K1 bf16's weight bytes and run on the tensor cores too, with
// K1's block shape (32 rows x 64 columns, 4 warps of 32 rows x 16
// columns), a cp.async ring of 64-deep slices and 16-byte row padding.
// The ring has 3 stages weight-only, 4 a8: 3 beat 4 by 3-10% weight-only
// and by at most 4% a8, 6 and 8 stages lost, and the 3-stage int8 a8
// build spilled (PERF.md, section 6). The weight slice is
// copied raw (64 int8 or 32 packed bytes a row); each lane builds its own
// B fragments from it in registers:
// - weight-only: bf16 mma.sync m16n8k16 into float32, as the TPU kernel
//   multiplies bf16 on its MXU; int8 and int4 values are exact in bf16
//   (q_widen builds them from magic-number float or bf16 bits, without
//   int-to-float conversions). Each group's float32 sums are folded at
//   its end, which may fall inside a slice (32-row groups), in
//   ascending g.
// - a8: s8 mma.sync m16n8k32 into s32 on quant_rows' int8 rows; each
//   lane gathers its column's four k-neighbours with byte permutes
//   (q_gather); an int4 nibble goes in as 16 q, and the exact sum is
//   shifted back. The epilogue is tile_gemm_s8's, so w4a8 equals K6.
// - int4: a block's 32 packed bytes a row hold its 64 columns (32 low
//   nibbles, 32 high ones, N/2 apart), so every byte is read by one block.
//
// Stacked weights: w1/w2 are the (L*E, K, .) base pointers and `layer`
// selects rows layer*E .. layer*E + E - 1, so no per-layer copy exists.
// Biases (E, N) and scales (E, G, N) are this layer's.
//
// Types: K1 takes fp32 or bf16 and computes at the weight type; K4/K5 take
// bf16 activations (the quantized engines' type). The hidden scratch is in
// the compute type (weight-only) or float32 (a8); the output is in the
// activation type. Rounding contract of K1: float32 sums, the bias added
// in float32 before v / (1 + expf(-v)), the hidden rounded to the compute
// type between the launches, the output in the compute type.

#include <type_traits>

#include "mma_common.cuh"
#include "moe_common.cuh"

using namespace moe;

namespace {

using bf16 = __nv_bfloat16;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;

// ---------------------------------------------------------------------------
// K1: out[t*TM + r, n] = act(sum_k a[t*TM + r, k] * w[layer*E + e, k, n]
//                            + bias[e, n]),  e = tile_e[t]
// ---------------------------------------------------------------------------

constexpr int F_BN = 64;  // column block; d and h must be multiples

// Shared layout of one pipeline stage: a TM x BK activation slice (row
// stride XLD) and a BK x F_BN weight slice (row stride WLD), elements of
// T.
template <typename T>
struct FTile;
template <>
struct FTile<bf16> {  // tensor cores
  static constexpr int BK = 64, STAGES = 4, THREADS = 128;
  static constexpr int XLD = BK + 8, WLD = F_BN + 8;
};
template <>
struct FTile<float> {  // FMAs: 4 x 4 outputs a thread
  static constexpr int BK = 32, STAGES = 3, THREADS = TM / 4 * F_BN / 4;
  static constexpr int XLD = BK + 4, WLD = F_BN;
};
template <typename T>
struct FLayout : FTile<T> {
  using C = FTile<T>;
  static constexpr int X = TM * C::XLD, STAGE = X + C::BK * C::WLD;
  static constexpr int bytes = C::STAGES * STAGE * (int)sizeof(T);
  static_assert(F_BN % C::BK == 0, "K steps must divide 64");
  static_assert(STAGE * sizeof(T) % 16 == 0 && X * sizeof(T) % 16 == 0,
                "16-byte aligned stages");
};

// One stage: the activation slice [k0, k0 + BK) of the tile's TM rows and
// the weight slice of rows [k0, k0 + BK), columns [n0, n0 + F_BN) (we
// points at column n0), by 16-byte cp.async; neighbouring threads copy
// neighbouring chunks of a row.
template <typename T>
__device__ __forceinline__ void f_stage(T* xs, const T* __restrict__ at,
                                        const T* __restrict__ we, int K,
                                        int N, int k0) {
  using C = FLayout<T>;
  constexpr int V = 16 / (int)sizeof(T);  // elements per chunk
  constexpr int XC = C::BK / V, WC = F_BN / V;
  static_assert(TM * XC % C::THREADS == 0 && C::BK * WC % C::THREADS == 0,
                "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < TM * XC / C::THREADS; ++j) {
    const int i = threadIdx.x + j * C::THREADS, r = i / XC, c = i % XC;
    cp_async16(xs + r * C::XLD + c * V, at + (size_t)r * K + k0 + c * V,
               true);
  }
  T* ws = xs + C::X;
#pragma unroll
  for (int j = 0; j < C::BK * WC / C::THREADS; ++j) {
    const int i = threadIdx.x + j * C::THREADS, r = i / WC, c = i % WC;
    cp_async16(ws + r * C::WLD + c * V, we + (size_t)(k0 + r) * N + c * V,
               true);
  }
}

// bias (when there is one) in float32, then the SiLU of GEMM1
template <bool SILU>
__device__ __forceinline__ float f_epilogue(float v, bool has_bias, float b) {
  if (has_bias) v += b;
  return SILU ? v / (1.0f + expf(-v)) : v;
}

// bf16: warp w's 32 rows x F_BN/4 columns as 2 x NT m16n8 tiles
template <bool SILU>
__device__ __forceinline__ void tile_mma(const bf16* __restrict__ at,
                                         const bf16* __restrict__ we,
                                         const bf16* __restrict__ bias,
                                         int K, int N, int n0, bf16* sm,
                                         bf16* __restrict__ out) {
  using C = FLayout<bf16>;
  constexpr int WN = F_BN / 4, NT = WN / 8;
  static_assert(NT % 2 == 0, "B fragments load in pairs");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this lane's ldmatrix row and column offset (mma_common.cuh)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  float acc[2][NT][4] = {};
  const int steps = K / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) f_stage<bf16>(sm + s * C::STAGE, at, we, K, N, s * C::BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slice ks is in for all; slice ks - 1 is done with
    const int next = ks + C::STAGES - 1;
    if (next < steps)
      f_stage<bf16>(sm + (next % C::STAGES) * C::STAGE, at, we, K, N,
                    next * C::BK);
    cp_async_commit();
    const bf16* xs = sm + (ks % C::STAGES) * C::STAGE;
    const bf16* ws = xs + C::X + warp * WN;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      uint32_t a0[4], a1[4];
      mma::ldsm_x4(a0, xs + lr * C::XLD + kk + lc);
      mma::ldsm_x4(a1, xs + (16 + lr) * C::XLD + kk + lc);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        mma::ldsm_x4_t(b, ws + (kk + lr) * C::WLD + 8 * n + lc);
        mma::mma_bf16(acc[0][n], a0, b[0], b[1]);
        mma::mma_bf16(acc[0][n + 1], a0, b[2], b[3]);
        mma::mma_bf16(acc[1][n], a1, b[0], b[1]);
        mma::mma_bf16(acc[1][n + 1], a1, b[2], b[3]);
      }
    }
  }
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + warp * WN + 8 * n + 2 * tq;
    const bool hb = bias != nullptr;
    const float b0 = hb ? to_f(bias[col]) : 0.f;
    const float b1 = hb ? to_f(bias[col + 1]) : 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = f_epilogue<SILU>(acc[m][n][2 * h], hb, b0);
        const float v1 = f_epilogue<SILU>(acc[m][n][2 * h + 1], hb, b1);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)(16 * m + 8 * h + g) * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

// float32: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns
// 4 tx .. 4 tx + 3 (8 neighbouring threads read 128 contiguous bytes of a
// weight row); `live` rows hold tokens
template <bool SILU>
__device__ __forceinline__ void tile_fma(const float* __restrict__ at,
                                         const float* __restrict__ we,
                                         const float* __restrict__ bias,
                                         int K, int N, int n0, int live,
                                         float* sm, float* __restrict__ out) {
  using C = FLayout<float>;
  constexpr int CG = F_BN / 4;  // column groups
  const int tid = threadIdx.x, tx = tid % CG, ty = tid / CG;
  // the warp's first row; a warp past the tokens skips its FMAs
  const bool work = 4 * ((tid & ~31) / CG) < live;
  float acc[4][4] = {};
  const int steps = K / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) f_stage<float>(sm + s * C::STAGE, at, we, K, N, s * C::BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slice ks is in for all; slice ks - 1 is done with
    const int next = ks + C::STAGES - 1;
    if (next < steps)
      f_stage<float>(sm + (next % C::STAGES) * C::STAGE, at, we, K, N,
                     next * C::BK);
    cp_async_commit();
    if (!work) continue;
    const float* xs = sm + (ks % C::STAGES) * C::STAGE + 4 * ty * C::XLD;
    const float* ws = sm + (ks % C::STAGES) * C::STAGE + C::X + 4 * tx;
#pragma unroll
    for (int k = 0; k < C::BK; k += 4) {
      float xr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(xs + i * C::XLD + k);
        xr[i][0] = v.x;
        xr[i][1] = v.y;
        xr[i][2] = v.z;
        xr[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v =
            *reinterpret_cast<const float4*>(ws + (k + kk) * C::WLD);
        const float wr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xr[i][kk], wr[j], acc[i][j]);
      }
    }
  }
  const int col = n0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = f_epilogue<SILU>(acc[i][j], bias != nullptr,
                              bias != nullptr ? bias[col + j] : 0.f);
    *reinterpret_cast<float4*>(out + (size_t)(4 * ty + i) * N + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(FTile<T>::THREADS)
    expert_tile_gemm(const T* __restrict__ a, const T* __restrict__ w,
                     const T* __restrict__ bias,
                     const int32_t* __restrict__ tile_e,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ counts, int n_experts,
                     int layer, int K, int N, T* __restrict__ out) {
  const int t = blockIdx.x;
  if (t >= starts[n_experts]) return;  // past the last real tile
  const int e = tile_e[t];
  const int n0 = blockIdx.y * F_BN;
  const T* at = a + (size_t)t * TM * K;
  const T* we = w + ((size_t)layer * n_experts + e) * (size_t)K * N + n0;
  const T* be = bias == nullptr ? nullptr : bias + (size_t)e * N;
  T* ot = out + (size_t)t * TM * N;
  extern __shared__ __align__(16) unsigned char f_smem[];
  T* sm = reinterpret_cast<T*>(f_smem);
  if constexpr (std::is_same<T, bf16>::value) {
    tile_mma<SILU>(at, we, be, K, N, n0, sm, ot);
  } else {
    const int live = counts[e] - (t - starts[e]) * TM;
    tile_fma<SILU>(at, we, be, K, N, n0, live, sm, ot);
  }
}

// ---------------------------------------------------------------------------
// K4 / K5: out[t*TM + r, n] = act(sum_g (a[t*TM + r, group g] @ W[group g, n])
//                                 * scale[e, g, n] + bias[e, n]),
// W = this layer's quantized w[layer*E + e], e = tile_e[t]
// ---------------------------------------------------------------------------

constexpr int Q_BN = 64;     // output columns per block; d and h multiples
constexpr int Q_GROUP = 32;  // scale groups: multiples of 32 rows
constexpr int Q_BK = 64, Q_THREADS = 128;
constexpr int Q_STAGES_W = 3, Q_STAGES_A8 = 4;  // cp.async ring depths

// Shared layout of one pipeline stage, in bytes: the activation slice (TM
// rows of Q_BK bf16 values, or int8 with A8) and the raw weight slice
// (Q_BK rows of the block's 64 int8 or 32 packed int4 bytes), every row
// padded by 16 bytes, so the 8 rows of an ldmatrix phase, and the weight
// rows 2t of a k16 step, fall in different bank groups.
template <int F, bool A8>
struct QLayout {
  static constexpr int XLD = Q_BK * (A8 ? 1 : 2) + 16;
  static constexpr int WROW = F == W_Q8 ? Q_BN : Q_BN / 2;
  static constexpr int WLD = WROW + 16;
  static constexpr int X = TM * XLD, STAGE = X + Q_BK * WLD;
  static constexpr int STAGES = A8 ? Q_STAGES_A8 : Q_STAGES_W;
  static constexpr int bytes = STAGES * STAGE;
  static_assert(bytes <= 48 * 1024, "no dynamic shared memory opt-in");
};

// One stage: rows [k0, k0 + Q_BK) of the activation slice (a: the tile's
// first row, a_ld bytes a row) and of the weight slice (we: the block's
// first byte of weight row 0, w_ld bytes a row), by 16-byte cp.async.
template <int F, bool A8>
__device__ __forceinline__ void q_stage(unsigned char* st,
                                        const unsigned char* __restrict__ a,
                                        int a_ld,
                                        const unsigned char* __restrict__ we,
                                        int w_ld, int k0) {
  using C = QLayout<F, A8>;
  constexpr int AE = A8 ? 1 : 2;  // bytes an activation
  constexpr int XC = Q_BK * AE / 16, WC = C::WROW / 16;
  static_assert(TM * XC % Q_THREADS == 0 && Q_BK * WC % Q_THREADS == 0,
                "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < TM * XC / Q_THREADS; ++j) {
    const int i = threadIdx.x + j * Q_THREADS, r = i / XC, c = i % XC;
    cp_async16(st + r * C::XLD + c * 16,
               a + (size_t)r * a_ld + k0 * AE + c * 16, true);
  }
#pragma unroll
  for (int j = 0; j < Q_BK * WC / Q_THREADS; ++j) {
    const int i = threadIdx.x + j * Q_THREADS, r = i / WC, c = i % WC;
    cp_async16(st + C::X + r * C::WLD + c * 16,
               we + (size_t)(k0 + r) * w_ld + c * 16, true);
  }
}

// Columns. Warp w owns 16 output columns of the block as two n8 MMA tiles
// j; lane (g, t) builds column g of each tile's B fragment and holds
// columns 2t, 2t + 1 (i = 0, 1) of each tile's C fragment.
// - int8: tile j's column n is block column 16 w + 2 n + j, so lane g
//   reads the byte pair 16 w + 2 g of a weight row, and its outputs are
//   the four neighbouring columns 16 w + 4 t .. + 3.
// - int4: byte c of the block's 32 holds column j0 + c (low nibble) and
//   j0 + N/2 + c (high nibble), j0 = n0 / 2; tile 0 takes low nibbles,
//   tile 1 high, so lane g reads byte 8 w + g once for both, and every
//   packed byte is read by one block.
// q_col: the global column of C element (j, i = 0) of this lane.
template <int F>
__device__ __forceinline__ int q_col(int n0, int N, int warp, int t, int j) {
  return F == W_Q8 ? n0 + 16 * warp + 4 * t + j
                   : n0 / 2 + 8 * warp + 2 * t + j * (N / 2);
}
// the column step from C element (j, 0) to (j, 1)
template <int F>
constexpr int Q_STEP = F == W_Q8 ? 2 : 1;

// The lane's four per-column values (scales, biases) from one row p.
template <int F, typename T>
__device__ __forceinline__ void q_load(const T* __restrict__ p, int n0,
                                       int N, int warp, int t,
                                       float (&v)[2][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      v[j][i] = to_f(p[q_col<F>(n0, N, warp, t, j) + i * Q_STEP<F>]);
}

// The lane's four outputs of one row p: one 8-byte (bf16) or 16-byte
// (float) store for int8, two pairs for int4.
template <int F>
__device__ __forceinline__ void q_store(bf16* p, int n0, int N, int warp,
                                        int t, const float (&v)[2][2]) {
  if constexpr (F == W_Q8) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0][0], v[1][0]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0][1], v[1][1]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p + q_col<F>(n0, N, warp, t, 0)) = u;
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + q_col<F>(n0, N, warp, t, j)) =
          __floats2bfloat162_rn(v[j][0], v[j][1]);
  }
}
template <int F>
__device__ __forceinline__ void q_store(float* p, int n0, int N, int warp,
                                        int t, const float (&v)[2][2]) {
  if constexpr (F == W_Q8) {
    *reinterpret_cast<float4*>(p + q_col<F>(n0, N, warp, t, 0)) =
        make_float4(v[0][0], v[1][0], v[0][1], v[1][1]);
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float2*>(p + q_col<F>(n0, N, warp, t, j)) =
          make_float2(v[j][0], v[j][1]);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Weight-only B fragments of weight rows k, k + 1 (r0, r1: the lane's
// bytes in them), widened to bf16 exactly: b[j] = (W[k][col j],
// W[k + 1][col j]) as bf16x2, low half first.
// int8: 2^23 + (q + 128) built as float bits, minus 2^23 + 128.
// int4: 128 + (q + 8) built as bf16 bits (0x4300 | (nibble ^ 8)), minus
// 136 in bf16x2.
template <int F>
__device__ __forceinline__ void q_widen(const unsigned char* r0,
                                        const unsigned char* r1,
                                        uint32_t (&b)[2]) {
  if constexpr (F == W_Q8) {
    const uint32_t u =
        __byte_perm(*reinterpret_cast<const uint16_t*>(r0),
                    *reinterpret_cast<const uint16_t*>(r1), 0x5410) ^
        0x80808080u;  // (k, 2g), (k, 2g + 1), (k + 1, 2g), (k + 1, 2g + 1)
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
             8388736.f;
    b[0] = bf16x2_bits(__floats2bfloat162_rn(f[0], f[2]));
    b[1] = bf16x2_bits(__floats2bfloat162_rn(f[1], f[3]));
  } else {
    const uint32_t v = __byte_perm(*r0, *r1, 0x5410);  // bytes 0 and 2
    const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
    uint32_t lo = (v & 0x000F000Fu) ^ 0x43084308u;
    uint32_t hi = ((v >> 4) & 0x000F000Fu) ^ 0x43084308u;
    b[0] = bf16x2_bits(
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo), off));
    b[1] = bf16x2_bits(
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi), off));
  }
}

// a8 B fragments of weight rows k .. k + 3 (r: the lane's bytes in row k,
// ld: the row stride): b[j] = W[k .. k + 3][col j] as four s8, lowest k in
// the lowest byte. int4 nibbles go in as 16 q (the nibble in the high
// half of the byte), so the s32 sums are 16x the true ones, exactly.
template <int F>
__device__ __forceinline__ void q_gather(const unsigned char* r, int ld,
                                         uint32_t (&b)[2]) {
  if constexpr (F == W_Q8) {
    const uint32_t x = __byte_perm(*reinterpret_cast<const uint16_t*>(r),
                                   *reinterpret_cast<const uint16_t*>(r + ld),
                                   0x5410);
    const uint32_t y =
        __byte_perm(*reinterpret_cast<const uint16_t*>(r + 2 * ld),
                    *reinterpret_cast<const uint16_t*>(r + 3 * ld), 0x5410);
    b[0] = __byte_perm(x, y, 0x6420);
    b[1] = __byte_perm(x, y, 0x7531);
  } else {
    const uint32_t x = __byte_perm(__byte_perm(r[0], r[ld], 0x0040),
                                   __byte_perm(r[2 * ld], r[3 * ld], 0x0040),
                                   0x5410);
    b[0] = (x << 4) & 0xF0F0F0F0u;
    b[1] = x & 0xF0F0F0F0u;
  }
}

// Weight-only: the tile's 32 rows x the block's 64 columns on bf16 MMAs.
// Each k16 step's float32 sums are folded into `tot` at the end of each
// scale group, in ascending g: tot += acc * s_g (__fmul_rn, __fadd_rn).
template <int F, bool SILU>
__device__ __forceinline__ void tile_q_mma(
    const bf16* __restrict__ at, const int8_t* __restrict__ we,
    const float* __restrict__ scale, int G, const bf16* __restrict__ bias,
    int K, int N, int n0, unsigned char* sm, bf16* __restrict__ out) {
  using C = QLayout<F, false>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row and byte offset (mma_common.cuh)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 16;
  const int wcol = F == W_Q8 ? 16 * warp + 2 * g : 8 * warp + g;
  const int w_ld = F == W_Q8 ? N : N / 2;
  const auto* a = reinterpret_cast<const unsigned char*>(at);
  const auto* w = reinterpret_cast<const unsigned char*>(we);
  const int gs = K / G;
  float acc[2][2][4] = {}, tot[2][2][4] = {};
  float sc[2][2];
  q_load<F>(scale, n0, N, warp, t, sc);
  int grp = 0, fold_at = gs;
  const int steps = K / Q_BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps)
      q_stage<F, false>(sm + s * C::STAGE, a, 2 * K, w, w_ld, s * Q_BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slice ks is in for all; slice ks - 1 is done with
    const int next = ks + C::STAGES - 1;
    if (next < steps)
      q_stage<F, false>(sm + (next % C::STAGES) * C::STAGE, a, 2 * K, w,
                        w_ld, next * Q_BK);
    cp_async_commit();
    const unsigned char* xs = sm + (ks % C::STAGES) * C::STAGE;
    const unsigned char* ws = xs + C::X + wcol;
#pragma unroll
    for (int kk = 0; kk < Q_BK; kk += 16) {
      uint32_t a0[4], a1[4], b0[2], b1[2];
      mma::ldsm_x4(a0, xs + lr * C::XLD + 2 * kk + lc);
      mma::ldsm_x4(a1, xs + (16 + lr) * C::XLD + 2 * kk + lc);
      const unsigned char* wr = ws + (kk + 2 * t) * C::WLD;
      q_widen<F>(wr, wr + C::WLD, b0);               // rows 2t, 2t + 1
      q_widen<F>(wr + 8 * C::WLD, wr + 9 * C::WLD, b1);  // 2t + 8, + 9
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma::mma_bf16(acc[0][j], a0, b0[j], b1[j]);
        mma::mma_bf16(acc[1][j], a1, b0[j], b1[j]);
      }
      if (ks * Q_BK + kk + 16 == fold_at) {  // end of a scale group
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              tot[m][j][c] = __fadd_rn(tot[m][j][c],
                                       __fmul_rn(acc[m][j][c], sc[j][c & 1]));
              acc[m][j][c] = 0.f;
            }
        fold_at += gs;
        if (++grp < G)
          q_load<F>(scale + (size_t)grp * N, n0, N, warp, t, sc);
      }
    }
  }
  float bv[2][2] = {};
  if (bias != nullptr) q_load<F>(bias, n0, N, warp, t, bv);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = tot[m][j][2 * h + i];
          if (bias != nullptr) x = __fadd_rn(x, bv[j][i]);
          v[j][i] = SILU ? silu(x) : x;
        }
      q_store<F>(out + (size_t)(16 * m + 8 * h + g) * N, n0, N, warp, t, v);
    }
}

// a8: the tile's int8 rows (aq, row scales as) x the block's 64 columns on
// s8 MMAs into exact s32 sums; the epilogue in tile_gemm_s8's order
// (moe_common.cuh), so that w4a8 equals K6's bit for bit:
//   int8: (float(sum) * as[row]) * scale[0, n]
//   int4: (sum_g float(sum_g) * scale[g, n]) * as[row]
template <int F, bool SILU, typename OutT>
__device__ __forceinline__ void tile_q_s8(
    const int8_t* __restrict__ aq, const float* __restrict__ as,
    const int8_t* __restrict__ we, const float* __restrict__ scale, int G,
    const bf16* __restrict__ bias, int K, int N, int n0, unsigned char* sm,
    OutT* __restrict__ out) {
  using C = QLayout<F, true>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 16;
  const int wcol = F == W_Q8 ? 16 * warp + 2 * g : 8 * warp + g;
  const int w_ld = F == W_Q8 ? N : N / 2;
  const auto* a = reinterpret_cast<const unsigned char*>(aq);
  const auto* w = reinterpret_cast<const unsigned char*>(we);
  const int gs = K / G;
  int acc[2][2][4] = {};
  float tot[2][2][4] = {};
  float sc[2][2];
  q_load<F>(scale, n0, N, warp, t, sc);
  int grp = 0, fold_at = gs;
  const int steps = K / Q_BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps)
      q_stage<F, true>(sm + s * C::STAGE, a, K, w, w_ld, s * Q_BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int next = ks + C::STAGES - 1;
    if (next < steps)
      q_stage<F, true>(sm + (next % C::STAGES) * C::STAGE, a, K, w, w_ld,
                       next * Q_BK);
    cp_async_commit();
    const unsigned char* xs = sm + (ks % C::STAGES) * C::STAGE;
    const unsigned char* ws = xs + C::X + wcol;
#pragma unroll
    for (int kk = 0; kk < Q_BK; kk += 32) {
      uint32_t a0[4], a1[4], b0[2], b1[2];
      mma::ldsm_x4(a0, xs + lr * C::XLD + kk + lc);
      mma::ldsm_x4(a1, xs + (16 + lr) * C::XLD + kk + lc);
      const unsigned char* wr = ws + (kk + 4 * t) * C::WLD;
      q_gather<F>(wr, C::WLD, b0);                 // rows 4t .. 4t + 3
      q_gather<F>(wr + 16 * C::WLD, C::WLD, b1);   // rows 16 + 4t ..
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma::mma_s8(acc[0][j], a0, b0[j], b1[j]);
        mma::mma_s8(acc[1][j], a1, b0[j], b1[j]);
      }
      if (F == W_Q4 && ks * Q_BK + kk + 32 == fold_at) {  // int4 group end
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              // the sums of 16 q are multiples of 16: >> 4 is exact
              tot[m][j][c] =
                  __fadd_rn(tot[m][j][c], __fmul_rn((float)(acc[m][j][c] >> 4),
                                                    sc[j][c & 1]));
              acc[m][j][c] = 0;
            }
        fold_at += gs;
        if (++grp < G)
          q_load<F>(scale + (size_t)grp * N, n0, N, warp, t, sc);
      }
    }
  }
  float bv[2][2] = {};
  if (bias != nullptr) q_load<F>(bias, n0, N, warp, t, bv);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + 8 * h + g;
      const float ar = as[r];
      float v[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = F == W_Q8
                        ? __fmul_rn(__fmul_rn((float)acc[m][j][2 * h + i], ar),
                                    sc[j][i])
                        : __fmul_rn(tot[m][j][2 * h + i], ar);
          if (bias != nullptr) x = __fadd_rn(x, bv[j][i]);
          v[j][i] = SILU ? silu(x) : x;
        }
      q_store<F>(out + (size_t)r * N, n0, N, warp, t, v);
    }
}

// The block's expert weights: expert row layer*E + e, from the block's
// first column (int8) or packed byte (int4)
template <int F>
__device__ __forceinline__ const int8_t* q_weights(const int8_t* w, int er,
                                                   int K, int N, int n0) {
  return expert_w<F>(w, er, K, N) + (F == W_Q8 ? n0 : n0 / 2);
}

// K4 / K5 weight-only: one tile of the expert that owns tile t
template <int F, bool SILU>
__global__ void __launch_bounds__(Q_THREADS)
    runs_gemm(const bf16* __restrict__ a, const int8_t* __restrict__ w,
              const float* __restrict__ scale, int G,
              const bf16* __restrict__ bias,
              const int32_t* __restrict__ tile_e,
              const int32_t* __restrict__ starts, int n_experts, int layer,
              int K, int N, bf16* __restrict__ out) {
  const int t = blockIdx.x;
  if (t >= starts[n_experts]) return;  // past the last real tile
  const int e = tile_e[t];
  const int n0 = blockIdx.y * Q_BN;
  extern __shared__ __align__(16) unsigned char q_smem[];
  tile_q_mma<F, SILU>(a + (size_t)t * TM * K,
                      q_weights<F>(w, layer * n_experts + e, K, N, n0),
                      scale + (size_t)e * G * N, G,
                      bias == nullptr ? nullptr : bias + (size_t)e * N, K, N,
                      n0, q_smem, out + (size_t)t * TM * N);
}

// K4 / K5 a8: the same on int8 rows with row scales
template <int F, bool SILU, typename OutT>
__global__ void __launch_bounds__(Q_THREADS)
    runs_gemm_s8(const int8_t* __restrict__ aq, const float* __restrict__ as,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scale, int G,
                 const bf16* __restrict__ bias,
                 const int32_t* __restrict__ tile_e,
                 const int32_t* __restrict__ starts, int n_experts,
                 int layer, int K, int N, OutT* __restrict__ out) {
  const int t = blockIdx.x;
  if (t >= starts[n_experts]) return;
  const int e = tile_e[t];
  const int n0 = blockIdx.y * Q_BN;
  extern __shared__ __align__(16) unsigned char q_smem[];
  tile_q_s8<F, SILU, OutT>(aq + (size_t)t * TM * K, as + (size_t)t * TM,
                           q_weights<F>(w, layer * n_experts + e, K, N, n0),
                           scale + (size_t)e * G * N, G,
                           bias == nullptr ? nullptr : bias + (size_t)e * N,
                           K, N, n0, q_smem, out + (size_t)t * TM * N);
}

#define RETURN_IF_ERROR()                       \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)

// One K1 GEMM. The dynamic shared memory limit is raised once per
// instantiation, before its first launch.
template <typename T, bool SILU>
int launch_gemm_f(const T* a, const T* w, const T* bias,
                  const int32_t* tile_e, const int32_t* starts,
                  const int32_t* counts, int n_tiles, int n_experts,
                  int layer, int K, int N, T* out, cudaStream_t stream) {
  using C = FLayout<T>;
  static const int attr = (int)cudaFuncSetAttribute(
      expert_tile_gemm<T, SILU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::bytes);
  if (attr != 0) return attr;
  expert_tile_gemm<T, SILU>
      <<<dim3(n_tiles, N / F_BN), C::THREADS, C::bytes, stream>>>(
          a, w, bias, tile_e, starts, counts, n_experts, layer, K, N, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_f(const void* x_pad, const void* w1, const void* b1,
             const void* w2, const void* b2, const int32_t* tile_e,
             const int32_t* starts, const int32_t* counts, int n_tiles,
             int n_experts, int layer, int d, int h, void* hidden,
             void* y_pad, cudaStream_t stream) {
  if (d % F_BN != 0 || h % F_BN != 0) return (int)cudaErrorInvalidValue;
  const int err = launch_gemm_f<T, true>(
      static_cast<const T*>(x_pad), static_cast<const T*>(w1),
      static_cast<const T*>(b1), tile_e, starts, counts, n_tiles, n_experts,
      layer, d, h, static_cast<T*>(hidden), stream);
  if (err != 0) return err;
  return launch_gemm_f<T, false>(
      static_cast<const T*>(hidden), static_cast<const T*>(w2),
      static_cast<const T*>(b2), tile_e, starts, counts, n_tiles, n_experts,
      layer, h, d, static_cast<T*>(y_pad), stream);
}

template <int F>
int launch_q(int a8, const void* x_pad, const void* w1, const float* s1,
             int g1, const void* b1, const void* w2, const float* s2, int g2,
             const void* b2, const int32_t* tile_e, const int32_t* starts,
             int n_tiles, int n_experts, int layer, int d, int h,
             void* hidden, int8_t* xq, float* xs, int8_t* hq, float* hs,
             void* y_pad, cudaStream_t stream) {
  if (d % Q_BN != 0 || h % Q_BN != 0) return (int)cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(x_pad);
  const int8_t* q1 = static_cast<const int8_t*>(w1);
  const int8_t* q2 = static_cast<const int8_t*>(w2);
  const bf16* bias1 = static_cast<const bf16*>(b1);
  const bf16* bias2 = static_cast<const bf16*>(b2);
  const dim3 grid1(n_tiles, h / Q_BN), grid2(n_tiles, d / Q_BN);
  if (!a8) {
    constexpr int smem = QLayout<F, false>::bytes;
    runs_gemm<F, true><<<grid1, Q_THREADS, smem, stream>>>(
        x, q1, s1, g1, bias1, tile_e, starts, n_experts, layer, d, h,
        static_cast<bf16*>(hidden));
    RETURN_IF_ERROR();
    runs_gemm<F, false><<<grid2, Q_THREADS, smem, stream>>>(
        static_cast<const bf16*>(hidden), q2, s2, g2, bias2, tile_e, starts,
        n_experts, layer, h, d, static_cast<bf16*>(y_pad));
    return (int)cudaGetLastError();
  }
  constexpr int smem = QLayout<F, true>::bytes;
  const int rows = n_tiles * TM;
  quant_rows<bf16><<<rows, QTHREADS, 0, stream>>>(x, d, starts, nullptr,
                                                  n_experts, TM, xq, xs);
  RETURN_IF_ERROR();
  runs_gemm_s8<F, true, float><<<grid1, Q_THREADS, smem, stream>>>(
      xq, xs, q1, s1, g1, bias1, tile_e, starts, n_experts, layer, d, h,
      static_cast<float*>(hidden));
  RETURN_IF_ERROR();
  quant_rows<float><<<rows, QTHREADS, 0, stream>>>(
      static_cast<const float*>(hidden), h, starts, nullptr, n_experts, TM,
      hq, hs);
  RETURN_IF_ERROR();
  runs_gemm_s8<F, false, bf16><<<grid2, Q_THREADS, smem, stream>>>(
      hq, hs, q2, s2, g2, bias2, tile_e, starts, n_experts, layer, h, d,
      static_cast<bf16*>(y_pad));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile rows, column blocks and scale-group step the wrapper must honour.
int moe_runs_tile_rows() { return TM; }
int moe_runs_col_block() { return Q_BN; }   // K4, K5: d, h multiples
int moe_runs_k_step() { return Q_GROUP; }   // K4, K5: group multiples
int moe_runs_f_col_block() { return F_BN; }  // K1: d, h multiples

// K1. dtype: 0 = float32, 1 = bfloat16. counts: (E,) tokens per expert
// (float32 skips the padding rows' FMAs). Returns cudaGetLastError() of
// the two launches (0 on success), or cudaErrorInvalidValue for widths K1
// does not take. All pointers are device pointers.
int moe_runs_f(int dtype, const void* x_pad, const void* w1, const void* b1,
               const void* w2, const void* b2, const int32_t* tile_e,
               const int32_t* starts, const int32_t* counts, int n_tiles,
               int n_experts, int layer, int d, int h, void* hidden,
               void* y_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f<float>(x_pad, w1, b1, w2, b2, tile_e, starts, counts,
                           n_tiles, n_experts, layer, d, h, hidden, y_pad, s);
  if (dtype == 1)
    return launch_f<bf16>(x_pad, w1, b1, w2, b2, tile_e, starts, counts,
                          n_tiles, n_experts, layer, d, h, hidden, y_pad, s);
  return (int)cudaErrorInvalidValue;
}

// K4 (fmt 1: int8 (L*E|E, d, h)/(., h, d)) and K5 (fmt 2: packed int4
// (., d, h/2)/(., h, d/2)), bf16 activations. s1 (E, g1, h), s2 (E, g2,
// d) float32; int8 takes g1 = g2 = 1, int4 groups of a multiple of
// moe_runs_k_step() rows. d and h are multiples of moe_runs_col_block();
// w1, w2, x_pad and the scratch start on 16-byte boundaries. a8 != 0
// quantizes the activations per row into xq/xs (x_pad's rows x d) and
// hq/hs (rows x h); hidden is then float32, else bf16. Returns
// cudaGetLastError() of the launches, or cudaErrorInvalidValue for widths
// K4/K5 do not take.
int moe_runs_q(int fmt, int a8, const void* x_pad, const void* w1,
               const float* s1, int g1, const void* b1, const void* w2,
               const float* s2, int g2, const void* b2,
               const int32_t* tile_e, const int32_t* starts, int n_tiles,
               int n_experts, int layer, int d, int h, void* hidden,
               int8_t* xq, float* xs, int8_t* hq, float* hs, void* y_pad,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == W_Q8)
    return launch_q<W_Q8>(a8, x_pad, w1, s1, g1, b1, w2, s2, g2, b2, tile_e,
                          starts, n_tiles, n_experts, layer, d, h, hidden,
                          xq, xs, hq, hs, y_pad, s);
  if (fmt == W_Q4)
    return launch_q<W_Q4>(a8, x_pad, w1, s1, g1, b1, w2, s2, g2, b2, tile_e,
                          starts, n_tiles, n_experts, layer, d, h, hidden,
                          xq, xs, hq, hs, y_pad, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
