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
// scale group (moe_common.cuh's tile routines). The a8 modes add two
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
//   thread owns 4 rows x 4 columns, twice the outputs of K4/K5's 2 x 4:
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
//
// K4/K5 are simple on purpose: no tensor cores or pipelining yet.

#include <type_traits>

#include "mma_common.cuh"
#include "moe_common.cuh"

using namespace moe;

namespace {

using bf16 = __nv_bfloat16;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;

static_assert(TM * BK / 4 == THREADS, "tile_gemm_s8 loads one word each");

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

// K4 / K5 weight-only: one tile of the expert that owns tile t
template <typename T, int F, bool SILU, typename OutT>
__global__ void __launch_bounds__(THREADS)
    runs_gemm(const T* __restrict__ a, const int8_t* __restrict__ w,
              const float* __restrict__ scale, int G,
              const T* __restrict__ bias, const int32_t* __restrict__ tile_e,
              const int32_t* __restrict__ starts, int n_experts, int layer,
              int K, int N, OutT* __restrict__ out) {
  const int t = blockIdx.x;
  if (t >= starts[n_experts]) return;  // past the last real tile
  const int e = tile_e[t];
  tile_gemm_f<T, F, SILU, OutT, false>(
      a, nullptr, t * TM, expert_w<F>(w, layer * n_experts + e, K, N),
      scale + (size_t)e * G * N, G,
      bias == nullptr ? nullptr : bias + (size_t)e * N, K, N,
      blockIdx.y * BN, out);
}

// K4 / K5 a8: the same on int8 rows with row scales
template <typename T, int F, bool SILU, typename OutT>
__global__ void __launch_bounds__(THREADS)
    runs_gemm_s8(const int8_t* __restrict__ aq, const float* __restrict__ as,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scale, int G,
                 const T* __restrict__ bias,
                 const int32_t* __restrict__ tile_e,
                 const int32_t* __restrict__ starts, int n_experts,
                 int layer, int K, int N, OutT* __restrict__ out) {
  const int t = blockIdx.x;
  if (t >= starts[n_experts]) return;
  const int e = tile_e[t];
  tile_gemm_s8<F, SILU, T, OutT, false>(
      aq, as, nullptr, t * TM, expert_w<F>(w, layer * n_experts + e, K, N),
      scale + (size_t)e * G * N, G,
      bias == nullptr ? nullptr : bias + (size_t)e * N, K, N,
      blockIdx.y * BN, out);
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
  using T = __nv_bfloat16;
  const T* x = static_cast<const T*>(x_pad);
  const int8_t* q1 = static_cast<const int8_t*>(w1);
  const int8_t* q2 = static_cast<const int8_t*>(w2);
  const T* bias1 = static_cast<const T*>(b1);
  const T* bias2 = static_cast<const T*>(b2);
  const dim3 grid1(n_tiles, h / BN), grid2(n_tiles, d / BN);
  if (!a8) {
    runs_gemm<T, F, true, T><<<grid1, THREADS, 0, stream>>>(
        x, q1, s1, g1, bias1, tile_e, starts, n_experts, layer, d, h,
        static_cast<T*>(hidden));
    RETURN_IF_ERROR();
    runs_gemm<T, F, false, T><<<grid2, THREADS, 0, stream>>>(
        static_cast<const T*>(hidden), q2, s2, g2, bias2, tile_e, starts,
        n_experts, layer, h, d, static_cast<T*>(y_pad));
    return (int)cudaGetLastError();
  }
  const int rows = n_tiles * TM;
  quant_rows<T><<<rows, QTHREADS, 0, stream>>>(x, d, starts, nullptr,
                                                n_experts, TM, xq, xs);
  RETURN_IF_ERROR();
  runs_gemm_s8<T, F, true, float><<<grid1, THREADS, 0, stream>>>(
      xq, xs, q1, s1, g1, bias1, tile_e, starts, n_experts, layer, d, h,
      static_cast<float*>(hidden));
  RETURN_IF_ERROR();
  quant_rows<float><<<rows, QTHREADS, 0, stream>>>(
      static_cast<const float*>(hidden), h, starts, nullptr, n_experts, TM,
      hq, hs);
  RETURN_IF_ERROR();
  runs_gemm_s8<T, F, false, T><<<grid2, THREADS, 0, stream>>>(
      hq, hs, q2, s2, g2, bias2, tile_e, starts, n_experts, layer, h, d,
      static_cast<T*>(y_pad));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile rows, column block and contraction step the wrapper must honour.
int moe_runs_tile_rows() { return TM; }
int moe_runs_col_block() { return BN; }     // K4, K5
int moe_runs_k_step() { return BK; }        // K4, K5
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
// d) float32; int8 takes g1 = g2 = 1. a8 != 0 quantizes the activations
// per row into xq/xs (x_pad's rows x d) and hq/hs (rows x h); hidden is
// then float32, else bf16. Returns cudaGetLastError() of the launches.
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
