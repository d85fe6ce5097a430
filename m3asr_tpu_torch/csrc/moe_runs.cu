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
// scale group (moe_common.cuh's tile routines; K1 keeps its own float
// loop, expert_tile_gemm). The a8 modes add two launches of quant_rows:
// x is quantized per row once before GEMM1, and the hidden, kept in
// float32 between the launches as the TPU kernel keeps it
// (pallas_moe_runs.py:304-318), is quantized per full row before GEMM2.
//
// What bounds it on an H100: the bytes of the ACTIVE experts' weights
// (d=512, h=1024: 4 MiB per expert in fp32, 2 MiB in bf16, 1 MiB int8,
// 0.5 MiB int4, plus scales). At the serving token counts the FLOPs are
// small next to that. The design reads each active expert's weights once
// per tile of that expert (one block per tile x column block, the weight
// k-slices converted or unpacked into shared memory as they are staged)
// and never reads an idle expert's: no tile maps to it. The grid is the
// static worst case of tiles; blocks past the last real tile (starts[E])
// exit before touching memory, so the host never learns the routing.
//
// Stacked weights: w1/w2 are the (L*E, K, .) base pointers and `layer`
// selects rows layer*E .. layer*E + E - 1, so no per-layer copy exists.
// Biases (E, N) and scales (E, G, N) are this layer's.
//
// Types: K1 takes fp32 (plain FMAs, no TF32) or bf16 and computes at the
// weight type; K4/K5 take bf16 activations (the quantized engines' type).
// The hidden scratch is in the compute type (weight-only) or float32
// (a8); the output is in the activation type.
//
// Simple on purpose: no tensor cores, TMA or pipelining yet.

#include "moe_common.cuh"

using namespace moe;

namespace {

static_assert(TM * BK / 4 == THREADS, "tile_gemm_s8 loads one word each");

// K1: out[t*TM + r, n] = act(sum_k a[t*TM + r, k] * w[layer*E + e, k, n]
//                            + bias[e, n]),  e = tile_e[t]
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
expert_tile_gemm(const T* __restrict__ a, const T* __restrict__ w,
                 const T* __restrict__ bias,
                 const int32_t* __restrict__ tile_e,
                 const int32_t* __restrict__ starts, int n_experts,
                 int layer, int K, int N, T* __restrict__ out) {
  const int t = blockIdx.x;
  if (t >= starts[n_experts]) return;  // past the last real tile
  const int e = tile_e[t];
  const int n0 = blockIdx.y * BN;
  const T* __restrict__ we =
      w + ((size_t)layer * n_experts + e) * (size_t)K * N;
  const T* __restrict__ at = a + (size_t)t * TM * K;

  __shared__ float xs[TM][BK + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < TM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      xs[r][c] = to_f(at[(size_t)r * K + k0 + c]);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      ws[r][c] = to_f(we[(size_t)(k0 + r) * N + n0 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float a0 = xs[2 * ty][k];
      const float a1 = xs[2 * ty + 1][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = ws[k][tx + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (size_t)t * TM + 2 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f(bias[(size_t)e * N + n]);
      if (SILU) v = v / (1.0f + expf(-v));
      out[row * N + n] = from_f<T>(v);
    }
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

template <typename T>
int launch_f(const void* x_pad, const void* w1, const void* b1,
             const void* w2, const void* b2, const int32_t* tile_e,
             const int32_t* starts, int n_tiles, int n_experts, int layer,
             int d, int h, void* hidden, void* y_pad, cudaStream_t stream) {
  const dim3 block(THREADS);
  expert_tile_gemm<T, true><<<dim3(n_tiles, h / BN), block, 0, stream>>>(
      static_cast<const T*>(x_pad), static_cast<const T*>(w1),
      static_cast<const T*>(b1), tile_e, starts, n_experts, layer, d, h,
      static_cast<T*>(hidden));
  RETURN_IF_ERROR();
  expert_tile_gemm<T, false><<<dim3(n_tiles, d / BN), block, 0, stream>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(w2),
      static_cast<const T*>(b2), tile_e, starts, n_experts, layer, h, d,
      static_cast<T*>(y_pad));
  return (int)cudaGetLastError();
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
int moe_runs_col_block() { return BN; }
int moe_runs_k_step() { return BK; }

// K1. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of
// the two launches (0 on success). All pointers are device pointers.
int moe_runs_f(int dtype, const void* x_pad, const void* w1, const void* b1,
               const void* w2, const void* b2, const int32_t* tile_e,
               const int32_t* starts, int n_tiles, int n_experts, int layer,
               int d, int h, void* hidden, void* y_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f<float>(x_pad, w1, b1, w2, b2, tile_e, starts, n_tiles,
                           n_experts, layer, d, h, hidden, y_pad, s);
  if (dtype == 1)
    return launch_f<__nv_bfloat16>(x_pad, w1, b1, w2, b2, tile_e, starts,
                                   n_tiles, n_experts, layer, d, h, hidden,
                                   y_pad, s);
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
