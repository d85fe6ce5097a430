// Tiled grouped GEMM on packed int4 expert weights (K7): weight-only
// (float32 or bf16 activations) or w4a8.
//
// Replaces m3asr_tpu/ops/pallas_moe_q4.py::moe_experts_pallas_q4_tiled
// / _q4_tiled_kernel (weights unpacked by _unpack_expert), the expert
// stage of the explicit `quant4_tiled` / `quant4_a8_tiled` requests
// (`tiled` on int4 and w4a8 engines). The wrapper
// (m3asr_tpu_torch/ops/moe_q4.py) builds the JAX package's _tile_layout
// on the device: tokens stably sorted by expert, each expert's group
// padded to a multiple of `tile` rows (64 up to 768 tokens, else 128),
// one expert per tile (tile_e), a static worst-case tile count. Pad rows
// are zeros and never gathered back.
//
// The TPU kernel runs one grid step per tile, in order, and memoizes
// each expert's unpacked weights in VMEM across the tiles of its run.
// Blocks on Hopper run in no order, so nothing carries over: each block
// is one TM-row slice of a tile x one column block, reads its tile's
// expert from tile_e, and dequantizes the packed k-slices it needs into
// shared memory as it stages them; the repeated reads of one expert's
// bytes by the blocks of its run come from L2. Blocks of a tile past
// the last expert's run (starts[E]), or of a TM-row slice holding only
// pad rows (past starts[e] * tile + counts[e]), return at once.
//
//     hidden = act(x_tile @ w1[e] + b1[e]) [min upper]     GEMM1
//     y_tile = hidden @ w2[e] + b2[e]                      GEMM2
//
// Rounding points, the TPU kernel's default (memoized) path:
// * weight-only (pallas_moe_q4.py:459-465, :579-593): each weight is
//   dequantized as (nibble * group scale) in float32 and rounded to the
//   activation type T before the product; one float32 sum over the
//   whole contraction; the float32 bias b1 is added, SiLU and the clamp
//   run in float32 and the hidden is rounded to T; GEMM2 likewise.
// * w4a8 (:560-587): x and the float32 hidden are quantized per row
//   (quant_rows); per 128-row group s8 x s8 sums in s32 (__dp4a), each
//   group's sum times its scale row in float32, the groups summed, times
//   the row scale: K5's a8 arithmetic, tile_gemm_s8 of moe_common.cuh.
//
// Stacked weights: w1/w2 are the (L*E, K, .) base pointers and `layer`
// selects rows layer*E .. layer*E + E - 1. Scales (E, G, N) and biases
// (E, N) float32 are this layer's.
//
// What bounds it on an H100: the bytes of the active experts' packed
// weights and scales (d=512, h=1024: 0.5 MiB + 48 KiB per expert) at
// 3.35 TB/s, or at high token counts the products at the type's peak.
//
// Simple on purpose: float32 FMAs (weight-only) and __dp4a (w4a8), no
// tensor cores, TMA or pipelining yet.

#include "moe_common.cuh"

using namespace moe;

namespace {

static_assert(TM * BK / 4 == THREADS, "tile_gemm_s8 loads one word each");

// The first row of this block's TM-row slice and its expert, or -1 when
// the slice has no real row.
__device__ __forceinline__ int slice_row0(const int32_t* __restrict__ tile_e,
                                          const int32_t* __restrict__ starts,
                                          const int32_t* __restrict__ counts,
                                          int tile, int n_experts, int* e) {
  const int row0 = blockIdx.x * TM;
  const int t = row0 / tile;
  if (t >= starts[n_experts]) return -1;  // past the last expert's run
  *e = tile_e[t];
  if (row0 >= starts[*e] * tile + counts[*e]) return -1;  // pad rows only
  return row0;
}

// Weight-only: one TM x BN tile of act(a @ deq(w) + bias) [min upper],
// deq(w)[k, n] = T(nibble(k, n) * scale[k / gs, n]).
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
    tiled_gemm(const T* __restrict__ a, const int8_t* __restrict__ w,
               const float* __restrict__ scale, int G,
               const float* __restrict__ bias,
               const int32_t* __restrict__ tile_e,
               const int32_t* __restrict__ starts,
               const int32_t* __restrict__ counts, int tile, int n_experts,
               int layer, int K, int N, int clamp, float upper,
               T* __restrict__ out) {
  int e;
  const int row0 = slice_row0(tile_e, starts, counts, tile, n_experts, &e);
  if (row0 < 0) return;
  const int n0 = blockIdx.y * BN;
  const int8_t* __restrict__ we =
      expert_w<W_Q4>(w, layer * n_experts + e, K, N);
  const float* __restrict__ se = scale + (size_t)e * G * N;
  const int gs = K / G;

  __shared__ float xs[TM][BK + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < TM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      xs[r][c] = to_f(a[(size_t)(row0 + r) * K + k0 + c]);
    }
    const float* sg = se + (size_t)(k0 / gs) * N + n0;  // BK divides gs
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const float v = __fmul_rn((float)wq<W_Q4>(we, k0 + r, n0 + c, N),
                                sg[c]);
      ws[r][c] = to_f(from_f<T>(v));
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
    const size_t row = (size_t)row0 + 2 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      float v = acc[i][j];
      if (bias != nullptr) v = __fadd_rn(v, bias[(size_t)e * N + n]);
      if (SILU) v = silu(v);
      if (clamp) v = fminf(v, upper);
      out[row * N + n] = from_f<T>(v);
    }
  }
}

// w4a8: the same slice on int8 rows with row scales (K5's a8 tile).
template <bool SILU, typename OutT>
__global__ void __launch_bounds__(THREADS)
    tiled_gemm_s8(const int8_t* __restrict__ aq, const float* __restrict__ as,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale, int G,
                  const float* __restrict__ bias,
                  const int32_t* __restrict__ tile_e,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ counts, int tile,
                  int n_experts, int layer, int K, int N, int clamp,
                  float upper, OutT* __restrict__ out) {
  int e;
  const int row0 = slice_row0(tile_e, starts, counts, tile, n_experts, &e);
  if (row0 < 0) return;
  tile_gemm_s8<W_Q4, SILU, float, OutT>(
      aq, as, row0, expert_w<W_Q4>(w, layer * n_experts + e, K, N),
      scale + (size_t)e * G * N, G,
      bias == nullptr ? nullptr : bias + (size_t)e * N, K, N,
      blockIdx.y * BN, out, clamp != 0, upper);
}

#define RETURN_IF_ERROR()                       \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)

template <typename T>
int launch(int a8, const void* x_pad, const void* w1, const float* s1,
           int g1, const float* b1, const void* w2, const float* s2, int g2,
           const float* b2, const int32_t* tile_e, const int32_t* starts,
           const int32_t* counts, int tile, int n_tiles, int n_experts,
           int layer, int d, int h, int clamp, float upper, void* hidden,
           int8_t* xq, float* xs, int8_t* hq, float* hs, void* y_pad,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(x_pad);
  const int8_t* q1 = static_cast<const int8_t*>(w1);
  const int8_t* q2 = static_cast<const int8_t*>(w2);
  const int rows = n_tiles * tile;
  const dim3 grid1(rows / TM, h / BN), grid2(rows / TM, d / BN);
  if (!a8) {
    tiled_gemm<T, true><<<grid1, THREADS, 0, s>>>(
        x, q1, s1, g1, b1, tile_e, starts, counts, tile, n_experts, layer, d,
        h, clamp, upper, static_cast<T*>(hidden));
    RETURN_IF_ERROR();
    tiled_gemm<T, false><<<grid2, THREADS, 0, s>>>(
        static_cast<const T*>(hidden), q2, s2, g2, b2, tile_e, starts,
        counts, tile, n_experts, layer, h, d, 0, 0.f,
        static_cast<T*>(y_pad));
    return (int)cudaGetLastError();
  }
  quant_rows<T><<<rows, QTHREADS, 0, s>>>(x, d, starts, nullptr, n_experts,
                                          tile, xq, xs);
  RETURN_IF_ERROR();
  tiled_gemm_s8<true, float><<<grid1, THREADS, 0, s>>>(
      xq, xs, q1, s1, g1, b1, tile_e, starts, counts, tile, n_experts, layer,
      d, h, clamp, upper, static_cast<float*>(hidden));
  RETURN_IF_ERROR();
  quant_rows<float><<<rows, QTHREADS, 0, s>>>(
      static_cast<const float*>(hidden), h, starts, nullptr, n_experts, tile,
      hq, hs);
  RETURN_IF_ERROR();
  tiled_gemm_s8<false, T><<<grid2, THREADS, 0, s>>>(
      hq, hs, q2, s2, g2, b2, tile_e, starts, counts, tile, n_experts, layer,
      h, d, 0, 0.f, static_cast<T*>(y_pad));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per block slice, column block and contraction step the wrapper
// must honour (a tile and every scale group a multiple of the last).
int moe_q4_tiled_slice_rows() { return TM; }
int moe_q4_tiled_col_block() { return BN; }
int moe_q4_tiled_k_step() { return BK; }

// dtype: 0 = float32, 1 = bfloat16 activations (x_pad, y_pad, and the
// weight-only hidden). x_pad (n_tiles * tile, d); w1 (L*E|E, d, h/2), w2
// (., h, d/2) packed int4; s1 (E, g1, h), s2 (E, g2, d) float32; b1/b2
// (E, h)/(E, d) float32 or null; tile_e (n_tiles,), starts (E+1,) in
// tiles, counts (E,) tokens. clamp != 0 takes min(hidden, upper) after
// SiLU. a8 != 0 quantizes x_pad's rows into xq/xs and the float32
// hidden into hq/hs; the hidden is of the activation type otherwise.
// Returns cudaGetLastError() of the launches (0 on success).
int moe_q4_tiled(int dtype, int a8, const void* x_pad, const void* w1,
                 const float* s1, int g1, const float* b1, const void* w2,
                 const float* s2, int g2, const float* b2,
                 const int32_t* tile_e, const int32_t* starts,
                 const int32_t* counts, int tile, int n_tiles, int n_experts,
                 int layer, int d, int h, int clamp, float upper,
                 void* hidden, int8_t* xq, float* xs, int8_t* hq, float* hs,
                 void* y_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile % TM) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(a8, x_pad, w1, s1, g1, b1, w2, s2, g2, b2, tile_e,
                         starts, counts, tile, n_tiles, n_experts, layer, d,
                         h, clamp, upper, hidden, xq, xs, hq, hs, y_pad, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a8, x_pad, w1, s1, g1, b1, w2, s2, g2, b2,
                                 tile_e, starts, counts, tile, n_tiles,
                                 n_experts, layer, d, h, clamp, upper, hidden,
                                 xq, xs, hq, hs, y_pad, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
