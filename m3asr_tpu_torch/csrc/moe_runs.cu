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
// K1 (expert_tile_gemm: bf16 on mma.sync, float32 on 4 x 4 FMA patches),
// K4/K5 weight-only (runs_gemm: bf16 mma.sync on int8/int4 values widened
// exactly) and a8 (runs_gemm_s8: s8 mma.sync into exact s32 sums) run the
// tiles of expert_tiles.cuh, which says how each is built and why, on the
// run-length layout's contiguous rows. Blocks are TM = 32 rows x 64
// columns; d and h must be multiples of 64 (moe_runs_f_col_block(),
// moe_runs_col_block()). TM stays 32 rows (the layout is K4/K5's too); two
// launches a call, four with a8.
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

#include "expert_tiles.cuh"

using namespace moe;

namespace {

// ---------------------------------------------------------------------------
// K1: out[t*TM + r, n] = act(sum_k a[t*TM + r, k] * w[layer*E + e, k, n]
//                            + bias[e, n]),  e = tile_e[t]
// ---------------------------------------------------------------------------

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
    tile_mma<SILU, false>(at, nullptr, we, be, K, N, n0, sm, ot);
  } else {
    const int live = counts[e] - (t - starts[e]) * TM;
    tile_fma<SILU, false>(at, nullptr, we, nullptr, 1, be, K, N, n0, live,
                          sm, ot);
  }
}

// ---------------------------------------------------------------------------
// K4 / K5: out[t*TM + r, n] = act(sum_g (a[t*TM + r, group g] @ W[group g, n])
//                                 * scale[e, g, n] + bias[e, n]),
// W = this layer's quantized w[layer*E + e], e = tile_e[t]
// ---------------------------------------------------------------------------

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
  tile_q_mma<F, SILU, false>(
      a + (size_t)t * TM * K, nullptr,
      q_weights<F>(w, layer * n_experts + e, K, N, n0),
      scale + (size_t)e * G * N, G,
      bias == nullptr ? nullptr : bias + (size_t)e * N, K, N, n0, q_smem,
      out + (size_t)t * TM * N);
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
  tile_q_s8<F, SILU, OutT, false>(
      aq + (size_t)t * TM * K, as + (size_t)t * TM, nullptr,
      q_weights<F>(w, layer * n_experts + e, K, N, n0),
      scale + (size_t)e * G * N, G,
      bias == nullptr ? nullptr : bias + (size_t)e * N, K, N, n0, q_smem,
      out + (size_t)t * TM * N);
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
