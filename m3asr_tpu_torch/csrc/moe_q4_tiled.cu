// Tiled grouped GEMM on packed int4 expert weights (K7): weight-only
// (float32 or bf16 activations) or w4a8, on the tiles of K5/K6
// (expert_tiles.cuh).
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
// is one 64-column block (blockIdx.x) x one TM = 32-row slice of a tile
// (blockIdx.y), reads its tile's expert from tile_e, and stages the raw
// packed weight slices on a cp.async ring; the repeated reads of one
// expert's bytes by the blocks of its run come from L2. A block's 32 packed bytes a row hold its 64
// columns (32 low nibbles, 32 high ones, N/2 apart), so every byte is
// read by one block. Blocks of a tile past the last expert's run
// (starts[E]), or of a slice holding only pad rows (past starts[e] *
// tile + counts[e]), return at once.
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
//   bf16: mma.sync m16n8k16 on B fragments built in registers as
//   bf16(q * s_g[n]) (tile_q_mma, DEQ). float32: FMAs on q * s_g[n], one
//   accumulator an output summed in ascending k, no TF32 (tile_fma on
//   Q4x2 weights).
// * w4a8 (:560-587): x and the float32 hidden are quantized per row
//   (quant_rows); per group s8 x s8 sums in s32 on mma.sync m16n8k32,
//   each group's sum times its scale row in float32, the groups summed,
//   times the row scale (tile_q_s8): K5's a8 arithmetic, so K7 w4a8
//   equals K5 w4a8 bit for bit.
//
// Stacked weights: w1/w2 are the (L*E, K, .) base pointers and `layer`
// selects rows layer*E .. layer*E + E - 1. Scales (E, G, N) and biases
// (E, N) float32 are this layer's.
//
// What bounds it on an H100: the bytes of the active experts' packed
// weights and scales (d=512, h=1024: 0.5 MiB + 48 KiB per expert) at
// 3.35 TB/s. The two (a8: four) dependent launches and GEMM2's 16 64-deep
// steps a block are the rest, and the static grid of 64/128-row tiles has
// two to four times the slices of K5's 32-row tiles, the extra ones
// exiting at once. The grid takes column blocks fastest, so each slice's
// blocks go out together and the empty slots past the last run come last:
// in a same-call trial that was faster than slices fastest (K5's order).

#include "expert_tiles.cuh"

using namespace moe;

namespace {

static_assert(Q_BN == F_BN && FTile<float>::THREADS == Q_THREADS,
              "one block shape for every activation type");

// The first row of this block's TM-row slice and its expert, or -1 when
// the slice has no real row.
__device__ __forceinline__ int slice_row0(const int32_t* __restrict__ tile_e,
                                          const int32_t* __restrict__ starts,
                                          const int32_t* __restrict__ counts,
                                          int tile, int n_experts, int* e) {
  const int row0 = blockIdx.y * TM;
  const int t = row0 / tile;
  // both loads at once: t < n_tiles, and tile_e holds an expert there
  const int last = starts[n_experts];
  *e = tile_e[t];
  if (t >= last) return -1;  // past the last expert's run
  if (row0 >= starts[*e] * tile + counts[*e]) return -1;  // pad rows only
  return row0;
}

// Weight-only: one TM x 64 slice of act(a @ deq(w) + bias) [min upper],
// deq(w)[k, n] = T(nibble(k, n) * scale[k / gs, n]).
template <typename T, bool SILU>
__global__ void __launch_bounds__(Q_THREADS)
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
  const int n0 = blockIdx.x * Q_BN;
  const int8_t* we = q_weights<W_Q4>(w, layer * n_experts + e, K, N, n0);
  const float* se = scale + (size_t)e * G * N;
  const float* be = bias == nullptr ? nullptr : bias + (size_t)e * N;
  extern __shared__ __align__(16) unsigned char k7_smem[];
  if constexpr (std::is_same<T, bf16>::value) {
    tile_q_mma<W_Q4, SILU, false, true, float>(
        a + (size_t)row0 * K, nullptr, we, se, G, be, K, N, n0, k7_smem,
        out + (size_t)row0 * N, clamp != 0, upper);
  } else {
    const int live = starts[e] * tile + counts[e] - row0;
    tile_fma<SILU, false, Q4x2>(
        a + (size_t)row0 * K, nullptr, reinterpret_cast<const Q4x2*>(we),
        se + n0 / 2, G, be, K, N, n0, live,
        reinterpret_cast<float*>(k7_smem), out + (size_t)row0 * N,
        clamp != 0, upper);
  }
}

// w4a8: the same slice on int8 rows with row scales (K5's a8 tile). At
// least 4 blocks an SM: without that bound ptxas held the SiLU form at 72
// registers and spilled 16 bytes around the calls of the division's slow
// path; with it all forms take 91 registers and none spills.
template <bool SILU, typename OutT>
__global__ void __launch_bounds__(Q_THREADS, 4)
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
  const int n0 = blockIdx.x * Q_BN;
  extern __shared__ __align__(16) unsigned char k7_smem[];
  tile_q_s8<W_Q4, SILU, OutT, false, float>(
      aq + (size_t)row0 * K, as + row0, nullptr,
      q_weights<W_Q4>(w, layer * n_experts + e, K, N, n0),
      scale + (size_t)e * G * N, G,
      bias == nullptr ? nullptr : bias + (size_t)e * N, K, N, n0, k7_smem,
      out + (size_t)row0 * N, clamp != 0, upper);
}

#define RETURN_IF_ERROR()                       \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)

template <typename T>
constexpr int weight_only_smem() {
  if constexpr (std::is_same<T, bf16>::value)
    return QLayout<W_Q4, false>::bytes;
  else
    return FLayout<float, Q4x2>::bytes;
}

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
  // column blocks fastest: a slice's blocks are dispatched together, and
  // the slots past the last run come last
  const int rows = n_tiles * tile;
  const dim3 grid1(h / Q_BN, rows / TM), grid2(d / Q_BN, rows / TM);
  if (!a8) {
    constexpr int smem = weight_only_smem<T>();
    tiled_gemm<T, true><<<grid1, Q_THREADS, smem, s>>>(
        x, q1, s1, g1, b1, tile_e, starts, counts, tile, n_experts, layer, d,
        h, clamp, upper, static_cast<T*>(hidden));
    RETURN_IF_ERROR();
    tiled_gemm<T, false><<<grid2, Q_THREADS, smem, s>>>(
        static_cast<const T*>(hidden), q2, s2, g2, b2, tile_e, starts,
        counts, tile, n_experts, layer, h, d, 0, 0.f,
        static_cast<T*>(y_pad));
    return (int)cudaGetLastError();
  }
  constexpr int smem = QLayout<W_Q4, true>::bytes;
  quant_rows<T><<<rows, QTHREADS, 0, s>>>(x, d, starts, nullptr, n_experts,
                                          tile, xq, xs);
  RETURN_IF_ERROR();
  tiled_gemm_s8<true, float><<<grid1, Q_THREADS, smem, s>>>(
      xq, xs, q1, s1, g1, b1, tile_e, starts, counts, tile, n_experts, layer,
      d, h, clamp, upper, static_cast<float*>(hidden));
  RETURN_IF_ERROR();
  quant_rows<float><<<rows, QTHREADS, 0, s>>>(
      static_cast<const float*>(hidden), h, starts, nullptr, n_experts, tile,
      hq, hs);
  RETURN_IF_ERROR();
  tiled_gemm_s8<false, T><<<grid2, Q_THREADS, smem, s>>>(
      hq, hs, q2, s2, g2, b2, tile_e, starts, counts, tile, n_experts, layer,
      h, d, 0, 0.f, static_cast<T*>(y_pad));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per block slice, column block and scale-group step the wrapper
// must honour (a tile a multiple of the first, d and h of the second,
// every scale group of the last).
int moe_q4_tiled_slice_rows() { return TM; }
int moe_q4_tiled_col_block() { return Q_BN; }
int moe_q4_tiled_k_step() { return Q_GROUP; }

// dtype: 0 = float32, 1 = bfloat16 activations (x_pad, y_pad, and the
// weight-only hidden). x_pad (n_tiles * tile, d); w1 (L*E|E, d, h/2), w2
// (., h, d/2) packed int4; s1 (E, g1, h), s2 (E, g2, d) float32; b1/b2
// (E, h)/(E, d) float32 or null; tile_e (n_tiles,), starts (E+1,) in
// tiles, counts (E,) tokens. clamp != 0 takes min(hidden, upper) after
// SiLU. a8 != 0 quantizes x_pad's rows into xq/xs and the float32
// hidden into hq/hs; the hidden is of the activation type otherwise.
// x_pad, w1, w2 and the scratch start on 16-byte boundaries. Returns
// cudaGetLastError() of the launches (0 on success), or
// cudaErrorInvalidValue for a tile or widths K7 does not take.
int moe_q4_tiled(int dtype, int a8, const void* x_pad, const void* w1,
                 const float* s1, int g1, const float* b1, const void* w2,
                 const float* s2, int g2, const float* b2,
                 const int32_t* tile_e, const int32_t* starts,
                 const int32_t* counts, int tile, int n_tiles, int n_experts,
                 int layer, int d, int h, int clamp, float upper,
                 void* hidden, int8_t* xq, float* xs, int8_t* hq, float* hs,
                 void* y_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile % TM || d % Q_BN || h % Q_BN) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(a8, x_pad, w1, s1, g1, b1, w2, s2, g2, b2, tile_e,
                         starts, counts, tile, n_tiles, n_experts, layer, d,
                         h, clamp, upper, hidden, xq, xs, hq, hs, y_pad, s);
  if (dtype == 1)
    return launch<bf16>(a8, x_pad, w1, s1, g1, b1, w2, s2, g2, b2, tile_e,
                        starts, counts, tile, n_tiles, n_experts, layer, d,
                        h, clamp, upper, hidden, xq, xs, hq, hs, y_pad, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
