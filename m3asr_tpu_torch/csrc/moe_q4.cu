// Top-1 expert FFN on packed int4 weights for small token counts, with
// no sort/pad layout (K6): weight-only (bf16 activations) or w4a8.
//
// Replaces m3asr_tpu/ops/pallas_moe_q4.py::moe_experts_pallas_q4 /
// _q4_kernel, the dense streamer that the JAX engine picks for int4 and
// w4a8 engines at <= 128 post-subsampling tokens. Its contract: x (N, d)
// and each row's expert gate[N] (-1, or any value outside [0, E), for a
// row of no expert); the output row is the top-1 expert's FFN of x, and
// 0 for a row of no expert (the TPU kernel's out += where(sel, y, 0));
// experts with no rows are never read.
//
// The TPU kernel computes every active expert on every token and masks,
// 32x the top-1 FLOPs, because its one sequential grid step streams the
// experts' weights past all tokens. On Hopper that waste buys nothing.
// Here the row-tile front (row_tiles.cuh) turns the gate vector into
// tiles of up to TM rows of one expert on the device, and each GEMM is a
// grid of (tile x 64-column block) over the static worst case of tiles:
// a block past the last real tile exits, an idle expert has no tile, and
// a heavy expert's tiles run side by side. A block reads its tile's rows
// in place through the front's row list and stores its outputs in place,
// so no torch op prepares a layout: the wrapper passes x and the gate as
// they are. GEMM2's grid has one more tile slot, which writes the zeros
// of rows of no expert.
//
//     hidden[rows of e] = silu(x[rows of e] @ w1[e] + b1[e])   GEMM1
//     out[rows of e]    = hidden[rows of e] @ w2[e] + b2[e]    GEMM2
//
// The tiles are K5's (expert_tiles.cuh): weight-only on bf16 mma.sync
// with the int4 values widened exactly in registers and each 128-row
// group's float32 sums folded at its end (tile_q_mma); w4a8 on s8
// mma.sync into exact s32 sums with the JAX package's epilogue order
// (tile_q_s8), after quant_rows launches for x (rows of an expert) and
// for the float32 hidden, as in moe_runs.cu. So K6 w4a8 equals K5 w4a8
// bit for bit.
//
// What bounds it on an H100: the bytes of the active experts' packed
// weights and scales (d=512, h=1024: 0.5 MiB + 48 KiB per expert; ~16 MB
// at 63 tokens with ~28 of 32 experts active, about 5 us at 3.35 TB/s).
// Each active expert's weights are read once per tile of its rows, which
// is once at these token counts; the launches (front, two GEMMs, with a8
// two quant_rows) and GEMM2's 16 dependent 64-deep steps a block are the
// rest.
//
// Stacked weights: w1/w2 are the (L*E, K, .) base pointers and `layer`
// selects rows layer*E .. layer*E + E - 1. Scales (E, G, N) and biases
// (E, N) bf16 are this layer's.

#include "expert_tiles.cuh"
#include "row_tiles.cuh"

using namespace moe;

namespace {

// GEMM over the front's tiles: grid (max_tiles [+ 1], N / Q_BN). A8
// selects the s8 tile on quantized rows (aq, as) instead of the bf16 tile
// on a; GEMM2 (!SILU) has the zero slot.
template <bool A8, bool SILU, typename OutT>
__global__ void __launch_bounds__(Q_THREADS)
    dense_gemm(const bf16* __restrict__ a, const int8_t* __restrict__ aq,
               const float* __restrict__ as,
               const int32_t* __restrict__ front, int n_rows, int max_tiles,
               const int8_t* __restrict__ w, const float* __restrict__ scale,
               int G, const bf16* __restrict__ bias, int n_experts,
               int layer, int K, int N, OutT* __restrict__ out) {
  __shared__ int rows[TM];
  const int t = blockIdx.x;
  const int n0 = blockIdx.y * Q_BN;
  if (!SILU && t == max_tiles) {
    front_zero_rows(front, n_rows, N, n0, Q_BN, Q_THREADS, out);
    return;
  }
  int e = 0;
  if (front_tile(front, n_rows, max_tiles, t, rows, e) == 0) return;
  extern __shared__ __align__(16) unsigned char q_smem[];
  const int8_t* we = q_weights<W_Q4>(w, layer * n_experts + e, K, N, n0);
  const float* se = scale + (size_t)e * G * N;
  const bf16* be = bias == nullptr ? nullptr : bias + (size_t)e * N;
  if constexpr (A8)
    tile_q_s8<W_Q4, SILU, OutT, true>(aq, as, rows, we, se, G, be, K, N, n0,
                                      q_smem, out);
  else
    tile_q_mma<W_Q4, SILU, true>(a, rows, we, se, G, be, K, N, n0, q_smem,
                                 out);
}

#define RETURN_IF_ERROR()                       \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)

}  // namespace

extern "C" {

int moe_q4_col_block() { return Q_BN; }
int moe_q4_k_step() { return Q_GROUP; }
// int32 words of the row-tile front scratch for n_rows rows, E experts
int moe_q4_front_ints(int n_rows, int n_experts) {
  return front_ints(n_rows, n_experts);
}

// The row-tile front alone (chip_smoke.py holds it against its plain
// twin, ops/row_tiles.py). Returns cudaGetLastError() of the launch.
int moe_q4_row_tiles(const int32_t* gate, int n_rows, int n_experts,
                     int32_t* front, void* stream) {
  return (int)launch_row_tiles(gate, n_rows, n_experts, front,
                               static_cast<cudaStream_t>(stream));
}

// x (n_rows, d) bf16, gate (n_rows,) int32; w1 (L*E|E, d, h/2), w2
// (., h, d/2) packed int4; s1 (E, g1, h), s2 (E, g2, d) float32; b1/b2
// (E, h)/(E, d) bf16 or null. front: moe_q4_front_ints int32 scratch.
// a8 != 0 quantizes x into xq/xs (n_rows x d) and the float32 hidden
// into hq/hs (n_rows x h); the hidden is bf16 otherwise. out (n_rows, d)
// bf16. d and h are multiples of moe_q4_col_block(), the groups of
// moe_q4_k_step() rows. Returns cudaGetLastError() of the launches (0 on
// success).
int moe_q4_dense(int a8, const void* x, const int32_t* gate, int n_rows,
                 const void* w1, const float* s1, int g1, const void* b1,
                 const void* w2, const float* s2, int g2, const void* b2,
                 int n_experts, int layer, int d, int h, int32_t* front,
                 void* hidden, int8_t* xq, float* xs, int8_t* hq, float* hs,
                 void* out, void* stream) {
  using T = bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % Q_BN != 0 || h % Q_BN != 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  const T* bias1 = static_cast<const T*>(b1);
  const T* bias2 = static_cast<const T*>(b2);
  const int8_t* q1 = static_cast<const int8_t*>(w1);
  const int8_t* q2 = static_cast<const int8_t*>(w2);
  const int tiles = front_max_tiles(n_rows, n_experts);
  const dim3 grid1(tiles, h / Q_BN), grid2(tiles + 1, d / Q_BN);
  const int err = (int)launch_row_tiles(gate, n_rows, n_experts, front, s);
  if (err != 0) return err;
  if (!a8) {
    constexpr int smem = QLayout<W_Q4, false>::bytes;
    dense_gemm<false, true, T><<<grid1, Q_THREADS, smem, s>>>(
        xt, nullptr, nullptr, front, n_rows, tiles, q1, s1, g1, bias1,
        n_experts, layer, d, h, static_cast<T*>(hidden));
    RETURN_IF_ERROR();
    dense_gemm<false, false, T><<<grid2, Q_THREADS, smem, s>>>(
        static_cast<const T*>(hidden), nullptr, nullptr, front, n_rows,
        tiles, q2, s2, g2, bias2, n_experts, layer, h, d,
        static_cast<T*>(out));
    return (int)cudaGetLastError();
  }
  constexpr int smem = QLayout<W_Q4, true>::bytes;
  quant_rows<T><<<n_rows, QTHREADS, 0, s>>>(xt, d, nullptr, gate, n_experts,
                                            TM, xq, xs);
  RETURN_IF_ERROR();
  dense_gemm<true, true, float><<<grid1, Q_THREADS, smem, s>>>(
      nullptr, xq, xs, front, n_rows, tiles, q1, s1, g1, bias1, n_experts,
      layer, d, h, static_cast<float*>(hidden));
  RETURN_IF_ERROR();
  quant_rows<float><<<n_rows, QTHREADS, 0, s>>>(
      static_cast<const float*>(hidden), h, nullptr, gate, n_experts, TM, hq,
      hs);
  RETURN_IF_ERROR();
  dense_gemm<true, false, T><<<grid2, Q_THREADS, smem, s>>>(
      nullptr, hq, hs, front, n_rows, tiles, q2, s2, g2, bias2, n_experts,
      layer, h, d, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
