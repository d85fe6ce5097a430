// Top-1 expert FFN on float32, bf16 or int8 expert weights with no
// sort/pad layout (K8, the dense float/int8 streamer).
//
// Replaces m3asr_tpu/ops/pallas_moe.py::_call_stream / _stream_kernel,
// reached by moe_experts_dense_pallas (float weights) and
// moe_experts_pallas_q (int8 weights, per-column scales): the expert
// stage of the explicit `pallas` / `quant_pallas` requests. Its
// contract: x (N, d) and each row's expert gate[N]; the output row is
// the top-1 expert's FFN of x, and 0 for a row of no expert (gate
// outside [0, E), the -1 padding of the JAX wrapper's _prep); experts
// with no rows are never read (the TPU kernel's chunk-skip).
//
// The TPU kernel streams every active expert's weights past all tokens
// in one sequential grid step and masks (32x the top-1 FLOPs). Here, as
// in K6 (moe_q4.cu), the row-tile front (row_tiles.cuh) turns the gate
// vector into tiles of up to TM rows of one expert on the device, and
// each GEMM is a grid of (tile x 64-column block) over the static worst
// case of tiles, reading its rows in place through the front's row list.
// So the expert that takes half of a block's tokens (the engine's real
// routing) runs its tiles side by side rather than one after another,
// and an idle expert has no tile. GEMM2's grid has one more tile slot,
// which writes the zeros of rows of no expert. Each row has one expert,
// so no atomics are needed.
//
//     hidden[rows of e] = silu(x[rows of e] @ w1[e] + b1[e])   GEMM1
//     out[rows of e]    = hidden[rows of e] @ w2[e] + b2[e]    GEMM2
//
// Rounding points, the TPU kernel's (pallas_moe.py:100-131): the weights
// are taken in the compute type cdt (x's type): float weights as they
// are; int8 weights as cdt(cdt(q) * cdt(scale)), the scale and the
// product both rounded to cdt. Products sum in float32, the float32 bias
// b1 is added, SiLU runs in float32 and the hidden is rounded to cdt;
// GEMM2 likewise, with the float32 bias b2, and the output is rounded to
// cdt.
//
// The tiles are K1's (expert_tiles.cuh):
// - bf16 weights: bf16 mma.sync m16n8k16 (tile_mma).
// - int8 weights on bf16 activations: the same MMA on B fragments built
//   in registers from the raw int8 slice, each weight bf16(q * bf16(s))
//   (tile_q_mma, DEQ): q * s is exact in float32, so the one rounding is
//   the TPU kernel's bf16 product, and the weights are exact bf16 values.
// - float32 weights, and int8 weights on float32 activations (each
//   weight q * s in float32): 4 x 4 FMA patches (tile_fma), one
//   accumulator an output summed in ascending k, no TF32; so float32 K8
//   equals float32 K1 bit for bit.
//
// What bounds it on an H100: the bytes of the active experts' weights
// (d=512, h=1024: 4 MiB per expert in fp32, 2 MiB bf16, 1 MiB int8) at
// 3.35 TB/s. Each active expert's weights are read once per tile of its
// rows: once at small token counts, more often (from L2, by blocks that
// run at about the same time) beyond.

#include "expert_tiles.cuh"
#include "row_tiles.cuh"

using namespace moe;

namespace {

// The shared memory of one GEMM block for activations T, weights W.
template <typename T, typename W>
constexpr int stream_smem() {
  if constexpr (std::is_same<T, bf16>::value && std::is_same<W, int8_t>::value)
    return QLayout<W_Q8, false>::bytes;
  else
    return FLayout<T, W>::bytes;
}

// GEMM over the front's tiles: grid (max_tiles [+ 1], N / F_BN); GEMM2
// (ACT_NONE) has the zero slot. w: (E, K, N); scale: (E, N) float32 for int8
// weights; bias: (E, N) float32 or null.
template <typename T, typename W, int ACT>
__global__ void __launch_bounds__(128)
    stream_gemm(const T* __restrict__ a, const int32_t* __restrict__ front,
                int n_rows, int max_tiles, const W* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias, int K, int N,
                T* __restrict__ out) {
  static_assert(F_BN == Q_BN && FTile<float>::THREADS == 128 &&
                    FTile<bf16>::THREADS == 128 && Q_THREADS == 128,
                "one block shape for every weight type");
  __shared__ int rows[TM];
  const int t = blockIdx.x;
  const int n0 = blockIdx.y * F_BN;
  if (ACT == ACT_NONE && t == max_tiles) {
    front_zero_rows(front, n_rows, N, n0, F_BN, 128, out);
    return;
  }
  int e = 0;
  const int m = front_tile(front, n_rows, max_tiles, t, rows, e);
  if (m == 0) return;
  extern __shared__ __align__(16) unsigned char s_smem[];
  const W* we = w + (size_t)e * K * N + n0;
  const float* se = scale == nullptr ? nullptr : scale + (size_t)e * N;
  const float* be = bias == nullptr ? nullptr : bias + (size_t)e * N;
  if constexpr (std::is_same<T, float>::value) {
    tile_fma<ACT, true, W>(a, rows, we, se == nullptr ? nullptr : se + n0,
                           1, be, K, N, n0, m,
                           reinterpret_cast<float*>(s_smem), out);
  } else if constexpr (std::is_same<W, int8_t>::value) {
    tile_q_mma<W_Q8, ACT, true, true, float>(a, rows, we, se, 1, be, K, N,
                                             n0, s_smem, out);
  } else {
    tile_mma<ACT, true, float>(a, rows, we, be, K, N, n0,
                               reinterpret_cast<bf16*>(s_smem), out);
  }
}

// One GEMM. The dynamic shared memory limit is raised once per
// instantiation, before its first launch.
template <typename T, typename W, int ACT>
int launch_gemm(const T* a, const int32_t* front, int n_rows, int tiles,
                const W* w, const float* scale, const float* bias, int K,
                int N, T* out, cudaStream_t s) {
  constexpr int smem = stream_smem<T, W>();
  static const int attr = (int)cudaFuncSetAttribute(
      stream_gemm<T, W, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != 0) return attr;
  stream_gemm<T, W, ACT><<<dim3(tiles + (ACT == ACT_NONE ? 1 : 0), N / F_BN),
                           128, smem, s>>>(a, front, n_rows, tiles, w, scale,
                                           bias, K, N, out);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* x, const int32_t* gate, int n_rows, const void* w1,
           const float* s1, const float* b1, const void* w2, const float* s2,
           const float* b2, int n_experts, int d, int h, int32_t* front,
           void* hidden, void* out, cudaStream_t s) {
  const int tiles = front_max_tiles(n_rows, n_experts);
  int err = (int)launch_row_tiles(gate, n_rows, n_experts, front, s);
  if (err != 0) return err;
  err = launch_gemm<T, W, ACT_SILU>(static_cast<const T*>(x), front, n_rows,
                                    tiles, static_cast<const W*>(w1), s1, b1,
                                    d, h, static_cast<T*>(hidden), s);
  if (err != 0) return err;
  return launch_gemm<T, W, ACT_NONE>(static_cast<const T*>(hidden), front,
                                     n_rows, tiles, static_cast<const W*>(w2),
                                     s2, b2, h, d, static_cast<T*>(out), s);
}

}  // namespace

extern "C" {

int moe_stream_col_block() { return F_BN; }
int moe_stream_k_step() { return FTile<bf16>::BK; }
// int32 words of the row-tile front scratch for n_rows rows, E experts
int moe_stream_front_ints(int n_rows, int n_experts) {
  return front_ints(n_rows, n_experts);
}

// The row-tile front alone (chip_smoke.py holds it against its plain
// twin, ops/row_tiles.py). Returns cudaGetLastError() of the launch.
int moe_stream_row_tiles(const int32_t* gate, int n_rows, int n_experts,
                         int32_t* front, void* stream) {
  return (int)launch_row_tiles(gate, n_rows, n_experts, front,
                               static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32, 1 = bfloat16 (x, the hidden, out, float weights);
// quant != 0: int8 weights with float32 scales s1 (E, h) / s2 (E, d),
// else weights of x's type (s1, s2 unused). x (n_rows, d), gate
// (n_rows,) int32, w1 (E, d, h), w2 (E, h, d); b1 (E, h) / b2 (E, d)
// float32 or null; front: moe_stream_front_ints int32 scratch; hidden
// (n_rows, h) scratch; out (n_rows, d). d and h are multiples of
// moe_stream_col_block() and moe_stream_k_step(). Returns
// cudaGetLastError() of the launches (0 on success).
int moe_stream(int dtype, int quant, const void* x, const int32_t* gate,
               int n_rows, const void* w1, const float* s1, const float* b1,
               const void* w2, const float* s2, const float* b2,
               int n_experts, int d, int h, int32_t* front, void* hidden,
               void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % F_BN != 0 || h % F_BN != 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  if (dtype == 0 && !quant)
    return launch<float, float>(x, gate, n_rows, w1, s1, b1, w2, s2, b2,
                                n_experts, d, h, front, hidden, out, s);
  if (dtype == 0)
    return launch<float, int8_t>(x, gate, n_rows, w1, s1, b1, w2, s2, b2,
                                 n_experts, d, h, front, hidden, out, s);
  if (dtype == 1 && !quant)
    return launch<bf16, bf16>(x, gate, n_rows, w1, s1, b1, w2, s2, b2,
                              n_experts, d, h, front, hidden, out, s);
  if (dtype == 1)
    return launch<bf16, int8_t>(x, gate, n_rows, w1, s1, b1, w2, s2, b2,
                                n_experts, d, h, front, hidden, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
