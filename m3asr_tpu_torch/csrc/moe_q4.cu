// Top-1 expert FFN on packed int4 weights for small token counts, with
// no sort/pad layout (K6): weight-only (bf16 activations) or w4a8.
//
// Replaces m3asr_tpu/ops/pallas_moe_q4.py::moe_experts_pallas_q4 /
// _q4_kernel, the dense streamer that the JAX engine picks for int4 and
// w4a8 engines at <= 128 post-subsampling tokens. Its contract: x (N, d)
// and each row's expert gate[N] (-1, or any value outside [0, E), for a
// row of no expert); the output row is the top-1 expert's FFN of x, and
// 0 for a row of no expert (the TPU kernel's out += where(sel, y, 0)).
//
// The TPU kernel computes every active expert on every token and masks,
// 32x the top-1 FLOPs, because its one sequential grid step streams the
// experts' weights past all tokens. On Hopper that waste buys nothing,
// so the design is a grid of (expert x output column block): each block
// scans the gate vector, gathers (ordered, by warp ballots) the rows
// routed to its expert into shared memory, and computes only those rows
// in tiles of TM, reading them in place. Each row has one expert, so
// blocks never write the same row and no atomics are needed; a block
// whose expert has no rows reads nothing but the gate vector. GEMM2's
// grid has one more expert slot, which writes the zeros of rows of no
// expert. Unlike the run-length kernels (moe_runs.cu), no torch ops
// prepare a layout: the wrapper passes x and the gate as they are.
//
//     hidden[rows of e] = silu(x[rows of e] @ w1[e] + b1[e])   GEMM1
//     out[rows of e]    = hidden[rows of e] @ w2[e] + b2[e]    GEMM2
//
// w4a8 adds quant_rows launches for x (once per row) and for the float32
// hidden (per full row), as in moe_runs.cu.
//
// What bounds it on an H100: the bytes of the active experts' packed
// weights and scales (d=512, h=1024: 0.5 MiB + 48 KiB per expert; ~16 MB
// at 63 tokens with ~28 of 32 experts active, about 5 us at 3.35 TB/s).
// Each active expert's weights are read once per tile of its rows, which
// is once at these token counts.
//
// Simple on purpose: no tensor cores, TMA or pipelining yet.

#include "moe_common.cuh"

using namespace moe;

namespace {

static_assert(TM * BK / 4 == THREADS, "tile_gemm_s8 loads one word each");

// GEMM over the rows of each expert: grid (E [+1], N / BN). A8 selects
// the s8 tile on quantized rows (aq, as) instead of the float tile on a.
template <bool A8, bool SILU, typename T, typename OutT>
__global__ void __launch_bounds__(THREADS)
    dense_gemm(const T* __restrict__ a, const int8_t* __restrict__ aq,
               const float* __restrict__ as,
               const int32_t* __restrict__ gate, int n_rows,
               const int8_t* __restrict__ w, const float* __restrict__ scale,
               int G, const T* __restrict__ bias, int n_experts, int layer,
               int K, int N, OutT* __restrict__ out) {
  __shared__ int list[THREADS];
  __shared__ int warp_count[THREADS / 32];
  __shared__ int rows[TM];
  const int e = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int8_t* we =
      expert_w<W_Q4>(w, layer * n_experts + (e % n_experts), K, N);
  for (int base = 0; base < n_rows; base += THREADS) {
    const int m = collect_rows(gate, n_rows, base, e, n_experts, list,
                               warp_count);
    if (e == n_experts) {  // rows of no expert: zeros
      for (int i = threadIdx.x; i < m * BN; i += THREADS)
        out[(size_t)list[i / BN] * N + n0 + i % BN] = from_f<OutT>(0.f);
      continue;
    }
    for (int c0 = 0; c0 < m; c0 += TM) {
      if (threadIdx.x < TM)
        rows[threadIdx.x] = c0 + threadIdx.x < m ? list[c0 + threadIdx.x] : -1;
      __syncthreads();
      const float* se = scale + (size_t)e * G * N;
      const T* be = bias == nullptr ? nullptr : bias + (size_t)e * N;
      if constexpr (A8)
        tile_gemm_s8<W_Q4, SILU, T, OutT, true>(aq, as, rows, 0, we, se, G,
                                                be, K, N, n0, out);
      else
        tile_gemm_f<T, W_Q4, SILU, OutT, true>(a, rows, 0, we, se, G, be, K,
                                               N, n0, out);
      __syncthreads();  // rows is rewritten by the next tile
    }
  }
}

#define RETURN_IF_ERROR()                       \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)

}  // namespace

extern "C" {

int moe_q4_col_block() { return BN; }
int moe_q4_k_step() { return BK; }

// x (n_rows, d) bf16, gate (n_rows,) int32; w1 (L*E|E, d, h/2), w2
// (., h, d/2) packed int4; s1 (E, g1, h), s2 (E, g2, d) float32; b1/b2
// (E, h)/(E, d) bf16 or null. a8 != 0 quantizes x into xq/xs
// (n_rows x d) and the float32 hidden into hq/hs (n_rows x h); the
// hidden is bf16 otherwise. out (n_rows, d) bf16. Returns
// cudaGetLastError() of the launches (0 on success).
int moe_q4_dense(int a8, const void* x, const int32_t* gate, int n_rows,
                 const void* w1, const float* s1, int g1, const void* b1,
                 const void* w2, const float* s2, int g2, const void* b2,
                 int n_experts, int layer, int d, int h, void* hidden,
                 int8_t* xq, float* xs, int8_t* hq, float* hs, void* out,
                 void* stream) {
  using T = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* bias1 = static_cast<const T*>(b1);
  const T* bias2 = static_cast<const T*>(b2);
  const int8_t* q1 = static_cast<const int8_t*>(w1);
  const int8_t* q2 = static_cast<const int8_t*>(w2);
  const dim3 grid1(n_experts, h / BN), grid2(n_experts + 1, d / BN);
  if (!a8) {
    dense_gemm<false, true, T, T><<<grid1, THREADS, 0, s>>>(
        xt, nullptr, nullptr, gate, n_rows, q1, s1, g1, bias1, n_experts,
        layer, d, h, static_cast<T*>(hidden));
    RETURN_IF_ERROR();
    dense_gemm<false, false, T, T><<<grid2, THREADS, 0, s>>>(
        static_cast<const T*>(hidden), nullptr, nullptr, gate, n_rows, q2,
        s2, g2, bias2, n_experts, layer, h, d, static_cast<T*>(out));
    return (int)cudaGetLastError();
  }
  quant_rows<T><<<n_rows, QTHREADS, 0, s>>>(xt, d, nullptr, gate, n_experts,
                                            TM, xq, xs);
  RETURN_IF_ERROR();
  dense_gemm<true, true, T, float><<<grid1, THREADS, 0, s>>>(
      nullptr, xq, xs, gate, n_rows, q1, s1, g1, bias1, n_experts, layer, d,
      h, static_cast<float*>(hidden));
  RETURN_IF_ERROR();
  quant_rows<float><<<n_rows, QTHREADS, 0, s>>>(
      static_cast<const float*>(hidden), h, nullptr, gate, n_experts, TM, hq,
      hs);
  RETURN_IF_ERROR();
  dense_gemm<true, false, T, T><<<grid2, THREADS, 0, s>>>(
      nullptr, hq, hs, gate, n_rows, q2, s2, g2, bias2, n_experts, layer, h,
      d, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
