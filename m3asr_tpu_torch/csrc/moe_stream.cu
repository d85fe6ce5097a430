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
// in K6 (moe_q4.cu), the grid is (expert x output column block): each
// block gathers the rows routed to its expert (warp ballots,
// collect_rows) and computes only those, in tiles of TM rows read in
// place; a block whose expert has no rows reads only the gate vector.
// GEMM2's grid has one more expert slot, which writes the zeros of rows
// of no expert. Each row has one expert, so no atomics are needed.
//
//     hidden[rows of e] = silu(x[rows of e] @ w1[e] + b1[e])   GEMM1
//     out[rows of e]    = hidden[rows of e] @ w2[e] + b2[e]    GEMM2
//
// Rounding points, the TPU kernel's (pallas_moe.py:100-131): the weights
// are taken in the compute type cdt (x's type): float weights as they
// are; int8 weights as cdt(cdt(q) * cdt(scale)), the scale and the
// product both rounded to cdt. Products sum in float32 (fp32 weights:
// plain float32 FMAs, no TF32), the float32 bias b1 is added, SiLU runs
// in float32 and the hidden is rounded to cdt; GEMM2 likewise, with the
// float32 bias b2, and the output is rounded to cdt.
//
// What bounds it on an H100: the bytes of the active experts' weights
// (d=512, h=1024: 4 MiB per expert in fp32, 2 MiB bf16, 1 MiB int8) at
// 3.35 TB/s. Each active expert's weights are read once per TM-row tile
// of its rows: once at small token counts, more often (from L2) beyond.
//
// Simple on purpose: float32 FMAs, no tensor cores, TMA or pipelining.

#include "moe_common.cuh"

using namespace moe;

namespace {

// Weight (k, n) of one expert's (K, N) matrix in the compute type T,
// widened to float: float weights as they are, int8 weights scaled by
// their column's scale, rounded to T as in the TPU kernel.
template <typename T, typename W>
struct Weight {
  static __device__ __forceinline__ float get(const W* w, const float*,
                                              size_t kn, int) {
    return to_f(w[kn]);
  }
};

template <typename T>
struct Weight<T, int8_t> {
  static __device__ __forceinline__ float get(const int8_t* w,
                                              const float* scale, size_t kn,
                                              int n) {
    const float s = to_f(from_f<T>(scale[n]));
    return to_f(from_f<T>(__fmul_rn((float)w[kn], s)));
  }
};

// One TM x BN tile of act(rows @ W + bias) for the gathered rows `rows`
// (-1: an empty slot, read as zeros and not stored).
template <typename T, typename W, bool SILU>
__device__ __forceinline__ void stream_tile(
    const T* __restrict__ a, const int* rows, const W* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias, int K,
    int N, int n0, T* __restrict__ out) {
  __shared__ float xs[TM][BK + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < TM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int row = rows[r];
      xs[r][c] = row < 0 ? 0.f : to_f(a[(size_t)row * K + k0 + c]);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      ws[r][c] = Weight<T, W>::get(w, scale, (size_t)(k0 + r) * N + n0 + c,
                                   n0 + c);
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
    const int row = rows[2 * ty + i];
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      float v = acc[i][j];
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      if (SILU) v = silu(v);
      out[(size_t)row * N + n] = from_f<T>(v);
    }
  }
}

// GEMM over the rows of each expert: grid (E [+1], N / BN).
template <typename T, typename W, bool SILU>
__global__ void __launch_bounds__(THREADS)
    stream_gemm(const T* __restrict__ a, const int32_t* __restrict__ gate,
                int n_rows, const W* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias, int n_experts, int K, int N,
                T* __restrict__ out) {
  __shared__ int list[THREADS];
  __shared__ int warp_count[THREADS / 32];
  __shared__ int rows[TM];
  const int e = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int ew = e % n_experts;  // e == n_experts reads no weights
  const W* we = w + (size_t)ew * K * N;
  const float* se = scale == nullptr ? nullptr : scale + (size_t)ew * N;
  const float* be = bias == nullptr ? nullptr : bias + (size_t)ew * N;
  for (int base = 0; base < n_rows; base += THREADS) {
    const int m = collect_rows(gate, n_rows, base, e, n_experts, list,
                               warp_count);
    if (e == n_experts) {  // rows of no expert: zeros
      for (int i = threadIdx.x; i < m * BN; i += THREADS)
        out[(size_t)list[i / BN] * N + n0 + i % BN] = from_f<T>(0.f);
      continue;
    }
    for (int c0 = 0; c0 < m; c0 += TM) {
      if (threadIdx.x < TM)
        rows[threadIdx.x] = c0 + threadIdx.x < m ? list[c0 + threadIdx.x] : -1;
      __syncthreads();
      stream_tile<T, W, SILU>(a, rows, we, se, be, K, N, n0, out);
      __syncthreads();  // rows is rewritten by the next tile
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const int32_t* gate, int n_rows, const void* w1,
           const float* s1, const float* b1, const void* w2, const float* s2,
           const float* b2, int n_experts, int d, int h, void* hidden,
           void* out, cudaStream_t s) {
  const dim3 grid1(n_experts, h / BN), grid2(n_experts + 1, d / BN);
  stream_gemm<T, W, true><<<grid1, THREADS, 0, s>>>(
      static_cast<const T*>(x), gate, n_rows, static_cast<const W*>(w1), s1,
      b1, n_experts, d, h, static_cast<T*>(hidden));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stream_gemm<T, W, false><<<grid2, THREADS, 0, s>>>(
      static_cast<const T*>(hidden), gate, n_rows, static_cast<const W*>(w2),
      s2, b2, n_experts, h, d, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int moe_stream_col_block() { return BN; }
int moe_stream_k_step() { return BK; }

// dtype: 0 = float32, 1 = bfloat16 (x, the hidden, out, float weights);
// quant != 0: int8 weights with float32 scales s1 (E, h) / s2 (E, d),
// else weights of x's type (s1, s2 unused). x (n_rows, d), gate
// (n_rows,) int32, w1 (E, d, h), w2 (E, h, d); b1 (E, h) / b2 (E, d)
// float32 or null; hidden (n_rows, h) scratch; out (n_rows, d). Returns
// cudaGetLastError() of the launches (0 on success).
int moe_stream(int dtype, int quant, const void* x, const int32_t* gate,
               int n_rows, const void* w1, const float* s1, const float* b1,
               const void* w2, const float* s2, const float* b2,
               int n_experts, int d, int h, void* hidden, void* out,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (dtype == 0 && !quant)
    return launch<float, float>(x, gate, n_rows, w1, s1, b1, w2, s2, b2,
                                n_experts, d, h, hidden, out, s);
  if (dtype == 0)
    return launch<float, int8_t>(x, gate, n_rows, w1, s1, b1, w2, s2, b2,
                                 n_experts, d, h, hidden, out, s);
  if (dtype == 1 && !quant)
    return launch<BF, BF>(x, gate, n_rows, w1, s1, b1, w2, s2, b2,
                          n_experts, d, h, hidden, out, s);
  if (dtype == 1)
    return launch<BF, int8_t>(x, gate, n_rows, w1, s1, b1, w2, s2, b2,
                              n_experts, d, h, hidden, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
