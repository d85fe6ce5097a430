// Device code shared by the expert-FFN kernels: the weight loaders of
// the two quantized formats, the a8 tile on __dp4a with its scale-group
// epilogue (moe_q4_tiled.cu: K7; the tensor-core tiles of
// expert_tiles.cuh keep its rounding order), and the per-row int8
// quantization of the a8 modes (K4-K7).
//
// tile_gemm_s8: a block of THREADS threads computes one TM x BN output
// tile: 32 rows of one expert's tokens x 64 output columns. Each thread
// owns 2 rows x 4 columns. The contraction runs in BK-row slices staged
// in shared memory. A tile's rows are row0 .. row0+TM-1 of a padded
// buffer (the run-length layout).
//
// Rounding contract (the JAX package's, pallas_moe_runs.py:114-136 and
// pallas_moe_q4.py:80-187): quantized weights are never multiplied by
// their scales in the compute type. Integer weight values (exact in
// float32) meet the activations in float32 sums (weight-only) or s32
// sums (a8); a scale multiplies the partial sum of its group (the whole
// contraction for int8, 128-row groups for int4). Scale and bias steps
// use __fmul_rn / __fadd_rn so that nvcc does not contract them into
// FMAs, which would round differently from the PyTorch plain versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

constexpr int TM = 32;        // rows per token tile
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // contraction slice staged per step
constexpr int THREADS = 256;  // 16 x 16: each thread owns 2 rows x 4 cols
constexpr int QTHREADS = 128; // threads per row of quant_rows

// Quantized weight formats: int8 values, or int4 values packed two per
// byte in the concat-half layout (byte j of a row holds column j in its
// low nibble and column j + N/2 in its high nibble; ops/quant.py
// pack_int4). The codes are the wrappers' (ops/moe_runs.py _FMT_CODE).
enum WFmt { W_Q8 = 1, W_Q4 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Base of expert row `er` (= layer * E + e) of a (L*E | E, K, N) weight.
template <int F>
__device__ __forceinline__ const int8_t* expert_w(const int8_t* w, int er,
                                                  int K, int N) {
  return w + (size_t)er * K * (F == W_Q8 ? N : N / 2);
}

// Integer weight value (k, n) of one expert's (K, N) matrix, int8 or a
// sign-extended nibble: lo = ((p & 15) ^ 8) - 8, hi = ((p >> 4) ^ 8) - 8.
template <int F>
__device__ __forceinline__ int wq(const int8_t* w, int k, int n, int N) {
  if (F == W_Q8) return w[(size_t)k * N + n];
  const int half = N / 2;
  const bool lo = n < half;
  const uint8_t b = (uint8_t)w[(size_t)k * half + (lo ? n : n - half)];
  const int nib = lo ? (b & 15) : (b >> 4);
  return (nib ^ 8) - 8;
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// A rows are int8 with float32 row scales `as`, weights are int8 (F ==
// W_Q8, one group) or int4 values; s8 x s8 products sum in
// s32 with __dp4a, four contraction rows per instruction (exact: |sum| <
// 127 * 127 * K). Epilogue in the JAX package's order:
//   int8: (float(sum) * as[row]) * scale[0, n]      (pallas_moe_runs.py:287)
//   int4: (sum_g float(sum_g) * scale[g, n]) * as[row]
//                                                  (pallas_moe_q4.py:183-187)
// then + bias, optional SiLU, optional clamp at `upper`, store. T is the
// bias type.
template <int F, bool SILU, typename T, typename OutT>
__device__ __forceinline__ void tile_gemm_s8(
    const int8_t* __restrict__ aq, const float* __restrict__ as, int row0,
    const int8_t* __restrict__ w,
    const float* __restrict__ scale, int G, const T* __restrict__ bias, int K,
    int N, int n0, OutT* __restrict__ out, bool clamp = false,
    float upper = 0.f) {
  __shared__ __align__(16) int8_t xq[TM][BK];
  // transposed weight slice; rows padded to 36 bytes so the 16 column
  // threads of a row read 16 different banks
  __shared__ __align__(16) int8_t wt[BN][BK + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int gs = K / G;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  float tot[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // TM x BK bytes: one 4-byte word per thread
      const int r = tid / (BK / 4), c4 = tid % (BK / 4);
      const int row = row0 + r;
      reinterpret_cast<int*>(xq[r])[c4] =
          *reinterpret_cast<const int*>(aq + (size_t)row * K + k0 + 4 * c4);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      wt[c][r] = (int8_t)wq<F>(w, k0 + r, n0 + c, N);
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      const int a0 = reinterpret_cast<const int*>(xq[2 * ty])[k4];
      const int a1 = reinterpret_cast<const int*>(xq[2 * ty + 1])[k4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = *reinterpret_cast<const int*>(&wt[tx + 16 * j][4 * k4]);
        acc[0][j] = __dp4a(a0, b, acc[0][j]);
        acc[1][j] = __dp4a(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
    if (F == W_Q4 && (k0 + BK) % gs == 0) {  // end of an int4 group
      const float* sg = scale + (size_t)((k0 + BK) / gs - 1) * N + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = sg[tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tot[i][j] = __fadd_rn(tot[i][j], __fmul_rn((float)acc[i][j], s));
          acc[i][j] = 0;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 2 * ty + i;
    const float ar = as[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      float v = F == W_Q8
                    ? __fmul_rn(__fmul_rn((float)acc[i][j], ar), scale[n])
                    : __fmul_rn(tot[i][j], ar);
      if (bias != nullptr) v = __fadd_rn(v, to_f(bias[n]));
      if (SILU) v = silu(v);
      if (clamp) v = fminf(v, upper);
      out[(size_t)row * N + n] = from_f<OutT>(v);
    }
  }
}

// Per-row symmetric int8 quantization (pallas_moe_q4.py::_quant_rows):
//   s = amax > 0 ? amax / 127 : 1,  q = clamp(rint(v / s), -127, 127)
// in float32 with IEEE division; rint rounds half to even as np.round
// and jnp.round do. One block per row of `in` (K values). Rows past the
// last real tile (starts != nullptr; tiles of tile_rows rows) or with no
// expert (gate != nullptr) are skipped: nothing reads them.
template <typename T>
__global__ void __launch_bounds__(QTHREADS)
    quant_rows(const T* __restrict__ in, int K,
               const int32_t* __restrict__ starts,
               const int32_t* __restrict__ gate, int n_experts,
               int tile_rows, int8_t* __restrict__ q, float* __restrict__ s) {
  const int row = blockIdx.x;
  if (starts != nullptr && row >= starts[n_experts] * tile_rows) return;
  if (gate != nullptr && (gate[row] < 0 || gate[row] >= n_experts)) return;
  const T* r = in + (size_t)row * K;
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += QTHREADS)
    m = fmaxf(m, fabsf(to_f(r[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float wmax[QTHREADS / 32];
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = m;
  __syncthreads();
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < QTHREADS / 32; ++i) amax = fmaxf(amax, wmax[i]);
  const float sc = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  for (int k = threadIdx.x; k < K; k += QTHREADS) {
    const float v = rintf(__fdiv_rn(to_f(r[k]), sc));
    q[(size_t)row * K + k] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
  if (threadIdx.x == 0) s[row] = sc;
}

}  // namespace moe
