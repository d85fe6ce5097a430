// Device code shared by the expert-FFN kernels (K1, K4-K8): the token
// tile height, the quantized weight formats, type conversions, SiLU, and
// the per-row int8 quantization of the a8 modes (K4-K7). The tiles
// themselves are in expert_tiles.cuh.
//
// Rounding contract (the JAX package's, pallas_moe_runs.py:114-136 and
// pallas_moe_q4.py:80-187): quantized weights are never multiplied by
// their scales in the compute type, except where the TPU kernel does so
// (K7 and K8 weight-only, expert_tiles.cuh DEQ). Integer weight values
// meet the activations in float32 sums (weight-only) or s32 sums (a8); a
// scale multiplies the partial sum of its group (the whole contraction
// for int8, 32- to 128-row groups for int4). Scale and bias steps use
// __fmul_rn / __fadd_rn so that nvcc does not contract them into FMAs,
// which would round differently from the PyTorch plain versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

constexpr int TM = 32;        // rows per token tile
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

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
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
