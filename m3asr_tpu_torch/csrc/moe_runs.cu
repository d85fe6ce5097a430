// Top-1 expert FFN over per-expert token tiles ("run-length" layout),
// float weights (fp32 or bf16) with float32 accumulation.
//
// Replaces m3asr_tpu/ops/pallas_moe_runs.py::moe_experts_pallas_runs /
// _runs_kernel, fmt "f". The wrapper (m3asr_tpu_torch/ops/moe_runs.py)
// sorts tokens by expert on the device and pads each expert's group to
// a multiple of TM rows, so every tile of TM rows belongs to one expert
// (tile_e[t]). For the tiles of each expert that has tokens:
//
//     hidden = silu(x_tile @ w1[e] + b1[e])      launch 1 (SILU = true)
//     y_tile = hidden @ w2[e] + b2[e]            launch 2 (SILU = false)
//
// What bounds it on an H100: the bytes of the ACTIVE experts' weights.
// At the flagship widths (d=512, h=1024) one expert is 4 MiB in fp32 and
// 2 MiB in bf16; at 63 tokens the FLOPs are negligible next to that.
// The design reads each active expert's weights once per tile of that
// expert (one block per tile x column block, the weight k-slices staged
// in shared memory) and never reads an idle expert's: no tile maps to it.
// The grid is the static worst case of tiles; blocks past the last real
// tile (starts[E]) exit before touching memory, so the host never has
// to learn the routing.
//
// Stacked weights: w1/w2 are the (L*E, K, N) base pointers and `layer`
// selects rows layer*E .. layer*E + E - 1, so no per-layer copy exists.
// Biases are this layer's (E, N) slices.
//
// Types: fp32 runs plain FMAs (no TF32); bf16 loads convert with
// __bfloat162float and accumulate in float32. The hidden scratch and the
// output are in the weight type, as the TPU kernel rounds them.
//
// Simple on purpose: no tensor cores, TMA or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;        // rows per token tile (the layout's tile)
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // contraction slice staged per step
constexpr int THREADS = 256;  // 16 x 16: each thread owns 2 rows x 4 cols

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

// out[t*TM + r, n] = act(sum_k a[t*TM + r, k] * w[layer*E + e, k, n]
//                        + bias[e, n]),  e = tile_e[t]
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

template <typename T>
int launch(const void* x_pad, const void* w1, const void* b1,
           const void* w2, const void* b2, const int32_t* tile_e,
           const int32_t* starts, int n_tiles, int n_experts, int layer,
           int d, int h, void* hidden, void* y_pad, cudaStream_t stream) {
  const dim3 block(THREADS);
  expert_tile_gemm<T, true><<<dim3(n_tiles, h / BN), block, 0, stream>>>(
      static_cast<const T*>(x_pad), static_cast<const T*>(w1),
      static_cast<const T*>(b1), tile_e, starts, n_experts, layer, d, h,
      static_cast<T*>(hidden));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  expert_tile_gemm<T, false><<<dim3(n_tiles, d / BN), block, 0, stream>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(w2),
      static_cast<const T*>(b2), tile_e, starts, n_experts, layer, h, d,
      static_cast<T*>(y_pad));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile rows, column block and contraction step the wrapper must honour.
int moe_runs_tile_rows() { return TM; }
int moe_runs_col_block() { return BN; }
int moe_runs_k_step() { return BK; }

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the
// two launches (0 on success). All pointers are device pointers.
int moe_runs_f(int dtype, const void* x_pad, const void* w1, const void* b1,
               const void* w2, const void* b2, const int32_t* tile_e,
               const int32_t* starts, int n_tiles, int n_experts, int layer,
               int d, int h, void* hidden, void* y_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x_pad, w1, b1, w2, b2, tile_e, starts, n_tiles,
                         n_experts, layer, d, h, hidden, y_pad, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x_pad, w1, b1, w2, b2, tile_e, starts,
                                 n_tiles, n_experts, layer, d, h, hidden,
                                 y_pad, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
