// The row-tile front of the dense streamers (moe_q4.cu: K6;
// moe_stream.cu: K8): one small kernel that turns the gate vector into
// tiles of one expert's rows, on the device, so that the GEMMs spread a
// heavy expert's rows over as many blocks as it has tiles, and the host
// never learns the routing.
//
// row_tiles (one block of FRONT_THREADS) reads gate[N] twice. The first
// pass counts the rows of each bucket (expert e for a gate in [0, E), and
// bucket E for a row of no expert: a gate outside [0, E), the JAX
// wrapper's -1 padding); a warp scan turns the counts into each bucket's
// first list slot and each expert's first tile. The second pass scatters
// the rows into `order`, experts in order, ascending rows within each
// (stable: chunks, warps and lanes in row order; __match_any_sync gives a
// lane its rank among the warp's rows of its bucket). No atomics: a
// warp's count of each bucket goes through shared memory, summed in warp
// order. Its int32 words (the wrapper's scratch, front_ints of them):
//
//   [0]                      real tiles
//   [1]                      rows of no expert
//   [4, 4 + N)               order: the experts' rows, then the rows of
//                            no expert (the last [1] slots)
//   then 3 arrays of max_tiles: each tile's expert, first slot of order,
//                            and rows (1 .. TM)
//
// max_tiles = min(N, ceil(N / TM) + E) bounds the real tiles (every tile
// has a row; an expert wastes less than one tile). The GEMMs' grids are
// that static worst case x column blocks; a block past the last real
// tile exits before touching memory but the front's first word, as K1's
// blocks past starts[E] do. GEMM2 has one more tile slot, which writes
// the zeros of the rows of no expert.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_common.cuh"

namespace moe {

constexpr int FRONT_THREADS = 1024;
constexpr int FRONT_BUCKETS = 128;  // experts + the rows of no expert
constexpr int FRONT_MAX_EXPERTS = FRONT_BUCKETS - 1;
constexpr int FRONT_HEAD = 4;

__host__ __device__ inline int front_max_tiles(int n_rows, int n_experts) {
  const int bound = (n_rows + TM - 1) / TM + n_experts;
  return n_rows < bound ? n_rows : bound;
}
__host__ __device__ inline int front_ints(int n_rows, int n_experts) {
  return FRONT_HEAD + n_rows + 3 * front_max_tiles(n_rows, n_experts);
}

// the bucket of row r, or -1 past the rows
__device__ __forceinline__ int front_bucket(const int32_t* __restrict__ gate,
                                            int r, int n_rows,
                                            int n_experts) {
  if (r >= n_rows) return -1;
  const int g = gate[r];
  return g >= 0 && g < n_experts ? g : n_experts;
}

__global__ void __launch_bounds__(FRONT_THREADS)
    row_tiles(const int32_t* __restrict__ gate, int n_rows, int n_experts,
              int32_t* __restrict__ front) {
  constexpr int WARPS = FRONT_THREADS / 32, PER = FRONT_BUCKETS / 32;
  __shared__ int wc[WARPS][FRONT_BUCKETS];  // a chunk's rows per warp
  __shared__ int cnt[FRONT_BUCKETS], slot[FRONT_BUCKETS],
      tile0[FRONT_BUCKETS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = n_experts + 1;
  const int max_tiles = front_max_tiles(n_rows, n_experts);
  int32_t* order = front + FRONT_HEAD;
  int32_t* tile_e = order + n_rows;
  int32_t* tile_s = tile_e + max_tiles;
  int32_t* tile_n = tile_s + max_tiles;
  for (int i = tid; i < WARPS * FRONT_BUCKETS; i += FRONT_THREADS)
    (&wc[0][0])[i] = 0;
  __syncthreads();

  // Each chunk: every warp's rows of each bucket into wc (by the lowest
  // lane of the bucket in the warp), then thread b folds and clears
  // column b.
  int total = 0;  // thread b < nb: rows of bucket b
  for (int base = 0; base < n_rows; base += FRONT_THREADS) {
    const int b = front_bucket(gate, base + tid, n_rows, n_experts);
    const unsigned same = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(same) - 1) wc[warp][b] = __popc(same);
    __syncthreads();
    if (tid < nb)
      for (int w = 0; w < WARPS; ++w) {
        total += wc[w][tid];
        wc[w][tid] = 0;
      }
    __syncthreads();
  }
  if (tid < nb) cnt[tid] = total;
  if (tid == n_experts) front[1] = total;
  __syncthreads();

  // exclusive scans of the slots and of the experts' tiles, one warp
  if (warp == 0) {
    int c[PER], t[PER], cs = 0, ts = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int b = lane * PER + i;
      c[i] = b < nb ? cnt[b] : 0;
      t[i] = b < n_experts ? (c[i] + TM - 1) / TM : 0;
      cs += c[i];
      ts += t[i];
    }
    int ci = cs, ti = ts;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int cu = __shfl_up_sync(0xffffffffu, ci, off);
      const int tu = __shfl_up_sync(0xffffffffu, ti, off);
      if (lane >= off) {
        ci += cu;
        ti += tu;
      }
    }
    if (lane == 31) front[0] = ti;
    ci -= cs;
    ti -= ts;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int b = lane * PER + i;
      if (b < nb) {
        slot[b] = ci;
        tile0[b] = ti;
      }
      ci += c[i];
      ti += t[i];
    }
  }
  __syncthreads();

  // expert e's tiles: thread e writes them, TM rows each, the last short
  if (tid < n_experts)
    for (int i = 0, t = tile0[tid]; i < cnt[tid]; i += TM, ++t) {
      tile_e[t] = tid;
      tile_s[t] = slot[tid] + i;
      tile_n[t] = min(TM, cnt[tid] - i);
    }

  // The scatter: a row's slot is its bucket's next free slot, plus the
  // rows of its bucket in earlier warps of the chunk, plus its rank in
  // its warp. Thread b then moves bucket b's next slot past the chunk.
  for (int base = 0; base < n_rows; base += FRONT_THREADS) {
    const int r = base + tid;
    const int b = front_bucket(gate, r, n_rows, n_experts);
    const unsigned same = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(same & ((1u << lane) - 1u));
    if (b >= 0 && rank == 0) wc[warp][b] = __popc(same);
    __syncthreads();
    if (b >= 0) {
      int off = slot[b] + rank;
      for (int w = 0; w < warp; ++w) off += wc[w][b];
      order[off] = r;
    }
    __syncthreads();
    if (tid < nb)
      for (int w = 0; w < WARPS; ++w) {
        slot[tid] += wc[w][tid];
        wc[w][tid] = 0;
      }
    __syncthreads();
  }
}

// Launches row_tiles; cudaErrorInvalidValue for more experts than its
// buckets hold.
inline cudaError_t launch_row_tiles(const int32_t* gate, int n_rows,
                                    int n_experts, int32_t* front,
                                    cudaStream_t s) {
  if (n_experts < 1 || n_experts > FRONT_MAX_EXPERTS)
    return cudaErrorInvalidValue;
  row_tiles<<<1, FRONT_THREADS, 0, s>>>(gate, n_rows, n_experts, front);
  return cudaGetLastError();
}

// Block t's tile: its expert, and its rows in `rows` (shared memory, TM
// slots; -1 past the tile's rows). Returns the tile's row count, or 0
// when t lies past the last real tile (then nothing else is read). Every
// thread of the block calls it; it syncs the block once.
__device__ __forceinline__ int front_tile(const int32_t* __restrict__ front,
                                          int n_rows, int max_tiles, int t,
                                          int* rows, int& expert) {
  if (t >= front[0]) return 0;
  const int32_t* order = front + FRONT_HEAD;
  const int32_t* tile_e = order + n_rows;
  expert = tile_e[t];
  const int slot0 = tile_e[max_tiles + t], m = tile_e[2 * max_tiles + t];
  const int r = threadIdx.x;
  if (r < TM) rows[r] = r < m ? order[slot0 + r] : -1;
  __syncthreads();
  return m;
}

// GEMM2's extra tile slot: zeros in columns [n0, n0 + bn) of every row of
// no expert, by a block of `threads` threads.
template <typename OutT>
__device__ __forceinline__ void front_zero_rows(
    const int32_t* __restrict__ front, int n_rows, int N, int n0, int bn,
    int threads, OutT* __restrict__ out) {
  const int m = front[1];
  const int32_t* none = front + FRONT_HEAD + n_rows - m;
  for (int i = threadIdx.x; i < m * bn; i += threads)
    out[(size_t)none[i / bn] * N + n0 + i % bn] = from_f<OutT>(0.f);
}

}  // namespace moe
