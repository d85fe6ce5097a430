// The expert-FFN tiles on the tensor cores and on FMA patches, shared by
// the run-length kernels (moe_runs.cu: K1, K4, K5), the dense streamers
// (moe_q4.cu: K6; moe_stream.cu: K8) and the tiled int4 grouped GEMM
// (moe_q4_tiled.cu: K7).
//
// A tile is TM = 32 rows of one expert's tokens x 64 output columns. Its
// rows are either rows 0 .. TM - 1 of a tile base (GATHER false: the
// run-length and tiled layouts' padded rows) or the rows listed in `rows`
// (GATHER true: TM slots in shared memory, -1 for an empty slot), read in
// place from the matrix base and stored in place (the dense streamers'
// rows of one expert, from the row-tile front of row_tiles.cuh). An empty
// slot is copied as zeros (a cp.async of 0 bytes) and never stored.
//
// The run-length kernels have 20-60 real tiles at the serving token
// counts, so a launch has a few hundred live blocks, each with little
// work: what counts is keeping enough loads in flight per block, and no
// block waiting on its own loads. Blocks are 32 rows x 64 columns; d and
// h must be multiples of 64. 128-column blocks were within a few percent
// either way at 63-1020 tokens (PERF.md, section 6), so there is one.
// - Float weights, bf16 (tile_mma): mma.sync m16n8k16 with float32 sums,
//   A fragments by ldmatrix from the staged activation slice, B fragments
//   by ldmatrix.trans from the staged row-major (BK, F_BN) weight slice. 4
//   warps; warp w owns all 32 rows x columns [16 w, 16 w + 16). BK = 64;
//   a 4-stage cp.async ring (16-byte copies) keeps three slices in flight
//   while one is multiplied. Shared rows are padded by 16 bytes, so the
//   8 rows of each ldmatrix phase fall in 8 different bank groups.
// - Float weights, float32 (tile_fma): FMAs (no TF32: the port's
//   precision decision). A thread owns 4 rows x 4 columns; per 4 k, four
//   float4 loads of activations (one per row) and four of weights feed 64
//   FMAs. Each output keeps one accumulator, summed in ascending k, so K1
//   and K8 agree bit for bit (chip_smoke.py holds them equal). BK = 32, a
//   3-stage cp.async ring; 128 threads. A warp whose rows all lie past
//   the tile's tokens (`live`) skips its FMAs: nothing reads those rows.
//   4 x 8 patches (half the threads) were slower at 63 and 511 tokens,
//   and a 4-stage ring no better overall (PERF.md, section 6). Quantized
//   weights on float32 activations stage the raw slice and take each
//   weight as q * scale in float32 before its FMA: K8's int8 (one scale
//   a column) and K7's packed int4 (Q4x2: a scale a column and group,
//   the block's 32 packed bytes a row holding its 64 columns).
// - Quantized weights (tile_q_mma, tile_q_s8): a half to a quarter of
//   bf16's weight bytes, the same block shape (4 warps of 32 rows x 16
//   columns), a cp.async ring of 64-deep slices and 16-byte row padding.
//   The ring has 3 stages weight-only, 4 a8: 3 beat 4 by 3-10%
//   weight-only and by at most 4% a8, 6 and 8 stages lost, and the
//   3-stage int8 a8 build spilled (PERF.md, section 6). The weight slice
//   is copied raw (64 int8 or 32 packed bytes a row); each lane builds
//   its own B fragments from it in registers:
//   - weight-only: bf16 mma.sync m16n8k16 into float32; int8 and int4
//     values are exact in bf16 (q_widen builds them from magic-number
//     float or bf16 bits, without int-to-float conversions). Each group's
//     float32 sums are folded at its end, which may fall inside a slice
//     (32-row groups), in ascending g. DEQ instead takes each weight
//     dequantized to bf16 before the product, as the TPU kernels of K8
//     and K7 round it, with one float32 sum and no fold: K8's int8 as
//     bf16(q * bf16(scale[0, n])), K7's int4 as bf16(q * scale[g, n])
//     (the float32 scale, reloaded at each group end).
//   - a8: s8 mma.sync m16n8k32 into s32 on quant_rows' int8 rows; each
//     lane gathers its column's four k-neighbours with byte permutes
//     (q_gather); an int4 nibble goes in as 16 q, and the exact sum is
//     shifted back. The epilogue runs in the JAX package's order (at
//     tile_q_s8), so K5, K6 and K7 w4a8 agree bit for bit.
//   - int4: a block's 32 packed bytes a row hold its 64 columns (32 low
//     nibbles, 32 high ones, N/2 apart), so every byte is read by one
//     block.
//
// Rounding contract of the float tiles: float32 sums, the bias added in
// float32 before v / (1 + expf(-v)), the output rounded to its type.
// Every tile takes an optional clamp, min(v, upper) after the activation
// (K7's upper_bound), off by default.

#pragma once

#include <type_traits>

#include "mma_common.cuh"
#include "moe_common.cuh"

namespace moe {

using bf16 = __nv_bfloat16;
using mma::cp_async16;
using mma::cp_async_commit;
using mma::cp_async_wait;

// Source row of tile row r (clamped to 0 for an empty slot, which copies
// nothing) and whether it holds a token.
template <bool GATHER>
__device__ __forceinline__ int src_row(const int* rows, int r) {
  return GATHER ? max(rows[r], 0) : r;
}
template <bool GATHER>
__device__ __forceinline__ bool has_row(const int* rows, int r) {
  return !GATHER || rows[r] >= 0;
}
// Destination row of tile row r, or -1 for an empty slot.
template <bool GATHER>
__device__ __forceinline__ int dst_row(const int* rows, int r) {
  return GATHER ? rows[r] : r;
}

// ---------------------------------------------------------------------------
// Float weights: out[r, n] = act(sum_k a[r, k] * w[k, n] + bias[n])
// ---------------------------------------------------------------------------

constexpr int F_BN = 64;  // column block; d and h must be multiples

// Packed int4 weights of tile_fma: byte c of a row holds column c in its
// low nibble and column c + N/2 in its high nibble (ops/quant.py
// pack_int4), so one element stands for two columns.
struct Q4x2 {
  int8_t v;
};
template <typename W>
constexpr int W_COLS = std::is_same<W, Q4x2>::value ? 2 : 1;

// Shared layout of one pipeline stage: a TM x BK activation slice (row
// stride XLD) and a BK x F_BN weight slice (row stride WLD), elements of
// T; quantized weights (W) take their raw F_BN / W_COLS bytes a row.
template <typename T>
struct FTile;
template <>
struct FTile<bf16> {  // tensor cores
  static constexpr int BK = 64, STAGES = 4, THREADS = 128;
  static constexpr int XLD = BK + 8, WLD = F_BN + 8;
};
template <>
struct FTile<float> {  // FMAs: 4 x 4 outputs a thread
  static constexpr int BK = 32, STAGES = 3, THREADS = TM / 4 * F_BN / 4;
  static constexpr int XLD = BK + 4, WLD = F_BN;
};
template <typename T, typename W = T>
struct FLayout : FTile<T> {
  using C = FTile<T>;
  static constexpr bool SAME = std::is_same<T, W>::value;
  static constexpr int WLDW = SAME ? C::WLD : F_BN / W_COLS<W>;  // of W
  static constexpr int X = TM * C::XLD;
  static constexpr int STAGE =
      X + C::BK * WLDW * (int)sizeof(W) / (int)sizeof(T);
  static constexpr int bytes = C::STAGES * STAGE * (int)sizeof(T);
  static_assert(F_BN % C::BK == 0, "K steps must divide 64");
  static_assert(STAGE * sizeof(T) % 16 == 0 && X * sizeof(T) % 16 == 0,
                "16-byte aligned stages");
};

// One stage: the activation slice [k0, k0 + BK) of the tile's TM rows
// (at: the tile base, or with GATHER the matrix base) and the weight
// slice of rows [k0, k0 + BK), the block's F_BN columns (we points at
// column n0, or packed byte n0 / 2), by 16-byte cp.async; neighbouring
// threads copy neighbouring chunks of a row.
template <typename T, typename W, bool GATHER>
__device__ __forceinline__ void f_stage(T* xs, const T* __restrict__ at,
                                        const int* rows,
                                        const W* __restrict__ we, int K,
                                        int N, int k0) {
  using C = FLayout<T, W>;
  constexpr int V = 16 / (int)sizeof(T);  // elements per chunk
  constexpr int VW = 16 / (int)sizeof(W);
  constexpr int XC = C::BK / V, WC = F_BN / W_COLS<W> / VW;
  constexpr int WN = C::BK * WC;  // weight chunks a stage
  static_assert(TM * XC % C::THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < TM * XC / C::THREADS; ++j) {
    const int i = threadIdx.x + j * C::THREADS, r = i / XC, c = i % XC;
    cp_async16(xs + r * C::XLD + c * V,
               at + (size_t)src_row<GATHER>(rows, r) * K + k0 + c * V,
               has_row<GATHER>(rows, r));
  }
  W* ws = reinterpret_cast<W*>(xs + C::X);
#pragma unroll
  for (int j = 0; j < (WN + C::THREADS - 1) / C::THREADS; ++j) {
    const int i = threadIdx.x + j * C::THREADS, r = i / WC, c = i % WC;
    if (WN % C::THREADS == 0 || i < WN)
      cp_async16(ws + r * C::WLDW + c * VW,
                 we + (size_t)(k0 + r) * (N / W_COLS<W>) + c * VW, true);
  }
}

// bias (when there is one) in float32, then the SiLU of GEMM1
template <bool SILU>
__device__ __forceinline__ float f_epilogue(float v, bool has_bias, float b) {
  if (has_bias) v += b;
  return SILU ? v / (1.0f + expf(-v)) : v;
}

// bf16: warp w's 32 rows x F_BN/4 columns as 2 x NT m16n8 tiles. BT: the
// bias type (bf16 for K1, float32 for K8).
template <bool SILU, bool GATHER, typename BT>
__device__ __forceinline__ void tile_mma(const bf16* __restrict__ at,
                                         const int* rows,
                                         const bf16* __restrict__ we,
                                         const BT* __restrict__ bias,
                                         int K, int N, int n0, bf16* sm,
                                         bf16* __restrict__ out) {
  using C = FLayout<bf16>;
  constexpr int WN = F_BN / 4, NT = WN / 8;
  static_assert(NT % 2 == 0, "B fragments load in pairs");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this lane's ldmatrix row and column offset (mma_common.cuh)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  float acc[2][NT][4] = {};
  const int steps = K / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps)
      f_stage<bf16, bf16, GATHER>(sm + s * C::STAGE, at, rows, we, K, N,
                                  s * C::BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slice ks is in for all; slice ks - 1 is done with
    const int next = ks + C::STAGES - 1;
    if (next < steps)
      f_stage<bf16, bf16, GATHER>(sm + (next % C::STAGES) * C::STAGE, at,
                                  rows, we, K, N, next * C::BK);
    cp_async_commit();
    const bf16* xs = sm + (ks % C::STAGES) * C::STAGE;
    const bf16* ws = xs + C::X + warp * WN;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      uint32_t a0[4], a1[4];
      mma::ldsm_x4(a0, xs + lr * C::XLD + kk + lc);
      mma::ldsm_x4(a1, xs + (16 + lr) * C::XLD + kk + lc);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        mma::ldsm_x4_t(b, ws + (kk + lr) * C::WLD + 8 * n + lc);
        mma::mma_bf16(acc[0][n], a0, b[0], b[1]);
        mma::mma_bf16(acc[0][n + 1], a0, b[2], b[3]);
        mma::mma_bf16(acc[1][n], a1, b[0], b[1]);
        mma::mma_bf16(acc[1][n + 1], a1, b[2], b[3]);
      }
    }
  }
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + warp * WN + 8 * n + 2 * tq;
    const bool hb = bias != nullptr;
    const float b0 = hb ? to_f(bias[col]) : 0.f;
    const float b1 = hb ? to_f(bias[col + 1]) : 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = dst_row<GATHER>(rows, 16 * m + 8 * h + g);
        if (GATHER && row < 0) continue;
        const float v0 = f_epilogue<SILU>(acc[m][n][2 * h], hb, b0);
        const float v1 = f_epilogue<SILU>(acc[m][n][2 * h + 1], hb, b1);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

// float32: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and four
// neighbouring columns (8 neighbouring threads read 128 contiguous bytes
// of a float weight row); `live` rows hold tokens. W: float weights, int8
// weights taken as __fmul_rn(q, scale[n]), or packed int4 (Q4x2) taken as
// __fmul_rn(q, scale[g, n]) (scale: float32 rows of N, G groups of K / G
// rows, a multiple of BK, int8 G = 1; like `we` it points at column n0,
// or packed byte n0 / 2). Columns: 4 tx .. 4 tx + 3 of the block, or for
// Q4x2 the low (tx < 8) or high nibbles of the block's packed bytes
// 4 (tx % 8) .. + 3, as q_col maps them. clamp takes min(v, upper) after
// the activation.
template <bool SILU, bool GATHER, typename W = float>
__device__ __forceinline__ void tile_fma(
    const float* __restrict__ at, const int* rows, const W* __restrict__ we,
    const float* __restrict__ scale, int G, const float* __restrict__ bias,
    int K, int N, int n0, int live, float* sm, float* __restrict__ out,
    bool clamp = false, float upper = 0.f) {
  using C = FLayout<float, W>;
  constexpr bool Q4 = W_COLS<W> == 2;
  constexpr int CG = F_BN / 4;  // column groups
  const int tid = threadIdx.x, tx = tid % CG, ty = tid / CG;
  const int hi = Q4 && tx >= CG / 2;  // Q4x2: this thread's nibble half
  const int wc = Q4 ? 4 * (tx % (CG / 2)) : 4 * tx;  // its weight bytes
  // its first column, counted from the block's (column n0, or packed byte
  // n0 / 2, where `we` and `scale` point) and in the whole row
  const int sofs = Q4 ? wc + hi * (N / 2) : 4 * tx;
  const int col = (Q4 ? n0 / 2 : n0) + sofs;
  // the warp's first row; a warp past the tokens skips its FMAs
  const bool work = 4 * ((tid & ~31) / CG) < live;
  const int gs = K / G;
  float acc[4][4] = {};
  float sc[4] = {}, sn[4];  // the columns' scales; Q4x2: and -8 times them
  if constexpr (!C::SAME) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = scale[sofs + j];
      sn[j] = -8.f * sc[j];
    }
  }
  const int steps = K / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps)
      f_stage<float, W, GATHER>(sm + s * C::STAGE, at, rows, we, K, N,
                                s * C::BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slice ks is in for all; slice ks - 1 is done with
    const int next = ks + C::STAGES - 1;
    if (next < steps)
      f_stage<float, W, GATHER>(sm + (next % C::STAGES) * C::STAGE, at,
                                rows, we, K, N, next * C::BK);
    cp_async_commit();
    if (!work) continue;
    if (Q4 && ks > 0 && ks * C::BK % gs == 0) {  // a new scale group
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j] = scale[(size_t)(ks * C::BK / gs) * N + sofs + j];
        sn[j] = -8.f * sc[j];
      }
    }
    const float* xs = sm + (ks % C::STAGES) * C::STAGE + 4 * ty * C::XLD;
    const W* ws =
        reinterpret_cast<const W*>(sm + (ks % C::STAGES) * C::STAGE + C::X) +
        wc;
#pragma unroll
    for (int k = 0; k < C::BK; k += 4) {
      float xr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(xs + i * C::XLD + k);
        xr[i][0] = v.x;
        xr[i][1] = v.y;
        xr[i][2] = v.z;
        xr[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float wr[4];
        if constexpr (C::SAME) {
          const float4 v =
              *reinterpret_cast<const float4*>(ws + (k + kk) * C::WLDW);
          wr[0] = v.x;
          wr[1] = v.y;
          wr[2] = v.z;
          wr[3] = v.w;
        } else if constexpr (Q4) {
          // byte j: q + 8 = nibble ^ 8 of this half's column j, taken as
          // the float 2^23 + q + 8 minus 2^23; then (q + 8) s - 8 s, exact
          // before its one rounding, is __fmul_rn(q, s)
          const uint32_t u =
              ((*reinterpret_cast<const uint32_t*>(ws + (k + kk) * C::WLDW) >>
                (4 * hi)) &
               0x0F0F0F0Fu) ^
              0x08080808u;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wr[j] = __fmaf_rn(
                __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) -
                    8388608.f,
                sc[j], sn[j]);
        } else {
          const char4 q =
              *reinterpret_cast<const char4*>(ws + (k + kk) * C::WLDW);
          wr[0] = __fmul_rn((float)q.x, sc[0]);
          wr[1] = __fmul_rn((float)q.y, sc[1]);
          wr[2] = __fmul_rn((float)q.z, sc[2]);
          wr[3] = __fmul_rn((float)q.w, sc[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xr[i][kk], wr[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = dst_row<GATHER>(rows, 4 * ty + i);
    if (GATHER && row < 0) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = f_epilogue<SILU>(acc[i][j], bias != nullptr,
                              bias != nullptr ? bias[col + j] : 0.f);
      if (clamp) v[j] = fminf(v[j], upper);
    }
    *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// Quantized weights: out[r, n] = act(sum_g (a[r, group g] @ W[group g, n])
//                                    * scale[g, n] + bias[n])
// ---------------------------------------------------------------------------

constexpr int Q_BN = 64;     // output columns per block; d and h multiples
constexpr int Q_GROUP = 32;  // scale groups: multiples of 32 rows
constexpr int Q_BK = 64, Q_THREADS = 128;
constexpr int Q_STAGES_W = 3, Q_STAGES_A8 = 4;  // cp.async ring depths

// Shared layout of one pipeline stage, in bytes: the activation slice (TM
// rows of Q_BK bf16 values, or int8 with A8) and the raw weight slice
// (Q_BK rows of the block's 64 int8 or 32 packed int4 bytes), every row
// padded by 16 bytes, so the 8 rows of an ldmatrix phase, and the weight
// rows 2t of a k16 step, fall in different bank groups.
template <int F, bool A8>
struct QLayout {
  static constexpr int XLD = Q_BK * (A8 ? 1 : 2) + 16;
  static constexpr int WROW = F == W_Q8 ? Q_BN : Q_BN / 2;
  static constexpr int WLD = WROW + 16;
  static constexpr int X = TM * XLD, STAGE = X + Q_BK * WLD;
  static constexpr int STAGES = A8 ? Q_STAGES_A8 : Q_STAGES_W;
  static constexpr int bytes = STAGES * STAGE;
  static_assert(bytes <= 48 * 1024, "no dynamic shared memory opt-in");
};

// One stage: rows [k0, k0 + Q_BK) of the activation slice (a: the tile's
// first row, or with GATHER the matrix's; a_ld bytes a row) and of the
// weight slice (we: the block's first byte of weight row 0, w_ld bytes a
// row), by 16-byte cp.async.
template <int F, bool A8, bool GATHER>
__device__ __forceinline__ void q_stage(unsigned char* st,
                                        const unsigned char* __restrict__ a,
                                        const int* rows, int a_ld,
                                        const unsigned char* __restrict__ we,
                                        int w_ld, int k0) {
  using C = QLayout<F, A8>;
  constexpr int AE = A8 ? 1 : 2;  // bytes an activation
  constexpr int XC = Q_BK * AE / 16, WC = C::WROW / 16;
  static_assert(TM * XC % Q_THREADS == 0 && Q_BK * WC % Q_THREADS == 0,
                "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < TM * XC / Q_THREADS; ++j) {
    const int i = threadIdx.x + j * Q_THREADS, r = i / XC, c = i % XC;
    cp_async16(st + r * C::XLD + c * 16,
               a + (size_t)src_row<GATHER>(rows, r) * a_ld + k0 * AE + c * 16,
               has_row<GATHER>(rows, r));
  }
#pragma unroll
  for (int j = 0; j < Q_BK * WC / Q_THREADS; ++j) {
    const int i = threadIdx.x + j * Q_THREADS, r = i / WC, c = i % WC;
    cp_async16(st + C::X + r * C::WLD + c * 16,
               we + (size_t)(k0 + r) * w_ld + c * 16, true);
  }
}

// Columns. Warp w owns 16 output columns of the block as two n8 MMA tiles
// j; lane (g, t) builds column g of each tile's B fragment and holds
// columns 2t, 2t + 1 (i = 0, 1) of each tile's C fragment.
// - int8: tile j's column n is block column 16 w + 2 n + j, so lane g
//   reads the byte pair 16 w + 2 g of a weight row, and its outputs are
//   the four neighbouring columns 16 w + 4 t .. + 3.
// - int4: byte c of the block's 32 holds column j0 + c (low nibble) and
//   j0 + N/2 + c (high nibble), j0 = n0 / 2; tile 0 takes low nibbles,
//   tile 1 high, so lane g reads byte 8 w + g once for both, and every
//   packed byte is read by one block.
// q_col: the global column of C element (j, i = 0) of this lane.
template <int F>
__device__ __forceinline__ int q_col(int n0, int N, int warp, int t, int j) {
  return F == W_Q8 ? n0 + 16 * warp + 4 * t + j
                   : n0 / 2 + 8 * warp + 2 * t + j * (N / 2);
}
// the column step from C element (j, 0) to (j, 1)
template <int F>
constexpr int Q_STEP = F == W_Q8 ? 2 : 1;

// The lane's four per-column values (scales, biases) from one row p.
template <int F, typename T>
__device__ __forceinline__ void q_load(const T* __restrict__ p, int n0,
                                       int N, int warp, int t,
                                       float (&v)[2][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      v[j][i] = to_f(p[q_col<F>(n0, N, warp, t, j) + i * Q_STEP<F>]);
}

// The lane's four outputs of one row p: one 8-byte (bf16) or 16-byte
// (float) store for int8, two pairs for int4.
template <int F>
__device__ __forceinline__ void q_store(bf16* p, int n0, int N, int warp,
                                        int t, const float (&v)[2][2]) {
  if constexpr (F == W_Q8) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0][0], v[1][0]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0][1], v[1][1]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p + q_col<F>(n0, N, warp, t, 0)) = u;
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + q_col<F>(n0, N, warp, t, j)) =
          __floats2bfloat162_rn(v[j][0], v[j][1]);
  }
}
template <int F>
__device__ __forceinline__ void q_store(float* p, int n0, int N, int warp,
                                        int t, const float (&v)[2][2]) {
  if constexpr (F == W_Q8) {
    *reinterpret_cast<float4*>(p + q_col<F>(n0, N, warp, t, 0)) =
        make_float4(v[0][0], v[1][0], v[0][1], v[1][1]);
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float2*>(p + q_col<F>(n0, N, warp, t, j)) =
          make_float2(v[j][0], v[j][1]);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// int8 weight bytes (k, c), (k, c + 1) (r0) and (k + 1, c), (k + 1, c + 1)
// (r1) as exact floats, in that order: 2^23 + (q + 128) built as float
// bits, minus 2^23 + 128.
__device__ __forceinline__ void q8_floats(const unsigned char* r0,
                                          const unsigned char* r1,
                                          float (&f)[4]) {
  const uint32_t u = __byte_perm(*reinterpret_cast<const uint16_t*>(r0),
                                 *reinterpret_cast<const uint16_t*>(r1),
                                 0x5410) ^
                     0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
}

// Weight-only B fragments of weight rows k, k + 1 (r0, r1: the lane's
// bytes in them), widened to bf16 exactly: b[j] = (W[k][col j],
// W[k + 1][col j]) as bf16x2, low half first.
// int8: q8_floats. int4: 128 + (q + 8) built as bf16 bits
// (0x4300 | (nibble ^ 8)), minus 136 in bf16x2.
template <int F>
__device__ __forceinline__ void q_widen(const unsigned char* r0,
                                        const unsigned char* r1,
                                        uint32_t (&b)[2]) {
  if constexpr (F == W_Q8) {
    float f[4];
    q8_floats(r0, r1, f);
    b[0] = bf16x2_bits(__floats2bfloat162_rn(f[0], f[2]));
    b[1] = bf16x2_bits(__floats2bfloat162_rn(f[1], f[3]));
  } else {
    const uint32_t v = __byte_perm(*r0, *r1, 0x5410);  // bytes 0 and 2
    const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
    uint32_t lo = (v & 0x000F000Fu) ^ 0x43084308u;
    uint32_t hi = ((v >> 4) & 0x000F000Fu) ^ 0x43084308u;
    b[0] = bf16x2_bits(
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo), off));
    b[1] = bf16x2_bits(
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi), off));
  }
}

// The int4 value of a nibble (the low 4 bits of v) as an exact float:
// 2^23 + (q + 8) built as float bits, minus 2^23 + 8.
__device__ __forceinline__ float q4_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | ((v & 15u) ^ 8u)) - 8388616.f;
}

// DEQ: the scales of this lane's B columns (tile j's column of the lane)
// from scale row s: int8 (K8) rounded to bf16, int4 (K7) in float32.
template <int F>
__device__ __forceinline__ void q_bscale(const float* __restrict__ s, int n0,
                                         int N, int wcol, float (&bs)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    bs[j] = F == W_Q8 ? to_f(from_f<bf16>(s[n0 + wcol + j]))
                      : s[n0 / 2 + wcol + j * (N / 2)];
}

// DEQ B fragments of weight rows k, k + 1 (r0, r1: the lane's bytes in
// them): each weight as bf16(q * s), s = bs[j] its column's scale, the
// TPU kernels' rounding. int8 (K8): q * bf16(s) is exact in float32
// (8-bit by 8-bit significands), so its one rounding is the bf16 product.
// int4 (K7): the float32 product is rounded, then rounded to bf16, as
// _unpack_expert rounds it.
template <int F>
__device__ __forceinline__ void q_deq(const unsigned char* r0,
                                      const unsigned char* r1,
                                      const float (&bs)[2],
                                      uint32_t (&b)[2]) {
  if constexpr (F == W_Q8) {
    float f[4];
    q8_floats(r0, r1, f);
    b[0] = bf16x2_bits(__floats2bfloat162_rn(__fmul_rn(f[0], bs[0]),
                                             __fmul_rn(f[2], bs[0])));
    b[1] = bf16x2_bits(__floats2bfloat162_rn(__fmul_rn(f[1], bs[1]),
                                             __fmul_rn(f[3], bs[1])));
  } else {  // low nibbles: tile 0's column, high nibbles: tile 1's
    const uint32_t x0 = *r0, x1 = *r1;
    b[0] = bf16x2_bits(__floats2bfloat162_rn(__fmul_rn(q4_float(x0), bs[0]),
                                             __fmul_rn(q4_float(x1), bs[0])));
    b[1] = bf16x2_bits(
        __floats2bfloat162_rn(__fmul_rn(q4_float(x0 >> 4), bs[1]),
                              __fmul_rn(q4_float(x1 >> 4), bs[1])));
  }
}

// a8 B fragments of weight rows k .. k + 3 (r: the lane's bytes in row k,
// ld: the row stride): b[j] = W[k .. k + 3][col j] as four s8, lowest k in
// the lowest byte. int4 nibbles go in as 16 q (the nibble in the high
// half of the byte), so the s32 sums are 16x the true ones, exactly.
template <int F>
__device__ __forceinline__ void q_gather(const unsigned char* r, int ld,
                                         uint32_t (&b)[2]) {
  if constexpr (F == W_Q8) {
    const uint32_t x = __byte_perm(*reinterpret_cast<const uint16_t*>(r),
                                   *reinterpret_cast<const uint16_t*>(r + ld),
                                   0x5410);
    const uint32_t y =
        __byte_perm(*reinterpret_cast<const uint16_t*>(r + 2 * ld),
                    *reinterpret_cast<const uint16_t*>(r + 3 * ld), 0x5410);
    b[0] = __byte_perm(x, y, 0x6420);
    b[1] = __byte_perm(x, y, 0x7531);
  } else {
    const uint32_t x = __byte_perm(__byte_perm(r[0], r[ld], 0x0040),
                                   __byte_perm(r[2 * ld], r[3 * ld], 0x0040),
                                   0x5410);
    b[0] = (x << 4) & 0xF0F0F0F0u;
    b[1] = x & 0xF0F0F0F0u;
  }
}

// Weight-only: the tile's 32 rows x the block's 64 columns on bf16 MMAs.
// Each k16 step's float32 sums are folded into `tot` at the end of each
// scale group, in ascending g: tot += acc * s_g (__fmul_rn, __fadd_rn).
// DEQ: the weights are dequantized to bf16 before the product (q_deq:
// K8's int8, K7's int4, whose scales are reloaded at each group end) and
// the sums are taken as they are, with no fold. BT: the bias type. clamp
// takes min(v, upper) after the activation.
template <int F, bool SILU, bool GATHER, bool DEQ = false,
          typename BT = bf16>
__device__ __forceinline__ void tile_q_mma(
    const bf16* __restrict__ at, const int* rows,
    const int8_t* __restrict__ we, const float* __restrict__ scale, int G,
    const BT* __restrict__ bias, int K, int N, int n0, unsigned char* sm,
    bf16* __restrict__ out, bool clamp = false, float upper = 0.f) {
  using C = QLayout<F, false>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row and byte offset (mma_common.cuh)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 16;
  const int wcol = F == W_Q8 ? 16 * warp + 2 * g : 8 * warp + g;
  const int w_ld = F == W_Q8 ? N : N / 2;
  const auto* a = reinterpret_cast<const unsigned char*>(at);
  const auto* w = reinterpret_cast<const unsigned char*>(we);
  const int gs = K / G;
  float acc[2][2][4] = {}, tot[2][2][4] = {};
  float sc[2][2];
  float bs[2];  // DEQ: the scales of this lane's B columns
  if constexpr (DEQ)
    q_bscale<F>(scale, n0, N, wcol, bs);
  else
    q_load<F>(scale, n0, N, warp, t, sc);
  int grp = 0, fold_at = gs;
  const int steps = K / Q_BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps)
      q_stage<F, false, GATHER>(sm + s * C::STAGE, a, rows, 2 * K, w, w_ld,
                                s * Q_BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slice ks is in for all; slice ks - 1 is done with
    const int next = ks + C::STAGES - 1;
    if (next < steps)
      q_stage<F, false, GATHER>(sm + (next % C::STAGES) * C::STAGE, a, rows,
                                2 * K, w, w_ld, next * Q_BK);
    cp_async_commit();
    const unsigned char* xs = sm + (ks % C::STAGES) * C::STAGE;
    const unsigned char* ws = xs + C::X + wcol;
#pragma unroll
    for (int kk = 0; kk < Q_BK; kk += 16) {
      uint32_t a0[4], a1[4], b0[2], b1[2];
      mma::ldsm_x4(a0, xs + lr * C::XLD + 2 * kk + lc);
      mma::ldsm_x4(a1, xs + (16 + lr) * C::XLD + 2 * kk + lc);
      const unsigned char* wr = ws + (kk + 2 * t) * C::WLD;
      if constexpr (DEQ) {
        q_deq<F>(wr, wr + C::WLD, bs, b0);                   // rows 2t, 2t + 1
        q_deq<F>(wr + 8 * C::WLD, wr + 9 * C::WLD, bs, b1);  // 2t + 8, + 9
      } else {
        q_widen<F>(wr, wr + C::WLD, b0);               // rows 2t, 2t + 1
        q_widen<F>(wr + 8 * C::WLD, wr + 9 * C::WLD, b1);  // 2t + 8, + 9
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma::mma_bf16(acc[0][j], a0, b0[j], b1[j]);
        mma::mma_bf16(acc[1][j], a1, b0[j], b1[j]);
      }
      if constexpr (!DEQ || F == W_Q4) {
        if (ks * Q_BK + kk + 16 == fold_at) {  // end of a scale group
          if constexpr (!DEQ) {
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  tot[m][j][c] = __fadd_rn(
                      tot[m][j][c], __fmul_rn(acc[m][j][c], sc[j][c & 1]));
                  acc[m][j][c] = 0.f;
                }
          }
          fold_at += gs;
          if (++grp < G) {
            if constexpr (DEQ)
              q_bscale<F>(scale + (size_t)grp * N, n0, N, wcol, bs);
            else
              q_load<F>(scale + (size_t)grp * N, n0, N, warp, t, sc);
          }
        }
      }
    }
  }
  float bv[2][2] = {};
  if (bias != nullptr) q_load<F>(bias, n0, N, warp, t, bv);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = dst_row<GATHER>(rows, 16 * m + 8 * h + g);
      if (GATHER && row < 0) continue;
      float v[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = DEQ ? acc[m][j][2 * h + i] : tot[m][j][2 * h + i];
          if (bias != nullptr) x = __fadd_rn(x, bv[j][i]);
          v[j][i] = SILU ? silu(x) : x;
          if (clamp) v[j][i] = fminf(v[j][i], upper);
        }
      q_store<F>(out + (size_t)row * N, n0, N, warp, t, v);
    }
}

// a8: the tile's int8 rows (aq, row scales as) x the block's 64 columns on
// s8 MMAs into exact s32 sums (|sum| < 127 * 127 * K); the epilogue in the
// JAX package's order:
//   int8: (float(sum) * as[row]) * scale[0, n]     (pallas_moe_runs.py:287)
//   int4: (sum_g float(sum_g) * scale[g, n]) * as[row]
//                                                 (pallas_moe_q4.py:183-187)
// then + bias (of type BT), optional SiLU, optional clamp at `upper`.
template <int F, bool SILU, typename OutT, bool GATHER, typename BT = bf16>
__device__ __forceinline__ void tile_q_s8(
    const int8_t* __restrict__ aq, const float* __restrict__ as,
    const int* rows, const int8_t* __restrict__ we,
    const float* __restrict__ scale, int G, const BT* __restrict__ bias,
    int K, int N, int n0, unsigned char* sm, OutT* __restrict__ out,
    bool clamp = false, float upper = 0.f) {
  using C = QLayout<F, true>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 16;
  const int wcol = F == W_Q8 ? 16 * warp + 2 * g : 8 * warp + g;
  const int w_ld = F == W_Q8 ? N : N / 2;
  const auto* a = reinterpret_cast<const unsigned char*>(aq);
  const auto* w = reinterpret_cast<const unsigned char*>(we);
  const int gs = K / G;
  int acc[2][2][4] = {};
  float tot[2][2][4] = {};
  float sc[2][2];
  q_load<F>(scale, n0, N, warp, t, sc);
  int grp = 0, fold_at = gs;
  const int steps = K / Q_BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps)
      q_stage<F, true, GATHER>(sm + s * C::STAGE, a, rows, K, w, w_ld,
                               s * Q_BK);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int next = ks + C::STAGES - 1;
    if (next < steps)
      q_stage<F, true, GATHER>(sm + (next % C::STAGES) * C::STAGE, a, rows,
                               K, w, w_ld, next * Q_BK);
    cp_async_commit();
    const unsigned char* xs = sm + (ks % C::STAGES) * C::STAGE;
    const unsigned char* ws = xs + C::X + wcol;
#pragma unroll
    for (int kk = 0; kk < Q_BK; kk += 32) {
      uint32_t a0[4], a1[4], b0[2], b1[2];
      mma::ldsm_x4(a0, xs + lr * C::XLD + kk + lc);
      mma::ldsm_x4(a1, xs + (16 + lr) * C::XLD + kk + lc);
      const unsigned char* wr = ws + (kk + 4 * t) * C::WLD;
      q_gather<F>(wr, C::WLD, b0);                 // rows 4t .. 4t + 3
      q_gather<F>(wr + 16 * C::WLD, C::WLD, b1);   // rows 16 + 4t ..
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma::mma_s8(acc[0][j], a0, b0[j], b1[j]);
        mma::mma_s8(acc[1][j], a1, b0[j], b1[j]);
      }
      if (F == W_Q4 && ks * Q_BK + kk + 32 == fold_at) {  // int4 group end
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              // the sums of 16 q are multiples of 16: >> 4 is exact
              tot[m][j][c] =
                  __fadd_rn(tot[m][j][c], __fmul_rn((float)(acc[m][j][c] >> 4),
                                                    sc[j][c & 1]));
              acc[m][j][c] = 0;
            }
        fold_at += gs;
        if (++grp < G)
          q_load<F>(scale + (size_t)grp * N, n0, N, warp, t, sc);
      }
    }
  }
  float bv[2][2] = {};
  if (bias != nullptr) q_load<F>(bias, n0, N, warp, t, bv);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = dst_row<GATHER>(rows, 16 * m + 8 * h + g);
      if (GATHER && r < 0) continue;
      const float ar = as[r];
      float v[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = F == W_Q8
                        ? __fmul_rn(__fmul_rn((float)acc[m][j][2 * h + i], ar),
                                    sc[j][i])
                        : __fmul_rn(tot[m][j][2 * h + i], ar);
          if (bias != nullptr) x = __fadd_rn(x, bv[j][i]);
          v[j][i] = SILU ? silu(x) : x;
          if (clamp) v[j][i] = fminf(v[j][i], upper);
        }
      q_store<F>(out + (size_t)r * N, n0, N, warp, t, v);
    }
}

// The block's expert weights: expert row layer*E + e, from the block's
// first column (int8) or packed byte (int4)
template <int F>
__device__ __forceinline__ const int8_t* q_weights(const int8_t* w, int er,
                                                   int K, int N, int n0) {
  return expert_w<F>(w, er, K, N) + (F == W_Q8 ? n0 : n0 / 2);
}

}  // namespace moe
