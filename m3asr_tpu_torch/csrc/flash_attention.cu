// Flash attention for the rel-pos conformer, forward (K2) and backward
// (K3: one kernel for dQ, one for dK and dV), on Hopper's tensor cores.
//
// Replaces m3asr_tpu/ops/pallas_attention.py::flash_attention_bhtd
// (_flash_kernel) and ::flash_attention_bwd (_flash_bwd_dq_kernel,
// _flash_bwd_dkv_kernel). The wrapper is m3asr_tpu_torch/ops/
// flash_attention.py. With q2 (B,H,T,D2), k2 (B,H,S,D2), v (B,H,S,Dk):
//
//     s[t, c] = scale * q2[t] . k2[c],  -1e30 where masked
//     out[t]  = sum_c p[t, c] v[c] / l[t],  p = exp(s - m), m, l online
//     lse[t]  = m[t] + log l[t]
//
// The masks are the JAX kernel's: key c < lengths[b]; with a window, c in
// [lo[b,t], hi[b,t]) or c < mem_cols. Masked scores take the finite
// -1e30 (never -inf), so a row whose keys are all masked comes out as
// the uniform average of v, finite, as in the JAX kernel. No key tile is
// skipped (that would change those rows). Keys past S and query rows past
// T are not padded: they load as zeros and get p = 0 (keys >= S in every
// kernel, rows >= T in the backward, where JAX reaches the same zero
// through +1e30 LSE padding).
//
// The backward is FlashAttention-2's recompute: each kernel rebuilds
// p = exp(s - lse) from q2, k2 and the saved LSE under the same masks,
// forms dp = dO . v and ds = p (dp - delta) scale, with delta =
// rowsum(dO * out) computed by the wrapper. dQ = ds k2 runs one block
// per query tile looping over key tiles; dK = ds^T q2 and dV = p^T dO
// one block per key tile looping over query tiles, so no two blocks
// write one output and no atomics are needed; every sum runs in a fixed
// order, so the gradients repeat bit for bit from run to run.
//
// Rounding contract (pallas_attention.py:93-142, :304-369):
// - bf16, on the tensor cores (mma.sync m16n8k16, float32 sums): q2.k2 and
//   dO.v are bf16 x bf16 products, exact in float32. The forward rounds p
//   to bf16 before p.v (the JAX kernel's p.astype(v.dtype)) and keeps l in
//   float32 from the unrounded p. The backward's products with a float32
//   operand (p^T dO, ds^T q2, ds k2) split it into hi = bf16(x) and lo =
//   bf16(x - hi) and run two MMAs, within about 2^-17 of the float32
//   product.
// - float32, on FMAs (no TF32): every product sums its contraction in
//   order, as the plain version's float32 products do. 3xTF32 MMAs were
//   tried: they came closer to a float64 reference than the float32 plain
//   version itself, but rounding in another order they left little or no
//   margin under the check's 2e-6 of max|ref| against it at T = 511, and
//   ran no faster than scaled_dot_product_attention's float32 path.
// Outputs are rounded once, at the end.
//
// What bounds it on an H100: at the flagship's shapes (T = S <= 512,
// D2 + Dk = 192 or 384) the FLOPs, 2 B H T S (D2 + Dk) forward, outrun
// the bytes by about T / 2 per element, so arithmetic bounds it: the
// tensor cores for bf16 (989 TFLOP/s), the float32 FMA rate for float32
// (67 TFLOP/s). The calls are small (0.8-2.3 GFLOP), so the grid and the
// latency of each key tile bound it first. The design:
// - 128 threads (4 warps) per block; a warp owns 16 rows of an output tile
//   and its per-thread layout is that of the m16n8 MMA's C fragments for
//   both types (ldmatrix feeds the bf16 MMAs; float32 reads float4 rows).
// - The block's tile height (16, 32 or 64 rows) is chosen by the wrapper
//   per call so that B H ceil(T / rows) gives every SM a block (two for
//   the float32 forward, whose smaller tiles fit twice). Below 64 rows
//   the block's 4 warps share out each tile's keys for the first product
//   (scores) and the output columns for the second.
// - Tiles load with cp.async into dynamic shared memory while the
//   previous tile computes: double-buffered where the tile's second
//   product reads them (v in K2, k2 in dQ, q2 and dO in dK/dV), else into
//   one buffer refilled once the first product is done (k2 in K2, v in
//   dQ), which keeps the float32 K2 at two blocks an SM.
// - Scores (and p, ds) pass through shared memory between the two
//   products of a tile, so that each second product sums its keys in
//   order and no warp holds more than 96 accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace mma;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;

// elements of padding per shared row: 16 bytes keeps ldmatrix rows and
// the float32 vector loads free of bank conflicts (float32 row strides are
// 4 mod 32 floats)
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }
// keys (queries for dK/dV) per pipelined tile
template <typename T>
__host__ __device__ constexpr int key_tile() {
  return sizeof(T) == 2 ? 64 : 32;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Masks {
  const int32_t* lens;  // (B,) valid keys per batch row, or null
  const int32_t* lo;    // (B, T) first key of each query's window, or null
  const int32_t* hi;    // (B, T) one past its last key
  int mem_cols;         // leading keys every windowed row may attend
};

// The attend predicate of one query row: key c < lens[b] and, with a
// window, lo <= c < hi or c < mem_cols.
struct RowMask {
  int len, lo, hi, mem;
  bool windowed;
  __device__ __forceinline__ bool attend(int c) const {
    return c < len && (!windowed || (c >= lo && c < hi) || c < mem);
  }
};

__device__ __forceinline__ RowMask row_mask(const Masks& m, int b, int T,
                                            int t) {
  RowMask r{m.lens != nullptr ? m.lens[b] : INT_MAX, 0, 0, m.mem_cols,
            m.lo != nullptr && t < T};
  if (r.windowed) {
    r.lo = m.lo[(size_t)b * T + t];
    r.hi = m.hi[(size_t)b * T + t];
  }
  return r;
}

// --------------------------------------------------------------------------
// cp.async tiles, ldmatrix and mma.sync fragments (helpers: mma_common.cuh)
// --------------------------------------------------------------------------

// rows [row0, row0 + rows) of a row-major (n_rows, D) array into a shared
// tile with row stride ld; rows at or past n_rows load as zeros
template <int D, typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int row0, int rows, int n_rows) {
  constexpr int V = 16 / (int)sizeof(T), CH = D / V;
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, ch = e % CH;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * ld + ch * V,
               in ? src + (size_t)(row0 + r) * D + ch * V : src, in);
  }
}

// (a, b) -> hi = bf16x2(a, b), lo = bf16x2 of the remainders
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c += x . y over the 4 lanes, in order
__device__ __forceinline__ void fma4(float& c, float4 x, float4 y) {
  c = fmaf(x.x, y.x, c);
  c = fmaf(x.y, y.y, c);
  c = fmaf(x.z, y.z, c);
  c = fmaf(x.w, y.w, c);
}

// Fragments. Lane = 4 g + t. A C fragment c[4] of a 16 x 8 tile holds
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// c[n] (16 x 8 tiles, n < NT) += A[16 x DEPTH] . Bm[8 NT x DEPTH]^T, both
// row-major in shared memory (A at its first row, Bm at its first row).
template <int NT, int DEPTH>
__device__ __forceinline__ void warp_abt(const bf16* A, int lda,
                                         const bf16* Bm, int ldb,
                                         float (&c)[NT][4]) {
  static_assert(NT % 2 == 0, "bf16 B fragments load in pairs");
  const int lane = threadIdx.x & 31;
  const bf16* ap = A + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda +
                   (lane >> 4) * 8;
  const bf16* bp = Bm + ((lane & 7) + (lane >> 4) * 8) * ldb +
                   ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k = 0; k < DEPTH; k += 16) {
    uint32_t a[4];
    ldsm_x4(a, ap + k);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, bp + n * 8 * ldb + k);
      mma_bf16(c[n], a, b[0], b[1]);
      mma_bf16(c[n + 1], a, b[2], b[3]);
    }
  }
}

// float32, on FMAs: the same C fragments, each summed over k in order
// (as the plain version's float32 product does), 4 k at a time from
// float4 loads. With rows of stride ld = 4 mod 32 floats the loads of an
// 8-lane phase hit distinct banks or broadcast.
template <int NT, int DEPTH>
__device__ __forceinline__ void warp_abt(const float* A, int lda,
                                         const float* Bm, int ldb,
                                         float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * lda;
  const float* a1 = a0 + 8 * lda;
  const float* b0 = Bm + 2 * t * ldb;
#pragma unroll 2
  for (int k = 0; k < DEPTH; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 y0 =
          *reinterpret_cast<const float4*>(b0 + n * 8 * ldb + k);
      const float4 y1 =
          *reinterpret_cast<const float4*>(b0 + (n * 8 + 1) * ldb + k);
      fma4(c[n][0], x0, y0);
      fma4(c[n][1], x0, y1);
      fma4(c[n][2], x1, y0);
      fma4(c[n][3], x1, y1);
    }
  }
}

// One 16-key MMA depth of acc[n] += P . X: P as the C fragments of two
// 16 x 8 tiles (which are the A fragment as they stand), X row-major
// [key][col] in shared memory at its first key and first column; P
// rounded to bf16 (SPLIT false) or split hi + lo (SPLIT true).
template <int NT, bool SPLIT>
__device__ __forceinline__ void kn_step(const float (*p)[4], const bf16* X,
                                        int ldx, float (&acc)[NT][4]) {
  static_assert(NT % 2 == 0, "bf16 B fragments load in pairs");
  uint32_t hi[4], lo[4];
  split_bf16(p[0][0], p[0][1], hi[0], lo[0]);
  split_bf16(p[0][2], p[0][3], hi[1], lo[1]);
  split_bf16(p[1][0], p[1][1], hi[2], lo[2]);
  split_bf16(p[1][2], p[1][3], hi[3], lo[3]);
  const int lane = threadIdx.x & 31;
  const bf16* xp = X + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldx +
                   (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, xp + n * 8);
    if (SPLIT) {
      mma_bf16(acc[n], lo, b[0], b[1]);
      mma_bf16(acc[n + 1], lo, b[2], b[3]);
    }
    mma_bf16(acc[n], hi, b[0], b[1]);
    mma_bf16(acc[n + 1], hi, b[2], b[3]);
  }
}

// C fragments of a 16 x 8 N float tile, row-major in shared memory
template <int N>
__device__ __forceinline__ void load_c_frag(const float* P, int ld,
                                            float (&p)[N][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 a = *reinterpret_cast<const float2*>(P + g * ld + 8 * j +
                                                      2 * t);
    const float2 b = *reinterpret_cast<const float2*>(
        P + (g + 8) * ld + 8 * j + 2 * t);
    p[j][0] = a.x;
    p[j][1] = a.y;
    p[j][2] = b.x;
    p[j][3] = b.y;
  }
}

// the C fragments of a 16 x 8 N tile into shared memory (row-major)
template <int N>
__device__ __forceinline__ void store_c_frag(float* P, int ld,
                                             const float (&p)[N][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    store2(P + g * ld + 8 * j + 2 * t, p[j][0], p[j][1]);
    store2(P + (g + 8) * ld + 8 * j + 2 * t, p[j][2], p[j][3]);
  }
}

// acc[n] (C fragments, n < NT) += P[16 x KEYS] . X[KEYS x 8 NT]: P float
// row-major in shared memory at the warp's first row, X row-major
// [key][col] at its first key and first column.
template <int NT, int KEYS, bool SPLIT>
__device__ __forceinline__ void warp_pv(const float* P, int ldp,
                                        const bf16* X, int ldx,
                                        float (&acc)[NT][4]) {
#pragma unroll
  for (int k = 0; k < KEYS; k += 16) {
    float p[2][4];
    load_c_frag(P + k, ldp, p);
    kn_step<NT, SPLIT>(p, X + k * ldx, ldx, acc);
  }
}

// float32, on FMAs: keys in order, 4 at a time from float4 loads of P
// (SPLIT does not apply: P stays float32)
template <int NT, int KEYS, bool SPLIT>
__device__ __forceinline__ void warp_pv(const float* P, int ldp,
                                        const float* X, int ldx,
                                        float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p0 = P + g * ldp;
  const float* p1 = p0 + 8 * ldp;
  const float* x0 = X + 2 * t;
#pragma unroll 1
  for (int k = 0; k < KEYS; k += 4) {
    const float4 u0 = *reinterpret_cast<const float4*>(p0 + k);
    const float4 u1 = *reinterpret_cast<const float4*>(p1 + k);
    const float a0[4] = {u0.x, u0.y, u0.z, u0.w};
    const float a1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y =
            *reinterpret_cast<const float2*>(x0 + (k + kk) * ldx + n * 8);
        acc[n][0] = fmaf(a0[kk], y.x, acc[n][0]);
        acc[n][1] = fmaf(a0[kk], y.y, acc[n][1]);
        acc[n][2] = fmaf(a1[kk], y.x, acc[n][2]);
        acc[n][3] = fmaf(a1[kk], y.y, acc[n][3]);
      }
  }
}

// ---------------------------------------------------------------------------
// K2: one block per (ROWS query rows, b * H + h), looping over key tiles of
// BK. Per tile, warp w first scores query rows 16 (w / NS) .. + 16 against
// the NS-th share w % NS of the tile's keys and stages the masked scores
// in shared memory; then it takes the whole tile's scores of its 16 rows,
// updates their online max m and sum l (each of the NS warps of a row
// group keeps the same copy) and adds p v into its Dk / NS columns of the
// accumulator, keys in order. The next key tile loads into the single K
// buffer once the scores are done, and into the other V buffer, while p v
// runs.
// ---------------------------------------------------------------------------
template <typename T, int D2, int DK, int ROWS>
struct FwdLayout {
  static constexpr int BK = key_tile<T>(), LQ = D2 + pad<T>(),
                       LV = DK + pad<T>(), LP = BK + 8, NS = 64 / ROWS;
  static constexpr int q = 0, k = q + ROWS * LQ * (int)sizeof(T),
                       v = k + BK * LQ * (int)sizeof(T),
                       s = v + 2 * BK * LV * (int)sizeof(T),
                       // each warp's p: 4 x 16 rows
                       p = s + ROWS * LP * 4, bytes = p + 64 * LP * 4;
};

template <typename T, int D2, int DK, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                     const T* __restrict__ v, Masks masks, int H, int T_,
                     int S, float scale, T* __restrict__ out,
                     float* __restrict__ lse) {
  using L = FwdLayout<T, D2, DK, ROWS>;
  constexpr int BK = L::BK, LQ = L::LQ, LV = L::LV, LP = L::LP, NS = L::NS;
  constexpr int KC = BK / NS, WV = DK / NS, NV = WV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Pw = reinterpret_cast<float*>(smem + L::p) + warp * 16 * LP;
  const int g = lane >> 2, tq = lane & 3, rg = warp / NS, ks = warp % NS;
  const int t0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H;
  const T* q = q2 + (size_t)bh * T_ * D2;
  const T* k = k2 + (size_t)bh * S * D2;
  const T* vv = v + (size_t)bh * S * DK;

  load_rows<D2>(Qs, LQ, q, t0, ROWS, T_);
  load_rows<D2>(Ks, LQ, k, 0, BK, S);
  load_rows<DK>(Vs, LV, vv, 0, BK, S);
  cp_async_commit();

  // this thread's rows: ra (C fragment entries 0, 1) and rb (2, 3)
  const int ra = t0 + rg * 16 + g, rb = ra + 8;
  const RowMask ma = row_mask(masks, b, T_, ra);
  const RowMask mb = row_mask(masks, b, T_, rb);
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (S + BK - 1) / BK;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, s0 = it * BK;
    cp_async_wait<0>();
    __syncthreads();    // this tile's K and V are in; the last p v is done
    {
      // scores of 16 rows x KC keys, scaled and masked; past S: -inf,
      // left out of max and sum
      float s[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      warp_abt<KC / 8, D2>(Qs + rg * 16 * LQ, LQ,
                           Ks + ks * KC * LQ, LQ, s);
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = s0 + ks * KC + 8 * j + 2 * tq + e;
          float xa = -INFINITY, xb = -INFINITY;
          if (c < S) {
            xa = ra >= T_ || ma.attend(c) ? s[j][e] * scale : NEG_INF;
            xb = rb >= T_ || mb.attend(c) ? s[j][2 + e] * scale : NEG_INF;
          }
          s[j][e] = xa;
          s[j][2 + e] = xb;
        }
      store_c_frag(Ss + rg * 16 * LP + ks * KC, LP, s);
    }
    __syncthreads();    // scores staged; K is free
    if (it + 1 < n_tiles) {
      load_rows<D2>(Ks, LQ, k, s0 + BK, BK, S);
      load_rows<DK>(Vs + (buf ^ 1) * BK * LV, LV, vv, s0 + BK, BK, S);
    }
    cp_async_commit();

    float p[BK / 8][4];
    load_c_frag(Ss + rg * 16 * LP, LP, p);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(p[j][0], p[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(p[j][2], p[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[j][e] = expf(p[j][e] - mn_a);
        p[j][2 + e] = expf(p[j][2 + e] - mn_b);
        sum_a += p[j][e];
        sum_b += p[j][2 + e];
      }
    // this thread's share of l; the quad's shares add up at the end
    l_a = al_a * l_a + sum_a;
    l_b = al_b * l_b + sum_b;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }
    store_c_frag(Pw, LP, p);
    __syncwarp();
    warp_pv<NV, BK, false>(Pw, LP, Vs + buf * BK * LV + ks * WV, LV, acc);
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const size_t row0 = (size_t)bh * T_;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int col = ks * WV + 8 * n + 2 * tq;
    if (ra < T_)
      store2(out + (row0 + ra) * DK + col, acc[n][0] / l_a, acc[n][1] / l_a);
    if (rb < T_)
      store2(out + (row0 + rb) * DK + col, acc[n][2] / l_b, acc[n][3] / l_b);
  }
  if (lse != nullptr && ks == 0 && tq == 0) {
    if (ra < T_) lse[row0 + ra] = m_a + logf(l_a);
    if (rb < T_) lse[row0 + rb] = m_b + logf(l_b);
  }
}

// ---------------------------------------------------------------------------
// K3 dQ: one block per (ROWS query rows, b * H + h), looping over key tiles
// of BK. Per tile, warp w first forms p and ds for query rows 16 (w / NS)
// .. + 16 and the NS-th share w % NS of the tile's keys (in registers),
// stages ds in shared memory, then adds ds k2 into its 16 rows x D2 / NS
// columns of dq. The next key tile loads into the other K buffer and the
// single V buffer while ds k2 runs.
// ---------------------------------------------------------------------------
template <typename T, int D2, int DK, int ROWS>
struct DqLayout {
  static constexpr int BK = key_tile<T>(), LQ = D2 + pad<T>(),
                       LV = DK + pad<T>(), LP = BK + 8, NS = 64 / ROWS;
  static constexpr int q = 0, g = q + ROWS * LQ * (int)sizeof(T),
                       k = g + ROWS * LV * (int)sizeof(T),
                       v = k + 2 * BK * LQ * (int)sizeof(T),
                       ds = v + BK * LV * (int)sizeof(T),
                       bytes = ds + ROWS * LP * 4;
};

template <typename T, int D2, int DK, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                        const T* __restrict__ v, const T* __restrict__ go,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, Masks masks, int H,
                        int T_, int S, float scale, T* __restrict__ dq) {
  using L = DqLayout<T, D2, DK, ROWS>;
  constexpr int BK = L::BK, LQ = L::LQ, LV = L::LV, LP = L::LP, NS = L::NS;
  constexpr int KC = BK / NS, WQ = D2 / NS, NQ = WQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Gs = reinterpret_cast<T*>(smem + L::g);
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  float* DSs = reinterpret_cast<float*>(smem + L::ds);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, rg = warp / NS, ks = warp % NS;
  const int t0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H;
  const T* q = q2 + (size_t)bh * T_ * D2;
  const T* k = k2 + (size_t)bh * S * D2;
  const T* vv = v + (size_t)bh * S * DK;

  load_rows<D2>(Qs, LQ, q, t0, ROWS, T_);
  load_rows<DK>(Gs, LV, go + (size_t)bh * T_ * DK, t0, ROWS, T_);
  load_rows<D2>(Ks, LQ, k, 0, BK, S);
  load_rows<DK>(Vs, LV, vv, 0, BK, S);
  cp_async_commit();

  const int ra = t0 + rg * 16 + g, rb = ra + 8;
  const RowMask ma = row_mask(masks, b, T_, ra);
  const RowMask mb = row_mask(masks, b, T_, rb);
  const size_t row0 = (size_t)bh * T_;
  const float lse_a = ra < T_ ? lse[row0 + ra] : 0.f;
  const float lse_b = rb < T_ ? lse[row0 + rb] : 0.f;
  const float dl_a = ra < T_ ? delta[row0 + ra] : 0.f;
  const float dl_b = rb < T_ ? delta[row0 + rb] : 0.f;
  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (S + BK - 1) / BK;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, s0 = it * BK;
    cp_async_wait<0>();
    __syncthreads();    // this tile's K and V are in; the last ds k2 is done
    const T* Kt = Ks + buf * BK * LQ;

    float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    warp_abt<KC / 8, D2>(Qs + rg * 16 * LQ, LQ, Kt + ks * KC * LQ, LQ, s);
    warp_abt<KC / 8, DK>(Gs + rg * 16 * LV, LV, Vs + ks * KC * LV, LV, dp);
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = s0 + ks * KC + 8 * j + 2 * tq + e;
        float pa = 0.f, pb = 0.f;
        if (c < S) {
          if (ra < T_)
            pa = expf((ma.attend(c) ? s[j][e] * scale : NEG_INF) - lse_a);
          if (rb < T_)
            pb = expf((mb.attend(c) ? s[j][2 + e] * scale : NEG_INF) - lse_b);
        }
        s[j][e] = pa * (dp[j][e] - dl_a) * scale;
        s[j][2 + e] = pb * (dp[j][2 + e] - dl_b) * scale;
      }
    store_c_frag(DSs + rg * 16 * LP + ks * KC, LP, s);
    __syncthreads();    // ds staged; V is free
    if (it + 1 < n_tiles) {
      load_rows<D2>(Ks + (buf ^ 1) * BK * LQ, LQ, k, s0 + BK, BK, S);
      load_rows<DK>(Vs, LV, vv, s0 + BK, BK, S);
    }
    cp_async_commit();
    // dq[16 rows, columns ks WQ ..] += ds[16 rows, BK keys] k2[BK keys, ..]
    warp_pv<NQ, BK, true>(DSs + rg * 16 * LP, LP, Kt + ks * WQ, LQ, acc);
  }

#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int col = ks * WQ + 8 * n + 2 * tq;
    if (ra < T_) store2(dq + (row0 + ra) * D2 + col, acc[n][0], acc[n][1]);
    if (rb < T_) store2(dq + (row0 + rb) * D2 + col, acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// K3 dK, dV: one block per (ROWS keys, b * H + h), looping over query tiles
// of BQ. Per tile, warp w forms p^T and ds^T for keys 16 (w / NS) .. + 16
// and the NS-th share w % NS of the tile's queries, stages both in shared
// memory, then adds p^T dO and ds^T q2 into its 16 keys x (Dk / NS, D2 /
// NS) columns of dv and dk.
// ---------------------------------------------------------------------------
template <typename T, int D2, int DK, int ROWS>
struct DkvLayout {
  static constexpr int BQ = key_tile<T>(), LQ = D2 + pad<T>(),
                       LV = DK + pad<T>(), LP = BQ + 8, NS = 64 / ROWS;
  static constexpr int k = 0, v = k + ROWS * LQ * (int)sizeof(T),
                       q = v + ROWS * LV * (int)sizeof(T),
                       g = q + 2 * BQ * LQ * (int)sizeof(T),
                       // per buffer: lse, delta, lo, hi of BQ queries
                       st = g + 2 * BQ * LV * (int)sizeof(T),
                       p = st + 2 * 4 * BQ * 4, ds = p + ROWS * LP * 4,
                       bytes = ds + ROWS * LP * 4;
};

template <typename T, int D2, int DK, int ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                         const T* __restrict__ v, const T* __restrict__ go,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, Masks masks, int H,
                         int T_, int S, float scale, T* __restrict__ dk,
                         T* __restrict__ dv) {
  using L = DkvLayout<T, D2, DK, ROWS>;
  constexpr int BQ = L::BQ, LQ = L::LQ, LV = L::LV, LP = L::LP, NS = L::NS;
  constexpr int KC = BQ / NS;
  constexpr int WV = DK / NS, NV = WV / 8, WK = D2 / NS, NK = WK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::k);
  T* Vs = reinterpret_cast<T*>(smem + L::v);
  T* Qs = reinterpret_cast<T*>(smem + L::q);
  T* Gs = reinterpret_cast<T*>(smem + L::g);
  float* St = reinterpret_cast<float*>(smem + L::st);
  float* Ps = reinterpret_cast<float*>(smem + L::p);
  float* DSs = reinterpret_cast<float*>(smem + L::ds);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, kg = warp / NS, qs = warp % NS;
  const int s0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H;
  const size_t row0 = (size_t)bh * T_;
  const T* q = q2 + row0 * D2;
  const T* gg = go + row0 * DK;
  const bool windowed = masks.lo != nullptr;

  // lse, delta, lo, hi of queries [t0, t0 + BQ) into buffer buf (plain
  // loads; read after the barrier that opens the tile)
  auto load_stats = [&](int buf, int t0) {
    float* st = St + buf * 4 * BQ;
    int* lohi = reinterpret_cast<int*>(st + 2 * BQ);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const int t = t0 + i;
      const bool in = t < T_;
      st[i] = in ? lse[row0 + t] : 0.f;
      st[BQ + i] = in ? delta[row0 + t] : 0.f;
      if (windowed) {
        lohi[i] = in ? masks.lo[(size_t)b * T_ + t] : 0;
        lohi[BQ + i] = in ? masks.hi[(size_t)b * T_ + t] : 0;
      }
    }
  };

  load_rows<D2>(Ks, LQ, k2 + (size_t)bh * S * D2, s0, ROWS, S);
  load_rows<DK>(Vs, LV, v + (size_t)bh * S * DK, s0, ROWS, S);
  load_rows<D2>(Qs, LQ, q, 0, BQ, T_);
  load_rows<DK>(Gs, LV, gg, 0, BQ, T_);
  load_stats(0, 0);
  cp_async_commit();

  const int ca = s0 + kg * 16 + g, cb = ca + 8;   // this thread's keys
  const int len = masks.lens != nullptr ? masks.lens[b] : INT_MAX;
  float acc_v[NV][4], acc_k[NK][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NK; ++n)
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;

  const int n_tiles = (T_ + BQ - 1) / BQ;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, t0 = it * BQ;
    cp_async_wait<0>();
    __syncthreads();    // this tile is in; the last tile's products are done
    if (it + 1 < n_tiles) {
      load_rows<D2>(Qs + (buf ^ 1) * BQ * LQ, LQ, q, t0 + BQ, BQ, T_);
      load_rows<DK>(Gs + (buf ^ 1) * BQ * LV, LV, gg, t0 + BQ, BQ, T_);
      load_stats(buf ^ 1, t0 + BQ);
    }
    cp_async_commit();
    const T* Qt = Qs + buf * BQ * LQ;
    const T* Gt = Gs + buf * BQ * LV;
    const float* st = St + buf * 4 * BQ;
    const int* lohi = reinterpret_cast<const int*>(st + 2 * BQ);

    // p^T and dp^T: 16 keys x KC queries
    float p[KC / 8][4], ds[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
    warp_abt<KC / 8, D2>(Ks + kg * 16 * LQ, LQ, Qt + qs * KC * LQ, LQ, p);
    warp_abt<KC / 8, DK>(Vs + kg * 16 * LV, LV, Gt + qs * KC * LV, LV, ds);
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = qs * KC + 8 * j + 2 * tq + e, t = t0 + i;
        float pa = 0.f, pb = 0.f;   // rows past T, keys past S: nothing
        if (t < T_) {
          const RowMask rm{len, lohi[i], lohi[BQ + i], masks.mem_cols,
                           windowed};
          if (ca < S)
            pa = expf((rm.attend(ca) ? p[j][e] * scale : NEG_INF) - st[i]);
          if (cb < S)
            pb = expf((rm.attend(cb) ? p[j][2 + e] * scale : NEG_INF) -
                      st[i]);
        }
        p[j][e] = pa;
        p[j][2 + e] = pb;
        ds[j][e] = pa * (ds[j][e] - st[BQ + i]) * scale;
        ds[j][2 + e] = pb * (ds[j][2 + e] - st[BQ + i]) * scale;
      }
    store_c_frag(Ps + kg * 16 * LP + qs * KC, LP, p);
    store_c_frag(DSs + kg * 16 * LP + qs * KC, LP, ds);
    __syncthreads();
    // dv[16 keys, columns qs WV ..] += p^T dO; dk[.., qs WK ..] += ds^T q2
    warp_pv<NV, BQ, true>(Ps + kg * 16 * LP, LP, Gt + qs * WV, LV, acc_v);
    warp_pv<NK, BQ, true>(DSs + kg * 16 * LP, LP, Qt + qs * WK, LQ, acc_k);
  }

  const size_t key0 = (size_t)bh * S;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int col = qs * WV + 8 * n + 2 * tq;
    if (ca < S) store2(dv + (key0 + ca) * DK + col, acc_v[n][0], acc_v[n][1]);
    if (cb < S) store2(dv + (key0 + cb) * DK + col, acc_v[n][2], acc_v[n][3]);
  }
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int col = qs * WK + 8 * n + 2 * tq;
    if (ca < S) store2(dk + (key0 + ca) * D2 + col, acc_k[n][0], acc_k[n][1]);
    if (cb < S) store2(dk + (key0 + cb) * D2 + col, acc_k[n][2], acc_k[n][3]);
  }
}

// Runs a functor's instantiation for (dtype, D2, DK, rows), or returns
// cudaErrorInvalidValue for any other type, width or tile height. The
// widths are the flagship's MoE blocks (8 heads of 64: D2 = 128) and embed
// blocks (4 heads of 128: D2 = 256); rows 16, 32 or 64, the backward's
// only 16 or 32 (at 64 a dK/dV thread would hold up to 192 accumulators).
template <typename F, typename T, int D2, int DK>
int by_rows(int rows, F& f) {
  if (rows == 16) return f.template run<T, D2, DK, 16>();
  if (rows == 32) return f.template run<T, D2, DK, 32>();
  if constexpr (F::WIDE64) {
    if (rows == 64) return f.template run<T, D2, DK, 64>();
  }
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int dispatch(int dtype, int d2, int dk, int rows, F& f) {
  if (d2 == 128 && dk == 64) {
    if (dtype == 0) return by_rows<F, float, 128, 64>(rows, f);
    if (dtype == 1) return by_rows<F, bf16, 128, 64>(rows, f);
  }
  if (d2 == 256 && dk == 128) {
    if (dtype == 0) return by_rows<F, float, 256, 128>(rows, f);
    if (dtype == 1) return by_rows<F, bf16, 256, 128>(rows, f);
  }
  return (int)cudaErrorInvalidValue;
}

// Raises a kernel's dynamic shared memory limit once per instantiation
// (before its first launch); returns the CUDA error, 0 on success.
template <typename K>
int allow_smem(K* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Common {
  const void *q2, *k2, *v;
  Masks masks;
  int B, H, T, S;
  float scale;
  cudaStream_t stream;
};

struct Fwd {
  static constexpr bool WIDE64 = true;
  Common c;
  void* out;
  float* lse;
  template <typename T, int D2, int DK, int ROWS>
  int run() {
    constexpr int smem = FwdLayout<T, D2, DK, ROWS>::bytes;
    static const int attr = allow_smem(flash_fwd_kernel<T, D2, DK, ROWS>, smem);
    if (attr != 0) return attr;
    const dim3 grid((c.T + ROWS - 1) / ROWS, c.B * c.H);
    flash_fwd_kernel<T, D2, DK, ROWS><<<grid, THREADS, smem, c.stream>>>(
        static_cast<const T*>(c.q2), static_cast<const T*>(c.k2),
        static_cast<const T*>(c.v), c.masks, c.H, c.T, c.S, c.scale,
        static_cast<T*>(out), lse);
    return (int)cudaGetLastError();
  }
};

struct BwdDq {
  static constexpr bool WIDE64 = false;
  Common c;
  const void* g;
  const float *lse, *delta;
  void* dq;
  template <typename T, int D2, int DK, int ROWS>
  int run() {
    constexpr int smem = DqLayout<T, D2, DK, ROWS>::bytes;
    static const int attr =
        allow_smem(flash_bwd_dq_kernel<T, D2, DK, ROWS>, smem);
    if (attr != 0) return attr;
    const dim3 grid((c.T + ROWS - 1) / ROWS, c.B * c.H);
    flash_bwd_dq_kernel<T, D2, DK, ROWS><<<grid, THREADS, smem, c.stream>>>(
        static_cast<const T*>(c.q2), static_cast<const T*>(c.k2),
        static_cast<const T*>(c.v), static_cast<const T*>(g), lse, delta,
        c.masks, c.H, c.T, c.S, c.scale, static_cast<T*>(dq));
    return (int)cudaGetLastError();
  }
};

struct BwdDkv {
  static constexpr bool WIDE64 = false;
  Common c;
  const void* g;
  const float *lse, *delta;
  void *dk, *dv;
  template <typename T, int D2, int DK, int ROWS>
  int run() {
    constexpr int smem = DkvLayout<T, D2, DK, ROWS>::bytes;
    static const int attr =
        allow_smem(flash_bwd_dkv_kernel<T, D2, DK, ROWS>, smem);
    if (attr != 0) return attr;
    const dim3 grid((c.S + ROWS - 1) / ROWS, c.B * c.H);
    flash_bwd_dkv_kernel<T, D2, DK, ROWS><<<grid, THREADS, smem, c.stream>>>(
        static_cast<const T*>(c.q2), static_cast<const T*>(c.k2),
        static_cast<const T*>(c.v), static_cast<const T*>(g), lse, delta,
        c.masks, c.H, c.T, c.S, c.scale, static_cast<T*>(dk),
        static_cast<T*>(dv));
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// All pointers are device pointers; tensors are contiguous. dtype: 0 =
// float32, 1 = bfloat16; (d2, dk) is (128, 64) or (256, 128). lens (B,)
// and lo/hi (B, T) are int32 or null; lse (B, H, T) float32 or null.
// rows: the block's query rows (flash_fwd, flash_bwd_dq) or keys
// (flash_bwd_dkv): 16, 32 or 64 for flash_fwd, 16 or 32 for the others.
// Each returns cudaGetLastError() after its launch (0 on success).
int flash_fwd(int dtype, int d2, int dk, const void* q2, const void* k2,
              const void* v, const int32_t* lens, const int32_t* lo,
              const int32_t* hi, int mem_cols, int B, int H, int T, int S,
              float scale, int rows, void* out, float* lse, void* stream) {
  Fwd f{{q2, k2, v, {lens, lo, hi, mem_cols}, B, H, T, S, scale,
         static_cast<cudaStream_t>(stream)},
        out, lse};
  return dispatch(dtype, d2, dk, rows, f);
}

// g (B, H, T, dk) in the input type; lse, delta (B, H, T) float32.
int flash_bwd_dq(int dtype, int d2, int dk, const void* q2, const void* k2,
                 const void* v, const void* g, const float* lse,
                 const float* delta, const int32_t* lens, const int32_t* lo,
                 const int32_t* hi, int mem_cols, int B, int H, int T, int S,
                 float scale, int rows, void* dq, void* stream) {
  BwdDq f{{q2, k2, v, {lens, lo, hi, mem_cols}, B, H, T, S, scale,
           static_cast<cudaStream_t>(stream)},
          g, lse, delta, dq};
  return dispatch(dtype, d2, dk, rows, f);
}

int flash_bwd_dkv(int dtype, int d2, int dk, const void* q2, const void* k2,
                  const void* v, const void* g, const float* lse,
                  const float* delta, const int32_t* lens, const int32_t* lo,
                  const int32_t* hi, int mem_cols, int B, int H, int T, int S,
                  float scale, int rows, void* dk_out, void* dv_out,
                  void* stream) {
  BwdDkv f{{q2, k2, v, {lens, lo, hi, mem_cols}, B, H, T, S, scale,
            static_cast<cudaStream_t>(stream)},
           g, lse, delta, dk_out, dv_out};
  return dispatch(dtype, d2, dk, rows, f);
}

}  // extern "C"
