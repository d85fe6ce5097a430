// Flash attention for the rel-pos conformer, forward (K2) and backward
// (K3: one kernel for dQ, one for dK and dV).
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
// the uniform average of v, finite, as in the JAX kernel. Keys past S
// and query rows past T are not padded: they are left out by bounds
// checks (p = 0 for keys >= S in every kernel and for rows >= T in dK/dV,
// where JAX reaches the same zero through +1e30 LSE padding).
//
// The backward is FlashAttention-2's recompute: each kernel rebuilds
// p = exp(s - lse) from q2, k2 and the saved LSE under the same masks,
// forms dp = dO . v and ds = p (dp - delta) scale, with delta =
// rowsum(dO * out) computed by the wrapper. dQ = ds k2 runs one block
// per query tile looping over key tiles; dK = ds^T q2 and dV = p^T dO
// one block per key tile looping over query tiles, so no two blocks
// write one output and no atomics are needed: the gradients repeat bit
// for bit from run to run.
//
// Rounding contract (pallas_attention.py:93-142, :304-369): products sum
// in float32 (f32 inputs run plain FMAs, no TF32; bf16 inputs are widened
// to float32, where their products are exact); the forward rounds p to
// v's type before the p.v product and keeps l in float32 from the
// unrounded p; the backward works in float32 from dO, v and p throughout
// and rounds only the outputs.
//
// What bounds it on an H100: at the flagship's shapes (T = S <= 512,
// D2 + Dk = 192 or 384) the FLOPs, 2 B H T S (D2 + Dk) forward, outrun
// the bytes of q2, k2, v and out by about 2 (T / 4) / element size, so
// the float32 rate (67 TFLOP/s outside the tensor cores) bounds fp32 and
// the tensor cores bound bf16. This first version is simple on purpose:
// 128 threads per block, each owning a 4 x 8 (or 2 x 8) patch of the
// score tile and of the accumulator, operands staged in float32 in
// shared memory in 32-deep (contraction) or 16-row slices, FMAs only. No
// mma.sync, wgmma, TMA or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int KC = 32;        // contraction depth staged per step
constexpr int RC = 16;        // rows of the right operand staged per step
constexpr float NEG_INF = -1e30f;

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

// v rounded to T and widened back (the JAX kernel's p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

struct Masks {
  const int32_t* lens;  // (B,) valid keys per batch row, or null
  const int32_t* lo;    // (B, T) first key of each query's window, or null
  const int32_t* hi;    // (B, T) one past its last key
  int mem_cols;         // leading keys every windowed row may attend
};

__device__ __forceinline__ bool attend(const Masks& m, int b, int T, int t,
                                       int c) {
  if (m.lens != nullptr && c >= m.lens[b]) return false;
  if (m.lo != nullptr) {
    const size_t i = (size_t)b * T + t;
    if (!((c >= m.lo[i] && c < m.hi[i]) || c < m.mem_cols)) return false;
  }
  return true;
}

// acc[i][j] = sum_k A[a0 + r_i, k] * Bm[b0 + c_j, k] over k < depth, with
// r_i = ty + 16 i (i < BR / 16), c_j = tx + 8 j (j < BC / 8). A and Bm are
// row-major with `depth` columns; rows at or past a_n (b_n) read as zero.
// Operands are staged transposed in KC-deep slices; the odd leading
// dimensions keep the staging stores free of bank conflicts.
template <int BR, int BC, typename T>
__device__ __forceinline__ void tile_abt(const T* __restrict__ A, int a0,
                                         int a_n, const T* __restrict__ Bm,
                                         int b0, int b_n, int depth,
                                         float (*As)[BR + 1],
                                         float (*Bs)[BC + 1],
                                         float (&acc)[BR / 16][BC / 8]) {
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
#pragma unroll
  for (int i = 0; i < BR / 16; ++i)
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < BR * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      As[k][r] = a0 + r < a_n
                     ? to_f(A[(size_t)(a0 + r) * depth + k0 + k]) : 0.f;
    }
    for (int e = tid; e < BC * KC; e += THREADS) {
      const int c = e / KC, k = e % KC;
      Bs[k][c] = b0 + c < b_n
                     ? to_f(Bm[(size_t)(b0 + c) * depth + k0 + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      float a[BR / 16], bb[BC / 8];
#pragma unroll
      for (int i = 0; i < BR / 16; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) bb[j] = Bs[k][tx + 8 * j];
#pragma unroll
      for (int i = 0; i < BR / 16; ++i)
#pragma unroll
        for (int j = 0; j < BC / 8; ++j)
          acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_c P(r_i, c) * X[x0 + c, tx + 8 j] over c < n_c, with
// r_i = ty + 16 i (i < RI) and P(r, c) = Ps[r * ld + c] (or Ps[c * ld + r]
// when TRANS). X is row-major with W = 8 NJ columns; rows at or past x_n
// read as zero. X is staged in RC-row slices in Xs.
template <int RI, int NJ, bool TRANS, typename T>
__device__ __forceinline__ void tile_px(const float* Ps, int ld, int n_c,
                                        const T* __restrict__ X, int x0,
                                        int x_n, float* Xs,
                                        float (&acc)[RI][NJ]) {
  constexpr int W = 8 * NJ;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  for (int c0 = 0; c0 < n_c; c0 += RC) {
    __syncthreads();
    for (int e = tid; e < RC * W; e += THREADS) {
      const int c = e / W, d = e % W;
      const int row = x0 + c0 + c;
      Xs[e] = row < x_n ? to_f(X[(size_t)row * W + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < RC; ++c) {
      float p[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        p[i] = TRANS ? Ps[(c0 + c) * ld + ty + 16 * i]
                     : Ps[(ty + 16 * i) * ld + c0 + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = Xs[c * W + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: one block per (query tile of 64 rows, b * H + h), looping over key
// tiles of 64 with the online max m and sum l of each row in float32.
// ---------------------------------------------------------------------------
constexpr int F_BQ = 64, F_BK = 64;

template <typename T, int D2, int DK>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                     const T* __restrict__ v, Masks masks, int H, int T_,
                     int S, float scale, T* __restrict__ out,
                     float* __restrict__ lse) {
  constexpr int RI = F_BQ / 16, CJ = F_BK / 8, NJ = DK / 8;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int t0 = blockIdx.x * F_BQ, bh = blockIdx.y, b = bh / H;
  const T* q = q2 + (size_t)bh * T_ * D2;
  const T* k = k2 + (size_t)bh * S * D2;
  const T* vv = v + (size_t)bh * S * DK;

  __shared__ float As[KC][F_BQ + 1];
  __shared__ float Bs[KC][F_BK + 1];
  __shared__ float Ps[F_BQ][F_BK + 1];
  __shared__ float Xs[RC * DK];
  __shared__ float m_s[F_BQ], l_s[F_BQ], alpha_s[F_BQ];

  if (tid < F_BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += F_BK) {
    float s[RI][CJ];
    tile_abt<F_BQ, F_BK>(q, t0, T_, k, s0, S, D2, As, Bs, s);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, t = t0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 8 * j, col = s0 + c;
        float x = -INFINITY;  // past S: left out of max and sum
        if (col < S) {
          x = s[i][j] * scale;
          if (t < T_ && !attend(masks, b, T_, t, col)) x = NEG_INF;
        }
        Ps[r][c] = x;
      }
    }
    __syncthreads();
    {
      // two threads per row, 32 columns each
      const int r = tid >> 1, c0 = (tid & 1) * (F_BK / 2);
      float mx = -INFINITY;
      for (int c = c0; c < c0 + F_BK / 2; ++c) mx = fmaxf(mx, Ps[r][c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = c0; c < c0 + F_BK / 2; ++c) {
        const float p = expf(Ps[r][c] - m_new);
        sum += p;
        Ps[r][c] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((tid & 1) == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    tile_px<RI, NJ, false>(&Ps[0][0], F_BK + 1, F_BK, vv, s0, S, Xs, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, t = t0 + r;
    if (t >= T_) continue;
    const float l = l_s[r];
    T* o = out + ((size_t)bh * T_ + t) * DK;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + 8 * j] = from_f<T>(acc[i][j] / l);
  }
  if (lse != nullptr && tid < F_BQ && t0 + tid < T_)
    lse[(size_t)bh * T_ + t0 + tid] = m_s[tid] + logf(l_s[tid]);
}

// ---------------------------------------------------------------------------
// K3 dQ: one block per (query tile of 32 rows, b * H + h), looping over
// key tiles of 64: dq += ds k2.
// ---------------------------------------------------------------------------
constexpr int Q_BQ = 32, Q_BK = 64;

template <typename T, int D2, int DK>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, Masks masks, int H,
                        int T_, int S, float scale, T* __restrict__ dq) {
  constexpr int RI = Q_BQ / 16, CJ = Q_BK / 8, NJ = D2 / 8;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int t0 = blockIdx.x * Q_BQ, bh = blockIdx.y, b = bh / H;
  const T* q = q2 + (size_t)bh * T_ * D2;
  const T* k = k2 + (size_t)bh * S * D2;
  const T* vv = v + (size_t)bh * S * DK;
  const T* go = g + (size_t)bh * T_ * DK;

  __shared__ float As[KC][Q_BQ + 1];
  __shared__ float Bs[KC][Q_BK + 1];
  __shared__ float Ps[Q_BQ][Q_BK + 1];
  __shared__ float Xs[RC * D2];
  __shared__ float lse_s[Q_BQ], dl_s[Q_BQ];

  if (tid < Q_BQ) {
    const bool in = t0 + tid < T_;
    lse_s[tid] = in ? lse[(size_t)bh * T_ + t0 + tid] : 0.f;
    dl_s[tid] = in ? delta[(size_t)bh * T_ + t0 + tid] : 0.f;
  }
  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q_BK) {
    float p[RI][CJ], dp[RI][CJ];
    tile_abt<Q_BQ, Q_BK>(q, t0, T_, k, s0, S, D2, As, Bs, p);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, t = t0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = s0 + tx + 8 * j;
        float x = 0.f;
        if (t < T_ && col < S) {
          const float sc =
              attend(masks, b, T_, t, col) ? p[i][j] * scale : NEG_INF;
          x = expf(sc - lse_s[r]);
        }
        p[i][j] = x;
      }
    }
    tile_abt<Q_BQ, Q_BK>(go, t0, T_, vv, s0, S, DK, As, Bs, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Ps[r][tx + 8 * j] = p[i][j] * (dp[i][j] - dl_s[r]) * scale;
    }
    tile_px<RI, NJ, false>(&Ps[0][0], Q_BK + 1, Q_BK, k, s0, S, Xs, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T_) continue;
    T* o = dq + ((size_t)bh * T_ + t) * D2;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + 8 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K3 dK, dV: one block per (key tile of 32 rows, b * H + h), looping over
// query tiles of 64: dv += p^T dO, dk += ds^T q2.
// ---------------------------------------------------------------------------
constexpr int KV_BK = 32, KV_BQ = 64;

template <typename T, int D2, int DK>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q2, const T* __restrict__ k2,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, Masks masks, int H,
                         int T_, int S, float scale, T* __restrict__ dk,
                         T* __restrict__ dv) {
  constexpr int RI = KV_BQ / 16, CJ = KV_BK / 8;  // score tile: queries x keys
  constexpr int KI = KV_BK / 16;                  // accumulators: keys x width
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int s0 = blockIdx.x * KV_BK, bh = blockIdx.y, b = bh / H;
  const T* q = q2 + (size_t)bh * T_ * D2;
  const T* k = k2 + (size_t)bh * S * D2;
  const T* vv = v + (size_t)bh * S * DK;
  const T* go = g + (size_t)bh * T_ * DK;

  __shared__ float As[KC][KV_BQ + 1];
  __shared__ float Bs[KC][KV_BK + 1];
  __shared__ float Ps[KV_BQ][KV_BK + 1];
  __shared__ float Xs[RC * D2];
  __shared__ float lse_s[KV_BQ], dl_s[KV_BQ];

  float dk_acc[KI][D2 / 8], dv_acc[KI][DK / 8];
#pragma unroll
  for (int i = 0; i < KI; ++i) {
#pragma unroll
    for (int j = 0; j < D2 / 8; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) dv_acc[i][j] = 0.f;
  }

  for (int t0 = 0; t0 < T_; t0 += KV_BQ) {
    // the previous step's last readers of lse_s / dl_s are behind the
    // barriers in its tile_px calls
    if (tid < KV_BQ) {
      const bool in = t0 + tid < T_;
      lse_s[tid] = in ? lse[(size_t)bh * T_ + t0 + tid] : 0.f;
      dl_s[tid] = in ? delta[(size_t)bh * T_ + t0 + tid] : 0.f;
    }
    float p[RI][CJ], dp[RI][CJ];
    tile_abt<KV_BQ, KV_BK>(q, t0, T_, k, s0, S, D2, As, Bs, p);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, t = t0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 8 * j, col = s0 + c;
        float x = 0.f;  // rows past T and keys past S contribute nothing
        if (t < T_ && col < S) {
          const float sc =
              attend(masks, b, T_, t, col) ? p[i][j] * scale : NEG_INF;
          x = expf(sc - lse_s[r]);
        }
        p[i][j] = x;
        Ps[r][c] = x;
      }
    }
    tile_px<KI, DK / 8, true>(&Ps[0][0], KV_BK + 1, KV_BQ, go, t0, T_, Xs,
                              dv_acc);
    tile_abt<KV_BQ, KV_BK>(go, t0, T_, vv, s0, S, DK, As, Bs, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Ps[r][tx + 8 * j] = p[i][j] * (dp[i][j] - dl_s[r]) * scale;
    }
    tile_px<KI, D2 / 8, true>(&Ps[0][0], KV_BK + 1, KV_BQ, q, t0, T_, Xs,
                              dk_acc);
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int c = s0 + ty + 16 * i;
    if (c >= S) continue;
    T* ok = dk + ((size_t)bh * S + c) * D2;
    T* ov = dv + ((size_t)bh * S + c) * DK;
#pragma unroll
    for (int j = 0; j < D2 / 8; ++j) ok[tx + 8 * j] = from_f<T>(dk_acc[i][j]);
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) ov[tx + 8 * j] = from_f<T>(dv_acc[i][j]);
  }
}

// The widths the kernels are built for: the flagship's MoE blocks (8
// heads of 64: D2 = 128) and embed blocks (4 heads of 128: D2 = 256).
// Calls a functor with the (T, D2, DK) instantiation, or returns
// cudaErrorInvalidValue for any other type or width.
template <typename F>
int dispatch(int dtype, int d2, int dk, F& f) {
  using bf16 = __nv_bfloat16;
  if (d2 == 128 && dk == 64) {
    if (dtype == 0) return f.template run<float, 128, 64>();
    if (dtype == 1) return f.template run<bf16, 128, 64>();
  }
  if (d2 == 256 && dk == 128) {
    if (dtype == 0) return f.template run<float, 256, 128>();
    if (dtype == 1) return f.template run<bf16, 256, 128>();
  }
  return (int)cudaErrorInvalidValue;
}

struct Common {
  const void *q2, *k2, *v;
  Masks masks;
  int B, H, T, S;
  float scale;
  cudaStream_t stream;
};

struct Fwd {
  Common c;
  void* out;
  float* lse;
  template <typename T, int D2, int DK>
  int run() {
    const dim3 grid((c.T + F_BQ - 1) / F_BQ, c.B * c.H);
    flash_fwd_kernel<T, D2, DK><<<grid, THREADS, 0, c.stream>>>(
        static_cast<const T*>(c.q2), static_cast<const T*>(c.k2),
        static_cast<const T*>(c.v), c.masks, c.H, c.T, c.S, c.scale,
        static_cast<T*>(out), lse);
    return (int)cudaGetLastError();
  }
};

struct BwdDq {
  Common c;
  const void* g;
  const float *lse, *delta;
  void* dq;
  template <typename T, int D2, int DK>
  int run() {
    const dim3 grid((c.T + Q_BQ - 1) / Q_BQ, c.B * c.H);
    flash_bwd_dq_kernel<T, D2, DK><<<grid, THREADS, 0, c.stream>>>(
        static_cast<const T*>(c.q2), static_cast<const T*>(c.k2),
        static_cast<const T*>(c.v), static_cast<const T*>(g), lse, delta,
        c.masks, c.H, c.T, c.S, c.scale, static_cast<T*>(dq));
    return (int)cudaGetLastError();
  }
};

struct BwdDkv {
  Common c;
  const void* g;
  const float *lse, *delta;
  void *dk, *dv;
  template <typename T, int D2, int DK>
  int run() {
    const dim3 grid((c.S + KV_BK - 1) / KV_BK, c.B * c.H);
    flash_bwd_dkv_kernel<T, D2, DK><<<grid, THREADS, 0, c.stream>>>(
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
// Each returns cudaGetLastError() after its launch (0 on success).
int flash_fwd(int dtype, int d2, int dk, const void* q2, const void* k2,
              const void* v, const int32_t* lens, const int32_t* lo,
              const int32_t* hi, int mem_cols, int B, int H, int T, int S,
              float scale, void* out, float* lse, void* stream) {
  Fwd f{{q2, k2, v, {lens, lo, hi, mem_cols}, B, H, T, S, scale,
         static_cast<cudaStream_t>(stream)},
        out, lse};
  return dispatch(dtype, d2, dk, f);
}

// g (B, H, T, dk) in the input type; lse, delta (B, H, T) float32.
int flash_bwd_dq(int dtype, int d2, int dk, const void* q2, const void* k2,
                 const void* v, const void* g, const float* lse,
                 const float* delta, const int32_t* lens, const int32_t* lo,
                 const int32_t* hi, int mem_cols, int B, int H, int T, int S,
                 float scale, void* dq, void* stream) {
  BwdDq f{{q2, k2, v, {lens, lo, hi, mem_cols}, B, H, T, S, scale,
           static_cast<cudaStream_t>(stream)},
          g, lse, delta, dq};
  return dispatch(dtype, d2, dk, f);
}

int flash_bwd_dkv(int dtype, int d2, int dk, const void* q2, const void* k2,
                  const void* v, const void* g, const float* lse,
                  const float* delta, const int32_t* lens, const int32_t* lo,
                  const int32_t* hi, int mem_cols, int B, int H, int T, int S,
                  float scale, void* dk_out, void* dv_out, void* stream) {
  BwdDkv f{{q2, k2, v, {lens, lo, hi, mem_cols}, B, H, T, S, scale,
            static_cast<cudaStream_t>(stream)},
           g, lse, delta, dk_out, dv_out};
  return dispatch(dtype, d2, dk, f);
}

}  // extern "C"
