// Attention at the inputs the fast kernels do not take, for Hopper (sm_90a):
// any head dim, float32, bfloat16 or float16, any token count, any number
// of heads.
//
// Replaces, at those inputs, the same TPU kernels as the fast ones:
// vidgraph_tpu/models/captioner.py::_attn_flash (JAX's Pallas TPU
// flash_attention forward and its backward pallas_calls
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq, which take any
// float type, any head dim below 128 and multiples of 128 above) and
// vidgraph_tpu/ops/short_attention.py::_fused_kernel (any even head count,
// any N, any float type).  flash_attention.cu / flash_attention_bwd.cu keep
// bfloat16 at hd 64 and 128, short_attention.cu bfloat16 at hd 64 and
// N <= 256; ops/flash_attention.py::flash_route and
// ops/short_attention.py::short_route choose, in Python, before the launch.
//
// Forward, attn_general_fwd, for q, k, v [B, H, T, hd] given by element
// strides (so [B, T, H, hd] and the ViT's strided views alike):
//
//   s[r,c] = (q[r] . k[c]) * scale                       (float32 FMAs)
//   visible(r,c) = c <= max(r, nv - 1)  (nv = T: every key)
//   online (kTwoPass false, the flash forward):
//     out[r] = sum_c e[r,c] v[c] / sum_c e[r,c],  e = exp(s - running max),
//     e rounded to the input type as the P.V operand (a no-op in float32),
//     as flash_attention.cu rounds it to bfloat16; L[r] = max + log(sum)
//   two passes (kTwoPass true, _fused_kernel's arithmetic):
//     pass 1 the row max m and sum l; pass 2 p = exp(s - m) / l rounded to
//     the input type, out[r] = sum_c p[r,c] v[c]
//
// with float32 sums and the output rounded once to the input type.  Float32
// inputs get float32 products and sums throughout: no TF32, no 16-bit
// rounding.
//
// Backward (the flash gradients; [B, T, H, hd] contiguous):
// attn_general_bwd_delta (delta = rowsum(dO * o), and the float32 dq
// accumulator zeroed), attn_general_bwd (dK and dV of a 64-key tile, dQ
// added into the accumulator by float32 atomics) and attn_general_dq_convert
// (dq = scale * accumulator in the input type), the formulas of
// flash_attention_bwd.cu with P and dS rounded to the input type as
// operands.
//
// What bounds it on the H100: at the shapes that reach it (the tiny64
// captioner's prefill, 4 heads of 32 over a few tokens; the ViT at small
// widths) launch latency; at long sequences the float32 products, which
// run on the CUDA cores (67 TFLOP/s) since a float32 caption must not
// round through TF32.  This is the simple kernel that is right, not the
// fast one: one block of 128 threads (a 16 x 8 grid of threads, each
// holding a 4 x 8 register tile) a (batch x head, 64 output dims, 64 query
// rows); the score product streams q and k through shared memory 32 dims
// at a time, so its shared memory (49,920 bytes forward, 83,968 backward)
// does not grow with hd; heads wider than 64 take one block per 64 output
// dims, each recomputing the scores.  The grid is one-dimensional, so
// B x H is bounded by 2^31 blocks, not by 65,535.  The entry points have a
// plain C interface and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kThreads = 128;             // 16 (ty) x 8 (tx)
constexpr int kRows = 64;                 // query rows (or keys) a tile
constexpr int kChunk = 32;                // dims a staged score chunk
constexpr int kDims = 64;                 // output dims a block
constexpr int kCS = kChunk + 1;           // padded rows of a score chunk
constexpr int kPS = kRows + 1;            // padded rows of P, dS

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T's precision: the rounding of a tensor-core operand.
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_f<T>(from_f<T>(x));
}

// Element strides of a [B, H, T, hd] view.
struct Layout {
  long long b, h, t, d;
};
struct Strides {
  Layout q, k, v, o;
};

// 64 rows x kChunk dims of x (rows from row0, dims from d0) into a
// [64][kCS] float32 tile; zeros past `rows` and past hd.
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* x,
                                            const Layout& l, int row0,
                                            int rows, int d0, int hd) {
  for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i % kChunk;
    const int row = row0 + r, d = d0 + c;
    dst[r * kCS + c] =
        row < rows && d < hd ? to_f<T>(x[row * l.t + d * l.d]) : 0.f;
  }
}

// 64 rows x kDims dims of x into a [64][kDims] float32 tile, zero-filled.
template <typename T>
__device__ __forceinline__ void stage_dims(float* dst, const T* x,
                                           const Layout& l, int row0,
                                           int rows, int d0, int hd) {
  for (int i = threadIdx.x; i < kRows * kDims; i += kThreads) {
    const int r = i / kDims, c = i % kDims;
    const int row = row0 + r, d = d0 + c;
    dst[r * kDims + c] =
        row < rows && d < hd ? to_f<T>(x[row * l.t + d * l.d]) : 0.f;
  }
}

// acc[i][j] += sum over hd of a[ty + 16 i] . b[tx + 8 j], the rows of a
// from a0 and of b from b0, streamed kChunk dims at a time through as, bs.
template <typename T>
__device__ __forceinline__ void dot_tile(float (&acc)[4][8], float* as,
                                         float* bs, const T* a,
                                         const Layout& la, int a0,
                                         const T* b, const Layout& lb, int b0,
                                         int rows, int hd, int ty, int tx) {
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    stage_chunk<T>(as, a, la, a0, rows, c0, hd);
    stage_chunk<T>(bs, b, lb, b0, rows, c0, hd);
    __syncthreads();
    const int cn = min(kChunk, hd - c0);
#pragma unroll 4
    for (int c = 0; c < cn; ++c) {
      float x[4], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = as[(ty + 16 * i) * kCS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = bs[(tx + 8 * j) * kCS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Max (or sum) over the 8 threads of a row (tx 0..7, neighbouring lanes).
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (2 * kRows * kCS + kRows * kDims + kRows * kPS);
}

template <typename T, bool kTwoPass, bool kWriteLse>
__global__ void __launch_bounds__(kThreads)
attn_general_fwd(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides st, int H, int Tn, int hd,
                 int nv, int n_qt, int n_dc, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [64][kCS]  q chunk
  float* ks = qs + kRows * kCS;           // [64][kCS]  k chunk
  float* vs = ks + kRows * kCS;           // [64][kDims] v, this block's dims
  float* ps = vs + kRows * kDims;         // [64][kPS]  P [row][key]

  long long blk = blockIdx.x;
  const int qt = n_qt - 1 - static_cast<int>(blk % n_qt);  // heaviest first
  blk /= n_qt;
  const int dc = static_cast<int>(blk % n_dc);
  const long long bh = blk / n_dc;
  const long long b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int row0 = qt * kRows, d0 = dc * kDims;
  const T* qh = q + b * st.q.b + h * st.q.h;
  const T* kh = k + b * st.k.b + h * st.k.h;
  const T* vh = v + b * st.v.b + h * st.v.h;

  const int last_row = min(row0 + kRows - 1, Tn - 1);
  const int n_kt = min(max(last_row, nv - 1), Tn - 1) / kRows + 1;

  // scores of the 64 x 64 tile at key0, scaled; -inf where hidden
  auto scores = [&](int key0, float (&s)[4][8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    dot_tile<T>(s, qs, ks, qh, st.q, row0, kh, st.k, key0, Tn, hd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = key0 + tx + 8 * j;
        s[i][j] = c < Tn && c <= max(r, nv - 1) ? s[i][j] * scale
                                                : -CUDART_INF_F;
      }
    }
  };
  // o[i][j] += P[row ty + 16 i][key] v[key][d0 + tx + 8 j] over the tile
  auto pv = [&](int key0, const float (&p)[4][8], float (&o)[4][8]) {
    stage_dims<T>(vs, vh, st.v, key0, Tn, d0, hd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ps[(ty + 16 * i) * kPS + tx + 8 * j] = round_as<T>(p[i][j]);
    __syncthreads();
    const int keys = min(kRows, Tn - key0);
#pragma unroll 4
    for (int c = 0; c < keys; ++c) {
      float x[4], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = vs[c * kDims + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) o[i][j] = fmaf(x[i], y[j], o[i][j]);
    }
    __syncthreads();
  };

  float m[4], l[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }
  // the running max and sum; key 0 is visible to every row, so after the
  // first tile m is finite (exp(-inf - m) = 0 for hidden keys)
  for (int kt = 0; kt < n_kt; ++kt) {
    float s[4][8];
    scores(kt * kRows, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        l[i] += s[i][j];
        if (!kTwoPass) o[i][j] *= alpha;
      }
    }
    if (!kTwoPass) pv(kt * kRows, s, o);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = row_sum(l[i]);
  if (kTwoPass) {
    // _fused_kernel's p: exactly normalised, then rounded (in pv)
    for (int kt = 0; kt < n_kt; ++kt) {
      float s[4][8];
      scores(kt * kRows, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = expf(s[i][j] - m[i]) / l[i];
      pv(kt * kRows, s, o);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= Tn) continue;
    if (kWriteLse && dc == 0 && tx == 0)
      lse[bh * Tn + r] = m[i] + logf(l[i]);
    const float inv = kTwoPass ? 1.f : 1.f / l[i];
    T* orow = out + b * st.o.b + h * st.o.h + r * st.o.t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + tx + 8 * j;
      if (d < hd) orow[d * st.o.d] = from_f<T>(o[i][j] * inv);
    }
  }
}

// delta[b, h, t] = sum_d dO * o over [B, T, H, hd] rows, a warp a row; the
// warp zeroes the row's float32 dq accumulator.
template <typename T>
__global__ void __launch_bounds__(256)
attn_general_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta,
                       float* __restrict__ dq_accum, long long n_rows, int Tn,
                       int H, int hd) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const long long at = row * hd;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32) {
    sum = fmaf(to_f<T>(o[at + d]), to_f<T>(dout[at + d]), sum);
    dq_accum[at + d] = 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long h = row % H, bt = row / H;
    delta[((bt / Tn) * H + h) * Tn + bt % Tn] = sum;
  }
}

constexpr size_t bwd_smem_bytes() {
  // score chunks (q, k, dO, v) or the tile's q and dO dims; k's dims; P^T
  // and dS^T; L and delta
  return sizeof(float) *
         (4 * kRows * kCS + kRows * kDims + 2 * kRows * kPS + 2 * kRows);
}

// One block a (batch x head, 64 output dims, 64-key tile): for every query
// tile that sees its keys, S^T and dP^T over the whole hd, P^T and dS^T,
// then dV += P^T dO and dK += dS^T q for its dims, and dQ = dS k for its
// dims added into the accumulator.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_general_bwd(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ dq_accum, int H,
                 int Tn, int hd, int nv, int n_kt, int n_dc, float scale) {
  extern __shared__ float smem[];
  float* qc = smem;                       // [64][kCS] q chunk; later q dims
  float* kc = qc + kRows * kCS;           // [64][kCS] k chunk
  float* oc = kc + kRows * kCS;           // [64][kCS] dO chunk; later dO dims
  float* vc = oc + kRows * kCS;           // [64][kCS] v chunk
  float* qd = qc;                         // [64][kDims] (qc, kc reused)
  float* od = qd + kRows * kDims;         // [64][kDims] (kc, oc reused)
  float* kd = vc + kRows * kCS;           // [64][kDims] k, this block's dims
  float* ps = kd + kRows * kDims;         // [64][kPS] P^T [key][query]
  float* ds = ps + kRows * kPS;           // [64][kPS] dS^T
  float* ls = ds + kRows * kPS;           // [64]
  float* dls = ls + kRows;                // [64]

  long long blk = blockIdx.x;
  const int kt = static_cast<int>(blk % n_kt);  // tile 0 is the heaviest
  blk /= n_kt;
  const int dc = static_cast<int>(blk % n_dc);
  const long long bh = blk / n_dc;
  const long long b = bh / H, h = bh % H;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int key0 = kt * kRows, d0 = dc * kDims;
  const long long tok = static_cast<long long>(H) * hd;
  const long long base = b * Tn * tok + h * hd;
  const Layout lay = {0, 0, tok, 1};
  const T* qh = q + base;
  const T* kh = k + base;
  const T* vh = v + base;
  const T* oh = dout + base;

  stage_dims<T>(kd, kh, lay, key0, Tn, d0, hd);
  float dka[4][8], dva[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int n_qt = (Tn + kRows - 1) / kRows;
  for (int qt = key0 < nv ? 0 : kt; qt < n_qt; ++qt) {
    const int q0 = qt * kRows;
    if (threadIdx.x < kRows) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < Tn ? lse[bh * Tn + r] : 0.f;
      dls[threadIdx.x] = r < Tn ? delta[bh * Tn + r] : 0.f;
    }
    // s = S^T, dp = dP^T: keys ty + 16 i, queries tx + 8 j
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_tile<T>(s, kc, qc, kh, lay, key0, qh, lay, q0, Tn, hd, ty, tx);
    dot_tile<T>(dp, vc, oc, vh, lay, key0, oh, lay, q0, Tn, hd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = key0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 8 * j, r = q0 + col;
        const bool vis = r < Tn && c < Tn && c <= max(r, nv - 1);
        const float p = vis ? expf(s[i][j] * scale - ls[col]) : 0.f;
        ps[(ty + 16 * i) * kPS + col] = round_as<T>(p);
        ds[(ty + 16 * i) * kPS + col] = round_as<T>(p * (dp[i][j] - dls[col]));
      }
    }
    stage_dims<T>(qd, qh, lay, q0, Tn, d0, hd);
    stage_dims<T>(od, oh, lay, q0, Tn, d0, hd);
    __syncthreads();
    const int rows = min(kRows, Tn - q0);
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float pa[4], da[4], ob[8], qb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[(ty + 16 * i) * kPS + r];
        da[i] = ds[(ty + 16 * i) * kPS + r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ob[j] = od[r * kDims + tx + 8 * j];
        qb[j] = qd[r * kDims + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dva[i][j] = fmaf(pa[i], ob[j], dva[i][j]);
          dka[i][j] = fmaf(da[i], qb[j], dka[i][j]);
        }
    }
    // dQ of queries q0 + ty + 16 i, dims d0 + tx + 8 j over this tile's keys
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const int keys = min(kRows, Tn - key0);
#pragma unroll 2
    for (int c = 0; c < keys; ++c) {
      float a[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ds[c * kPS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = kd[c * kDims + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], kb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r >= Tn) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d0 + tx + 8 * j;
        if (d < hd) atomicAdd(dq_accum + base + r * tok + d, acc[i][j]);
      }
    }
    __syncthreads();                      // before the next tile restages
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = key0 + ty + 16 * i;
    if (c >= Tn) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + tx + 8 * j;
      if (d >= hd) continue;
      dk[base + c * tok + d] = from_f<T>(dka[i][j] * scale);
      dv[base + c * tok + d] = from_f<T>(dva[i][j]);
    }
  }
}

// dq = scale * dq_accum in the input type, n elements.
template <typename T>
__global__ void __launch_bounds__(256)
attn_general_dq_convert(const float* __restrict__ acc, T* __restrict__ dq,
                        long long n, float scale) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    dq[i] = from_f<T>(acc[i] * scale);
}

constexpr long long kMaxBlocks = 2147483647LL;

template <typename T, bool kTwoPass, bool kWriteLse>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, const Strides& st, int B, int H,
                       int Tn, int hd, int nv, float scale,
                       cudaStream_t stream) {
  const int n_qt = (Tn + kRows - 1) / kRows, n_dc = (hd + kDims - 1) / kDims;
  const long long blocks = static_cast<long long>(B) * H * n_dc * n_qt;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  auto* kern = attn_general_fwd<T, kTwoPass, kWriteLse>;
  constexpr size_t smem = fwd_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), st, H, Tn, hd, nv, n_qt, n_dc, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_mode(const void* q, const void* k, const void* v,
                            void* out, void* lse, const Strides& st, int B,
                            int H, int Tn, int hd, int nv, int two_pass,
                            float scale, cudaStream_t stream) {
  if (two_pass)
    return launch_fwd<T, true, false>(q, k, v, out, lse, st, B, H, Tn, hd,
                                      nv, scale, stream);
  if (lse != nullptr)
    return launch_fwd<T, false, true>(q, k, v, out, lse, st, B, H, Tn, hd,
                                      nv, scale, stream);
  return launch_fwd<T, false, false>(q, k, v, out, lse, st, B, H, Tn, hd, nv,
                                     scale, stream);
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, void* dq_accum, int B, int Tn,
                       int H, int hd, int nv, float scale,
                       cudaStream_t stream) {
  const int n_kt = (Tn + kRows - 1) / kRows, n_dc = (hd + kDims - 1) / kDims;
  const long long blocks = static_cast<long long>(B) * H * n_dc * n_kt;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  constexpr size_t smem = bwd_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      attn_general_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attn_general_bwd<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dq_accum),
      H, Tn, hd, nv, n_kt, n_dc, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                         void* dq_accum, int B, int Tn, int H, int hd,
                         cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Tn * H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  attn_general_bwd_delta<T><<<static_cast<unsigned>(blocks), 256, 0,
                              stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), static_cast<float*>(dq_accum), rows, Tn, H,
      hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_convert(const void* acc, void* dq, long long n,
                           float scale, cudaStream_t stream) {
  const long long blocks = std::min((n + 255) / 256, 1LL << 20);
  attn_general_dq_convert<T><<<static_cast<unsigned>(blocks), 256, 0,
                               stream>>>(static_cast<const float*>(acc),
                                         static_cast<T*>(dq), n, scale);
  return cudaGetLastError();
}

// dtype codes of the entry points: 0 float32, 1 bfloat16, 2 float16
#define VG_DISPATCH(dtype, call_f32, call_bf16, call_f16)        \
  switch (dtype) {                                               \
    case 0:                                                      \
      return static_cast<int>(call_f32);                         \
    case 1:                                                      \
      return static_cast<int>(call_bf16);                        \
    case 2:                                                      \
      return static_cast<int>(call_f16);                         \
    default:                                                     \
      return static_cast<int>(cudaErrorInvalidValue);            \
  }

}  // namespace

extern "C" {

// q, k, v, out: [B, H, T, hd] of `dtype` at the element strides
// strides[0..15] = (b, h, t, d) of q, k, v, out; lse: float32 [B, H, T] or
// null (the online mode only); two_pass 1 normalises p before P.V
// (_fused_kernel's arithmetic) and writes no lse.  nv = T sees every key.
int attn_general_fwd_launch(const void* q, const void* k, const void* v,
                            void* out, void* lse, const long long* strides,
                            int B, int H, int T, int hd, int nv, int two_pass,
                            int dtype, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || hd < 1 || (two_pass && lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  Layout* ls[4] = {&st.q, &st.k, &st.v, &st.o};
  for (int i = 0; i < 4; ++i)
    *ls[i] = {strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
              strides[4 * i + 3]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VG_DISPATCH(dtype,
              launch_fwd_mode<float>(q, k, v, out, lse, st, B, H, T, hd, nv,
                                     two_pass, scale, s),
              launch_fwd_mode<__nv_bfloat16>(q, k, v, out, lse, st, B, H, T,
                                             hd, nv, two_pass, scale, s),
              launch_fwd_mode<__half>(q, k, v, out, lse, st, B, H, T, hd, nv,
                                      two_pass, scale, s))
}

// o, dout: [B, T, H, hd] of `dtype`, contiguous; delta: float32 [B, H, T];
// dq_accum: float32 [B, T, H, hd], zeroed here.
int attn_general_bwd_delta_launch(const void* o, const void* dout,
                                  void* delta, void* dq_accum, int B, int T,
                                  int H, int hd, int dtype, void* stream) {
  if (B < 1 || H < 1 || T < 1 || hd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VG_DISPATCH(dtype,
              launch_delta<float>(o, dout, delta, dq_accum, B, T, H, hd, s),
              launch_delta<__nv_bfloat16>(o, dout, delta, dq_accum, B, T, H,
                                          hd, s),
              launch_delta<__half>(o, dout, delta, dq_accum, B, T, H, hd, s))
}

// q, k, v, dout, dk, dv: [B, T, H, hd] of `dtype`, contiguous; lse, delta:
// float32 [B, H, T]; dq_accum: float32 [B, T, H, hd], zeroed, summed into
// unscaled.
int attn_general_bwd_launch(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            void* dq_accum, int B, int T, int H, int hd,
                            int nv, int dtype, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || hd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VG_DISPATCH(dtype,
              launch_bwd<float>(q, k, v, dout, lse, delta, dk, dv, dq_accum,
                                B, T, H, hd, nv, scale, s),
              launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                        dq_accum, B, T, H, hd, nv, scale, s),
              launch_bwd<__half>(q, k, v, dout, lse, delta, dk, dv, dq_accum,
                                 B, T, H, hd, nv, scale, s))
}

// dq (n elements of `dtype`) = scale * dq_accum.
int attn_general_dq_convert_launch(const void* dq_accum, void* dq,
                                   long long n, int dtype, float scale,
                                   void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VG_DISPATCH(dtype, launch_convert<float>(dq_accum, dq, n, scale, s),
              launch_convert<__nv_bfloat16>(dq_accum, dq, n, scale, s),
              launch_convert<__half>(dq_accum, dq, n, scale, s))
}

}  // extern "C"
