// FlashAttention backward with a mutually visible vision prefix, for Hopper
// (sm_90a): the gradients of flash_attention.cu::flash_attn_fwd.
//
// Replaces the backward of JAX's Pallas TPU flash_attention as
// vidgraph_tpu/models/captioner.py::_attn_flash trains through it: the two
// pallas_calls _flash_attention_bwd_dkv and _flash_attention_bwd_dq, fed by
// di = sum(o * do, -1), plus XLA's gradient of the dense nv x nv prefix
// corner.  Here the whole mask is folded into the kernels, as in the
// forward.  With q, k, v, o, dO [B, T, H, hd] bfloat16 (contiguous, hd 64 or
// 128), L [B, H, T] float32 the forward's log-sum-exp (natural log),
// scale = 1/sqrt(hd) and visible(r,c) = c <= max(r, nv - 1):
//
//   P[r,c]   = visible ? exp(scale * q[r].k[c] - L[r]) : 0      (float32)
//   delta[r] = sum_d dO[r,d] * o[r,d]                           (float32)
//   dV[c]    = sum_r P[r,c] * dO[r]
//   dP[r,c]  = dO[r] . v[c]
//   dS[r,c]  = P[r,c] * (dP[r,c] - delta[r])
//   dQ[r]    = scale * sum_c dS[r,c] * k[c]
//   dK[c]    = scale * sum_r dS[r,c] * q[r]
//
// for any T (ragged last tiles are masked, rows past T are staged as zeros).
//
// What bounds them on the H100: operations.  The backward is five matrix
// products per (query tile, key tile) pair against the forward's two, and
// nothing of the [B, H, T, T] P or dS may reach device memory; the inputs
// are read once per tile of the other side and the outputs written once.
//
// Design: three kernels and no atomics, so two runs give the same bits.
// The TPU kernels accumulate over a sequential grid dimension; here blocks
// run in no order, so each block owns its output rows and loops over the
// other side inside the block.
//
// * flash_bwd_delta: delta = rowsum(dO * o), written as [B, H, T] (the
//   layout the other two read a tile of with one coalesced load; the plain
//   expression would need two float32 copies and a transpose).
// * flash_bwd_dkv: one block of 4 warps per (64-key tile, batch x head),
//   each warp owning 16 keys.  It loops over the query tiles that can see
//   its keys (from the diagonal tile upward, and from tile 0 when the key
//   tile holds prefix keys: rows < nv see every key < nv).  It computes
//   the transposed products directly, S^T = K Q^T and dP^T = V dO^T, with
//   the keys as the M dimension of mma.sync m16n8k16, so that P^T and dS^T
//   come out of the accumulators already laid out as the A operand of
//   dV += P^T dO and dK += dS^T Q (the forward's trick for P V).  Q and dO
//   tiles are staged in shared memory twice, [row][dim] for the first two
//   products and [dim][row] for the last two.
// * flash_bwd_dq: one block per (64-query tile, batch x head), each warp
//   owning 16 query rows with their q and dO fragments in registers; it
//   loops over the visible key tiles as the forward does, with K staged
//   [key][dim] and [dim][key] and V [key][dim].
//
// Registers: a warp holds S and dP for 32 columns at a time (two chunks a
// 64-row tile), which halves those accumulators.  In dkv at hd 128 the dK
// and dV accumulators alone are 128 registers a thread, so there the K and
// V fragments are read from shared memory at each use instead of being
// held (kHoldKV).  Shared memory passes 48 KB (56 KB at hd 64, 105 KB at hd
// 128 in dkv), so it is dynamic and raised with cudaFuncSetAttribute.
//
// Numerics: every product accumulates in float32; P and dS are rounded to
// bfloat16 only as tensor-core operands; dQ, dK, dV are rounded once, on
// the way out.
//
// Later work (not here): wgmma with TMA-fed tile rings, skipping the
// masked 32-column chunks of a diagonal tile, and one pass that shares S
// between dkv and dq.  The entry points have a plain C interface and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;             // rows a block owns, rows a staged tile
constexpr int kChunk = 32;            // columns of S a warp holds at once
constexpr int kChunkTiles = kChunk / 8;   // n-tiles of 8 columns a chunk
constexpr int kTStride = kTile + 8;   // a transposed tile's row, padded
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows x 16 dims at k-step kk) of a row-major tile; `row` is
// the fragment's row g of this thread, the second row is row + 8.  `ld` is
// the row stride in elements (shared memory or device memory).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, size_t ld,
                                       int row, int kk, int tq) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = *reinterpret_cast<const uint32_t*>(
        tile + (row + (e & 1) * 8) * ld + kk * 16 + (e >> 1) * 8 + tq * 2);
}

// Stage rows [0, 64) of `src` (row stride `tok`, the rows from `rows` on as
// zeros) into shared memory: row-major with rows of kHeadDim + 8 into `rm`,
// and, when kTransposed, as [dim][row] with rows of kTStride into `tr`.
// Neighbouring threads take neighbouring rows, so the 2-byte stores of one
// dim fall on one row of shared memory and the 16-byte row-major stores on
// distinct banks.
template <int kHeadDim, bool kTransposed>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* src, int rows,
                                           size_t tok, __nv_bfloat16* rm,
                                           __nv_bfloat16* tr) {
  constexpr int kStride = kHeadDim + 8;
  constexpr int kRowChunks = kHeadDim / 8;        // 16-byte chunks a row
  for (unsigned i = threadIdx.x; i < kTile * kRowChunks; i += kThreads) {
    const int r = i & (kTile - 1), c8 = (i / kTile) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * tok + c8);
    *reinterpret_cast<uint4*>(rm + r * kStride + c8) = val;
    if (kTransposed) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c8 + j) * kTStride + r] = e[j];
    }
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * o[b, t, h, d]: 8 dims a thread
// (one 16-byte load of each), the head's kHeadDim / 8 lanes reduced with
// shuffles.  n_rows = B * T * H.
template <int kHeadDim>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ delta, long long n_rows, int T, int H) {
  constexpr int kLanes = kHeadDim / 8;            // 8 or 16: divides a warp
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = idx / kLanes;
  const int c8 = static_cast<int>(idx % kLanes) * 8;
  float sum = 0.f;
  if (row < n_rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * kHeadDim + c8);
    const uint4 b =
        *reinterpret_cast<const uint4*>(dout + row * kHeadDim + c8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]);
      const float2 y = __bfloat1622float2(b2[j]);
      sum += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n_rows && c8 == 0) {
    const long long h = row % H, bt = row / H;
    const long long t = bt % T, b = bt / T;
    delta[(b * H + h) * T + t] = sum;
  }
}

template <int kHeadDim>
constexpr int dkv_smem_bytes() {
  // q, dO row-major; q, dO transposed; K, V row-major; L and delta
  return (4 * kTile * (kHeadDim + 8) + 2 * kHeadDim * kTStride) * 2 +
         2 * kTile * 4;
}

template <int kHeadDim>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              int T, int H, int nv, float scale, float scale_log2) {
  constexpr int kStride = kHeadDim + 8;           // row-major tile row
  constexpr int kDimSteps = kHeadDim / 16;        // k-steps over the dims
  constexpr int kDimTiles = kHeadDim / 8;         // n-tiles of dK, dV
  constexpr bool kHoldKV = kHeadDim <= 64;        // K, V fragments in registers
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kTile * kStride;      // dO [query][dim]
  __nv_bfloat16* ks = dos + kTile * kStride;      // K  [key][dim]
  __nv_bfloat16* vs = ks + kTile * kStride;       // V  [key][dim]
  __nv_bfloat16* qts = vs + kTile * kStride;      // q  [dim][query]
  __nv_bfloat16* dots = qts + kHeadDim * kTStride;  // dO [dim][query]
  float* ls = reinterpret_cast<float*>(dots + kHeadDim * kTStride);
  float* ds = ls + kTile;                         // L (log2 domain), delta

  const int kt = blockIdx.x;                      // tile 0 is the heaviest
  const int key0 = kt * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;         // mma group, thread in group
  const size_t tok = static_cast<size_t>(H) * kHeadDim;   // token stride
  const size_t base = static_cast<size_t>(b) * T * tok +
                      static_cast<size_t>(h) * kHeadDim;
  const size_t rows = static_cast<size_t>(blockIdx.y) * T;  // into L, delta
  const int wrow = warp * 16 + g;                 // this thread's key in tile
  const int krow = key0 + wrow;                   // and krow + 8

  stage_tile<kHeadDim, false>(k + base + key0 * tok, T - key0, tok, ks,
                              nullptr);
  stage_tile<kHeadDim, false>(v + base + key0 * tok, T - key0, tok, vs,
                              nullptr);
  __syncthreads();
  uint32_t kf[kHoldKV ? kDimSteps : 1][4], vf[kHoldKV ? kDimSteps : 1][4];
  if (kHoldKV) {
#pragma unroll
    for (int kk = 0; kk < kDimSteps; ++kk) {
      load_a(kf[kHoldKV ? kk : 0], ks, kStride, wrow, kk, tq);
      load_a(vf[kHoldKV ? kk : 0], vs, kStride, wrow, kk, tq);
    }
  }

  float dka[kDimTiles][4], dva[kDimTiles][4];
#pragma unroll
  for (int nd = 0; nd < kDimTiles; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;
  }

  const int n_qt = (T + kTile - 1) / kTile;
  // rows >= key0 see these keys; rows < nv see them too if they are < nv
  for (int qt = key0 < nv ? 0 : kt; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();                              // last tile's readers done
    stage_tile<kHeadDim, true>(q + base + q0 * tok, T - q0, tok, qs, qts);
    stage_tile<kHeadDim, true>(dout + base + q0 * tok, T - q0, tok, dos,
                               dots);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < T ? lse[rows + r] * kLog2e : 0.f;
      ds[threadIdx.x] = r < T ? delta[rows + r] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += kChunk) {
      // S^T = K q^T and dP^T = V dO^T for 16 keys x 32 queries
      float s[kChunkTiles][4], dp[kChunkTiles][4];
#pragma unroll
      for (int nt = 0; nt < kChunkTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kDimSteps; ++kk) {
        uint32_t ka[4], va[4];
        if (kHoldKV) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kHoldKV ? kk : 0][e];
            va[e] = vf[kHoldKV ? kk : 0][e];
          }
        } else {
          load_a(ka, ks, kStride, wrow, kk, tq);
          load_a(va, vs, kStride, wrow, kk, tq);
        }
#pragma unroll
        for (int nt = 0; nt < kChunkTiles; ++nt) {
          const int off = (qc + nt * 8 + g) * kStride + kk * 16 + tq * 2;
          const uint32_t* qp = reinterpret_cast<const uint32_t*>(qs + off);
          const uint32_t* op = reinterpret_cast<const uint32_t*>(dos + off);
          mma_bf16(s[nt], ka, qp[0], qp[4]);
          mma_bf16(dp[nt], va, op[0], op[4]);
        }
      }
      // P^T into s, dS^T into dp
#pragma unroll
      for (int nt = 0; nt < kChunkTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = krow + (e >> 1) * 8;      // key
          const int col = qc + nt * 8 + tq * 2 + (e & 1);
          const int r = q0 + col;                 // query
          const bool visible = r < T && c < T && c <= max(r, nv - 1);
          const float p =
              visible ? exp2f(s[nt][e] * scale_log2 - ls[col]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - ds[col]);
        }
      }
      // dV += P^T dO and dK += dS^T q: the accumulators are the A
      // fragments, 16 queries a step
#pragma unroll
      for (int j = 0; j < kChunkTiles / 2; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dp[2 * j][0], dp[2 * j][1]),
            pack_bf16(dp[2 * j][2], dp[2 * j][3]),
            pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
            pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
        for (int nd = 0; nd < kDimTiles; ++nd) {
          const int off = (nd * 8 + g) * kTStride + qc + j * 16 + tq * 2;
          const uint32_t* op = reinterpret_cast<const uint32_t*>(dots + off);
          const uint32_t* qp = reinterpret_cast<const uint32_t*>(qts + off);
          mma_bf16(dva[nd], pa, op[0], op[4]);
          mma_bf16(dka[nd], da, qp[0], qp[4]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = krow + i * 8;
    if (c >= T) continue;
#pragma unroll
    for (int nd = 0; nd < kDimTiles; ++nd) {
      const size_t at = base + c * tok + nd * 8 + tq * 2;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dka[nd][2 * i] * scale, dka[nd][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dva[nd][2 * i], dva[nd][2 * i + 1]);
    }
  }
}

template <int kHeadDim>
constexpr int dq_smem_bytes() {
  // K, V row-major; K transposed
  return (2 * kTile * (kHeadDim + 8) + kHeadDim * kTStride) * 2;
}

template <int kHeadDim>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int T, int H, int nv,
             float scale, float scale_log2) {
  constexpr int kStride = kHeadDim + 8;
  constexpr int kDimSteps = kHeadDim / 16;
  constexpr int kDimTiles = kHeadDim / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * kStride;       // V [key][dim]
  __nv_bfloat16* kts = vs + kTile * kStride;      // K [dim][key]

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t tok = static_cast<size_t>(H) * kHeadDim;
  const size_t base = static_cast<size_t>(b) * T * tok +
                      static_cast<size_t>(h) * kHeadDim;
  const size_t rows = static_cast<size_t>(blockIdx.y) * T;
  const int row0 = qt * kTile + warp * 16 + g;    // this thread's query rows:
                                                  // row0 and row0 + 8
  // q and dO fragments from device memory; rows past T as zeros
  uint32_t qf[kDimSteps][4], dof[kDimSteps][4];
#pragma unroll
  for (int kk = 0; kk < kDimSteps; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + (e & 1) * 8;
      const size_t at = base + r * tok + kk * 16 + (e >> 1) * 8 + tq * 2;
      qf[kk][e] = r < T ? *reinterpret_cast<const uint32_t*>(q + at) : 0u;
      dof[kk][e] = r < T ? *reinterpret_cast<const uint32_t*>(dout + at) : 0u;
    }
  }
  float l2[2], dl[2];                             // L (log2 domain), delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + i * 8;
    l2[i] = r < T ? lse[rows + r] * kLog2e : 0.f;
    dl[i] = r < T ? delta[rows + r] : 0.f;
  }
  float dqa[kDimTiles][4];
#pragma unroll
  for (int nd = 0; nd < kDimTiles; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;
  }

  const int last_row = min(qt * kTile + kTile - 1, T - 1);
  const int last_key = min(max(last_row, nv - 1), T - 1);
  const int n_kt = last_key / kTile + 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * kTile;
    __syncthreads();                              // last tile's readers done
    stage_tile<kHeadDim, true>(k + base + key0 * tok, T - key0, tok, ks, kts);
    stage_tile<kHeadDim, false>(v + base + key0 * tok, T - key0, tok, vs,
                                nullptr);
    __syncthreads();

#pragma unroll 1
    for (int kc = 0; kc < kTile; kc += kChunk) {
      // S = q K^T and dP = dO V^T for 16 rows x 32 keys
      float s[kChunkTiles][4], dp[kChunkTiles][4];
#pragma unroll
      for (int nt = 0; nt < kChunkTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kDimSteps; ++kk) {
          const int off = (kc + nt * 8 + g) * kStride + kk * 16 + tq * 2;
          const uint32_t* kp = reinterpret_cast<const uint32_t*>(ks + off);
          const uint32_t* vp = reinterpret_cast<const uint32_t*>(vs + off);
          mma_bf16(s[nt], qf[kk], kp[0], kp[4]);
          mma_bf16(dp[nt], dof[kk], vp[0], vp[4]);
        }
      }
      // dS into dp
#pragma unroll
      for (int nt = 0; nt < kChunkTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + (e >> 1) * 8;
          const int c = key0 + kc + nt * 8 + tq * 2 + (e & 1);
          const bool visible = r < T && c < T && c <= max(r, nv - 1);
          const float p =
              visible ? exp2f(s[nt][e] * scale_log2 - l2[e >> 1]) : 0.f;
          dp[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
        }
      }
      // dQ += dS K: the accumulators are the A fragments, 16 keys a step
#pragma unroll
      for (int j = 0; j < kChunkTiles / 2; ++j) {
        const uint32_t da[4] = {
            pack_bf16(dp[2 * j][0], dp[2 * j][1]),
            pack_bf16(dp[2 * j][2], dp[2 * j][3]),
            pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
            pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
        for (int nd = 0; nd < kDimTiles; ++nd) {
          const uint32_t* kp = reinterpret_cast<const uint32_t*>(
              kts + (nd * 8 + g) * kTStride + kc + j * 16 + tq * 2);
          mma_bf16(dqa[nd], da, kp[0], kp[4]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + i * 8;
    if (r >= T) continue;
#pragma unroll
    for (int nd = 0; nd < kDimTiles; ++nd) {
      *reinterpret_cast<uint32_t*>(dq + base + r * tok + nd * 8 + tq * 2) =
          pack_bf16(dqa[nd][2 * i] * scale, dqa[nd][2 * i + 1] * scale);
    }
  }
}

template <int kHeadDim>
cudaError_t launch_dkv(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* dout,
                       const float* lse, const float* delta,
                       __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int T,
                       int H, int nv, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<kHeadDim>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv<kHeadDim>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(float(kHeadDim));
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  flash_bwd_dkv<kHeadDim><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, T, H, nv, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int kHeadDim>
cudaError_t launch_dq(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, const __nv_bfloat16* dout,
                      const float* lse, const float* delta, __nv_bfloat16* dq,
                      int B, int T, int H, int nv, cudaStream_t st) {
  constexpr int smem = dq_smem_bytes<kHeadDim>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<kHeadDim>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(float(kHeadDim));
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  flash_bwd_dq<kHeadDim><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, T, H, nv, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o, dout: [B, T, H, hd] bf16, contiguous, 16-byte aligned; delta: float32
// [B, H, T]; hd 64 or 128.
int flash_bwd_delta_launch(const void* o, const void* dout, void* delta,
                           int B, int T, int H, int hd, void* stream) {
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(B) * T * H;
  const long long threads = n_rows * (hd / 8);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  auto* dl = static_cast<float*>(delta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    flash_bwd_delta<64><<<blocks, 256, 0, st>>>(ob, db, dl, n_rows, T, H);
  else
    flash_bwd_delta<128><<<blocks, 256, 0, st>>>(ob, db, dl, n_rows, T, H);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dout, dk, dv: [B, T, H, hd] bf16, contiguous, 16-byte aligned;
// lse, delta: float32 [B, H, T]; hd 64 or 128.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int T, int H, int hd,
                         int nv, void* stream) {
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      hd == 64 ? launch_dkv<64>(qb, kb, vb, db, lp, dl, dkb, dvb, B, T, H, nv,
                                st)
               : launch_dkv<128>(qb, kb, vb, db, lp, dl, dkb, dvb, B, T, H,
                                 nv, st));
}

// q, k, v, dout, dq: [B, T, H, hd] bf16, contiguous, 16-byte aligned; lse,
// delta: float32 [B, H, T]; hd 64 or 128.
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int T, int H, int hd, int nv,
                        void* stream) {
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      hd == 64 ? launch_dq<64>(qb, kb, vb, db, lp, dl, dqb, B, T, H, nv, st)
               : launch_dq<128>(qb, kb, vb, db, lp, dl, dqb, B, T, H, nv,
                                st));
}

}  // extern "C"
