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
// for any T (ragged last tiles are masked, rows past T are staged as zeros)
// and any B x H (folded over the grid's y and z, as in the forward).  Other
// float types and head dims take attention_general.cu's backward kernels.
//
// What bounds it on the H100: operations.  Per visible (query, key) pair
// the backward needs five products (S, dP, dV, dK, dQ) against the
// forward's two; nothing of the [B, H, T, T] P or dS may reach device
// memory.
//
// Design: three launches, five products.
// * flash_bwd_delta: delta = rowsum(dO * o), written as [B, H, T], and the
//   float32 dQ accumulator [B, T, H, hd] zeroed (no memset launch).
// * flash_bwd_fused: one block of 4 warps per (64-key tile, batch x head),
//   each warp owning 16 keys; K and V stay in shared memory, and at hd 64
//   their A fragments in registers.  The block loops over the query tiles
//   that can see its keys (from the diagonal tile, and from tile 0 when
//   the key tile holds prefix keys: rows < nv see every key < nv).  Per
//   query tile, in chunks of 32 queries, each warp computes
//   S^T = K Q^T and dP^T = V dO^T (keys as the M dimension of mma.sync
//   m16n8k16), P^T and dS^T in registers, and accumulates dV += P^T dO and
//   dK += dS^T Q in registers: P^T and dS^T leave the accumulators already
//   laid out as A fragments; the B fragments of Q and dO come by ldmatrix
//   from the [query][dim] tiles (.trans for the last two products), so Q
//   and dO are staged once.  dS^T goes to shared memory as bf16; after a
//   barrier each warp computes dQ for 16 queries of the tile, dS K with dS
//   by ldmatrix.trans and K by ldmatrix.trans, and adds it into the float32
//   accumulator with Hopper's two-float atomics (red.global.add.v2.f32).
//   The next query tile's Q, dO, L and delta are staged by cp.async into a
//   two-stage ring while the current one is computed.  32-query chunks
//   (and dQ's 16 x 16 steps) that the mask hides wholly are skipped.
// * flash_bwd_dq_convert: dQ = bf16(scale * accumulator).
//
// dK and dV are written by the block that owns them, so two runs give them
// the same bits; dQ's sums arrive in an order that changes from run to run,
// so its last bits may differ.
//
// Registers: a warp holds S and dP for 32 queries at a time.  At hd 128 the
// dK and dV accumulators alone are 128 registers a thread, so there the K
// and V fragments are read from shared memory at each use (kHoldKV), and
// dQ is computed 64 dims at a time.  Shared memory (66 KB at hd 64, 115 KB
// at hd 128) is dynamic, raised with cudaFuncSetAttribute.
//
// Numerics: every product accumulates in float32; P and dS are rounded to
// bfloat16 only as tensor-core operands; dK, dV and dQ are rounded once, on
// the way out.
//
// Later work (not here): wgmma with K and V as the shared-memory A operand
// and TMA-fed tile rings.  The entry points have a plain C interface and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;             // keys a block owns, queries a tile
constexpr int kChunk = 32;            // queries of S a warp holds at once
constexpr int kDsStride = kTile + 8;  // dS^T smem row, padded
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// Rows [0, 64) of `src` (token stride `tok`; rows from `rows` on as zeros)
// into a [64][kHeadDim + 8] shared tile by 16-byte cp.async copies:
// neighbouring threads copy neighbouring chunks of a row.
template <int kHeadDim>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int rows,
                                           size_t tok) {
  constexpr int kRowChunks = kHeadDim / 8;
  for (unsigned i = threadIdx.x; i < kTile * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c8 = (i % kRowChunks) * 8;
    const bool in = r < rows;
    cp_async16(dst + r * (kHeadDim + 8) + c8, src + (in ? r : 0) * tok + c8,
               in);
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * o[b, t, h, d]: 8 dims a thread
// (one 16-byte load of each), the head's kHeadDim / 8 lanes reduced with
// shuffles; the same thread zeroes its 8 floats of the dQ accumulator.
// n_rows = B * T * H.
template <int kHeadDim>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ delta, float* __restrict__ dq_accum,
                long long n_rows, int T, int H) {
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
    float4* acc = reinterpret_cast<float4*>(dq_accum + row * kHeadDim + c8);
    acc[0] = acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
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
constexpr int fused_smem_bytes() {
  // K, V; two stages of q and dO; dS^T; two stages of L and delta
  return (6 * kTile * (kHeadDim + 8) + kTile * kDsStride) * 2 +
         4 * kTile * 4;
}

// kFold: (batch, head) folded over the grid's y and z, for B * H past y's
// 65,535; the instantiation without it is the kernel every smaller B * H
// takes.
template <int kHeadDim, bool kFold>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                float* __restrict__ dq_accum, int T, int H, int nv,
                float scale, float scale_log2, int BH) {
  constexpr int kStride = kHeadDim + 8;           // a staged row, padded
  constexpr int kTileElems = kTile * kStride;
  constexpr int kDimSteps = kHeadDim / 16;        // k-steps over the dims
  constexpr int kDimTiles = kHeadDim / 8;         // n-tiles of dK, dV
  constexpr bool kHoldKV = kHeadDim <= 64;        // K, V fragments in registers
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [key][dim]
  __nv_bfloat16* vs = ks + kTileElems;                          // [key][dim]
  __nv_bfloat16* qs = vs + kTileElems;        // [2][query][dim]
  __nv_bfloat16* dos = qs + 2 * kTileElems;   // [2][query][dim]
  __nv_bfloat16* dss = dos + 2 * kTileElems;  // dS^T [key][query]
  float* ls = reinterpret_cast<float*>(dss + kTile * kDsStride);  // [2][64]
  float* dls = ls + 2 * kTile;                                    // [2][64]

  const int kt = blockIdx.x;                      // tile 0 is the heaviest
  const int key0 = kt * kTile;
  // unsigned, as blockIdx.y: the non-fold instantiation is the kernel
  // these shapes took before the fold, instruction for instruction
  unsigned bh = blockIdx.y;
  if (kFold) {
    bh += blockIdx.z * gridDim.y;
    if (bh >= static_cast<unsigned>(BH)) return;
  }
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;         // mma group, thread in group
  const size_t tok = static_cast<size_t>(H) * kHeadDim;   // token stride
  const size_t base = static_cast<size_t>(b) * T * tok +
                      static_cast<size_t>(h) * kHeadDim;
  const size_t rows = static_cast<size_t>(bh) * T;  // into L, delta
  const int kw0 = key0 + warp * 16;               // this warp's first key
  const int krow = kw0 + g;                       // this thread's keys: krow
                                                  // and krow + 8
  // ldmatrix lane offsets: A of a [row][col] tile; B (two n-tiles) of a
  // [n][k] tile; B (two n-tiles) of a [k][n] tile by .trans
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;

  auto stage_queries = [&](int qt, int st) {
    const int q0 = qt * kTile;
    stage_tile<kHeadDim>(qs + st * kTileElems, q + base + q0 * tok, T - q0,
                         tok);
    stage_tile<kHeadDim>(dos + st * kTileElems, dout + base + q0 * tok,
                         T - q0, tok);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      const bool in = r < T;
      cp_async4(ls + st * kTile + threadIdx.x, lse + rows + (in ? r : 0), in);
      cp_async4(dls + st * kTile + threadIdx.x, delta + rows + (in ? r : 0),
                in);
    }
  };

  stage_tile<kHeadDim>(ks, k + base + key0 * tok, T - key0, tok);
  stage_tile<kHeadDim>(vs, v + base + key0 * tok, T - key0, tok);
  cp_async_commit();
  const int n_qt = (T + kTile - 1) / kTile;
  // rows >= key0 see these keys; rows < nv see them too if they are < nv
  const int qt0 = key0 < nv ? 0 : kt;
  stage_queries(qt0, 0);
  cp_async_commit();
  cp_async_wait<1>();                             // K and V
  __syncthreads();

  uint32_t kf[kHoldKV ? kDimSteps : 1][4], vf[kHoldKV ? kDimSteps : 1][4];
  if (kHoldKV) {
#pragma unroll
    for (int kk = 0; kk < kDimSteps; ++kk) {
      const int off = (warp * 16 + a_row) * kStride + kk * 16 + a_col;
      ldsm_x4(kf[kHoldKV ? kk : 0], ks + off);
      ldsm_x4(vf[kHoldKV ? kk : 0], vs + off);
    }
  }
  float dka[kDimTiles][4], dva[kDimTiles][4];
#pragma unroll
  for (int nd = 0; nd < kDimTiles; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;
  }

  for (int qt = qt0, st = 0; qt < n_qt; ++qt, st ^= 1) {
    const int q0 = qt * kTile;
    if (qt + 1 < n_qt) {
      stage_queries(qt + 1, st ^ 1);              // read last in qt - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                              // tile qt staged
    const __nv_bfloat16* qst = qs + st * kTileElems;
    const __nv_bfloat16* dost = dos + st * kTileElems;
    const float* lst = ls + st * kTile;
    const float* dlst = dls + st * kTile;

#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += kChunk) {
      const int c0 = q0 + qc;
      // every (key, query) pair of this warp and chunk is hidden
      if (kw0 >= T || c0 >= T || kw0 > max(c0 + kChunk - 1, nv - 1))
        continue;
      // S^T = K q^T and dP^T = V dO^T for 16 keys x 32 queries
      float s[kChunk / 8][4], dp[kChunk / 8][4];
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
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
          const int off = (warp * 16 + a_row) * kStride + kk * 16 + a_col;
          ldsm_x4(ka, ks + off);
          ldsm_x4(va, vs + off);
        }
#pragma unroll
        for (int np = 0; np < kChunk / 16; ++np) {
          const int off = (qc + np * 16 + b_row) * kStride + kk * 16 + b_col;
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, qst + off);
          ldsm_x4(ob, dost + off);
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * np], va, ob[0], ob[1]);
          mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // P^T into s, dS^T into dp, and dS^T to shared memory
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = krow + (e >> 1) * 8;      // key
          const int col = qc + nt * 8 + tq * 2 + (e & 1);
          const int r = q0 + col;                 // query
          const bool visible = r < T && c < T && c <= max(r, nv - 1);
          const float p =
              visible ? exp2f(s[nt][e] * scale_log2 - lst[col] * kLog2e)
                      : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dlst[col]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(
              dss + (warp * 16 + g + 8 * i) * kDsStride + qc + nt * 8 +
              tq * 2) = pack_bf16(dp[nt][2 * i], dp[nt][2 * i + 1]);
      }
      // dV += P^T dO and dK += dS^T q: the accumulators are the A
      // fragments, 16 queries a step; dO and q by ldmatrix.trans
#pragma unroll
      for (int j = 0; j < kChunk / 16; ++j) {
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
        for (int d2 = 0; d2 < kDimTiles / 2; ++d2) {
          const int off = (qc + j * 16 + t_row) * kStride + d2 * 16 + t_col;
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, dost + off);
          ldsm_x4_t(qb, qst + off);
          mma_bf16(dva[2 * d2], pa, ob[0], ob[1]);
          mma_bf16(dva[2 * d2 + 1], pa, ob[2], ob[3]);
          mma_bf16(dka[2 * d2], da, qb[0], qb[1]);
          mma_bf16(dka[2 * d2 + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();                              // dS^T of the tile written

    // dQ of this warp's 16 queries: dS K over the tile's visible 16-key
    // steps, 64 dims at a time, added into the float32 accumulator
    const int qw0 = q0 + warp * 16;
    const int see = max(qw0 + 15, nv - 1);        // last key these rows see
    if (qw0 < T && key0 <= see) {
#pragma unroll 1
      for (int d0 = 0; d0 < kHeadDim; d0 += 64) {
        float acc[8][4];
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) {
          const int j0 = key0 + j * 16;
          if (j0 >= T || j0 > see) continue;      // warp-uniform
          uint32_t a[4];
          ldsm_x4_t(a, dss + (j * 16 + b_row) * kDsStride + warp * 16 + b_col);
#pragma unroll
          for (int d2 = 0; d2 < 4; ++d2) {
            uint32_t kb[4];
            ldsm_x4_t(kb, ks + (j * 16 + t_row) * kStride + d0 + d2 * 16 +
                              t_col);
            mma_bf16(acc[2 * d2], a, kb[0], kb[1]);
            mma_bf16(acc[2 * d2 + 1], a, kb[2], kb[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = qw0 + g + 8 * i;
          if (r >= T) continue;
#pragma unroll
          for (int nd = 0; nd < 8; ++nd)          // result unused: red
            atomicAdd(reinterpret_cast<float2*>(
                          dq_accum + base + r * tok + d0 + nd * 8 + tq * 2),
                      make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]));
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

// dq = bf16(scale * dq_accum), 8 elements a thread; n a multiple of 8.
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert(const float* __restrict__ dq_accum,
                     __nv_bfloat16* __restrict__ dq, long long n,
                     float scale) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  const float4 a = *reinterpret_cast<const float4*>(dq_accum + i);
  const float4 b = *reinterpret_cast<const float4*>(dq_accum + i + 4);
  *reinterpret_cast<uint4*>(dq + i) = make_uint4(
      pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale),
      pack_bf16(b.x * scale, b.y * scale),
      pack_bf16(b.z * scale, b.w * scale));
}

template <int kHeadDim>
cudaError_t launch_fused(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const __nv_bfloat16* dout,
                         const float* lse, const float* delta,
                         __nv_bfloat16* dk, __nv_bfloat16* dv,
                         float* dq_accum, int B, int T, int H, int nv,
                         cudaStream_t st) {
  constexpr int smem = fused_smem_bytes<kHeadDim>();
  const int bh = B * H, y = bh < 65535 ? bh : 65535;
  auto* kern = bh > y ? flash_bwd_fused<kHeadDim, true>
                      : flash_bwd_fused<kHeadDim, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(float(kHeadDim));
  const dim3 grid((T + kTile - 1) / kTile, y, (bh + y - 1) / y);
  kern<<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, dq_accum, T, H, nv, scale,
      scale * kLog2e, bh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o, dout: [B, T, H, hd] bf16, contiguous, 16-byte aligned; delta: float32
// [B, H, T]; dq_accum: float32 [B, T, H, hd], zeroed here; hd 64 or 128.
int flash_bwd_delta_launch(const void* o, const void* dout, void* delta,
                           void* dq_accum, int B, int T, int H, int hd,
                           void* stream) {
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(B) * T * H;
  const long long threads = n_rows * (hd / 8);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  auto* dl = static_cast<float*>(delta);
  auto* acc = static_cast<float*>(dq_accum);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    flash_bwd_delta<64><<<blocks, 256, 0, st>>>(ob, db, dl, acc, n_rows, T,
                                                H);
  else
    flash_bwd_delta<128><<<blocks, 256, 0, st>>>(ob, db, dl, acc, n_rows, T,
                                                 H);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dout, dk, dv: [B, T, H, hd] bf16, contiguous, 16-byte aligned;
// lse, delta: float32 [B, H, T]; dq_accum: float32 [B, T, H, hd], zeroed
// (by flash_bwd_delta_launch), summed into; hd 64 or 128.
int flash_bwd_fused_launch(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv,
                           void* dq_accum, int B, int T, int H, int hd,
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
  auto* acc = static_cast<float*>(dq_accum);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      hd == 64 ? launch_fused<64>(qb, kb, vb, db, lp, dl, dkb, dvb, acc, B, T,
                                  H, nv, st)
               : launch_fused<128>(qb, kb, vb, db, lp, dl, dkb, dvb, acc, B,
                                   T, H, nv, st));
}

// dq: [B, T, H, hd] bf16 = bf16(dq_accum * float(1 / sqrt(hd))), the scale
// rounded once from double; n = B*T*H*hd.
int flash_bwd_dq_convert_launch(const void* dq_accum, void* dq, long long n,
                                int hd, void* stream) {
  if ((hd != 64 && hd != 128) || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n / 8 + 255) / 256);
  flash_bwd_dq_convert<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dq_accum), static_cast<__nv_bfloat16*>(dq), n,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd))));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
