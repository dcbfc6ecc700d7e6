// FlashAttention forward with a mutually visible vision prefix, for Hopper
// (sm_90a).
//
// Replaces vidgraph_tpu/models/captioner.py::_attn_flash: JAX's Pallas TPU
// flash_attention (causal, 512/384/256/128 blocks over a sequence padded by
// flash_pad_len) followed by a dense recompute of the nv x nv vision-prefix
// corner.  This kernel computes the same function in one pass, for
// q, k, v, out [B, T, H, hd] bfloat16, contiguous, hd 64 or 128 (the heads
// of CaptionerConfig.base()/chat() and of large()):
//
//   s[r,c] = (q[r] . k[c]) / sqrt(hd)                 (float32 accumulation)
//   visible(r,c) = c <= max(r, nv - 1)                 (causal + prefix)
//   out[r] = sum_c softmax_c(s[r,c] | visible) v[c]    (float32, then bf16)
//
// for any T: the last tiles are masked in the kernel, no padding.
//
// What bounds it on the H100: nothing of the [B, H, T, T] score matrix may
// reach device memory (the plain version writes and reads 4.3 GB of float32
// probabilities a layer at B = 32, T = 2056).  Each block keeps its scores
// in registers and runs the online softmax (running max and sum in
// float32); q, k and v are read once per 64-row query tile.  At hd = 64 the
// work per tile is 2 x 64 x 64 x 64 multiply-adds on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).
//
// Design: one block of 4 warps per (64-row query tile, batch x head); each
// warp owns 16 query rows and keeps their q fragments in registers.  Key
// tiles of 64 rows are staged in shared memory, K as [key][dim] and V
// transposed as [dim][key], so that both operands of the two products load
// as 32-bit pairs without bank conflicts (rows padded by 8 elements).  The
// probabilities are rounded to bf16 for the P.V product (the tensor-core
// operand) and their float32 sum is kept unrounded.  Key tiles wholly
// above the diagonal are skipped, except the prefix tile; query tiles run
// heaviest (last) first.  A fully masked tile row never divides by zero:
// its max is -inf, and the exponent is taken against 0 instead.
//
// For training the kernel also writes each row's log-sum-exp
// L[r] = log sum_c exp(s[r,c] | visible), float32 [B, H, T] in natural-log
// units: the one residual the backward kernels of flash_attention_bwd.cu
// recompute the probabilities from (the TPU kernel saves the running max
// and sum separately).  Serving passes a null pointer and takes the
// instantiation without that store (kWriteLse false): the pointer held
// through the kernel cost the hd 64 forward a spilled register and 3-4 %.
//
// Later work (not here): wgmma, TMA loads into a ring of tiles, and warp
// specialisation.  The entry point has a plain C interface and returns
// cudaGetLastError() so that a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 16;                  // the m16 of the mma
constexpr int kQTile = kWarps * kRowsPerWarp;     // 64 query rows a block
constexpr int kKTile = 64;                        // keys a shared tile
constexpr int kVStride = kKTile + 8;              // V^T smem row, padded

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

template <int kHeadDim, bool kWriteLse>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int T, int H, int nv, float scale_log2) {
  constexpr int kKStride = kHeadDim + 8;          // K smem row, padded
  constexpr int kDimSteps = kHeadDim / 16;        // k-steps of q . k
  constexpr int kDimTiles = kHeadDim / 8;         // n-tiles of p . v
  constexpr int kRowChunks = kHeadDim / 8;        // 16-byte chunks a row
  __shared__ __align__(16) __nv_bfloat16 ks[kKTile * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vts[kHeadDim * kVStride];

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;         // mma group, thread in group
  const size_t tok = static_cast<size_t>(H) * kHeadDim;   // token stride
  const size_t base = static_cast<size_t>(b) * T * tok +
                      static_cast<size_t>(h) * kHeadDim;
  // this thread's two query rows: row0 (fragment rows g) and row0 + 8
  const int row0 = qt * kQTile + warp * kRowsPerWarp + g;

  // q fragments (A operand, 16 rows x hd dims = hd / 16 k-steps of 16)
  uint32_t qf[kDimSteps][4];
#pragma unroll
  for (int kk = 0; kk < kDimSteps; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + (e & 1) * 8;
      const int col = kk * 16 + (e >> 1) * 8 + tq * 2;
      qf[kk][e] = r < T ? *reinterpret_cast<const uint32_t*>(
                              q + base + r * tok + col)
                        : 0u;
    }
  }

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l[2] = {0.f, 0.f};                      // running sum (this thread)
  float o[kDimTiles][4];
#pragma unroll
  for (int nd = 0; nd < kDimTiles; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  }

  const int last_row = min(qt * kQTile + kQTile - 1, T - 1);
  const int last_key = min(max(last_row, nv - 1), T - 1);
  const int n_kt = last_key / kKTile + 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * kKTile;
    __syncthreads();                              // last tile's readers done
    // K tile, [key][dim]: neighbouring threads read one key's row
    for (unsigned i = threadIdx.x; i < kKTile * kRowChunks; i += kThreads) {
      const int kr = i / kRowChunks, c8 = (i % kRowChunks) * 8;
      const int key = key0 + kr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key < T)
        val = *reinterpret_cast<const uint4*>(k + base + key * tok + c8);
      *reinterpret_cast<uint4*>(ks + kr * kKStride + c8) = val;
    }
    // V tile transposed, [dim][key]: neighbouring threads take neighbouring
    // keys, so the 2-byte stores of one dim fall on one row of shared memory
    for (unsigned i = threadIdx.x; i < kKTile * kRowChunks; i += kThreads) {
      const int kr = i & (kKTile - 1), c8 = (i / kKTile) * 8;
      const int key = key0 + kr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key < T)
        val = *reinterpret_cast<const uint4*>(v + base + key * tok + c8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[(c8 + j) * kVStride + kr] = e[j];
    }
    __syncthreads();

    // s = q k^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDimSteps; ++kk) {
        const uint32_t* kp = reinterpret_cast<const uint32_t*>(
            ks + (nt * 8 + g) * kKStride + kk * 16 + tq * 2);
        mma_bf16(s[nt], qf[kk], kp[0], kp[4]);
      }
    }

    // scale into the log2 domain and mask; row max over the quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + (e >> 1) * 8;
        const int c = key0 + nt * 8 + tq * 2 + (e & 1);
        const bool visible = c < T && c <= max(r, nv - 1);
        s[nt][e] = visible ? s[nt][e] * scale_log2 : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float sub[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      sub[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i];   // no (-inf) - (-inf)
      alpha[i] = exp2f(m[i] - sub[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - sub[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int nd = 0; nd < kDimTiles; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];
    }

    // o += p v: the s accumulators are the A fragments of p, 16 keys a step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int nd = 0; nd < kDimTiles; ++nd) {
        const uint32_t* vp = reinterpret_cast<const uint32_t*>(
            vts + (nd * 8 + g) * kVStride + j * 16 + tq * 2);
        mma_bf16(o[nd], pa, vp[0], vp[4]);
      }
    }
  }

  // normalise and write the two rows' dims, 2 per 32-bit store
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  // m is in the log2 domain: L = (m + log2 l) ln 2.  Key 0 is visible to
  // every row, so l > 0.
  if (kWriteLse && tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + i * 8;
      if (r < T)
        lse[static_cast<size_t>(blockIdx.y) * T + r] =
            (m[i] + log2f(l[i])) * 0.6931471805599453f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + i * 8;
    if (r >= T) continue;
#pragma unroll
    for (int nd = 0; nd < kDimTiles; ++nd) {
      *reinterpret_cast<uint32_t*>(out + base + r * tok + nd * 8 + tq * 2) =
          pack_bf16(o[nd][2 * i] * inv[i], o[nd][2 * i + 1] * inv[i]);
    }
  }
}

}  // namespace

extern "C" {

// 1 where the kernel takes the head dim, else 0.
int flash_takes_head_dim(int hd) { return hd == 64 || hd == 128; }

// q, k, v, out: [B, T, H, hd] bf16, contiguous, 16-byte aligned; hd 64 or
// 128.  lse: float32 [B, H, T], or null to write none.
int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                          void* out, void* lse, int B, int T, int H, int hd,
                          int nv, void* stream) {
  if (!flash_takes_head_dim(hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + kQTile - 1) / kQTile, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf(float(hd));
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64 && lp == nullptr)
    flash_attn_fwd<64, false><<<grid, kThreads, 0, st>>>(
        qb, kb, vb, ob, lp, T, H, nv, scale_log2);
  else if (hd == 64)
    flash_attn_fwd<64, true><<<grid, kThreads, 0, st>>>(
        qb, kb, vb, ob, lp, T, H, nv, scale_log2);
  else if (lp == nullptr)
    flash_attn_fwd<128, false><<<grid, kThreads, 0, st>>>(
        qb, kb, vb, ob, lp, T, H, nv, scale_log2);
  else
    flash_attn_fwd<128, true><<<grid, kThreads, 0, st>>>(
        qb, kb, vb, ob, lp, T, H, nv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
