// Exact multi-head attention over short sequences (the ViT's N ~ 50
// tokens), on the tensor cores of Hopper (sm_90a).
//
// Replaces vidgraph_tpu/ops/short_attention.py::_fused_kernel, which packs
// head pairs into a [2N, 2N] problem padded to 128 rows for the TPU's
// 128-lane matrix unit.  The packing is not carried over.  For q, k, v
// [B, H, N, 64] bf16 (the head dim contiguous, the other strides given, 16
// bytes aligned) and out [B, H, N, 64] contiguous, each head computes
//
//   s[r, c] = (q[r] . k[c]) * (1 / sqrt(64))           float32
//   p[r, c] = exp(s - max_c s) / sum_c exp(s - max_c s), rounded to bf16
//   out[r]  = sum_c p[r, c] v[c]                        float32, then bf16
//
// the arithmetic of _fused_kernel (expf and an IEEE division, as the plain
// version ops/short_attention.py::short_attention_ref).
//
// What bounds it on the H100: bytes and latency.  Per ViT layer at 5
// frames x 12 heads (N = 50, bf16) q, k, v and out are 1.54 MB, 0.46 us at
// 3.35 TB/s; at 160 frames 49 MB, 14.7 us (1.2 GFLOP, 1.2 us of tensor-core
// time).  A head is one 64 x 64 x 64 problem, far too small for a warpgroup
// product to pay for its setup, so the two products run on mma.sync
// m16n8k16 (bf16 in, float32 sums), not wgmma: the time is in the loads.
//
// Design:
// * K and V of a head are staged as bf16 in shared memory by 16-byte
//   cp.async copies into tiles of 64 keys with rows padded to 64 + 8
//   elements (conflict-free ldmatrix); rows at or past N are zero-filled by
//   the copy itself.  Up to four key tiles (N <= 256).  K and the first
//   query strip travel in one copy group, V in a second, so that the scores
//   are computed while V is still in flight.
// * One warp owns a 16-row query strip: its Q rows are staged the same way
//   and loaded into A fragments by ldmatrix.  S = Q K^T takes K's B
//   fragments by ldmatrix from the [key][dim] tile; columns at or past N
//   are set to -inf before the row max.  Row max and sum come from quad
//   shuffles; P (exactly normalised, rounded to bf16) is packed straight
//   from the accumulators into the A fragments of P V, and V's B fragments
//   come from ldmatrix.trans of the [key][dim] tile.
// * The output strip is rounded to bf16, written into the warp's Q slot in
//   shared memory, and stored as 16-byte rows.
// * Grid: one head a block, 4 warps (one a 16-row strip; a warp takes
//   strips 4 apart when N > 64), K and V staged once for its strips.  On
//   an H100 80GB HBM3 at 700 W this was the fastest of three layouts at B
//   1, 5 and 160 x 12 heads (5.3 / 25.8 us at B 5 / 160, against 6.1 /
//   40.4 for a strip a block and 6.1 / 32.0 for two heads a block; PERF.md
//   section 6 has the whole measurement).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kHeadDim = 64;
constexpr int kKeyTile = 64;
constexpr int kMaxKeyTiles = 4;           // N <= 256
constexpr int kStride = kHeadDim + 8;     // a staged row, padded
constexpr int kRowChunks = kHeadDim / 8;  // 16-byte chunks a row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
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

// The 16 rows of query strip `strip` into the warp's slot (zeros past N).
__device__ __forceinline__ void stage_strip(__nv_bfloat16* qs,
                                            const __nv_bfloat16* q,
                                            int64_t base, int64_t sn,
                                            int strip, int N, int lane) {
#pragma unroll
  for (int i = lane; i < 16 * kRowChunks; i += 32) {
    const int r = i / kRowChunks, c8 = (i % kRowChunks) * 8;
    const int row = strip * 16 + r;
    const bool in = row < N;
    cp_async16(qs + r * kStride + c8, q + base + (in ? row : 0) * sn + c8,
               in);
  }
}

// P of one strip, exactly normalised, in the score accumulators.
template <int kKeyTiles>
__device__ __forceinline__ void strip_probs(float (&s)[kKeyTiles * 8][4],
                                            const __nv_bfloat16* qs,
                                            const __nv_bfloat16* ks, int N,
                                            float scale, int lane) {
  const int tq = lane & 3;
  uint32_t qa[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    ldsm_x4(qa[kk], qs + (lane & 15) * kStride + kk * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int nt = 0; nt < kKeyTiles * 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  }
  // S = Q K^T: two n-tiles of 8 keys per ldmatrix.x4
#pragma unroll
  for (int np = 0; np < kKeyTiles * 4; ++np) {
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
    }
  }
  // scale, mask the keys past N, row max over the quad
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int nt = 0; nt < kKeyTiles * 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = nt * 8 + tq * 2 + (e & 1);
      const float x = c < N ? s[nt][e] * scale : -CUDART_INF_F;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int nt = 0; nt < kKeyTiles * 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(s[nt][e] - mx[e >> 1]);
      s[nt][e] = x;
      sum[e >> 1] += x;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
#pragma unroll
  for (int nt = 0; nt < kKeyTiles * 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] / sum[e >> 1];
  }
}

// out strip = P V, rounded to bf16, through the warp's slot to device
// memory (rows < N).
template <int kKeyTiles>
__device__ __forceinline__ void strip_out(const float (&s)[kKeyTiles * 8][4],
                                          __nv_bfloat16* qs,
                                          const __nv_bfloat16* vs,
                                          __nv_bfloat16* out, int strip,
                                          int N, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  float o[kHeadDim / 8][4];
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  }
  // the accumulators of n-tiles 2j, 2j + 1 are the A fragment of keys
  // 16j .. 16j + 15; V's B fragments by ldmatrix.trans, 16 dims a load
#pragma unroll
  for (int j = 0; j < kKeyTiles * 4; ++j) {
    const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                            pack_bf16(s[2 * j][2], s[2 * j][3]),
                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < kHeadDim / 16; ++dp) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             kStride +
                        dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int nd = 0; nd < kHeadDim / 8; ++nd) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(qs + (g + 8 * i) * kStride + nd * 8 +
                                   tq * 2) =
          pack_bf16(o[nd][2 * i], o[nd][2 * i + 1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kRowChunks; i += 32) {
    const int r = i / kRowChunks, c8 = (i % kRowChunks) * 8;
    const int row = strip * 16 + r;
    if (row < N)
      *reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * kHeadDim +
                                c8) =
          *reinterpret_cast<const uint4*>(qs + r * kStride + c8);
  }
  __syncwarp();                           // the slot is restaged next
}

constexpr int kWarps = 4;                 // a block: one head
constexpr int kThreads = 32 * kWarps;

template <int kKeyTiles>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(2 * kKeyTiles * kKeyTile) + kWarps * 16) *
         kStride;
}

template <int kKeyTiles>
__global__ void __launch_bounds__(kThreads)
short_attention(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int H, int N, int64_t sb,
                int64_t sh, int64_t sn, float scale) {
  constexpr int kKeys = kKeyTiles * kKeyTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kKeys * kStride;
  __nv_bfloat16* qs = vs + kKeys * kStride + warp * 16 * kStride;
  const int n_strips = (N + 15) / 16;
  const int head = blockIdx.x;
  const bool has_first = warp < n_strips;
  const int64_t base = static_cast<int64_t>(head / H) * sb +
                       static_cast<int64_t>(head % H) * sh;
  __nv_bfloat16* oh = out + static_cast<int64_t>(head) * N * kHeadDim;

  // group 0: K and the first strip's Q; group 1: V
  for (int i = threadIdx.x; i < kKeys * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c8 = (i % kRowChunks) * 8;
    const bool in = r < N;
    cp_async16(ks + r * kStride + c8, k + base + (in ? r : 0) * sn + c8, in);
  }
  if (has_first) stage_strip(qs, q, base, sn, warp, N, lane);
  cp_async_commit();
  for (int i = threadIdx.x; i < kKeys * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c8 = (i % kRowChunks) * 8;
    const bool in = r < N;
    cp_async16(vs + r * kStride + c8, v + base + (in ? r : 0) * sn + c8, in);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float s[kKeyTiles * 8][4];
  if (has_first) strip_probs<kKeyTiles>(s, qs, ks, N, scale, lane);
  cp_async_wait<0>();
  __syncthreads();
  if (has_first) strip_out<kKeyTiles>(s, qs, vs, oh, warp, N, lane);

  // more strips than warps (N > 64)
  for (int strip = warp + kWarps; strip < n_strips; strip += kWarps) {
    stage_strip(qs, q, base, sn, strip, N, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    strip_probs<kKeyTiles>(s, qs, ks, N, scale, lane);
    strip_out<kKeyTiles>(s, qs, vs, oh, strip, N, lane);
  }
}

template <int kKeyTiles>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* out, int BH, int H, int N,
           int64_t sb, int64_t sh, int64_t sn, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<kKeyTiles>();
  auto* kernel = short_attention<kKeyTiles>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<BH, kThreads, smem, st>>>(
      q, k, v, out, H, N, sb, sh, sn,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(kHeadDim))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v: [B, H, N, 64] bf16 with element strides (sb, sh, sn, 1), 16-byte
// aligned rows (pointers and strides multiples of 8 elements); out:
// [B, H, N, 64] bf16 contiguous; 1 <= N <= 256, 1 <= B * H < 2^31.
int short_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int N, int64_t sb,
                           int64_t sh, int64_t sn, void* stream) {
  if (N < 1 || N > kMaxKeyTiles * kKeyTile || B < 1 || H < 1 ||
      static_cast<int64_t>(B) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  switch ((N + kKeyTile - 1) / kKeyTile) {
    case 1:
      return launch<1>(qb, kb, vb, ob, BH, H, N, sb, sh, sn, st);
    case 2:
      return launch<2>(qb, kb, vb, ob, BH, H, N, sb, sh, sn, st);
    case 3:
      return launch<3>(qb, kb, vb, ob, BH, H, N, sb, sh, sn, st);
    default:
      return launch<4>(qb, kb, vb, ob, BH, H, N, sb, sh, sn, st);
  }
}

}  // extern "C"
