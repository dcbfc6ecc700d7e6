// Exact multi-head attention over short sequences (the ViT's N ~ 50
// tokens), for Hopper (sm_90a).
//
// Replaces vidgraph_tpu/ops/short_attention.py::_fused_kernel, which packs
// head pairs into a [2N, 2N] problem padded to 128 rows for the TPU's
// 128-lane matrix unit.  The packing is not carried over: one block per
// (batch, head) computes, for q, k, v [B, H, N, 64] bf16 (the head dim
// contiguous, the other strides given) and out [B, H, N, 64] contiguous:
//
//   s[r, c] = (q[r] . k[c]) * (1 / sqrt(64))           float32
//   p[r, c] = exp(s - max_c s) / sum_c exp(s - max_c s), rounded to bf16
//   out[r]  = sum_c p[r, c] v[c]                        float32, then bf16
//
// the arithmetic of _fused_kernel (expf and an IEEE division, as the plain
// version ops/short_attention.py::short_attention_ref).
//
// What bounds it on the H100: bytes.  Per ViT layer at 5 frames x 12 heads
// (N = 50, HD = 64, bf16) q, k, v and out are 1.54 MB, 0.46 us at 3.35
// TB/s; at 160 frames 49 MB, 14.7 us (1.2 GFLOP).  Nothing of the [N, N]
// scores leaves the block.
//
// Design: 8 warps a block.  Q, K and V are staged in shared memory as
// float32, K's rows padded by four floats so that the 16-byte reads of
// lanes on neighbouring keys fall on distinct banks.  Each warp takes query
// rows in turn: a lane computes the scores of keys lane, lane + 32, ...
// from 16-byte reads (the q row is a broadcast), the max and the sum come
// from warp shuffles, the rounded probabilities go to the warp's row of
// shared memory, and each lane sums p . v for its two adjacent dims,
// reading four probabilities at a time.  FMA on the CUDA cores: the
// kernel is bound by its shared-memory reads; mma.sync for the two
// products is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdk = kHeadDim + 4;        // float4 rows, no bank conflicts
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ __forceinline__ int padded4(int n) {
  return (n + 3) & ~3;
}

size_t smem_bytes(int n) {
  // K [n][kLdk], Q [n][64], V [n][64], probabilities [kWarps][n pad 4]
  return sizeof(float) * (static_cast<size_t>(n) * (kLdk + 2 * kHeadDim) +
                          static_cast<size_t>(kWarps) * padded4(n));
}

__global__ void __launch_bounds__(kThreads)
short_attention(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int H, int N, int64_t sb,
                int64_t sh, int64_t sn, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                         // [N][kLdk]
  float* qs = ks + N * kLdk;              // [N][64]
  float* vs = qs + N * kHeadDim;          // [N][64]
  float* ps = vs + N * kHeadDim;          // [kWarps][N pad 4]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t base = b * sb + h * sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < N * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i - r * kHeadDim;
    const int64_t off = base + r * sn + d;
    qs[i] = __bfloat162float(q[off]);
    ks[r * kLdk + d] = __bfloat162float(k[off]);
    vs[i] = __bfloat162float(v[off]);
  }
  __syncthreads();

  float* p = ps + warp * padded4(N);
  const int d0 = 2 * lane;                // this lane's two output dims
  for (int r = warp; r < N; r += kWarps) {
    const float4* qr = reinterpret_cast<const float4*>(qs + r * kHeadDim);
    float mx = -CUDART_INF_F;
    for (int c = lane; c < N; c += 32) {
      const float4* kr = reinterpret_cast<const float4*>(ks + c * kLdk);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
        const float4 a = qr[d4], kk = kr[d4];
        s = fmaf(a.x, kk.x, s);
        s = fmaf(a.y, kk.y, s);
        s = fmaf(a.z, kk.z, s);
        s = fmaf(a.w, kk.w, s);
      }
      s *= scale;
      p[c] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(p[c] - mx);
      p[c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int c = lane; c < N; c += 32)
      p[c] = __bfloat162float(__float2bfloat16_rn(p[c] / sum));
    __syncwarp();

    float acc0 = 0.f, acc1 = 0.f;
    for (int c4 = 0; c4 < N; c4 += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(p + c4);
      const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c4 + u < N) {
          const float2 v2 = *reinterpret_cast<const float2*>(
              vs + (c4 + u) * kHeadDim + d0);
          acc0 = fmaf(pu[u], v2.x, acc0);
          acc1 = fmaf(pu[u], v2.y, acc1);
        }
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(
        out + (static_cast<int64_t>(blockIdx.x) * N + r) * kHeadDim + d0) =
        __floats2bfloat162_rn(acc0, acc1);
    __syncwarp();                         // p is rewritten by the next row
  }
}

}  // namespace

extern "C" {

int short_attention_head_dim() { return kHeadDim; }

int short_attention_max_smem() { return kMaxSmem; }

int short_attention_smem(int n) { return static_cast<int>(smem_bytes(n)); }

// q, k, v: [B, H, N, 64] bf16 with element strides (sb, sh, sn, 1); out:
// [B, H, N, 64] bf16 contiguous.
int short_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int N, int64_t sb,
                           int64_t sh, int64_t sn, void* stream) {
  const size_t smem = smem_bytes(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        short_attention, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  short_attention<<<B * H, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), H, N, sb, sh, sn,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(kHeadDim))));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
