// Cosine scoring with a fused count mask and top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vidgraph_tpu/ops/topk_cosine.py::_score_kernel
// (pallas_call in _pallas_scores, with the mask and the two-stage top-k of
// _fused_cosine_topk_count / _masked_topk around it).  It computes, for
// queries q [B,d] and a store [N,d] of L2-normalised float32 rows:
//
//   q^ = q * rsqrt(sum(q^2) + 1e-12)          (float32 accumulation)
//   s[b,n] = q^[b] . store[n]                 for n <  count
//   s[b,n] = -1e30                            for n >= count (masked)
//
// and either writes the dense scores [B,N] or the top-k (values desc,
// ties to the lower row index as lax.top_k breaks them).
//
// What bounds it on the H100: the store read.  At 200,000 x 512 float32 a
// call reads 410 MB, about 0.12 ms at 3.35 TB/s, while the arithmetic is
// 2*B*N*d = 3.3 GFLOP at B=16: the kernel is memory-bound for the batches
// retrieval sends (1 to 32 queries).  So the design reads each store row
// once for the whole query batch, with 16-byte loads by neighbouring lanes,
// skips the read of masked rows, and keeps every score of a tile in shared
// memory, so that top-k never writes the [B,N] scores to device memory.
// At B=16 the next limit is the shared-memory read of q^ (2 KB a warp for
// each row and query): a warp therefore holds several rows in registers
// (4 at d <= 512) and uses each q^ value it reads for all of them.
//
// Kernel 1, cosine_score_tile: one block of 256 threads per tile of 256
// store rows.  The block normalises its B queries into shared memory; each
// warp walks 32 rows, a few at a time, holds them in registers and reduces
// one dot product per row and query with warp shuffles.  Then it either
// copies the tile's scores to the dense output, or one warp per query picks
// the tile's top k and writes partials [B, n_tiles, k].
// Kernel 2, cosine_topk_merge: one block per query merges the n_tiles
// sorted partial lists head by head into the final [B,k].
//
// Later work (not here): wgmma over a bf16 store, TMA loads, and a
// persistent grid.  The entry points have a plain C interface and return
// cudaGetLastError() so that a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 256;           // store rows per block
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kRowVecs = 16;             // float4 registers a lane gives rows
constexpr float kMasked = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (v, i) beats (w, j) when it scores higher, or equal with a lower index.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    int j = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(w, j, v, i)) { v = w; i = j; }
  }
}

// Shared memory: q^ [bq][d], then the tile's scores [bq][kTileRows].
// k == 0: dense mode, out_scores [B,N].  k > 0: partials
// part_vals / part_idx [B, n_tiles, k].  NV: float4 a lane holds of one
// row (d <= 128 NV); a warp scores kRowVecs / NV rows at a time, so each
// q^ value read from shared memory serves that many rows.
template <int NV>
__global__ void __launch_bounds__(kThreads)
cosine_score_tile(const float* __restrict__ query,
                  const float* __restrict__ store, int bq, int n_rows,
                  int dim, int count, int k, int n_tiles,
                  float* __restrict__ out_scores,
                  float* __restrict__ part_vals,
                  int* __restrict__ part_idx) {
  extern __shared__ float4 smem4[];
  float* qn = reinterpret_cast<float*>(smem4);
  float* tile = qn + bq * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = dim >> 2;
  const int tile0 = blockIdx.x * kTileRows;

  // 1. normalise the queries into shared memory, one warp per query
  for (int b = warp; b < bq; b += kWarps) {
    const float4* src = reinterpret_cast<const float4*>(query + (size_t)b * dim);
    float ss = 0.f;
    for (int c = lane; c < nvec; c += 32) {
      float4 x = src[c];
      ss += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    }
    const float inv = rsqrtf(warp_sum(ss) + 1e-12f);
    float4* dst = reinterpret_cast<float4*>(qn + b * dim);
    for (int c = lane; c < nvec; c += 32) {
      float4 x = src[c];
      dst[c] = make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
    }
  }
  __syncthreads();

  // 2. score the tile: a warp per group of R rows, the rows in registers
  constexpr int R = kRowVecs / NV;
  const float4* q4 = reinterpret_cast<const float4*>(qn);
  for (int r0 = warp * kRowsPerWarp; r0 < (warp + 1) * kRowsPerWarp;
       r0 += R) {
    if (tile0 + r0 >= count) {           // all masked or past the store:
      for (int i = 0; i < R; ++i) {      // no need to read the rows
        const float s = tile0 + r0 + i >= n_rows ? -CUDART_INF_F : kMasked;
        for (int b = lane; b < bq; b += 32) tile[b * kTileRows + r0 + i] = s;
      }
      continue;
    }
    float4 x[R][NV];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = tile0 + r0 + i;
      const float4* s4 =
          reinterpret_cast<const float4*>(store + (size_t)row * dim);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = lane + 32 * j;
        x[i][j] = row < count && c < nvec ? s4[c]
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int b = 0; b < bq; ++b) {
      const float4* qb = q4 + b * nvec;
      float acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = lane + 32 * j;
        if (c < nvec) {
          const float4 y = qb[c];
#pragma unroll
          for (int i = 0; i < R; ++i)
            acc[i] += x[i][j].x * y.x + x[i][j].y * y.y + x[i][j].z * y.z +
                      x[i][j].w * y.w;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int row = tile0 + r0 + i;
          tile[b * kTileRows + r0 + i] =
              row >= n_rows ? -CUDART_INF_F : (row >= count ? kMasked : acc[i]);
        }
      }
    }
  }
  __syncthreads();

  // 3a. dense mode: copy the tile out, coalesced
  if (k == 0) {
    for (int b = 0; b < bq; ++b)
      for (int r = threadIdx.x; r < kTileRows; r += kThreads)
        if (tile0 + r < n_rows)
          out_scores[(size_t)b * n_rows + tile0 + r] = tile[b * kTileRows + r];
    return;
  }

  // 3b. top-k of the tile: one warp per query, k rounds of a warp argmax;
  // lane l owns rows l, l+32, ... so a lane scans in ascending row order
  for (int b = warp; b < bq; b += kWarps) {
    float* sc = tile + b * kTileRows;
    const size_t base = ((size_t)b * n_tiles + blockIdx.x) * k;
    for (int j = 0; j < k; ++j) {
      float v = -CUDART_INF_F;
      int i = kNoIndex;
      for (int r = lane; r < kTileRows; r += 32) {
        const float s = sc[r];
        if (s > v) { v = s; i = r; }
      }
      warp_best(v, i);
      if (lane == 0) {
        part_vals[base + j] = v;
        part_idx[base + j] = i == kNoIndex ? kNoIndex : tile0 + i;
        if (i != kNoIndex) sc[i] = -CUDART_INF_F;   // taken
      }
      __syncwarp();
    }
  }
}

// One block per query: k rounds, each picking the best head among the
// n_tiles sorted partial lists.  Shared memory: one head per tile.
__global__ void __launch_bounds__(kThreads)
cosine_topk_merge(const float* __restrict__ part_vals,
                  const int* __restrict__ part_idx, int n_tiles, int k,
                  float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ int heads[];
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int wt[kWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* pv = part_vals + (size_t)b * n_tiles * k;
  const int* pi = part_idx + (size_t)b * n_tiles * k;
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) heads[t] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float v = -CUDART_INF_F;
    int i = kNoIndex, tb = -1;
    for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
      const int h = heads[t];
      if (h < k) {
        const float w = pv[(size_t)t * k + h];
        const int wj = pi[(size_t)t * k + h];
        if (better(w, wj, v, i)) { v = w; i = wj; tb = t; }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      const int wj = __shfl_xor_sync(0xffffffffu, i, o);
      const int wtb = __shfl_xor_sync(0xffffffffu, tb, o);
      if (better(w, wj, v, i)) { v = w; i = wj; tb = wtb; }
    }
    if (lane == 0) { wv[warp] = v; wi[warp] = i; wt[warp] = tb; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (better(wv[w], wi[w], v, i)) { v = wv[w]; i = wi[w]; tb = wt[w]; }
      vals[(size_t)b * k + j] = v;
      idx[(size_t)b * k + j] = i;
      if (tb >= 0) heads[tb] += 1;
    }
    __syncthreads();
  }
}

size_t score_smem_bytes(int bq, int dim) {
  return (size_t)bq * (dim + kTileRows) * sizeof(float);
}

template <int NV>
int launch_score(const float* query, const float* store, int bq, int n_rows,
                 int dim, int count, int k, float* out_scores,
                 float* part_vals, int* part_idx, cudaStream_t stream) {
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const size_t smem = score_smem_bytes(bq, dim);
  cudaError_t err = cudaFuncSetAttribute(
      cosine_score_tile<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cosine_score_tile<NV><<<n_tiles, kThreads, smem, stream>>>(
      query, store, bq, n_rows, dim, count, k, n_tiles, out_scores,
      part_vals, part_idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cosine_tile_rows() { return kTileRows; }
int cosine_max_dim() { return 32 * 4 * kRowVecs; }

// Scores bq queries against n_rows store rows.  k == 0 writes the dense
// out_scores [bq, n_rows]; k > 0 writes partials [bq, n_tiles, k] with
// n_tiles = ceil(n_rows / cosine_tile_rows()).
int cosine_score_tile_launch(const float* query, const float* store, int bq,
                             int n_rows, int dim, int count, int k,
                             float* out_scores, float* part_vals,
                             int* part_idx, void* stream) {
  const int nv = (dim / 4 + 31) / 32;    // float4 per lane for one row
  cudaStream_t st = (cudaStream_t)stream;
  if (nv <= 4)
    return launch_score<4>(query, store, bq, n_rows, dim, count, k,
                           out_scores, part_vals, part_idx, st);
  if (nv <= 8)
    return launch_score<8>(query, store, bq, n_rows, dim, count, k,
                           out_scores, part_vals, part_idx, st);
  if (nv <= 16)
    return launch_score<16>(query, store, bq, n_rows, dim, count, k,
                            out_scores, part_vals, part_idx, st);
  return (int)cudaErrorInvalidValue;
}

int cosine_topk_merge_launch(const float* part_vals, const int* part_idx,
                             int bq, int n_tiles, int k, float* vals,
                             int* idx, void* stream) {
  const size_t smem = (size_t)n_tiles * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      cosine_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cosine_topk_merge<<<bq, kThreads, smem, (cudaStream_t)stream>>>(
      part_vals, part_idx, n_tiles, k, vals, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
