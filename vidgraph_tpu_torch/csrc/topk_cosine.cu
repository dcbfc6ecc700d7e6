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
// call reads 410 MB, 0.122 ms at 3.35 TB/s; the arithmetic, 2*B*N*d = 3.3
// GFLOP at B=16, is 0.049 ms at the 67 TFLOP/s of float32 FMAs.  The first
// design (one block per 256-row tile, a warp shuffle reduction per row and
// query, rows loaded in bursts with no copy in flight while scoring) was
// bound by instructions at B=16 and by load latency at B=1: 2.0-2.7x its
// bound on an NVIDIA H100 80GB HBM3 at 700 W.
//
// This design:
// * a persistent grid, one block of 4 warps per SM, each walking a
//   contiguous segment of 256-row tiles, so the store streams once;
// * a ring of 2-6 shared-memory stages (as many as fit beside q^), each a
//   256-row x 32-float slice of a tile brought by one TMA copy
//   (cp.async.bulk.tensor over a 2-D tensor map of the store's first
//   `count` rows, encoded on the host by libcuda's
//   cuTensorMapEncodeTiled, looked up at run time: no -lcuda), 128-byte swizzled, on an mbarrier
//   a stage.  Rows at or past count and columns past d are zero-filled by
//   the copy engine and never read.  The next slices are in flight while
//   this one is scored.  (16-byte cp.async copies by every thread, the
//   first version, kept too few bytes in flight: 0.22-0.25 ms at B 1-16);
// * register tiling as an SGEMM: each thread holds 2 rows x QB queries of
//   float32 accumulators (QB the batch rounded up to a power of two) over
//   the d-slices, reads its rows' float4 from the stage (the swizzle puts
//   eight neighbouring rows' float4 in eight bank groups) and each q^
//   float4 as a warp-wide broadcast.  No shuffle per dot product; each q^
//   read serves 64 rows, each row read serves QB queries;
// * top-k: at each tile's end the scores go to shared memory and one warp
//   per query merges the candidates that beat its running k-th best into a
//   sorted list of k kept for the whole segment.  The partials are one list
//   per segment [B, n_segments, k]; cosine_topk_merge merges them.
//
// Left as later work: a bfloat16 store (no config asks for one) and a
// merge folded into the grid.  The entry points have a plain C interface
// and return cudaGetLastError() so that a refused launch is reported to
// the caller; a launch returns cudaErrorNotSupported where libcuda
// offers no tensor-map encoder.

#include "tma.cuh"

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using namespace vg_tma;

constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 2;                   // rows a thread scores
constexpr int kTileRows = kWarps * 32 * kRT;   // 256
constexpr int kDK = 32;                  // floats of a row in one stage
constexpr int kStageBytes = kTileRows * kDK * 4;   // 32 KB, 128 B rows
constexpr int kMaxStages = 6;
constexpr int kMaxK = 64;
constexpr int kMaxQueries = 32;
constexpr int kMaxDim = 2048;
constexpr int kSmemLimit = 232448;       // opt-in shared memory on sm_90
// the 1024-byte alignment of the swizzled ring and its mbarriers
constexpr int kExtraBytes = 1024 + 8 * kMaxStages;
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

// The [256 rows][32 floats] box of the store at (column c0, row r0),
// 128-byte swizzled, counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

__host__ __device__ constexpr int padded_dim(int dim) {
  return (dim + kDK - 1) / kDK * kDK;
}

// Shared memory beside the ring: q^, the tile's scores, the lists.
size_t side_bytes(int qb, int dim) {
  return sizeof(float) * ((size_t)qb * padded_dim(dim) +
                          (size_t)qb * kTileRows) +
         (size_t)qb * kMaxK * (sizeof(float) + sizeof(int));
}

// Stages of the ring: as many as fit beside the rest, at most kMaxStages.
int stages_for(int qb, int dim) {
  const long long room =
      (long long)kSmemLimit - kExtraBytes - (long long)side_bytes(qb, dim);
  return (int)(room / kStageBytes < kMaxStages ? room / kStageBytes
                                               : kMaxStages);
}

// One warp merges query b's tile scores sc[kTileRows] into its sorted
// list (lv, li)[k]: every row that beats the list's k-th entry is
// inserted at its rank.  Lane l owns rows l, l + 32, ...
__device__ void merge_tile(const float* sc, float* lv, int* li, int k,
                           int tile0, int n_rows) {
  const int lane = threadIdx.x & 31;
  float tv = lv[k - 1];
  int ti = li[k - 1];
  for (int j = 0; j < kTileRows / 32; ++j) {
    const int row = tile0 + j * 32 + lane;
    const float v = sc[j * 32 + lane];
    const bool in = row < n_rows;
    unsigned m = __ballot_sync(0xffffffffu, in && better(v, row, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      const float cv = __shfl_sync(0xffffffffu, v, src);
      const int ci = __shfl_sync(0xffffffffu, row, src);
      // its rank: the list entries that beat it (the list is sorted)
      const int e0 = lane, e1 = lane + 32;
      const bool b0 = e0 < k && better(lv[e0], li[e0], cv, ci);
      const bool b1 = e1 < k && better(lv[e1], li[e1], cv, ci);
      const int pos = __popc(__ballot_sync(0xffffffffu, b0)) +
                      __popc(__ballot_sync(0xffffffffu, b1));
      const bool s0 = e0 >= pos && e0 < k - 1, s1 = e1 >= pos && e1 < k - 1;
      const float v0 = s0 ? lv[e0] : 0.f, v1 = s1 ? lv[e1] : 0.f;
      const int i0 = s0 ? li[e0] : 0, i1 = s1 ? li[e1] : 0;
      __syncwarp();
      if (s0) { lv[e0 + 1] = v0; li[e0 + 1] = i0; }
      if (s1) { lv[e1 + 1] = v1; li[e1 + 1] = i1; }
      if (lane == 0) { lv[pos] = cv; li[pos] = ci; }
      __syncwarp();
      tv = lv[k - 1];
      ti = li[k - 1];
      m &= ~(1u << src);
      m &= __ballot_sync(0xffffffffu, in && better(v, row, tv, ti));
    }
  }
}

// Shared memory: the ring [stages][kTileRows][kDK] (1024-byte aligned,
// swizzled), q^ [QB][dpad], the tile's scores [QB][kTileRows], the lists'
// values and indices [QB][kMaxK], one mbarrier a stage.  k == 0: dense
// mode, out_scores [bq, n_rows].  k > 0: partials part_vals / part_idx
// [bq, gridDim.x, k], one sorted list per segment of tiles_per_block tiles.
template <int QB>
__global__ void __launch_bounds__(kThreads, 1)
cosine_score_tile(const float* __restrict__ query,
                  const __grid_constant__ CUtensorMap store_map, int bq,
                  int n_rows, int dim, int count, int k, int tiles_per_block,
                  int stages, float* __restrict__ out_scores,
                  float* __restrict__ part_vals,
                  int* __restrict__ part_idx) {
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((1024 - __cvta_generic_to_shared(smem_raw) % 1024) % 1024));
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int dpad = padded_dim(dim);
  float* qn = ring + stages * kTileRows * kDK;
  float* sc = qn + QB * dpad;
  float* lv = sc + QB * kTileRows;
  int* li = reinterpret_cast<int*>(lv + QB * kMaxK);
  const uint32_t full = static_cast<uint32_t>(
      __cvta_generic_to_shared(li + QB * kMaxK) + 7) & ~7u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  const int n_chunks = dpad / kDK;
  const int n_steps = (t_end - t_begin) * n_chunks;

  // step j into its stage, by thread 0: tile t_begin + j / n_chunks,
  // columns (j % n_chunks) * kDK.  Nothing is read when count is 0.
  auto fetch = [&](int j) {
    const int slot = j % stages;
    if (count > 0) {
      mbar_expect(full + 8 * slot, kStageBytes);
      tma_load(ring_s + slot * kStageBytes, &store_map, (j % n_chunks) * kDK,
               (t_begin + j / n_chunks) * kTileRows, full + 8 * slot);
    } else {
      mbar_expect(full + 8 * slot, 0);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < stages - 1 && j < n_steps; ++j) fetch(j);
  }

  // q^ into shared memory, zero past bq and past dim; the lists empty
  for (int b = warp; b < QB; b += kWarps) {
    const float4* src =
        reinterpret_cast<const float4*>(query + (size_t)b * dim);
    float ss = 0.f;
    if (b < bq)
      for (int c = lane; c < dim / 4; c += 32) {
        const float4 x = src[c];
        ss += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      }
    const float inv = b < bq ? rsqrtf(warp_sum(ss) + 1e-12f) : 0.f;
    float4* dst = reinterpret_cast<float4*>(qn + b * dpad);
    for (int c = lane; c < dpad / 4; c += 32) {
      const float4 x = b < bq && c < dim / 4 ? src[c]
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[c] = make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
    }
  }
  for (int i = threadIdx.x; i < QB * kMaxK; i += kThreads) {
    lv[i] = -CUDART_INF_F;
    li[i] = kNoIndex;
  }

  float acc[kRT][QB];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int b = 0; b < QB; ++b) acc[i][b] = 0.f;
  // this thread's rows of a tile
  int rr[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) rr[i] = warp * 32 * kRT + i * 32 + lane;

  for (int s = 0; s < n_steps; ++s) {
    __syncthreads();                     // step s - 1's stage is read: it
    if (threadIdx.x == 0 && s + stages - 1 < n_steps)   // takes step
      fetch(s + stages - 1);                            // s + stages - 1
    mbar_wait(full + 8 * (s % stages), (s / stages) & 1);   // step s landed

    const int tile = t_begin + s / n_chunks, chunk = s % n_chunks;
    const float* st = ring + (s % stages) * kTileRows * kDK;
    const float* qs = qn + chunk * kDK;
#pragma unroll
    for (int kk = 0; kk < kDK / 4; ++kk) {
      float4 x[kRT];
      // row r's 16-byte chunk c lies at chunk c ^ (r % 8) of its 128 B
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        x[i] = *reinterpret_cast<const float4*>(
            st + rr[i] * kDK + ((kk ^ (rr[i] & 7)) << 2));
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        const float4 y =
            *reinterpret_cast<const float4*>(qs + b * dpad + kk * 4);
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          float a = acc[i][b];
          a = fmaf(x[i].x, y.x, a);
          a = fmaf(x[i].y, y.y, a);
          a = fmaf(x[i].z, y.z, a);
          a = fmaf(x[i].w, y.w, a);
          acc[i][b] = a;
        }
      }
    }
    if (chunk != n_chunks - 1) continue;
    // the tile is scored: mask, then write it out or merge its top-k
    const int tile0 = tile * kTileRows;
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int row = tile0 + rr[i];
#pragma unroll
        for (int b = 0; b < QB; ++b)
          if (b < bq && row < n_rows)
            out_scores[(size_t)b * n_rows + row] =
                row >= count ? kMasked : acc[i][b];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int row = tile0 + rr[i];
#pragma unroll
        for (int b = 0; b < QB; ++b)
          sc[b * kTileRows + rr[i]] =
              row >= n_rows ? -CUDART_INF_F
                            : (row >= count ? kMasked : acc[i][b]);
      }
      __syncthreads();
      // the next write of sc is past the next step's barrier
      for (int b = warp; b < bq; b += kWarps)
        merge_tile(sc + b * kTileRows, lv + b * kMaxK, li + b * kMaxK, k,
                   tile0, n_rows);
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int b = 0; b < QB; ++b) acc[i][b] = 0.f;
  }
  if (k > 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < bq * k; i += kThreads) {
      const int b = i / k, j = i % k;
      const size_t o = ((size_t)b * gridDim.x + blockIdx.x) * k + j;
      part_vals[o] = lv[b * kMaxK + j];
      part_idx[o] = li[b * kMaxK + j];
    }
  }
}

// One block per query: k rounds, each picking the best head among the
// n_parts sorted partial lists.  Shared memory: one head per list.
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;

__global__ void __launch_bounds__(kMergeThreads)
cosine_topk_merge(const float* __restrict__ part_vals,
                  const int* __restrict__ part_idx, int n_parts, int k,
                  float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ int heads[];
  __shared__ float wv[kMergeWarps];
  __shared__ int wi[kMergeWarps];
  __shared__ int wt[kMergeWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* pv = part_vals + (size_t)b * n_parts * k;
  const int* pi = part_idx + (size_t)b * n_parts * k;
  for (int t = threadIdx.x; t < n_parts; t += kMergeThreads) heads[t] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float v = -CUDART_INF_F;
    int i = kNoIndex, tb = -1;
    for (int t = threadIdx.x; t < n_parts; t += kMergeThreads) {
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
      for (int w = 1; w < kMergeWarps; ++w)
        if (better(wv[w], wi[w], v, i)) { v = wv[w]; i = wi[w]; tb = wt[w]; }
      vals[(size_t)b * k + j] = v;
      idx[(size_t)b * k + j] = i;
      if (tb >= 0) heads[tb] += 1;
    }
    __syncthreads();
  }
}

// A 2-D map of the store's first max(count, 1) rows [rows][dim] float32
// that loads [256 rows][32 floats] boxes, 128-byte swizzled, zero past
// the rows and past dim.
bool encode_store_map(CUtensorMap* map, const float* store, int count,
                      int dim) {
  const PFN_cuTensorMapEncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)dim,
                              (cuuint64_t)(count > 0 ? count : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)dim * 4};
  const cuuint32_t box[2] = {kDK, kTileRows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(store), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int QB>
int launch_score(const float* query, const CUtensorMap& map, int bq,
                 int n_rows, int dim, int count, int k, int tiles_per_block,
                 float* out_scores, float* part_vals, int* part_idx,
                 cudaStream_t stream) {
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int grid = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const int stages = stages_for(QB, dim);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem =
      kExtraBytes + (size_t)stages * kStageBytes + side_bytes(QB, dim);
  cudaError_t err = cudaFuncSetAttribute(
      cosine_score_tile<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cosine_score_tile<QB><<<grid, kThreads, smem, stream>>>(
      query, map, bq, n_rows, dim, count, k, tiles_per_block, stages,
      out_scores, part_vals, part_idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cosine_tile_rows() { return kTileRows; }
int cosine_max_dim() { return kMaxDim; }

// The most queries one launch takes at this width: a power of two whose
// q^, scores and lists leave room for two stages of the ring.
int cosine_queries_per_launch(int dim) {
  int qb = kMaxQueries;
  while (qb > 1 && stages_for(qb, dim) < 2) qb /= 2;
  return qb;
}

// Scores bq queries against n_rows store rows, one block per segment of
// tiles_per_block tiles of cosine_tile_rows() rows.  k == 0 writes the
// dense out_scores [bq, n_rows]; k > 0 writes partials [bq, n_segments, k]
// with n_segments = ceil(ceil(n_rows / tile rows) / tiles_per_block).
int cosine_score_tile_launch(const float* query, const float* store, int bq,
                             int n_rows, int dim, int count, int k,
                             int tiles_per_block, float* out_scores,
                             float* part_vals, int* part_idx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bq < 1 || bq > cosine_queries_per_launch(dim) || dim % 4 ||
      dim > kMaxDim || k < 0 || k > kMaxK || tiles_per_block < 1 ||
      count < 0 || count > n_rows)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!encode_store_map(&map, store, count, dim))
    return (int)cudaErrorNotSupported;
#define VG_COSINE_LAUNCH(QB)                                               \
  if (bq <= QB)                                                            \
    return launch_score<QB>(query, map, bq, n_rows, dim, count, k,         \
                            tiles_per_block, out_scores, part_vals,        \
                            part_idx, st);
  VG_COSINE_LAUNCH(1)
  VG_COSINE_LAUNCH(2)
  VG_COSINE_LAUNCH(4)
  VG_COSINE_LAUNCH(8)
  VG_COSINE_LAUNCH(16)
  VG_COSINE_LAUNCH(32)
#undef VG_COSINE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int cosine_topk_merge_launch(const float* part_vals, const int* part_idx,
                             int bq, int n_parts, int k, float* vals,
                             int* idx, void* stream) {
  const size_t smem = (size_t)n_parts * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      cosine_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cosine_topk_merge<<<bq, kMergeThreads, smem, (cudaStream_t)stream>>>(
      part_vals, part_idx, n_parts, k, vals, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
