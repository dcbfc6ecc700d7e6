// Cosine scoring with a fused count mask and top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vidgraph_tpu/ops/topk_cosine.py::_score_kernel
// (pallas_call in _pallas_scores, with the mask and the two-stage top-k of
// _fused_cosine_topk_count / _masked_topk around it).  It computes, for
// float32 queries q [B,d] and a store [N,d] of L2-normalised rows held in
// float32, bfloat16 or float16:
//
//   q^ = q * rsqrt(sum(q^2) + 1e-12)          (float32 accumulation)
//   s[b,n] = q^[b] . float32(store[n])        for n <  count
//   s[b,n] = -1e30                            for n >= count (masked)
//
// and either writes the dense scores [B,N] or the top-k (values desc,
// ties to the lower row index as lax.top_k breaks them).  As _score_kernel
// does, a 16-bit store is read in its own type and each element upcast to
// float32 on its way to the products, whose sums are float32.
//
// What bounds it on the H100: the store read.  At 200,000 x 512 float32 a
// call reads 410 MB, 0.122 ms at 3.35 TB/s (a 16-bit store half of that,
// 0.061 ms); the arithmetic, 2*B*N*d = 3.3 GFLOP at B=16, is 0.049 ms at
// the 67 TFLOP/s of float32 FMAs.  The first design (one block per 256-row
// tile, a warp shuffle reduction per row and query, rows loaded in bursts
// with no copy in flight while scoring) was bound by instructions at B=16
// and by load latency at B=1: 2.0-2.7x its bound on an NVIDIA H100 80GB
// HBM3 at 700 W.
//
// This design:
// * a persistent grid, one block of 4 warps per SM, each walking a
//   contiguous segment of 256-row tiles, so the store streams once;
// * a ring of 2-6 shared-memory stages (as many as fit beside q^), each a
//   256-row x 128-byte slice of a tile (32 float32 or 64 16-bit columns)
//   brought by one TMA copy (cp.async.bulk.tensor over a 2-D tensor map of
//   the store's first `count` rows, whose row stride `ld` may exceed d: a
//   store kept with its columns padded to a 16-byte stride, encoded on the
//   host by libcuda's cuTensorMapEncodeTiled, looked up at run time: no
//   -lcuda), 128-byte swizzled, on an mbarrier a stage.  Rows at or past
//   count and columns past d are zero-filled by the copy engine and never
//   read, so any d takes the same path.  The next slices are in flight
//   while this one is scored.  (16-byte cp.async copies by every thread,
//   the first version, kept too few bytes in flight: 0.22-0.25 ms at B
//   1-16);
// * register tiling as an SGEMM: each thread holds 2 rows x QB queries of
//   float32 accumulators (QB the batch rounded up to a power of two) over
//   the slices, reads its rows' 16-byte chunks from the stage (the swizzle
//   puts eight neighbouring rows' chunks in eight bank groups; a 16-bit
//   chunk is upcast to eight floats in registers) and each q^ float4 as a
//   warp-wide broadcast.  No shuffle per dot product; each q^ read serves
//   64 rows, each row read serves QB queries;
// * top-k, for k up to kMaxK: at each tile's end the scores go to shared
//   memory and one warp per query merges the candidates that beat its
//   running k-th best into a sorted list of k kept for the whole segment.
//   The partials are one list per segment [B, n_segments, k], sized by k;
//   cosine_topk_merge merges them.  Above kMaxK the caller takes the dense
//   scores and selects from them (ops/topk_cosine.py), as the JAX package
//   leaves its top-k to lax.top_k outside the Pallas kernel.
//
// Left as later work: a merge folded into the grid, and lists for k above
// kMaxK.  The entry points have a plain C interface and return
// cudaGetLastError() so that a refused launch is reported to the caller; a
// launch returns cudaErrorNotSupported where libcuda offers no tensor-map
// encoder.

#include "tma.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using namespace vg_tma;

constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 2;                   // rows a thread scores
constexpr int kTileRows = kWarps * 32 * kRT;   // 256
constexpr int kRowBytes = 128;           // a row's bytes in one stage
constexpr int kStageBytes = kTileRows * kRowBytes;   // 32 KB
constexpr int kMaxStages = 6;
constexpr int kMaxK = 64;                // two list entries a lane
constexpr int kMaxQueries = 32;
constexpr int kSmemLimit = 232448;       // opt-in shared memory on sm_90
// the 1024-byte alignment of the swizzled ring, the 8-byte alignment of
// its mbarriers, and the mbarriers
constexpr int kExtraBytes = 1024 + 8 + 8 * kMaxStages;
constexpr float kMasked = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

// the store's element types, by the code the wrapper passes
enum StoreType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// columns of a store row in one stage: 32 float32 or 64 16-bit values
template <typename T>
constexpr int kDK = kRowBytes / (int)sizeof(T);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (v, i) beats (w, j) when it scores higher, or equal with a lower index.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// A 16-byte chunk of a stage row as float32: 4 float32 values, or 8
// 16-bit values upcast (exactly).
template <typename T>
__device__ __forceinline__ void upcast(const uint4 u, float* f);

template <>
__device__ __forceinline__ void upcast<float>(const uint4 u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

template <>
__device__ __forceinline__ void upcast<__nv_bfloat16>(const uint4 u,
                                                      float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void upcast<__half>(const uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// The [256 rows][128 bytes] box of the store at (column c0, row r0),
// 128-byte swizzled, counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

__host__ __device__ constexpr int padded_dim(int dim, int dk) {
  return (dim + dk - 1) / dk * dk;
}

// Shared memory beside the ring: q^ (float32), the tile's scores, the
// lists of k.
size_t side_bytes(int qb, int dim, int dk, int k) {
  return sizeof(float) * ((size_t)qb * padded_dim(dim, dk) +
                          (size_t)qb * kTileRows) +
         (size_t)qb * k * (sizeof(float) + sizeof(int));
}

// Stages of the ring: as many as fit beside the rest, at most kMaxStages.
int stages_for(int qb, int dim, int dk, int k) {
  const long long room = (long long)kSmemLimit - kExtraBytes -
                         (long long)side_bytes(qb, dim, dk, k);
  return (int)(room / kStageBytes < kMaxStages ? room / kStageBytes
                                               : kMaxStages);
}

int columns_a_stage(int type) { return type == kF32 ? 32 : 64; }

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

// Shared memory: the ring [stages][kTileRows][128 bytes] (1024-byte
// aligned, swizzled), q^ [QB][dpad] float32, the tile's scores
// [QB][kTileRows], the lists' values and indices [QB][k], one mbarrier a
// stage.  k == 0: dense mode, out_scores [bq, n_rows].  k > 0: partials
// part_vals / part_idx [bq, gridDim.x, k], one sorted list per segment of
// tiles_per_block tiles.  vec4: the query's rows are whole float4s.
template <int QB, typename T>
__global__ void __launch_bounds__(kThreads, 1)
cosine_score_tile(const float* __restrict__ query,
                  const __grid_constant__ CUtensorMap store_map, int bq,
                  int n_rows, int dim, int count, int k, int tiles_per_block,
                  int stages, int vec4, float* __restrict__ out_scores,
                  float* __restrict__ part_vals,
                  int* __restrict__ part_idx) {
  constexpr int DK = kDK<T>;
  constexpr int E = 16 / (int)sizeof(T);      // values of a 16-byte chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - __cvta_generic_to_shared(smem_raw) %
                                          1024) % 1024);
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int dpad = padded_dim(dim, DK);
  float* qn = reinterpret_cast<float*>(ring + stages * kStageBytes);
  float* sc = qn + QB * dpad;
  float* lv = sc + QB * kTileRows;
  int* li = reinterpret_cast<int*>(lv + QB * k);
  const uint32_t full = static_cast<uint32_t>(
      __cvta_generic_to_shared(li + QB * k) + 7) & ~7u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(t_begin + tiles_per_block, n_tiles);
  const int n_chunks = dpad / DK;
  const int n_steps = (t_end - t_begin) * n_chunks;

  // step j into its stage, by thread 0: tile t_begin + j / n_chunks,
  // columns (j % n_chunks) * DK.  Nothing is read when count is 0.
  auto fetch = [&](int j) {
    const int slot = j % stages;
    if (count > 0) {
      mbar_expect(full + 8 * slot, kStageBytes);
      tma_load(ring_s + slot * kStageBytes, &store_map, (j % n_chunks) * DK,
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
    const float* src = query + (size_t)b * dim;
    float* dst = qn + b * dpad;
    float ss = 0.f;
    if (vec4) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      if (b < bq)
        for (int c = lane; c < dim / 4; c += 32) {
          const float4 x = src4[c];
          ss += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
        }
      const float inv = b < bq ? rsqrtf(warp_sum(ss) + 1e-12f) : 0.f;
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int c = lane; c < dpad / 4; c += 32) {
        const float4 x = b < bq && c < dim / 4
                             ? src4[c]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        dst4[c] = make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
      }
    } else {
      if (b < bq)
        for (int c = lane; c < dim; c += 32) ss += src[c] * src[c];
      const float inv = b < bq ? rsqrtf(warp_sum(ss) + 1e-12f) : 0.f;
      for (int c = lane; c < dpad; c += 32)
        dst[c] = b < bq && c < dim ? src[c] * inv : 0.f;
    }
  }
  for (int i = threadIdx.x; i < QB * k; i += kThreads) {
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
    const uint8_t* st = ring + (s % stages) * kStageBytes;
    const float* qs = qn + chunk * DK;
#pragma unroll
    for (int kk = 0; kk < kRowBytes / 16; ++kk) {
      float x[kRT][E];
      // row r's 16-byte chunk c lies at chunk c ^ (r % 8) of its 128 B
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        upcast<T>(*reinterpret_cast<const uint4*>(
                      st + rr[i] * kRowBytes + ((kk ^ (rr[i] & 7)) << 4)),
                  x[i]);
#pragma unroll
      for (int b = 0; b < QB; ++b) {
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          const float4 y = *reinterpret_cast<const float4*>(
              qs + b * dpad + kk * E + 4 * h);
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            float a = acc[i][b];
            a = fmaf(x[i][4 * h], y.x, a);
            a = fmaf(x[i][4 * h + 1], y.y, a);
            a = fmaf(x[i][4 * h + 2], y.z, a);
            a = fmaf(x[i][4 * h + 3], y.w, a);
            acc[i][b] = a;
          }
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
        merge_tile(sc + b * kTileRows, lv + b * k, li + b * k, k, tile0,
                   n_rows);
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
      part_vals[o] = lv[b * k + j];
      part_idx[o] = li[b * k + j];
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

// A 2-D map of the store's first max(count, 1) rows [rows][dim] of the
// given type, rows `ld` elements apart, that loads [256 rows][128 bytes]
// boxes, 128-byte swizzled, zero past the rows and past dim.
bool encode_store_map(CUtensorMap* map, const void* store, int type,
                      int count, int dim, int ld) {
  const PFN_cuTensorMapEncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int elem = type == kF32 ? 4 : 2;
  const CUtensorMapDataType dt =
      type == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : (type == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT16);
  const cuuint64_t dims[2] = {(cuuint64_t)dim,
                              (cuuint64_t)(count > 0 ? count : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)columns_a_stage(type), kTileRows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(store), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int QB, typename T>
int launch_score(const float* query, const CUtensorMap& map, int bq,
                 int n_rows, int dim, int count, int k, int tiles_per_block,
                 int vec4, float* out_scores, float* part_vals,
                 int* part_idx, cudaStream_t stream) {
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int grid = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const int stages = stages_for(QB, dim, kDK<T>, k);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = kExtraBytes + (size_t)stages * kStageBytes +
                      side_bytes(QB, dim, kDK<T>, k);
  cudaError_t err = cudaFuncSetAttribute(
      cosine_score_tile<QB, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cosine_score_tile<QB, T><<<grid, kThreads, smem, stream>>>(
      query, map, bq, n_rows, dim, count, k, tiles_per_block, stages, vec4,
      out_scores, part_vals, part_idx);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const float* query, const CUtensorMap& map, int bq,
                 int n_rows, int dim, int count, int k, int tiles_per_block,
                 int vec4, float* out_scores, float* part_vals,
                 int* part_idx, cudaStream_t st) {
#define VG_COSINE_LAUNCH(QB)                                               \
  if (bq <= QB)                                                            \
    return launch_score<QB, T>(query, map, bq, n_rows, dim, count, k,      \
                               tiles_per_block, vec4, out_scores,          \
                               part_vals, part_idx, st);
  VG_COSINE_LAUNCH(1)
  VG_COSINE_LAUNCH(2)
  VG_COSINE_LAUNCH(4)
  VG_COSINE_LAUNCH(8)
  VG_COSINE_LAUNCH(16)
  VG_COSINE_LAUNCH(32)
#undef VG_COSINE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int cosine_tile_rows() { return kTileRows; }
int cosine_list_max_k() { return kMaxK; }

// The most queries one launch takes at this width, list length and store
// type (0 float32, 1 bfloat16, 2 float16): a power of two whose q^,
// scores and lists leave room for two stages of the ring; 0 where not
// even one query does.
int cosine_queries_per_launch(int dim, int k, int type) {
  const int dk = columns_a_stage(type);
  int qb = kMaxQueries;
  while (qb > 1 && stages_for(qb, dim, dk, k) < 2) qb /= 2;
  return stages_for(qb, dim, dk, k) < 2 ? 0 : qb;
}

// Scores bq float32 queries against n_rows store rows of `type`, `ld`
// elements apart, one block per segment of tiles_per_block tiles of
// cosine_tile_rows() rows.  k == 0 writes the dense out_scores [bq,
// n_rows]; 0 < k <= cosine_list_max_k() writes partials [bq, n_segments,
// k] with n_segments = ceil(ceil(n_rows / tile rows) / tiles_per_block).
int cosine_score_tile_launch(const float* query, const void* store, int type,
                             int ld, int bq, int n_rows, int dim, int count,
                             int k, int tiles_per_block, float* out_scores,
                             float* part_vals, int* part_idx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int elem = type == kF32 ? 4 : 2;
  if (type < kF32 || type > kF16 || dim < 1 || ld < dim ||
      ((long long)ld * elem) % 16 || (uintptr_t)store % 16 || k < 0 ||
      k > kMaxK || bq < 1 || bq > cosine_queries_per_launch(dim, k, type) ||
      tiles_per_block < 1 || count < 0 || count > n_rows)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!encode_store_map(&map, store, type, count, dim, ld))
    return (int)cudaErrorNotSupported;
  const int vec4 = dim % 4 == 0 && (uintptr_t)query % 16 == 0;
  if (type == kBF16)
    return launch_typed<__nv_bfloat16>(query, map, bq, n_rows, dim, count,
                                       k, tiles_per_block, vec4, out_scores,
                                       part_vals, part_idx, st);
  if (type == kF16)
    return launch_typed<__half>(query, map, bq, n_rows, dim, count, k,
                                tiles_per_block, vec4, out_scores, part_vals,
                                part_idx, st);
  return launch_typed<float>(query, map, bq, n_rows, dim, count, k,
                             tiles_per_block, vec4, out_scores, part_vals,
                             part_idx, st);
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
