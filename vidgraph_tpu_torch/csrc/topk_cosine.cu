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
//   Each block writes its segment's list [B, n_segments, k] to scratch
//   and counts itself done on a counter in device memory; the grid's last
//   block merges every list into the top k (merge_lists), so a search is
//   one launch.  A separate merge kernel cost a second launch: 0.019-0.048
//   ms of host time a search on the card named above.  The merge stages the
//   lists by cp.async, takes tau, the k-th best of a pool of list heads
//   (a bound on the k-th best entry), and ranks the few entries at or
//   above it, all 128 threads at once, in rolled loops: it runs once a
//   launch from a cold instruction cache, where a warp merging in k rounds
//   (each a chain of dependent instructions) or unrolled code cost more
//   than the work.  The counters are a zero-initialised array of this
//   library, one slot for each stream the wrapper launches on: the last
//   block sets its slot back to 0, so no launch ever clears it and a CUDA
//   graph's replays find it at 0.  Above kMaxK the caller takes the dense
//   scores and selects from them (csrc/topk_select.cu), as the JAX package
//   leaves its top-k to lax.top_k outside the Pallas kernel.
//
// The entry points have a plain C interface and return cudaGetLastError()
// so that a refused launch is reported to the caller; a launch returns
// cudaErrorNotSupported where libcuda offers no tensor-map encoder.  The
// tensor maps are cached by (address, geometry) and each instantiation
// raises its shared-memory limit once a device, so a search's host work
// is the launch.

#include "tma.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <mutex>
#include <unordered_map>

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
constexpr int kMaxSegments = 160;        // lists a merge takes: 5 a lane
constexpr int kListsPerLane = kMaxSegments / 32;
constexpr int kCounterSlots = 1024;      // streams with a completion counter

// The completion counters, one a stream (the wrapper hands out the
// slots); zero at load, and set back to zero by each launch's last block.
__device__ unsigned int g_done[kCounterSlots];

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

typedef unsigned long long Key;

// A list entry as one key: its score's order-preserving bits (-0.0 as
// +0.0) above its row's complement, so that a larger key comes first and
// equal scores go to the lower row, as `better` orders the lists; 0 for an
// empty slot (-inf at kNoIndex), below every entry.
__device__ __forceinline__ Key list_key(float v, int i) {
  if (i == kNoIndex) return 0;
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0) u = 0;
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (Key)o << 32 | (uint32_t)~(uint32_t)i;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Starts copying n 4-byte words from src (global) to dst (shared), the
// two equal modulo 16 bytes: 16-byte copies between 4-byte ones at the
// ends.
__device__ void stage_words(void* dst, const void* src, int n) {
  uint32_t* d = static_cast<uint32_t*>(dst);
  const uint32_t* g = static_cast<const uint32_t*>(src);
  const int head =
      min(n, (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2);
  const int chunks = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kThreads) cp_async4(d + i, g + i);
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(d + head + 4 * c, g + head + 4 * c);
  for (int i = head + 4 * chunks + threadIdx.x; i < n; i += kThreads)
    cp_async4(d + i, g + i);
}

// entries of a list that the merge stages in shared memory
constexpr int kStaged = 8;

// An entry past the staged ones, from the lists in global memory; out of
// line, so that the merge's loops stay small.
__device__ __noinline__ Key far_key(const float* pv, const int* pi,
                                    size_t e) {
  return list_key(__ldcg(pv + e), __ldcg(pi + e));
}

// A query's lists for the merge: the first `staged` entries of each in
// shared memory, sv / si [n_seg][staged], the rest in global memory, pv /
// pi [n_seg][k].
struct Lists {
  const float* sv;
  const int* si;
  const float* pv;
  const int* pi;
  int n_seg, k, staged;
  // query q's lists, where this holds a group's from query 0 on
  __device__ __forceinline__ Lists query(int q) const {
    return Lists{sv + q * n_seg * staged, si + q * n_seg * staged,
                 pv + (size_t)q * n_seg * k, pi + (size_t)q * n_seg * k,
                 n_seg, k, staged};
  }
  // entry c of list t as a key; 0 past the list
  __device__ __forceinline__ Key at(int t, int c) const {
    if (c >= k) return 0;
    if (c < staged) return list_key(sv[t * staged + c], si[t * staged + c]);
    return far_key(pv, pi, (size_t)t * k + c);
  }
};

// result r of a query: the entry of `key`, or -inf at kNoIndex for 0
__device__ __forceinline__ void put(Key key, float* vals, int* idx, int r) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  vals[r] = key == 0 ? -CUDART_INF_F
                     : __uint_as_float((o & 0x80000000u) ? o & 0x7fffffffu
                                                         : ~o);
  idx[r] = key == 0 ? kNoIndex : (int)~static_cast<uint32_t>(key);
}

constexpr int kPool = kListsPerLane * 32;  // every head of a query

// keys of a query's pool of heads: the best of each of 32 groups of lists
// where k <= 32, else every head
__host__ __device__ constexpr int pool_keys(int k) {
  return k <= 32 ? 32 : kPool;
}

// lists of a query whose head reaches tau, at most: k groups' five, or k
__host__ __device__ constexpr int list_room(int k) {
  return k <= 32 ? 5 * k : k;
}

// candidates a query keeps room for
__host__ __device__ constexpr int cand_room(int k) {
  return 4 * k > 64 ? 4 * k : 64;
}

// Bytes of shared memory a query of the merge takes: its staged lists,
// pool, tau, counts and candidates.
__host__ __device__ constexpr int merge_query_bytes(int n_seg, int k) {
  return n_seg * (k < kStaged ? k : kStaged) * 8 + pool_keys(k) * 8 + 16 +
         cand_room(k) * 8 + list_room(k) * 4;
}

// One warp, one query: its top k in k rounds, each taking the warp's
// largest head; the lane that holds it moves that list on.  The fallback
// of merge_group for a query past its candidates' room.
__device__ __noinline__ void merge_rounds(const Lists L, float* vals,
                                          int* idx) {
  const int lane = threadIdx.x & 31;
  Key hk[kListsPerLane];
  int cur[kListsPerLane];
#pragma unroll
  for (int j = 0; j < kListsPerLane; ++j) {
    cur[j] = 0;
    hk[j] = lane + 32 * j < L.n_seg ? L.at(lane + 32 * j, 0) : 0;
  }
  for (int r = 0; r < L.k; ++r) {
    Key best = hk[0];
#pragma unroll
    for (int j = 1; j < kListsPerLane; ++j) best = max(best, hk[j]);
    Key top = best;
    for (int o = 16; o > 0; o >>= 1)
      top = max(top, __shfl_xor_sync(0xffffffffu, top, o));
    if (lane == 0) put(top, vals, idx, r);
    // a real key is one entry's: one lane holds it
    if (top != 0 && best == top) {
#pragma unroll
      for (int j = 0; j < kListsPerLane; ++j)
        if (hk[j] == top) hk[j] = L.at(lane + 32 * j, ++cur[j]);
    }
  }
}

// The top k of each of gq queries from their staged lists, by the whole
// block in steps:
// 1. a pool of each query's heads: the best of lists g, g + 32, ... for
//    each g < 32 where k <= 32, else every head;
// 2. tau, the pool's k-th largest key (1 where it holds fewer than k), is
//    at or below the query's k-th largest entry, so its top k are among
//    the entries at or above tau: a prefix of each list whose head is;
// 3. the lists whose head reaches tau, then (a thread a list) their
//    passing prefixes into the query's candidates;
// 4. each candidate's rank among them; rank r < k is the result's r-th.
// A query whose candidates overflow `room` is merged in rounds instead.
// pool [gq][pool keys], tau [gq], cnt and off [gq + 1], cand [gq][room]
// and the passing lists `pass` [gq][list_room] are shared memory.  The
// merge runs once a launch, from a cold instruction cache, so its loops
// are rolled: unrolled, the code grew to cost more than the work.
__device__ __noinline__ void merge_group(const Lists lists, int gq,
                                         float* vals, int* idx, Key* pool,
                                         Key* tau, int* cnt, int* off,
                                         Key* cand, int room, int* pass) {
  const int k = lists.k, n_seg = lists.n_seg;
  const int pp = pool_keys(k);
  // 1
  for (int e = threadIdx.x; e < gq * 32; e += kThreads) {
    const int q = e >> 5, g = e & 31;
    const Lists L = lists.query(q);
    Key h[kListsPerLane];
#pragma unroll
    for (int j = 0; j < kListsPerLane; ++j)
      h[j] = g + 32 * j < n_seg ? L.at(g + 32 * j, 0) : 0;
    if (pp == kPool) {
#pragma unroll
      for (int j = 0; j < kListsPerLane; ++j) pool[q * pp + 32 * j + g] = h[j];
    } else {
      Key a = 0;
#pragma unroll
      for (int j = 0; j < kListsPerLane; ++j) a = max(a, h[j]);
      pool[q * pp + g] = a;
    }
  }
  for (int q = threadIdx.x; q <= gq; q += kThreads) {
    if (q < gq) tau[q] = 1;
    cnt[q] = 0;                        // cnt[gq]: the passing lists
  }
  __syncthreads();
  // 2: eight keys of a query's pool a thread, one pass over that pool
  for (int c = threadIdx.x; c < gq * pp / 8; c += kThreads) {
    const int q = c * 8 / pp;
    const Key* pq = pool + q * pp;
    Key x[8];
    int r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = pool[c * 8 + i];
      r[i] = 0;
    }
#pragma unroll 2
    for (int u = 0; u < pp; ++u) {
      const Key y = pq[u];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] += y > x[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (x[i] != 0 && r[i] == k - 1) tau[q] = x[i];
  }
  __syncthreads();
  // 3: the passing lists, a warp's at once; then a thread a list (a
  // list's prefix costs a few dependent reads: in one thread of a warp
  // the rest would wait for it)
  const int lane = threadIdx.x & 31;
  for (int e0 = 0; e0 < gq * n_seg; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    const int q = e / n_seg;
    const bool ok = e < gq * n_seg &&
                    lists.query(q).at(e - q * n_seg, 0) >= tau[q];
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&cnt[gq], __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (ok) pass[base + __popc(m & ((1u << lane) - 1))] = e;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < cnt[gq]; p += kThreads) {
    const int e = pass[p], q = e / n_seg, t = e - q * n_seg;
    const Lists L = lists.query(q);
    const Key floor = tau[q];
    int len = 0;
#pragma unroll
    for (int c = 0; c < kStaged; ++c)
      len += c < L.staged && L.at(t, c) >= floor;
#pragma unroll 1
    while (len >= L.staged && len < k && L.at(t, len) >= floor) ++len;
    const int at = atomicAdd(&cnt[q], len);
#pragma unroll 1
    for (int c = 0; c < len && at + c < room; ++c)
      cand[q * room + at + c] = L.at(t, c);
  }
  __syncthreads();
  if (threadIdx.x < 32) {                     // offsets of the kept ones
    int base = 0;
    for (int q0 = 0; q0 < gq; q0 += 32) {
      const int q = q0 + threadIdx.x;
      const int n = q < gq && cnt[q] <= room ? cnt[q] : 0;
      int incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (threadIdx.x >= o) incl += y;
      }
      if (q < gq) off[q] = base + incl - n;
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (threadIdx.x == 0) off[gq] = base;
  }
  const int over =
      __syncthreads_or(threadIdx.x < gq && cnt[threadIdx.x] > room);
  // 4
  for (int e = threadIdx.x; e < off[gq]; e += kThreads) {
    int q = 0;
    while (q + 1 < gq && off[q + 1] <= e) ++q;
    const Key* cq = cand + q * room;
    const int n = cnt[q];
    const Key x = cq[e - off[q]];
    int r = 0;
#pragma unroll 4
    for (int u = 0; u < n; ++u) r += cq[u] > x;
    if (r < k) put(x, vals + (size_t)q * k, idx + (size_t)q * k, r);
  }
  for (int e = threadIdx.x; e < gq * k; e += kThreads) {
    const int q = e / k, r = e % k;
    if (cnt[q] <= room && r >= cnt[q])
      put(0, vals + (size_t)q * k, idx + (size_t)q * k, r);
  }
  // queries past their room (rare): a warp each, in rounds
  if (!over) return;
  const int warp = threadIdx.x >> 5;
  int seen = 0;
  for (int q = 0; q < gq; ++q)
    if (cnt[q] > room && seen++ % kWarps == warp)
      merge_rounds(lists.query(q), vals + (size_t)q * k,
                   idx + (size_t)q * k);
}

// Run by the grid's last block once every block's lists are in part_vals
// / part_idx [bq][n_seg][k]: each query's top k into vals / idx [bq][k].
// The first kStaged entries of every list come from L2 (other blocks
// wrote them) into this block's shared memory (`area` bytes) by cp.async
// copies, all in flight at once, as many queries at a time as fit; then
// merge_group.  Kept out of line, so that the score loop's registers do
// not depend on it.
__device__ __noinline__ void merge_lists(const float* part_vals,
                                         const int* part_idx, int bq,
                                         int n_seg, int k, float* vals,
                                         int* idx, uint8_t* smem, int area) {
  const int staged = min(k, kStaged);
  const int per_q = n_seg * staged;
  const int room = cand_room(k);
  const int group = min(bq, (area - 256) / merge_query_bytes(n_seg, k));
  Key* pool = reinterpret_cast<Key*>(smem);
  Key* tau = pool + group * pool_keys(k);
  Key* cand = tau + group;
  int* cnt = reinterpret_cast<int*>(cand + group * room);
  int* off = cnt + group + 1;
  int* pass = off + group + 1;
  uint8_t* lists = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(pass + group * list_room(k)) + 15) &
      ~uintptr_t(15));
  const int si_at = (group * per_q * 4 + 16 + 15) & ~15;
  for (int g0 = 0; g0 < bq; g0 += group) {
    const int gq = min(group, bq - g0);
    const float* pv = part_vals + (size_t)g0 * n_seg * k;
    const int* pi = part_idx + (size_t)g0 * n_seg * k;
    // the lists at the same offset modulo 16 bytes as in global memory
    float* sv = reinterpret_cast<float*>(
        lists + (reinterpret_cast<uintptr_t>(pv) & 15));
    int* si = reinterpret_cast<int*>(
        lists + si_at + (reinterpret_cast<uintptr_t>(pi) & 15));
    __syncthreads();                     // the last group's merge is done
    if (staged == k) {                   // whole lists: contiguous
      stage_words(sv, pv, gq * per_q);
      stage_words(si, pi, gq * per_q);
    } else {
      for (int e = threadIdx.x; e < gq * per_q; e += kThreads) {
        const size_t from = (size_t)(e / staged) * k + e % staged;
        cp_async4(sv + e, pv + from);
        cp_async4(si + e, pi + from);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    merge_group(Lists{sv, si, pv, pi, n_seg, k, staged}, gq,
                vals + (size_t)g0 * k, idx + (size_t)g0 * k, pool, tau, cnt,
                off, cand, room, pass);
  }
}

// Shared memory: the ring [stages][kTileRows][128 bytes] (1024-byte
// aligned, swizzled), q^ [QB][dpad] float32, the tile's scores
// [QB][kTileRows], the lists' values and indices [QB][k], one mbarrier a
// stage.  k == 0: dense mode, out_scores [bq, n_rows].  k > 0: one sorted
// list per segment of tiles_per_block tiles into part_vals / part_idx
// [bq, gridDim.x, k], and the top k into vals / idx [bq, k], merged by
// the block that finishes last (counted on g_done[slot]).  vec4: the
// query's rows are whole float4s.
template <int QB, typename T>
__global__ void __launch_bounds__(kThreads, 1)
cosine_score_tile(const float* __restrict__ query,
                  const __grid_constant__ CUtensorMap store_map, int bq,
                  int n_rows, int dim, int count, int k, int tiles_per_block,
                  int stages, int vec4, float* __restrict__ out_scores,
                  float* __restrict__ part_vals, int* __restrict__ part_idx,
                  float* __restrict__ vals, int* __restrict__ idx, int slot) {
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
    // the lists out before the count; the last block in merges them all
    __threadfence();
    __syncthreads();
    int* last = reinterpret_cast<int*>(ring);   // the ring is free now
    if (threadIdx.x == 0) {
      const bool done = atomicAdd(&g_done[slot], 1u) == gridDim.x - 1;
      if (done) atomicExch(&g_done[slot], 0u);
      __threadfence();
      *last = done;
    }
    __syncthreads();
    if (*last)
      merge_lists(part_vals, part_idx, bq, gridDim.x, k, vals, idx, ring,
                  static_cast<int>(reinterpret_cast<uint8_t*>(li + QB * k) -
                                   ring));
  }
}

// Tensor maps by (address, type, rows, columns, row stride): a map holds
// only an address and a geometry, so a cached one is valid for any store
// that has them.
struct MapKey {
  uintptr_t ptr;
  int type, rows, dim, ld;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && type == o.type && rows == o.rows && dim == o.dim &&
           ld == o.ld;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<uintptr_t>()(k.ptr);
    for (int v : {k.type, k.rows, k.dim, k.ld})
      h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

std::mutex map_mutex;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> map_cache;

// A 2-D map of the store's first max(count, 1) rows [rows][dim] of the
// given type, rows `ld` elements apart, that loads [256 rows][128 bytes]
// boxes, 128-byte swizzled, zero past the rows and past dim.
bool encode_store_map(CUtensorMap* map, const void* store, int type,
                      int count, int dim, int ld) {
  const MapKey key{reinterpret_cast<uintptr_t>(store), type,
                   count > 0 ? count : 1, dim, ld};
  std::lock_guard<std::mutex> lock(map_mutex);
  auto it = map_cache.find(key);
  if (it != map_cache.end()) {
    *map = it->second;
    return true;
  }
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
  if (fn(map, dt, 2, const_cast<void*>(store), dims, strides, box, step,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (map_cache.size() >= 4096) map_cache.clear();
  map_cache.emplace(key, *map);
  return true;
}

// The launch's arguments past the store's map.
struct Args {
  const float* query;
  int bq, n_rows, dim, count, k, tiles_per_block, vec4;
  float* out_scores;
  float* part_vals;
  int* part_idx;
  float* vals;
  int* idx;
  int slot;
};

template <int QB, typename T>
int launch_score(const CUtensorMap& map, const Args& a, cudaStream_t stream) {
  const int n_tiles = (a.n_rows + kTileRows - 1) / kTileRows;
  const int grid = (n_tiles + a.tiles_per_block - 1) / a.tiles_per_block;
  const int stages = stages_for(QB, a.dim, kDK<T>, a.k);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t area =
      (size_t)stages * kStageBytes + side_bytes(QB, a.dim, kDK<T>, a.k);
  // the merge holds one query at least, and a lane keeps five heads
  if (a.k > 0 && (grid > kMaxSegments ||
                  merge_query_bytes(grid, a.k) + 256 > (int)area))
    return (int)cudaErrorInvalidValue;
  // the instantiation's limit, raised to the card's opt-in maximum once a
  // device; each launch asks for its own size
  static std::atomic<bool> raised[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !raised[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(cosine_score_tile<QB, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev].store(true, std::memory_order_release);
  }
  cosine_score_tile<QB, T><<<grid, kThreads, kExtraBytes + area, stream>>>(
      a.query, map, a.bq, a.n_rows, a.dim, a.count, a.k, a.tiles_per_block,
      stages, a.vec4, a.out_scores, a.part_vals, a.part_idx, a.vals, a.idx,
      a.slot);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const CUtensorMap& map, const Args& a, cudaStream_t st) {
#define VG_COSINE_LAUNCH(QB) \
  if (a.bq <= QB) return launch_score<QB, T>(map, a, st);
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
int cosine_counter_slots() { return kCounterSlots; }

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
// n_rows].  0 < k <= cosine_list_max_k() writes each segment's sorted
// list into the scratch part_vals / part_idx [bq, n_segments, k], with
// n_segments = ceil(ceil(n_rows / tile rows) / tiles_per_block) <= 160,
// and the top k into vals / idx [bq, k]; `slot` (< cosine_counter_slots())
// names the completion counter, which launches that may run at once must
// not share: the wrapper keeps one a stream.
int cosine_score_tile_launch(const float* query, const void* store, int type,
                             int ld, int bq, int n_rows, int dim, int count,
                             int k, int tiles_per_block, float* out_scores,
                             float* part_vals, int* part_idx, float* vals,
                             int* idx, int slot, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int elem = type == kF32 ? 4 : 2;
  if (type < kF32 || type > kF16 || dim < 1 || ld < dim ||
      ((long long)ld * elem) % 16 || (uintptr_t)store % 16 || k < 0 ||
      k > kMaxK || bq < 1 || bq > cosine_queries_per_launch(dim, k, type) ||
      tiles_per_block < 1 || count < 0 || count > n_rows || slot < 0 ||
      slot >= kCounterSlots)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!encode_store_map(&map, store, type, count, dim, ld))
    return (int)cudaErrorNotSupported;
  const Args a{query, bq, n_rows, dim, count, k, tiles_per_block,
               dim % 4 == 0 && (uintptr_t)query % 16 == 0, out_scores,
               part_vals, part_idx, vals, idx, slot};
  if (type == kBF16) return launch_typed<__nv_bfloat16>(map, a, st);
  if (type == kF16) return launch_typed<__half>(map, a, st);
  return launch_typed<float>(map, a, st);
}

}  // extern "C"
