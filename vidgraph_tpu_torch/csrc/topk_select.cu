// Tie-exact top-k of dense float32 scores, for Hopper (sm_90a).
//
// The second half of the port of vidgraph_tpu/ops/topk_cosine.py's top-k:
// above the cosine kernel's lists (k > 64) the JAX package's _masked_topk
// takes lax.top_k of the masked scores that the Pallas kernel
// (_score_kernel) wrote, outside the kernel.  Here cosine_score_tile
// writes the dense scores [B, n] and this kernel selects from them.  For
// each row it writes the k largest scores and their columns, score
// descending, equal scores by ascending column: lax.top_k's order, and bit
// for bit the first k of a stable descending sort of the row, which is
// its plain version (ops/topk_cosine.py::select_ref).  Scores are finite
// and ordered as IEEE's total order orders them, +0.0 above -0.0, as
// lax.top_k does.
//
// What bounds it on the H100: reading the scores once, 12.8 MB at B 16 x
// 200,000 (3.8 us at 3.35 TB/s); the dense pass has just written them, so
// they come from the 50 MB L2.  A full sort of each row (torch.sort, the
// path this replaces) reads and writes the row several times to keep at
// most a few hundred entries.
//
// Design: one block of 1024 threads a row.  Each entry gets a 64-bit key
// that orders entries as the result does: the score's order-preserving
// 32-bit key above the complement of its column, so no two entries tie.
// 1. A threshold key theta with at least k entries at or above it:
//    - for k <= 1024: each thread's best entry is a distinct entry, so the
//      k-th best of the 1024 threads' bests is at or below the k-th best
//      of the row.  One pass keeps each thread's best (a float compare an
//      entry) and a radix select over the 1024 bests gives it.  On scores
//      like a store's (no order along the row) a few times k entries pass;
//    - else, or where more entries pass than shared memory holds: a radix
//      select of the row's exact k-th key.
//    A radix select takes 11, 11, then 10 bits a pass (shared-memory
//    histograms of the keys that match the chosen prefix) and stops once
//    every key of the chosen prefix is in, so a column's bits are read only
//    where the k-th score ties.
// 2. One pass gathers the entries at or above theta (in any order: the key
//    is unique) into shared memory, or for k past kSortCap into a global
//    scratch the wrapper allocates.  A thread marks its 16 entries of a
//    step and its warp counts them in one scan, so an entry below theta
//    costs a compare.  Where more than 2k passed, a radix select over the
//    gathered keys keeps the exact k, so the sort below is of k keys.
// 3. A bitonic sort of the kept keys, in shared memory up to kSortCap
//    keys, else in the scratch with the strides below kSortCap taken in
//    shared memory chunks; the first k are written out, each score read
//    back from the row (its own bits).
//
// The entry point has a plain C interface and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;              // 11 bits a radix pass
constexpr int kSortCap = 16384;          // keys sorted in shared memory
constexpr int kPasses = 6;
__constant__ int kWidths[kPasses] = {11, 11, 10, 11, 11, 10};

typedef unsigned long long Key;

// larger score -> larger key (IEEE total order: -0.0 below +0.0)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the score of an order_key (its inverse)
__device__ __forceinline__ float score_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? key & 0x7fffffffu : ~key);
}

// the entry's key: its score's, then its column's complement (a lower
// column ranks higher); 0 is no entry's
__device__ __forceinline__ Key entry_key(float f, int col) {
  return (Key)order_key(f) << 32 | (uint32_t)~(uint32_t)col;
}

// A thread's share of a row in one step: N scores, their columns, and
// whether each is in the row.
template <int N>
struct Tile {
  float v[N];
  int c[N];
  bool ok[N];
};

// Calls f(tile) for the row's entries, a Tile<16> a step (four float4s of
// the row's 16-byte aligned middle, loaded before any is used) and a
// Tile<1> for each end: as often on every thread of the block, so that f
// may vote across its warp; a thread sees its columns in ascending order.
template <typename F>
__device__ __forceinline__ void each_tile(const float* row, int n, F&& f) {
  const int tid = threadIdx.x;
  const int h = min(
      n, (int)(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2));
  const int nv = (n - h) >> 2;
  const int t0 = h + 4 * nv;
  {
    Tile<1> t;
    t.ok[0] = tid < h;
    t.v[0] = t.ok[0] ? row[tid] : 0.f;
    t.c[0] = tid;
    f(t);
  }
  const float4* row4 = reinterpret_cast<const float4*>(row + h);
  for (int vb = 0; vb < nv; vb += 4 * kThreads) {
    Tile<16> t;
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int v = vb + u * kThreads + tid;
      x[u] = v < nv ? __ldg(row4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int v = vb + u * kThreads + tid;
      const float e[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t.v[4 * u + j] = e[j];
        t.c[4 * u + j] = h + 4 * v + j;
        t.ok[4 * u + j] = v < nv;
      }
    }
    f(t);
  }
  {
    Tile<1> t;
    t.ok[0] = tid < n - t0;
    t.v[0] = t.ok[0] ? row[t0 + tid] : 0.f;
    t.c[0] = t0 + tid;
    f(t);
  }
}

// the row's entries as keys: g(key, valid) for each
template <typename G>
__device__ __forceinline__ void row_keys(const float* row, int n, G&& g) {
  each_tile(row, n, [&](const auto& t) {
    constexpr int N = sizeof(t.v) / sizeof(t.v[0]);
#pragma unroll
    for (int j = 0; j < N; ++j) g(entry_key(t.v[j], t.c[j]), t.ok[j]);
  });
}

// The exclusive sum of x over the block's threads (all must call).
__device__ int block_exclusive_sum(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = warp_sums[lane];
    int t = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_sums[lane] = t - s;
  }
  __syncthreads();
  const int before = warp_sums[warp] + incl - x;
  __syncthreads();                       // warp_sums is free again
  return before;
}

// The exact key of the k-th best of a set of distinct keys, which
// visit(g) hands to g(key, valid) (k at most the set's size): radix
// passes from the top bits down.  hist [kBins], pick [3] and warp_sums in
// shared memory.
template <typename V>
__device__ Key radix_threshold(int k, V&& visit, int* hist, int* pick,
                               int* warp_sums) {
  Key prefix = 0;
  int bits = 0, r = k;                   // r: the rank sought in the prefix
  for (int p = 0; p < kPasses; ++p) {
    const int w = kWidths[p], shift = 64 - bits - w;
    for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    visit([&](Key key, bool ok) {
      if (ok && (bits == 0 || key >> (64 - bits) == prefix))
        atomicAdd(&hist[(int)(key >> shift) & ((1 << w) - 1)], 1);
    });
    __syncthreads();
    // thread t holds digits kBins-1-2t and kBins-2-2t, highest first
    const int hi = kBins - 1 - 2 * threadIdx.x;
    const int c_hi = hist[hi], c_lo = hist[hi - 1];
    const int above = block_exclusive_sum(c_hi + c_lo, warp_sums);
    if (above < r && r <= above + c_hi) {
      pick[0] = hi; pick[1] = r - above; pick[2] = c_hi;
    } else if (above + c_hi < r && r <= above + c_hi + c_lo) {
      pick[0] = hi - 1; pick[1] = r - above - c_hi; pick[2] = c_lo;
    }
    __syncthreads();
    prefix = prefix << w | (Key)pick[0];
    bits += w;
    r = pick[1];
    const bool all = r == pick[2];       // every key of the prefix is in
    __syncthreads();
    if (all) break;
  }
  return prefix << (64 - bits);
}

// One compare-exchange step of the ascending bitonic network over the m
// keys at buf[0, m), which sit at positions base + [0, m) of the whole.
__device__ __forceinline__ void bitonic_step(Key* buf, int m, int base,
                                             int size, int stride) {
  for (int p = threadIdx.x; p < m / 2; p += kThreads) {
    const int i = 2 * p - (p & (stride - 1)), j = i + stride;
    const bool up = ((base + i) & size) == 0;
    const Key a = buf[i], b = buf[j];
    if ((a > b) == up) { buf[i] = b; buf[j] = a; }
  }
  __syncthreads();
}

// The network's steps of sizes lo..hi (powers of two) over buf[0, m),
// each from stride min(size, m) / 2 down to 1.
__device__ void bitonic(Key* buf, int m, int base, int lo, int hi) {
  for (int size = lo; size <= hi; size <<= 1)
    for (int stride = min(size, m) / 2; stride > 0; stride >>= 1)
      bitonic_step(buf, m, base, size, stride);
}

// Sorts g[0, m) (m a power of two past kSortCap) ascending: strides below
// kSortCap in shared memory s, the others in place.
__device__ void sort_global(Key* g, int m, Key* s) {
  auto chunks = [&](int lo, int hi) {
    for (int c0 = 0; c0 < m; c0 += kSortCap) {
      for (int i = threadIdx.x; i < kSortCap; i += kThreads) s[i] = g[c0 + i];
      __syncthreads();
      bitonic(s, kSortCap, c0, lo, hi);
      for (int i = threadIdx.x; i < kSortCap; i += kThreads) g[c0 + i] = s[i];
      __syncthreads();
    }
  };
  chunks(2, kSortCap);
  for (int size = 2 * kSortCap; size <= m; size <<= 1) {
    for (int stride = size / 2; stride >= kSortCap; stride >>= 1)
      bitonic_step(g, m, 0, size, stride);
    chunks(size, size);
  }
}

// Appends key to out[0, cap) at a place counted on *count, for the lanes
// whose take is set (a warp vote: every lane calls it).
__device__ __forceinline__ void append(bool take, Key key, Key* out, int cap,
                                       int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(0xffffffffu, take);
  if (m == 0) return;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  const int pos = base + __popc(m & ((1u << lane) - 1));
  if (take && pos < cap) out[pos] = key;
}

// The entries of row whose key is at or above theta, as complemented keys
// (so an ascending sort puts the best first) at out[0, cap); returns how
// many there are, which may exceed cap.  A thread marks its tile's entries
// first and the warp counts them in one scan, so an entry below theta
// costs a compare.
__device__ int gather(const float* row, int n, Key theta, Key* out, int cap,
                      int* count) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  const float floor_v = score_of((uint32_t)(theta >> 32));
  each_tile(row, n, [&](const auto& t) {
    constexpr int N = sizeof(t.v) / sizeof(t.v[0]);
    unsigned mask = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      // below theta's score is below theta; the key settles the rest
      if (t.ok[j] && !(t.v[j] < floor_v) &&
          entry_key(t.v[j], t.c[j]) >= theta)
        mask |= 1u << j;
    if (!__any_sync(0xffffffffu, mask != 0)) return;
    const int mine = __popc(mask);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int base = 0;
    if (lane == 31) base = atomicAdd(count, incl);
    int pos = __shfl_sync(0xffffffffu, base, 31) + incl - mine;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (mask >> j & 1) {
        if (pos < cap) out[pos] = ~entry_key(t.v[j], t.c[j]);
        ++pos;
      }
  });
  __syncthreads();
  return *count;
}

// One block a row of scores [bs, n]: the row's top k into vals / idx
// [bs, k].  scratch [bs, scratch_len] (scratch_len the power of two at or
// past k) only where k > kSortCap.  Shared memory: kSortCap keys, then
// kThreads keys for the exact k.
__global__ void __launch_bounds__(kThreads, 1)
cosine_select(const float* __restrict__ scores, int n, int k,
              float* __restrict__ vals, int* __restrict__ idx,
              Key* __restrict__ scratch, int scratch_len) {
  extern __shared__ Key sbuf[];
  __shared__ int hist[kBins];
  __shared__ int pick[3];
  __shared__ int warp_sums[kWarps];
  __shared__ int count;
  const float* row = scores + (size_t)blockIdx.x * n;
  Key* buf = sbuf;
  bool in_scratch = false;
  int c = kSortCap + 1;
  if (k <= kThreads) {
    // each thread's best entry (the first of equal scores), and the k-th
    // best of those
    float bv = 0.f;
    int bc = -1;
    each_tile(row, n, [&](const auto& t) {
      constexpr int N = sizeof(t.v) / sizeof(t.v[0]);
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (t.ok[j] && (bc < 0 || t.v[j] > bv)) { bv = t.v[j]; bc = t.c[j]; }
    });
    const Key best = bc < 0 ? 0 : entry_key(bv, bc);
    const Key theta =
        __syncthreads_count(bc >= 0) < k
            ? 0                          // fewer threads had one: take all
            : radix_threshold(
                  k, [&](auto&& g) { g(best, bc >= 0); }, hist, pick,
                  warp_sums);
    c = gather(row, n, theta, sbuf, kSortCap, &count);
  }
  if (c > kSortCap) {                    // too many passed: the exact k-th
    const Key theta = radix_threshold(
        k, [&](auto&& g) { row_keys(row, n, g); }, hist, pick, warp_sums);
    int cap = kSortCap;
    if (k > kSortCap) {
      buf = scratch + (size_t)blockIdx.x * scratch_len;
      cap = scratch_len;
      in_scratch = true;
    }
    c = gather(row, n, theta, buf, cap, &count);
  } else if (c > 2 * k) {
    // more than twice k passed: keep the exact k before sorting
    const int m = c;
    const Key theta = radix_threshold(
        k,
        [&](auto&& g) {
          for (int i0 = 0; i0 < m; i0 += kThreads) {
            const int i = i0 + threadIdx.x;
            g(i < m ? ~sbuf[i] : 0ull, i < m);
          }
        },
        hist, pick, warp_sums);
    buf = sbuf + kSortCap;
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    for (int i0 = 0; i0 < m; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      const Key key = i < m ? ~sbuf[i] : 0ull;
      append(i < m && key >= theta, ~key, buf, kThreads, &count);
    }
    c = k;
    __syncthreads();
  }
  int m = 1;
  while (m < c) m <<= 1;
  for (int i = c + threadIdx.x; i < m; i += kThreads) buf[i] = ~0ull;
  __syncthreads();
  if (in_scratch)
    sort_global(buf, m, sbuf);
  else
    bitonic(buf, m, 0, 2, m);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const int col = (int)(uint32_t)buf[j];
    vals[(size_t)blockIdx.x * k + j] = row[col];
    idx[(size_t)blockIdx.x * k + j] = col;
  }
}

}  // namespace

extern "C" {

int cosine_select_sort_cap() { return kSortCap; }

// The top k (1 <= k <= n) of each of bs rows of n float32 scores into vals
// [bs, k] and idx [bs, k]; scratch holds bs x scratch_len keys (8 bytes
// each, scratch_len the power of two at or past k) where k >
// cosine_select_sort_cap(), and may be null otherwise.
int cosine_select_launch(const float* scores, int bs, int n, int k,
                         float* vals, int* idx, void* scratch,
                         int scratch_len, void* stream) {
  if (bs < 1 || n < 1 || k < 1 || k > n ||
      (k > kSortCap && (scratch == nullptr || scratch_len < k ||
                        (scratch_len & (scratch_len - 1)))))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = (kSortCap + kThreads) * (int)sizeof(Key);
  static std::atomic<bool> raised[64];   // once a device; zero-initialised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !raised[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        cosine_select, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev].store(true, std::memory_order_release);
  }
  cosine_select<<<bs, kThreads, smem, (cudaStream_t)stream>>>(
      scores, n, k, vals, idx, static_cast<Key*>(scratch), scratch_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
