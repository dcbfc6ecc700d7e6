// The attention of one decode step (a query of one token against the KV
// cache), in one launch: the qkv bias add, the cache write, the scores,
// the mask, the softmax and P.V.
//
// Replaces no TPU kernel: the JAX package's decode step
// (vidgraph_tpu/models/captioner.py::_step_block) leaves it to XLA, a
// dynamic_update_slice of the caches and two einsums that XLA fuses.  The
// eager port ran it as twelve PyTorch ops a layer (the two cache writes,
// casts, two float32 bmms over every cache slot, the scale, masked_fill,
// softmax, the transpose copy), ~20 us of host time each: at B 1 the
// decode is paced by the host's launches, not by the card.  For every row
// b and local head h the kernel computes what that chain computes
// (ops/decode_attention.py::decode_attention_ref), after the qkv product's
// bias add (x + b rounded to the compute type, as the product's own add
// rounded it; the block saves that launch too):
//
//   kc[b, h, slot] = k[b, h]; vc[b, h, slot] = v[b, h]     (float32)
//   s[j] = (q[b, h] . kc[b, h, j]) * (1 / sqrt(hd))          float32
//   p[j] = exp(s - max s) / sum exp(s - max s) over the keys j the row
//          sees (masked[b, j] false), 0 elsewhere; rounded to the
//          compute type (the JAX path's .astype(cfg.dtype))
//   o[b, h] = sum_j p[j] vc[b, h, j]                         float32
//
// and writes o in the compute type as [B, h * hd].  Keys past the write
// slot are masked for every row (the decode loop's invariant), so their
// probabilities are exactly 0: they are not read.  A key whose rounded
// probability is 0 adds nothing and is not read either.
//
// What bounds it on the H100: bytes and latency.  A step reads 2 x (live
// keys) x hd x 4 bytes a (row, head) from the float32 caches: at the
// large() captioner's B 1 x 16 heads x 265 slots x 128, 0.54 MB at most,
// 0.16 us at 3.35 TB/s, far under one DRAM round trip per dependent load.
// So the design is about keeping loads in flight:
// * a key row is read by a group of lanes (hd / 4 rounded up to a power of
//   two, at most 32), one 16-byte load a lane, neighbouring lanes on
//   neighbouring elements; a group keeps kLoads / R rows in flight and a
//   block of 512 threads 128-512 rows;
// * one block per (row, head) where B x h fills the card or the live keys
//   are few (the single route: scores in shared memory, one launch);
// * where B x h is small and the keys are many (the chat LM's 4,096
//   positions at B 1 x 8 heads), the keys are split over blocks.  The
//   probabilities are rounded after the global max and sum, so a split
//   takes two launches: the first writes the scores of its keys, the
//   second computes the max and sum over all of them (the single route's
//   reduction, bit for bit), its keys' P.V, and the grid's last block of
//   the (row, head) adds the splits' sums in order (a completion counter
//   in device memory, left at zero).
// The wrapper (ops/decode_attention.py::plan) picks the route from the
// shapes; both give the same probabilities, and P.V differs between them
// only in its float32 summation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "attention_general.cuh"

namespace {

using vg_attn::from_f;
using vg_attn::to_f;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;              // 16-byte loads a lane has in flight
constexpr int kMaxHeadDim = 256;
constexpr int kSingleMaxKeys = 4096;   // scores a block keeps in shared memory
constexpr int kCounterSlots = 64;      // streams with completion counters
constexpr int kMaxSplitRows = 1024;    // (row, head) pairs a split launch takes

// One completion counter a (stream slot, row x head) of a split launch; zero
// at load, and set back to zero by each (row, head)'s last block.
__device__ unsigned int g_done[kCounterSlots * kMaxSplitRows];

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;          // [3, h, hd] of the compute type
  long long q_sb, q_sh, k_sb, k_sh, v_sb, v_sh;  // element strides
  float* kc;                 // [B, h, max_t, hd] float32
  float* vc;
  const uint8_t* masked;     // [B, ... max_t]: nonzero where not seen
  long long mask_sb;
  void* out;                 // [B, h * hd], the compute type
  float* scores;             // split: [B * h, slot + 1]
  float* parts;              // split: [B * h, splits, hd]
  int h, hd, max_t, slot, gs, chunk, splits, counter;
  float scale;
};

// x + b rounded to the compute type, as a PyTorch add of the two rounds it.
template <typename T>
__device__ __forceinline__ float biased(T x, T b) {
  return to_f(from_f<T>(to_f(x) + to_f(b)));
}

// q of (row, head) ``bh`` as float32 into qs; the step's k and v into
// cache slot ``slot`` where ``owns_slot``.  Ends in a barrier, so that the
// block reads the slot it wrote.
template <typename T>
__device__ void stage(const Params& p, int bh, bool owns_slot, float* qs) {
  const int b = bh / p.h, hh = bh % p.h;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const T* bq = static_cast<const T*>(p.bias) + hh * p.hd;
  for (int i = threadIdx.x; i < p.hd; i += kThreads)
    qs[i] = biased(q[i], bq[i]);
  if (owns_slot) {
    const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hh * p.k_sh;
    const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hh * p.v_sh;
    const T* bk = bq + p.h * p.hd;
    const T* bv = bk + p.h * p.hd;
    const size_t row = ((size_t)bh * p.max_t + p.slot) * p.hd;
    for (int i = threadIdx.x; i < p.hd; i += kThreads) {
      p.kc[row + i] = biased(k[i], bk[i]);
      p.vc[row + i] = biased(v[i], bv[i]);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The scaled scores of keys [k0, k1) of (row, head) ``bh`` into sc[j]
// (-inf where masked).  A group of p.gs lanes reads one key row, R 16-byte
// chunks a lane; the loop bound is the same for every thread (shuffles).
template <int R>
__device__ void scores(const Params& p, int bh, int k0, int k1,
                       const float* qs, float* sc) {
  constexpr int U = kLoads / R;
  const int nc = p.hd >> 2, gs = p.gs;
  const int lane = threadIdx.x & (gs - 1), group = threadIdx.x / gs;
  const int groups = kThreads / gs;
  float4 qv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = lane + r * gs;
    qv[r] = c < nc ? reinterpret_cast<const float4*>(qs)[c]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* base = p.kc + (size_t)bh * p.max_t * p.hd;
  const uint8_t* mask = p.masked + (size_t)(bh / p.h) * p.mask_sb;
  for (int j0 = k0; j0 < k1; j0 += groups * U) {
    float4 kv[U][R];
    bool seen[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * groups + group;
      seen[u] = j < k1 && !mask[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + r * gs;
        kv[u][r] = seen[u] && c < nc
                       ? __ldcg(reinterpret_cast<const float4*>(
                             base + (size_t)j * p.hd) + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) d = dot4(qv[r], kv[u][r], d);
      for (int o = gs >> 1; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      const int j = j0 + u * groups + group;
      if (lane == 0 && j < k1) sc[j] = seen[u] ? d * p.scale : -INFINITY;
    }
  }
}

// Block-wide max and sum (every thread gets the result); red holds kWarps
// floats and is free again on return.
__device__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The softmax's max and sum over the scores sc[0, n): the same thread
// order on both routes, so that they round the same probabilities.
__device__ void softmax_stats(const float* sc, int n, float* red, float& m,
                              float& l) {
  float x = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) x = fmaxf(x, sc[j]);
  m = block_max(x, red);
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) s += expf(sc[j] - m);
  l = block_sum(s, red);
}

template <typename T>
__device__ __forceinline__ float probability(float s, float m, float l) {
  return to_f(from_f<T>(expf(s - m) / l));
}

// sum_j P[j - k0] vc[bh, j] over keys [k0, k1): each group sums its keys,
// then the groups' sums are added in group order through red (groups x hd
// floats).  Thread i < hd returns element i.
template <int R>
__device__ float pv(const Params& p, int bh, int k0, int k1, const float* P,
                    float* red) {
  constexpr int U = kLoads / R;
  const int nc = p.hd >> 2, gs = p.gs;
  const int lane = threadIdx.x & (gs - 1), group = threadIdx.x / gs;
  const int groups = kThreads / gs;
  const float* base = p.vc + (size_t)bh * p.max_t * p.hd;
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = k0; j0 < k1; j0 += groups * U) {
    float4 vv[U][R];
    float w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * groups + group;
      w[u] = j < k1 ? P[j - k0] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + r * gs;
        vv[u][r] = w[u] != 0.f && c < nc
                       ? __ldcg(reinterpret_cast<const float4*>(
                             base + (size_t)j * p.hd) + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r].x = fmaf(w[u], vv[u][r].x, acc[r].x);
        acc[r].y = fmaf(w[u], vv[u][r].y, acc[r].y);
        acc[r].z = fmaf(w[u], vv[u][r].z, acc[r].z);
        acc[r].w = fmaf(w[u], vv[u][r].w, acc[r].w);
      }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = lane + r * gs;
    if (c < nc) reinterpret_cast<float4*>(red + group * p.hd)[c] = acc[r];
  }
  __syncthreads();
  float o = 0.f;
  if (threadIdx.x < p.hd)
    for (int g = 0; g < groups; ++g) o += red[g * p.hd + threadIdx.x];
  return o;
}

// The single route: one block a (row, head), grid B x h.  Shared memory:
// q (hd), the groups' sums (groups x hd; its head also serves the block
// reductions), the scores and then the probabilities (slot + 1).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    decode_attention_single(const Params p) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* red = qs + p.hd;
  float* sc = red + (kThreads / p.gs) * p.hd;
  const int bh = blockIdx.x, live = p.slot + 1;
  stage<T>(p, bh, true, qs);
  scores<R>(p, bh, 0, live, qs, sc);
  __syncthreads();
  float m, l;
  softmax_stats(sc, live, red, m, l);
  for (int j = threadIdx.x; j < live; j += kThreads)
    sc[j] = probability<T>(sc[j], m, l);
  __syncthreads();
  const float o = pv<R>(p, bh, 0, live, sc, red);
  if (threadIdx.x < p.hd)
    static_cast<T*>(p.out)[(size_t)bh * p.hd + threadIdx.x] =
        from_f<T>(o);
}

// The split route, launch 1: grid (splits, B x h); block x writes the
// scores of keys [x chunk, (x + 1) chunk) to global scratch, and the
// block that holds the write slot writes the step's k and v.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    decode_attention_split_scores(const Params p) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.y, live = p.slot + 1;
  const int k0 = blockIdx.x * p.chunk, k1 = min(live, k0 + p.chunk);
  stage<T>(p, bh, k0 <= p.slot && p.slot < k1, qs);
  scores<R>(p, bh, k0, k1, qs, p.scores + (size_t)bh * live);
}

// The split route, launch 2: each block reduces all of its (row, head)'s
// scores to the max and sum, rounds its keys' probabilities, sums their
// P.V; the last block of the (row, head) adds the splits' sums.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    decode_attention_split_pv(const Params p) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  float* P = red + (kThreads / p.gs) * p.hd;
  __shared__ int last;
  const int bh = blockIdx.y, live = p.slot + 1;
  const int k0 = blockIdx.x * p.chunk, k1 = min(live, k0 + p.chunk);
  const float* sc = p.scores + (size_t)bh * live;
  float m, l;
  softmax_stats(sc, live, red, m, l);
  for (int j = k0 + threadIdx.x; j < k1; j += kThreads)
    P[j - k0] = probability<T>(sc[j], m, l);
  __syncthreads();
  const float o = pv<R>(p, bh, k0, k1, P, red);
  float* part = p.parts + (size_t)bh * p.splits * p.hd;
  if (threadIdx.x < p.hd) part[blockIdx.x * p.hd + threadIdx.x] = o;
  // the sums out before the count; the last block in adds them
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* done = &g_done[p.counter + bh];
    last = atomicAdd(done, 1u) == (unsigned)p.splits - 1;
    if (last) atomicExch(done, 0u);
    __threadfence();
  }
  __syncthreads();
  if (last && threadIdx.x < p.hd) {
    float s = 0.f;
    for (int x = 0; x < p.splits; ++x)
      s += __ldcg(part + x * p.hd + threadIdx.x);
    static_cast<T*>(p.out)[(size_t)bh * p.hd + threadIdx.x] =
        from_f<T>(s);
  }
}

template <typename T, int R>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const int groups = kThreads / p.gs;
  if (p.splits == 1) {
    const size_t smem = (size_t)(p.hd + groups * p.hd + p.slot + 1) * 4;
    decode_attention_single<T, R><<<bh, kThreads, smem, stream>>>(p);
  } else {
    const dim3 grid(p.splits, bh);
    decode_attention_split_scores<T, R>
        <<<grid, kThreads, (size_t)p.hd * 4, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_attention_split_pv<T, R>
        <<<grid, kThreads, (size_t)(groups * p.hd + p.chunk) * 4, stream>>>(
            p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(const Params& p, int bh, cudaStream_t stream) {
  return (p.hd >> 2) > 32 ? launch<T, 2>(p, bh, stream)
                          : launch<T, 1>(p, bh, stream);
}

}  // namespace

extern "C" {

int decode_attention_counter_slots() { return kCounterSlots; }

// q, k, v: [B, h, hd] of the compute type (dtype: 0 float32, 1 bfloat16,
// 2 float16) with element strides (sb, sh, 1), and the bias [3, h, hd]
// (q's, k's, v's) of the compute type to add to them; kc, vc: [B, h,
// max_t, hd] float32, contiguous, 16-byte aligned; masked: [B, max_t]
// bytes at batch stride mask_sb, nonzero where a row does not see a key,
// every key past ``slot`` masked; out: [B, h * hd] contiguous, the compute
// type.  ``splits`` 1 is the single route (slot < 4096); above 1 the split
// route over ``chunk`` keys a block (splits x chunk > slot >= (splits - 1)
// x chunk, chunk <= 4096, B x h <= 1024) with scratch of B x h x (slot + 1
// + splits x hd) floats and the counters of ``counter_slot``.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            long long q_sb, long long q_sh, long long k_sb,
                            long long k_sh, long long v_sb, long long v_sh,
                            const void* bias, float* kc, float* vc,
                            const void* masked, long long mask_sb, void* out,
                            int B, int h, int hd, int max_t, int slot,
                            int dtype, int splits, int chunk, float* scratch,
                            int counter_slot, void* stream) {
  const long long bh = (long long)B * h;
  const int live = slot + 1;
  if (B < 1 || h < 1 || bh > 2147483647LL || hd < 4 || hd % 4 ||
      hd > kMaxHeadDim || slot < 0 || slot >= max_t || splits < 1 ||
      bias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits == 1 && live > kSingleMaxKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 &&
      (bh > kMaxSplitRows || chunk < 1 || chunk > kSingleMaxKeys ||
       (long long)splits * chunk < live ||
       (long long)(splits - 1) * chunk >= live || scratch == nullptr ||
       counter_slot < 0 || counter_slot >= kCounterSlots))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.kc = kc;
  p.vc = vc;
  p.masked = static_cast<const uint8_t*>(masked);
  p.mask_sb = mask_sb;
  p.out = out;
  p.scores = scratch;
  p.parts = scratch == nullptr ? nullptr : scratch + bh * live;
  p.h = h;
  p.hd = hd;
  p.max_t = max_t;
  p.slot = slot;
  int gs = 1;
  while (gs < hd / 4 && gs < 32) gs <<= 1;
  p.gs = gs;
  p.chunk = splits == 1 ? live : chunk;
  p.splits = splits;
  p.counter = counter_slot * kMaxSplitRows;
  p.scale = 1.f / sqrtf(static_cast<float>(hd));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_type<float>(p, (int)bh, st));
    case kBF16:
      return static_cast<int>(launch_type<__nv_bfloat16>(p, (int)bh, st));
    case kF16:
      return static_cast<int>(launch_type<__half>(p, (int)bh, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
