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
// for any T: the last tiles are masked in the kernel, no padding; and any
// B x H: (batch, head) is folded over the grid's y and z dimensions, so
// 65,535 heads is no limit.  Other float types and head dims (float32,
// float16, hd 32, 80, 256, ...) take attention_general.cu's kernels
// (ops/flash_attention.py::flash_route).
//
// What bounds it on the H100: the tensor cores.  Nothing of the [B, H, T, T]
// score matrix reaches device memory (the plain version writes and reads
// 4.3 GB of float32 probabilities a layer at B = 32, T = 2056); what is left
// is 4 * B * H * hd * (visible pairs) FLOP of bf16 products, 0.140 ms at
// 989 TFLOP/s for B = 32, T = 2056, 8 heads of 64.  The first design
// (mma.sync fed by 32-bit shared loads, K and V loaded synchronously into one
// buffer between two barriers a tile, V transposed by scalar 2-byte stores)
// ran 8-9x above that on an NVIDIA H100 80GB HBM3 at 700 W.
//
// This design:
// * one warpgroup (4 warps) a block of 64 query rows, four blocks an SM
//   at hd 64 (128 registers a thread), so that one block's products
//   overlap another's softmax; q stays in registers as the A operand of
//   wgmma.  (Two warpgroups a block, sharing 128-row query tiles' key
//   tiles, measured 2-13 % slower but at one training shape.);
// * S = Q K^T on wgmma.mma_async m64n64k16 with K from shared memory
//   ([key][dim], K-major); the online softmax on the S accumulators in
//   registers (running max and sum in float32); O += P V on wgmma with P
//   rounded to bf16 in registers as the A operand (the accumulator layout
//   is the A fragment layout) and V from shared memory in its natural
//   [key][dim] layout through the descriptor's transpose bit: no transpose;
// * K and V tiles of 64 keys come by TMA (cp.async.bulk.tensor over 4-D
//   tensor maps of [B, T, H, hd], encoded on the host by libcuda's
//   cuTensorMapEncodeTiled, looked up at run time: no -lcuda) into a ring of three
//   stages in the 128-byte swizzled layout the wgmma descriptors read; the
//   ragged last tile is zero-filled by the copy engine.  One thread starts
//   a tile's two to four copies; each stage has an mbarrier the copies
//   complete and one its readers arrive on, so the block has no block-wide
//   barrier in its loop.  (16-byte cp.async copies by every thread, the
//   first version, cost a third more time at B = 32: 0.69-0.76 ms);
// * key tiles wholly above the diagonal are skipped, except the prefix
//   tiles; query tiles run heaviest (last) first.  A fully masked tile row
//   never divides by zero: its max is -inf, and the exponent is taken
//   against 0 instead.  P is rounded to bf16 as the P.V operand; its
//   float32 sum is kept unrounded.  The exponents run on ex2.approx.
//
// For training the kernel also writes each row's log-sum-exp
// L[r] = log sum_c exp(s[r,c] | visible), float32 [B, H, T] in natural-log
// units: the one residual the backward kernels of flash_attention_bwd.cu
// recompute the probabilities from.  Serving passes a null pointer and
// takes the instantiation without that store (kWriteLse false).
//
// Left as later work: a producer warp of its own with setmaxnreg (here the
// block's first thread starts the copies between its own tiles),
// overlapping one tile's softmax with the next tile's S product inside a
// warpgroup, and the backward kernels on wgmma.  The entry point has a
// plain C interface and returns cudaGetLastError() so that a refused
// launch is reported.

#include "tma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using namespace vg_tma;

constexpr int kKTile = 64;                        // keys a stage
constexpr int kStages = 3;                        // ring of key tiles
constexpr int kAhead = 1;                         // tiles fetched ahead
constexpr int kRegion = kKTile * 128;             // 64 rows x 128 B

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A [64 keys][64 dims] bf16 box of a [B, T, H, hd] tensor at (dim d0,
// head h, key key0, batch b), 128-byte swizzled, counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d0, int h, int key0, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(key0),
      "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of r across the wgmma
// that reads or writes it asynchronously.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// A wgmma shared-memory descriptor of a 128-byte swizzled tile: rows of
// 128 B, eight-row groups 1024 B apart (SBO), start 16-byte aligned inside
// a 1024-byte aligned tile.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// d (m64 x n64, float32) += a (m64 x k16 bf16, registers) * B (k16 x n64
// bf16, shared memory through desc_b); kTransB 1 reads B as [k][n] (MN-
// major), 0 as [n][k] (K-major).  scale_d 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "n"(kTransB), "r"(scale_d));
}

// At hd 64 an SM holds four blocks (at most 128 registers a thread), so
// that one block's products overlap another's softmax.  kFold: (batch,
// head) is folded over the grid's y and z, for B * H past y's 65,535; the
// instantiation without it is the kernel that every smaller B * H takes.
template <int kHeadDim, bool kWriteLse, bool kFold>
__global__ void __launch_bounds__(128, kHeadDim == 64 ? 4 : 1)
flash_attn_fwd(const __nv_bfloat16* __restrict__ q,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int T, int H, int nv, float scale_log2, int BH) {
  constexpr int kThreads = 128;                   // one warpgroup
  constexpr int kQTile = 64;                      // query rows a block
  constexpr int kDimSteps = kHeadDim / 16;        // k-steps of q . k
  constexpr int kHalves = kHeadDim / 64;          // n64 products of p . v
  constexpr int kStageBytes = 2 * kKTile * kHeadDim * 2;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is on address bits: tiles start 1024-byte aligned
  const uint32_t smem0 =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
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
  const int row_first = qt * kQTile;
  // this thread's two query rows: row0 (fragment rows g) and row0 + 8
  const int row0 = row_first + warp * 16 + g;

  const int last_row = min(row_first + kQTile - 1, T - 1);
  const int last_key = min(max(last_row, nv - 1), T - 1);
  const int n_kt = last_key / kKTile + 1;

  // the ring's barriers, after its stages: full[i] completes when the
  // stage's tile has landed, empty[i] when every thread is done reading
  // it.
  const uint32_t full = smem0 + kStages * kStageBytes;
  const uint32_t empty = full + kStages * 8;
  // tile j into its stage (by thread 0), once tile j - kStages has left it
  auto fetch = [&](int j) {
    const int slot = j % kStages;
    if (j >= kStages) mbar_wait(empty + 8 * slot, (j / kStages - 1) & 1);
    const uint32_t st = smem0 + slot * kStageBytes;
    mbar_expect(full + 8 * slot, kStageBytes);
#pragma unroll
    for (int hh = 0; hh < kHeadDim / 64; ++hh) {
      tma_load(st + hh * kRegion, &k_map, hh * 64, h, j * kKTile, b,
               full + 8 * slot);
      tma_load(st + kStageBytes / 2 + hh * kRegion, &v_map, hh * 64, h,
               j * kKTile, b, full + 8 * slot);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < kAhead && j < n_kt; ++j) fetch(j);

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

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, raw scores
  float l[2] = {0.f, 0.f};                      // running sum (this thread)
  float o[kHalves][32];
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[hh][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * kKTile;
    if (threadIdx.x == 0 && kt + kAhead < n_kt) fetch(kt + kAhead);
    __syncwarp();                 // the warp converges for the wgmma below
    const int slot = kt % kStages;
    mbar_wait(full + 8 * slot, (kt / kStages) & 1);
    __syncwarp();

    const uint32_t ks = smem0 + slot * kStageBytes;
    const uint32_t vs = ks + kKTile * kHeadDim * 2;

    // s = q k^T for 64 rows x 64 keys: s[nt * 4 + e] is row g + 8 (e / 2),
    // key nt * 8 + 2 tq + e % 2 of this warp's 16 rows
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDimSteps; ++kk)
      wgmma_m64n64k16<0>(
          s, qf[kk],
          smem_desc(ks + (kk / 4) * kRegion + (kk % 4) * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // mask (only tiles that cross the diagonal or the end); row max over
    // the quad, in raw score units
    if (key0 + kKTile > T || key0 + kKTile - 1 > max(row_first, nv - 1)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = row0 + ((e >> 1) & 1) * 8;
        const int c = key0 + (e >> 2) * 8 + tq * 2 + (e & 1);
        if (c >= T || c > max(r, nv - 1)) s[e] = -CUDART_INF_F;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    // exponents in the log2 domain: p = 2^(s scale_log2 - m scale_log2)
    float sub[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // no (-inf) - (-inf)
      sub[i] = mx[i] == -CUDART_INF_F ? 0.f : mx[i] * scale_log2;
      alpha[i] = fast_exp2(m[i] * scale_log2 - sub[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = fast_exp2(fmaf(s[e], scale_log2, -sub[(e >> 1) & 1]));
      l[(e >> 1) & 1] += s[e];
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {    // the max moved
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[hh][e] *= alpha[(e >> 1) & 1];
    }

    // o += p v: the s accumulators are the A fragments of p, 16 keys a step
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
      pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) reg_fence(o[hh]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
        wgmma_m64n64k16<1>(o[hh], pa[j],
                           smem_desc(vs + hh * kRegion + j * 2048, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) reg_fence(o[hh]);
    reg_fence(pa);
    mbar_arrive(empty + 8 * slot);
  }

  // normalise and write the two rows' dims, 2 per 32-bit store
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  // L = (m scale_log2 + log2 l) ln 2.  Key 0 is visible to every row, so
  // l > 0.
  if (kWriteLse && tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + i * 8;
      if (r < T)
        lse[static_cast<size_t>(bh) * T + r] =
            (m[i] * scale_log2 + log2f(l[i])) * 0.6931471805599453f;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + i * 8;
    if (r >= T) continue;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + base + r * tok + hh * 64 + nt * 8 +
                                     tq * 2) =
            pack_bf16(o[hh][nt * 4 + 2 * i] * inv[i],
                      o[hh][nt * 4 + 2 * i + 1] * inv[i]);
  }
}

// A 4-D map of x [B, T, H, hd] bf16 that loads [64 keys][64 dims] boxes,
// 128-byte swizzled, zero past T.
bool encode_map(CUtensorMap* map, const void* x, int B, int T, int H,
                int hd) {
  const PFN_cuTensorMapEncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)T * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, kKTile, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kHeadDim, bool kWriteLse>
int launch(const __nv_bfloat16* q, const CUtensorMap& k_map,
           const CUtensorMap& v_map, __nv_bfloat16* out, float* lse, int B,
           int T, int H, int nv, cudaStream_t st) {
  constexpr int kQTile = 64;
  const size_t smem = kStages * (2 * kKTile * kHeadDim * 2 + 16) + 1024;
  const int bh = B * H, y = bh < 65535 ? bh : 65535;
  auto* kern = bh > y ? flash_attn_fwd<kHeadDim, kWriteLse, true>
                      : flash_attn_fwd<kHeadDim, kWriteLse, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kQTile - 1) / kQTile, y, (bh + y - 1) / y);
  const float scale_log2 = 1.4426950408889634f / sqrtf(float(kHeadDim));
  kern<<<grid, 128, smem, st>>>(q, k_map, v_map, out, lse, T, H, nv,
                                scale_log2, bh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, out: [B, T, H, hd] bf16, contiguous, 16-byte aligned; hd 64 or
// 128.  lse: float32 [B, H, T], or null to write none.
// cudaErrorNotSupported where libcuda offers no tensor-map encoder.
int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                          void* out, void* lse, int B, int T, int H, int hd,
                          int nv, void* stream) {
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap k_map, v_map;
  if (!encode_map(&k_map, k, B, T, H, hd) ||
      !encode_map(&v_map, v, B, T, H, hd))
    return static_cast<int>(cudaErrorNotSupported);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return lp ? launch<64, true>(qb, k_map, v_map, ob, lp, B, T, H, nv, st)
              : launch<64, false>(qb, k_map, v_map, ob, lp, B, T, H, nv, st);
  return lp ? launch<128, true>(qb, k_map, v_map, ob, lp, B, T, H, nv, st)
            : launch<128, false>(qb, k_map, v_map, ob, lp, B, T, H, nv, st);
}

}  // extern "C"
