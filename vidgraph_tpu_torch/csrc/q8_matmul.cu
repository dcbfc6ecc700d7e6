// Weight-only int8 product for small-M decode steps, for Hopper (sm_90a).
//
// Replaces vidgraph_tpu/ops/q8_matmul.py::_kernel (the pallas_call in
// q8_matmul), reached from models/quant8.py::wdot with qmode = 'a16p':
//
//   out[M, N] = (bf16(x)[M, K] . bf16(q)[K, N]) * s[N]
//
// x is bfloat16 (the wrapper rounds it), q int8 row-major, s float32.  The
// int8 weights are converted to bfloat16 on the chip (exact: |q| <= 127
// needs seven bits), the products are summed in float32, the per-column
// scale multiplies the finished float32 sum, and the output is float32 or
// bfloat16 (the float32 value rounded to nearest even: bit for bit the
// cast of the float32 output).  Only the int8 bytes of the weight cross
// device memory; no dequantised matrix is ever written.  M <= 64, K and N
// multiples of 128.
//
// What bounds it on the H100: bytes.  (K, N) = (2048, 8192) at M = 32 moves
// 16.8 MB of weights and 1.2 MB of x, s and out: 5.4 us at 3.35 TB/s against
// 1.07 GFLOP, 1.1 us of bf16 tensor-core time.  A decode step launches 96 of
// these, so the launch and the first bytes' latency count as much as the
// rate.
//
// Design (one launch a product, no workspace):
//  * One block owns 128 weight columns and computes out^T for them: the
//    weights are the A operand of wgmma.mma_async m64nNk16 (two products of
//    64 columns), x the B operand, N = M rounded up to 8, 16, 32 or 64.  M
//    is not rounded to 16 rows, and the weights, the large operand, never
//    pass through shared memory as bfloat16.
//  * The weights come by TMA: a 2-D tensor map over q [K, N] int8 loads
//    [64 rows][128 columns] boxes, 128-byte swizzled, into a ring of six
//    stages; x comes by TMA too, a [N rows][64] bf16 box a stage (rows past
//    M lie outside the map and are zero-filled: nothing is padded in device
//    memory).  A producer warp issues the copies onto full/empty mbarriers;
//    two consumer warpgroups take the stages in turn, and warpgroup 1's
//    sums join warpgroup 0's at the end.  The maps are cached on the host
//    by (address, geometry): a map holds nothing else.
//  * A comes from registers.  The 128 columns are permuted inside the
//    block: byte j of the 32-bit word 8w + g of a row is column
//    16w + g + 8 (j & 1) of the product j >> 1, so one shared read feeds
//    four A fragments (two rows of each product) and a thread ends with four
//    adjacent output columns.  A byte b becomes the float
//    (0x4B000000 | (b ^ 0x80)) - (2^23 + 128) = b exactly, and the upper
//    halves of two such floats are the packed bf16 pair: byte permutes and
//    one float add a byte, no conversion unit.  With the swizzle the reads
//    are free of bank conflicts.
//  * K is split over the blocks of one thread-block cluster (a power of two
//    up to 8, chosen on the host by ops/q8_matmul.py::plan) where the
//    column blocks alone would leave SMs idle.  Every rank stores each of
//    its float32 sums into the shared memory of the rank that adds it
//    (item i of thread t: rank (i + t) % cluster); after one cluster
//    barrier each rank adds its items in rank order, scales them and writes
//    them.  The order is fixed, so two runs give the same bits.
//
// Measured and not kept: one or four consumer warpgroups, more or larger
// stages (builds of this source with other constants, PERF.md);
// and, since taken out, the products on mma.sync m16n8k16 (slower at most
// shapes), a wgmma stage overlapped with the next one's converts, other L2
// promotions of the weights, rank 0 alone adding the cluster's sums, and
// one bulk copy a pair of ranks in the place of the threads' stores.  What is left between the kernel and its bound: a launch and
// the first bytes (~2.5 µs at base()'s shapes, where loads alone take
// 2.6-3.2), the converts (~0.4 µs a 64-row stage a warpgroup) and the
// cluster's reduction (1-5 µs, the most at M 32).
//
// The entry point has a plain C interface and returns cudaGetLastError()
// (cudaErrorNotSupported where libcuda offers no tensor-map encoder).

#include "tma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <unordered_map>

namespace {

using namespace vg_tma;

constexpr int kMaxM = 64;
constexpr int kBN = 128;                  // weight columns a block
constexpr int kBK = 64;                   // K rows a stage
constexpr int kStages = 6;
constexpr int kMaxCluster = 8;
constexpr int kGroup = 128;               // threads of a warpgroup
constexpr int kWG = 2;
constexpr int kConsumers = kWG * kGroup;  // consumer warpgroups
constexpr int kThreads = kConsumers + 32; // and a producer warp
constexpr int kProducer = kConsumers / 32;
constexpr int kQBytes = kBK * kBN;        // one [64][128] int8 box

// The float32 sums a consumer thread keeps, out^T on wgmma: two m64
// products of 64 weight columns x N = NP rows, v[t][e]; as float4 items
// (the unit of the warpgroups' and the cluster's reductions), with where
// each lies in out.
template <int NP>
struct Sums {
  static constexpr int kHalf = NP / 2;                // floats a product
  static constexpr int kItems = NP / 4;
  float v[2][kHalf];
  __device__ __forceinline__ float4 item(int i) const {
    const int t = 4 * i / kHalf, e = 4 * i % kHalf;
    return make_float4(v[t][e], v[t][e + 1], v[t][e + 2], v[t][e + 3]);
  }
  __device__ __forceinline__ void add(int i, float4 x) {
    const int t = 4 * i / kHalf, e = 4 * i % kHalf;
    v[t][e] += x.x;
    v[t][e + 1] += x.y;
    v[t][e + 2] += x.z;
    v[t][e + 3] += x.w;
  }
  // v[t][4 nt8 + 2h + e] is weight column 4 (8 w4 + g) + 2t + h, row
  // 8 nt8 + 2 tq + e: item i's (row, column) for x, y, z, w
  __device__ static void where(int i, int w4, int g, int tq, int (&m)[4],
                               int (&c)[4]) {
    const int t = 4 * i / kHalf, nt8 = 4 * i % kHalf / 4;
    const int row = 8 * nt8 + 2 * tq, col = 4 * (8 * w4 + g) + 2 * t;
    m[0] = row, m[1] = row + 1, m[2] = row, m[3] = row + 1;
    c[0] = col, c[1] = col, c[2] = col + 1, c[3] = col + 1;
  }
};

template <int NP>
struct Shape {
  static constexpr int kItems = Sums<NP>::kItems;
  static constexpr int kXBytes = NP * kBK * 2;        // [NP][64] bf16 boxes
  static constexpr int kStage = kQBytes + kXBytes;    // a multiple of 1024
  static constexpr int kPart = kGroup * kItems * 16;  // a warpgroup's sums
  // the sums the cluster's ranks push to this one: items x
  // ceil(128 / cluster) x cluster float4
  static constexpr int kRecv = kItems * (kGroup + kMaxCluster) * 16;
  static constexpr int kSmem =
      1024 + kStages * kStage + kPart + kRecv + 16 * kStages;
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of products are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of r across the wgmma
// that reads or writes it asynchronously.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma descriptor of a 128-byte swizzled K-major tile: rows of 128 B,
// eight-row groups 1024 B apart, inside a 1024-byte aligned tile.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// d (m64 x nNP, float32) += a (m64 x k16 bf16, registers) * B (k16 x nNP
// bf16, K-major in shared memory).
template <int NP>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
        "0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Byte J of w (an int8 with its sign bit flipped) as a float, exactly.
template <int J>
__device__ __forceinline__ float byte_to_float(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + J)) -
         8388736.0f;                      // 2^23 + 128
}

// The bf16 pair (lo, hi) of two floats whose low 16 bits are zero.
__device__ __forceinline__ uint32_t upper_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// bytes J of two rows' words as the bf16 pair (row k, row k + 1)
template <int J>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t w_lo, uint32_t w_hi) {
  return upper_halves(byte_to_float<J>(w_lo), byte_to_float<J>(w_hi));
}

// This thread's word of row r of a swizzled [64][128] int8 tile: the
// 16-byte chunk c of a row lies at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t q_word(const uint8_t* tile, int r,
                                           int chunk, int byte) {
  return *reinterpret_cast<const uint32_t*>(
             tile + r * kBN + ((chunk ^ (r & 7)) << 4) + byte) ^
         0x80808080u;
}

// out[m][c] = v s[c] for the items' four (row, column) pairs, rows past M
// left out.
__device__ __forceinline__ void store4(void* out, int out_bf16, int M, int N,
                                       const float* s, const int (&m)[4],
                                       const int (&c)[4], float4 v) {
  const float val[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (m[k] >= M) continue;
    const float y = val[k] * __ldg(s + c[k]);
    const size_t o = static_cast<size_t>(m[k]) * N + c[k];
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[o] = y;
  }
}

// Four adjacent columns of a row of out from col on, scaled.
__device__ __forceinline__ void store_row4(void* out, int out_bf16, int N,
                                           int m, int col, float4 v,
                                           float4 sc) {
  v = make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
  const size_t o = static_cast<size_t>(m) * N + col;
  if (out_bf16) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) = packed;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
  }
}

// Grid (N / 128, cluster), cluster dims (1, cluster, 1): rank r sums the
// K tiles [r T / cluster, (r + 1) T / cluster) of T = K / 64, its
// consumer warpgroups taking the tiles in turn.
template <int NP>
__global__ void __launch_bounds__(kThreads)
q8_matmul_wgmma(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap x_map,
             const float* __restrict__ s, void* __restrict__ out, int M,
             int K, int N, int out_bf16) {
  using Sh = Shape<NP>;
  constexpr int kItems = Sh::kItems;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;     // the swizzle's alignment
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t part = base + kStages * Sh::kStage;
  float4* part_ptr = reinterpret_cast<float4*>(base_ptr + kStages * Sh::kStage);
  const uint32_t recv = part + Sh::kPart;
  const float4* recv_ptr = part_ptr + Sh::kPart / 16;
  const uint32_t full = recv + Sh::kRecv;
  const uint32_t empty = full + 8 * kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, gt = tid & (kGroup - 1);  // warpgroup, its thread
  const int n0 = blockIdx.x * kBN;
  const int splits = gridDim.y, rank = blockIdx.y;
  const int tiles = K / kBK;
  const int t0 = rank * tiles / splits;
  const int nt = (rank + 1) * tiles / splits - t0;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kGroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == kProducer && lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&q_map))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&x_map))
                 : "memory");
  }
  __syncthreads();
  // the cluster's blocks are all running before any pushes to another's
  // shared memory (waited for below, after the main loop)
  if (splits > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  Sums<NP> acc;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < Sums<NP>::kHalf; ++e) acc.v[t][e] = 0.f;

  const int w4 = warp & 3;                  // warp in its warpgroup
  const int g = lane >> 2, tq = lane & 3;   // fragment group, thread in it
  if (warp == kProducer) {
    // tile j into its stage once tile j - kStages has left it
    if (lane == 0) {
      for (int j = 0; j < nt; ++j) {
        const int slot = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * slot, (j / kStages - 1) & 1);
        const uint32_t st = base + slot * Sh::kStage;
        const int k0 = (t0 + j) * kBK;
        mbar_expect(full + 8 * slot, Sh::kStage);
        tma_load_2d(st, &q_map, n0, k0, full + 8 * slot);
#pragma unroll
        for (int h = 0; h < kBK / 64; ++h)
          tma_load_2d(st + kQBytes + h * NP * 128, &x_map, k0 + 64 * h, 0,
                      full + 8 * slot);
      }
    }
    __syncwarp();
  } else {
    const int chunk = 2 * w4 + (g >> 2), byte = (g & 3) * 4;
    for (int j = wg; j < nt; j += kWG) {
      const int slot = j % kStages;
      mbar_wait(full + 8 * slot, (j / kStages) & 1);
      __syncwarp();
      const uint8_t* qs = base_ptr + slot * Sh::kStage;
      // out^T on wgmma: A the weights from registers, B the x tile
      const uint32_t xs = base + slot * Sh::kStage + kQBytes;
      uint32_t a[kBK / 16][2][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int r = kk * 16 + 2 * tq;
        const uint32_t w00 = q_word(qs, r, chunk, byte);
        const uint32_t w01 = q_word(qs, r + 1, chunk, byte);
        const uint32_t w10 = q_word(qs, r + 8, chunk, byte);
        const uint32_t w11 = q_word(qs, r + 9, chunk, byte);
        // rows g, g + 8 (bytes 2t, 2t + 1) x k 2tq, 2tq + 8 of product t
        a[kk][0][0] = bf16_pair<0>(w00, w01);
        a[kk][0][1] = bf16_pair<1>(w00, w01);
        a[kk][0][2] = bf16_pair<0>(w10, w11);
        a[kk][0][3] = bf16_pair<1>(w10, w11);
        a[kk][1][0] = bf16_pair<2>(w00, w01);
        a[kk][1][1] = bf16_pair<3>(w00, w01);
        a[kk][1][2] = bf16_pair<2>(w10, w11);
        a[kk][1][3] = bf16_pair<3>(w10, w11);
      }
      reg_fence(acc.v[0]);
      reg_fence(acc.v[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 2; ++t)
          Wgmma<NP>::run(acc.v[t], a[kk][t],
                         smem_desc(xs + (kk / 4) * NP * 128 + (kk % 4) * 32));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc.v[0]);
      reg_fence(acc.v[1]);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 2; ++t) reg_fence(a[kk][t]);
      mbar_arrive(empty + 8 * slot);
    }
    // the other warpgroups' sums join warpgroup 0's, in their order
    for (int w = 1; w < kWG; ++w) {
      if (wg == w) {
#pragma unroll
        for (int i = 0; i < kItems; ++i) part_ptr[i * kGroup + gt] = acc.item(i);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < kItems; ++i) acc.add(i, part_ptr[i * kGroup + gt]);
      }
      if (w + 1 < kWG)
        asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    }
  }

  if (splits > 1) {
    // item i of thread gt (a float4 of its sums) belongs to rank
    // (i + gt) % cluster, which receives it from every rank r at
    // [(i ceil(128 / cluster) + gt / cluster) cluster + r]; then each rank
    // adds its items in rank order and writes them.  x / cluster is
    // (x m) >> 16, exact for x < 2^16 / cluster (x < 160 here), without
    // the integer divide's long sequence.  (One bulk copy a pair of ranks
    // in the place of the threads' stores measured slower.)
    const uint32_t mul = (65536u + splits - 1) / splits;
    auto div = [&](int x) { return static_cast<int>((x * mul) >> 16); };
    auto mod = [&](int x) { return x - div(x) * splits; };
    const int per_i = div(kGroup + splits - 1);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (wg == 0 && warp != kProducer) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const float4 v = acc.item(i);
        const uint32_t at = recv + ((i * per_i + div(gt)) * splits + rank) * 16;
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote)
                     : "r"(at), "r"(mod(i + gt)));
        asm volatile(
            "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                remote),
            "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
            : "memory");
      }
    }
    cluster_sync();
    if (wg == 0 && warp != kProducer) {
      for (int i = 0; i < kItems; ++i) {
        if (mod(i + gt) != rank) continue;
        const float4* in = recv_ptr + (i * per_i + div(gt)) * splits;
        float4 sum = in[0];
        for (int r = 1; r < splits; ++r) {
          const float4 v = in[r];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        int m[4], c[4];
        Sums<NP>::where(i, w4, g, tq, m, c);
#pragma unroll
        for (int k = 0; k < 4; ++k) c[k] += n0;
        store4(out, out_bf16, M, N, s, m, c, sum);
      }
    }
    return;
  }
  if (wg != 0 || warp == kProducer) return;

  // acc.v[t][4 nt8 + 2h + e] is column 4 (8 w4 + g) + 2t + h, row
  // 8 nt8 + 2 tq + e: four adjacent columns a thread and row
  const int col = n0 + 4 * (8 * w4 + g);
  const float4 sc = *reinterpret_cast<const float4*>(s + col);
#pragma unroll
  for (int nt8 = 0; nt8 < NP / 8; ++nt8)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = nt8 * 8 + 2 * tq + e;
      if (m >= M) continue;
      store_row4(out, out_bf16, N, m, col,
                 make_float4(acc.v[0][4 * nt8 + e], acc.v[0][4 * nt8 + 2 + e],
                             acc.v[1][4 * nt8 + e],
                             acc.v[1][4 * nt8 + 2 + e]),
                 sc);
    }
}

// ---------------------------------------------------------------- host side
// Tensor maps by (address, rows, columns, box rows, type): a map holds only
// an address and a geometry, so a cached one is valid for any tensor that
// has them.
struct MapKey {
  uintptr_t ptr;
  int rows, cols, box_rows, type;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols &&
           box_rows == o.box_rows && type == o.type;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<uintptr_t>()(k.ptr);
    for (int v : {k.rows, k.cols, k.box_rows, k.type})
      h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

std::mutex map_mutex;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> map_cache;

// A 2-D map of a row-major [rows, cols] matrix that loads 128-byte wide
// boxes of box_rows rows, 128-byte swizzled, zero past its edges.
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows, bool is_bf16) {
  const MapKey key{reinterpret_cast<uintptr_t>(ptr), rows, cols, box_rows,
                   is_bf16 ? 1 : 0};
  std::lock_guard<std::mutex> lock(map_mutex);
  auto it = map_cache.find(key);
  if (it != map_cache.end()) {
    *map = it->second;
    return true;
  }
  const PFN_cuTensorMapEncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int elem = is_bf16 ? 2 : 1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  if (fn(map,
         is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
         2, const_cast<void*>(ptr), dims, strides, box, step,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (map_cache.size() >= 4096) map_cache.clear();
  map_cache.emplace(key, *map);
  return true;
}

template <int NP>
cudaError_t launch(const void* x, const void* q, const float* s, void* out,
                   int M, int K, int N, int cluster, int out_bf16,
                   cudaStream_t stream) {
  CUtensorMap q_map, x_map;
  if (!tensor_map(&q_map, q, K, N, kBK, false) ||
      !tensor_map(&x_map, x, M, K, NP, true))
    return cudaErrorNotSupported;
  constexpr int smem = Shape<NP>::kSmem;
  static std::atomic<bool> raised[64];    // once a device; zero-initialised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !raised[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(q8_matmul_wgmma<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / kBN, cluster, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, q8_matmul_wgmma<NP>, q_map, x_map, s, out,
                           M, K, N, out_bf16);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] bf16, q [K, N] int8, s [N] float32, all contiguous and 16-byte
// aligned; out [M, N] float32, or bfloat16 where out_bf16.  1 <= M <= 64,
// K % 128 == 0, N % 128 == 0, 1 <= cluster <= min(8, K / 64).
int q8_matmul_launch(const void* x, const void* q, const void* s, void* out,
                     int M, int K, int N, int cluster, int out_bf16,
                     void* stream) {
  if (M < 1 || M > kMaxM || K < 128 || K % 128 || N < 128 || N % 128 ||
      cluster < 1 || cluster > kMaxCluster || cluster > K / kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sb = static_cast<const float*>(s);
  cudaError_t err;
  if (M <= 8)
    err = launch<8>(x, q, sb, out, M, K, N, cluster, out_bf16, st);
  else if (M <= 16)
    err = launch<16>(x, q, sb, out, M, K, N, cluster, out_bf16, st);
  else if (M <= 32)
    err = launch<32>(x, q, sb, out, M, K, N, cluster, out_bf16, st);
  else
    err = launch<64>(x, q, sb, out, M, K, N, cluster, out_bf16, st);
  return static_cast<int>(err);
}

}  // extern "C"
