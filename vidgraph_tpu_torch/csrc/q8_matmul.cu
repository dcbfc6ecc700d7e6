// Weight-only int8 product for small-M decode steps, for Hopper (sm_90a).
//
// Replaces vidgraph_tpu/ops/q8_matmul.py::_kernel (the pallas_call in
// q8_matmul), reached from models/quant8.py::wdot with qmode = 'a16p':
//
//   out[M, N] = (bf16(x)[M, K] . bf16(q)[K, N]) * s[N]        float32
//
// x is bfloat16 (the wrapper rounds it), q int8 row-major, s float32.  The
// int8 weights are converted to bfloat16 on the chip (exact: |q| <= 127
// needs seven bits), the products are summed in float32, the per-column
// scale multiplies the finished float32 sum, and the output is float32.
// Only the int8 bytes of the weight cross device memory; no dequantised
// matrix is ever written.  M <= 64, K and N multiples of 128.
//
// What bounds it on the H100: bytes.  (K, N) = (2048, 8192) at M = 32 moves
// 16.8 MB of weights and 1.2 MB of x, s and out: 5.4 us at 3.35 TB/s against
// 1.07 GFLOP, 1.1 us of bf16 tensor-core time.
//
// Design.  The TPU kernel keeps the whole [M, K] activation resident and
// walks N tiles in order on one core; here nothing of that carries over:
//  * One block (4 warps) owns 128 output columns and one contiguous range of
//    64-row K tiles.  With few column blocks (N = 2048 gives 16) the K tiles
//    are split over `splits` blocks so that the card's 132 SMs all stream
//    weights; each split writes its float32 partial sums to a workspace and
//    q8_reduce adds them in split order and applies s.  No atomics: the sum
//    order is fixed, so two runs give the same bits.  With splits = 1 the
//    first kernel scales and writes the output itself.
//  * K is tiled (64 rows a stage), so the activation never has to fit
//    shared memory whole: a stage holds 64 x 128 int8 and up to 64 x 64
//    bf16 of x, and four stages form a cp.async ring that keeps three tiles
//    (24-54 KB) in flight a block while one is computed.
//  * The products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//    float32 accumulate): at M = 64 the CUDA cores would need 32 us for
//    what the weights' bytes allow in 5.  Rows of x past M are never loaded:
//    an mma's output row depends on its own input row only, and rows past M
//    are not stored.
//  * int8 -> bf16 without the conversion unit.  A warp owns 32 columns as
//    four n8 tiles, tile j taking the columns 4c + j (c = 0..7), so the
//    four bytes of one 32-bit shared-memory word feed the four tiles: a
//    k-step reads four words a thread, not sixteen bytes.  A byte b becomes
//    float(0x4B000000 | (b ^ 0x80)) - (2^23 + 128) = b exactly, and the
//    upper halves of two such floats are the packed bf16 pair (byte
//    permutes and one float add a byte).  The 144-byte row stride of both
//    tiles makes every fragment read conflict-free.
//  * A thread ends with 8 adjacent columns a row: two 16-byte stores.
//
// Later work: wgmma, the int8 tiles by TMA, the bias, the cast and GELU
// fused into the epilogue, and x shared across column blocks (at M >= 32
// its re-reads and the partial sums move as many bytes as the weights).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxM = 64;
constexpr int kBN = 128;                  // output columns a block
constexpr int kBK = 64;                   // K rows a stage
constexpr int kStages = 4;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQStride = kBN + 16;        // bytes a q row in shared memory
constexpr int kXStride = kBK + 8;         // bf16 an x row in shared memory
constexpr int kQTileBytes = kBK * kQStride;

__host__ __device__ constexpr int x_tile_bytes(int mt) {
  return mt * 16 * kXStride * 2;
}

__host__ __device__ constexpr int stage_bytes(int mt) {
  return kQTileBytes + x_tile_bytes(mt);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

template <int J>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t w_lo, uint32_t w_hi) {
  return upper_halves(byte_to_float<J>(w_lo), byte_to_float<J>(w_hi));
}

// dst: out [M, N], scaled by s (splits == 1), or the partial sums
// [splits, M, N], unscaled.  Grid (N / 128, splits).  MT = ceil(M / 16).
template <int MT>
__global__ void __launch_bounds__(kThreads)
q8_matmul_tiles(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ dst, int M, int K, int N, int splits) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // mma group, thread in group
  const int n0 = blockIdx.x * kBN;
  const int tiles = K / kBK;
  const int t0 = static_cast<int>(
      static_cast<int64_t>(blockIdx.y) * tiles / splits);
  const int t1 = static_cast<int>(
      static_cast<int64_t>(blockIdx.y + 1) * tiles / splits);
  const int nt = t1 - t0;

  auto load_stage = [&](int t, int buf) {
    uint8_t* qs = smem + buf * stage_bytes(MT);
    uint8_t* xs = qs + kQTileBytes;
    const int k0 = (t0 + t) * kBK;
#pragma unroll
    for (int c = 0; c < kBK * (kBN / 16) / kThreads; ++c) {
      const int idx = tid + c * kThreads;
      const int row = idx >> 3, ch = idx & 7;
      cp_async16(qs + row * kQStride + ch * 16,
                 q + static_cast<size_t>(k0 + row) * N + n0 + ch * 16);
    }
    for (int idx = tid; idx < M * (kBK / 8); idx += kThreads) {
      const int row = idx >> 3, ch = idx & 7;
      cp_async16(xs + row * (kXStride * 2) + ch * 16,
                 x + static_cast<size_t>(row) * K + k0 + ch * 8);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nt) load_stage(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();         // tile t has landed
    __syncthreads();                      // and tile t - 1 is consumed
    if (t + kStages - 1 < nt)
      load_stage(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();

    const uint8_t* qs = smem + (t % kStages) * stage_bytes(MT);
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(qs + kQTileBytes);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // rows kk + 2tq, + 1, + 8, + 9 of this warp's word g: bytes j are the
      // columns 4g + j of the n8 tiles j
      const uint8_t* qrow = qs + (kk + 2 * tq) * kQStride + (warp * 8 + g) * 4;
      const uint32_t w00 =
          *reinterpret_cast<const uint32_t*>(qrow) ^ 0x80808080u;
      const uint32_t w01 =
          *reinterpret_cast<const uint32_t*>(qrow + kQStride) ^ 0x80808080u;
      const uint32_t w10 =
          *reinterpret_cast<const uint32_t*>(qrow + 8 * kQStride) ^
          0x80808080u;
      const uint32_t w11 =
          *reinterpret_cast<const uint32_t*>(qrow + 9 * kQStride) ^
          0x80808080u;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr = xs + (mt * 16 + g) * kXStride + kk + 2 * tq;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(xr);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * kXStride);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(xr + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * kXStride + 8);
      }
      uint32_t b0[4], b1[4];
      b0[0] = bf16_pair<0>(w00, w01); b1[0] = bf16_pair<0>(w10, w11);
      b0[1] = bf16_pair<1>(w00, w01); b1[1] = bf16_pair<1>(w10, w11);
      b0[2] = bf16_pair<2>(w00, w01); b1[2] = bf16_pair<2>(w10, w11);
      b0[3] = bf16_pair<3>(w00, w01); b1[3] = bf16_pair<3>(w10, w11);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b0[j], b1[j]);
    }
  }
  cp_async_wait<0>();

  // fragment columns 2tq and 2tq + 1 of tile j are the output columns
  // 8tq + j and 8tq + 4 + j: eight adjacent columns a thread and row
  const int col = warp * 32 + 8 * tq;     // within the block's 128
  float4 s_lo = make_float4(1.f, 1.f, 1.f, 1.f), s_hi = s_lo;
  if (splits == 1) {
    s_lo = *reinterpret_cast<const float4*>(s + n0 + col);
    s_hi = *reinterpret_cast<const float4*>(s + n0 + col + 4);
  }
  float* base = dst + static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + g + 8 * half;
      if (row >= M) continue;
      const int e = 2 * half;
      float4 lo = make_float4(acc[mt][0][e], acc[mt][1][e], acc[mt][2][e],
                              acc[mt][3][e]);
      float4 hi = make_float4(acc[mt][0][e + 1], acc[mt][1][e + 1],
                              acc[mt][2][e + 1], acc[mt][3][e + 1]);
      lo.x *= s_lo.x; lo.y *= s_lo.y; lo.z *= s_lo.z; lo.w *= s_lo.w;
      hi.x *= s_hi.x; hi.y *= s_hi.y; hi.z *= s_hi.z; hi.w *= s_hi.w;
      float* o = base + static_cast<size_t>(row) * N + n0 + col;
      *reinterpret_cast<float4*>(o) = lo;
      *reinterpret_cast<float4*>(o + 4) = hi;
    }
  }
}

// out = s * (partials[0] + partials[1] + ... ), added in split order.
__global__ void __launch_bounds__(256)
q8_reduce(const float4* __restrict__ partials, const float* __restrict__ s,
          float4* __restrict__ out, int mn4, int N, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn4) return;
  float4 acc = partials[i];
  for (int sp = 1; sp < splits; ++sp) {
    const float4 p = partials[static_cast<size_t>(sp) * mn4 + i];
    acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
  }
  const float4 sc =
      *reinterpret_cast<const float4*>(s + (static_cast<size_t>(i) * 4) % N);
  acc.x *= sc.x; acc.y *= sc.y; acc.z *= sc.z; acc.w *= sc.w;
  out[i] = acc;
}

template <int MT>
cudaError_t launch_tiles(const __nv_bfloat16* x, const int8_t* q,
                         const float* s, float* dst, int M, int K, int N,
                         int splits, cudaStream_t stream) {
  constexpr int smem = kStages * stage_bytes(MT);
  if (smem > 48 * 1024) {
    static std::atomic<bool> raised[64];  // once a device; zero-initialised
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !raised[dev].load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(
          q8_matmul_tiles<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
      if (dev < 64) raised[dev].store(true, std::memory_order_release);
    }
  }
  q8_matmul_tiles<MT><<<dim3(N / kBN, splits), kThreads, smem, stream>>>(
      x, q, s, dst, M, K, N, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] bf16, q [K, N] int8, s [N] float32, all contiguous and 16-byte
// aligned; out [M, N] float32; partials [splits, M, N] float32 (unused
// when splits == 1).  1 <= M <= 64, K % 128 == 0, N % 128 == 0,
// 1 <= splits <= K / 64.
int q8_matmul_launch(const void* x, const void* q, const void* s, void* out,
                     void* partials, int M, int K, int N, int splits,
                     void* stream) {
  if (M < 1 || M > kMaxM || K < 128 || K % 128 || N < 128 || N % 128 ||
      splits < 1 || splits > K / kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(s);
  float* dst = static_cast<float*>(splits == 1 ? out : partials);
  cudaError_t err;
  switch ((M + 15) / 16) {
    case 1: err = launch_tiles<1>(xb, qb, sb, dst, M, K, N, splits, st); break;
    case 2: err = launch_tiles<2>(xb, qb, sb, dst, M, K, N, splits, st); break;
    case 3: err = launch_tiles<3>(xb, qb, sb, dst, M, K, N, splits, st); break;
    default: err = launch_tiles<4>(xb, qb, sb, dst, M, K, N, splits, st);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int mn4 = M * (N / 4);
  q8_reduce<<<(mn4 + 255) / 256, 256, 0, st>>>(
      static_cast<const float4*>(partials), sb, static_cast<float4*>(out),
      mn4, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
