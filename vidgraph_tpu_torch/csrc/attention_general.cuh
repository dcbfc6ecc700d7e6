// Shared pieces of the general attention kernels (attention_general.cu,
// attention_general_bwd.cu, attention_general_f32.cu): type conversions,
// the tensor-core and copy instructions, the warp's 16-row products, tile
// staging, the launch arguments.  The design is set out at the head of
// attention_general.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace vg_attn {

constexpr int kRows = 64;                 // query rows or keys a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr long long kMaxBlocks = 2147483647LL;

// Element strides of a [B, H, T, hd] view.
struct Layout {
  long long b, h, t, d;
};
struct Strides {
  Layout q, k, v, o;
};

// The forward's launch: q, k, v, out [B, H, T, hd] at `st`; lse float32
// [B, H, T] or null; d_max the instantiation's head-dim maximum (wider
// heads take 256-dim output blocks); aligned: every row on 16 bytes.
struct FwdArgs {
  const void *q, *k, *v;
  void *out, *lse;
  Strides st;
  int B, H, T, hd, nv, two_pass, d_max, aligned;
  float scale;
  cudaStream_t stream;
};

// The backward's launch: q, k, v, dout, dk, dv [B, T, H, hd] contiguous;
// lse, delta float32 [B, H, T]; dq_accum float32 [B, T, H, hd].
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv, *dq_accum;
  int B, T, H, hd, nv, d_max, aligned;
  float scale;
  cudaStream_t stream;
};

cudaError_t fwd32_launch(const FwdArgs& a);
cudaError_t bwd32_launch(const BwdArgs& a);

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Whether a [B, H, T, hd] view's rows all lie on 16 bytes: the pointer, the
// strides of every dimension longer than 1, and hd a whole number of
// 16-byte chunks with the dims contiguous.
inline bool rows_aligned(const void* p, const Layout& l, int B, int H, int T,
                         int hd, int vec) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && hd % vec == 0 &&
         l.d == 1 && (B == 1 || l.b % vec == 0) &&
         (H == 1 || l.h % vec == 0) && (T == 1 || l.t % vec == 0);
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// (lo, hi) rounded to T and packed as one 32-bit register, lo in the low
// half: two neighbouring elements of an mma fragment.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<__half2*>(&x));
  } else {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col) in T (bfloat16 or float16), float32
// accumulators.
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// acc (this warp's 16 rows of a x 64 rows of b) += a b^T over nk16
// k-steps of 16: a's and b's rows `ld` elements apart.
template <typename T, int kMaxK16>
__device__ __forceinline__ void abt16(float (&acc)[8][4], const T* a,
                                      const T* b, int ld, int nk16, int warp,
                                      int lane) {
#pragma unroll
  for (int kk = 0; kk < kMaxK16; ++kk) {
    if (kk < nk16) {
      uint32_t fa[4];
      ldsm_x4(fa, a + (warp * 16 + (lane & 15)) * ld + kk * 16 +
                      (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t fb[4];
        ldsm_x4(fb, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma<T>(acc[2 * np], fa, fb[0], fb[1]);
        mma<T>(acc[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// acc (16 x 16 n16 dims) += A (16 x 64, four k-steps of packed fragments)
// times x (64 rows x dims, row-major, by ldmatrix.trans).
template <typename T, int kMaxD8>
__device__ __forceinline__ void ax16(float (&acc)[kMaxD8][4],
                                     const uint32_t (&fa)[4][4], const T* x,
                                     int ld, int n16, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int dp = 0; dp < kMaxD8 / 2; ++dp) {
      if (dp < n16) {
        uint32_t fb[4];
        ldsm_x4_t(fb, x + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                          dp * 16 + (lane >> 4) * 8);
        mma<T>(acc[2 * dp], fa[j], fb[0], fb[1]);
        mma<T>(acc[2 * dp + 1], fa[j], fb[2], fb[3]);
      }
    }
  }
}

// The accumulators of n-tiles 2j, 2j + 1 as the A fragment of k-step j.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&fa)[4][4],
                                       const float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fa[j][0] = pack2<T>(x[2 * j][0], x[2 * j][1]);
    fa[j][1] = pack2<T>(x[2 * j][2], x[2 * j][3]);
    fa[j][2] = pack2<T>(x[2 * j + 1][0], x[2 * j + 1][1]);
    fa[j][3] = pack2<T>(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

// 64 rows (from row0; zeros at and past `rows`) x `width` dims (from d0;
// zeros at and past dn) of x into dst, `ld` elements a row.  aligned: by
// 16-byte cp.async copies (the caller commits and waits); else element by
// element at any strides, synchronously.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* x,
                                      long long st_t, long long st_d,
                                      int row0, int rows, int d0, int dn,
                                      int width, bool aligned, int tid,
                                      int nth) {
  // thread tid takes units tid, tid + nth, ... of the 64 x n tile, row by
  // row; (r, c) advances by (nth / n, nth % n) without a division a unit
  const int n = aligned ? width / (16 / static_cast<int>(sizeof(T))) : width;
  const int dr = nth / n, dc = nth - dr * n;
  int r = tid / n, c = tid - r * n;
  for (; r < kRows; r += dr, c += dc) {
    if (c >= n) {
      c -= n;
      ++r;
      if (r >= kRows) break;
    }
    const int row = row0 + r;
    if (aligned) {
      const int e = c * (16 / static_cast<int>(sizeof(T)));
      const bool in = row < rows && e < dn;
      cp_async16(dst + r * ld + e, in ? x + row * st_t + d0 + e : x, in);
    } else {
      dst[r * ld + c] = row < rows && c < dn
                            ? x[row * st_t + (d0 + c) * st_d]
                            : from_f<T>(0.f);
    }
  }
}

// Sets a kernel's dynamic shared memory limit once.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace vg_attn
