// The general attention backward (the flash gradients at every input the
// wgmma kernels of flash_attention_bwd.cu do not take): attn_general_bwd
// for bfloat16 and float16 on the tensor cores, and the two small stages
// attn_general_bwd_delta and attn_general_dq_convert.  Float32 is in
// attention_general_f32.cu; the design and the replaced TPU kernels are set
// out at the head of attention_general.cu.
//
// attn_general_bwd, 16-bit: a block is (batch x head, 64-key tile), 4
// warps of 16 keys.  Its K and V tiles stay in shared memory for the
// block's life; it walks the query tiles that see its keys with Q and dO
// by 16-byte cp.async into a two-slot ring (the next tile's copies in
// flight while this one computes, one barrier to open a tile and one
// before dQ).  S^T = K Q^T and dP^T = V dO^T run on mma.sync m16n8k16;
// P^T and dS^T are formed in the accumulators and packed in registers into
// the A fragments of dV += P^T dO and dK += dS^T Q (dO and Q by
// ldmatrix.trans), whose float32 sums stay in registers for the block's
// life; dS^T goes once through shared memory so that dQ = dS K (dS by
// ldmatrix.trans as the A operand) runs on the tensor cores too and is
// added into the float32 accumulator by float2 atomics.  Both products'
// reductions run over the whole hd, in k-steps of 16; dK and dV of 16
// keys x 128 dims fill half a thread's registers, so hd up to 128 is one
// block (64 and 128 instantiations) and wider heads take 128-dim output
// blocks that restage K, V, Q and dO 128 dims at a time.  P is rounded to
// the input type before it forms dS (P (dP - delta) from the operand the
// dV product sees).

#include <initializer_list>

#include "attention_general.cuh"

namespace vg_attn {
namespace {

constexpr int kThreads = 128;
constexpr int kDsLd = kRows + 8;          // a dS^T row, padded

size_t bwd16_smem(int width) {
  // K, V; Q and dO two slots each; dS^T; L and delta two slots each
  return sizeof(uint16_t) * (6 * kRows * (width + 8) + kRows * kDsLd) +
         sizeof(float) * 4 * kRows;
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
attn_general_bwd(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ dq_accum, int H,
                 int Tn, int hd, int nv, int n_kt, int n_dc, float scale,
                 bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool wide = hd > kD;
  const int width = wide ? kD : round_up(hd, 16);
  const int ld = width + 8, tile = kRows * ld;
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + tile;
  T* qs = vs + tile;                      // two slots
  T* os = qs + 2 * tile;                  // two slots
  T* dst = os + 2 * tile;                 // dS^T [key][query]
  float* ls = reinterpret_cast<float*>(dst + kRows * kDsLd);  // two slots
  float* dls = ls + 2 * kRows;                                // two slots

  long long blk = blockIdx.x;
  const int kt = static_cast<int>(blk % n_kt);  // tile 0 is the heaviest
  blk /= n_kt;
  const int dc = static_cast<int>(blk % n_dc);
  const long long bh = blk / n_dc;
  const long long b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int key0 = kt * kRows, d0 = dc * kD;
  const long long tok = static_cast<long long>(H) * hd;
  const long long base = b * Tn * tok + h * hd;
  const T* qh = q + base;
  const T* kh = k + base;
  const T* vh = v + base;
  const T* oh = dout + base;
  const int n_out = min(width, hd - d0);
  const int n_out16 = (n_out + 15) / 16;
  const float sl2 = scale * kLog2e;
  auto stage_rows = [&](T* dst_, const T* x, int r0, int w0, int dn) {
    stage(dst_, ld, x, tok, 1LL, r0, Tn, w0, dn, width, aligned, tid,
          kThreads);
  };
  // L in log2 units and delta of the 64 queries from q0, into `slot`
  auto load_rows = [&](int slot, int q0) {
    if (tid < kRows) {
      const int r = q0 + tid;
      ls[slot * kRows + tid] = r < Tn ? lse[bh * Tn + r] * kLog2e : 0.f;
      dls[slot * kRows + tid] = r < Tn ? delta[bh * Tn + r] : 0.f;
    }
  };

  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  const int n_qt = (Tn + kRows - 1) / kRows;
  const int qt0 = key0 < nv ? 0 : kt;
  if (!wide) {
    stage_rows(ks, kh, key0, 0, hd);
    stage_rows(vs, vh, key0, 0, hd);
    stage_rows(qs, qh, qt0 * kRows, 0, hd);
    stage_rows(os, oh, qt0 * kRows, 0, hd);
    cp_async_commit();
    load_rows(0, qt0 * kRows);
  }
  for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
    const int q0 = qt * kRows, slot = wide ? 0 : it & 1;
    const T* qb = qs + slot * tile;
    const T* ob = os + slot * tile;
    const float* L = ls + slot * kRows;
    const float* D = dls + slot * kRows;
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    if (!wide) {
      // this tile has landed; every warp is done with the other slot
      cp_async_wait<0>();
      __syncthreads();
      if (qt + 1 < n_qt) {
        stage_rows(qs + (slot ^ 1) * tile, qh, q0 + kRows, 0, hd);
        stage_rows(os + (slot ^ 1) * tile, oh, q0 + kRows, 0, hd);
        cp_async_commit();
        load_rows(slot ^ 1, q0 + kRows);
      }
      abt16<T, kD / 16>(acc, ks, qb, ld, width / 16, warp, lane);
    } else {
      __syncthreads();
      load_rows(0, q0);
      for (int w0 = 0; w0 < hd; w0 += kD) {
        const int dn = min(kD, hd - w0);
        __syncthreads();
        stage_rows(ks, kh, key0, w0, dn);
        stage_rows(qs, qh, q0, w0, dn);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        abt16<T, kD / 16>(acc, ks, qs, ld, (dn + 15) / 16, warp, lane);
      }
    }
    // P^T: keys key0 + 16 warp + g (+ 8), queries q0 + 8 nt + 2 tq (+ 1);
    // a tile whose keys every query sees skips the test
    const bool whole = q0 + kRows <= Tn && key0 + kRows <= Tn &&
                       key0 + kRows - 1 <= max(q0, nv - 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = key0 + warp * 16 + g + 8 * (e >> 1);
        const int col = nt * 8 + tq * 2 + (e & 1), r = q0 + col;
        const bool vis = whole || (r < Tn && c < Tn && c <= max(r, nv - 1));
        acc[nt][e] = vis ? exp2f(acc[nt][e] * sl2 - L[col]) : 0.f;
      }
    uint32_t pp[4][4], pd[4][4];
    pack_a<T>(pp, acc);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    if (!wide) {
      abt16<T, kD / 16>(acc, vs, ob, ld, width / 16, warp, lane);
    } else {
      for (int w0 = 0; w0 < hd; w0 += kD) {
        const int dn = min(kD, hd - w0);
        __syncthreads();
        stage_rows(vs, vh, key0, w0, dn);
        stage_rows(os, oh, q0, w0, dn);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        abt16<T, kD / 16>(acc, vs, os, ld, (dn + 15) / 16, warp, lane);
      }
    }
    // dS^T = P^T (dP^T - delta), from the rounded P^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * j + half;
        const int col = nt * 8 + tq * 2;
        const float2 p0 = unpack2<T>(pp[j][2 * half]);
        const float2 p1 = unpack2<T>(pp[j][2 * half + 1]);
        acc[nt][0] = p0.x * (acc[nt][0] - D[col]);
        acc[nt][1] = p0.y * (acc[nt][1] - D[col + 1]);
        acc[nt][2] = p1.x * (acc[nt][2] - D[col]);
        acc[nt][3] = p1.y * (acc[nt][3] - D[col + 1]);
      }
    pack_a<T>(pd, acc);
    {
      T* row = dst + (warp * 16 + g) * kDsLd + tq * 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(row + 16 * j) = pd[j][0];
        *reinterpret_cast<uint32_t*>(row + 8 * kDsLd + 16 * j) = pd[j][1];
        *reinterpret_cast<uint32_t*>(row + 16 * j + 8) = pd[j][2];
        *reinterpret_cast<uint32_t*>(row + 8 * kDsLd + 16 * j + 8) =
            pd[j][3];
      }
    }
    if (wide) {
      __syncthreads();
      stage_rows(ks, kh, key0, d0, n_out);
      stage_rows(qs, qh, q0, d0, n_out);
      stage_rows(os, oh, q0, d0, n_out);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    ax16<T, kD / 8>(dva, pp, ob, ld, n_out16, lane);
    ax16<T, kD / 8>(dka, pd, qb, ld, n_out16, lane);
    __syncthreads();                      // dS^T complete
    // dQ of queries q0 + 16 warp + g (+ 8) = dS K over the tile's keys:
    // dS's A fragments from dS^T by ldmatrix.trans
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldsm_x4_t(da[j], dst + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * kDsLd +
                           warp * 16 + ((lane >> 3) & 1) * 8);
    const int r0 = q0 + warp * 16 + g;
    float* row0 = dq_accum + base + r0 * tok + d0;
    const bool pairs = (hd & 1) == 0;
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      if (dp >= n_out16) continue;
      float dq[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t fb[4];
        ldsm_x4_t(fb, ks + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                          dp * 16 + (lane >> 4) * 8);
        mma<T>(dq[0], da[j], fb[0], fb[1]);
        mma<T>(dq[1], da[j], fb[2], fb[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int dd = dp * 16 + half * 8 + tq * 2;
          if (r0 + 8 * i >= Tn || dd >= n_out) continue;
          float* at = row0 + 8 * i * tok + dd;
          if (pairs) {
            atomicAdd(reinterpret_cast<float2*>(at),
                      make_float2(dq[half][2 * i], dq[half][2 * i + 1]));
          } else {
            atomicAdd(at, dq[half][2 * i]);
            if (dd + 1 < n_out) atomicAdd(at + 1, dq[half][2 * i + 1]);
          }
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = key0 + warp * 16 + g + 8 * i;
    if (c >= Tn) continue;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      const int dd = nd * 8 + tq * 2;
      if (dd >= n_out) continue;
      T* krow = dk + base + c * tok + d0 + dd;
      T* vrow = dv + base + c * tok + d0 + dd;
      krow[0] = from_f<T>(dka[nd][2 * i] * scale);
      vrow[0] = from_f<T>(dva[nd][2 * i]);
      if (dd + 1 < n_out) {
        krow[1] = from_f<T>(dka[nd][2 * i + 1] * scale);
        vrow[1] = from_f<T>(dva[nd][2 * i + 1]);
      }
    }
  }
}

// delta[b, h, t] = sum_d dO * o over [B, T, H, hd] rows, a warp a row; the
// warp zeroes the row's float32 dq accumulator.
template <typename T>
__global__ void __launch_bounds__(256)
attn_general_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta,
                       float* __restrict__ dq_accum, long long n_rows, int Tn,
                       int H, int hd) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const long long at = row * hd;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32) {
    sum = fmaf(to_f<T>(o[at + d]), to_f<T>(dout[at + d]), sum);
    dq_accum[at + d] = 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long h = row % H, bt = row / H;
    delta[((bt / Tn) * H + h) * Tn + bt % Tn] = sum;
  }
}

// dq = scale * dq_accum in the input type, n elements.
template <typename T>
__global__ void __launch_bounds__(256)
attn_general_dq_convert(const float* __restrict__ acc, T* __restrict__ dq,
                        long long n, float scale) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    dq[i] = from_f<T>(acc[i] * scale);
}

template <typename T, int kD>
cudaError_t launch_bwd16(const BwdArgs& a) {
  const bool wide = a.hd > kD;
  const int n_kt = (a.T + kRows - 1) / kRows;
  const int n_dc = wide ? (a.hd + kD - 1) / kD : 1;
  const long long blocks = static_cast<long long>(a.B) * a.H * n_dc * n_kt;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  auto* kern = attn_general_bwd<T, kD>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(kern, bwd16_smem(kD), smem_set);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd16_smem(wide ? kD : round_up(a.hd, 16));
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dq_accum), a.H, a.T, a.hd, a.nv, n_kt, n_dc,
      a.scale, a.aligned != 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd16_dims(const BwdArgs& a) {
  switch (a.d_max) {
    case 64:
      return launch_bwd16<T, 64>(a);
    case 128:
      return launch_bwd16<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                         void* dq_accum, int B, int Tn, int H, int hd,
                         cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Tn * H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  attn_general_bwd_delta<T><<<static_cast<unsigned>(blocks), 256, 0,
                              stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), static_cast<float*>(dq_accum), rows, Tn, H,
      hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_convert(const void* acc, void* dq, long long n,
                           float scale, cudaStream_t stream) {
  const long long blocks = (n + 255) / 256 < (1LL << 20) ? (n + 255) / 256
                                                          : (1LL << 20);
  attn_general_dq_convert<T><<<static_cast<unsigned>(blocks), 256, 0,
                               stream>>>(static_cast<const float*>(acc),
                                         static_cast<T*>(dq), n, scale);
  return cudaGetLastError();
}

// dtype codes of the entry points: 0 float32, 1 bfloat16, 2 float16
#define VG_DISPATCH(dtype, call_f32, call_bf16, call_f16)        \
  switch (dtype) {                                               \
    case 0:                                                      \
      return static_cast<int>(call_f32);                         \
    case 1:                                                      \
      return static_cast<int>(call_bf16);                        \
    case 2:                                                      \
      return static_cast<int>(call_f16);                         \
    default:                                                     \
      return static_cast<int>(cudaErrorInvalidValue);            \
  }

}  // namespace
}  // namespace vg_attn

extern "C" {

// o, dout: [B, T, H, hd] of `dtype`, contiguous; delta: float32 [B, H, T];
// dq_accum: float32 [B, T, H, hd], zeroed here.
int attn_general_bwd_delta_launch(const void* o, const void* dout,
                                  void* delta, void* dq_accum, int B, int T,
                                  int H, int hd, int dtype, void* stream) {
  using namespace vg_attn;
  if (B < 1 || H < 1 || T < 1 || hd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VG_DISPATCH(dtype,
              launch_delta<float>(o, dout, delta, dq_accum, B, T, H, hd, s),
              launch_delta<__nv_bfloat16>(o, dout, delta, dq_accum, B, T, H,
                                          hd, s),
              launch_delta<__half>(o, dout, delta, dq_accum, B, T, H, hd, s))
}

// q, k, v, dout, dk, dv: [B, T, H, hd] of `dtype`, contiguous; lse, delta:
// float32 [B, H, T]; dq_accum: float32 [B, T, H, hd], zeroed, summed into
// unscaled.  d_max: the instantiation's head-dim maximum (64 or 128; wider
// heads take 128-dim output blocks); aligned 1: every row of q, k, v, dout,
// dk and dv on 16 bytes (checked here).
int attn_general_bwd_launch(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            void* dq_accum, int B, int T, int H, int hd,
                            int nv, int dtype, float scale, int d_max,
                            int aligned, void* stream) {
  using namespace vg_attn;
  if (B < 1 || H < 1 || T < 1 || hd < 1 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (aligned) {
    const long long tok = static_cast<long long>(H) * hd;
    const Layout lay{T * tok, hd, tok, 1};
    const int vec = dtype == 0 ? 4 : 8;
    for (const void* p : {q, k, v, dout, static_cast<const void*>(dk),
                          static_cast<const void*>(dv)})
      if (!rows_aligned(p, lay, B, H, T, hd, vec))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{q,  k,  v,  dout, lse, delta,   dk,    dv,
                  dq_accum, B, T, H, hd, nv, d_max, aligned, scale,
                  static_cast<cudaStream_t>(stream)};
  VG_DISPATCH(dtype, bwd32_launch(a), launch_bwd16_dims<__nv_bfloat16>(a),
              launch_bwd16_dims<__half>(a))
}

// dq (n elements of `dtype`) = scale * dq_accum.
int attn_general_dq_convert_launch(const void* dq_accum, void* dq,
                                   long long n, int dtype, float scale,
                                   void* stream) {
  using namespace vg_attn;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  VG_DISPATCH(dtype, launch_convert<float>(dq_accum, dq, n, scale, s),
              launch_convert<__nv_bfloat16>(dq_accum, dq, n, scale, s),
              launch_convert<__half>(dq_accum, dq, n, scale, s))
}

}  // extern "C"
