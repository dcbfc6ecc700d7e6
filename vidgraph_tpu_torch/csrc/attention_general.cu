// Attention at the inputs the fast kernels do not take, for Hopper (sm_90a):
// any head dim, float32, bfloat16 or float16, any token count, any number
// of heads, any strides.
//
// Replaces, at those inputs, the same TPU kernels as the fast ones:
// vidgraph_tpu/models/captioner.py::_attn_flash (JAX's Pallas TPU
// flash_attention forward and its backward pallas_calls
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq, which take any
// float type, any head dim below 128 and multiples of 128 above) and
// vidgraph_tpu/ops/short_attention.py::_fused_kernel (any even head count,
// any N, any float type).  flash_attention.cu / flash_attention_bwd.cu keep
// bfloat16 at hd 64 and 128, short_attention.cu bfloat16 at hd 64 and
// N <= 256; ops/flash_attention.py::flash_route and
// ops/short_attention.py::short_route choose, in Python, before the launch,
// and ops/flash_attention.py::general_plan picks the instantiation here
// (the head-dim maximum, and whether every row lies on 16 bytes).
//
// What they compute, for q, k, v [B, H, T, hd] at element strides:
//
//   s[r,c] = (q[r] . k[c]) * scale,  visible(r,c) = c <= max(r, nv - 1)
//   online (the flash forward): out[r] = sum_c e[r,c] v[c] / sum_c e[r,c],
//     e = exp(s - running max) rounded to the input type as the P.V
//     operand; L[r] = max + log(sum)
//   two passes (_fused_kernel's arithmetic): pass 1 the row max m and sum
//     l; pass 2 p = exp(s - m) / l rounded to the input type, out = P.V
//   backward (attention_general_bwd.cu): delta = rowsum(dO * o),
//     P = exp(s - L), dS = P (dO.v - delta), P and dS rounded to the input
//     type as operands; dV = P^T dO, dK = scale dS^T q, dQ = scale dS k
//     summed in a float32 accumulator by atomics
//
// with float32 sums and each output rounded once.  Float32 inputs get
// float32 products throughout (attention_general_f32.cu): no TF32, since
// the tiny64 captioner's tokens must equal its plain prefill's.
//
// What bounds them on the H100.  16-bit: the tensor cores (989 TFLOP/s) at
// long T; launch latency and the softmax's exponentials at short T (a
// ViT's N 50 at hd 80).  Float32: the CUDA cores' FMAs (67 TFLOP/s) at
// long T; launch latency at short T (the tiny64 tower's N 5, the tiny64
// captioner's prefill).  The bytes are q, k, v and the output once: far
// below either at every shape the paths launch.
//
// Design, 16-bit (this file and attention_general_bwd.cu):
// * Both products on mma.sync m16n8k16 with float32 accumulators, operands
//   by ldmatrix (.trans for V, dO and Q where they are the k x n operand).
//   Not wgmma: this route takes every hd from 1 to 512 and beyond, strided
//   views whose rows need not lie on the 16 bytes TMA needs, and tiles of
//   5 or 9 tokens; a 64-row wgmma tile with TMA descriptors would leave
//   most of that to masking, and mma.sync takes 16-row warp tiles with the
//   same fragments at any hd.
// * Forward: a block is (batch x head, 64 query rows), 4 warps of 16 rows.
//   q is staged once into shared memory and never restaged; K and V tiles
//   of 64 keys come by 16-byte cp.async into a ring of three slots (copies
//   two tiles ahead) up to a width of 64, two above, the next copies
//   issued right after the one barrier a tile, so they fly while the tile
//   computes.  S stays in the accumulators; the online softmax runs on
//   them in registers (exp2f, log2(e) folded into the scale; the mask
//   test only on tiles that cut the diagonal or the sequence's end); P is
//   packed in registers into the A fragments of P.V (the m16n8
//   accumulator layout is the m16n8k16 A layout), so it never touches
//   shared memory.  Two passes: pass 1 runs QK^T alone (no V copies) for
//   m and l, pass 2 QK^T again, then the normalised, rounded p and P.V;
//   both on tensor cores, so the second QK^T costs little.  With one key
//   tile (N <= 64) K and V are staged once for both passes.
// * Every head dim in one block up to 256: the QK^T reduction runs over hd
//   in k-steps of 16 (zero-padded in shared memory), P.V over n-tiles of 8
//   up to the instantiation's maximum (64, 128 or 256, chosen by hd), so
//   hd 80 computes its scores once over 80 dims.  Only hd > 256 splits into
//   256-dim output blocks that recompute the scores, restaging q and k 256
//   dims at a time.
// * Rows not on 16 bytes (a view one element into its storage, hd 15)
//   take element loads into the same shared-memory tiles and the same
//   tensor-core compute (`aligned` false): never the plain version.
// * Grid: one-dimensional, heaviest query tiles first; B x H is bounded by
//   2^31 blocks.  Shared memory 7 tiles of 64 x (hd + 8) up to hd 64 (65
//   KB at 64), 5 above.
// * As measured on an H100 (PERF.md section 6), a key tile costs ~2.4 us at
//   hd 32-64 with 1-2 blocks an SM, far from the tensor cores' rate; a
//   third ring slot and two warp groups splitting a block's keys did not
//   shorten it, so what holds a tile is open.
//
// The entry points have a plain C interface and return cudaGetLastError().

#include <algorithm>

#include "attention_general.cuh"

namespace vg_attn {
namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the K/V ring's slots: three (copies two steps ahead) up to a width of
// 64, where 7 tiles leave three blocks an SM; two above (a third slot cost
// hd 80 17 % on an H100: PERF.md section 6)
__host__ __device__ constexpr int fwd16_slots(int width) {
  return width <= 64 ? 3 : 2;
}

constexpr size_t fwd16_smem(int width) {
  return sizeof(uint16_t) * (1 + 2 * fwd16_slots(width)) * kRows *
         (width + 8);
}

template <typename T, int kD, bool kTwoPass>
__global__ void __launch_bounds__(kThreads)
attn_general_fwd(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides st, int H, int Tn, int hd,
                 int nv, int n_qt, int n_dc, float scale, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool wide = hd > kD;
  const int width = wide ? kD : round_up(hd, 16);
  const int ld = width + 8, tile = kRows * ld;
  const int slots = wide ? 1 : fwd16_slots(width);
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + tile;                      // `slots` tiles
  T* vs = ks + slots * tile;              // `slots` tiles

  long long blk = blockIdx.x;
  const int qt = n_qt - 1 - static_cast<int>(blk % n_qt);  // heaviest first
  blk /= n_qt;
  const int dc = static_cast<int>(blk % n_dc);
  const long long bh = blk / n_dc;
  const long long b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = qt * kRows, d0 = dc * kD;
  const T* qh = q + b * st.q.b + h * st.q.h;
  const T* kh = k + b * st.k.b + h * st.k.h;
  const T* vh = v + b * st.v.b + h * st.v.h;
  // output dims of this block, in 16-dim steps
  const int n_out16 = (min(width, hd - d0) + 15) / 16;

  const int last_row = min(row0 + kRows - 1, Tn - 1);
  const int n_kt = min(max(last_row, nv - 1), Tn - 1) / kRows + 1;
  const int steps = kTwoPass ? 2 * n_kt : n_kt;
  // one key tile: k and v are staged once, for both passes
  const bool single = n_kt == 1 && !wide;
  const float sl2 = scale * kLog2e;
  auto needs_v = [&](int s) { return !kTwoPass || s >= n_kt; };
  auto tile_of = [&](int s) { return s >= n_kt ? s - n_kt : s; };
  // step s's K (and V where P.V runs) into slot s % slots
  auto stage_step = [&](int s) {
    const int key0 = tile_of(s) * kRows, slot = (s % slots) * tile;
    stage(ks + slot, ld, kh, st.k.t, st.k.d, key0, Tn, 0, hd, width, aligned,
          tid, kThreads);
    if (needs_v(s) || single)
      stage(vs + slot, ld, vh, st.v.t, st.v.d, key0, Tn, 0, hd, width,
            aligned, tid, kThreads);
  };

  float o[kD / 8][4], m[2], l[2], inv_l[2];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
    inv_l[i] = 1.f;
  }

  // one copy group a step, committed even when empty, so that before step
  // s exactly slots - 2 later groups may still fly
  if (!wide) {
    stage(qs, ld, qh, st.q.t, st.q.d, row0, Tn, 0, hd, width, aligned, tid,
          kThreads);
    stage_step(0);
    cp_async_commit();
    if (slots == 3) {
      if (!single && steps > 1) stage_step(1);
      cp_async_commit();
    }
  }
  for (int s = 0; s < steps; ++s) {
    const int key0 = tile_of(s) * kRows;
    const bool pv = needs_v(s);
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    const T* kt_s = ks;
    const T* vt_s = vs;
    if (!wide) {
      // step s has landed, and every warp is done with step s - 1's slot
      if (slots == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if (!single) {
        if (s + slots - 1 < steps) stage_step(s + slots - 1);
        cp_async_commit();
        kt_s += (s % slots) * tile;
        vt_s += (s % slots) * tile;
      }
      abt16<T, kD / 16>(sc, qs, kt_s, ld, width / 16, warp, lane);
    } else {
      // hd > kD: the scores over kD-dim windows of q and k, restaged
      for (int w0 = 0; w0 < hd; w0 += kD) {
        const int dn = min(kD, hd - w0);
        __syncthreads();
        stage(qs, ld, qh, st.q.t, st.q.d, row0, Tn, w0, dn, kD, aligned, tid,
              kThreads);
        stage(ks, ld, kh, st.k.t, st.k.d, key0, Tn, w0, dn, kD, aligned, tid,
              kThreads);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        abt16<T, kD / 16>(sc, qs, ks, ld, (dn + 15) / 16, warp, lane);
      }
    }
    // scale into log2 units; hidden keys -inf (key 0 is visible to every
    // row, so each row's max is finite after the first tile).  A tile that
    // every row of the block sees whole skips the test.
    const int last_key = key0 + kRows - 1;
    const bool whole = last_key < Tn && last_key <= max(row0, nv - 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = key0 + nt * 8 + tq * 2 + (e & 1);
        const int r = row0 + warp * 16 + g + 8 * (e >> 1);
        sc[nt][e] = whole || (c < Tn && c <= max(r, nv - 1))
                        ? sc[nt][e] * sl2
                        : -CUDART_INF_F;
      }
    if (!kTwoPass || s < n_kt) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = exp2f(sc[nt][e] - m[e >> 1]);
          l[e >> 1] += sc[nt][e];
        }
      if (!kTwoPass) {
#pragma unroll
        for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];
      }
    } else {
      if (s == n_kt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) inv_l[i] = 1.f / quad_sum(l[i]);
      }
      // _fused_kernel's p: exactly normalised, then rounded (in pack_a)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = exp2f(sc[nt][e] - m[e >> 1]) * inv_l[e >> 1];
    }
    if (pv) {
      if (wide) {
        __syncthreads();
        stage(vs, ld, vh, st.v.t, st.v.d, key0, Tn, d0, min(kD, hd - d0), kD,
              aligned, tid, kThreads);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      // P rounded to T in the A fragments of P.V
      uint32_t pa[4][4];
      pack_a<T>(pa, sc);
      ax16<T, kD / 8>(o, pa, vt_s, ld, n_out16, lane);
    }
  }
  if (!kTwoPass) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = quad_sum(l[i]);
      inv_l[i] = 1.f / l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + g + 8 * i;
    if (r >= Tn) continue;
    if (!kTwoPass && lse != nullptr && dc == 0 && tq == 0)
      lse[bh * Tn + r] = m[i] * kLn2 + logf(l[i]);
    const float inv = kTwoPass ? 1.f : inv_l[i];
    T* orow = out + b * st.o.b + h * st.o.h + r * st.o.t;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      const int d = d0 + nd * 8 + tq * 2;
      if (nd * 8 >= width || d >= hd) continue;
      const float lo = o[nd][2 * i] * inv, hi = o[nd][2 * i + 1] * inv;
      if (aligned) {
        *reinterpret_cast<uint32_t*>(orow + d) = pack2<T>(lo, hi);
      } else {
        orow[d * st.o.d] = from_f<T>(lo);
        if (d + 1 < hd) orow[(d + 1) * st.o.d] = from_f<T>(hi);
      }
    }
  }
}

template <typename T, int kD, bool kTwoPass>
cudaError_t launch_fwd16(const FwdArgs& a) {
  const bool wide = a.hd > kD;
  const int n_qt = (a.T + kRows - 1) / kRows;
  const int n_dc = wide ? (a.hd + kD - 1) / kD : 1;
  const long long blocks = static_cast<long long>(a.B) * a.H * n_dc * n_qt;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  auto* kern = attn_general_fwd<T, kD, kTwoPass>;
  static bool smem_set = false;
  cudaError_t err = allow_smem(
      kern, std::max(fwd16_smem(kD), fwd16_smem(std::min(kD, 64))),
      smem_set);
  if (err != cudaSuccess) return err;
  const size_t smem = wide ? sizeof(uint16_t) * 3 * kRows * (kD + 8)
                           : fwd16_smem(round_up(a.hd, 16));
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.st, a.H, a.T, a.hd, a.nv, n_qt, n_dc,
      a.scale, a.aligned != 0);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t launch_fwd16_mode(const FwdArgs& a) {
  return a.two_pass ? launch_fwd16<T, kD, true>(a)
                    : launch_fwd16<T, kD, false>(a);
}

template <typename T>
cudaError_t launch_fwd16_dims(const FwdArgs& a) {
  switch (a.d_max) {
    case 64:
      return launch_fwd16_mode<T, 64>(a);
    case 128:
      return launch_fwd16_mode<T, 128>(a);
    case 256:
      return launch_fwd16_mode<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vg_attn

extern "C" {

// q, k, v, out: [B, H, T, hd] of `dtype` (0 float32, 1 bfloat16, 2
// float16) at the element strides strides[0..15] = (b, h, t, d) of q, k,
// v, out; lse: float32 [B, H, T] or null (the online mode only); two_pass
// 1 normalises p before P.V (_fused_kernel's arithmetic) and writes no
// lse.  nv = T sees every key.  d_max: the head-dim maximum of the
// instantiation (64, 128 or 256; wider heads take 256-dim output blocks);
// aligned 1: every row of q, k, v and out on 16 bytes (checked here).
int attn_general_fwd_launch(const void* q, const void* k, const void* v,
                            void* out, void* lse, const long long* strides,
                            int B, int H, int T, int hd, int nv, int two_pass,
                            int dtype, float scale, int d_max, int aligned,
                            void* stream) {
  using namespace vg_attn;
  if (B < 1 || H < 1 || T < 1 || hd < 1 || dtype < 0 || dtype > 2 ||
      (two_pass && lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q, k, v, out, lse, {}, B, H, T, hd, nv, two_pass, d_max, aligned,
            scale, static_cast<cudaStream_t>(stream)};
  Layout* ls[4] = {&a.st.q, &a.st.k, &a.st.v, &a.st.o};
  const void* ps[4] = {q, k, v, out};
  const int vec = dtype == 0 ? 4 : 8;
  for (int i = 0; i < 4; ++i) {
    *ls[i] = {strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
              strides[4 * i + 3]};
    if (aligned && !rows_aligned(ps[i], *ls[i], B, H, T, hd, vec))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0:
      return static_cast<int>(fwd32_launch(a));
    case 1:
      return static_cast<int>(launch_fwd16_dims<__nv_bfloat16>(a));
    default:
      return static_cast<int>(launch_fwd16_dims<__half>(a));
  }
}

}  // extern "C"
