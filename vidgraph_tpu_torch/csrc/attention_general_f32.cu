// The general attention kernels for float32 inputs, on the CUDA cores:
// attn_general_fwd (online and two passes) and attn_general_bwd.  The
// functions and the replaced TPU kernels are set out at the head of
// attention_general.cu.
//
// Float32 gets float32 products and sums (no TF32: the tiny64 caption's
// tokens must equal its plain prefill's), so it is bound by FMAs at 67
// TFLOP/s.  The design spends them on the products and little else:
// * Forward: a block is (batch x head, 64 query rows), 128 threads as 16 x
//   8, each holding a 4-row x 8-key score tile and 4 rows x (4 dims every
//   32) of the output.  q is staged once and held for the block; k and v
//   tiles come by 16-byte cp.async, the next key tile's copy issued as soon
//   as the scores no longer read the slot (v's after P.V), so copies fly
//   while the other product runs; with one key tile (short attention's N
//   <= 64) k and v are staged once for both passes.  The score product
//   reads q and k as float4 (12 shared loads a 128 FMAs); P goes through
//   shared memory and P.V loops over the tile's keys only, with v read as
//   float4.  Loops over keys and queries are not unrolled past 4: a fully
//   unrolled 64-key loop made the kernels too large for the instruction
//   cache (PERF.md section 6).  Scores once for every hd up to 256
//   (instantiations of 64, 128 and 256 dims); hd > 256 takes 256-dim output
//   blocks that restage q and k.
// * Backward: a block is (batch x head, 64-key tile), 256 threads as 32 x
//   8: each thread 2 keys x 8 queries of S^T and dP^T, and 2 keys x (4
//   dims every 32) of dK and dV; k and v held for the block, q and dO a
//   query tile at a time (the next tile's copies in flight during dQ); P^T
//   and dS^T through shared memory for dV += P^T dO, dK += dS^T q and dQ =
//   dS k, dQ added into the float32 accumulator by float4 atomics.  hd up
//   to 128 in one block (64 and 128 instantiations: dK and dV of 128 dims
//   fill the registers); wider heads restage 128-dim windows.
// * Rows not on 16 bytes take element loads into the same tiles.
// expf throughout: the exact-token gate is float32.

#include "attention_general.cuh"

namespace vg_attn {
namespace {

constexpr int kPLd = kRows + 8;           // a row of P (or P^T, dS^T)

// Max (or sum) over the 8 threads of a row (neighbouring lanes).
__device__ __forceinline__ float row8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a,
                                     const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s[i][j] += a[ra + rstep i] . b[rb + 8 j] over nd4 float4 steps: rows of
// a and b `ld` floats apart.
template <int kI>
__device__ __forceinline__ void dot_tile(float (&s)[kI][8], const float* a,
                                         int ra, int rstep, const float* b,
                                         int rb, int ld, int nd4) {
#pragma unroll 2
  for (int d4 = 0; d4 < nd4; ++d4) {
    float4 x[kI], y[8];
#pragma unroll
    for (int i = 0; i < kI; ++i) x[i] = ld4(a + (ra + rstep * i) * ld + d4 * 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = ld4(b + (rb + 8 * j) * ld + d4 * 4);
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dot4(x[i], y[j], s[i][j]);
  }
}

constexpr int kFwdThreads = 128;

constexpr size_t fwd32_smem(int width) {
  return sizeof(float) * (3 * kRows * (width + 4) + kRows * kPLd);
}

template <int kD, bool kTwoPass>
__global__ void __launch_bounds__(kFwdThreads)
attn_general_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Strides st, int H, int Tn,
                     int hd, int nv, int n_qt, int n_dc, float scale,
                     bool aligned) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int kJ = kD / 32;             // output float4 groups a thread
  const bool wide = hd > kD;
  const int width = wide ? kD : round_up(hd, 32);
  const int ld = width + 4;               // an odd number of float4s
  float* qs = fsm;
  float* ks = qs + kRows * ld;
  float* vs = ks + kRows * ld;
  float* ps = vs + kRows * ld;            // P [row][key]

  long long blk = blockIdx.x;
  const int qt = n_qt - 1 - static_cast<int>(blk % n_qt);  // heaviest first
  blk /= n_qt;
  const int dc = static_cast<int>(blk % n_dc);
  const long long bh = blk / n_dc;
  const long long b = bh / H, h = bh % H;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int row0 = qt * kRows, d0 = dc * kD;
  const float* qh = q + b * st.q.b + h * st.q.h;
  const float* kh = k + b * st.k.b + h * st.k.h;
  const float* vh = v + b * st.v.b + h * st.v.h;
  const int n_out = min(width, hd - d0);  // output dims of this block
  const int n_out32 = (n_out + 31) / 32;

  const int last_row = min(row0 + kRows - 1, Tn - 1);
  const int n_kt = min(max(last_row, nv - 1), Tn - 1) / kRows + 1;
  const int steps = kTwoPass ? 2 * n_kt : n_kt;
  // one key tile: k and v are staged once, for both passes
  const bool single = n_kt == 1 && !wide;
  auto needs_v = [&](int s) { return !kTwoPass || s >= n_kt; };
  auto tile_of = [&](int s) { return s >= n_kt ? s - n_kt : s; };
  auto stage_rows = [&](float* dst, const float* x, const Layout& l, int r0,
                        int w0, int dn) {
    stage(dst, ld, x, l.t, l.d, r0, Tn, w0, dn, width, aligned, tid,
          kFwdThreads);
  };

  float o[4][kJ][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
  }

  // groups in flight: q and k of step 0, then v of step 0 where needed
  if (!wide) {
    stage_rows(qs, qh, st.q, row0, 0, hd);
    stage_rows(ks, kh, st.k, 0, 0, hd);
    cp_async_commit();
    if (needs_v(0) || single) {
      stage_rows(vs, vh, st.v, 0, 0, hd);
      cp_async_commit();
    }
  }
  for (int s = 0; s < steps; ++s) {
    const int key0 = tile_of(s) * kRows, nkeys = min(kRows, Tn - key0);
    // next: a prefetch of step s + 1 is in flight behind this step's copies
    const bool pv = needs_v(s), next = s + 1 < steps && !single && !wide;
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    if (!wide) {
      if (pv && !single)
        cp_async_wait<1>();               // k of step s; v may still fly
      else
        cp_async_wait<0>();
      __syncthreads();
      dot_tile<4>(sc, qs, ty, 16, ks, tx, ld, (hd + 3) / 4);
      if (next) {
        __syncthreads();                  // every thread is done with ks
        const int nk0 = tile_of(s + 1) * kRows;
        stage_rows(ks, kh, st.k, nk0, 0, hd);
        cp_async_commit();
        if (!pv && needs_v(s + 1)) {
          stage_rows(vs, vh, st.v, nk0, 0, hd);
          cp_async_commit();
        }
      }
    } else {
      for (int w0 = 0; w0 < hd; w0 += kD) {
        const int dn = min(kD, hd - w0);
        __syncthreads();
        stage_rows(qs, qh, st.q, row0, w0, dn);
        stage_rows(ks, kh, st.k, key0, w0, dn);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        dot_tile<4>(sc, qs, ty, 16, ks, tx, ld, (dn + 3) / 4);
      }
    }
    // a tile that every row of the block sees whole skips the test
    const int last_key = key0 + kRows - 1;
    const bool whole = last_key < Tn && last_key <= max(row0, nv - 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = key0 + tx + 8 * j;
        sc[i][j] = whole || (c < Tn && c <= max(r, nv - 1))
                       ? sc[i][j] * scale
                       : -CUDART_INF_F;
      }
    }
    if (!kTwoPass || s < n_kt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = sc[i][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) mx = fmaxf(mx, sc[i][j]);
        const float m_new = fmaxf(m[i], row8_max(mx));
        const float alpha = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = expf(sc[i][j] - m_new);
          l[i] += sc[i][j];
        }
        if (!kTwoPass) {
#pragma unroll
          for (int j = 0; j < kJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[i][j][e] *= alpha;
        }
      }
    } else {
      if (s == n_kt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] = row8_sum(l[i]);
      }
      // _fused_kernel's p: exactly normalised
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = expf(sc[i][j] - m[i]) / l[i];
    }
    if (!pv) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ps[(ty + 16 * i) * kPLd + tx + 8 * j] = sc[i][j];
    if (wide) {
      __syncthreads();
      stage_rows(vs, vh, st.v, key0, d0, n_out);
      cp_async_commit();
    }
    if (next)
      cp_async_wait<1>();                 // v of step s; k of s + 1 flies
    else
      cp_async_wait<0>();
    __syncthreads();                      // P and v of this step are in
    // o[i][j] += sum over the tile's keys of p[row i][key] v[key][dims of
    // group j]
#pragma unroll 4
    for (int c = 0; c < nkeys; ++c) {
      float pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pk[i] = ps[(ty + 16 * i) * kPLd + c];
      const float* vrow = vs + c * ld + tx * 4;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (j < n_out32) {
          const float4 vv = ld4(vrow + j * 32);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma4(o[i][j], pk[i], vv);
        }
      }
    }
    if (!wide && !single) {
      __syncthreads();                    // every thread is done with vs, ps
      if (next && needs_v(s + 1)) {
        stage_rows(vs, vh, st.v, tile_of(s + 1) * kRows, 0, hd);
        cp_async_commit();
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (!kTwoPass) l[i] = row8_sum(l[i]);
    if (r >= Tn) continue;
    if (!kTwoPass && lse != nullptr && dc == 0 && tx == 0)
      lse[bh * Tn + r] = m[i] + logf(l[i]);
    const float inv = kTwoPass ? 1.f : 1.f / l[i];
    float* orow = out + b * st.o.b + h * st.o.h + r * st.o.t;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dd = j * 32 + tx * 4 + e;
        if (dd < n_out) orow[(d0 + dd) * st.o.d] = o[i][j][e] * inv;
      }
  }
}

constexpr int kBwdThreads = 256;

constexpr size_t bwd32_smem(int width) {
  // k, v, q, dO tiles; P^T and dS^T [key][query]; L and delta
  return sizeof(float) *
         (4 * kRows * (width + 4) + 2 * kRows * kPLd + 2 * kRows);
}

// One block a (batch x head, 64-key tile, output block): for every query
// tile that sees its keys, S^T and dP^T over the whole hd, P^T and dS^T,
// dV += P^T dO and dK += dS^T q, and dQ = dS k added into the accumulator.
template <int kD>
__global__ void __launch_bounds__(kBwdThreads)
attn_general_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dq_accum,
                     int H, int Tn, int hd, int nv, int n_kt, int n_dc,
                     float scale, bool aligned) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int kJ = kD / 32;
  const bool wide = hd > kD;
  const int width = wide ? kD : round_up(hd, 32);
  const int ld = width + 4;
  float* ks = fsm;
  float* vs = ks + kRows * ld;
  float* qs = vs + kRows * ld;
  float* os = qs + kRows * ld;
  float* pst = os + kRows * ld;           // P^T [key][query]
  float* dst = pst + kRows * kPLd;        // dS^T [key][query]
  float* ls = dst + kRows * kPLd;
  float* dls = ls + kRows;

  long long blk = blockIdx.x;
  const int kt = static_cast<int>(blk % n_kt);  // tile 0 is the heaviest
  blk /= n_kt;
  const int dc = static_cast<int>(blk % n_dc);
  const long long bh = blk / n_dc;
  const long long b = bh / H, h = bh % H;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int key0 = kt * kRows, d0 = dc * kD;
  const long long tok = static_cast<long long>(H) * hd;
  const long long base = b * Tn * tok + h * hd;
  const float* qh = q + base;
  const float* kh = k + base;
  const float* vh = v + base;
  const float* oh = dout + base;
  const int n_out = min(width, hd - d0);
  const int n_out32 = (n_out + 31) / 32;
  const int nkeys = min(kRows, Tn - key0);
  auto stage_rows = [&](float* dst_, const float* x, int r0, int w0, int dn) {
    stage(dst_, ld, x, tok, 1LL, r0, Tn, w0, dn, width, aligned, tid,
          kBwdThreads);
  };
  auto load_rows = [&](int q0) {
    if (tid < kRows) {
      const int r = q0 + tid;
      ls[tid] = r < Tn ? lse[bh * Tn + r] : 0.f;
      dls[tid] = r < Tn ? delta[bh * Tn + r] : 0.f;
    }
  };

  float dka[2][kJ][4], dva[2][kJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][j][e] = dva[i][j][e] = 0.f;

  const int n_qt = (Tn + kRows - 1) / kRows;
  const int qt0 = key0 < nv ? 0 : kt;
  if (!wide) {
    stage_rows(ks, kh, key0, 0, hd);
    stage_rows(vs, vh, key0, 0, hd);
    stage_rows(qs, qh, qt0 * kRows, 0, hd);
    stage_rows(os, oh, qt0 * kRows, 0, hd);
    cp_async_commit();
    load_rows(qt0 * kRows);
  }
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kRows, nq = min(kRows, Tn - q0);
    // s = S^T, dp = dP^T: keys ty + 32 i, queries tx + 8 j
    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    if (!wide) {
      cp_async_wait<0>();
      __syncthreads();
      dot_tile<2>(s, ks, ty, 32, qs, tx, ld, (hd + 3) / 4);
      dot_tile<2>(dp, vs, ty, 32, os, tx, ld, (hd + 3) / 4);
    } else {
      __syncthreads();
      load_rows(q0);
      for (int w0 = 0; w0 < hd; w0 += kD) {
        const int dn = min(kD, hd - w0);
        __syncthreads();
        stage_rows(ks, kh, key0, w0, dn);
        stage_rows(vs, vh, key0, w0, dn);
        stage_rows(qs, qh, q0, w0, dn);
        stage_rows(os, oh, q0, w0, dn);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        dot_tile<2>(s, ks, ty, 32, qs, tx, ld, (dn + 3) / 4);
        dot_tile<2>(dp, vs, ty, 32, os, tx, ld, (dn + 3) / 4);
      }
    }
    // P^T and dS^T into shared memory; a tile whose keys every query sees
    // skips the test
    const bool whole = q0 + kRows <= Tn && key0 + kRows <= Tn &&
                       key0 + kRows - 1 <= max(q0, nv - 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = key0 + ty + 32 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 8 * j, r = q0 + col;
        const bool vis = whole || (r < Tn && c < Tn && c <= max(r, nv - 1));
        const float p = vis ? expf(s[i][j] * scale - ls[col]) : 0.f;
        pst[(ty + 32 * i) * kPLd + col] = p;
        dst[(ty + 32 * i) * kPLd + col] = p * (dp[i][j] - dls[col]);
      }
    }
    if (wide) {
      __syncthreads();
      stage_rows(ks, kh, key0, d0, n_out);
      stage_rows(qs, qh, q0, d0, n_out);
      stage_rows(os, oh, q0, d0, n_out);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();                      // P^T and dS^T complete
    // dV += P^T dO, dK += dS^T q over the tile's queries
#pragma unroll 4
    for (int r = 0; r < nq; ++r) {
      float pk[2], dsk[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pk[i] = pst[(ty + 32 * i) * kPLd + r];
        dsk[i] = dst[(ty + 32 * i) * kPLd + r];
      }
      const int row = r * ld + tx * 4;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (j < n_out32) {
          const float4 o4 = ld4(os + row + j * 32);
          const float4 q4 = ld4(qs + row + j * 32);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            fma4(dva[i][j], pk[i], o4);
            fma4(dka[i][j], dsk[i], q4);
          }
        }
      }
    }
    __syncthreads();                      // q and dO read
    if (!wide && qt + 1 < n_qt) {
      stage_rows(qs, qh, q0 + kRows, 0, hd);
      stage_rows(os, oh, q0 + kRows, 0, hd);
      cp_async_commit();
      load_rows(q0 + kRows);
    }
    // dQ of queries q0 + ty + 32 i, dims tx * 4 + 32 j, over the tile's keys
    float acc[2][kJ][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < nkeys; ++c) {
      float a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = dst[c * kPLd + ty + 32 * i];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (j < n_out32) {
          const float4 k4 = ld4(ks + c * ld + j * 32 + tx * 4);
#pragma unroll
          for (int i = 0; i < 2; ++i) fma4(acc[i][j], a[i], k4);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + ty + 32 * i;
      if (r >= Tn) continue;
      float* row = dq_accum + base + r * tok + d0;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int dd = j * 32 + tx * 4;
        if (dd >= n_out) continue;
        if (aligned) {
          atomicAdd(reinterpret_cast<float4*>(row + dd),
                    make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                                acc[i][j][3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (dd + e < n_out) atomicAdd(row + dd + e, acc[i][j][e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = key0 + ty + 32 * i;
    if (c >= Tn) continue;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dd = j * 32 + tx * 4 + e;
        if (dd >= n_out) continue;
        dk[base + c * tok + d0 + dd] = dka[i][j][e] * scale;
        dv[base + c * tok + d0 + dd] = dva[i][j][e];
      }
  }
}

template <int kD, bool kTwoPass>
cudaError_t launch_fwd(const FwdArgs& a) {
  const bool wide = a.hd > kD;
  const int n_qt = (a.T + kRows - 1) / kRows;
  const int n_dc = wide ? (a.hd + kD - 1) / kD : 1;
  const long long blocks = static_cast<long long>(a.B) * a.H * n_dc * n_qt;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  auto* kern = attn_general_fwd_f32<kD, kTwoPass>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(kern, fwd32_smem(kD), smem_set);
  if (err != cudaSuccess) return err;
  const size_t smem = fwd32_smem(wide ? kD : round_up(a.hd, 32));
  kern<<<static_cast<unsigned>(blocks), kFwdThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      static_cast<float*>(a.lse), a.st, a.H, a.T, a.hd, a.nv, n_qt, n_dc,
      a.scale, a.aligned != 0);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_fwd_mode(const FwdArgs& a) {
  return a.two_pass ? launch_fwd<kD, true>(a) : launch_fwd<kD, false>(a);
}

template <int kD>
cudaError_t launch_bwd(const BwdArgs& a) {
  const bool wide = a.hd > kD;
  const int n_kt = (a.T + kRows - 1) / kRows;
  const int n_dc = wide ? (a.hd + kD - 1) / kD : 1;
  const long long blocks = static_cast<long long>(a.B) * a.H * n_dc * n_kt;
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  auto* kern = attn_general_bwd_f32<kD>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(kern, bwd32_smem(kD), smem_set);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd32_smem(wide ? kD : round_up(a.hd, 32));
  kern<<<static_cast<unsigned>(blocks), kBwdThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      static_cast<float*>(a.dq_accum), a.H, a.T, a.hd, a.nv, n_kt, n_dc,
      a.scale, a.aligned != 0);
  return cudaGetLastError();
}

}  // namespace

cudaError_t fwd32_launch(const FwdArgs& a) {
  switch (a.d_max) {
    case 64:
      return launch_fwd_mode<64>(a);
    case 128:
      return launch_fwd_mode<128>(a);
    case 256:
      return launch_fwd_mode<256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t bwd32_launch(const BwdArgs& a) {
  switch (a.d_max) {
    case 64:
      return launch_bwd<64>(a);
    case 128:
      return launch_bwd<128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vg_attn
