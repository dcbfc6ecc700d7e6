// Frame preprocessing for Hopper (sm_90a): uint8 frames -> separable
// antialiased resize -> CLIP affine, in one launch.
//
// Replaces vidgraph_tpu/ops/preprocess.py::_normalize_kernel (the Pallas
// uint8 -> x / (255 std_c) - mean_c / std_c kernel) together with the XLA
// resize that serving runs around it (preprocess_frames, fast and exact).
// For x [B, H, W, 3] uint8 contiguous and out [B, S, S, 3]:
//
//   y[r, j]   = sum_t wh[r, t] x[hs[r] + t, j]           (j = column*3 + c)
//   out[r, o] = affine_c(sum_t ww[c, o, t] y[ws[o] + t, c])
//
// with the start offsets hs, ws and the tap weights wh, ww from host tables
// (ops/preprocess.py::_host_tables).  Two modes:
//   fast (bf16 out): y is rounded to bf16; the width sum (whose weights
//     carry 1 / (255 std_c)) is rounded to bf16, then the bf16 bias a_c is
//     added and the sum rounded to bf16 -- the plain version's roundings;
//   float32: out = (sum - a_c) / b_c with a = 255 mean, b = 255 std; the
//     same-size case is the 1-tap identity table.
// Sums are float32 fmaf over the taps in ascending order.
//
// What bounds it on the H100: bytes (each input byte read once, each output
// written once).  At 5 frames of 405 x 720 -> 224 (bf16 out) that is
// 4.37 MB + 1.51 MB, 1.8 us at 3.35 TB/s: the launch costs more.
//
// Design: one block of 128 threads per (output row, frame), so that the
// 1,120 blocks of 5 frames fit the card in one wave.  The height pass reads
// the filter's few source rows, four bytes a thread a load (uchar4) with
// neighbouring threads on neighbouring words, and keeps the result, one
// float per source column and channel, in shared memory (W * 12 bytes);
// the width pass reads its taps from there and writes the output row with
// neighbouring threads on neighbouring elements.  Both passes issue the
// loads of up to 8 taps before their multiply-adds.  A source row is read
// by the 2-3 blocks whose filters cover it, from L2 after the first.
//
// Later work (not here): several output rows a block, patchify fused into
// the store.  The entry point has a plain C interface and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;            // taps whose loads are issued together
constexpr int kMaxSmem = 48 * 1024;   // no opt-in: W * 3 floats <= 48 KB

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The height pass of one output row into row[0, W * 3): four source bytes
// a thread a step (uchar4 loads) when the row length allows it.
template <bool kFast, bool kVec4>
__device__ __forceinline__ void height_pass(const uint8_t* __restrict__ src,
                                            const float* __restrict__ wh,
                                            int taps, int wc, float* row) {
  constexpr int kVec = kVec4 ? 4 : 1;
  for (int j = threadIdx.x * kVec; j < wc; j += kThreads * kVec) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < taps; t0 += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u;
        if (t < taps) {
          const float w = __ldg(wh + t);
          const uint8_t* p = src + static_cast<size_t>(t) * wc + j;
          if constexpr (kVec4) {
            const uchar4 v = __ldg(reinterpret_cast<const uchar4*>(p));
            acc[0] = fmaf(w, static_cast<float>(v.x), acc[0]);
            acc[1] = fmaf(w, static_cast<float>(v.y), acc[1]);
            acc[2] = fmaf(w, static_cast<float>(v.z), acc[2]);
            acc[3] = fmaf(w, static_cast<float>(v.w), acc[3]);
          } else {
            acc[0] = fmaf(w, static_cast<float>(__ldg(p)), acc[0]);
          }
        }
      }
    }
    if constexpr (kFast) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = round_bf16(acc[e]);
    }
    if constexpr (kVec4) {
      *reinterpret_cast<float4*>(row + j) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      row[j] = acc[0];
    }
  }
}

template <bool kFast, bool kVec4>
__global__ void __launch_bounds__(kThreads)
preprocess_frames(const uint8_t* __restrict__ x, void* __restrict__ out,
                  int H, int W, int S, const int* __restrict__ h_start,
                  const int* __restrict__ w_start,
                  const float* __restrict__ h_w,
                  const float* __restrict__ w_w, int h_taps, int w_taps,
                  float a0, float a1, float a2, float b0, float b1,
                  float b2) {
  extern __shared__ __align__(16) float row[];    // [W * 3]
  const int r = blockIdx.x, frame = blockIdx.y;
  const int wc = W * 3;
  const uint8_t* src =
      x + (static_cast<size_t>(frame) * H + __ldg(h_start + r)) * wc;
  height_pass<kFast, kVec4>(src, h_w + static_cast<size_t>(r) * h_taps,
                            h_taps, wc, row);
  __syncthreads();

  const size_t obase = (static_cast<size_t>(frame) * S + r) * S * 3;
  for (int o = threadIdx.x; o < S * 3; o += kThreads) {
    const int col = o / 3, c = o - col * 3;
    const float* ww = w_w + (static_cast<size_t>(c) * S + col) * w_taps;
    const float* y = row + __ldg(w_start + col) * 3 + c;
    float acc = 0.f;
    for (int t0 = 0; t0 < w_taps; t0 += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u;
        if (t < w_taps) acc = fmaf(__ldg(ww + t), y[t * 3], acc);
      }
    }
    const float a = c == 0 ? a0 : (c == 1 ? a1 : a2);
    if (kFast) {
      static_cast<__nv_bfloat16*>(out)[obase + o] =
          __float2bfloat16_rn(round_bf16(acc) + a);
    } else {
      const float b = c == 0 ? b0 : (c == 1 ? b1 : b2);
      static_cast<float*>(out)[obase + o] = (acc - a) / b;
    }
  }
}

template <bool kFast, bool kVec4>
void launch(const dim3 grid, size_t smem, cudaStream_t s, const void* x,
            void* out, int H, int W, int S, const int* st, const float* wt,
            const float* w_w, int h_taps, int w_taps, float a0, float a1,
            float a2, float b0, float b1, float b2) {
  preprocess_frames<kFast, kVec4><<<grid, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(x), out, H, W, S, st, st + S, wt, w_w,
      h_taps, w_taps, a0, a1, a2, b0, b1, b2);
}

}  // namespace

extern "C" {

int preprocess_max_smem() { return kMaxSmem; }

// x: [B, H, W, 3] uint8; out: [B, S, S, 3] bf16 (fast) or float32.
// starts: int32 [2 S] (height windows, then width windows); weights:
// float32 [S h_taps] then [3, S, w_taps].
int preprocess_frames_launch(const void* x, void* out, int B, int H, int W,
                             int S, const void* starts, const void* weights,
                             int h_taps, int w_taps, int fast, float a0,
                             float a1, float a2, float b0, float b1,
                             float b2, void* stream) {
  const dim3 grid(S, B);
  const size_t smem = static_cast<size_t>(W) * 3 * sizeof(float);
  const int* st = static_cast<const int*>(starts);
  const float* wt = static_cast<const float*>(weights);
  const float* w_w = wt + static_cast<size_t>(S) * h_taps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // uchar4 loads need every source row to start on 4 bytes
  const bool vec4 = (W * 3) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 4 == 0;
  auto go = fast ? (vec4 ? launch<true, true> : launch<true, false>)
                 : (vec4 ? launch<false, true> : launch<false, false>);
  go(grid, smem, s, x, out, H, W, S, st, wt, w_w, h_taps, w_taps, a0, a1,
     a2, b0, b1, b2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
