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
// Sums are float32: the height pass on the tensor cores, the width pass as
// fmaf over the taps in ascending order.
//
// What bounds it on the H100: bytes (each input byte read once, each output
// written once).  160 frames of 405 x 720 -> 224 (bf16 out) read 140 MB
// and write 48 MB: 0.056 ms at 3.35 TB/s.  At 5 frames (1.8 us) a launch
// costs more.
//
// Design (the first one of this kind, one output row a block on the CUDA
// cores, issued ~700K warp instructions a frame and was bound by that, not
// by bytes):
//  * Bands.  A block of 384 threads owns a band of R consecutive output
//    rows of one frame (R and the bands from ops/preprocess.py::plan: at
//    most 8 rows, fewer where the grid would not fill the card, a block
//    would hold more than 113 KB, so that two blocks share an SM, or a band
//    would need more than 32 source rows).  The band's source rows are
//    contiguous in the frame; each comes into shared memory by a bulk
//    async copy (cp.async.bulk) on one mbarrier, so a source byte crosses
//    device memory about once, not once for each of the 2-3 output rows
//    whose filters cover it, while the block stages the tap tables.  (Rows
//    not 16-byte aligned are copied by the threads instead.)  A persistent
//    grid that kept the next band's rows in flight measured no faster, and
//    slower in the exact mode, whose two buffers left room for 4-row
//    bands only (PERF.md).
//  * Strips, for frames whose full-width band does not keep within those
//    limits (1080p and larger to 224; a one-row full-width band of 1080p
//    or 1440p runs slower than the strips on an H100: the `plans` job of
//    scripts/compare_torch_kernels.py times both): a block owns
//    a band of R output rows x a strip of `cols` output columns and
//    stages only the 16-byte aligned span of source bytes that its
//    columns' width taps cover (ops/preprocess.py::
//    strip_plan chooses R and cols to stage the fewest bytes within the
//    shared memory aimed at), so shared memory is bounded by the strip,
//    not by the frame's width.  A band may then need more than two product
//    steps of 16 source rows: the height pass loops over them, its A
//    fragments built once into shared memory (kStrip).  Frames whose
//    full-width plan keeps within its limits (405 x 720, 720 x 1280) keep
//    it and its code: one strip, two steps, fragments in registers.
//  * The height pass is a product on the tensor cores (mma.sync
//    m16n8k16 in fp16, float32 sums): A the band's taps [rows][source rows]
//    (zero off each row's window), B the source bytes.  No conversion
//    unit and no float arithmetic makes B: the half 0x64XX is 1024 + XX,
//    so byte permutes turn four bytes of two rows into four fp16 pairs,
//    and 1024 x a row's tap sum is taken off its float32 result.  A 32-bit
//    shared read feeds four n8 products (its bytes are column g of products
//    0-3), and each source byte is converted once, not once a tap.  The
//    fast mode's taps are bf16 values, exact in fp16; the exact mode's
//    float32 taps are split into two fp16 terms (within 2^-22 of the tap),
//    two products.  The rows stay in shared memory, bf16 in the fast mode
//    (they are rounded to bf16 anyway) and float32 otherwise.
//  * The width pass puts neighbouring threads on neighbouring outputs, so
//    that their reads of the rows and of the taps (kept output-major) fall
//    on distinct banks, and reads an output's taps once for all the band's
//    rows, in registers.  The block size is a multiple of 3, so a thread
//    keeps one channel and steps its column: no division by 3 an output.
//    (As a product on the tensor cores, with its taps as fragments built on
//    the host, it was slower: 86 KB of fragments re-read from L2 by every
//    band.)  The band's output is staged in shared memory over its dead
//    source rows and copied out 16 bytes a thread (element by element
//    where it is not a whole number of 16-byte groups).
//
// Frames already of the output size take preprocess_affine, elementwise.
//
// The entry point has a plain C interface and returns cudaGetLastError().

#include "tma.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

using namespace vg_tma;

constexpr int kThreads = 384;          // a multiple of 3: a thread's channel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_half(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bytes of words lo (source row k) and hi (row k + 1) as four packed
// fp16 pairs (1024 + lo.b_j, 1024 + hi.b_j), j = 0..3: 0x64XX is the half
// 1024 + XX, so a byte permute makes two of them.
__device__ __forceinline__ void byte_halves(uint32_t lo, uint32_t hi,
                                            uint32_t (&b)[4]) {
  const uint32_t t0 = __byte_perm(lo, hi, 0x5140);  // lo.b0 hi.b0 lo.b1 hi.b1
  const uint32_t t1 = __byte_perm(lo, hi, 0x7362);  // lo.b2 hi.b2 lo.b3 hi.b3
  b[0] = __byte_perm(t0, 0x64646464u, 0x4140);
  b[1] = __byte_perm(t0, 0x64646464u, 0x4342);
  b[2] = __byte_perm(t1, 0x64646464u, 0x4140);
  b[3] = __byte_perm(t1, 0x64646464u, 0x4342);
}

// d += a (16x16 f16, row) * b (16x8 f16, col), float32 accumulators.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Shared row stride of a source row of wc bytes (and of a height-pass row,
// in elements): past the last 32-byte chunk, and 16 modulo 32, so that
// the four rows a fragment reads fall on distinct banks.
__host__ __device__ constexpr int row_stride(int wc) {
  return ((wc + 31) & ~31) + 16;
}

// ops/preprocess.py::smem_bytes: the band's source rows of a strip
// (then the block's output, staged for the copy out), the height-pass
// rows, the strip's width taps [cols 3][w_taps] and starts, the height
// taps and starts, the A fragments of a strip plan (strips narrower than
// the row, or bands of more than 32 source rows; [steps][terms][4][32]
// words), a barrier.
__host__ __device__ inline int smem_bytes(int S, int R, int band_rows,
                                          int h_taps, int w_taps, bool bf16,
                                          int cols, int strip_bytes) {
  const int ls = row_stride(strip_bytes), elem = bf16 ? 2 : 4;
  const int src = band_rows * ls;
  const int out = R * cols * 3 * elem;
  const bool strip = cols < S || band_rows > 32;
  const int frags =
      strip ? (band_rows + 15) / 16 * (bf16 ? 1 : 2) * 4 * 32 * 4 : 0;
  return round16(src > out ? src : out) + R * ls * elem +
         3 * cols * w_taps * 4 + cols * 4 + R * h_taps * 4 + R * 4 + frags +
         16;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Grid (bands, B, strips).  bands: int32 [2 nb + 2 nstrips], each
// band's first source row, then its source row count, then each strip's
// first staged byte of a source row and the byte past its last.  w_w
// output-major [S 3][w_taps].  kBulk: W * 3 % 16 == 0 and x 16-byte
// aligned (the strips' bytes are then 16-byte aligned too).  kVec: every
// strip's output row is a whole number of 16-byte groups.  kStrip: a
// strip plan (strips narrower than the row, or bands of more than 32
// source rows): the strip's bytes staged, the product steps looped.
template <bool kFast, bool kBulk, bool kVec, bool kStrip>
__global__ void __launch_bounds__(kThreads)
preprocess_frames(const uint8_t* __restrict__ x, void* __restrict__ out,
                  int H, int W, int S, const int* __restrict__ h_start,
                  const int* __restrict__ w_start,
                  const float* __restrict__ h_w,
                  const float* __restrict__ w_w,
                  const int* __restrict__ bands, int h_taps, int w_taps,
                  int R, int band_rows, int cols, int strip_bytes,
                  float a0, float a1, float a2, float b0, float b1,
                  float b2) {
  using T = typename std::conditional<kFast, __nv_bfloat16, float>::type;
  // the height taps as 1 (fast: they are bf16 values) or 2 fp16 terms
  constexpr int kTerms = kFast ? 1 : 2;
  extern __shared__ __align__(16) uint8_t smem[];
  // without strips every size below follows from W and S alone, at
  // compile time, and `cols` and `strip_bytes` are dead (they hold no
  // registers)
  const int wc = W * 3, row_out = S * 3;
  const int ls = row_stride(kStrip ? strip_bytes : wc);
  const int span = kStrip ? cols : S;    // a block's columns of the tables
  const int band = blockIdx.x, frame = blockIdx.y;
  const int nb = gridDim.x;
  const int r0 = band * R, nr = min(R, S - r0);
  const int src0 = bands[band], nrows = bands[nb + band];
  // the strip: its first output column and columns, the first staged
  // byte of a source row and the bytes staged (the whole row without
  // strips)
  int c0 = 0, nc = S, lo = 0, sb = wc;
  if constexpr (kStrip) {
    const int strip = blockIdx.z, nstrips = gridDim.z;
    c0 = strip * cols;
    nc = min(cols, S - c0);
    lo = bands[2 * nb + strip];
    sb = bands[2 * nb + nstrips + strip] - lo;
  }
  const int seg = nc * 3;
  const int ksteps = (band_rows + 15) / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  uint8_t* src = smem;                   // source rows, then the output
  T* y = reinterpret_cast<T*>(
      smem + round16(max(band_rows * ls, R * span * 3 * (int)sizeof(T))));
  float* ww = reinterpret_cast<float*>(y + R * ls);
  int* ws = reinterpret_cast<int*>(ww + span * 3 * w_taps);
  float* wh = reinterpret_cast<float*>(ws + span);
  int* hs = reinterpret_cast<int*>(wh + R * h_taps);
  uint32_t* frag = reinterpret_cast<uint32_t*>(hs + R);
  const int frag_words = kStrip ? ksteps * kTerms * 4 * 32 : 0;
  const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t bar =
      smem0 + ((static_cast<int>(reinterpret_cast<uint8_t*>(
                                     frag + frag_words) - smem) + 7) & ~7);
  const uint8_t* rows = x + (static_cast<size_t>(frame) * H + src0) * wc + lo;

  if constexpr (kBulk) {
    // one bulk copy a source row, all on one barrier
    if (tid == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect(bar, nrows * sb);
      for (int i = 0; i < nrows; ++i)
        bulk_load(smem0 + i * ls, rows + static_cast<size_t>(i) * wc, sb,
                  bar);
    }
  } else {
    for (int i = tid; i < nrows * sb; i += kThreads) {
      const int row = i / sb, j = i - row * sb;
      // without strips the band's bytes are one run
      src[row * ls + j] = rows[kStrip ? static_cast<size_t>(row) * wc + j
                                      : static_cast<size_t>(i)];
    }
  }
  // the tables, while the band's rows fly
  for (int i = tid; i < seg * w_taps; i += kThreads)
    ww[i] = __ldg(w_w + static_cast<size_t>(c0) * 3 * w_taps + i);
  for (int i = tid; i < nc; i += kThreads) ws[i] = __ldg(w_start + c0 + i);
  for (int i = tid; i < nr * h_taps; i += kThreads)
    wh[i] = __ldg(h_w + static_cast<size_t>(r0) * h_taps + i);
  for (int i = tid; i < nr; i += kThreads)
    hs[i] = __ldg(h_start + r0 + i) - src0;
  __syncthreads();

  // height pass on the tensor cores: y[band rows, columns] = A [rows,
  // source rows] . B [source rows, columns], A the band's taps in fp16
  // (zero off a row's window; rows past nr zero), B the source bytes as
  // the halves 1024 + b; 1024 x the sum of a row's taps is taken off the
  // product after it.  A fragment's entry e of step ks: rows g, g + 8 x
  // source rows 16 ks + 2 tq (+1, +8, +9).
  auto taps2 = [&](int r, int k, float (&w2)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = k + u - (r < nr ? hs[r] : 0);
      w2[u] = (r < nr && t >= 0 && t < h_taps) ? wh[r * h_taps + t] : 0.f;
    }
  };
  uint32_t a[2][kTerms][4];
  float rowsum[2] = {0.f, 0.f};
  if constexpr (!kStrip) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e & 1);
        const int k = 16 * ks + 2 * tq + 8 * (e >> 1);
        float w2[2];
        taps2(r, k, w2);
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          a[ks][term][e] = pack_half(w2[0], w2[1]);
          const float2 used = __half22float2(
              *reinterpret_cast<const __half2*>(&a[ks][term][e]));
          rowsum[e & 1] += used.x + used.y;
          w2[0] -= used.x;
          w2[1] -= used.y;
        }
      }
    // the quad's four threads hold a row's 2 x 16 source rows between them
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rowsum[h] += __shfl_xor_sync(0xffffffffu, rowsum[h], 1);
      rowsum[h] += __shfl_xor_sync(0xffffffffu, rowsum[h], 2);
      rowsum[h] *= 1024.f;
    }
  } else {
    // every step's fragments into shared memory, [ks][term][e][lane]
    for (int i = tid; i < ksteps * 32; i += kThreads) {
      const int ks = i >> 5, ln = i & 31;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float w2[2];
        taps2((ln >> 2) + 8 * (e & 1),
              16 * ks + 2 * (ln & 3) + 8 * (e >> 1), w2);
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          const uint32_t packed = pack_half(w2[0], w2[1]);
          frag[((ks * kTerms + term) * 4 + e) * 32 + ln] = packed;
          const float2 used =
              __half22float2(*reinterpret_cast<const __half2*>(&packed));
          w2[0] -= used.x;
          w2[1] -= used.y;
        }
      }
    }
    // a row's sum of the terms, tap by tap
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      for (int t = 0; r < nr && t < h_taps; ++t) {
        float w = wh[r * h_taps + t];
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          const float used = __half2float(__float2half_rn(w));
          rowsum[h] += used;
          w -= used;
        }
      }
      rowsum[h] *= 1024.f;
    }
    __syncthreads();
  }
  if constexpr (kBulk) mbar_wait(bar, 0);

  // a warp a 32-byte chunk of columns: the thread's word g, whose bytes
  // j are column g of the n8 products j; it ends with the columns 8 tq ..
  // 8 tq + 7 of the chunk for rows g and g + 8
  const int chunks = (sb + 31) / 32;
  for (int ch = warp; ch < chunks; ch += kWarps) {
    const uint8_t* col_base = src + ch * 32 + g * 4;
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
    // rows past the band's own are read from row 0: their taps are 0
    auto word = [&](int row) {
      return *reinterpret_cast<const uint32_t*>(
          col_base + (row < nrows ? row : 0) * ls);
    };
    if constexpr (!kStrip) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ks >= ksteps) break;
        const int k = 16 * ks + 2 * tq;
        uint32_t bl[4], bh[4];
        byte_halves(word(k), word(k + 1), bl);
        byte_halves(word(k + 8), word(k + 9), bh);
#pragma unroll
        for (int term = 0; term < kTerms; ++term)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_f16(d[j], a[ks][term], bl[j], bh[j]);
      }
    } else {
      const int steps = (nrows + 15) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        const int k = 16 * ks + 2 * tq;
        uint32_t bl[4], bh[4];
        byte_halves(word(k), word(k + 1), bl);
        byte_halves(word(k + 8), word(k + 9), bh);
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          uint32_t af[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            af[e] = frag[((ks * kTerms + term) * 4 + e) * 32 + lane];
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_f16(d[j], af, bl[j], bh[j]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r >= nr) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = d[j][2 * h] - rowsum[h];
        v[4 + j] = d[j][2 * h + 1] - rowsum[h];
      }
      T* yo = y + r * ls + ch * 32 + 8 * tq;
      if constexpr (kFast) {
        *reinterpret_cast<uint4*>(yo) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      } else {
        reinterpret_cast<float4*>(yo)[0] =
            make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(yo)[1] =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
  __syncthreads();

  // width pass: neighbouring threads on neighbouring outputs, each
  // output's taps read once for the band's rows (held in registers up to
  // 8); kThreads is a multiple of 3, so a thread keeps its channel
  // c = tid % 3 and steps its column: no division by 3 an output.  The
  // output is staged over this band's source rows, dead now.
  T* staged_out = reinterpret_cast<T*>(src);
  {
    const int c = tid % 3;
    const float a_c = c == 0 ? a0 : (c == 1 ? a1 : a2);
    const float b_c = c == 0 ? b0 : (c == 1 ? b1 : b2);
    for (int o = tid, col = tid / 3; o < seg;
         o += kThreads, col += kThreads / 3) {
      const float* wt = ww + o * w_taps;
      // the staged row's element where the column's taps begin
      const T* yp = y + (ws[col] * 3 - lo) + c;
      float wr[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) wr[t] = t < w_taps ? wt[t] : 0.f;
      for (int r = 0; r < nr; ++r, yp += ls) {
        float acc = 0.f;
        if (w_taps <= 8) {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (t < w_taps) acc = fmaf(wr[t], to_float(yp[3 * t]), acc);
        } else {
#pragma unroll 4
          for (int t = 0; t < w_taps; ++t)
            acc = fmaf(wt[t], to_float(yp[3 * t]), acc);
        }
        if constexpr (kFast)
          staged_out[r * seg + o] =
              __float2bfloat16_rn(round_bf16(acc) + a_c);
        else
          staged_out[r * seg + o] = (acc - a_c) / b_c;
      }
    }
  }
  __syncthreads();

  // the block's output rows: one contiguous run when the strip is the
  // whole row, else a run a row; 16 bytes a thread where they allow it
  T* dst = static_cast<T*>(out) +
           (static_cast<size_t>(frame) * S + r0) * row_out + c0 * 3;
  if (!kStrip || nc == S) {
    if constexpr (kVec) {
      const int n16 = nr * row_out * (int)sizeof(T) / 16;
      for (int i = tid; i < n16; i += kThreads)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(staged_out)[i];
    } else {
      for (int i = tid; i < nr * row_out; i += kThreads)
        dst[i] = staged_out[i];
    }
  } else if constexpr (kVec) {
    const int n16 = seg * (int)sizeof(T) / 16;
    for (int i = tid; i < nr * n16; i += kThreads) {
      const int r = i / n16, j = i - r * n16;
      reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * row_out)[j] =
          reinterpret_cast<const uint4*>(staged_out + r * seg)[j];
    }
  } else {
    for (int i = tid; i < nr * seg; i += kThreads) {
      const int r = i / seg;
      dst[static_cast<size_t>(r) * row_out + (i - r * seg)] = staged_out[i];
    }
  }
}

// The byte b (0..255) as a float, exactly, without the conversion unit:
// the float 2^23 + b less 2^23.
__device__ __forceinline__ float byte_float(uint32_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;
}

// Frames already of the output size: out = (x - a_c) / b_c, float32, four
// pixels (12 bytes in, 48 out) a thread a step, so that each byte's
// channel is its place in the step; bytes past the last whole step one by
// one.
__global__ void __launch_bounds__(256)
preprocess_affine(const uint8_t* __restrict__ x, float* __restrict__ out,
                  long long n, float a0, float a1, float a2, float b0,
                  float b1, float b2) {
  const float a[3] = {a0, a1, a2}, b[3] = {b0, b1, b2};
  const long long steps = n / 12;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < steps;
       i += gridDim.x * 256ll) {
    const uint32_t* in = reinterpret_cast<const uint32_t*>(x + 12 * i);
    const uint32_t w[3] = {__ldg(in), __ldg(in + 1), __ldg(in + 2)};
    float v[12];
#pragma unroll
    for (int e = 0; e < 12; ++e)
      v[e] = (byte_float(__byte_perm(w[e / 4], 0, 0x4440 + e % 4)) -
              a[e % 3]) /
             b[e % 3];
    float4* o = reinterpret_cast<float4*>(out + 12 * i);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
    o[2] = make_float4(v[8], v[9], v[10], v[11]);
  }
  for (long long e = steps * 12 + blockIdx.x * 256ll + threadIdx.x; e < n;
       e += gridDim.x * 256ll)
    out[e] = (byte_float(x[e]) - a[e % 3]) / b[e % 3];
}

template <bool kFast, bool kBulk, bool kVec, bool kStrip>
cudaError_t launch(const dim3 grid, int smem, cudaStream_t st,
                   const uint8_t* x, void* out, int H, int W, int S,
                   const int* starts, const float* wt, const float* w_w,
                   const int* bands, int h_taps, int w_taps, int R,
                   int band_rows, int cols, int strip_bytes,
                   float a0, float a1, float a2, float b0, float b1,
                   float b2) {
  auto* kern = preprocess_frames<kFast, kBulk, kVec, kStrip>;
  static std::atomic<int> raised[64];             // bytes allowed a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && (dev >= 64 || raised[dev].load() < smem)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) {
      int seen = raised[dev].load();
      while (seen < smem && !raised[dev].compare_exchange_weak(seen, smem)) {
      }
    }
  }
  kern<<<grid, kThreads, smem, st>>>(x, out, H, W, S, starts, starts + S, wt,
                                     w_w, bands, h_taps, w_taps, R,
                                     band_rows, cols, strip_bytes, a0, a1,
                                     a2, b0, b1, b2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B, H, W, 3] uint8; out: [B, S, S, 3] bf16 (fast) or float32.
// starts: int32 [2 S] (height windows, then width windows); weights:
// float32 [S h_taps] then [S, 3, w_taps]; bands: int32 [2 nb + 2 nstrips]
// (first source row of each band of R output rows, then its source row
// count, the largest band_rows; then the first and past-the-last staged
// byte of a source row for each strip of `cols` output columns, the
// widest strip_bytes); smem: ops/preprocess.py::smem_bytes.
int preprocess_frames_launch(const void* x, void* out, int B, int H, int W,
                             int S, const void* starts, const void* weights,
                             const void* bands, int h_taps, int w_taps,
                             int R, int nb, int band_rows, int cols,
                             int nstrips, int strip_bytes, int smem,
                             int fast, float a0, float a1, float a2,
                             float b0, float b1, float b2, void* stream) {
  if (B < 1 || B > 65535 || R < 1 || R > 16 || nb != (S + R - 1) / R ||
      cols < 1 || nstrips != (S + cols - 1) / cols || nstrips > 65535 ||
      strip_bytes < 1 ||
      strip_bytes > W * 3 ||
      smem != smem_bytes(S, R, band_rows, h_taps, w_taps, fast != 0, cols,
                         strip_bytes) ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const uint8_t*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == S && W == S && !fast && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const long long n = 3ll * B * S * S;
    const long long blocks = (n / 12 + 255) / 256;
    preprocess_affine<<<static_cast<int>(blocks < 1 ? 1 : blocks), 256, 0,
                        s>>>(xb, static_cast<float*>(out), n, a0, a1, a2,
                             b0, b1, b2);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(nb, B, nstrips);
  const int* st = static_cast<const int*>(starts);
  const float* wt = static_cast<const float*>(weights);
  const float* w_w = wt + static_cast<size_t>(S) * h_taps;
  const int* bd = static_cast<const int*>(bands);
  const int elem = fast ? 2 : 4;
  const bool bulk =
      (W * 3) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec = (S * 3 * elem) % 16 == 0 && (cols * 3 * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool strip = nstrips > 1 || band_rows > 32;
  using Fn = cudaError_t (*)(const dim3, int, cudaStream_t, const uint8_t*,
                             void*, int, int, int, const int*, const float*,
                             const float*, const int*, int, int, int, int,
                             int, int, float, float, float, float, float,
                             float);
  static const Fn table[16] = {
      launch<false, false, false, false>, launch<false, false, false, true>,
      launch<false, false, true, false>,  launch<false, false, true, true>,
      launch<false, true, false, false>,  launch<false, true, false, true>,
      launch<false, true, true, false>,   launch<false, true, true, true>,
      launch<true, false, false, false>,  launch<true, false, false, true>,
      launch<true, false, true, false>,   launch<true, false, true, true>,
      launch<true, true, false, false>,   launch<true, true, false, true>,
      launch<true, true, true, false>,    launch<true, true, true, true>};
  const Fn go = table[(fast ? 8 : 0) + (bulk ? 4 : 0) + (vec ? 2 : 0) +
                      (strip ? 1 : 0)];
  return static_cast<int>(go(grid, smem, s, xb, out, H, W, S, st, wt, w_w,
                             bd, h_taps, w_taps, R, band_rows, cols,
                             strip_bytes, a0, a1, a2, b0, b1, b2));
}

}  // extern "C"
