// Fused pair prep: per (scene, pair) union-bbox crop, cv2 INTER_CUBIC
// RGB resize, uint8 round/clip, ImageNet normalisation, and (5-channel
// mode) INTER_NEAREST resize of both instance masks, written as NHWC
// bf16 or (`out_f32`) f32: (S*P, out, out, 5) with channels [mask_i,
// mask_j, R, G, B], or (S*P, out, out, 3) RGB only.
//
// Replaces two TPU kernels of instaorder_tpu/ops/prep_pallas.py:
// `fused_prep_pairs` (kernel body `_prep5_kernel`, 5 channels) and
// `fused_prep_rgb` (`_prep_rgb_kernel`, RGB only, normalisation on or
// off). The TPU kernels contract dense interpolation windows on the
// MXU; here the resize runs as its two separable tap passes (the tap
// form of ops/pairs._cubic_taps, whose weights equal the dense matrix
// entries bit for bit: taps clamped to the crop window, clamped taps'
// mass merged onto the border column, source columns outside the image
// read as zero).
//
// Bound on the H100: memory. Per pair it writes 5 (or 3) * out*out bf16
// (640 KB at out=256; 1.25 MB in f32) and does ~100 flops per output
// pixel, far below the 295 flop/byte ridge; the scene's image and masks
// are read from L2 (each scene is shared by its P pairs, and the blocks
// of one scene run together: the block index is pair-major). What costs
// on the card is the L1 traffic of the tap reads, the instructions of
// the two passes and the stores; the design:
//
//   block      one (pair, band of `band` output rows, tile of up to 256
//              output columns), one thread an output column, 4 blocks
//              an SM (at most 64 registers);
//   tables     the band's y taps (tap start, 4 source rows, 4 weights,
//              the nearest row) are computed once per block into shared
//              memory, and so is a table of the output value of each
//              uint8 result; each thread computes its column's x taps
//              once, in registers;
//   stage 1    the horizontal sum of source row r at the thread's column
//              depends only on the unclamped tap index t (its row is
//              clamp(clamp(t, 0, chigh) + off, 0, H - 1)), and the tap
//              start y0 is non-decreasing in the output row. So each
//              thread keeps a ring of four stage-1 values in registers,
//              slot a holding t = y0 - 1 + a: an output row whose y0
//              moved by d shifts the ring by d and computes only its
//              last min(d, 4) taps (straight-line code for each d, so
//              the loads of two new taps are in flight together). A band
//              computes about band * crop/out + 3 stage-1 rows, not
//              4 * band (the same 4 a row when the crop is above 4 * out);
//   tap reads  a column's 4 x taps away from a clamp are 4 adjacent
//              pixels, 48 contiguous bytes: read as the four aligned
//              16-byte loads that cover them, the 12 values picked by the
//              word offset; a column at a clamp reads its taps one by one.
//              (Staging each source-row segment in shared memory by
//              cp.async, a 4-slot ring with a barrier per stage-1 row,
//              was slower on the H100: 12 shared loads a tap window and
//              the barriers cost more than the L1 hits they replace);
//   epilogue   the mask reads are issued before the tap reads; RGB is
//              rounded and clipped by one saturating conversion and
//              mapped through the table;
//   stores     each output row goes to a shared-memory stage laid out
//              as `out` is, placed at the destination's offset mod 16
//              bytes; every `group` rows the block writes the stage's
//              contiguous range of `out` with 16-byte stores (one range
//              per row when the columns are split into tiles). The
//              stage's byte budget is the same for both output types,
//              so an f32 group holds half the rows of a bf16 one and
//              the shared memory a block takes (and so the 4 blocks an
//              SM) does not change with the type.
//
// Numerics (build with -fmad=false: a contracted FMA would move a
// weight by one ulp and can flip a bf16 rounding at passes=1):
//   passes=3  weights and the stage-1 row values stay f32;
//   passes=1  weights and the stage-1 row values are rounded to bf16
//             (round to nearest even) before they are multiplied, with
//             f32 accumulation — the 1-pass bf16 dot of prep_pallas._dot3.
// Both sums run in tap order from 0, each product rounded before it is
// added. Output: round half to even, clip to 0..255, then (v/255 -
// mean)/std (or the integer itself with normalisation off), bf16, the
// same expressions evaluated once per value 0..255, stored as bf16 (round
// to nearest even) or as the f32 value itself. The masks are exactly 0
// or 1 in either type. The ring changes how often a stage-1 value is
// computed, not its arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 256;      // output columns of a block
constexpr int kMaxBand = 64;        // most output rows of a block
constexpr int kStageBytes = 20480;  // output stage budget (group rows)
constexpr int kMinBlocks = 4;       // resident blocks an SM (<= 64 registers)

__device__ __forceinline__ float cubic(float t) {
  // OpenCV bicubic, A = -0.75, the same expression tree as
  // ops/resize._cubic_kernel.
  const float at = fabsf(t);
  if (at <= 1.0f) return ((1.25f * at - 2.25f) * at) * at + 1.0f;
  if (at < 2.0f) return ((-0.75f * at - (-3.75f)) * at + (-6.0f)) * at - (-3.0f);
  return 0.0f;
}

__device__ __forceinline__ float to_bf16_f(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// An output value in the output type T (bf16 rounded to nearest even, or
// f32 unchanged), and the elements of T in 16 bytes.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <typename T>
struct Vec {
  static constexpr int n = 16 / (int)sizeof(T);
};

// Four merged cubic taps of output index d along one axis: the tap
// start x0 (the unclamped index of tap 1), source indices (clamped into
// the image) and weights (zero for a duplicate column or a column
// outside the image).
__device__ __forceinline__ void cubic_taps(float d, float off, float size,
                                           int out_size, int src_size,
                                           int passes, int idx[4],
                                           float w[4], int* start) {
  const float f = (d + 0.5f) * size / (float)out_size - 0.5f;
  const float x0 = floorf(f);
  const float frac = f - x0;
  const float hi_lim = size - 1.0f;
  const float chigh = floorf(hi_lim);
  float w4[4], tap[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float kf = (float)(k - 1);
    w4[k] = cubic(kf - frac);
    tap[k] = x0 + kf;
  }
  float low = 0.0f, high = 0.0f;
  {
    float l[4], h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      l[k] = w4[k] * (tap[k] < 0.0f ? 1.0f : 0.0f);
      h[k] = w4[k] * (tap[k] > hi_lim ? 1.0f : 0.0f);
    }
    low = ((l[0] + l[1]) + l[2]) + l[3];
    high = ((h[0] + h[1]) + h[2]) + h[3];
  }
  float prev_c = -1.0e30f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float c = fminf(fmaxf(tap[k], 0.0f), chigh);
    const bool inwin = (c >= 0.0f) && (c <= hi_lim);
    const float m = cubic((c - x0) - frac) * (inwin ? 1.0f : 0.0f);
    float e = (m + low * (c == 0.0f ? 1.0f : 0.0f)) +
              high * (c == chigh ? 1.0f : 0.0f);
    const float src = c + off;
    const bool valid = (src >= 0.0f) && (src <= (float)(src_size - 1));
    if (c == prev_c || !valid) e = 0.0f;
    prev_c = c;
    if (passes == 1) e = to_bf16_f(e);
    w[k] = e;
    idx[k] = (int)fminf(fmaxf(src, 0.0f), (float)(src_size - 1));
  }
  *start = (int)x0;
}

__device__ __forceinline__ void nearest_tap(float d, float off, float size,
                                            int out_size, int src_size,
                                            int* idx, bool* valid) {
  float t = floorf(d * size / (float)out_size);
  t = fminf(fmaxf(t, 0.0f), size - 1.0f);
  const float src = t + off;
  *valid = (src >= 0.0f) && (src <= (float)(src_size - 1));
  *idx = (int)fminf(fmaxf(src, 0.0f), (float)(src_size - 1));
}

// One output row's y taps, computed once per block (48 bytes: three
// 16-byte shared loads).
struct __align__(16) RowTaps {
  float wy[4];   // merged weights
  int ry[4];     // source rows
  int y0;        // unclamped index of tap 1
  int ny;        // nearest source row (masks)
  int vy;        // nearest row inside the image
  int pad;
};

// Stage 1: the horizontal sum of source row r at one column, in tap
// order from 0 (bf16-rounded at passes=1). base_w is the word index of
// the scene's image in `images`, vec whether the column's taps are 4
// adjacent pixels and `images` is 16-byte aligned, limit the words in
// `images` (a 16-byte load must end inside it).
__device__ __forceinline__ void stage1(const float* __restrict__ images,
                                       int64_t base_w, int W, int r,
                                       bool vec, int64_t limit,
                                       const int cx[4], const float wx[4],
                                       int passes, float s[3]) {
  const int64_t row_w = base_w + (int64_t)r * W * 3;
  float v[12];
  bool done = false;
  if (vec) {
    const int64_t w0 = row_w + (int64_t)cx[0] * 3;
    const int64_t a = w0 & ~(int64_t)3;
    if (a + 16 <= limit) {
      const float4* q = reinterpret_cast<const float4*>(images + a);
      const float4 f0 = __ldg(q), f1 = __ldg(q + 1), f2 = __ldg(q + 2),
                   f3 = __ldg(q + 3);
      const float f[16] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w,
                           f2.x, f2.y, f2.z, f2.w, f3.x, f3.y, f3.z, f3.w};
      // the 12 words from word offset w0 - a (0..3), in two select steps
      const int off = (int)(w0 - a);
      float g[13];
#pragma unroll
      for (int k = 0; k < 13; ++k) g[k] = (off & 2) ? f[k + 2] : f[k];
#pragma unroll
      for (int k = 0; k < 12; ++k) v[k] = (off & 1) ? g[k + 1] : g[k];
      done = true;
    }
  }
  if (!done) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[3 * k + c] = __ldg(images + row_w + (int64_t)cx[k] * 3 + c);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = acc + wx[k] * v[3 * k + c];
    s[c] = passes == 1 ? to_bf16_f(acc) : acc;
  }
}

// dst's offset mod 16 bytes, in elements of T (0..Vec<T>::n - 1).
template <typename T>
__device__ __forceinline__ int pad_of(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) &
               (Vec<T>::n - 1));
}

// Copy n values of T from the stage to `out`; src sits at dst's offset
// mod 16 bytes, so after a short head (at most Vec<T>::n - 1 values: 7 in
// bf16, 3 in f32) both are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void flush(const T* src, T* dst, int n) {
  constexpr int kV = Vec<T>::n;
  const int head = min((kV - pad_of(dst)) & (kV - 1), n);
  const int nv = (n - head) / kV;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
  for (int i = head + nv * kV + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

template <bool kMasks, typename T>
__global__ void __launch_bounds__(kTileCols, kMinBlocks)
prep_pairs_kernel(const float* __restrict__ images,     // (S, H, W, 3)
                  const uint8_t* __restrict__ masks,    // (S, N, H, W)
                  const int* __restrict__ pair_idx,     // (P, 2)
                  const float* __restrict__ rois,       // (S*P, 4)
                  T* __restrict__ out,                  // (S*P, O, O, C)
                  int S, int P, int N, int H, int W, int O, int passes,
                  int normalize, int band, int nbands, int ntiles,
                  int group, int row_elems) {
  constexpr int kC = kMasks ? 5 : 3;    // output channels
  constexpr int kRgb = kMasks ? 2 : 0;  // first RGB channel
  extern __shared__ __align__(16) unsigned char stage_raw[];
  T* stage = reinterpret_cast<T*>(stage_raw);
  __shared__ RowTaps rows[kMaxBand];
  __shared__ T lut[3][256];             // uint8 value -> output channel

  // pair-major block order: the blocks of one scene run together
  int b = blockIdx.x;
  const int tile = b % ntiles;
  b /= ntiles;
  const int pp = b / nbands;            // scene * P + pair
  const int i0 = (b - pp * nbands) * band;
  const int s = pp / P;
  const int p = pp - s * P;
  const int nrows = min(band, O - i0);
  const int j0 = tile * kTileCols;
  const int ncols = min(kTileCols, O - j0);
  const float ox = rois[pp * 4 + 0];
  const float oy = rois[pp * 4 + 1];
  const float szx = rois[pp * 4 + 2];
  const float szy = rois[pp * 4 + 3];

  // ---- tables, once per block -------------------------------------------
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    RowTaps t;
    cubic_taps((float)(i0 + r), oy, szy, O, H, passes, t.ry, t.wy, &t.y0);
    t.ny = 0;
    t.vy = 0;
    t.pad = 0;
    if (kMasks) {
      bool vy;
      nearest_tap((float)(i0 + r), oy, szy, O, H, &t.ny, &vy);
      t.vy = vy;
    }
    rows[r] = t;
  }
  for (int q = threadIdx.x; q < 256; q += blockDim.x) {
    const float mean[3] = {0.485f, 0.456f, 0.406f};
    const float stdv[3] = {0.229f, 0.224f, 0.225f};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      lut[c][q] = from_f32<T>(
          normalize ? ((float)q / 255.0f - mean[c]) / stdv[c] : (float)q);
  }
  const int jl = threadIdx.x;
  const bool live = jl < ncols;
  int cx[4], x0;
  float wx[4];
  cubic_taps((float)(j0 + (live ? jl : 0)), ox, szx, O, W, passes, cx, wx,
             &x0);
  int nx = 0;
  bool vx = false;
  if (kMasks) nearest_tap((float)(j0 + jl), ox, szx, O, W, &nx, &vx);
  const bool vec = cx[3] == cx[0] + 3 &&
                   (reinterpret_cast<uintptr_t>(images) & 15) == 0;
  const int64_t base_w = (int64_t)s * H * W * 3;
  const int64_t limit = (int64_t)S * H * W * 3;
  const uint8_t* mi = nullptr;
  const uint8_t* mj = nullptr;
  if (kMasks) {
    mi = masks + ((int64_t)s * N + pair_idx[2 * p]) * H * W;
    mj = masks + ((int64_t)s * N + pair_idx[2 * p + 1]) * H * W;
  }
  const bool whole = ntiles == 1;       // the band is one range of out
  __syncthreads();

  float ring[4][3];                     // slot a: stage 1 of t = y0 - 1 + a
  int cur = 0;
#define PREP_STEP(K)                                                      \
  stage1(images, base_w, W, t.ry[K], vec, limit, cx, wx, passes, ring[K]);
#define PREP_MOVE(A, B)                                                   \
  {                                                                       \
    ring[A][0] = ring[B][0];                                              \
    ring[A][1] = ring[B][1];                                              \
    ring[A][2] = ring[B][2];                                              \
  }
  for (int r0 = 0; r0 < nrows; r0 += group) {
    const int gn = min(group, nrows - r0);
    T* dst0 = out + (((int64_t)pp * O + i0 + r0) * O + j0) * kC;
    if (live) {
      for (int rr = 0; rr < gn; ++rr) {
        const RowTaps t = rows[r0 + rr];
        uint8_t m0 = 0, m1 = 0;
        if (kMasks && vx && t.vy) {       // issued before the tap reads
          const int64_t moff = (int64_t)t.ny * W + nx;
          m0 = __ldg(mi + moff);
          m1 = __ldg(mj + moff);
        }
        // the ring moves by the tap start's move: the last min(move, 4)
        // taps are new (all 4 on the band's first row)
        const int adv = (r0 + rr == 0) ? 4 : t.y0 - cur;
        cur = t.y0;
        switch (adv) {
          case 0:
            break;
          case 1:
            PREP_MOVE(0, 1) PREP_MOVE(1, 2) PREP_MOVE(2, 3) PREP_STEP(3)
            break;
          case 2:
            PREP_MOVE(0, 2) PREP_MOVE(1, 3) PREP_STEP(2) PREP_STEP(3)
            break;
          case 3:
            PREP_MOVE(0, 3) PREP_STEP(1) PREP_STEP(2) PREP_STEP(3)
            break;
          default:
            PREP_STEP(0) PREP_STEP(1) PREP_STEP(2) PREP_STEP(3)
            break;
        }
        float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[c] = acc[c] + t.wy[a] * ring[a][c];
        T* o = whole ? stage + pad_of(dst0) + (rr * O + jl) * kC
                     : stage + rr * row_elems +
                           pad_of(dst0 + (int64_t)rr * O * kC) + jl * kC;
        if (kMasks) {
          o[0] = from_f32<T>((float)m0);
          o[1] = from_f32<T>((float)m1);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          // rintf and the clip to 0..255 as one saturating conversion
          const int q = min(max(__float2int_rn(acc[c]), 0), 255);
          o[kRgb + c] = lut[c][q];
        }
      }
    }
    __syncthreads();
    if (whole) {
      flush(stage + pad_of(dst0), dst0, gn * O * kC);
    } else {
      for (int rr = 0; rr < gn; ++rr) {
        T* d = dst0 + (int64_t)rr * O * kC;
        flush(stage + rr * row_elems + pad_of(d), d, ncols * kC);
      }
    }
    __syncthreads();
  }
#undef PREP_STEP
#undef PREP_MOVE
}

// Launch geometry shared by every mode; returns a CUDA error code.
template <bool kMasks, typename T>
int launch(const float* images, const uint8_t* masks, const int* pair_idx,
           const float* rois, T* out, int S, int P, int N, int H, int W,
           int O, int passes, int normalize, int band, cudaStream_t stream) {
  constexpr int kC = kMasks ? 5 : 3;
  constexpr int kV = Vec<T>::n;
  if (band < 1 || band > kMaxBand || O < 1) return (int)cudaErrorInvalidValue;
  const int threads = min(kTileCols, (O + 31) / 32 * 32);
  const int ntiles = (O + kTileCols - 1) / kTileCols;
  const int nbands = (O + band - 1) / band;
  // a stage row: the whole output row (+ room for the 16-byte offset of
  // the group's range), or one tile's row with its own offset room; a
  // tile row is a whole number of 16-byte words, so each row's offset
  // room starts 16-byte aligned
  const int row_elems = ntiles == 1 ? O * kC
                                    : (kTileCols * kC + kV - 1) / kV * kV +
                                          kV;
  const int group =
      max(1, min(band, kStageBytes / (row_elems * (int)sizeof(T))));
  const size_t smem = ((size_t)group * row_elems + kV) * sizeof(T);
  const int64_t blocks = (int64_t)S * P * nbands * ntiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  prep_pairs_kernel<kMasks, T><<<(unsigned)blocks, threads, smem, stream>>>(
      images, masks, pair_idx, rois, out, S, P, N, H, W, O, passes,
      normalize, band, nbands, ntiles, group, row_elems);
  return (int)cudaGetLastError();
}

}  // namespace

// 5 channels: (S*P, out, out, 5) bf16, or f32 with out_f32.
extern "C" int io_prep_pairs(const void* images, const void* masks,
                             const void* pair_idx, const void* rois,
                             void* out, int S, int P, int N, int H, int W,
                             int out_size, int passes, int band,
                             int out_f32, void* stream) {
  if (out_f32)
    return launch<true, float>((const float*)images, (const uint8_t*)masks,
                               (const int*)pair_idx, (const float*)rois,
                               (float*)out, S, P, N, H, W, out_size, passes,
                               1, band, (cudaStream_t)stream);
  return launch<true, __nv_bfloat16>(
      (const float*)images, (const uint8_t*)masks, (const int*)pair_idx,
      (const float*)rois, (__nv_bfloat16*)out, S, P, N, H, W, out_size,
      passes, 1, band, (cudaStream_t)stream);
}

// RGB only: (S*P, out, out, 3) bf16, or f32 with out_f32, normalised or
// raw 0..255.
extern "C" int io_prep_rgb(const void* images, const void* rois, void* out,
                           int S, int P, int H, int W, int out_size,
                           int passes, int normalize, int band, int out_f32,
                           void* stream) {
  if (out_f32)
    return launch<false, float>(
        (const float*)images, nullptr, nullptr, (const float*)rois,
        (float*)out, S, P, 0, H, W, out_size, passes, normalize, band,
        (cudaStream_t)stream);
  return launch<false, __nv_bfloat16>(
      (const float*)images, nullptr, nullptr, (const float*)rois,
      (__nv_bfloat16*)out, S, P, 0, H, W, out_size, passes, normalize, band,
      (cudaStream_t)stream);
}
