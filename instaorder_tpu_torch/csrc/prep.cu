// Fused pair prep: per (scene, pair) union-bbox crop, cv2 INTER_CUBIC
// RGB resize, uint8 round/clip, ImageNet normalisation, and (5-channel
// mode) INTER_NEAREST resize of both instance masks, written as NHWC
// bf16: (S*P, out, out, 5) with channels [mask_i, mask_j, R, G, B], or
// (S*P, out, out, 3) RGB only.
//
// Replaces two TPU kernels of instaorder_tpu/ops/prep_pallas.py:
// `fused_prep_pairs` (kernel body `_prep5_kernel`, 5 channels) and
// `fused_prep_rgb` (`_prep_rgb_kernel`, RGB only, normalisation on or
// off). The TPU kernels contract dense
// interpolation windows on the MXU; here every output pixel reads its
// 4x4 cubic taps directly (the tap form of ops/pairs._cubic_taps, whose
// weights equal the dense matrix entries bit for bit: taps clamped to
// the crop window, clamped taps' mass merged onto the border column,
// source columns outside the image read as zero).
//
// Bound on the H100: memory. Per pair it writes 5 (or 3) * out*out bf16
// (640 KB at out=256) and does ~100 flops per output pixel, far below the
// 295 flop/byte ridge; the scene's image and masks are read from L2
// (each scene is shared by its P pairs). Design: one block per (pair,
// tile of output rows); each thread owns output columns, computes its
// x taps once in registers and streams its rows, so nothing but the
// output touches device memory twice.
//
// Numerics (build with -fmad=false: a contracted FMA would move a
// weight by one ulp and can flip a bf16 rounding at passes=1):
//   passes=3  weights and the stage-1 row values stay f32;
//   passes=1  weights and the stage-1 row values are rounded to bf16
//             (round to nearest even) before they are multiplied, with
//             f32 accumulation — the 1-pass bf16 dot of prep_pallas._dot3.
// Output: round half to even, clip to 0..255, then (v/255 - mean)/std
// (or the integer itself with normalisation off), bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 256;

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

// Four merged cubic taps of output index d along one axis: source
// indices (clamped into the image) and weights (zero for a duplicate
// column or a column outside the image).
__device__ __forceinline__ void cubic_taps(float d, float off, float size,
                                           int out_size, int src_size,
                                           int passes, int idx[4],
                                           float w[4]) {
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

template <bool kMasks>
__global__ void __launch_bounds__(kThreads)
prep_pairs_kernel(const float* __restrict__ images,     // (S, H, W, 3)
                  const uint8_t* __restrict__ masks,    // (S, N, H, W)
                  const int* __restrict__ pair_idx,     // (P, 2)
                  const float* __restrict__ rois,       // (S*P, 4)
                  __nv_bfloat16* __restrict__ out,      // (S*P, O, O, C)
                  int P, int N, int H, int W, int O, int passes,
                  int normalize) {
  constexpr int kC = kMasks ? 5 : 3;    // output channels
  constexpr int kRgb = kMasks ? 2 : 0;  // first RGB channel
  const int pp = blockIdx.x;            // scene * P + pair
  const int s = pp / P;
  const int p = pp - s * P;
  const float ox = rois[pp * 4 + 0];
  const float oy = rois[pp * 4 + 1];
  const float szx = rois[pp * 4 + 2];
  const float szy = rois[pp * 4 + 3];
  const float* img = images + (int64_t)s * H * W * 3;
  const uint8_t* mi = nullptr;
  const uint8_t* mj = nullptr;
  if (kMasks) {
    mi = masks + ((int64_t)s * N + pair_idx[2 * p]) * H * W;
    mj = masks + ((int64_t)s * N + pair_idx[2 * p + 1]) * H * W;
  }
  const float mean[3] = {0.485f, 0.456f, 0.406f};
  const float stdv[3] = {0.229f, 0.224f, 0.225f};
  const int i0 = blockIdx.y * kRowsPerBlock;
  const int i1 = min(i0 + kRowsPerBlock, O);

  for (int j = threadIdx.x; j < O; j += blockDim.x) {
    int cx[4];
    float wx[4];
    cubic_taps((float)j, ox, szx, O, W, passes, cx, wx);
    int nx = 0;
    bool vx = false;
    if (kMasks) nearest_tap((float)j, ox, szx, O, W, &nx, &vx);
    for (int i = i0; i < i1; ++i) {
      int ry[4];
      float wy[4];
      cubic_taps((float)i, oy, szy, O, H, passes, ry, wy);
      float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* row = img + (int64_t)ry[a] * W * 3;
        float s1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float* px = row + cx[b] * 3;
#pragma unroll
          for (int c = 0; c < 3; ++c) s1[c] = s1[c] + wx[b] * __ldg(px + c);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = passes == 1 ? to_bf16_f(s1[c]) : s1[c];
          acc[c] = acc[c] + wy[a] * v;
        }
      }
      __nv_bfloat16* o = out + (((int64_t)pp * O + i) * O + j) * kC;
      if (kMasks) {
        int ny;
        bool vy;
        nearest_tap((float)i, oy, szy, O, H, &ny, &vy);
        const bool mv = vx && vy;
        const int64_t moff = (int64_t)ny * W + nx;
        o[0] = __float2bfloat16_rn(mv ? (float)__ldg(mi + moff) : 0.0f);
        o[1] = __float2bfloat16_rn(mv ? (float)__ldg(mj + moff) : 0.0f);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float q = fminf(fmaxf(rintf(acc[c]), 0.0f), 255.0f);
        o[kRgb + c] = __float2bfloat16_rn(
            normalize ? (q / 255.0f - mean[c]) / stdv[c] : q);
      }
    }
  }
}

}  // namespace

extern "C" int io_prep_pairs(const void* images, const void* masks,
                             const void* pair_idx, const void* rois,
                             void* out, int S, int P, int N, int H, int W,
                             int out_size, int passes, void* stream) {
  dim3 grid(S * P, (out_size + kRowsPerBlock - 1) / kRowsPerBlock);
  prep_pairs_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)images, (const uint8_t*)masks, (const int*)pair_idx,
      (const float*)rois, (__nv_bfloat16*)out, P, N, H, W, out_size, passes,
      1);
  return (int)cudaGetLastError();
}

// RGB only: (S*P, out, out, 3) bf16, normalised or raw 0..255.
extern "C" int io_prep_rgb(const void* images, const void* rois, void* out,
                           int S, int P, int H, int W, int out_size,
                           int passes, int normalize, void* stream) {
  dim3 grid(S * P, (out_size + kRowsPerBlock - 1) / kRowsPerBlock);
  prep_pairs_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)images, nullptr, nullptr, (const float*)rois,
      (__nv_bfloat16*)out, P, 0, H, W, out_size, passes, normalize);
  return (int)cudaGetLastError();
}
