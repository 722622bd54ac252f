// int8c ("fully quantized") ResNet bottlenecks as implicit-GEMM
// convolutions on the int8 tensor cores (WMMA s8 x s8 -> s32, m16n16k16),
// NHWC.
//
// Replaces five TPU kernels of instaorder_tpu/ops/pallas_blocks.py, which
// compute two functions:
//   fused_bottleneck_int8               stride 1, identity residual
//   fused_bottleneck_int8_hwnc          the same on the (H, W, N, C) view
//   fused_bottleneck_down_int8          projection, stride 1 or 2
//   fused_bottleneck_down_int8_hwnc     projection, stride 1, hwnc view
//   fused_bottleneck_down_s2_int8_hwnc  projection, stride 2, hwnc view
// The port has no hwnc view, so one kernel serves all five
// (ops/int8_kernels.py sequences it). A block is three launches:
//   h1  = rq8(x . w1)                                   1x1
//   h2  = rq8(conv3x3_s(h1) . w2)                       3x3, pad 1
//   out = clip(rint((acc3*m3 + b3) + f32(x)*sxr), 0, 127)          identity
//   out = clip(rint((acc3*m3 + b3) + (accd*md + bd)), 0, 127)      projection
// with rq8(acc) = clip(rint(f32(acc)*m + b), 0, 127) per output channel
// (models/quantize `_requant`; the relu is the clip's lower bound). Every
// sum is an exact s32 sum of s8 products, and the epilogue is the
// reference's f32 mul then add, unfused (built with -fmad=false) and
// rounded half to even, so the output equals the XLA int8 oracle bit for
// bit. h1 and h2 are int8 by the int8c contract, so their device-memory
// scratch loses nothing.
//
// The projection's two K segments (h2 . w3 and x_s . wd) carry different
// per-channel multipliers, so they cannot share one accumulator as the
// bf16/v2 kernel's K-packed projection does: the kernel runs the two
// segments one after the other into two s32 tiles in shared memory and
// combines them in the epilogue.
//
// Bound on the H100: tensor-core operations (the dense int8 rate is twice
// the bf16 one) at serving batch. This first design keeps the bf16
// kernel's shape (csrc/bottleneck_v2.cu): 64x64 output tiles, 64-deep K
// steps staged through shared memory without a pipeline, WMMA rather
// than wgmma, h1/h2 through L2/HBM. Operand tiles are stored as 16x16
// blocks of 256 bytes, so that every WMMA fragment starts 32-byte
// aligned (a row-major int8 tile would put every other fragment on a
// 16-byte boundary).

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 64, NT = 128;
constexpr int KB = BK / 16;          // 16-deep blocks per K step
constexpr int LDC = BN + 4;

// One K segment: an NHWC int8 activation read as a 1x1 (stride s) or
// 3x3 (stride s, pad 1) im2col view, its (K, Cout) int8 weight rows and
// its per-output-channel f32 multiplier and bias. K = taps * C.
struct Seg {
  const int8_t* x;
  const int8_t* w;
  const float* m;
  const float* b;
  int C, H, W, stride, ksize, K;
};

enum Mode { kRq8 = 0, kResidual = 1, kProjection = 2 };

// 16 consecutive K entries of one im2col row (C % 16 == 0, so they lie
// in one tap); zero outside the image, past the row count or past K.
__device__ __forceinline__ int4 load_a(const Seg& s, int n, int ho, int wo,
                                       int k, bool row_ok) {
  if (!row_ok || k >= s.K) return make_int4(0, 0, 0, 0);
  const int tap = k / s.C;
  const int c = k - tap * s.C;
  const int pad = s.ksize == 3 ? 1 : 0;
  const int dy = s.ksize == 3 ? tap / 3 : 0;
  const int dx = s.ksize == 3 ? tap - 3 * dy : 0;
  const int hi = ho * s.stride + dy - pad;
  const int wi = wo * s.stride + dx - pad;
  if (hi < 0 || hi >= s.H || wi < 0 || wi >= s.W) return make_int4(0, 0, 0, 0);
  const int64_t off = (((int64_t)n * s.H + hi) * s.W + wi) * s.C + c;
  return *reinterpret_cast<const int4*>(s.x + off);
}

__device__ __forceinline__ float affine(int acc, float m, float b) {
  return __fadd_rn(__fmul_rn((float)acc, m), b);
}

__global__ void __launch_bounds__(NT)
conv_gemm_s8_kernel(Seg s0, Seg s1, int M, int Ho, int Wo, int Cout,
                    const int8_t* __restrict__ res, float sxr,
                    int8_t* __restrict__ out, int mode) {
  __shared__ __align__(128) int8_t As[BM * BK];
  __shared__ __align__(128) int8_t Bs[BK * BN];
  __shared__ __align__(128) int Cs[2][BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int hw = Ho * Wo;

  // this thread's two A rows (fixed over the K loop) and 16-byte K slot;
  // its two B rows of a K step and 16 columns
  const int slot = tid & 3;
  int an[2], aho[2], awo[2];
  bool aok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t m = m0 + (tid >> 2) + 32 * r;
    aok[r] = m < M;
    const int mm = aok[r] ? (int)m : 0;
    an[r] = mm / hw;
    const int rem = mm - an[r] * hw;
    aho[r] = rem / Wo;
    awo[r] = rem - aho[r] * Wo;
  }

  const int nseg = mode == kProjection ? 2 : 1;
  for (int sg = 0; sg < nseg; ++sg) {
    const Seg& s = sg ? s1 : s0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

    for (int k0 = 0; k0 < s.K; k0 += BK) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (tid >> 2) + 32 * r;
        const int4 v = load_a(s, an[r], aho[r], awo[r], k0 + slot * 16,
                              aok[r]);
        *reinterpret_cast<int4*>(
            &As[((row >> 4) * KB + slot) * 256 + (row & 15) * 16]) = v;
        const int k = k0 + row;          // this thread's B row
        int4 wv = make_int4(0, 0, 0, 0);
        if (k < s.K)
          wv = *reinterpret_cast<const int4*>(s.w + (int64_t)k * Cout + n0 +
                                              slot * 16);
        *reinterpret_cast<int4*>(
            &Bs[(slot * KB + (row >> 4)) * 256 + (row & 15) * 16]) = wv;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], &As[((wm * 2 + i) * KB + kk) * 256], 16);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], &Bs[((wn * 2 + j) * KB + kk) * 256], 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            &Cs[sg][(wm * 32 + i * 16) * LDC + wn * 32 + j * 16], acc[i][j],
            LDC, wmma::mem_row_major);
  }
  __syncthreads();

  for (int e = tid; e < BM * BN; e += NT) {
    const int row = e / BN, col = e - (e / BN) * BN;
    const int64_t m = m0 + row;
    if (m >= M) continue;
    const int n = n0 + col;
    const int64_t o = m * Cout + n;
    float y = affine(Cs[0][row * LDC + col], s0.m[n], s0.b[n]);
    if (mode == kProjection)
      y = __fadd_rn(y, affine(Cs[1][row * LDC + col], s1.m[n], s1.b[n]));
    else if (mode == kResidual)
      y = __fadd_rn(y, __fmul_rn((float)res[o], sxr));
    out[o] = (int8_t)(int)fminf(fmaxf(rintf(y), 0.0f), 127.0f);
  }
}

}  // namespace

// out[m, n] = epilogue(sum_k A[m, k] * W[k, n]) over the output grid
// (N, Ho, Wo), int8 in and out. Segment 1 (the projection) is read only
// in mode 2; `res` (an int8 tensor of out's shape) only in mode 1.
// Requires every segment's C % 16 == 0, Cout % 64 == 0 and 16-byte
// aligned pointers (checked by the Python wrapper).
extern "C" int io_conv_gemm_s8(
    const void* x0, const void* w0, const void* m0, const void* b0, int C0,
    int H0, int W0, int stride0, int ksize0,
    const void* x1, const void* w1, const void* m1, const void* b1, int C1,
    int H1, int W1, int stride1, int ksize1,
    int N, int Ho, int Wo, int Cout, const void* res, float sxr, void* out,
    int mode, void* stream) {
  Seg s0{(const int8_t*)x0, (const int8_t*)w0, (const float*)m0,
         (const float*)b0, C0, H0, W0, stride0, ksize0,
         ksize0 * ksize0 * C0};
  Seg s1{(const int8_t*)x1, (const int8_t*)w1, (const float*)m1,
         (const float*)b1, C1, H1, W1, stride1, ksize1,
         x1 ? ksize1 * ksize1 * C1 : 0};
  const int64_t M = (int64_t)N * Ho * Wo;
  if (M >= ((int64_t)1 << 31) || Cout % BN) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + BM - 1) / BM), Cout / BN);
  conv_gemm_s8_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      s0, s1, (int)M, Ho, Wo, Cout, (const int8_t*)res, sxr, (int8_t*)out,
      mode);
  return (int)cudaGetLastError();
}
