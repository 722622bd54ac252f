// int8c ("fully quantized") ResNet bottlenecks as implicit-GEMM
// convolutions on Hopper's int8 tensor cores (wgmma m64nNk32, s8 x s8 ->
// s32), NHWC.
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
// Bound on the H100: int8 tensor-core operations (the dense int8 rate is
// twice the bf16 one) at the serving batch. The design is the bf16
// kernel's (csrc/conv_gemm.cuh): 128 x 128 output tiles (128 x 64 where
// Cout = 64) from two warpgroups on wgmma, K steps of 128 int8 from a
// three-stage cp.async ring that gathers the im2col rows and the weights
// two steps ahead of the MMAs, two CTAs to an SM (the projection, whose
// finished projection sum takes another BN / 2 registers, runs 128 x 64
// tiles for it), and the
// epilogue in registers with the residual and the output staged through
// the idle ring. int8 wgmma reads B only K-major, so the weights come as
// (Cout, K) rows, laid out once when the model is built on the card
// (ops/gemm_layout.kmajor).
//
// The projection's two K segments carry different per-channel
// multipliers, so they cannot share one accumulator as the bf16/v2
// kernel's K-packed projection does: the kernel runs the projection
// segment first, finishes it into f32 registers yd = accd*md + bd, then
// reuses the accumulator for h2 . w3 and adds yd in the epilogue (f32
// addition commutes, so the sum is the reference's bit for bit).

#include "conv_gemm.cuh"

namespace {

using namespace convgemm;

// One K segment: an NHWC int8 activation read as a 1x1 (stride s) or 3x3
// (stride s, pad 1) im2col view, its (Cout, K) int8 weight rows and its
// per-output-channel f32 multiplier and bias. K = taps * C.
struct Seg {
  const int8_t* x;
  const int8_t* w;
  const float* m;
  const float* b;
  int C, H, W, stride, ksize, K;
};

// the epilogue and the A operand: rq8 of a 1x1 or of a 3x3, the identity
// residual (1x1), the projection (two 1x1 segments); a kernel name each
enum Kind { kRq8_1x1 = 0, kRq8_3x3 = 1, kResidual = 2, kProjection = 3 };

constexpr int kBK = 128;   // int8 elements of a K step

template <int BN>
struct Tile {
  static constexpr int kA = kBM * kRowBytes;     // 128 rows x 128 int8
  static constexpr int kB = BN * kRowBytes;      // BN rows x 128 int8
  static constexpr int kStage = kA + kB;
  static constexpr int kSmem = kStages * kStage + 4 * BN * 4 + 1024;
  static_assert(kSmem <= 232448, "ring exceeds shared memory");
};

__device__ __forceinline__ float affine(int acc, float m, float b) {
  return __fadd_rn(__fmul_rn((float)acc, m), b);
}

template <int BN, int KIND>
__global__ void __launch_bounds__(kThreads,
                                  KIND == kProjection && BN > 64 ? 1 : 2)
conv_gemm_s8_kernel(Seg s0, Seg s1, int M, int Ho, int Wo, int Cout,
                    const int8_t* __restrict__ res, float sxr,
                    int8_t* __restrict__ out) {
  using T = Tile<BN>;
  constexpr bool kProj = KIND == kProjection;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* sm0 = reinterpret_cast<float*>(smem + kStages * T::kStage);
  float* sb0 = sm0 + BN;
  float* sm1 = sb0 + BN;
  float* sb1 = sm1 + BN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ntiles = Cout / BN;
  const int n0 = (int)(blockIdx.x % ntiles) * BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ntiles) * kBM;
  for (int i = tid; i < BN; i += kThreads) {
    sm0[i] = s0.m[n0 + i];
    sb0[i] = s0.b[n0 + i];
    if (kProj) {
      sm1[i] = s1.m[n0 + i];
      sb1[i] = s1.b[n0 + i];
    }
  }
  if (KIND == kResidual)
    prefetch_rows_l2(res + m0 * Cout + n0, Cout,
                     M - m0 < kBM ? (int)(M - m0) : kBM, BN, tid);

  // the loader: 16-byte chunk q of rows tid / 8 + 32 i of each K step.
  // The projection runs its segment 1 (x_s . wd) first.
  const int q = tid & 7;
  int rn[4], rho[4], rwo[4];
  bool rok[4];
  decode_rows<4>(m0, tid >> 3, 32, M, Ho, Wo, rn, rho, rwo, rok);
  Gather<4> g;
  int lseg = -1;
  const Seg first = kProj ? s1 : s0;
  const int t0 = (first.K + kBK - 1) / kBK;
  const int nsteps = t0 + (kProj ? (s0.K + kBK - 1) / kBK : 0);

  auto issue = [&](int j) {
    const int sg = j < t0 ? 0 : 1;
    const Seg s = sg ? s0 : first;
    const int k0 = (sg ? j - t0 : j) * kBK;
    if (sg != lseg) {
      g.start(s.x, 1, s.C, s.H, s.W, s.stride, s.ksize, s.K, rn, rho, rwo,
              rok, 16 * q);
      lseg = sg;
    } else {
      g.advance(kBK);
    }
    uint8_t* st = smem + (j % kStages) * T::kStage;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok;
      const void* src = g.src(i, ok);
      cp_async16(smem_addr(st) + swz128((tid >> 3) + 32 * i, q), src, ok);
    }
    // weights: BN rows (output channels) of 128 K entries
    const bool kok = k0 + 16 * q < s.K;
#pragma unroll
    for (int p = 0; p < BN / 32; ++p) {
      const int nr = (tid >> 3) + 32 * p;
      const int8_t* src =
          kok ? s.w + (int64_t)(n0 + nr) * s.K + k0 + 16 * q : s.w;
      cp_async16(smem_addr(st + T::kA) + swz128(nr, q), src, kok);
    }
  };

  int acc[BN / 2];
  float yd[kProj ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nsteps) issue(j);
    cp_async_commit();
  }
  for (int kt = 0; kt < nsteps; ++kt) {
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    const uint32_t st = smem_addr(smem) + (kt % kStages) * T::kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8<BN>(acc, desc_kmajor(st + wg * kWgRows * kRowBytes, kk * 32),
                   desc_kmajor(st + T::kA, kk * 32));
    wgmma_commit();
    // while the MMAs run: the loads of step kt + 2 into the slot of step
    // kt - 1, whose MMAs every warpgroup finished before the barrier
    if (kt + kStages - 1 < nsteps) issue(kt + kStages - 1);
    cp_async_commit();
    wgmma_wait<0>();
    if (kProj && kt == t0 - 1) {
      // the projection finished: yd = accd * md + bd, then h2 . w3
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = frag_col(tid, j) + (e & 1);
          yd[kProj ? 4 * j + e : 0] = affine(acc[4 * j + e], sm1[n], sb1[n]);
          acc[4 * j + e] = 0;
        }
    }
  }

  // epilogue: residual tile in, output tile out, both through the ring
  cp_async_wait<0>();
  __syncthreads();
  constexpr int ld = BN + 16;
  uint8_t* so = smem;
  uint8_t* sr = smem + kBM * ld;
  constexpr int cpr = BN / 16;
  if (KIND == kResidual) {
    for (int e = tid; e < kBM * cpr; e += kThreads) {
      const int row = e / cpr, ch = e - row * cpr;
      if (m0 + row < M)
        *reinterpret_cast<int4*>(sr + row * ld + ch * 16) =
            *reinterpret_cast<const int4*>(res + (m0 + row) * Cout + n0
                                           + ch * 16);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = frag_row(tid, e >> 1), n = frag_col(tid, j) + (e & 1);
      float y = affine(acc[4 * j + e], sm0[n], sb0[n]);
      if (kProj)
        y = __fadd_rn(y, yd[kProj ? 4 * j + e : 0]);
      else if (KIND == kResidual)
        y = __fadd_rn(y, __fmul_rn((float)(int8_t)sr[row * ld + n], sxr));
      so[row * ld + n] = (uint8_t)(int8_t)(int)fminf(fmaxf(rintf(y), 0.0f),
                                                     127.0f);
    }
  __syncthreads();
  for (int e = tid; e < kBM * cpr; e += kThreads) {
    const int row = e / cpr, ch = e - row * cpr;
    if (m0 + row < M)
      *reinterpret_cast<int4*>(out + (m0 + row) * Cout + n0 + ch * 16) =
          *reinterpret_cast<const int4*>(so + row * ld + ch * 16);
  }
}

template <int BN, int KIND>
int launch(const Seg& s0, const Seg& s1, int M, int Ho, int Wo, int Cout,
           const int8_t* res, float sxr, int8_t* out, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const int e = allow_smem(conv_gemm_s8_kernel<BN, KIND>, Tile<BN>::kSmem,
                           smem_set);
  if (e) return e;
  const unsigned grid = (unsigned)(((int64_t)M + kBM - 1) / kBM * (Cout / BN));
  conv_gemm_s8_kernel<BN, KIND><<<grid, kThreads, Tile<BN>::kSmem, stream>>>(
      s0, s1, M, Ho, Wo, Cout, res, sxr, out);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_kind(const Seg& s0, const Seg& s1, int M, int Ho, int Wo,
                int Cout, const int8_t* res, float sxr, int8_t* out,
                int mode, cudaStream_t stream) {
  if (mode == 2)
    return launch<BN, kProjection>(s0, s1, M, Ho, Wo, Cout, res, sxr, out,
                                   stream);
  if (mode == 1)
    return launch<BN, kResidual>(s0, s1, M, Ho, Wo, Cout, res, sxr, out,
                                 stream);
  if (s0.ksize == 3)
    return launch<BN, kRq8_3x3>(s0, s1, M, Ho, Wo, Cout, res, sxr, out,
                                stream);
  return launch<BN, kRq8_1x1>(s0, s1, M, Ho, Wo, Cout, res, sxr, out,
                              stream);
}

}  // namespace

// out[m, n] = epilogue(sum_k A[m, k] * W[n, k]) over the output grid
// (N, Ho, Wo), int8 in and out; weights (Cout, K) rows. mode 0: rq8 of
// segment 0 (a 1x1 or a 3x3); mode 1: segment 0 plus the identity
// residual `res` (an int8 tensor of out's shape); mode 2: segment 0 plus
// the projection segment 1 (both 1x1). bn: the CTA's output columns (64
// or 128, a divisor of Cout; ops/gemm_layout.tile_n). Requires every
// segment's C % 16 == 0 and 16-byte aligned pointers (checked by the
// Python wrapper).
extern "C" int io_conv_gemm_s8(
    const void* x0, const void* w0, const void* m0, const void* b0, int C0,
    int H0, int W0, int stride0, int ksize0,
    const void* x1, const void* w1, const void* m1, const void* b1, int C1,
    int H1, int W1, int stride1, int ksize1,
    int N, int Ho, int Wo, int Cout, int bn, const void* res, float sxr,
    void* out, int mode, void* stream) {
  Seg s0{(const int8_t*)x0, (const int8_t*)w0, (const float*)m0,
         (const float*)b0, C0, H0, W0, stride0, ksize0,
         ksize0 * ksize0 * C0};
  Seg s1{(const int8_t*)x1, (const int8_t*)w1, (const float*)m1,
         (const float*)b1, C1, H1, W1, stride1, ksize1,
         x1 ? ksize1 * ksize1 * C1 : 0};
  const int64_t M = (int64_t)N * Ho * Wo;
  if (M >= ((int64_t)1 << 31) || Cout % bn || mode < 0 || mode > 2
      || (mode == 2 && (x1 == nullptr || ksize0 != 1 || ksize1 != 1))
      || (mode == 1 && (res == nullptr || ksize0 != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 128)
    return launch_kind<128>(s0, s1, (int)M, Ho, Wo, Cout,
                            (const int8_t*)res, sxr, (int8_t*)out, mode, st);
  if (bn == 64)
    return launch_kind<64>(s0, s1, (int)M, Ho, Wo, Cout, (const int8_t*)res,
                           sxr, (int8_t*)out, mode, st);
  return (int)cudaErrorInvalidValue;
}
