// The f32 mode of the ResNet bottleneck's implicit-GEMM convolution, NHWC,
// on Hopper's CUDA cores (f32 FMA), for the folded model at f32
// (ops/bottleneck_bf16_kernels.py given f32 activations) and for the
// boundary-int8 ("v2") model quantized at compute_dtype=f32
// (ops/bottleneck_kernels.py given f32 weights).
//
// Replaces the f32 modes of these TPU kernels of
// instaorder_tpu/ops/pallas_blocks.py, which are dtype-generic and run in
// f32 when given f32 activations or weights (the kernel bodies keep h1 and
// h2 in f32, never rounded):
//   fused_bottleneck, fused_bottleneck_down, fused_bottleneck_stage,
//   fused_bottleneck_stage_stream, fused_bottleneck_hwnc
// and, at v2's f32 compute:
//   fused_bottleneck_i8v2_hwnc, fused_bottleneck_down_s2_i8v2_hwnc,
//   fused_bottleneck_i8v2_hwnc_stage, fused_bottleneck_i8v2_hwncp_stage,
//   fused_bottleneck_down_i8v2_hwnc, fused_bottleneck_i8v2,
//   fused_bottleneck_down_i8v2
// A block runs as the same three launches as the bf16 block
// (ops/bottleneck_kernels._block_gemms sequences them):
//   h1  = relu(x . w1 + b1)                              1x1
//   h2  = relu(conv3x3_s(h1) . w2 + b2)                  3x3, pad 1
//   out = relu(h2 . w3 + b3 + x)                         identity
//   out = relu([h2 | x_s] . [[w3], [wd]] + b3 + bd)      projection
//   v2:  out = clip(rint(h2 . w3 + b3 + (r*x | + bd)), 0, 127)
// with h1 and h2 in f32 device scratch, every value f32, the epilogue's
// adds in the reference order and nothing rounded below f32. A v2 block's
// x (conv1's A operand, the projection's second segment and the identity
// residual) is int8, or f32 holding the integers 0..127; its output is
// int8, or f32 holding the same integers.
//
// Bound on the H100: f32 operations (67 TFLOP/s outside the tensor
// cores). TF32 tensor cores would be faster but keep a 10-bit mantissa,
// about 5e-4 relative, far outside the f32 bar (2e-5 of the output
// scale); a 3xTF32 split on wgmma is a later redesign. Design:
//   - a CTA computes a 128 x BN output tile (BN = 128, or 64 where Cout
//     = 64: ops/gemm_layout.tile_n) with 256 threads, each a register
//     micro-tile of 8 x 8 (BN 128) or 4 x 8 (BN 64) sums;
//   - a K step is 32 elements of every operand row (128 bytes of f32),
//     gathered by the bf16 kernel's loader (csrc/conv_gemm.cuh `Gather`:
//     16-byte cp.async of the im2col view, zero fill for the halo, the
//     stride-2 edges, rows past M and K past a segment's end) into a
//     three-stage ring, two steps ahead of the FMAs;
//   - an int8 segment's K step is 32 raw bytes of a row, two 16-byte
//     chunks copied by the two threads (lanes 2p and 2p + 1 of one warp)
//     that own the row's f32 chunks 0-3 and 4-7, into the last 32 bytes
//     of the row's f32 slot; before the stage's barrier each thread reads
//     its raw chunk into registers, the warp syncs, and each writes its
//     16 values widened to f32 (exact for -128..127) over the row's half
//     it owns (the odd lane's half covers both raw chunks, which the
//     sync keeps from being overwritten before they are read);
//   - the stage is laid out for the CUDA cores, not for wgmma: A rows of
//     32 f32 at a pitch of 36 (the four rows a warp reads at one K index
//     fall in four banks), B as K rows of BN f32 (a warp's eight column
//     groups read 128 contiguous bytes);
//   - per K index a thread reads its 8 (or 4) A values and two 16-byte B
//     vectors and issues 64 (or 32) FMAs with __fmaf_rn, which the
//     build's -fmad=false does not split;
//   - the epilogue reads the bias (and the residual, f32 or int8) and
//     writes the output straight from the registers (a warp covers four
//     rows of 128 contiguous bytes of f32, or 32 of int8).

#include "conv_gemm.cuh"

namespace {

using namespace convgemm;

// One operand segment of the GEMM's K axis: an f32 or int8 NHWC
// activation read as a 1x1 (stride s) or 3x3 (stride s, pad 1) im2col
// view. K = taps * C.
struct SegF {
  const void* ptr;
  const float* w;   // this segment's (K, Cout) weight rows
  int is_i8, C, H, W, stride, ksize, K;
};

// epilogue modes (ops/bottleneck_kernels.py _RELU_F32, _RES_RELU_F32,
// _Q8_INT8_F32, _Q8_F32): relu(acc + b); relu(acc + b (+ b2) (+ r * x));
// clip(rint(acc + b (+ b2) (+ r * x)), 0, 127) as int8 or as f32
enum ModeF { kReluF32 = 0, kResReluF32 = 1, kQ8Int8F32 = 2, kQ8F32 = 3 };
enum Kind { k1x1 = 0, k3x3 = 1, kProj = 2 };

constexpr int kBK = 32;         // f32 elements of a K step (128 bytes)
constexpr int kLdA = kBK + 4;   // A row pitch in the stage, f32
// byte offset in an A row of an int8 segment's raw K step (32 bytes)
constexpr int kRawOff = (kBK - 8) * 4;

template <int BN>
struct TileF {
  static constexpr int kNTN = BN / 8;            // threads along N
  static constexpr int kNTM = kThreads / kNTN;   // threads along M
  static constexpr int kTM = kBM / kNTM;         // rows of a thread
  static constexpr int kWN = kNTN / 8;           // warps along N
  static constexpr int kA = kBM * kLdA * 4;      // A bytes of a stage
  static constexpr int kB = kBK * BN * 4;        // B bytes of a stage
  static constexpr int kStage = kA + kB;
  static constexpr int kSmem = kStages * kStage;
  // two CTAs an SM where the 4 x 8 micro-tile leaves registers for it
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
  static_assert(kNTM * kTM == kBM && kNTN * 8 == BN, "thread grid");
  static_assert(kSmem <= 232448, "ring exceeds shared memory");
};

template <int BN, int KIND>
__global__ void __launch_bounds__(kThreads, TileF<BN>::kMinBlocks)
conv_gemm_f32_kernel(SegF s0, SegF s1, int M, int Ho, int Wo, int Cout,
                     const float* __restrict__ bias,
                     const float* __restrict__ bias2,
                     const void* __restrict__ res, int res_i8, float r,
                     void* __restrict__ out, int mode) {
  using T = TileF<BN>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int ntiles = Cout / BN;
  const int n0 = (int)(blockIdx.x % ntiles) * BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ntiles) * kBM;

  // the loader: 16-byte chunk q of rows tid / 8 + 32 i of each K step
  // (an int8 segment: raw chunk q % 2 of row tid / 8 + 32 (q / 2))
  const int q = tid & 7;
  int rn[4], rho[4], rwo[4];
  bool rok[4];
  decode_rows<4>(m0, tid >> 3, 32, M, Ho, Wo, rn, rho, rwo, rok);
  Gather<4> g;
  int lseg = -1;
  const int t0 = (s0.K + kBK - 1) / kBK;
  const int nsteps = t0 + (KIND == kProj ? (s1.K + kBK - 1) / kBK : 0);

  auto issue = [&](int j) {
    const int sg = j < t0 ? 0 : 1;
    const SegF s = sg ? s1 : s0;
    const int k0 = (sg ? j - t0 : j) * kBK;
    if (sg != lseg) {
      g.start(s.ptr, s.is_i8 ? 1 : 4, s.C, s.H, s.W, s.stride, s.ksize, s.K,
              rn, rho, rwo, rok, s.is_i8 ? 16 * (q & 1) : 4 * q);
      lseg = sg;
    } else {
      g.advance(kBK);
    }
    uint8_t* st = smem + (j % kStages) * T::kStage;
    if (s.is_i8) {
      // row i = q / 2 only, selected in an unrolled loop so that the
      // gather's per-row arrays stay in registers
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i != (q >> 1)) continue;
        bool ok;
        const void* src = g.src(i, ok);
        cp_async16(smem_addr(st + ((tid >> 3) + 32 * i) * kLdA * 4 + kRawOff
                             + 16 * (q & 1)), src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok;
        const void* src = g.src(i, ok);
        cp_async16(smem_addr(st + ((tid >> 3) + 32 * i) * kLdA * 4 + q * 16),
                   src, ok);
      }
    }
    // weights: kBK rows of BN columns, row-major as in device memory
    constexpr int kCpr = BN / 4, kRpp = kThreads / kCpr;
    const int cq = tid % kCpr;
#pragma unroll
    for (int p = 0; p < kBK / kRpp; ++p) {
      const int kr = tid / kCpr + kRpp * p;
      const bool ok = k0 + kr < s.K;
      const float* src = ok ? s.w + (int64_t)(k0 + kr) * Cout + n0 + cq * 4
                            : s.w;
      cp_async16(smem_addr(st + T::kA + (kr * BN + cq * 4) * 4), src, ok);
    }
  };

  // an int8 K step -> f32 in place: this thread's raw chunk (its own
  // cp.async, complete after the wait) into registers, the warp's sync,
  // then its 16 values over its half of the row
  auto widen = [&](int kt) {
    uint8_t* row = smem + (kt % kStages) * T::kStage
                   + ((tid >> 3) + 32 * (q >> 1)) * kLdA * 4;
    const int4 v = *reinterpret_cast<const int4*>(row + kRawOff
                                                  + 16 * (q & 1));
    __syncwarp();
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    float4* o = reinterpret_cast<float4*>(row + 64 * (q & 1));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = make_float4((float)b[4 * e], (float)b[4 * e + 1],
                         (float)b[4 * e + 2], (float)b[4 * e + 3]);
  };

  // the thread's micro-tile: rows tm + kNTM * i, columns c0 .. c0 + 3
  // and c1 .. c1 + 3; a warp is 4 row groups x 8 column groups
  const int lane = tid & 31, warp = tid >> 5;
  const int tn = (warp % T::kWN) * 8 + (lane & 7);
  const int tm = (warp / T::kWN) * 4 + (lane >> 3);
  const int c0 = tn * 4, c1 = BN / 2 + tn * 4;

  float acc[T::kTM][8];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nsteps) issue(j);
    cp_async_commit();
  }
  for (int kt = 0; kt < nsteps; ++kt) {
    cp_async_wait<kStages - 2>();
    if (kt < t0 ? s0.is_i8 : s1.is_i8) widen(kt);
    __syncthreads();
    // the loads of step kt + 2 into the slot of step kt - 1, which every
    // thread finished reading before the barrier
    if (kt + kStages - 1 < nsteps) issue(kt + kStages - 1);
    cp_async_commit();
    const uint8_t* st = smem + (kt % kStages) * T::kStage;
    const float* As = reinterpret_cast<const float*>(st) + tm * kLdA;
    const float* Bs = reinterpret_cast<const float*>(st + T::kA);
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[T::kTM];
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) a[i] = As[i * T::kNTM * kLdA + k];
      const float4 u = *reinterpret_cast<const float4*>(Bs + k * BN + c0);
      const float4 v = *reinterpret_cast<const float4*>(Bs + k * BN + c1);
      const float b[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < T::kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: relu(acc + b) (h1, h2), or acc + b (+ b2) (+ r * x) in
  // that order, then relu (the block output) or the v2 boundary's
  // clip(rint(.), 0, 127), f32 throughout
  const bool q8 = mode == kQ8Int8F32 || mode == kQ8F32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = n0 + (h ? c1 : c0);
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + col));
    float4 b2v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (bias2 != nullptr)
      b2v = __ldg(reinterpret_cast<const float4*>(bias2 + col));
    const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
    const float b2[4] = {b2v.x, b2v.y, b2v.z, b2v.w};
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) {
      const int64_t m = m0 + tm + T::kNTM * i;
      if (m >= M) continue;
      float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (mode != kReluF32 && res != nullptr) {
        if (res_i8) {
          const char4 x4 = *reinterpret_cast<const char4*>(
              static_cast<const int8_t*>(res) + m * Cout + col);
          xv[0] = x4.x; xv[1] = x4.y; xv[2] = x4.z; xv[3] = x4.w;
        } else {
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(
              static_cast<const float*>(res) + m * Cout + col));
          xv[0] = x4.x; xv[1] = x4.y; xv[2] = x4.z; xv[3] = x4.w;
        }
      }
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = acc[i][4 * h + e] + bb[e];
        if (mode != kReluF32) {
          if (bias2 != nullptr) t = t + b2[e];
          if (res != nullptr) t = t + xv[e] * r;
        }
        y[e] = q8 ? fminf(fmaxf(rintf(t), 0.0f), 127.0f) : fmaxf(t, 0.0f);
      }
      if (mode == kQ8Int8F32)
        *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + m * Cout
                                  + col) =
            make_char4((signed char)y[0], (signed char)y[1],
                       (signed char)y[2], (signed char)y[3]);
      else
        *reinterpret_cast<float4*>(static_cast<float*>(out) + m * Cout
                                   + col) =
            make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

template <int BN, int KIND>
int launch(const SegF& s0, const SegF& s1, int M, int Ho, int Wo, int Cout,
           const float* bias, const float* bias2, const void* res,
           int res_i8, float r, void* out, int mode, cudaStream_t stream) {
  static bool smem_set = false;
  const int e = allow_smem(conv_gemm_f32_kernel<BN, KIND>, TileF<BN>::kSmem,
                           smem_set);
  if (e) return e;
  const unsigned grid = (unsigned)(((int64_t)M + kBM - 1) / kBM * (Cout / BN));
  conv_gemm_f32_kernel<BN, KIND><<<grid, kThreads, TileF<BN>::kSmem,
                                   stream>>>(s0, s1, M, Ho, Wo, Cout, bias,
                                             bias2, res, res_i8, r, out,
                                             mode);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_kind(const SegF& s0, const SegF& s1, int M, int Ho, int Wo,
                int Cout, const float* bias, const float* bias2,
                const void* res, int res_i8, float r, void* out, int mode,
                cudaStream_t stream) {
  if (s1.ptr != nullptr)
    return launch<BN, kProj>(s0, s1, M, Ho, Wo, Cout, bias, bias2, res,
                             res_i8, r, out, mode, stream);
  if (s0.ksize == 3)
    return launch<BN, k3x3>(s0, s1, M, Ho, Wo, Cout, bias, bias2, res,
                            res_i8, r, out, mode, stream);
  return launch<BN, k1x1>(s0, s1, M, Ho, Wo, Cout, bias, bias2, res, res_i8,
                          r, out, mode, stream);
}

}  // namespace

// out[m, n] = epilogue(sum_k A[m, k] * W[k, n]) over the output grid
// (N, Ho, Wo), f32 sums of f32 operands (an int8 A segment widened to f32
// exactly); the K axis is segment 0 then segment 1 (absent when its
// pointer is null), each with its own (K, Cout) f32 weight rows. The
// residual is f32 or (res_i8) int8; out is int8 in kQ8Int8F32, else f32.
// bn: the CTA's output columns (64 or 128, a divisor of Cout;
// ops/gemm_layout.tile_n). Requires every segment's C % 32 == 0, Cout %
// bn == 0, in the K-packed projection segment 0's K % 32 == 0 (a K step
// of either type, ops/gemm_layout.F32_K_STEP), and 16-byte aligned
// pointers (checked by the Python wrapper).
extern "C" int io_conv_gemm_f32(
    const void* a0, const void* w0, int a0_i8, int a0_C, int a0_H,
    int a0_W, int a0_stride, int a0_ksize,
    const void* a1, const void* w1, int a1_i8, int a1_C, int a1_H,
    int a1_W, int a1_stride, int a1_ksize,
    int N, int Ho, int Wo, int Cout, int bn, const void* bias,
    const void* bias2, const void* res, int res_i8, float r, void* out,
    int mode, void* stream) {
  SegF s0{a0, (const float*)w0, a0_i8, a0_C, a0_H, a0_W, a0_stride,
          a0_ksize, a0_ksize * a0_ksize * a0_C};
  SegF s1{a1, (const float*)w1, a1_i8, a1_C, a1_H, a1_W, a1_stride,
          a1_ksize, a1 ? a1_ksize * a1_ksize * a1_C : 0};
  const int64_t M = (int64_t)N * Ho * Wo;
  if (M >= ((int64_t)1 << 31) || Cout % bn || mode < kReluF32
      || mode > kQ8F32 || a0_C % kBK || (a1 != nullptr && a1_C % kBK)
      || (a1 != nullptr && (s0.K % kBK || a0_ksize != 1 || a1_ksize != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* b = (const float*)bias;
  const float* b2 = (const float*)bias2;
  if (bn == 128)
    return launch_kind<128>(s0, s1, (int)M, Ho, Wo, Cout, b, b2, res, res_i8,
                            r, out, mode, st);
  if (bn == 64)
    return launch_kind<64>(s0, s1, (int)M, Ho, Wo, Cout, b, b2, res, res_i8,
                           r, out, mode, st);
  return (int)cudaErrorInvalidValue;
}
