// The f32 mode of the ResNet bottleneck's implicit-GEMM convolution, NHWC,
// on Hopper's TF32 tensor cores with f32 accuracy (3xTF32), for the
// folded model at f32 (ops/bottleneck_bf16_kernels.py given f32
// activations) and for the boundary-int8 ("v2") model quantized at
// compute_dtype=f32 (ops/bottleneck_kernels.py given f32 weights).
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
// with h1 and h2 in f32 device scratch, every sum f32, the epilogue's
// adds in the reference order and nothing rounded below f32. A v2 block's
// x (conv1's A operand, the projection's second segment and the identity
// residual) is int8, or f32 holding the integers 0..127; its output is
// int8, or f32 holding the same integers.
//
// Bound on the H100: tensor-core operations at three TF32 products per
// f32 product (495 / 3 = 165 TFLOP/s; two for an int8 A: 247.5). One TF32 product keeps ~11 significant bits, about 5e-4
// relative, far outside the f32 bar (2e-5 of the output scale); three
// recover ~22: each operand is split as hi = tf32(a), lo = tf32(a - hi)
// (the subtraction is exact) and a . b = lo_a . hi_b + hi_a . lo_b +
// hi_a . hi_b, dropping lo_a . lo_b (~2^-22 relative). An int8 A segment
// is exact in TF32, has lo_a = 0 and takes two products; an f32 one is
// always split (f32 holding a v2 block's integers gets lo_a = 0 from the
// split). Design (csrc/conv_gemm.cuh):
//   - a CTA computes a 128 x BN output tile (BN = 128, or 64 where Cout
//     = 64: ops/gemm_layout.tile_n) with two consumer warpgroups of 64
//     rows on wgmma m64nBNk8 tf32, both operands K-major from shared
//     memory with the 128-byte swizzle (tf32 wgmma has no transpose);
//   - a K step is 32 elements of every operand row (128 bytes of f32),
//     gathered by the bf16 kernel's loader (`Gather`: 16-byte cp.async of
//     the im2col view, zero fill for the halo, the stride-2 edges, rows
//     past M and K past a segment's end) into a ring of stages; a stage
//     holds A_hi, A_lo, B_hi, B_lo (16 KB each at BN = 128) and a 4 KB
//     raw tile. At BN = 128 three stages (~205 KB, loads two steps ahead
//     of the MMAs) and one CTA an SM; at BN = 64 two stages and two CTAs
//     an SM, which measured faster at every shape;
//   - the weights come split and K-major, (2, Cout, K) = [hi, lo] in the
//     im2col order, made once when the model is built
//     (ops/gemm_layout.split_kmajor_f32): the ring copies B_hi and B_lo;
//   - each thread splits the A chunks it copied itself, once its copy has
//     landed: hi over the raw f32 in place, lo into A_lo. That runs for
//     step k + 1 while the MMAs of step k run, then a proxy fence makes
//     the generic-proxy writes visible to wgmma before the next barrier.
//     An int8 segment's K step is 32 raw bytes of a row, copied into the
//     raw tile by the two threads that widen it into A_hi (exact for
//     -128..127);
//   - a K step's products go into one fresh accumulator, the small ones
//     (lo_a . hi_b, hi_a . lo_b of each k8) first and hi_a . hi_b last,
//     and the step's sum is added into f32 registers rounded to nearest.
//     The tensor cores truncate their sums (a bias toward zero that grows
//     with the chain of large partial sums): a fresh accumulator a step
//     keeps it from growing with K (layer4's 3x3 has K = 4,608), and
//     the order keeps the chain over large partial sums four long;
//   - the epilogue works on those registers in the reference's order
//     (acc + b, (+ b2), (+ x * r), then relu or clip(rint(.), 0, 127);
//     built with -fmad=false) and stages the residual and the output tile
//     through the idle ring for 16-byte global accesses; the residual
//     rows are prefetched into L2 when the CTA starts and copied in with
//     cp.async, every copy in flight at once (a 1x1 at K = 64 is two K
//     steps, so its epilogue is most of its time).

#include "conv_gemm.cuh"

namespace {

using namespace convgemm;

// what one A segment holds: f32 values (split into hi and lo) or int8
// values (widened to f32, exact in TF32: no lo)
enum AKind { kAF32 = 0, kAInt8 = 1 };

// One operand segment of the GEMM's K axis: an f32 or int8 NHWC
// activation read as a 1x1 (stride s) or 3x3 (stride s, pad 1) im2col
// view, and its split K-major weights. K = taps * C.
struct SegF {
  const void* ptr;
  const float* w;   // (2, Cout, K): hi then lo, K-major
  int kind, C, H, W, stride, ksize, K;
};

// epilogue modes (ops/bottleneck_kernels.py _RELU_F32, _RES_RELU_F32,
// _Q8_INT8_F32, _Q8_F32): relu(acc + b); relu(acc + b (+ b2) (+ r * x));
// clip(rint(acc + b (+ b2) (+ r * x)), 0, 127) as int8 or as f32
enum ModeF { kReluF32 = 0, kResReluF32 = 1, kQ8Int8F32 = 2, kQ8F32 = 3 };
enum Kind { k1x1 = 0, k3x3 = 1, kProj = 2 };

constexpr int kBK = 32;         // f32 elements of a K step (128 bytes)
constexpr int kRawRow = 32;     // bytes of an int8 K step of one row

template <int BN>
struct TileF {
  static constexpr int kA = kBM * kRowBytes;      // A_hi or A_lo
  static constexpr int kB = BN * kRowBytes;       // B_hi or B_lo
  static constexpr int kALo = kA;                 // offsets in a stage
  static constexpr int kBHi = 2 * kA;
  static constexpr int kBLo = 2 * kA + kB;
  static constexpr int kRaw = 2 * kA + 2 * kB;
  static constexpr int kStage = kRaw + kBM * kRawRow;
  // stages of the ring, and CTAs an SM: 128-wide tiles one CTA with
  // three stages (~205 KB); 64-wide tiles two CTAs with two stages
  // (~105 KB each, <= 128 registers a thread), so that one CTA's
  // prologue and epilogue run under the other's MMAs
  static constexpr int kRing = BN == 64 ? 2 : 3;
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
  // the ring, the biases, and slack for the 1024-byte alignment
  static constexpr int kSmem = kRing * kStage + 2 * BN * 4 + 1024;
  static_assert(kStage % 1024 == 0, "every tile 1024-byte aligned");
  static_assert(kSmem * kMinBlocks <= 232448, "ring exceeds shared memory");
  // the epilogue's output and residual tiles fit in the idle ring
  static_assert(2 * kBM * (BN * 4 + 16) <= kRing * kStage, "epilogue");
};

template <int BN, int KIND>
__global__ void __launch_bounds__(kThreads, TileF<BN>::kMinBlocks)
conv_gemm_f32_kernel(SegF s0, SegF s1, int M, int Ho, int Wo, int Cout,
                     const float* __restrict__ bias,
                     const float* __restrict__ bias2,
                     const void* __restrict__ res, int res_i8, float r,
                     void* __restrict__ out, int mode) {
  using T = TileF<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* sb = reinterpret_cast<float*>(smem + T::kRing * T::kStage);
  float* sb2 = sb + BN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ntiles = Cout / BN;
  const int n0 = (int)(blockIdx.x % ntiles) * BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ntiles) * kBM;
  for (int i = tid; i < BN; i += kThreads) {
    sb[i] = bias[n0 + i];
    sb2[i] = bias2 != nullptr ? bias2[n0 + i] : 0.0f;
  }
  const int res_es = res_i8 ? 1 : 4;
  if (res != nullptr)
    prefetch_rows_l2(static_cast<const char*>(res)
                     + (m0 * Cout + n0) * res_es, (int64_t)Cout * res_es,
                     M - m0 < kBM ? (int)(M - m0) : kBM, BN * res_es, tid);

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
  auto kind_of = [&](int j) { return j < t0 ? s0.kind : s1.kind; };

  auto issue = [&](int j) {
    const int sg = j < t0 ? 0 : 1;
    const SegF s = sg ? s1 : s0;
    const bool i8 = s.kind == kAInt8;
    const int k0 = (sg ? j - t0 : j) * kBK;
    if (sg != lseg) {
      g.start(s.ptr, i8 ? 1 : 4, s.C, s.H, s.W, s.stride, s.ksize, s.K, rn,
              rho, rwo, rok, i8 ? 16 * (q & 1) : 4 * q);
      lseg = sg;
    } else {
      g.advance(kBK);
    }
    uint8_t* st = smem + (j % T::kRing) * T::kStage;
    if (i8) {
      // row i = q / 2 only, selected in an unrolled loop so that the
      // gather's per-row arrays stay in registers
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i != (q >> 1)) continue;
        bool ok;
        const void* src = g.src(i, ok);
        cp_async16(smem_addr(st + T::kRaw + ((tid >> 3) + 32 * i) * kRawRow
                             + 16 * (q & 1)), src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok;
        const void* src = g.src(i, ok);
        cp_async16(smem_addr(st) + swz128((tid >> 3) + 32 * i, q), src, ok);
      }
    }
    // weights: BN rows (output channels) of 32 K entries, hi and lo
    const bool kok = k0 + 4 * q < s.K;
    const int64_t lo = (int64_t)Cout * s.K;
#pragma unroll
    for (int p = 0; p < BN / 32; ++p) {
      const int nr = (tid >> 3) + 32 * p;
      const float* src = s.w + (int64_t)(n0 + nr) * s.K + k0 + 4 * q;
      cp_async16(smem_addr(st + T::kBHi) + swz128(nr, q), kok ? src : s.w,
                 kok);
      cp_async16(smem_addr(st + T::kBLo) + swz128(nr, q),
                 kok ? src + lo : s.w, kok);
    }
  };

  // step kt's A chunks this thread copied (landed after its wait): f32
  // split into hi (in place) and lo; int8 widened into A_hi. Then the
  // fence that shows these writes to wgmma.
  auto prepare = [&](int kt) {
    uint8_t* st = smem + (kt % T::kRing) * T::kStage;
    const int kind = kind_of(kt);
    if (kind == kAInt8) {
      const int row = (tid >> 3) + 32 * (q >> 1);
      const int4 v = *reinterpret_cast<const int4*>(
          st + T::kRaw + row * kRawRow + 16 * (q & 1));
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<float4*>(st + swz128(row, 4 * (q & 1) + e)) =
            make_float4((float)b[4 * e], (float)b[4 * e + 1],
                        (float)b[4 * e + 2], (float)b[4 * e + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t off = swz128((tid >> 3) + 32 * i, q);
        float4* hp = reinterpret_cast<float4*>(st + off);
        const float4 a = *hp;
        const float4 h = make_float4(tf32_rna(a.x), tf32_rna(a.y),
                                     tf32_rna(a.z), tf32_rna(a.w));
        *hp = h;
        *reinterpret_cast<float4*>(st + T::kALo + off) = make_float4(
            tf32_rna(__fsub_rn(a.x, h.x)), tf32_rna(__fsub_rn(a.y, h.y)),
            tf32_rna(__fsub_rn(a.z, h.z)), tf32_rna(__fsub_rn(a.w, h.w)));
      }
    }
    fence_async_smem();
  };

  float acc[BN / 2], tot[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = tot[i] = 0.0f;

#pragma unroll
  for (int j = 0; j < T::kRing - 1; ++j) {
    if (j < nsteps) issue(j);
    cp_async_commit();
  }
  cp_async_wait<T::kRing - 2>();
  prepare(0);
  for (int kt = 0; kt < nsteps; ++kt) {
    // every thread's step kt is prepared, and every warpgroup finished
    // the MMAs of step kt - 1, whose slot the loads below reuse
    __syncthreads();
    const uint32_t st = smem_addr(smem) + (kt % T::kRing) * T::kStage;
    const uint32_t ah = st + wg * kWgRows * kRowBytes;
    const bool split = kind_of(kt) == kAF32;
    wgmma_fence();
    // the step's small products first, lo_a . hi_b and hi_a . lo_b of
    // every k8, then its four hi_a . hi_b: each sum the tensor cores
    // truncate adds a bias toward zero in proportion to the partial sum,
    // so the chain over large partial sums stays four long
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      if (split)
        wgmma_tf32<BN>(acc, desc_kmajor(ah + T::kALo, kk * 32),
                       desc_kmajor(st + T::kBHi, kk * 32), kk > 0);
      wgmma_tf32<BN>(acc, desc_kmajor(ah, kk * 32),
                     desc_kmajor(st + T::kBLo, kk * 32), kk > 0 || split);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
      wgmma_tf32<BN>(acc, desc_kmajor(ah, kk * 32),
                     desc_kmajor(st + T::kBHi, kk * 32), 1);
    wgmma_commit();
    // while the MMAs run: the loads of step kt + kRing - 1, then step
    // kt + 1's split once its loads have landed (issued a step ago, or
    // just now with a two-stage ring)
    if (kt + T::kRing - 1 < nsteps) issue(kt + T::kRing - 1);
    cp_async_commit();
    if (kt + 1 < nsteps) {
      cp_async_wait<T::kRing - 2>();
      prepare(kt + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) tot[i] = tot[i] + acc[i];
  }

  // epilogue: residual tile in (every copy in flight at once), output
  // tile out, both through the ring
  cp_async_wait<0>();
  __syncthreads();
  const int oes = mode == kQ8Int8F32 ? 1 : 4;
  const int ldo = BN * oes + 16, ldr = BN * res_es + 16;
  uint8_t* so = smem;
  uint8_t* sr = smem + kBM * (BN * 4 + 16);
  if (res != nullptr) {
    const int cpr = BN * res_es / 16;
    for (int e = tid; e < kBM * cpr; e += kThreads) {
      const int row = e / cpr, ch = e - row * cpr;
      const bool ok = m0 + row < M;
      cp_async16(smem_addr(sr + row * ldr + ch * 16),
                 ok ? static_cast<const char*>(res)
                      + ((m0 + row) * Cout + n0) * res_es + ch * 16
                    : res, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const bool q8 = mode == kQ8Int8F32 || mode == kQ8F32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = frag_row(tid, h), col = frag_col(tid, j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = col + e;
        float y = tot[4 * j + 2 * h + e] + sb[n];
        if (mode != kReluF32) {
          if (bias2 != nullptr) y = y + sb2[n];
          if (res != nullptr) {
            const float xv = res_i8
                ? (float)*reinterpret_cast<const int8_t*>(sr + row * ldr + n)
                : *reinterpret_cast<const float*>(sr + row * ldr + 4 * n);
            y = y + xv * r;
          }
        }
        y = q8 ? fminf(fmaxf(rintf(y), 0.0f), 127.0f) : fmaxf(y, 0.0f);
        if (oes == 1)
          *reinterpret_cast<int8_t*>(so + row * ldo + n) = (int8_t)(int)y;
        else
          *reinterpret_cast<float*>(so + row * ldo + 4 * n) = y;
      }
    }
  __syncthreads();
  const int cpo = BN * oes / 16;
  for (int e = tid; e < kBM * cpo; e += kThreads) {
    const int row = e / cpo, ch = e - row * cpo;
    if (m0 + row < M)
      *reinterpret_cast<int4*>(static_cast<char*>(out)
                               + ((m0 + row) * Cout + n0) * oes + ch * 16) =
          *reinterpret_cast<const int4*>(so + row * ldo + ch * 16);
  }
}

template <int BN, int KIND>
int launch(const SegF& s0, const SegF& s1, int M, int Ho, int Wo, int Cout,
           const float* bias, const float* bias2, const void* res,
           int res_i8, float r, void* out, int mode, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
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

// out[m, n] = epilogue(sum_k A[m, k] * W[n, k]) over the output grid
// (N, Ho, Wo), f32 sums of f32 operands (3xTF32; an int8 A segment
// widened to f32 exactly); the K axis is segment 0 then segment 1 (absent
// when its pointer is null), each with its own split K-major weights
// (2, Cout, K) = [hi, lo] (ops/gemm_layout.split_kmajor_f32). A segment's
// kind: 0 f32, 1 int8. The residual is f32 or (res_i8) int8; out is int8
// in kQ8Int8F32, else f32. bn: the CTA's output columns (64 or 128, a
// divisor of Cout; ops/gemm_layout.tile_n). Requires every segment's C %
// 32 == 0, Cout % bn == 0, in the K-packed projection segment 0's K % 32
// == 0 (ops/gemm_layout.F32_K_STEP), and 16-byte aligned pointers
// (checked by the Python wrapper).
extern "C" int io_conv_gemm_f32(
    const void* a0, const void* w0, int a0_kind, int a0_C, int a0_H,
    int a0_W, int a0_stride, int a0_ksize,
    const void* a1, const void* w1, int a1_kind, int a1_C, int a1_H,
    int a1_W, int a1_stride, int a1_ksize,
    int N, int Ho, int Wo, int Cout, int bn, const void* bias,
    const void* bias2, const void* res, int res_i8, float r, void* out,
    int mode, void* stream) {
  SegF s0{a0, (const float*)w0, a0_kind, a0_C, a0_H, a0_W, a0_stride,
          a0_ksize, a0_ksize * a0_ksize * a0_C};
  SegF s1{a1, (const float*)w1, a1_kind, a1_C, a1_H, a1_W, a1_stride,
          a1_ksize, a1 ? a1_ksize * a1_ksize * a1_C : 0};
  const int64_t M = (int64_t)N * Ho * Wo;
  if (M >= ((int64_t)1 << 31) || Cout % bn || mode < kReluF32
      || mode > kQ8F32 || a0_kind < kAF32 || a0_kind > kAInt8
      || a1_kind < kAF32 || a1_kind > kAInt8 || a0_C % kBK
      || (a1 != nullptr && a1_C % kBK)
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
