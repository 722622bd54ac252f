// ResNet bottlenecks as implicit-GEMM convolutions on Hopper's bf16
// tensor cores (wgmma m64nNk16, f32 accumulation), NHWC.
//
// Boundary-int8 ("v2") blocks replace these TPU kernels of
// instaorder_tpu/ops/pallas_blocks.py (ops/bottleneck_kernels.py):
//   fused_bottleneck_i8v2_hwnc          stride 1, identity residual r*x
//   fused_bottleneck_down_s2_i8v2_hwnc  stride 2, projection residual
//   fused_bottleneck_i8v2_hwnc_stage    layer1 (or an identity run)
//   fused_bottleneck_i8v2_hwncp_stage, fused_bottleneck_down_i8v2_hwnc,
//   fused_bottleneck_i8v2, fused_bottleneck_down_i8v2
// and the bf16 blocks (ops/bottleneck_bf16_kernels.py):
//   fused_bottleneck, fused_bottleneck_down, fused_bottleneck_stage,
//   fused_bottleneck_stage_stream, fused_bottleneck_hwnc
// A block runs as three launches of the one GEMM kernel below
// (ops/bottleneck_kernels.py sequences them):
//   h1  = bf16(relu(x . w1 + b1))                      1x1
//   h2  = bf16(relu(conv3x3_s(h1) . w2 + b2))          3x3, pad 1
//   v2:   out = clip(rint(h2 . w3 + b3 + (r*x | + bd)), 0, 127)
//   bf16: out = bf16(relu(h2 . w3 + b3 + (x | + bd)))
// with the projection K-packed as one f32 sum [h2 | x_s] . [[w3],[wd]]
// like the TPU kernel. h1 and h2 live in bf16 device scratch; the v2
// output is int8 or bf16 holding the integers 0..127.
//
// Bound on the H100: tensor-core operations. At the serving batch an
// identity block at 64x64 does ~285 M MAC per image against ~1.5 MB of
// activations, far above the 295 flop/byte ridge. The design
// (csrc/conv_gemm.cuh) feeds the tensor cores at that rate: 128 x 128
// output tiles (128 x 64 where Cout = 64) from two warpgroups on wgmma;
// a three-stage cp.async ring that gathers the im2col rows and the
// weights two K steps ahead of the MMAs, with no register round trip and
// no division in the K loop, two CTAs to an SM; the epilogue in
// registers, the residual and the output staged through the idle ring
// for 16-byte global accesses. int8 activation segments (a v2 block's x
// in conv1 and in the projection) are copied raw into the first half of
// each A row and widened to bf16 in place by the warp that copied them
// (exact for -128..127). The weights stay
// (K, Cout) row-major: wgmma reads them MN-major. The arithmetic
// contract is kept exactly: bf16 operands, f32 sums, one bf16 rounding
// per stage, bias and residual added in f32 in the reference order
// (built with -fmad=false).

#include "conv_gemm.cuh"

namespace {

using namespace convgemm;

// One operand segment of the GEMM's K axis: an NHWC activation read as
// a 1x1 (stride s) or 3x3 (stride s, pad 1) im2col view. K = taps * C.
struct Seg {
  const void* ptr;
  const __nv_bfloat16* w;   // this segment's (K, Cout) weight rows
  int is_i8, C, H, W, stride, ksize, K;
};

// kResReluBf16: the bf16 block output, bf16(relu(acc + b (+ b2 | + r*x)))
enum Mode { kReluBf16 = 0, kQ8Int8 = 1, kQ8Bf16 = 2, kResReluBf16 = 3 };
// what the A operand is: one 1x1 segment, one 3x3 segment, or the
// K-packed projection (two 1x1 segments); a distinct kernel name each
enum Kind { k1x1 = 0, k3x3 = 1, kProj = 2 };

constexpr int kBK = 64;   // bf16 elements of a K step (128 bytes)

template <int BN>
struct Tile {
  static constexpr int kA = kBM * kRowBytes;       // 128 rows x 64 bf16
  static constexpr int kAtom = kBK * kRowBytes;    // 64 K rows x 64 cols
  static constexpr int kB = (BN / 64) * kAtom;     // MN-major weights
  static constexpr int kStage = kA + kB;
  static constexpr int kSmem = kStages * kStage + 2 * BN * 4 + 1024;
  static_assert(kSmem <= 232448, "ring exceeds shared memory");
};

template <int BN, int KIND>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_kernel(Seg s0, Seg s1, int M, int Ho, int Wo, int Cout,
                 const float* __restrict__ bias,
                 const float* __restrict__ bias2,
                 const void* __restrict__ res, int res_i8, float r,
                 void* __restrict__ out, int mode) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* sb = reinterpret_cast<float*>(smem + kStages * T::kStage);
  float* sb2 = sb + BN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ntiles = Cout / BN;
  const int n0 = (int)(blockIdx.x % ntiles) * BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ntiles) * kBM;
  for (int i = tid; i < BN; i += kThreads) {
    sb[i] = bias[n0 + i];
    sb2[i] = bias2 != nullptr ? bias2[n0 + i] : 0.0f;
  }
  const int res_es = res_i8 ? 1 : 2;
  if (res != nullptr)
    prefetch_rows_l2(static_cast<const char*>(res) + (m0 * Cout + n0) * res_es,
                     (int64_t)Cout * res_es, M - m0 < kBM ? (int)(M - m0) : kBM,
                     BN * res_es, tid);

  // the loader: 16-byte chunk q of rows tid / 8 + 32 i of each K step
  // (an int8 segment: raw chunk q / 2 of rows i = q % 2, q % 2 + 2, at
  // byte 16 * (q / 2) of the row, unswizzled; a row's four raw chunks
  // come from four threads of one warp)
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
    const Seg s = sg ? s1 : s0;
    const int k0 = (sg ? j - t0 : j) * kBK;
    if (sg != lseg) {
      g.start(s.ptr, s.is_i8 ? 1 : 2, s.C, s.H, s.W, s.stride, s.ksize,
              s.K, rn, rho, rwo, rok, s.is_i8 ? 16 * (q >> 1) : 8 * q);
      lseg = sg;
    } else {
      g.advance(kBK);
    }
    uint8_t* st = smem + (j % kStages) * T::kStage;
    if (s.is_i8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (q & 1) + 2 * h, row = (tid >> 3) + 32 * i;
        bool ok;
        const void* src = g.src(i, ok);
        cp_async16(smem_addr(st + row * kRowBytes + (q >> 1) * 16), src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok;
        const void* src = g.src(i, ok);
        cp_async16(smem_addr(st) + swz128((tid >> 3) + 32 * i, q), src, ok);
      }
    }
    // weights: kBK rows of BN columns, 64-column atoms
    constexpr int kCpr = BN / 8, kRpp = kThreads / kCpr;
    const int cq = tid % kCpr;
#pragma unroll
    for (int p = 0; p < kBK / kRpp; ++p) {
      const int kr = tid / kCpr + kRpp * p;
      const bool ok = k0 + kr < s.K;
      const __nv_bfloat16* src =
          ok ? s.w + (int64_t)(k0 + kr) * Cout + n0 + cq * 8 : s.w;
      cp_async16(smem_addr(st + T::kA) + (cq >> 3) * T::kAtom
                     + swz128(kr, cq & 7), src, ok);
    }
  };

  // an int8 segment's raw chunks -> bf16 in the swizzled A rows they
  // lie in: the warp reads all its raw chunks, then writes (each thread
  // widens the chunks it copied)
  auto widen = [&](int kt) {
    uint8_t* st = smem + (kt % kStages) * T::kStage;
    int4 v[2];
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (tid >> 3) + 32 * ((q & 1) + 2 * h);
      v[h] = *reinterpret_cast<const int4*>(st + row * kRowBytes
                                            + (q >> 1) * 16);
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (tid >> 3) + 32 * ((q & 1) + 2 * h);
      const int8_t* b = reinterpret_cast<const int8_t*>(&v[h]);
      uint32_t o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const __nv_bfloat162 p = __floats2bfloat162_rn((float)b[2 * e],
                                                       (float)b[2 * e + 1]);
        o[e] = *reinterpret_cast<const uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(st + swz128(row, 2 * (q >> 1))) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(st + swz128(row, 2 * (q >> 1) + 1)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nsteps) issue(j);
    cp_async_commit();
  }
  for (int kt = 0; kt < nsteps; ++kt) {
    cp_async_wait<kStages - 2>();
    if (kt < t0 ? s0.is_i8 : s1.is_i8) widen(kt);
    fence_async_smem();
    __syncthreads();
    const uint32_t st = smem_addr(smem) + (kt % kStages) * T::kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_bf16<BN>(acc, desc_kmajor(st + wg * kWgRows * kRowBytes, kk * 32),
                     desc_mnmajor(st + T::kA, kk * 16, T::kAtom));
    wgmma_commit();
    // while the MMAs run: the loads of step kt + 2 into the slot of step
    // kt - 1, whose MMAs every warpgroup finished before the barrier
    if (kt + kStages - 1 < nsteps) issue(kt + kStages - 1);
    cp_async_commit();
    wgmma_wait<0>();
  }

  // epilogue: residual tile in, output tile out, both through the ring
  cp_async_wait<0>();
  __syncthreads();
  const int oes = mode == kQ8Int8 ? 1 : 2;
  const int ldo = BN * oes + 16, ldr = BN * res_es + 16;
  uint8_t* so = smem;
  uint8_t* sr = smem + kBM * (BN * 2 + 16);
  if (res != nullptr) {
    const int cpr = BN * res_es / 16;
    for (int e = tid; e < kBM * cpr; e += kThreads) {
      const int row = e / cpr, ch = e - row * cpr;
      if (m0 + row < M)
        *reinterpret_cast<int4*>(sr + row * ldr + ch * 16) =
            *reinterpret_cast<const int4*>(
                static_cast<const char*>(res)
                + ((m0 + row) * Cout + n0) * res_es + ch * 16);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = frag_row(tid, h), col = frag_col(tid, j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = col + e;
        float y = acc[4 * j + 2 * h + e] + sb[n];
        uint8_t* o = so + row * ldo + n * oes;
        if (mode == kReluBf16) {
          *reinterpret_cast<__nv_bfloat16*>(o) =
              __float2bfloat16_rn(fmaxf(y, 0.0f));
          continue;
        }
        if (bias2 != nullptr) y = y + sb2[n];
        if (res != nullptr) {
          const float xv = res_i8
              ? (float)*reinterpret_cast<const int8_t*>(sr + row * ldr + n)
              : __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                    sr + row * ldr + 2 * n));
          y = y + xv * r;
        }
        if (mode == kResReluBf16) {
          *reinterpret_cast<__nv_bfloat16*>(o) =
              __float2bfloat16_rn(fmaxf(y, 0.0f));
          continue;
        }
        const float qv = fminf(fmaxf(rintf(y), 0.0f), 127.0f);
        if (mode == kQ8Int8)
          *reinterpret_cast<int8_t*>(o) = (int8_t)(int)qv;
        else
          *reinterpret_cast<__nv_bfloat16*>(o) = __float2bfloat16_rn(qv);
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
int launch(const Seg& s0, const Seg& s1, int M, int Ho, int Wo, int Cout,
           const float* bias, const float* bias2, const void* res,
           int res_i8, float r, void* out, int mode, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const int e = allow_smem(conv_gemm_kernel<BN, KIND>, Tile<BN>::kSmem,
                           smem_set);
  if (e) return e;
  const unsigned grid = (unsigned)(((int64_t)M + kBM - 1) / kBM * (Cout / BN));
  conv_gemm_kernel<BN, KIND><<<grid, kThreads, Tile<BN>::kSmem, stream>>>(
      s0, s1, M, Ho, Wo, Cout, bias, bias2, res, res_i8, r, out, mode);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_kind(const Seg& s0, const Seg& s1, int M, int Ho, int Wo,
                int Cout, const float* bias, const float* bias2,
                const void* res, int res_i8, float r, void* out, int mode,
                cudaStream_t stream) {
  if (s1.ptr != nullptr)
    return launch<BN, kProj>(s0, s1, M, Ho, Wo, Cout, bias, bias2, res,
                             res_i8, r, out, mode, stream);
  if (s0.ksize == 3)
    return launch<BN, k3x3>(s0, s1, M, Ho, Wo, Cout, bias, bias2, res,
                            res_i8, r, out, mode, stream);
  return launch<BN, k1x1>(s0, s1, M, Ho, Wo, Cout, bias, bias2, res,
                          res_i8, r, out, mode, stream);
}

}  // namespace

// out[m, n] = epilogue(sum_k A[m, k] * W[k, n]) over the output grid
// (N, Ho, Wo); the K axis is segment 0 then segment 1 (absent when its
// pointer is null), each with its own weight rows. bn: the CTA's output
// columns (64 or 128, a divisor of Cout; ops/gemm_layout.tile_n).
// Requires every segment's C % 32 == 0, Cout % bn == 0, in the K-packed
// projection segment 0's K % 64 == 0, and 16-byte aligned pointers
// (checked by the Python wrapper).
extern "C" int io_conv_gemm(
    const void* a0, const void* w0, int a0_i8, int a0_C, int a0_H, int a0_W,
    int a0_stride, int a0_ksize,
    const void* a1, const void* w1, int a1_i8, int a1_C, int a1_H, int a1_W,
    int a1_stride, int a1_ksize,
    int N, int Ho, int Wo, int Cout, int bn, const void* bias,
    const void* bias2, const void* res, int res_i8, float r, void* out,
    int mode, void* stream) {
  Seg s0{a0, (const __nv_bfloat16*)w0, a0_i8, a0_C, a0_H, a0_W, a0_stride,
         a0_ksize, a0_ksize * a0_ksize * a0_C};
  Seg s1{a1, (const __nv_bfloat16*)w1, a1_i8, a1_C, a1_H, a1_W, a1_stride,
         a1_ksize, a1 ? a1_ksize * a1_ksize * a1_C : 0};
  const int64_t M = (int64_t)N * Ho * Wo;
  if (M >= ((int64_t)1 << 31) || Cout % bn
      || (a1 != nullptr && (s0.K % kBK || a0_ksize != 1 || a1_ksize != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 128)
    return launch_kind<128>(s0, s1, (int)M, Ho, Wo, Cout, (const float*)bias,
                            (const float*)bias2, res, res_i8, r, out, mode,
                            st);
  if (bn == 64)
    return launch_kind<64>(s0, s1, (int)M, Ho, Wo, Cout, (const float*)bias,
                           (const float*)bias2, res, res_i8, r, out, mode,
                           st);
  return (int)cudaErrorInvalidValue;
}
