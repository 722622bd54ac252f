// Fused ResNet stem, NHWC: conv 7x7 / stride 2 / pad 3, then max-pool
// 3x3 / stride 2 / pad 1, as one implicit GEMM on Hopper's tensor cores
// (wgmma) with the pool in its epilogue (and, at f32, on the CUDA cores:
// `stem_f32_kernel`, described at its definition below). Two kernels
// share the design:
//   stem_kernel<COUT, Q8>   bf16 operands, f32 sums: + f32 bias, relu,
//                           one bf16 rounding, the pool, stored as bf16
//                           or (q8) as the one-sided int8
//                           clip(rint(v), 0, 127);
//   stem_s8_kernel<COUT>    int8 operands, s32 sums: the requant
//                           clip(rint(f32(acc)*m + b), 0, 127) per output
//                           channel, the pool on int8.
//
// Replaces instaorder_tpu/ops/pallas_blocks.py `fused_stem` (kernel body
// `_stem_v2_kernel`, with its q8 option) and `fused_stem_int8` (kernel
// body `_stem_v2_int8_kernel`). What the TPU kernels keep out of device
// memory carries over: the (N, H/2, W/2, Cout) conv output never leaves
// the SM.
//
// Bound on the H100: tensor-core operations. Per 256^2 image at Cout 128
// (the double-width siamese stem) the conv is 128^2 * 245 * 128 MAC
// (1.03 GFLOP) against ~1.7 MB of input and output, above the 295
// flop/byte ridge.
//
// Design.
//  - The 7x7/2 conv is a 4x4 stride-1 conv over the 2x2 space-to-depth
//    input (models/folding `s2d_conv1_w`): 4C <= 20 channels per s2d
//    pixel, padded to 24 bf16 (three 16-byte chunks) or 32 int8 (two).
//    `stem_pack_kernel` writes that input once per call, chunk-planar:
//    (N, H/2 + 3, J, W/2 + 3, 16 bytes), J = 3 | 2 (the analogue of the
//    TPU kernel's `_stem_pack`, which also runs outside its kernel).
//  - A conv row of 128 pixels is the GEMM's M tile (one 64-row wgmma per
//    warpgroup). Its A operand is never gathered: in the planar layout,
//    chunk (dy, dx, j) of pixels c..c+7 is 128 contiguous bytes of s2d
//    row r + dy, plane j, i.e. a wgmma core matrix of a K-major operand
//    without swizzle. A k-step pairs the taps dx and dx + 1, whose core
//    matrices lie 16 bytes apart (LBO = 16, SBO = 128): 8 * J wgmma per
//    row read the s2d rows in place (K = 16 taps * 24 = 384 bf16, or
//    16 * 32 = 512 int8; the taps and channels outside the 7x7 x C
//    weights carry zero weights, so they add exact zeros).
//  - The s2d rows reach shared memory by 16-byte cp.async, a whole row
//    (J planes x 131 pixels) at a time, into a ring of kSlots rows that
//    runs kAhead rows ahead of the MMAs: a conv row reads four s2d rows
//    and brings in one new one.
//  - The weights (K x Cout; the bf16 ones (K, Cout) read MN-major, the
//    int8 ones (Cout, K) since int8 wgmma reads B only K-major; both laid
//    out once when the model is built, ops/stem_kernels
//    `stem_kernel_weights`) and the bias (and multiplier) are loaded once
//    per CTA. CTAs are persistent and walk work items of (image, 8
//    pooled rows, up to 64 pooled columns): 17 conv rows for 16, a 6%
//    recompute share at 256^2 (the first conv row of a strip is the
//    last of the one above).
//  - Per conv row: the MMAs are issued asynchronously, then, while they
//    run, the pool consumes the previous conv row; then the epilogue
//    takes the accumulators through the bias and relu (or the requant)
//    into a one-row conv buffer in shared memory. The pool is separable:
//    each thread owns the same (pooled column, 16-byte channel chunk)
//    items on every row, takes the horizontal 3/2 max from the conv
//    buffer with 16-byte loads, and keeps the running vertical max in
//    registers: an even conv row 2i joins pooled row i, an odd row 2i+1
//    finishes pooled row i and opens row i + 1. Conv pixels off the
//    image are simply not read: every value is >= 0 after the relu or
//    the clip and every pool window holds a real pixel, so a zero start
//    equals the reference's padding.
//  - bf16: the bias is added in f32 before the one rounding, as in
//    `fused_stem` (not the cuDNN route's conv-then-add). int8: s32 sums
//    are exact and the requant is the reference's f32 mul then add,
//    unfused (built with -fmad=false), rounded half to even, so the int8
//    output equals the plain version bit for bit.

#include "conv_gemm.cuh"

#include <type_traits>

namespace {

using namespace convgemm;

constexpr int kTM = 128;               // conv pixels of a tile row (M)
constexpr int kCols = kTM + 3;         // s2d pixels a tile row reads
constexpr int kPlane = kCols * 16;     // one 16-byte plane of them
constexpr int kAhead = 2;              // s2d rows in flight past a row's 4
constexpr int kSlots = 5 + kAhead;     // ring slots (s2d rows)
constexpr int kRP = 8;                 // pooled rows of a work item
constexpr int kTP = 64;                // pooled columns of a first tile

template <bool S8, int COUT>
struct Stem {
  static constexpr int kEs = S8 ? 1 : 2;
  static constexpr int kJ = S8 ? 2 : 3;            // chunks of an s2d pixel
  static constexpr int kK = 16 * kJ * 16 / kEs;    // 16 taps x 24 | 32
  static constexpr int kW = kK * COUT * kEs;       // weight bytes
  static constexpr int kSlot = kJ * kPlane;
  static constexpr int kLdc = COUT * kEs + 16;     // conv buffer row
  static constexpr int kQC = COUT * kEs / 16;      // chunks of a conv pixel
  static constexpr int kNI = kTP * kQC / kThreads; // pool items a thread
  static constexpr int kRing = kW;
  static constexpr int kConv = kRing + kSlots * kSlot;
  static constexpr int kVec = kConv + kTM * kLdc;
  static constexpr int kSmem = kVec + 2 * COUT * 4 + 1024;
  // two CTAs an SM where the shared memory allows (228 KB, 1 KB each
  // reserved)
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
  static_assert(kW % 1024 == 0, "weights keep the swizzle alignment");
  static_assert(kNI * kThreads == kTP * kQC, "pool items");
  static_assert(kSmem <= 232448, "stem tile exceeds shared memory");
};

// elementwise max of two 16-byte vectors of bf16 (or of int8) values
template <bool S8>
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  if constexpr (S8) {
    return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                      __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
  } else {
    uint4 r;
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
    __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) pr[e] = __hmax2(pa[e], pb[e]);
    return r;
  }
}

template <bool S8, int COUT, bool Q8>
__device__ __forceinline__ void stem_body(
    const uint8_t* __restrict__ xs, const void* __restrict__ wk,
    const float* __restrict__ mul, const float* __restrict__ bias,
    void* __restrict__ out, int N, int Hc, int Wc, int Ho, int Wo,
    int nstrips, int ntiles) {
  using S = Stem<S8, COUT>;
  using Acc = std::conditional_t<S8, int, float>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* conv = smem + S::kConv;
  float* sb = reinterpret_cast<float*>(smem + S::kVec);
  float* sm = sb + COUT;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int Ws = Wc + 3;
  const int64_t row_bytes = (int64_t)S::kJ * Ws * 16;
  const uint32_t sW = smem_addr(smem), sRing = sW + S::kRing;

  // 1. once per CTA: the weights (the first cp.async group), the bias
  //    and the multiplier
  const uint8_t* wsrc = static_cast<const uint8_t*>(wk);
  for (int e = tid; e < S::kW / 16; e += kThreads) {
    uint32_t dst;
    if constexpr (S8) {
      // (COUT, K) rows, K-major: 128-byte K steps of COUT rows
      const int nr = e / (S::kK / 16), c = e % (S::kK / 16);
      dst = sW + (c >> 3) * COUT * kRowBytes + swz128(nr, c & 7);
    } else {
      // (K, COUT) rows, MN-major: 64-row K blocks of 64-column atoms
      const int kr = e / (COUT / 8), cq = e % (COUT / 8);
      dst = sW + (kr >> 6) * (COUT / 64) * 8192 + (cq >> 3) * 8192
            + swz128(kr & 63, cq & 7);
    }
    cp_async16(dst, wsrc + (int64_t)e * 16, true);
  }
  cp_async_commit();
  for (int i = tid; i < COUT; i += kThreads) {
    sb[i] = bias[i];
    if (S8) sm[i] = mul[i];
  }

  const int items = N * nstrips * ntiles;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int t = item % ntiles;
    const int s = (item / ntiles) % nstrips;
    const int n = item / (ntiles * nstrips);
    const int i0 = s * kRP, i1 = min(Ho, i0 + kRP);
    const int j0 = t == 0 ? 0 : kTP + (t - 1) * (kTP - 1);
    const int j1 = min(Wo, t == 0 ? kTP : j0 + kTP - 1);
    const int cs = t == 0 ? 0 : 2 * j0 - 1;      // first conv column
    const int rlo = max(0, 2 * i0 - 1), rhi = min(Hc - 1, 2 * i1 - 1);
    const uint8_t* xn = xs + (int64_t)n * (Hc + 3) * row_bytes;

    // s2d row u (pixels cs .. cs + 130 of each plane; zero past the
    // image) into its ring slot; rows past the item's last are skipped
    auto load = [&](int u) {
      if (u > rhi + 3) return;
      const uint32_t dst = sRing + (u % kSlots) * S::kSlot;
      const uint8_t* row = xn + u * row_bytes;
      for (int e = tid; e < S::kJ * kCols; e += kThreads) {
        const int j = e / kCols, v = e - j * kCols;
        const bool ok = cs + v < Ws;
        cp_async16(dst + j * kPlane + v * 16,
                   ok ? row + ((int64_t)j * Ws + cs + v) * 16 : row, ok);
      }
    };

    // pooled output (image n, row i, column j, chunk q)
    auto store = [&](int i, int j, int q, uint4 v) {
      const int64_t px = ((int64_t)n * Ho + i) * Wo + j;
      if constexpr (S8) {
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + px * COUT
                                  + q * 16) = v;
      } else if constexpr (Q8) {
        const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
        uint32_t o[2] = {0, 0};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int qv = (int)fminf(fmaxf(rintf(__bfloat162float(b[e])),
                                          0.0f), 127.0f);
          o[e >> 2] |= (uint32_t)qv << (8 * (e & 3));
        }
        *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + px * COUT
                                  + q * 8) = make_uint2(o[0], o[1]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out)
                                  + px * COUT + q * 8) = v;
      }
    };

    uint4 V[S::kNI];
#pragma unroll
    for (int k = 0; k < S::kNI; ++k) V[k] = make_uint4(0, 0, 0, 0);

    // the pool's step for conv row r, which the conv buffer holds
    auto pool = [&](int r) {
#pragma unroll
      for (int k = 0; k < S::kNI; ++k) {
        const int it = tid + k * kThreads, jj = it / S::kQC;
        const int q = it - jj * S::kQC, j = j0 + jj;
        if (j >= j1) continue;
        const int clo = max(2 * j - 1, 0) - cs;
        const int chi = min(2 * j + 1, Wc - 1) - cs;
        const uint8_t* p = conv + q * 16;
        uint4 h = *reinterpret_cast<const uint4*>(p + clo * S::kLdc);
        for (int c = clo + 1; c <= chi; ++c)
          h = vmax<S8>(h, *reinterpret_cast<const uint4*>(p + c * S::kLdc));
        if ((r & 1) == 0) {
          V[k] = vmax<S8>(V[k], h);
          if (r + 1 == Hc) store(r >> 1, j, q, V[k]);
        } else {
          if ((r >> 1) >= i0) store(r >> 1, j, q, vmax<S8>(V[k], h));
          V[k] = h;
        }
      }
    };

    for (int d = 0; d < 4 + kAhead; ++d) {
      load(rlo + d);
      cp_async_commit();
    }
    Acc acc[COUT / 2];
    for (int r = rlo; r <= rhi; ++r) {
      // s2d rows r .. r + 3 have landed (and the weights); the conv
      // buffer holds row r - 1
      cp_async_wait<kAhead>();
      fence_async_smem();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < COUT / 2; ++i) acc[i] = 0;
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 4; ++dy) {
        const uint32_t a = sRing + ((r + dy) % kSlots) * S::kSlot
                           + wg * kWgRows * 16;
#pragma unroll
        for (int dxp = 0; dxp < 2; ++dxp)
#pragma unroll
          for (int j = 0; j < S::kJ; ++j) {
            const int i = (dy * 2 + dxp) * S::kJ + j;
            const uint64_t da =
                desc_kmajor_noswz(a + j * kPlane + dxp * 32, 16, 128);
            if constexpr (S8)
              wgmma_s8<COUT>(acc, da, desc_kmajor(
                  sW + (i >> 2) * COUT * kRowBytes, (i & 3) * 32));
            else
              wgmma_bf16<COUT>(acc, da, desc_mnmajor(
                  sW + (i >> 2) * (COUT / 64) * 8192, (i & 3) * 16, 8192));
          }
      }
      wgmma_commit();
      // while the MMAs run: the copies of s2d row r + 4 + kAhead, into
      // the slot of s2d row r - 1 (read last by conv row r - 1, whose
      // MMAs every warpgroup finished before the barrier), and the pool
      // of conv row r - 1
      load(r + 4 + kAhead);
      cp_async_commit();
      if (r > rlo) pool(r - 1);
      wgmma_wait<0>();
      __syncthreads();
      // epilogue: conv row r into the conv buffer
#pragma unroll
      for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = frag_row(tid, h), col = frag_col(tid, j);
          const Acc a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
          uint8_t* o = conv + row * S::kLdc + col * S::kEs;
          if constexpr (S8) {
            auto rq8 = [&](int a, int c) {
              return (uint32_t)(int)fminf(fmaxf(rintf(__fadd_rn(
                  __fmul_rn((float)a, sm[c]), sb[c])), 0.0f), 127.0f);
            };
            *reinterpret_cast<uint16_t*>(o) =
                (uint16_t)(rq8(a0, col) | (rq8(a1, col + 1) << 8));
          } else {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(
                fmaxf(a0 + sb[col], 0.0f), fmaxf(a1 + sb[col + 1], 0.0f));
          }
        }
    }
    __syncthreads();
    pool(rhi);
  }
  cp_async_wait<0>();
}

template <int COUT, bool Q8>
__global__ void __launch_bounds__(kThreads, (Stem<false, COUT>::kMinBlocks))
stem_kernel(const uint8_t* __restrict__ xs, const void* __restrict__ wk,
            const float* __restrict__ bias, void* __restrict__ out, int N,
            int Hc, int Wc, int Ho, int Wo, int nstrips, int ntiles) {
  stem_body<false, COUT, Q8>(xs, wk, nullptr, bias, out, N, Hc, Wc, Ho, Wo,
                             nstrips, ntiles);
}

template <int COUT>
__global__ void __launch_bounds__(kThreads, (Stem<true, COUT>::kMinBlocks))
stem_s8_kernel(const uint8_t* __restrict__ xs, const void* __restrict__ wk,
               const float* __restrict__ mul, const float* __restrict__ bias,
               void* __restrict__ out, int N, int Hc, int Wc, int Ho, int Wo,
               int nstrips, int ntiles) {
  stem_body<true, COUT, false>(xs, wk, mul, bias, out, N, Hc, Wc, Ho, Wo,
                               nstrips, ntiles);
}

// The padded 2x2 space-to-depth input, chunk-planar: 16-byte chunk (n, u,
// j, v) holds s2d channels 16/es * j .. of pixel (u, v), channel (sy, sx,
// c) = x[n, 2u + sy - 4, 2v + sx - 4, c] (zero off the image and past
// 4C). One thread makes one s2d pixel: channels (sy, 0..1, 0..C-1) are
// the 2C contiguous elements of input row 2u + sy - 4 at column 2v - 4,
// which lie wholly on or off the image (W is even), read as C words of
// two elements (2C * es bytes apart, so aligned); then the pixel's J
// chunks go to their planes, neighbouring threads on neighbouring
// chunks. T: the element's bits (uint16_t for bf16, uint8_t for int8).
template <typename T, int C>
__global__ void __launch_bounds__(256)
stem_pack_kernel(const T* __restrict__ x, uint8_t* __restrict__ xs, int N,
                 int H, int W, int Hs, int Ws) {
  using Word = std::conditional_t<sizeof(T) == 2, uint32_t, uint16_t>;
  constexpr int J = sizeof(T) == 2 ? 3 : 2;
  constexpr int kWords = J * 16 / sizeof(Word);
  const int64_t total = (int64_t)N * Hs * Ws;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int v = (int)(idx % Ws);
    const int64_t nu = idx / Ws;
    const int u = (int)(nu % Hs), n = (int)(nu / Hs);
    alignas(16) Word buf[kWords];
#pragma unroll
    for (int e = 0; e < kWords; ++e) buf[e] = 0;
    const int xx = 2 * v - 4;
#pragma unroll
    for (int sy = 0; sy < 2; ++sy) {
      const int y = 2 * u + sy - 4;
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        const Word* src = reinterpret_cast<const Word*>(
            x + (((int64_t)n * H + y) * W + xx) * C);
#pragma unroll
        for (int c = 0; c < C; ++c) buf[sy * C + c] = src[c];
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(xs) + nu * J * Ws + v;
#pragma unroll
    for (int j = 0; j < J; ++j)
      dst[(int64_t)j * Ws] = reinterpret_cast<const uint4*>(buf)[j];
  }
}

template <typename T, int C>
int pack(const void* x, void* xs, int N, int H, int W, int Hs, int Ws,
         cudaStream_t st) {
  const int64_t blocks = ((int64_t)N * Hs * Ws + 255) / 256;
  stem_pack_kernel<T, C><<<(unsigned)(blocks < (1 << 20) ? blocks : 1 << 20),
                           256, 0, st>>>((const T*)x, (uint8_t*)xs, N, H, W,
                                         Hs, Ws);
  return (int)cudaGetLastError();
}

template <typename T>
int pack_c(const void* x, void* xs, int N, int H, int W, int C, int Hs,
           int Ws, cudaStream_t st) {
  switch (C) {
    case 1: return pack<T, 1>(x, xs, N, H, W, Hs, Ws, st);
    case 2: return pack<T, 2>(x, xs, N, H, W, Hs, Ws, st);
    case 3: return pack<T, 3>(x, xs, N, H, W, Hs, Ws, st);
    case 4: return pack<T, 4>(x, xs, N, H, W, Hs, Ws, st);
    case 5: return pack<T, 5>(x, xs, N, H, W, Hs, Ws, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool S8, int COUT, bool Q8>
auto kernel_of() {
  if constexpr (S8)
    return &stem_s8_kernel<COUT>;
  else
    return &stem_kernel<COUT, Q8>;
}

// the pack, then the persistent stem kernel, as many CTAs as fit on the
// card at once
template <bool S8, int COUT, bool Q8, class... Args>
int launch(const void* x, void* xs, int N, int H, int W, int C,
           cudaStream_t st, Args... args) {
  using S = Stem<S8, COUT>;
  const auto kernel = kernel_of<S8, COUT, Q8>();
  static bool smem_set = false;
  static int grid_cap = 0;
  int e = allow_smem(kernel, S::kSmem, smem_set);
  if (e) return e;
  if (!grid_cap) {
    int dev = 0, sms = 0, occ = 0;
    if ((e = (int)cudaGetDevice(&dev))
        || (e = (int)cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev))
        || (e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, kernel, kThreads, S::kSmem)))
      return e;
    grid_cap = sms * (occ > 0 ? occ : 1);
  }
  const int Hc = H / 2, Wc = W / 2, Ho = (Hc - 1) / 2 + 1;
  const int Wo = (Wc - 1) / 2 + 1, Hs = Hc + 3, Ws = Wc + 3;
  const int nstrips = (Ho + kRP - 1) / kRP;
  const int ntiles = Wo <= kTP ? 1 : 1 + (Wo - kTP + kTP - 2) / (kTP - 1);
  const int64_t items = (int64_t)N * nstrips * ntiles;
  const int64_t chunks = (int64_t)N * Hs * S::kJ * Ws;
  if (items >= ((int64_t)1 << 31) || chunks >= ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  if (items == 0) return 0;
  e = S8 ? pack_c<uint8_t>(x, xs, N, H, W, C, Hs, Ws, st)
         : pack_c<uint16_t>(x, xs, N, H, W, C, Hs, Ws, st);
  if (e) return e;
  const int grid = (int)(items < grid_cap ? items : grid_cap);
  kernel<<<grid, kThreads, S::kSmem, st>>>((const uint8_t*)xs, args..., N,
                                            Hc, Wc, Ho, Wo, nstrips, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 stem. x (N, H, W, C) bf16 with C <= 5 and H, W even; xs the
// pack's scratch, (N, H/2 + 3, 3, W/2 + 3, 16) bytes; wk (384, cout) bf16
// (ops/stem_kernels `stem_kernel_weights`); bias (cout,) f32; out (N, Ho,
// Wo, cout) bf16, or int8 with q8. cout is 64 or 128; pointers 16-byte
// aligned (checked by the Python wrapper).
extern "C" int io_fused_stem(const void* x, void* xs, const void* wk,
                             const void* bias, void* out, int N, int H,
                             int W, int C, int cout, int q8, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = (const float*)bias;
  if (C > 5 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  if (cout == 64)
    return q8 ? launch<false, 64, true>(x, xs, N, H, W, C, s, wk, b, out)
              : launch<false, 64, false>(x, xs, N, H, W, C, s, wk, b, out);
  if (cout == 128)
    return q8 ? launch<false, 128, true>(x, xs, N, H, W, C, s, wk, b, out)
              : launch<false, 128, false>(x, xs, N, H, W, C, s, wk, b, out);
  return (int)cudaErrorInvalidValue;
}

// int8c stem: x (N, H, W, C) int8 with C <= 5 and H, W even; xs the
// pack's scratch, (N, H/2 + 3, 2, W/2 + 3, 16) bytes; wk (cout, 512) int8
// (`stem_kernel_weights`); mul, bias (cout,) f32; out (N, Ho, Wo, cout)
// int8. cout is 64 or 128; pointers 16-byte aligned (checked by the
// Python wrapper).
extern "C" int io_fused_stem_s8(const void* x, void* xs, const void* wk,
                                const void* mul, const void* bias, void* out,
                                int N, int H, int W, int C, int cout,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)mul;
  const float* b = (const float*)bias;
  if (C > 5 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  if (cout == 64)
    return launch<true, 64, false>(x, xs, N, H, W, C, s, wk, m, b, out);
  if (cout == 128)
    return launch<true, 128, false>(x, xs, N, H, W, C, s, wk, m, b, out);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The f32 stem: kernel 15 given f32 activations (the TPU kernel
// `fused_stem` is dtype-generic), conv 7x7 / stride 2 / pad 3 with f32
// sums, + f32 bias, relu, max-pool 3x3 / stride 2 / pad 1, stored f32 or
// (q8: the v2 model's stem at f32 compute, instaorder_tpu/models/
// quantize.py `_stem_v2`) as the one-sided int8 clip(rint(v), 0, 127) of
// the pooled value, quantised after the pool as the TPU kernel does.
//
// Bound on the H100: f32 operations at the double-width siamese stem
// (Cout 128: 128^2 * 245 * 128 MAC, 1.03 GFLOP per 256^2 image, against
// ~3.4 MB of f32 input and output). Design: the conv runs direct, on the
// CUDA cores, at its real K = 7 * 7 * C: no pack pass and no padded taps.
//  - A CTA owns 64 output channels (half of the double-width stem) and
//    keeps their (K, 64) weights (ops/stem_kernels `stem_kernel_weights`:
//    at f32 the HWIO weights as (7 * 7 * C, Cout) rows) and bias in
//    shared memory. CTAs are persistent and walk the bf16 stem's work
//    items (image, 8 pooled rows, up to 64 pooled columns) within a
//    channel half, halves outermost, so a CTA reloads its weights only
//    when its half changes.
//  - A conv row of kTM = 128 pixels reads 7 input rows of 2 * 128 + 5
//    pixels. Input rows reach a ring of kSlotsF rows in shared memory by
//    4-byte cp.async (a tile's first input column is not 16-byte
//    aligned), zero-filled off the image, one conv row ahead: a conv row
//    brings in two new input rows.
//  - Per conv row each thread sums a 4-pixel x 8-channel micro-tile over
//    the K taps in (dy, dx, c) order with __fmaf_rn: four A values (four
//    pixels 2C words apart, so a warp's four pixel rows fall in four
//    banks) and two 16-byte B vectors per tap.
//  - The epilogue adds the bias and takes the relu into a one-row conv
//    buffer; the bf16 stem's separable pool then runs on 16-byte chunks
//    of four channels with the running vertical max in registers, and a
//    pooled chunk is stored as four f32 or (q8) four int8 values.

namespace {

using namespace convgemm;

constexpr int kChF = 64;                // output channels of a CTA
constexpr int kInCols = 2 * kTM + 5;    // input pixels a conv row reads
constexpr int kSlotsF = 9;              // input rows in the ring
constexpr int kLdcF = kChF + 4;         // conv buffer row, f32

template <int C>
struct StemF {
  static constexpr int kK = 49 * C;
  static constexpr int kSlot = (kInCols * C + 3) / 4 * 4;  // f32 a ring row
  static constexpr int kRing = kK * kChF;                   // offsets in f32
  static constexpr int kConv = kRing + kSlotsF * kSlot;
  static constexpr int kBias = kConv + kTM * kLdcF;
  static constexpr int kSmem = (kBias + kChF) * 4;
  static constexpr int kQC = kChF / 4;                      // chunks a pixel
  static constexpr int kNI = kTP * kQC / kThreads;          // pool items
  static_assert(kNI * kThreads == kTP * kQC, "pool items");
  static_assert(kSmem <= 232448, "stem tile exceeds shared memory");
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ float4 vmax4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
stem_f32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                const float* __restrict__ bias, void* __restrict__ out,
                int N, int H, int W, int Cout, int Hc, int Wc, int Ho,
                int Wo, int nstrips, int ntiles, int q8) {
  using S = StemF<C>;
  extern __shared__ __align__(16) float smf[];
  float* ws = smf;
  float* ring = smf + S::kRing;
  float* conv = smf + S::kConv;
  float* sb = smf + S::kBias;
  const int tid = threadIdx.x, lane = tid & 31;
  // micro-tile: pixels tm + 32 i (i < 4), channels c0.. and c1.. (4 each)
  const int tm = (tid >> 5) * 4 + (lane >> 3);
  const int c0 = (lane & 7) * 4, c1 = kChF / 2 + c0;
  const int per_half = N * nstrips * ntiles;
  const int items = per_half * (Cout / kChF);
  int half = -1;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int hf = item / per_half;
    const int rest = item - hf * per_half;
    const int t = rest % ntiles;
    const int s = (rest / ntiles) % nstrips;
    const int n = rest / (ntiles * nstrips);
    if (hf != half) {
      // the half's weights (in the first cp.async group of the item) and
      // bias; every reader of the old ones passed the item's last barrier
      for (int e = tid; e < S::kK * kChF / 4; e += kThreads) {
        const int k = e / (kChF / 4), cq = e - k * (kChF / 4);
        cp_async16(smem_addr(ws + k * kChF + cq * 4),
                   wk + (int64_t)k * Cout + hf * kChF + cq * 4, true);
      }
      for (int i = tid; i < kChF; i += kThreads) sb[i] = bias[hf * kChF + i];
      half = hf;
    }
    const int i0 = s * kRP, i1 = min(Ho, i0 + kRP);
    const int j0 = t == 0 ? 0 : kTP + (t - 1) * (kTP - 1);
    const int j1 = min(Wo, t == 0 ? kTP : j0 + kTP - 1);
    const int cs = t == 0 ? 0 : 2 * j0 - 1;      // first conv column
    const int rlo = max(0, 2 * i0 - 1), rhi = min(Hc - 1, 2 * i1 - 1);
    const int ic0 = 2 * cs - 3;                  // first input column
    const float* xn = x + (int64_t)n * H * W * C;

    // input row u (u >= -3; zero off the image) into its ring slot
    auto load = [&](int u) {
      const uint32_t dst = smem_addr(ring + ((u + 2 * kSlotsF) % kSlotsF)
                                            * S::kSlot);
      const bool rowok = u >= 0 && u < H;
      const float* row = xn + ((int64_t)(rowok ? u : 0) * W + ic0) * C;
      for (int e = tid; e < kInCols * C; e += kThreads) {
        const int col = ic0 + e / C;
        const bool ok = rowok && col >= 0 && col < W;
        cp_async4(dst + e * 4, ok ? row + e : x, ok);
      }
    };

    // pooled output (image n, row i, column j, chunk q of this half):
    // f32, or (q8) clip(rint(v), 0, 127) as int8
    auto store = [&](int i, int j, int q, float4 v) {
      const int64_t o = (((int64_t)n * Ho + i) * Wo + j) * Cout + hf * kChF
                        + q * 4;
      if (q8) {
        auto q8v = [](float t) {
          return (signed char)fminf(fmaxf(rintf(t), 0.0f), 127.0f);
        };
        *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + o) =
            make_char4(q8v(v.x), q8v(v.y), q8v(v.z), q8v(v.w));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
      }
    };

    float4 V[S::kNI];
#pragma unroll
    for (int k = 0; k < S::kNI; ++k) V[k] = make_float4(0.f, 0.f, 0.f, 0.f);

    // the pool's step for conv row r, which the conv buffer holds (as in
    // stem_body: an even row joins pooled row r / 2, an odd row finishes
    // it and opens the next)
    auto pool = [&](int r) {
#pragma unroll
      for (int k = 0; k < S::kNI; ++k) {
        const int it = tid + k * kThreads, jj = it / S::kQC;
        const int q = it - jj * S::kQC, j = j0 + jj;
        if (j >= j1) continue;
        const int clo = max(2 * j - 1, 0) - cs;
        const int chi = min(2 * j + 1, Wc - 1) - cs;
        const float* p = conv + q * 4;
        float4 h = *reinterpret_cast<const float4*>(p + clo * kLdcF);
        for (int c = clo + 1; c <= chi; ++c)
          h = vmax4(h, *reinterpret_cast<const float4*>(p + c * kLdcF));
        if ((r & 1) == 0) {
          V[k] = vmax4(V[k], h);
          if (r + 1 == Hc) store(r >> 1, j, q, V[k]);
        } else {
          if ((r >> 1) >= i0) store(r >> 1, j, q, vmax4(V[k], h));
          V[k] = h;
        }
      }
    };

    for (int d = 0; d < 7; ++d) load(2 * rlo - 3 + d);
    cp_async_commit();
    for (int r = rlo; r <= rhi; ++r) {
      // input rows 2r - 3 .. 2r + 3 (and the weights) have landed; the
      // conv buffer holds conv row r - 1
      cp_async_wait<0>();
      __syncthreads();
      // the two input rows conv row r + 1 adds, into the slots of rows
      // 2r - 5 and 2r - 4, which conv row r - 1 read last
      if (r < rhi) {
        load(2 * r + 4);
        load(2 * r + 5);
      }
      cp_async_commit();
      if (r > rlo) pool(r - 1);
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
      for (int dy = 0; dy < 7; ++dy) {
        const float* rp = ring + ((2 * r - 3 + dy + 2 * kSlotsF) % kSlotsF)
                                 * S::kSlot + 2 * tm * C;
        const float* wp = ws + dy * 7 * C * kChF;
#pragma unroll
        for (int dx = 0; dx < 7; ++dx)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float* wr = wp + (dx * C + c) * kChF;
            const float4 u = *reinterpret_cast<const float4*>(wr + c0);
            const float4 v = *reinterpret_cast<const float4*>(wr + c1);
            const float b[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float a = rp[(64 * i + dx) * C + c];
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = __fmaf_rn(a, b[j], acc[i][j]);
            }
          }
      }
      // every thread is done with pool(r - 1): conv row r into the buffer
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* o = conv + (tm + 32 * i) * kLdcF;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = h ? c1 : c0;
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[e] = fmaxf(acc[i][4 * h + e] + sb[c + e], 0.0f);
          *reinterpret_cast<float4*>(o + c) = make_float4(y[0], y[1], y[2],
                                                          y[3]);
        }
      }
    }
    __syncthreads();
    pool(rhi);
  }
  cp_async_wait<0>();
}

template <int C>
int launch_f32(const float* x, const float* wk, const float* bias,
               void* out, int N, int H, int W, int cout, int q8,
               cudaStream_t st) {
  using S = StemF<C>;
  static bool smem_set = false;
  static int grid_cap = 0;
  int e = allow_smem(stem_f32_kernel<C>, S::kSmem, smem_set);
  if (e) return e;
  if (!grid_cap) {
    int dev = 0, sms = 0, occ = 0;
    if ((e = (int)cudaGetDevice(&dev))
        || (e = (int)cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev))
        || (e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, stem_f32_kernel<C>, kThreads, S::kSmem)))
      return e;
    grid_cap = sms * (occ > 0 ? occ : 1);
  }
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Ho = (Hc - 1) / 2 + 1, Wo = (Wc - 1) / 2 + 1;
  const int nstrips = (Ho + kRP - 1) / kRP;
  const int ntiles = Wo <= kTP ? 1 : 1 + (Wo - kTP + kTP - 2) / (kTP - 1);
  const int64_t items = (int64_t)N * nstrips * ntiles * (cout / kChF);
  if (items >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (items == 0) return 0;
  const int grid = (int)(items < grid_cap ? items : grid_cap);
  stem_f32_kernel<C><<<grid, kThreads, S::kSmem, st>>>(
      x, wk, bias, out, N, H, W, cout, Hc, Wc, Ho, Wo, nstrips, ntiles, q8);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 stem. x (N, H, W, C) f32 with C <= 5, H, W >= 1; wk (49 C, cout)
// f32 (ops/stem_kernels `stem_kernel_weights`); bias (cout,) f32; out (N,
// Ho, Wo, cout) f32, or int8 with q8, Ho = ceil(ceil(H / 2) / 2). cout is
// 64 or 128; pointers 16-byte aligned (checked by the Python wrapper).
extern "C" int io_fused_stem_f32(const void* x, const void* wk,
                                 const void* bias, void* out, int N, int H,
                                 int W, int C, int cout, int q8,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* w = (const float*)wk;
  const float* b = (const float*)bias;
  if (H < 1 || W < 1 || (cout != 64 && cout != 128))
    return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1: return launch_f32<1>(xf, w, b, out, N, H, W, cout, q8, s);
    case 2: return launch_f32<2>(xf, w, b, out, N, H, W, cout, q8, s);
    case 3: return launch_f32<3>(xf, w, b, out, N, H, W, cout, q8, s);
    case 4: return launch_f32<4>(xf, w, b, out, N, H, W, cout, q8, s);
    case 5: return launch_f32<5>(xf, w, b, out, N, H, W, cout, q8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
