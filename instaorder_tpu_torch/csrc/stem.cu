// Fused ResNet stem, NHWC: conv 7x7 / stride 2 / pad 3, then max-pool
// 3x3 / stride 2 / pad 1, as one implicit GEMM on Hopper's tensor cores
// (wgmma) with the pool in its epilogue. Three kernels share the design:
// the two below and, at f32, `stem_f32_kernel` (3xTF32 with A from
// registers, described at its definition below):
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
// chunks. T: the element's bits (uint32_t for f32, uint16_t for bf16,
// uint8_t for int8); at f32 the 4C channels are exactly J = C chunks.
template <typename T, int C>
__global__ void __launch_bounds__(256)
stem_pack_kernel(const T* __restrict__ x, uint8_t* __restrict__ xs, int N,
                 int H, int W, int Hs, int Ws) {
  using Word = std::conditional_t<
      sizeof(T) == 4, uint2,
      std::conditional_t<sizeof(T) == 2, uint32_t, uint16_t>>;
  constexpr int J = sizeof(T) == 4 ? C : sizeof(T) == 2 ? 3 : 2;
  constexpr int kWords = J * 16 / sizeof(Word);
  const int64_t total = (int64_t)N * Hs * Ws;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int v = (int)(idx % Ws);
    const int64_t nu = idx / Ws;
    const int u = (int)(nu % Hs), n = (int)(nu / Hs);
    alignas(16) Word buf[kWords];
#pragma unroll
    for (int e = 0; e < kWords; ++e) buf[e] = Word{};
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
  // per device: the shared-memory attribute and the grid cap (SMs x
  // resident CTAs) belong to the card the launch runs on
  static bool smem_set[kMaxDevices] = {};
  static int grid_caps[kMaxDevices] = {};
  int dev = 0;
  int e = current_device(dev);
  if (e || (e = allow_smem(kernel, S::kSmem, smem_set))) return e;
  int& grid_cap = grid_caps[dev];
  if (!grid_cap) {
    int sms = 0, occ = 0;
    if ((e = (int)cudaDeviceGetAttribute(
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
// accuracy, + f32 bias, relu, max-pool 3x3 / stride 2 / pad 1, stored f32
// or (q8: the v2 model's stem at f32 compute, instaorder_tpu/models/
// quantize.py `_stem_v2`) as the one-sided int8 clip(rint(v), 0, 127) of
// the pooled value, quantised after the pool as the TPU kernel does.
//
// Bound on the H100: tensor-core operations at three TF32 products per
// f32 product (csrc/bottleneck_f32.cu: a . b = lo_a . hi_b + hi_a . lo_b
// + hi_a . hi_b, each operand split as a = hi + lo, ~2^-22 relative; one
// TF32 product keeps ~11 bits, outside the stem's 1e-5 bar). At the
// double-width siamese stem (Cout 128) that is 3 * 128^2 * 245 * 128 MAC
// per 256^2 image at 495 TFLOP/s, against ~3.4 MB of f32 input and
// output. Design: `stem_f32_kernel<C>`, a 3xTF32 implicit GEMM on wgmma
// over the bf16 stem's space-to-depth input.
//  - The pack (`stem_pack_kernel<uint32_t, C>`) writes the s2d input
//    chunk-planar, (N, H/2 + 3, J, W/2 + 3, 16 bytes): at f32 a chunk
//    holds 4 values, so the 4C s2d channels are exactly J = C chunks.
//  - A k8 step is one (tap row du, tap column pair dxp, chunk j): the
//    taps dx = 2 dxp + e, e = 0, 1, times the chunk's 4 channels i, K
//    order (e, i). The du = 0 chunks whose channels all come from the
//    pad row above (sy = 0: chunks j < C / 2) have zero weights and are
//    skipped: 8C - 2 (C / 2) k8 steps, K = 288 at C = 5 (of 320; the real
//    K is 245). The weights come split and K-major, (2, Cout, K) = [hi,
//    lo], hi = tf32(w) and lo = tf32(w - hi), made once when the model is
//    built (ops/stem_kernels `stem_kernel_weights`); a CTA keeps its 64
//    output channels' hi and lo in shared memory with the 128-byte
//    swizzle (tf32 wgmma reads B only K-major).
//  - A conv row of kTM = 128 pixels is the M tile (64 rows a
//    warpgroup). A's hi is the raw f32 of the s2d rows in shared memory,
//    read in place as the bf16 stem reads its A (core matrices of a
//    K-major operand without swizzle, LBO 16, SBO 128): tf32 wgmma reads
//    the top 19 bits of each f32, so hi = trunc(a), a with its low 13
//    mantissa bits cleared, and a - hi is exact. A's lo = tf32(a - hi)
//    comes from registers (the RS form of tf32 wgmma): each thread
//    loads its fragment of a k8 (4 values, two pixels of each of two
//    pixel rows, one chunk element; a warp's loads are 128 contiguous
//    bytes) and forms lo. So lo_a . hi_b is RS, hi_a . lo_b and hi_a .
//    hi_b read both operands from shared memory.
//  - Shared memory decides the design. At C = 5 the hi and lo weights of
//    64 channels take 2 * 9 * 64 * 128 = 147,456 B (163,840 at K = 320);
//    one raw s2d row of a tile 5 * 131 * 16 = 10,480 B; the conv buffer
//    128 * 72 * 4 = 36,864 B. A lo plane beside each raw row would double
//    the ring and does not fit with 128-pixel rows; lo in registers, a
//    ring of kSlotsF = 4 raw rows fits: 227,520 B with the bias and the
//    alignment slack, of 232,448. Four rows are exactly the rows a conv
//    row reads: row r + 3 is copied (16-byte cp.async) into the slot of
//    row r - 1 when conv row r starts, and waited for only before the
//    k8 steps of du = 3, three quarters of a conv row later.
//  - Products: a K step is one (du, dxp) with its chunks jlo .. C - 1,
//    split in two where there are three or more, so at most kG = 3 k8
//    steps (16 K steps a row at C = 5). Its small products (lo_a . hi_b,
//    hi_a . lo_b of every k8) go first, then its hi_a . hi_b, into a
//    fresh accumulator (the tensor cores truncate their sums; see
//    csrc/bottleneck_f32.cu), and the step's sum is added into f32
//    registers rounded to nearest. Two accumulators and two fragment
//    sets alternate, so that a step's lo fragments are formed, and the
//    previous step's sum added, while the step before it runs.
//  - CTAs are persistent, each on one channel half (Cout 128 is two) for
//    all its items, so it loads its weights once; an item is (image, 16
//    pooled rows, up to 64 pooled columns), 33 conv rows for 32 (the
//    first conv row of a strip is the last of the one above), and the
//    two halves' CTAs walk them in step, so an s2d row read from device
//    memory by one is found in L2 by the other.
//  - The epilogue adds the bias and takes the relu into the one-row conv
//    buffer (built with -fmad=false, as the reference adds); the bf16
//    stem's separable pool then runs on 16-byte chunks of four channels
//    with the running vertical max in registers, and a pooled chunk is
//    stored as four f32 or (q8) four int8 values.

namespace {

using namespace convgemm;

constexpr int kChF = 64;                // output channels of a CTA
constexpr int kSlotsF = 4;              // raw s2d rows in the ring
constexpr int kRPF = 16;                // pooled rows of a work item
// conv buffer row (f32): a half-warp's 8-byte stores of its accumulator
// rows (lane / 4) land in 16 distinct bank pairs
constexpr int kLdcF = kChF + 8;

template <int C>
struct StemF {
  static constexpr int kJ = C;                       // chunks of a pixel
  static constexpr int kSkip = C / 2;                // du = 0 zero chunks
  static constexpr int kN8 = 8 * C - 2 * kSkip;      // k8 steps
  static constexpr int kK = 8 * kN8;                 // 288 at C = 5
  static constexpr int kWHalf = (kN8 + 3) / 4 * kChF * kRowBytes;
  static constexpr int kSlot = kJ * kPlane;
  static constexpr int kRing = 2 * kWHalf;           // byte offsets
  static constexpr int kConv = kRing + kSlotsF * kSlot;
  static constexpr int kBias = kConv + kTM * kLdcF * 4;
  static constexpr int kSmem = kBias + kChF * 4 + 1024;
  static constexpr int kQC = kChF / 4;               // chunks a pixel
  static constexpr int kNI = kTP * kQC / kThreads;   // pool items
  static_assert(kWHalf % 1024 == 0, "weights keep the swizzle alignment");
  static_assert(kNI * kThreads == kTP * kQC, "pool items");
  static_assert(kSmem <= 232448, "stem tile exceeds shared memory");

  // the k8 step of (du, dxp, j) in the weights' K order
  __host__ __device__ static constexpr int k8(int du, int dxp, int j) {
    return du == 0 ? dxp * (kJ - kSkip) + j - kSkip
                   : 2 * (kJ - kSkip) + ((du - 1) * 2 + dxp) * kJ + j;
  }

  // K steps g = 4 du + 2 dxp + h: the chunks jlo .. C - 1 of (du, dxp),
  // split in two halves h (the first one larger) where there are three
  // or more, so that a step has at most kG k8 steps; g is a step where
  // h < the number of halves
  static constexpr int kG = 3;
  __host__ __device__ static constexpr int jlo(int du) {
    return du == 0 ? kSkip : 0;
  }
  __host__ __device__ static constexpr int halves(int du) {
    return kJ - jlo(du) >= 3 ? 2 : 1;
  }
  __host__ __device__ static constexpr bool valid(int g) {
    return (g & 1) < halves(g >> 2);
  }
  __host__ __device__ static constexpr int jmid(int du) {
    return halves(du) == 2 ? jlo(du) + (kJ - jlo(du) + 1) / 2 : kJ;
  }
  __host__ __device__ static constexpr int ja(int g) {
    return (g & 1) ? jmid(g >> 2) : jlo(g >> 2);
  }
  __host__ __device__ static constexpr int jb(int g) {
    return (g & 1) ? kJ : jmid(g >> 2);
  }
  // steps before g (closed forms, so that an unrolled loop folds them),
  // and the step after g (16: none)
  __host__ __device__ static constexpr int order(int g) {
    return (g >= 4 ? 2 * halves(0) + 2 * halves(1) * ((g >> 2) - 1) : 0)
           + ((g >> 1) & 1) * halves(g >> 2) + (g & 1);
  }
  static constexpr int kSteps =
      2 * (kJ - kSkip >= 3 ? 2 : 1) + 6 * (kJ >= 3 ? 2 : 1);
  __host__ __device__ static constexpr int next(int g) {
    return (g & 1) == 0 && halves(g >> 2) == 2 ? g + 1 : (g | 1) + 1;
  }
  __host__ __device__ static constexpr bool fits() {
    int n = 0;
    for (int g = 0; g < 16; ++g) {
      if (!valid(g)) continue;
      if (jb(g) - ja(g) > kG || jb(g) <= ja(g) || order(g) != n++
          || (next(g) < 16 && !valid(next(g))))
        return false;
    }
    return n == kSteps;
  }
};

__device__ __forceinline__ float4 vmax4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// This thread's lo fragments of the k8 steps (du, dxp, ja .. jb - 1):
// from `px`, its first pixel's first element in the slot of s2d row r +
// du, chunk j's values a of pixels m, m + 8 (column e = 0) and m + 1, m
// + 9 (e = 1), each as tf32(a - trunc(a)), trunc(a) = a with its low 13
// mantissa bits cleared (A's hi: what tf32 wgmma reads of a in shared
// memory)
template <int G>
__device__ __forceinline__ void load_frags(const uint8_t* px, int dxp,
                                           int ja, int jb,
                                           uint32_t (&fl)[G][4]) {
#pragma unroll
  for (int jj = 0; jj < G; ++jj) {
    if (ja + jj >= jb) continue;
    const float* p = reinterpret_cast<const float*>(
        px + (ja + jj) * kPlane + dxp * 32);
    const float a[4] = {p[0], p[32], p[4], p[36]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float h = __uint_as_float(__float_as_uint(a[i]) & 0xffffe000u);
      fl[jj][i] = __float_as_uint(tf32_rna(__fsub_rn(a[i], h)));
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
stem_f32_kernel(const uint8_t* __restrict__ xs, const float* __restrict__ wk,
                const float* __restrict__ bias, void* __restrict__ out,
                int N, int Hc, int Wc, int Ho, int Wo, int nstrips,
                int ntiles, int Cout, int q8) {
  using S = StemF<C>;
  static_assert(S::fits(), "a K step holds 1 .. kG k8 steps");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint8_t* ring = smem + S::kRing;
  float* conv = reinterpret_cast<float*>(smem + S::kConv);
  float* sb = reinterpret_cast<float*>(smem + S::kBias);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int nh = Cout / kChF, hf = blockIdx.x % nh;
  const int Ws = Wc + 3;
  const int64_t row_bytes = (int64_t)S::kJ * Ws * 16;
  const uint32_t sW = smem_addr(smem), sRing = sW + S::kRing;
  // the thread's A fragment origin: pixel row m = 64 wg + 16 warp + lane
  // / 4 of the tile, element lane % 4 of a chunk
  const uint8_t* afrag = ring
      + ((tid >> 7) * kWgRows + ((tid >> 5) & 3) * 16 + (lane >> 2)) * 16
      + (lane & 3) * 4;

  // once per CTA: its half's hi and lo weights (the first cp.async group),
  // 128-byte K blocks of 64 rows, and bias
  constexpr int kCpr = S::kK / 4;                    // 16-byte chunks a row
  for (int e = tid; e < 2 * kChF * kCpr; e += kThreads) {
    const int hl = e / (kChF * kCpr), rest = e - hl * kChF * kCpr;
    const int nr = rest / kCpr, c = rest - nr * kCpr;
    cp_async16(sW + hl * S::kWHalf + (c >> 3) * kChF * kRowBytes
                   + swz128(nr, c & 7),
               wk + ((int64_t)hl * Cout + hf * kChF + nr) * S::kK + c * 4,
               true);
  }
  cp_async_commit();
  for (int i = tid; i < kChF; i += kThreads) sb[i] = bias[hf * kChF + i];

  uint32_t fl[2][S::kG][4];
  float acc[2][kChF / 2], tot[kChF / 2];
#pragma unroll
  for (int i = 0; i < kChF / 2; ++i) acc[0][i] = acc[1][i] = 0.0f;
  const int items = N * nstrips * ntiles;
  for (int item = blockIdx.x / nh; item < items; item += gridDim.x / nh) {
    const int t = item % ntiles;
    const int s = (item / ntiles) % nstrips;
    const int n = item / (ntiles * nstrips);
    const int i0 = s * kRPF, i1 = min(Ho, i0 + kRPF);
    const int j0 = t == 0 ? 0 : kTP + (t - 1) * (kTP - 1);
    const int j1 = min(Wo, t == 0 ? kTP : j0 + kTP - 1);
    const int cs = t == 0 ? 0 : 2 * j0 - 1;      // first conv column
    const int rlo = max(0, 2 * i0 - 1), rhi = min(Hc - 1, 2 * i1 - 1);
    const uint8_t* xn = xs + (int64_t)n * (Hc + 3) * row_bytes;

    // s2d row u (pixels cs .. cs + 130 of each plane; zero past the
    // image) into its ring slot; rows past the item's last are skipped
    auto load = [&](int u) {
      if (u > rhi + 3) return;
      const uint32_t dst = sRing + (u % kSlotsF) * S::kSlot;
      const uint8_t* row = xn + u * row_bytes;
      for (int e = tid; e < S::kJ * kCols; e += kThreads) {
        const int j = e / kCols, v = e - j * kCols;
        const bool ok = cs + v < Ws;
        cp_async16(dst + j * kPlane + v * 16,
                   ok ? row + ((int64_t)j * Ws + cs + v) * 16 : row, ok);
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

    for (int d = 0; d < 3; ++d) load(rlo + d);
    cp_async_commit();
    // s2d rows rlo .. rlo + 2 (and, the first time, the weights) landed;
    // the barrier at the top of the first conv row shows them to all
    cp_async_wait<0>();
    fence_async_smem();

    for (int r = rlo; r <= rhi; ++r) {
      // s2d rows r .. r + 2 are in place; every thread is done with conv
      // row r - 1's fragments (so with the slot of s2d row r - 1), and
      // the conv buffer holds conv row r - 1
      __syncthreads();
      load(r + 3);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < kChF / 2; ++i) tot[i] = 0.0f;
      load_frags(afrag + (r % kSlotsF) * S::kSlot, 0, S::ja(0), S::jb(0),
                 fl[0]);
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        if (!S::valid(g)) continue;
        const int du = g >> 2, dxp = (g >> 1) & 1, b = S::order(g) & 1;
        const int ja = S::ja(g), jb = S::jb(g);
        wgmma_fence();
        const uint32_t arow = sRing + ((r + du) % kSlotsF) * S::kSlot
                              + wg * kWgRows * 16 + dxp * 32;
#pragma unroll
        for (int jj = 0; jj < S::kG; ++jj) {
          if (ja + jj >= jb) continue;
          const int k = S::k8(du, dxp, ja + jj);
          const uint32_t w = sW + (k >> 2) * kChF * kRowBytes;
          wgmma_tf32_rs64(acc[b], fl[b][jj], desc_kmajor(w, (k & 3) * 32),
                          jj > 0);
          wgmma_tf32<64>(acc[b],
                         desc_kmajor_noswz(arow + (ja + jj) * kPlane, 16, 128),
                         desc_kmajor(w + S::kWHalf, (k & 3) * 32), 1);
        }
#pragma unroll
        for (int jj = 0; jj < S::kG; ++jj) {
          if (ja + jj >= jb) continue;
          const int k = S::k8(du, dxp, ja + jj);
          wgmma_tf32<64>(acc[b],
                         desc_kmajor_noswz(arow + (ja + jj) * kPlane, 16, 128),
                         desc_kmajor(sW + (k >> 2) * kChF * kRowBytes,
                                     (k & 3) * 32), 1);
        }
        wgmma_commit();
        // while the step's MMAs run: the pool of conv row r - 1, the sum
        // of the step before (its group retired), the next step's
        // fragments (into the set that step read)
        if (g == 0 && r > rlo) pool(r - 1);
        if (S::order(g) > 0) {
          wgmma_wait<1>();
#pragma unroll
          for (int i = 0; i < kChF / 2; ++i) {
            reg_fence(acc[b ^ 1][i]);
            tot[i] = tot[i] + acc[b ^ 1][i];
          }
        }
        const int gn = S::next(g);
        if (gn < 16) {
          if ((gn >> 2) == 3 && (g >> 2) < 3) {
            // s2d row r + 3, copied when the row started
            cp_async_wait<0>();
            fence_async_smem();
            __syncthreads();
          }
          load_frags(afrag + ((r + (gn >> 2)) % kSlotsF) * S::kSlot,
                     (gn >> 1) & 1, S::ja(gn), S::jb(gn), fl[b ^ 1]);
        }
      }
      wgmma_wait<0>();
      constexpr int kLast = (S::kSteps - 1) & 1;
#pragma unroll
      for (int i = 0; i < kChF / 2; ++i) {
        reg_fence(acc[kLast][i]);
        tot[i] = tot[i] + acc[kLast][i];
      }
      // every thread is done with pool(r - 1): conv row r into the buffer
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kChF / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = frag_row(tid, h), col = frag_col(tid, j);
          *reinterpret_cast<float2*>(conv + row * kLdcF + col) = make_float2(
              fmaxf(tot[4 * j + 2 * h] + sb[col], 0.0f),
              fmaxf(tot[4 * j + 2 * h + 1] + sb[col + 1], 0.0f));
        }
    }
    __syncthreads();
    pool(rhi);
  }
  cp_async_wait<0>();
}

// the pack, then the persistent kernel: as many CTAs as fit on the card
// at once, an even number when Cout = 128 (CTA b on channel half b % 2)
template <int C>
int launch_f32(const void* x, void* xs, const float* wk, const float* bias,
               void* out, int N, int H, int W, int cout, int q8,
               cudaStream_t st) {
  using S = StemF<C>;
  // per device, as in launch() above
  static bool smem_set[kMaxDevices] = {};
  static int grid_caps[kMaxDevices] = {};
  int dev = 0;
  int e = current_device(dev);
  if (e || (e = allow_smem(stem_f32_kernel<C>, S::kSmem, smem_set)))
    return e;
  int& grid_cap = grid_caps[dev];
  if (!grid_cap) {
    int sms = 0, occ = 0;
    if ((e = (int)cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev))
        || (e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, stem_f32_kernel<C>, kThreads, S::kSmem)))
      return e;
    grid_cap = sms * (occ > 0 ? occ : 1);
  }
  const int Hc = H / 2, Wc = W / 2, Ho = (Hc - 1) / 2 + 1;
  const int Wo = (Wc - 1) / 2 + 1, Hs = Hc + 3, Ws = Wc + 3;
  const int nstrips = (Ho + kRPF - 1) / kRPF;
  const int ntiles = Wo <= kTP ? 1 : 1 + (Wo - kTP + kTP - 2) / (kTP - 1);
  const int nh = cout / kChF;
  const int64_t items = (int64_t)N * nstrips * ntiles;
  const int64_t chunks = (int64_t)N * Hs * S::kJ * Ws;
  if (items * nh >= ((int64_t)1 << 31) || chunks >= ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  if (items == 0) return 0;
  e = pack<uint32_t, C>(x, xs, N, H, W, Hs, Ws, st);
  if (e) return e;
  int64_t grid = items * nh < grid_cap ? items * nh : grid_cap;
  grid -= grid % nh;
  stem_f32_kernel<C><<<(int)grid, kThreads, S::kSmem, st>>>(
      (const uint8_t*)xs, wk, bias, out, N, Hc, Wc, Ho, Wo, nstrips, ntiles,
      cout, q8);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 stem. x (N, H, W, C) f32 with C <= 5 and H, W even; xs the pack's
// scratch, (N, H/2 + 3, C, W/2 + 3, 16) bytes; wk (2, cout, K) f32, the
// split K-major s2d weights (ops/stem_kernels `stem_kernel_weights`, K =
// 8 (8C - 2 (C / 2))); bias (cout,) f32; out (N, Ho, Wo, cout) f32, or
// int8 with q8. cout is 64 or 128; pointers 16-byte aligned (checked by
// the Python wrapper).
extern "C" int io_fused_stem_f32(const void* x, void* xs, const void* wk,
                                 const void* bias, void* out, int N, int H,
                                 int W, int C, int cout, int q8,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* w = (const float*)wk;
  const float* b = (const float*)bias;
  if (H % 2 || W % 2 || (cout != 64 && cout != 128))
    return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1: return launch_f32<1>(x, xs, w, b, out, N, H, W, cout, q8, s);
    case 2: return launch_f32<2>(x, xs, w, b, out, N, H, W, cout, q8, s);
    case 3: return launch_f32<3>(x, xs, w, b, out, N, H, W, cout, q8, s);
    case 4: return launch_f32<4>(x, xs, w, b, out, N, H, W, cout, q8, s);
    case 5: return launch_f32<5>(x, xs, w, b, out, N, H, W, cout, q8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
