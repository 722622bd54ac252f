// Fused ResNet stem, NHWC: conv 7x7 / stride 2 / pad 3 + f32 bias + relu,
// rounded to bf16, then max-pool 3x3 / stride 2 / pad 1, stored as bf16
// or (q8) as the one-sided int8 clip(rint(v), 0, 127). The int8c variant
// (`stem_s8_kernel`, below the bf16 one) takes s8 input and weights.
//
// Replaces instaorder_tpu/ops/pallas_blocks.py `fused_stem` (kernel
// body `_stem_v2_kernel`, with its q8 option). The TPU kernel packs the
// input mod 4 and produces the conv output as 2x2 parity planes so that
// neither stride-2 stage needs a strided VMEM load; none of that carries
// over. What it keeps out of device memory does: the (N, H/2, W/2, Cout)
// conv output never leaves the SM.
//
// Bound on the H100: tensor-core operations. Per 256^2 image at Cout 128
// (the double-width siamese stem) the conv is 128^2 * 245 * 128 MAC
// (1.03 GFLOP) against ~1.7 MB of input and output, ~600 flop/byte,
// above the 295 flop/byte ridge.
//
// Design: one CTA per (image, 8x8 tile of pooled outputs). It stages the
// tile's 39x39 input window (the 17x17 conv pixels the pool reads, with
// the conv's 3-pixel halo) in shared memory as bf16 with Cin padded to
// 8, and the whole (245, Cout) weight matrix, K zero-padded to 256. The
// conv runs as an implicit GEMM on the tensor cores (WMMA bf16, f32
// accumulation): M = 289 conv pixels in chunks of 64, each chunk's
// im2col rows gathered from the window through a K -> offset table.
// The epilogue adds the f32 bias, applies relu and rounds to bf16 into a
// shared conv tile; conv pixels outside the image hold 0, which is the
// pool's padding (exact: every pool window holds a real pixel and real
// values are >= 0 after relu). The pool reads the tile and writes each
// pooled value once. The 1/8 overlap of neighbouring tiles' conv pixels
// is recomputed. No pipeline, WMMA rather than wgmma: later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TP = 8, TQ = 8;                     // pooled rows, cols per CTA
constexpr int CR = 2 * TP + 1, CC = 2 * TQ + 1;   // conv rows, cols (17x17)
constexpr int NPIX = CR * CC;                     // conv pixels per CTA
constexpr int IR = 4 * TP + 7, IC = 4 * TQ + 7;   // input window (39x39)
constexpr int CP = 8;                             // channels, padded
constexpr int KP = 256;                           // K = 49*C, padded
constexpr int MCH = 64;                           // conv pixels per GEMM chunk
constexpr int NCH = (NPIX + MCH - 1) / MCH;
constexpr int LDA = KP + 8;
constexpr int NT = 256;
constexpr int WIN = IR * IC * CP;                 // window elements

__host__ __device__ constexpr int align128(int b) {
  return (b + 127) / 128 * 128;
}

// dynamic shared memory layout (byte offsets)
template <int COUT>
struct Smem {
  static constexpr int LDB = COUT + 8;
  static constexpr int win = 0;
  static constexpr int tab = align128(win + WIN * 2);
  static constexpr int b = align128(tab + KP * 4);
  static constexpr int a = align128(b + KP * LDB * 2);
  static constexpr int scr = align128(a + MCH * LDA * 2);
  static constexpr int conv = align128(scr + (NT / 32) * 256 * 4);
  static constexpr int bytes = align128(conv + NPIX * COUT * 2);
};

template <int COUT, bool Q8>
__global__ void __launch_bounds__(NT)
stem_kernel(const __nv_bfloat16* __restrict__ x,   // (N, H, W, C)
            const __nv_bfloat16* __restrict__ w,   // (49*C, COUT)
            const float* __restrict__ bias,        // (COUT,)
            void* __restrict__ out,                // (N, Ho, Wo, COUT)
            int H, int W, int C, int Hc, int Wc, int Ho, int Wo) {
  using L = Smem<COUT>;
  constexpr int NW = COUT / 32;          // 16-wide column tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + L::win);
  int* tab = reinterpret_cast<int*>(smem + L::tab);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L::b);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + L::a);
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem + L::conv);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * TP, j0 = blockIdx.x * TQ;   // pooled origin
  const int r0 = 2 * i0 - 1, c0 = 2 * j0 - 1;             // conv origin
  const int y0 = 2 * r0 - 3, x0 = 2 * c0 - 3;             // input origin
  const int K = 49 * C;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // 1. the input window (zero outside the image and for channels >= C),
  //    the K -> window offset table (k = (dy*7 + dx)*C + c, HWIO order;
  //    -1 for the K padding, whose A entries are 0) and the weights
  //    (rows >= K zero)
  const __nv_bfloat16* xn = x + (int64_t)n * H * W * C;
  for (int e = tid; e < WIN; e += NT) {
    __nv_bfloat16 v = zero;
    const int c = e % CP, px = e / CP;
    const int yy = y0 + px / IC, xx = x0 + px % IC;
    if (c < C && yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = xn[((int64_t)yy * W + xx) * C + c];
    win[e] = v;
  }
  for (int k = tid; k < KP; k += NT) {
    const int dy = k / (7 * C), dx = (k / C) % 7, c = k % C;
    tab[k] = k < K ? (dy * IC + dx) * CP + c : -1;
  }
  for (int e = tid; e < KP * COUT / 8; e += NT) {
    const int k = e / (COUT / 8), o = (e % (COUT / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K) v = *reinterpret_cast<const uint4*>(w + (int64_t)k * COUT + o);
    *reinterpret_cast<uint4*>(Bs + k * L::LDB + o) = v;
  }
  __syncthreads();

  // 2. the conv tile as an implicit GEMM, MCH conv pixels at a time;
  //    warp: 16 rows of the chunk x NW 16-wide column tiles
  const int msub = warp >> 1;
  const int nbase = (warp & 1) * NW * 16;
  float* scr = reinterpret_cast<float*>(smem + L::scr) + warp * 256;
  for (int mc = 0; mc < NCH; ++mc) {
    for (int e = tid; e < MCH * KP; e += NT) {
      const int row = e / KP, k = e % KP;
      const int p = mc * MCH + row;
      const int t = tab[k];
      __nv_bfloat16 v = zero;
      if (p < NPIX && t >= 0)
        v = win[(2 * (p / CC) * IC + 2 * (p % CC)) * CP + t];
      As[row * LDA + k] = v;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int ks = 0; ks < KP; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + msub * 16 * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + ks * L::LDB + nbase + j * 16,
                               L::LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }

    // epilogue: f32 bias, relu, one bf16 rounding; off-image conv
    // pixels are the pool's zero padding
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int t = lane; t < 256; t += 32) {
        const int p = mc * MCH + msub * 16 + t / 16;
        const int o = nbase + j * 16 + t % 16;
        if (p < NPIX) {
          const int cr = r0 + p / CC, cc = c0 + p % CC;
          float v = 0.0f;
          if (cr >= 0 && cr < Hc && cc >= 0 && cc < Wc)
            v = fmaxf(scr[t] + bias[o], 0.0f);
          conv[p * COUT + o] = __float2bfloat16_rn(v);
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // 3. max-pool 3x3/2 over the bf16 conv tile; bf16 or int8 store
  for (int e = tid; e < TP * TQ * COUT; e += NT) {
    const int o = e % COUT, q = e / COUT;
    const int pi = q / TQ, pj = q % TQ;
    const int i = i0 + pi, j = j0 + pj;
    if (i >= Ho || j >= Wo) continue;
    float m = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, __bfloat162float(
                         conv[((2 * pi + dy) * CC + 2 * pj + dx) * COUT + o]));
    const int64_t off = (((int64_t)n * Ho + i) * Wo + j) * COUT + o;
    if (Q8)
      static_cast<int8_t*>(out)[off] =
          (int8_t)(int)fminf(fmaxf(rintf(m), 0.0f), 127.0f);
    else
      static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(m);
  }
}

// ---------------------------------------------------------------------------
// int8c stem (replaces instaorder_tpu/ops/pallas_blocks.py
// `fused_stem_int8`, kernel body `_stem_v2_int8_kernel`): s8 input and
// weights, s32 accumulation on the int8 tensor cores (WMMA s8 m16n16k16),
// the requant epilogue rq8(acc) = clip(rint(f32(acc)*m + b), 0, 127) per
// output channel into an int8 conv tile, then the 3x3/2 max-pool on int8.
// The tile, window and K -> offset table are the bf16 kernel's. Operand
// tiles are stored as 16x16 blocks of 256 bytes so that every WMMA
// fragment starts 32-byte aligned. Conv pixels outside the image hold 0:
// requantised values are >= 0, so that equals the reference pool's -128
// padding (every pool window holds a real pixel).
// ---------------------------------------------------------------------------

constexpr int KBS = KP / 16;                      // 16-deep K blocks

template <int COUT>
struct SmemS8 {
  static constexpr int win = 0;
  static constexpr int tab = align128(win + WIN);
  static constexpr int b = align128(tab + KP * 4);
  static constexpr int a = align128(b + KP * COUT);
  static constexpr int scr = align128(a + MCH * KP);
  static constexpr int conv = align128(scr + (NT / 32) * 256 * 4);
  static constexpr int bytes = align128(conv + NPIX * COUT);
};

template <int COUT>
__global__ void __launch_bounds__(NT)
stem_s8_kernel(const int8_t* __restrict__ x,    // (N, H, W, C)
               const int8_t* __restrict__ w,    // (49*C, COUT)
               const float* __restrict__ mul,   // (COUT,)
               const float* __restrict__ bias,  // (COUT,)
               int8_t* __restrict__ out,        // (N, Ho, Wo, COUT)
               int H, int W, int C, int Hc, int Wc, int Ho, int Wo) {
  using L = SmemS8<COUT>;
  constexpr int NW = COUT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* win = reinterpret_cast<int8_t*>(smem + L::win);
  int* tab = reinterpret_cast<int*>(smem + L::tab);
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + L::b);
  int8_t* As = reinterpret_cast<int8_t*>(smem + L::a);
  int8_t* conv = reinterpret_cast<int8_t*>(smem + L::conv);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * TP, j0 = blockIdx.x * TQ;
  const int r0 = 2 * i0 - 1, c0 = 2 * j0 - 1;
  const int y0 = 2 * r0 - 3, x0 = 2 * c0 - 3;
  const int K = 49 * C;

  // 1. window, K table, weights (block (kb, nb) at (nb*KBS + kb)*256,
  //    row-major inside)
  const int8_t* xn = x + (int64_t)n * H * W * C;
  for (int e = tid; e < WIN; e += NT) {
    int8_t v = 0;
    const int c = e % CP, px = e / CP;
    const int yy = y0 + px / IC, xx = x0 + px % IC;
    if (c < C && yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = xn[((int64_t)yy * W + xx) * C + c];
    win[e] = v;
  }
  for (int k = tid; k < KP; k += NT) {
    const int dy = k / (7 * C), dx = (k / C) % 7, c = k % C;
    tab[k] = k < K ? (dy * IC + dx) * CP + c : -1;
  }
  for (int e = tid; e < KP * COUT / 16; e += NT) {
    const int k = e / (COUT / 16), o = (e % (COUT / 16)) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (k < K) v = *reinterpret_cast<const int4*>(w + (int64_t)k * COUT + o);
    *reinterpret_cast<int4*>(Bs + ((o / 16) * KBS + k / 16) * 256 +
                             (k % 16) * 16) = v;
  }
  __syncthreads();

  // 2. the conv tile, MCH conv pixels at a time
  const int msub = warp >> 1;
  const int nb0 = (warp & 1) * NW;                // first 16-wide col block
  int* scr = reinterpret_cast<int*>(smem + L::scr) + warp * 256;
  for (int mc = 0; mc < NCH; ++mc) {
    for (int e = tid; e < MCH * KP; e += NT) {
      const int row = e / KP, k = e % KP;
      const int p = mc * MCH + row;
      const int t = tab[k];
      int8_t v = 0;
      if (p < NPIX && t >= 0)
        v = win[(2 * (p / CC) * IC + 2 * (p % CC)) * CP + t];
      As[((row / 16) * KBS + k / 16) * 256 + (row % 16) * 16 + k % 16] = v;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) wmma::fill_fragment(acc[j], 0);
    for (int kb = 0; kb < KBS; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + (msub * KBS + kb) * 256, 16);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + ((nb0 + j) * KBS + kb) * 256, 16);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }

    // epilogue: rq8; off-image conv pixels are the pool's padding
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int t = lane; t < 256; t += 32) {
        const int p = mc * MCH + msub * 16 + t / 16;
        const int o = (nb0 + j) * 16 + t % 16;
        if (p < NPIX) {
          const int cr = r0 + p / CC, cc = c0 + p % CC;
          float v = 0.0f;
          if (cr >= 0 && cr < Hc && cc >= 0 && cc < Wc)
            v = fminf(fmaxf(rintf(__fadd_rn(__fmul_rn((float)scr[t], mul[o]),
                                            bias[o])), 0.0f), 127.0f);
          conv[p * COUT + o] = (int8_t)(int)v;
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // 3. max-pool 3x3/2 over the int8 conv tile
  for (int e = tid; e < TP * TQ * COUT; e += NT) {
    const int o = e % COUT, q = e / COUT;
    const int pi = q / TQ, pj = q % TQ;
    const int i = i0 + pi, j = j0 + pj;
    if (i >= Ho || j >= Wo) continue;
    int m = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = max(m, (int)conv[((2 * pi + dy) * CC + 2 * pj + dx) * COUT + o]);
    out[(((int64_t)n * Ho + i) * Wo + j) * COUT + o] = (int8_t)m;
  }
}

template <int COUT>
int launch_s8(const void* x, const void* w, const void* mul,
              const void* bias, void* out, int N, int H, int W, int C,
              cudaStream_t stream) {
  constexpr int bytes = SmemS8<COUT>::bytes;
  static_assert(bytes <= 232448, "int8 stem tile exceeds shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      stem_s8_kernel<COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Ho = (Hc - 1) / 2 + 1, Wo = (Wc - 1) / 2 + 1;
  dim3 grid((Wo + TQ - 1) / TQ, (Ho + TP - 1) / TP, N);
  stem_s8_kernel<COUT><<<grid, NT, bytes, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)mul,
      (const float*)bias, (int8_t*)out, H, W, C, Hc, Wc, Ho, Wo);
  return (int)cudaGetLastError();
}

template <int COUT, bool Q8>
int launch(const void* x, const void* w, const void* bias, void* out, int N,
           int H, int W, int C, cudaStream_t stream) {
  constexpr int bytes = Smem<COUT>::bytes;
  static_assert(bytes <= 232448, "stem tile exceeds shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      stem_kernel<COUT, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Ho = (Hc - 1) / 2 + 1, Wo = (Wc - 1) / 2 + 1;
  dim3 grid((Wo + TQ - 1) / TQ, (Ho + TP - 1) / TP, N);
  stem_kernel<COUT, Q8><<<grid, NT, bytes, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      out, H, W, C, Hc, Wc, Ho, Wo);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, C) bf16 with C <= 5; w (7, 7, C, cout) bf16 read as
// (49*C, cout); bias (cout,) f32; out (N, Ho, Wo, cout) bf16, or int8
// with q8. cout is 64 or 128; pointers 16-byte aligned (checked by the
// Python wrapper).
extern "C" int io_fused_stem(const void* x, const void* w, const void* bias,
                             void* out, int N, int H, int W, int C, int cout,
                             int q8, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cout == 64)
    return q8 ? launch<64, true>(x, w, bias, out, N, H, W, C, s)
              : launch<64, false>(x, w, bias, out, N, H, W, C, s);
  if (cout == 128)
    return q8 ? launch<128, true>(x, w, bias, out, N, H, W, C, s)
              : launch<128, false>(x, w, bias, out, N, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// int8c stem: x (N, H, W, C) int8 with C <= 5; w (7, 7, C, cout) int8 read
// as (49*C, cout); mul, bias (cout,) f32; out (N, Ho, Wo, cout) int8. cout
// is 64 or 128; pointers 16-byte aligned (checked by the Python wrapper).
extern "C" int io_fused_stem_s8(const void* x, const void* w, const void* mul,
                                const void* bias, void* out, int N, int H,
                                int W, int C, int cout, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cout == 64)
    return launch_s8<64>(x, w, mul, bias, out, N, H, W, C, s);
  if (cout == 128)
    return launch_s8<128>(x, w, mul, bias, out, N, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
