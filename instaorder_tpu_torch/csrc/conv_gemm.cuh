// Building blocks shared by the implicit-GEMM block kernels for Hopper
// (sm_90a): csrc/bottleneck_v2.cu (bf16 operands, f32 sums),
// csrc/bottleneck_int8.cu (int8 operands, s32 sums) and
// csrc/bottleneck_f32.cu (f32 operands split into TF32 halves, f32
// sums). The stem kernels (csrc/stem.cu) use its copy, descriptor,
// wgmma and fragment helpers.
//
// The design both kernels follow:
//   - a CTA computes a 128 x BN output tile (BN = 64 or 128, chosen by
//     ops/gemm_layout.tile_n) with two consumer warpgroups of 64 rows
//     each, through wgmma reading both operands from shared memory;
//   - a K step is 128 bytes of every operand row (64 bf16, 128 int8 or
//     32 f32),
//     stored with the 128-byte swizzle wgmma reads: 16-byte chunk c of
//     row r at r * 128 + ((c ^ r % 8) * 16), every tile 1024-byte aligned;
//   - all 256 threads issue cp.async 16-byte copies of the im2col gather
//     (and of the weights) into a ring of kStages stages in dynamic shared
//     memory, kStages - 1 steps ahead of the MMAs; src-size 0 zero-fills
//     the 3x3 halo, the stride-2 edges, rows past M and K past a
//     segment's end;
//   - the ring (~100 KB) and the registers (<= 128 a thread) leave room
//     for two CTAs on an SM, so that one CTA's prologue and epilogue run
//     under the other's MMAs (a 1x1 at K = 64..512 is 1..8 K steps);
//   - the epilogue works on the accumulator registers and stages the
//     residual and the output tile through the idle ring, so that global
//     memory is read and written 16 bytes a thread.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace convgemm {

constexpr int kBM = 128;          // output rows of a CTA
constexpr int kThreads = 256;     // two warpgroups
constexpr int kStages = 3;        // depth of the cp.async ring
constexpr int kWgRows = 64;       // rows of one warpgroup's wgmma
constexpr int kRowBytes = 128;    // one K step of one operand row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory rounded up to the 1024-byte swizzle period (the
// allocation carries 1024 bytes of slack for it)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// byte offset of 16-byte chunk `chunk` (0..7) of 128-byte row `row` in a
// tile stored with the 128-byte swizzle
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return (uint32_t)(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; valid == false writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// makes this thread's shared-memory writes (cp.async and st.shared, the
// generic proxy) visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128-byte lines of a tile's rows (rows of `bytes` bytes, `ld` bytes
// apart, rows from `rows`) into L2, so that an epilogue that reads the
// tile after the K loop finds it there
__device__ __forceinline__ void prefetch_rows_l2(const void* tile, int64_t ld,
                                                 int rows, int bytes,
                                                 int tid) {
  const int lines = (bytes + 127) / 128;
  for (int e = tid; e < rows * lines; e += kThreads) {
    const int row = e / lines;
    asm volatile("prefetch.global.L2 [%0];\n"
                 :: "l"(static_cast<const char*>(tile) + row * ld
                        + (e - row * lines) * 128));
  }
}

// a rounded to TF32 (10 mantissa bits, to nearest, ties away from zero)
// as an f32 whose low 13 mantissa bits are 0; a - tf32_rna(a) is exact
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (bytes, multiples of 16)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
       | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
       | (1ull << 62);
}

// K-major operand (rows of 128 bytes along K, 8-row groups 1024 bytes
// apart), starting `koff` bytes into the K step
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int koff) {
  return smem_desc(tile + koff, 16, 1024);
}

// K-major operand without swizzle: each 8-row core matrix is 8 rows of
// 16 bytes stored as 128 contiguous bytes; `lbo` bytes between the core
// matrices of a K step, `sbo` between 8-row groups (csrc/stem.cu)
__device__ __forceinline__ uint64_t desc_kmajor_noswz(uint32_t addr,
                                                      uint32_t lbo,
                                                      uint32_t sbo) {
  return smem_desc(addr, lbo, sbo) & ~(3ull << 62);
}

// MN-major bf16 operand: 64-column atoms of `atom` bytes (K rows of 128
// bytes, 8-row groups 1024 bytes apart), starting at K row `krow`
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int krow,
                                                 uint32_t atom) {
  return smem_desc(tile + krow * kRowBytes, atom, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// D(64 x BN, f32) += A(64 x 16, K-major) . B(16 x BN, MN-major), bf16
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);

// D(64 x BN, s32) += A(64 x 32, K-major) . B(32 x BN, K-major), int8
template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b);

// D(64 x BN, f32) = A(64 x 8, K-major) . B(8 x BN, K-major) (+ D where
// accumulate != 0), tf32: both operands K-major (tf32 wgmma has no
// transpose), each element an f32 whose low 13 mantissa bits are 0
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64, f32) = A(64 x 8) . B(8 x 64, K-major) (+ D where accumulate
// != 0), tf32, A from registers: a[i] of a thread holds row 16 * warp +
// lane / 4 + 8 * (i % 2) of its warpgroup's 64 rows and column lane % 4 +
// 4 * (i / 2), each the bits of an f32 whose low 13 mantissa bits are 0.
// The registers are read asynchronously: they stay unchanged until a
// wgmma_wait retires the group (csrc/stem.cu)
__device__ __forceinline__ void wgmma_tf32_rs64(float* d, const uint32_t* a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// keeps the compiler from moving reads of accumulator registers above the
// wgmma_wait that retires them
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}

// Accumulator layout of wgmma m64nN: element 4 * j + e of a thread holds
// row 16 * warp + lane / 4 + 8 * (e / 2) of its warpgroup's 64 rows and
// column 8 * j + 2 * (lane % 4) + e % 2.
__device__ __forceinline__ int frag_row(int tid, int half) {
  return (tid >> 7) * kWgRows + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2)
         + 8 * half;
}

__device__ __forceinline__ int frag_col(int tid, int j) {
  return 8 * j + 2 * (tid & 3);
}

// Output rows m0 + first + step * i (i < R) of the (N, Ho, Wo) grid:
// image, output row and column, and whether the row exists.
template <int R>
__device__ __forceinline__ void decode_rows(int64_t m0, int first, int step,
                                            int M, int Ho, int Wo, int* n,
                                            int* ho, int* wo, bool* ok) {
  const int hw = Ho * Wo;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t m = m0 + first + step * i;
    ok[i] = m < M;
    const int mm = ok[i] ? (int)m : 0;
    n[i] = mm / hw;
    const int rem = mm - n[i] * hw;
    ho[i] = rem / Wo;
    wo[i] = rem - ho[i] * Wo;
  }
}

// One thread's part of the im2col gather of one K segment (an NHWC
// activation read as a 1x1 or a 3x3 pad-1 view at stride s): R output
// rows, fixed for the kernel, and a cursor on the segment's K axis (K =
// taps * C, tap-major) that moves one K step at a time. A 16-byte read
// at the cursor lies in one tap because C is a multiple of the elements
// a read holds (checked by the Python wrappers).
template <int R>
struct Gather {
  const char* img[R];   // image n's plane of the activation
  int hb[R], wb[R];     // the row's window origin (ho * s - pad, ...)
  const char* base;
  int k, c, dy, dx;     // cursor: K element, its channel, its tap
  int C, H, W, ksize, K, es;

  __device__ __forceinline__ void start(const void* x, int es_, int C_,
                                        int H_, int W_, int stride, int ks,
                                        int K_, const int* n, const int* ho,
                                        const int* wo, const bool* ok,
                                        int koff) {
    base = static_cast<const char*>(x);
    es = es_; C = C_; H = H_; W = W_; ksize = ks; K = K_;
    const int pad = ks == 3 ? 1 : 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      img[i] = base + (int64_t)n[i] * H * W * C * es;
      hb[i] = ok[i] ? ho[i] * stride - pad : -(1 << 28);
      wb[i] = wo[i] * stride - pad;
    }
    k = koff;
    c = koff;
    dy = dx = 0;
    while (c >= C) next_tap();
  }

  __device__ __forceinline__ void next_tap() {
    c -= C;
    if (++dx == ksize) {
      dx = 0;
      ++dy;
    }
  }

  __device__ __forceinline__ void advance(int elems) {
    k += elems;
    c += elems;
    while (c >= C) next_tap();
  }

  // row i's 16 bytes at the cursor; valid == false: outside the image,
  // past M or past K (zero fill)
  __device__ __forceinline__ const void* src(int i, bool& valid) const {
    const int hi = hb[i] + dy, wi = wb[i] + dx;
    valid = k < K && hi >= 0 && hi < H && wi >= 0 && wi < W;
    return valid ? img[i] + ((int64_t)(hi * W + wi) * C + c) * es : base;
  }
};

// the most cards a process launches on; per-device launch state (the
// shared-memory attribute, the stems' grid caps) is kept in arrays this long
constexpr int kMaxDevices = 64;

// the current device (the one a launch runs on), checked against
// kMaxDevices
inline int current_device(int& dev) {
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return dev < kMaxDevices ? 0 : (int)cudaErrorInvalidDevice;
}

// once per kernel instantiation and device: allow `bytes` of dynamic
// shared memory (the attribute belongs to the device: a flag for the
// process would leave a second card's launch refused)
template <class Kernel>
inline int allow_smem(Kernel kernel, int bytes,
                      bool (&done)[kMaxDevices]) {
  int dev = 0;
  int e = current_device(dev);
  if (e || done[dev]) return e;
  e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done[dev] = e == (int)cudaSuccess;
  return e;
}

}  // namespace convgemm
