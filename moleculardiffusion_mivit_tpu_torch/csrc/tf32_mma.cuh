// Tensor-core and asynchronous-copy primitives used by the implicit-GEMM
// kernels in conv_rows.cuh: mma.sync and cp.async (sm_80 and later) and the
// warpgroup-wide wgmma (sm_90a only); the TF32 products of the f32 kernels
// and the bf16 products of the bf16 ones (end of the file).
//
// f32-grade products on the TF32 tensor cores ("3xTF32"): an f32 value a is
// split as a = big + small with big = tf32(a) (round to nearest, 10 mantissa
// bits) and small = a - big, of which the tensor core reads the 10 leading
// mantissa bits (the packed weights round small to TF32 first, activations
// split as they are read leave that truncation to the tensor core), and a
// product a*b is accumulated in f32 as small_a*big_b + big_a*small_b +
// big_a*big_b, small terms first. The dropped small_a*small_b term and the
// tail of small are ~2^-21 of the product, the size of f32's own rounding
// over a sum of this depth, so the result carries f32 accuracy where one TF32
// product would keep three decimal digits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// big = tf32(v) rounded to nearest (ties away from zero, as cvt.rna gives it)
// by integer arithmetic on the bits; small = v - big, exact in f32. The
// tensor core reads the top 19 bits of an operand and ignores the rest, so
// small needs no rounding of its own: its ignored tail is below 2^-21 of v.
// Three full-rate instructions per element; the cvt route is quarter rate.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// D (16x8, f32) += A (16x8, row-major, tf32) * B (8x8, column-major, tf32).
// With gid = lane / 4 and tig = lane % 4 a thread holds
//   a0 = A[gid][tig]  a1 = A[gid+8][tig]  a2 = A[gid][tig+4]  a3 = A[gid+8][tig+4]
//   b0 = B[tig][gid]  b1 = B[tig+4][gid]
//   d0 = D[gid][2tig] d1 = D[gid][2tig+1] d2 = D[gid+8][2tig] d3 = D[gid+8][2tig+1]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  // volatile: a warp-wide instruction must stay where every lane reaches it,
  // and the compiler may otherwise sink it into a branch that uses its result
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// How the kernels use it. The tensor core adds into its accumulator with
// truncation, not rounding to nearest. Chained over a reduction of depth 1152
// (432 mma) that shrinks every sum by ~1e-5, which BatchNorm hides in the
// forward and the gradients do not forgive. So only the three products of one
// step of depth 8 are chained on the tensor core, from zero, and the running
// sum is kept by ordinary f32 adds (round to nearest); wgmma accumulates the
// same way and is used the same way. The three mma.sync products of one tile
// depend on each other and an mma's result takes ~30 cycles, so each term is
// issued for all of a warp's tiles before the next: a warp issues in order,
// and a dependent mma right behind its producer would wait out that latency.

// ---- wgmma: the warpgroup-wide tensor-core instruction of sm_90a. Four
// warps together multiply a 64 x 8 tile of A, held in their registers in the
// mma_tf32 layout (warp w of the group owns rows 16 w .. 16 w + 15), by an
// 8 x N tile of B that the tensor core reads from shared memory itself, and
// add into 4 N / 8 accumulator registers a thread laid out like N / 8 mma_tf32
// results side by side. It runs asynchronously: registers it reads or writes
// must not be touched between issue and wgmma_wait.

// Descriptor of a B tile in shared memory: element (k, n) of the 8 x N tile
// at float offset ((n / 8 * 2 + k / 4) * 8 + n % 8) * 4 + k % 4 from `tile`,
// i.e. 8 x 4 "core matrices" of 128 contiguous bytes, no swizzle; 128 bytes
// to the next one along k, 256 bytes to the next 8 columns.
__device__ __forceinline__ uint64_t wgmma_b_desc(const float* tile) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{128 >> 4} << 16) | (uint64_t{256 >> 4} << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits for every wgmma issued so far, then hands the registers they used
// back to the compiler: the empty asm statements keep it from reading the
// accumulators, or reusing the A registers, before the wait.
template <int NT>
__device__ __forceinline__ void wgmma_wait(float (&d)[NT][4], uint32_t (&a_big)[4],
                                           uint32_t (&a_small)[4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a_big[e]), "+r"(a_small[e])::"memory");
}

// d (64 x 8 NT) = A * B, or d += A * B with `accumulate`, NT = 8 or 4.
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4], const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  static_assert(NT == 8 || NT == 4, "wgmma tiles of 64 or 32 columns");
  if constexpr (NT == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
          "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
          "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
          "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
          "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
          "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
          "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
          "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
          "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
  }
}

// 16-byte asynchronous copy global -> shared; with `valid` false the 16
// bytes are zero-filled and the source is not read.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem_src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- bf16: one product per f32 product, as the JAX kernel computes on the
// TPU off its exact mode (bf16 operands, f32 accumulation). The chain of
// mma accumulates on the tensor core: its truncating adds cost ~1e-5 of a
// sum of this depth, far below bf16's own 2^-9, so no f32 side sum is kept.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// f32 -> T, rounding to nearest even for bf16.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value a product of the T kernels reads of an f32 operand: itself for
// f32, its bf16 rounding for bf16.
template <typename T>
__device__ __forceinline__ float operand(float v) {
  return to_f32(from_f32<T>(v));
}

// Two bf16 in one register, `lo` in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D (16x8, f32) += A (16x16, row-major, bf16) * B (16x8, column-major, bf16).
// With gid = lane / 4 and tig = lane % 4 a thread holds, each register two
// bf16 of adjacent k (the lower in the low half):
//   a0 = A[gid][2tig..]    a1 = A[gid+8][2tig..]  a2 = A[gid][2tig+8..]  a3 = A[gid+8][2tig+8..]
//   b0 = B[2tig..][gid]    b1 = B[2tig+8..][gid]
//   d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tc
