// The bf16 tensor-core kernels of K2-bf16 / K3-bf16 (fused_embedding.cu):
// the implicit-GEMM 3x3 SAME (or 1x1) convolution and its data gradient, and
// the weight gradient, on Hopper's warpgroup instruction wgmma m64nNk16
// (bf16 operands, f32 accumulation on the tensor core), over activations in
// the channels-last row layout (R, C), R = images * S * S. They compute
// what the JAX kernel computes on the TPU off its exact mode: one bf16
// product per f32 product. The tensor core accumulates with truncating adds;
// over a sum of this depth that costs ~1e-5, far below bf16's own 2^-9.
//
// Both kernels keep conv_rows.cuh's slab: for output rows [row0, row0 + BM)
// every tap reads the input at a constant row offset dy*S + dx, so all taps
// read one contiguous slab of rows [row0 - S - 1, row0 + BM + S + 1), brought
// to shared memory once with 16-byte cp.async (zero-filled outside [0, R)).
// A slab row in a neighbouring image, or at the other end of an image row,
// is an out-of-image tap of that output pixel; the caller's table of 9
// validity bits per pixel says which. An out-of-image tap must add zero, and
// wgmma reads a shared-memory operand as it lies, so each kernel takes the
// operand that carries the output row from registers and zeroes it there:
// the slab fragment of the conv, the gradient fragment of the weight
// gradient. (The other choice, each image zero-padded to (S+2)^2 rows so
// that every tap is a plain address shift, computes (S+2)^2 / S^2 = 1.3-1.5x
// the products and breaks the rows of an 8-row core matrix at every image
// row; the register mask costs a select per register.)
//
// Members: as conv_rows.cuh, blockIdx.z (the weight gradient: z = member *
// chunks + chunk) picks a member's arrays at m times their member strides,
// and a member runs the tiles and sums a call for it alone runs.
#pragma once

#include <cstdint>

#include "conv_rows.cuh"
#include "operand_types.cuh"

namespace tc {

// Four 8 x 8 matrices of 16-bit values from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 (16 contiguous bytes); register i
// receives matrix i's row lane / 4, columns 2 (lane % 4) and + 1 (the lower
// in the low half). With .trans each matrix arrives transposed: column
// lane / 4, rows 2 (lane % 4) and + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Descriptor of a wgmma operand in shared memory without swizzle: "core
// matrices" of 8 rows of 16 bytes (128 contiguous bytes), `lbo` bytes from
// one core matrix to the next along the reduction (K), `sbo` bytes to the
// next along M or N. A core matrix of a K-major operand is 8 rows of M or N,
// each 8 consecutive k; of an MN-major one (read with the transpose bit) 8
// rows of k, each 8 consecutive columns. Its start needs only 16-byte
// alignment, so a row offset of a 16-byte-row layout is an address shift.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x N, f32) += A (64 x 16, bf16) * B (16 x N, bf16): four warps
// together; warp w of the group holds rows 16 w .. 16 w + 15 of A in the
// mma.sync m16n8k16 layout (gid = lane / 4, tig = lane % 4: a0 = A[gid][2tig,
// +1], a1 = A[gid+8][2tig, +1], a2 = A[gid][2tig+8, +9], a3 = A[gid+8][2tig+8,
// +9], the lower k in the low half) and of d the same rows, d[j] = columns 8j
// + 2tig, + 1 of rows gid (d[j][0..1]) and gid + 8 (d[j][2..3]). B is read by
// the tensor core from shared memory through `b_desc`, K-major with
// TRANS_B = 0, MN-major with 1. Asynchronous: the registers it reads and
// writes stay untouched until wgmma_wait_bf16.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b_desc) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma tiles of 32, 64 or 128 columns");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1), "n"(TRANS_B));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1), "n"(TRANS_B));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1), "n"(TRANS_B));
  }

}

// Waits for every wgmma issued so far, then hands the accumulators and the A
// registers they read back to the compiler (the empty asm statements keep it
// from reading the one or reusing the other before the wait).
template <int NP, int NT, int NA>
__device__ __forceinline__ void wgmma_wait_bf16(float (&d)[NP][NT][4], uint32_t (&a)[NA][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[p][j][e])::"memory");
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

}  // namespace tc

namespace convbf {

using conv::ceil_div;
using conv::member_ptr;
using tc::bf16;

// ------------------------------------------------------------------ forward
// and data gradient:  y[r, c] = mask(add[r, c] + sum_{tap, k} x[r + off(tap), k] * w[tap][k][c])
//
// Packed weights (pack_weights_bf16_kernel): B[tap][k][n] (k the input
// channel, n the output channel) as [tap][K / 16][N / 8][2][8][8]: per tap,
// block of 16 k and block of 8 n, two core matrices (k 0-7, then k 8-15), each
// 8 rows n of the 8 k values of that n: a K-major B, 128 bytes to the next
// core matrix along k, 256 bytes to the next 8 columns. A stage's weight
// tile, KC x BN, is KC / 16 runs of BN * 16 contiguous values.
//
// Block tile BM x BN, BM = 64 WGS: warpgroup g multiplies slab rows 64 g ..
// 64 g + 63 by the whole tile, one wgmma m64nBNk16 per 16 channels, its A
// registers loaded by one ldmatrix.x4 a warp from the slab (row stride KC +
// 8 values: the 8 rows of a matrix fall on distinct banks) and zeroed where
// the tap leaves the image. One pipeline stage is one (channel chunk of KC,
// tap): a weight tile in a ring of kStages; the stage of tap 0 also brings
// the chunk's slab (two slab buffers for 3x3, kStages for 1x1, whose slabs
// turn over with every stage). Stage it + 2 loads while stage it computes;
// the warpgroups wait for their products before the barrier that lets a
// stage's buffers be refilled. (Keeping a stage's products in flight across
// that barrier, with a fourth weight tile and two sets of A registers,
// measured no faster on an NVIDIA H100 80GB HBM3 at 700 W.) The epilogue
// stages the tile in shared memory, writes it in 16-byte row stores with
// `add` and `mask` fused, and with `stat_partial` writes the per-column mean
// and centred sum of squares of the tile's rows for the BatchNorm
// statistics.

constexpr int kStages = 3;

// Row stride (floats) of the tile the epilogue stages: the float2 writes of
// a warp's 8 rows fall on distinct bank pairs.
__host__ __device__ constexpr int tile_stride(int BN) { return BN + 8; }

// Dynamic shared memory: the pipeline's weight tiles and slabs, or the
// epilogue's staged tile, its partial sums (a float a thread) and means,
// whichever is larger.
template <int BN, int KC>
constexpr int conv_smem_bytes(int BM, int slab_rows, int n_slabs) {
  const int pipeline = 2 * (kStages * KC * BN + n_slabs * slab_rows * (KC + 8));
  const int epilogue = 4 * (BM * tile_stride(BN) + 2 * BM + BN);
  return pipeline > epilogue ? pipeline : epilogue;
}

template <int BN, int WGS, int KC>
__global__ void __launch_bounds__(WGS * 128, 2) conv_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wp, const float* add,
    const bf16* __restrict__ mask, float* y, double* __restrict__ stat_partial,
    const int* __restrict__ valid, int R, int S, int Ci, int Co, int taps, long long x_ms,
    long long wp_ms, long long add_ms, long long mask_ms, long long y_ms, long long stat_ms) {
  constexpr int BM = 64 * WGS, NT = BN / 8, NK = KC / 16;
  constexpr int kThreads = 128 * WGS;
  constexpr int A_STRIDE = KC + 8;
  constexpr int W_TILE = KC * BN;
  constexpr int kTileStride = tile_stride(BN);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);  // [kStages][KC / 16][BN / 8][2][8][8]
  bf16* a_s = w_s + kStages * W_TILE;             // [n_slabs][slab_rows][A_STRIDE]
  const int halo = taps == 9 ? S + 1 : 0;
  const int slab_rows = BM + 2 * halo;
  const int slab_elems = slab_rows * A_STRIDE;
  const int n_slabs = taps == 9 ? 2 : kStages;

  const int member = blockIdx.z;
  x = member_ptr(x, x_ms, member);
  wp = member_ptr(wp, wp_ms, member);
  add = member_ptr(add, add_ms, member);
  mask = member_ptr(mask, mask_ms, member);
  y = member_ptr(y, y_ms, member);
  stat_partial = member_ptr(stat_partial, stat_ms, member);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int n_stages = (Ci / KC) * taps;

  int vm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + gid + h * 8;
    vm[h] = r < R ? (taps == 9 ? valid[r % (S * S)] : 1) : 0;
  }

  auto load_stage = [&](int chunk, int tap, int slot, int slab) {
    if (tap == 0) {
      bf16* dst = a_s + slab * slab_elems;
      const int first = row0 - halo;
      for (int i = tid; i < slab_rows * (KC / 8); i += kThreads) {
        const int row = i / (KC / 8), q = i % (KC / 8);
        const int gr = first + row;
        const bool ok = gr >= 0 && gr < R;
        tc::cp_async16(dst + row * A_STRIDE + q * 8,
                       x + (static_cast<size_t>(ok ? gr : 0) * Ci + chunk * KC + q * 8), ok);
      }
    }
    const bf16* src = wp + (static_cast<size_t>(tap * (Ci / 16) + chunk * NK) * (Co / 8) + col0 / 8) * 128;
    bf16* dst = w_s + slot * W_TILE;
    for (int i = tid; i < NK * BN * 2; i += kThreads) {
      const int kk = i / (BN * 2), q = i % (BN * 2);
      tc::cp_async16(dst + kk * BN * 16 + q * 8, src + static_cast<size_t>(kk) * (Co / 8) * 128 + q * 8, true);
    }
  };

  float acc[1][NT][4];  // one accumulator tile (wgmma_wait_bf16 takes a set of them)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;

  // load cursor: the next stage to bring in
  int l_n = 0, l_chunk = 0, l_tap = 0, l_slot = 0, l_slab = 0;
  auto load_next = [&]() {
    if (l_n < n_stages) {
      load_stage(l_chunk, l_tap, l_slot, l_slab);
      ++l_n;
      l_slot = l_slot + 1 == kStages ? 0 : l_slot + 1;
      if (++l_tap == taps) {
        l_tap = 0;
        ++l_chunk;
        l_slab = l_slab + 1 == n_slabs ? 0 : l_slab + 1;
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next();

  // this lane's ldmatrix row: row lane % 8 of matrix lane / 8, matrices
  // (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
  const int a_lane = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * A_STRIDE + (lane >> 4) * 8;
  int c_tap = 0, c_slot = 0, c_slab = 0;
  for (int it = 0; it < n_stages; ++it) {
    tc::cp_async_wait<kStages - 2>();  // stage `it` has landed
    __syncthreads();                   // and every warp is done with stage it - 1
    load_next();                       // refills the slot of stage it - 1
    const int off = taps == 9 ? (c_tap / 3 - 1) * S + (c_tap % 3 - 1) : 0;
    const bf16* As = a_s + c_slab * slab_elems + (halo + off) * A_STRIDE + a_lane;
    const bf16* Ws = w_s + c_slot * W_TILE;
    const bool v0 = (vm[0] >> c_tap) & 1, v1 = (vm[1] >> c_tap) & 1;
    uint32_t a[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      tc::ldsm_x4(a[kk], As + kk * 16);
      a[kk][0] = v0 ? a[kk][0] : 0u;
      a[kk][1] = v1 ? a[kk][1] : 0u;
      a[kk][2] = v0 ? a[kk][2] : 0u;
      a[kk][3] = v1 ? a[kk][3] : 0u;
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      tc::wgmma_bf16<BN, 0>(acc[0], a[kk], tc::smem_desc(Ws + kk * BN * 16, 128, 256));
    tc::wgmma_commit();
    tc::wgmma_wait_bf16(acc, a);
    c_slot = c_slot + 1 == kStages ? 0 : c_slot + 1;
    if (++c_tap == taps) {
      c_tap = 0;
      c_slab = c_slab + 1 == n_slabs ? 0 : c_slab + 1;
    }
  }

  // The epilogue goes through shared memory, free once every warpgroup's
  // products are done: the tile is staged as f32 rows, written out with
  // 16-byte row-contiguous stores (`add` and `mask` fused), and the
  // statistics are taken from it by column, kThreads / BN threads a column
  // over contiguous runs of rows, combined in a fixed order.
  tc::cp_async_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem_raw);  // [BM][kTileStride]
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (warp * 16 + gid + h * 8) * kTileStride + j * 8 + 2 * tig) =
          make_float2(acc[0][j][2 * h], acc[0][j][2 * h + 1]);
  __syncthreads();
  const int n_in = min(BM, R - row0);
  for (int i = tid; i < n_in * (BN / 4); i += kThreads) {
    const int row = i / (BN / 4), c = (i % (BN / 4)) * 4;
    float4 out = *reinterpret_cast<const float4*>(tile + row * kTileStride + c);
    const size_t o = static_cast<size_t>(row0 + row) * Co + col0 + c;
    if (add) {
      const float4 t = *reinterpret_cast<const float4*>(add + o);
      out.x += t.x;
      out.y += t.y;
      out.z += t.z;
      out.w += t.w;
    }
    if (mask) {
      const uint2 mb = *reinterpret_cast<const uint2*>(mask + o);  // four bf16
      const float2 m01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&mb.x));
      const float2 m23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&mb.y));
      if (!(m01.x > 0.f)) out.x = 0.f;
      if (!(m01.y > 0.f)) out.y = 0.f;
      if (!(m23.x > 0.f)) out.z = 0.f;
      if (!(m23.y > 0.f)) out.w = 0.f;
    }
    *reinterpret_cast<float4*>(y + o) = out;
  }

  if (stat_partial == nullptr) return;
  // Per-channel mean and centred sum of squares of this tile's rows: the
  // sum, then the squares about the tile's own mean.
  constexpr int TPC = kThreads / BN, PER = BM / TPC;
  float* red = tile + BM * kTileStride;  // [TPC][BN]
  float* mean_s = red + TPC * BN;        // [BN]
  const int c = tid % BN, part = tid / BN;
  const int r_lo = part * PER, r_hi = min(r_lo + PER, n_in);
  float s = 0.f;
  for (int r = r_lo; r < r_hi; ++r) s += tile[r * kTileStride + c];
  red[part * BN + c] = s;
  __syncthreads();
  if (tid < BN) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < TPC; ++q) t += red[q * BN + tid];
    mean_s[tid] = t / static_cast<float>(n_in);
  }
  __syncthreads();
  const float m = mean_s[c];
  s = 0.f;
  for (int r = r_lo; r < r_hi; ++r) {
    const float d = tile[r * kTileStride + c] - m;
    s += d * d;
  }
  red[part * BN + c] = s;
  __syncthreads();
  if (tid < BN) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < TPC; ++q) t += red[q * BN + tid];
    const size_t o = static_cast<size_t>(blockIdx.x) * 2 * Co + col0 + tid;
    stat_partial[o] = static_cast<double>(mean_s[tid]);
    stat_partial[o + Co] = static_cast<double>(t);
  }
}

template <int BN, int WGS, int KC>
int launch_conv_tile(const bf16* x, const bf16* wp, const float* add, const bf16* mask, float* y,
                     double* stat_partial, const int* valid, int R, int S, int Ci, int Co, int taps,
                     int M, const conv::ConvStrides& ms, cudaStream_t st) {
  constexpr int BM = 64 * WGS;
  const int halo = taps == 9 ? S + 1 : 0;
  const int bytes = conv_smem_bytes<BN, KC>(BM, BM + 2 * halo, taps == 9 ? 2 : kStages);
  auto kernel = conv_bf16_kernel<BN, WGS, KC>;
  static conv::SmemGrant granted;
  const cudaError_t e = conv::grant_smem(kernel, bytes, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ceil_div(R, BM), Co / BN, M);
  kernel<<<grid, 128 * WGS, bytes, st>>>(x, wp, add, mask, y, stat_partial, valid, R, S, Ci, Co, taps,
                                         ms.x, ms.wp, ms.add, ms.mask, ms.y, ms.stat);
  return static_cast<int>(cudaGetLastError());
}

// The tile: 64 or 128 rows by 32, 64 or 128 columns. Wider tiles read each
// weight tile (from L2) for more products and each slab fragment for more
// columns, so the largest tile that still gives the grid two blocks for
// every SM is taken: 128 rows by all of Co (up to 128), else 64 rows, else
// 64 rows and narrower columns (down to 32) until the grid covers the card
// or the tile is the smallest. (At 38,880 rows 64-row tiles made the convs
// 7-8 % faster on an NVIDIA H100 80GB HBM3 at 700 W but doubled the
// BatchNorm partials to merge, which cost as much in K2-bf16.) KC = 64 input channels a stage where Ci
// allows it. Returns the rows per tile through `bm` (the BatchNorm merge
// needs it). With M members the tile is the one a member alone gets.
inline int launch_conv(const bf16* x, const bf16* wp, const float* add, const bf16* mask, float* y,
                       double* stat_partial, const int* valid, int R, int S, int Ci, int Co, int taps,
                       int M, const conv::ConvStrides& ms, int* bm, cudaStream_t st) {
  if (Ci % 32 != 0 || Co % 32 != 0 || (taps != 1 && taps != 9) || M < 1 || M > conv::kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  int bn = Co % 128 == 0 ? 128 : Co % 64 == 0 ? 64 : 32;
  *bm = 128;
  const int want = 2 * conv::kSMs;
  if (ceil_div(R, 128) * (Co / bn) < want) {
    *bm = 64;
    while (bn > 32 && ceil_div(R, 64) * (Co / bn) < want) bn /= 2;
  }
#define CONV_TILE(BN_, WGS_, KC_) \
  return launch_conv_tile<BN_, WGS_, KC_>(x, wp, add, mask, y, stat_partial, valid, R, S, Ci, Co, taps, M, ms, st)
  const int wgs = *bm / 64;
  if (Ci % 64 == 0) {
    if (bn == 128) {
      if (wgs == 2) CONV_TILE(128, 2, 64);
      CONV_TILE(128, 1, 64);
    }
    if (bn == 64) {
      if (wgs == 2) CONV_TILE(64, 2, 64);
      CONV_TILE(64, 1, 64);
    }
    if (wgs == 2) CONV_TILE(32, 2, 64);
    CONV_TILE(32, 1, 64);
  }
  if (bn == 128) return static_cast<int>(cudaErrorInvalidValue);  // Ci = 32 feeds Co = 64 only
  if (bn == 64) {
    if (wgs == 2) CONV_TILE(64, 2, 32);
    CONV_TILE(64, 1, 32);
  }
  if (wgs == 2) CONV_TILE(32, 2, 32);
  CONV_TILE(32, 1, 32);
#undef CONV_TILE
}

// ---------------------------------------------------------- weight gradient
// partial[chunk][tap][ci][co] = sum over the chunk's rows r of
//   valid(r, tap) * x[r + off(tap), ci] * g[r, co]
// as the product g^T (M = co, 64 a block) times the tap-shifted slab (N =
// ci, CIB a block), reduced over rows (K, 16 a wgmma). The slab lies in
// shared memory as [CIB / 8][slab row][8 channels], so 8 consecutive slab
// rows of one channel group are one core matrix of an MN-major B (rows k,
// 8 channels each): 128 bytes to the next 8 rows, a slab plane to the next
// 8 channels, and the tap's row offset a shift of the descriptor's start by
// 16 bytes a row. The tensor core reads B through the transpose bit. A =
// g^T comes from registers: one ldmatrix.x4.trans a warp per 16 rows from the
// g rows (stride 72 values: distinct banks), then per tap each register's
// two rows masked by their validity bits (rows past the chunk have none).
// A 3x3 block runs three warpgroups, one per row of taps (dy), each three
// taps on the same A registers; a 1x1 block one. (Writing the partials as
// whole rows through shared memory, fetching a step's fragment during the
// step before, or bringing the validity words by cp.async measured no
// faster on an NVIDIA H100 80GB HBM3 at 700 W.) Each block sums one row
// chunk; the chunks are then summed in a fixed order in double by the
// caller (sum_chunks_kernel): no atomics on parameter gradients.

constexpr int kWgCOB = 64;
constexpr int kWgStages = 3;
constexpr int kWgGStride = kWgCOB + 8;

template <int TAPS>
__host__ __device__ constexpr int wgrad_rows_per_stage() {
  return TAPS == 9 ? 128 : 64;
}

// Bytes of one stage: the x slab, the g rows (bf16), the rows' validity words.
template <int TAPS, int CIB>
__host__ __device__ inline int wgrad_stage_bytes(int S) {
  constexpr int RB = wgrad_rows_per_stage<TAPS>();
  const int halo = TAPS == 9 ? S + 1 : 0;
  return 2 * ((RB + 2 * halo) * CIB + RB * kWgGStride) + 4 * RB;
}

template <int TAPS, int CIB>
__global__ void __launch_bounds__(TAPS == 9 ? 384 : 128, 1) wgrad_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g, float* __restrict__ partial,
    const int* __restrict__ valid, int R, int S, int Ci, int Co, int rows_per_chunk, int chunks,
    long long x_ms, long long g_ms, long long partial_ms) {
  constexpr int NWG = TAPS == 9 ? 3 : 1, TPW = TAPS / NWG;  // warpgroups, taps of each
  constexpr int kThreads = NWG * 128, NT = CIB / 8;
  constexpr int RB = wgrad_rows_per_stage<TAPS>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int member = blockIdx.z / chunks;
  x = member_ptr(x, x_ms, member);
  g = member_ptr(g, g_ms, member);
  partial = member_ptr(partial, partial_ms, member);
  const int halo = TAPS == 9 ? S + 1 : 0;
  const int slab_rows = RB + 2 * halo;
  const int stage_bytes = wgrad_stage_bytes<TAPS, CIB>(S);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int ci0 = blockIdx.x * CIB, co0 = blockIdx.y * kWgCOB, chunk = blockIdx.z % chunks;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(R, r_begin + rows_per_chunk);
  const int steps = (r_end - r_begin + RB - 1) / RB;
  const int SS = S * S;

  auto x_stage = [&](int buf) { return reinterpret_cast<bf16*>(smem_raw + buf * stage_bytes); };
  auto load_step = [&](int step, int buf) {
    bf16* x_s = x_stage(buf);  // [CIB / 8][slab_rows][8]
    bf16* g_s = x_s + slab_rows * CIB;  // [RB][kWgGStride]
    int* m_s = reinterpret_cast<int*>(g_s + RB * kWgGStride);
    const int rb = r_begin + step * RB;
    for (int i = tid; i < slab_rows * (CIB / 8); i += kThreads) {
      const int row = i / (CIB / 8), q = i % (CIB / 8);
      const int gr = rb - halo + row;
      const bool ok = gr >= 0 && gr < R;
      tc::cp_async16(x_s + (q * slab_rows + row) * 8, x + (static_cast<size_t>(ok ? gr : 0) * Ci + ci0 + q * 8), ok);
    }
    for (int i = tid; i < RB * (kWgCOB / 8); i += kThreads) {
      const int row = i / (kWgCOB / 8), q = i % (kWgCOB / 8);
      const int gr = rb + row;
      const bool ok = gr < r_end;
      tc::cp_async16(g_s + row * kWgGStride + q * 8, g + (static_cast<size_t>(ok ? gr : 0) * Co + co0 + q * 8), ok);
    }
    for (int i = tid; i < RB; i += kThreads) {
      const int r = rb + i;
      m_s[i] = r < r_end ? (TAPS == 9 ? valid[r % SS] : 1) : 0;
    }
  };

  float acc[TPW][NT][4];
#pragma unroll
  for (int u = 0; u < TPW; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load_step(s, s);
    tc::cp_async_commit();
  }
  // this lane's ldmatrix.trans row: g row lane % 8 (+ 8 for matrices 2, 3),
  // columns 16 wq (+ 8 for matrices 1, 3): a0..a3 = A (co x rows) at
  // (co 0-7, rows 0-7), (co 8-15, rows 0-7), (co 0-7, rows 8-15), (co 8-15, rows 8-15)
  const int g_lane = ((lane & 7) + (lane >> 4) * 8) * kWgGStride + wq * 16 + ((lane >> 3) & 1) * 8;
  for (int it = 0; it < steps; ++it) {
    tc::cp_async_wait<kWgStages - 2>();  // step `it` has landed
    __syncthreads();                     // and every warp is done with step it - 1
    if (it + kWgStages - 1 < steps) load_step(it + kWgStages - 1, (it + kWgStages - 1) % kWgStages);
    tc::cp_async_commit();

    const bf16* x_s = x_stage(it % kWgStages);
    const bf16* g_s = x_s + slab_rows * CIB;
    const int* m_s = reinterpret_cast<const int*>(g_s + RB * kWgGStride);
#pragma unroll 1
    for (int rl = 0; rl < RB; rl += 16) {
      uint32_t a[4];
      tc::ldsm_x4_trans(a, g_s + rl * kWgGStride + g_lane);
      const int* mr = m_s + rl + 2 * tig;  // rows 2 tig, + 1 (a0, a1) and + 8, + 9 (a2, a3)
      const int v[4] = {mr[0], mr[1], mr[8], mr[9]};
      uint32_t am[TPW][4];
#pragma unroll
      for (int u = 0; u < TPW; ++u) {
        const int t = wg * TPW + u;
        const uint32_t lo = (((v[0] >> t) & 1) ? 0x0000ffffu : 0u) | (((v[1] >> t) & 1) ? 0xffff0000u : 0u);
        const uint32_t hi = (((v[2] >> t) & 1) ? 0x0000ffffu : 0u) | (((v[3] >> t) & 1) ? 0xffff0000u : 0u);
        am[u][0] = a[0] & lo;
        am[u][1] = a[1] & lo;
        am[u][2] = a[2] & hi;
        am[u][3] = a[3] & hi;
      }
      tc::wgmma_fence();
#pragma unroll
      for (int u = 0; u < TPW; ++u) {
        const int t = wg * TPW + u;
        const int off = TAPS == 9 ? (t / 3 - 1) * S + (t % 3 - 1) : 0;
        const uint64_t desc = tc::smem_desc(x_s + (halo + rl + off) * 8, 128, slab_rows * 16);
        tc::wgmma_bf16<CIB, 1>(acc[u], am[u], desc);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_bf16(acc, am);
    }
  }

  // d[j] of tap t: co = co0 + 16 wq + gid (+ 8 for e >= 2), ci = ci0 + 8 j + 2 tig (+ 1 for odd e)
  const int gid = lane >> 2;
#pragma unroll
  for (int u = 0; u < TPW; ++u) {
    float* base = partial + (static_cast<size_t>(chunk) * TAPS + wg * TPW + u) * Ci * Co;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int co = co0 + wq * 16 + gid;
      const int ci = ci0 + j * 8 + 2 * tig;
      base[static_cast<size_t>(ci) * Co + co] = acc[u][j][0];
      base[static_cast<size_t>(ci + 1) * Co + co] = acc[u][j][1];
      base[static_cast<size_t>(ci) * Co + co + 8] = acc[u][j][2];
      base[static_cast<size_t>(ci + 1) * Co + co + 8] = acc[u][j][3];
    }
  }
}

// Blocks the weight gradient aims for: one 3x3 block (384 threads, ~96
// accumulators a thread) fills an SM, 1x1 blocks fit several.
template <int TAPS>
constexpr int wgrad_target_blocks() {
  return TAPS == 9 ? conv::kSMs : 2 * conv::kSMs;
}

// Row chunks: enough that tiles * chunks covers the target, in whole stages.
template <int TAPS>
inline void wgrad_chunks(int R, int tiles, int* chunks, int* rows_per_chunk) {
  constexpr int RB = wgrad_rows_per_stage<TAPS>();
  const int want = std::max(1, std::min(ceil_div(R, RB), ceil_div(wgrad_target_blocks<TAPS>(), tiles)));
  *rows_per_chunk = ceil_div(ceil_div(R, want), RB) * RB;
  *chunks = ceil_div(R, *rows_per_chunk);
}

// Floats of partials the largest call writes (Ci, Co <= 128): at most
// (target + tiles) tiles of TAPS x CIB x 64.
constexpr long long kWgradFloats = static_cast<long long>(conv::kSMs + 4) * 9 * 64 * kWgCOB;

template <int TAPS, int CIB>
int launch_wgrad_tile(const bf16* x, const bf16* g, float* partial, const int* valid, int R, int S,
                      int Ci, int Co, int M, long long x_ms, long long g_ms, long long partial_ms,
                      int* chunks, cudaStream_t st) {
  int rows_per_chunk;
  wgrad_chunks<TAPS>(R, (Ci / CIB) * (Co / kWgCOB), chunks, &rows_per_chunk);
  if (static_cast<long long>(*chunks) * M > conv::kMaxGridYZ ||
      static_cast<long long>(*chunks) * TAPS * Ci * Co > kWgradFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = kWgStages * wgrad_stage_bytes<TAPS, CIB>(S);
  auto kernel = wgrad_bf16_kernel<TAPS, CIB>;
  static conv::SmemGrant granted;
  const cudaError_t e = conv::grant_smem(kernel, bytes, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Ci / CIB, Co / kWgCOB, *chunks * M);
  kernel<<<grid, TAPS == 9 ? 384 : 128, bytes, st>>>(x, g, partial, valid, R, S, Ci, Co, rows_per_chunk,
                                                      *chunks, x_ms, g_ms, partial_ms);
  return static_cast<int>(cudaGetLastError());
}

// With M members (R a member's rows) each member gets the chunks a member
// alone gets; the grid's z runs over (member, chunk). CIB = 64 input
// channels a block, 32 where Ci is 32.
template <int TAPS>
int launch_wgrad(const bf16* x, const bf16* g, float* partial, const int* valid, int R, int S, int Ci,
                 int Co, int M, long long x_ms, long long g_ms, long long partial_ms, int* chunks,
                 cudaStream_t st) {
  if (Ci % 32 != 0 || Co % kWgCOB != 0 || Ci > 128 || Co > 128 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Ci % 64 == 0)
    return launch_wgrad_tile<TAPS, 64>(x, g, partial, valid, R, S, Ci, Co, M, x_ms, g_ms, partial_ms, chunks, st);
  return launch_wgrad_tile<TAPS, 32>(x, g, partial, valid, R, S, Ci, Co, M, x_ms, g_ms, partial_ms, chunks, st);
}

}  // namespace convbf
