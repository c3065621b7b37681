// K2 and K3: the DeepResNetEmbedding training forward and backward for
// NVIDIA Hopper (sm_90a), on the TF32 tensor cores with f32-grade accuracy.
//
// Replaces moleculardiffusion_mivit_tpu/ops/fused_embedding.py:
//   K2  _core_fwd_impl (body _fwd_kernel / _fwd_stages)
//   K3  _core_bwd      (body _bwd_kernel)
// The forward is: conv3x3 1->32 + BN + ReLU; residual block 32->64 and
// 64->128 (two 3x3 convs with BN, a 1x1 skip conv with BN, ReLU after the
// sum); mean pool over each S x S image; Dense 128->E. BatchNorm uses the
// biased statistics of the whole batch; the 7 (mean, var) pairs are
// returned so the caller applies the running-stat EMA. The backward gives
// every parameter gradient and the input gradient.
//
// What bounds it on this card. The 3x3 convs at 32..128 channels are
// 2.87e5 multiply-adds per activation row forward and twice that backward
// (rows R = batch * frames * S * S; 38,880 at batch 16). The port is held
// to f32 accuracy (gradients to 1e-3 of their maximum against float64), and
// one TF32 product keeps three digits, so every product runs as three TF32
// tensor-core products on operands split into a big and a small part
// (tf32_mma.cuh): the arithmetic bound is 3 * flops / 495 TFLOP/s, 0.135 ms
// forward and 0.270 ms backward at 38,880 rows, where f32 FMAs outside the
// tensor cores would need 0.333 / 0.666 ms. The kernels are bound by what
// surrounds the tensor core, not by it: every product needs its A operand
// read from shared memory, masked and split, and its result added in f32
// beside it; mma.sync (the weight gradients, and the convs at few rows)
// also reads B itself and tops out at ~63% of the data-sheet rate
// (bench/mma_rate.cu), wgmma (the convs at many rows) reads B from shared
// memory on its own and leaves the warps the A side and the adds. The
// 12 saved activations are 4 KB per row (159 MB at 38,880 rows, above the
// 50 MB L2), so the elementwise passes over them are bound by memory and
// take about a fifth of the time. At the batch-1 shape (2,430 rows) neither
// bounds it: the work is ~10 us of arithmetic spread over 22 (forward) and
// 47 (backward) dependent launches, so the time is latency: of each launch
// and of the chain of pipeline stages inside each block.
//
// Design: a short sequence of launches on the caller's stream, holding
// activations in device memory in the channels-last (R, C) row layout.
//  - pack_weights: one launch splits the six GEMM-shaped weights into
//    (big, small) TF32 parts laid out as the tensor core reads them from
//    shared memory, and for the backward also flips the taps and
//    transposes, so the data gradient is the same conv kernel.
//  - conv_rows_tc (conv_rows.cuh): implicit-GEMM 3x3 SAME or 1x1 conv with
//    wgmma m64nNk8 TF32 (128- and 64-row tiles) or mma.sync m16n8k8 TF32
//    (32-row tiles, few rows), three products per f32 product. The input slab
//    of a row tile is loaded once per channel chunk with cp.async and read
//    by all 9 taps at row offsets; the image border is a per-pixel table of
//    validity bits; weight tiles are a ring three stages deep. The tile is
//    chosen from (R, Co) so the grid covers the 132 SMs at 2,430 rows too.
//    `add` and `mask` fuse the residual-gradient sum and the ReLU mask into
//    the epilogue. In the forward the epilogue also writes each tile's
//    per-channel mean and centred sum of squares from the accumulators, so
//    no pass re-reads a conv output for the BatchNorm statistics.
//  - bn_stats_final: merges the tile partials (mean, centred sum of squares)
//    in double about the batch mean, in a fixed order: stable at 155k rows
//    where E[x^2]-E[x]^2 cancels, deterministic.
//  - bn_act: BN apply + optional second BN branch (the skip) + ReLU.
//  - conv0_*: the initial conv (1 input channel) and its gradients are
//    bandwidth work, not GEMMs: plain SIMT kernels with the same validity
//    table.
//  - pool_fc / pool_fc_bwd / fc_wgrad: one block per image; a 16 x 16 tile
//    of fc weights per block.
//  - wgrad_rows_tc (conv_rows.cuh): weight gradients as tensor-core products
//    g^T x slab per row chunk, the 9 taps sharing one slab and one split of
//    g, then a fixed-order sum of the chunks in double: deterministic, no
//    atomics on parameter gradients.
//  - bn_bwd_partial / colsum_final / bn_bwd_apply: BN backward.
// Every reduction over rows beyond one tile (the BN merge, the BN-backward
// sums, the sum of the weight-gradient chunks) accumulates in double: above
// ~10^4 rows the gradients through seven batch-statistics BNs are
// ill-conditioned enough that float sums cost visible accuracy, and these
// reductions move few bytes, so the double rate does not bound them. Each
// merge of per-block partials is spread over C / 16 blocks: a single block
// would pull every partial through one SM.
// The backward reads the forward's saved pre-BN conv outputs, the post-ReLU
// activations and the BN statistics (saved by the caller through
// ctx.save_for_backward) instead of recomputing the forward: device memory
// is not scarce here (~4 KB per row), and recomputation would double the
// conv work of the backward. x-hat is recomputed from the pre-BN value and
// the statistics inside each BN-backward kernel rather than stored.
// Not done here: the 1x1 skip conv shares its input with conv1 but needs
// its own accumulators, which the 128-register budget of two blocks per SM
// has no room for, so it stays a launch of its own, and so do the two data
// gradients that sum into one buffer; the weight gradients stay on mma.sync
// (wgmma takes a TF32 B operand only with its reduction index contiguous,
// and here that index is the row, shifted by an odd offset per tap); BN +
// ReLU are not applied while the next conv loads its slab, because the
// backward needs the post-ReLU activations in memory anyway.
//
// bf16 (K2-bf16 / K3-bf16: deep_resnet_embed_fwd_bf16 / _bwd_bf16). They
// replace the same two TPU kernels in the mode the TPU runs them,
// _core_fwd_impl / _core_bwd at exact=False: _dot / _dot_t with bf16 operands
// and f32 accumulation. The same launch sequence over the operand type T =
// bf16. Inputs, the embedding and every gradient are bf16; the conv outputs,
// BatchNorm and its statistics, the residual gradient sum (BUF_G) and the
// initial conv (one input channel, not a product in JAX either) are f32. Every
// product reads bf16 operands: the post-ReLU activations are saved in bf16 (A,
// Z1, Y1, Z1B, Y2: only products and ReLU masks read them), BN's backward
// writes its output for the products in bf16 (BUF_D1, BUF_D2: the rounding JAX
// makes on the gradient entering a product), the pool and fc products round
// their f32 operands as they read them (the pool is a product with bf16(1 /
// S^2) in JAX), and the weights are packed as bf16: one product per f32
// product, where f32 runs three.
// What bounds them. At 38,880 rows the six convs are 2.2e10 operations forward
// and twice that backward, 0.023 / 0.046 ms at the 989 TFLOP/s bf16 peak
// (data-sheet peaks of the H100 SXM here and below); the function's own bytes
// are far fewer, but the launch sequence moves the f32 conv outputs and the
// saved activations through memory (~5 KB a row with the passes that read them
// back, ~0.06 ms at 3.35 TB/s for K2). At 2,430 rows the products are ~1.4 us
// forward and ~2.8 us backward at the peak, and the time is the latency of the
// 22 and 47 launches and of the pipeline stages inside each.
// What the design does. The convs, their data gradients and the weight
// gradients run on Hopper's wgmma m64nNk16 (conv_rows_bf16.cuh), the
// instruction that reaches the tensor core's full rate (mma.sync tops out at
// ~63 %, bench/mma_rate.cu on an NVIDIA H100 80GB HBM3 at 700 W). At many rows
// a conv tile is 128 rows by all output columns (up to 128), so each weight
// tile read from L2 and each slab fragment serve as many products as the
// registers allow; its A operand is loaded by ldmatrix and zeroed in registers
// where a tap leaves the image, its B read by the tensor core from the packed
// weights, and the epilogue stages the tile in shared memory so the outputs
// leave in 16-byte row stores and the BatchNorm partials come from columns. The
// weight gradient is g^T by the tap-shifted slab: the slab read MN-major
// through the transpose bit, each tap a shift of the descriptor, g^T one
// ldmatrix.trans a step for all taps, three warpgroups for the three rows of
// taps. (The f32 weight gradients cannot do this: wgmma takes a TF32 B only
// K-major.) At few rows the tile shrinks to 64 rows by 32 columns, so 2,430
// rows still give 38-152 blocks, and a stage takes 64 input channels, which
// halves the stages a block waits through. The elementwise passes and the
// launch chain are the f32 kernels', instantiated over T.
//
// Members. Both entries take M independent members at once (a grid of
// models: each member its own input rows, weights, BN statistics and
// gradients). Every launch above carries the member index in its grid
// (blockIdx.y or .z; the weight gradient folds it into z with the row
// chunk), and every array is offset by m times its member stride, which the
// caller passes beside each pointer (64-bit: 30 members at batch 16 hold
// 1.2 M rows, 4.8 GB of saved activations). Tiles, row chunks and the
// fixed-order sums are chosen from a member's rows, so member m's result is
// bitwise the result of a call for m alone, and BN statistics never mix
// members. With M = 1 every launch is the one-member launch.

#include <cuda_runtime.h>

#include <algorithm>

#include "conv_rows.cuh"
#include "conv_rows_bf16.cuh"
#include "operand_types.cuh"

namespace {

using conv::ceil_div;
using conv::member_ptr;
using tc::bf16;
using tc::from_f32;
using tc::operand;
using tc::to_f32;

constexpr int C0 = 32, C1 = 64, C2 = 128, CMAX = 128;
constexpr float kEps = 1e-5f;
constexpr int NT = 256;
constexpr int kStatRows = 64;   // rows per block of the SIMT reductions over rows
constexpr int kFinalThreads = 1024;  // one block merges the per-block partials
constexpr int kMinTileRows = 32;  // smallest conv tile: most BN partials per row

// The six GEMM-shaped conv weights, in the order of `enum Ptr`.
struct WeightShape {
  int taps, ci, co;
};
constexpr int kNumPacked = 6;
constexpr WeightShape kPackedShapes[kNumPacked] = {
    {9, C0, C1}, {1, C0, C1}, {9, C1, C1}, {9, C1, C2}, {1, C1, C2}, {9, C2, C2}};
constexpr int packed_floats_before(int n) {
  int total = 0;
  for (int i = 0; i < n; ++i)
    total += 2 * kPackedShapes[i].taps * kPackedShapes[i].ci * kPackedShapes[i].co;
  return total;
}
constexpr int kPackedFloats = packed_floats_before(kNumPacked);
// Largest set of weight-gradient partials: (target blocks + tiles) * tile,
// of the f32 kernel and of the bf16 one.
constexpr long long kWgradFloats =
    std::max(static_cast<long long>(conv::kWgTargetBlocks + 8) * 9 * conv::CIB * conv::COB,
             convbf::kWgradFloats);
// f32 copies of the BN scale and bias gradients (7 x CMAX each), which BN's
// backward reads whatever the type of the gradients it returns.
constexpr long long kBnGradFloats = 2 * 7 * CMAX;

// Kernel launches of the last entry call, by kind (deep_resnet_last_launches).
enum Kind {
  K_PACK, K_CONV_TC, K_CONV0, K_BN_STATS, K_BN_ACT, K_POOL_FC, K_WGRAD_TC, K_WGRAD_SIMT,
  K_SUM_CHUNKS, K_BN_BWD, NKIND
};
int g_launches[NKIND];

inline int launched(Kind k) {
  ++g_launches[k];
  return static_cast<int>(cudaGetLastError());
}

struct PackItem {
  const float* src;
  float* dst;
  int taps, K, N;
  long long src_ms, dst_ms;  // member strides
};
struct PackList {
  PackItem item[kNumPacked];
};

// dst = the GEMM operand B[tap][k][n] of a conv weight stored (taps, ci, co),
// split as big = tf32(w), small = tf32(w - big) (big + small = w to 2^-21,
// relative) and laid out as conv_rows_tc_kernel reads it:
// [tap][K / 8][big, small][N / 8][2][8][4], each [8][4] a core matrix of
// column n0 + r at rows k0 + 2 q + h (h the half, r the column, q the float).
// Forward: K = ci, N = co, B = w. With flip (the data gradient): K = co,
// N = ci, B[tap][k][n] = w[taps - 1 - tap][n][k].
__global__ void pack_weights_kernel(PackList list, int flip) {
  PackItem it = list.item[blockIdx.y];
  it.src = member_ptr(it.src, it.src_ms, blockIdx.z);
  it.dst = member_ptr(it.dst, it.dst_ms, blockIdx.z);
  const int nb = it.N / 8, kb = it.K / 8;
  const int n = it.taps * kb * nb * 16;  // one thread per core-matrix row: (tap, kb, nb, h, r)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int r = i % 8, h = (i / 8) % 2, blk = i / 16;
    const int col = (blk % nb) * 8 + r;
    const int k0 = ((blk / nb) % kb) * 8 + h;
    const int tap = blk / (nb * kb);
    float big[4], small[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 2 * q;
      const float v = flip ? it.src[((it.taps - 1 - tap) * it.N + col) * it.K + k]
                           : it.src[(tap * it.K + k) * it.N + col];
      uint32_t b, s;
      tc::split_tf32(v, b, s);
      big[q] = __uint_as_float(b);
      small[q] = __uint_as_float(tc::to_tf32(__uint_as_float(s)));
    }
    // float4 index of (tap, kb, part, nb, h, r)
    const int o = ((blk / nb) * 2 * nb + blk % nb) * 16 + h * 8 + r;
    reinterpret_cast<float4*>(it.dst)[o] = make_float4(big[0], big[1], big[2], big[3]);
    reinterpret_cast<float4*>(it.dst)[o + nb * 16] =
        make_float4(small[0], small[1], small[2], small[3]);
  }
}

// bf16: dst = B[tap][k][n] (as above) laid out as conv_bf16_kernel reads it
// (conv_rows_bf16.cuh): [tap][K / 16][N / 8][2][8][8], per block of 16 k and
// 8 n two core matrices (k 0-7, k 8-15) of 8 rows n, each row the 8 k of
// that n in 16 bytes.
struct PackItemBf16 {
  const bf16* src;
  float* dst;  // member stride in floats, as the f32 packing's
  int taps, K, N;
  long long src_ms, dst_ms;
};
struct PackListBf16 {
  PackItemBf16 item[kNumPacked];
};

__global__ void pack_weights_bf16_kernel(PackListBf16 list, int flip) {
  PackItemBf16 it = list.item[blockIdx.y];
  it.src = member_ptr(it.src, it.src_ms, blockIdx.z);
  it.dst = member_ptr(it.dst, it.dst_ms, blockIdx.z);
  const int nb = it.N / 8, kb = it.K / 16;
  const int n = it.taps * kb * nb * 16;  // one thread per core-matrix row: (tap, kb, nb, half, r)
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int r = i % 8, half = (i / 8) % 2, blk = i / 16;
    const int col = (blk % nb) * 8 + r;
    const int k0 = ((blk / nb) % kb) * 16 + half * 8;
    const int tap = blk / (nb * kb);
    auto bits = [&](int k) {
      const bf16 v = flip ? it.src[((it.taps - 1 - tap) * it.N + col) * it.K + k] : it.src[(tap * it.K + k) * it.N + col];
      return static_cast<uint32_t>(__bfloat16_as_ushort(v));
    };
    uint32_t word[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) word[q] = bits(k0 + 2 * q) | (bits(k0 + 2 * q + 1) << 16);
    reinterpret_cast<uint4*>(it.dst)[i] = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

__device__ __forceinline__ int tap_offset(int t, int S) { return (t / 3 - 1) * S + (t % 3 - 1); }

// Initial conv, 1 -> 32 channels: z[r, c] = sum_t x[r + off(t)] * w[t, c],
// in f32 for either T.
template <typename T>
__global__ void __launch_bounds__(NT) conv0_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ z,
    const int* __restrict__ valid, int R, int S, long long x_ms, long long w_ms, long long z_ms) {
  x = member_ptr(x, x_ms, blockIdx.y);
  w = member_ptr(w, w_ms, blockIdx.y);
  z = member_ptr(z, z_ms, blockIdx.y);
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= R * C0) return;
  const int r = i / C0, c = i % C0;
  const int vm = valid[r % (S * S)];
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t)
    if ((vm >> t) & 1) acc = fmaf(to_f32(x[r + tap_offset(t, S)]), to_f32(w[t * C0 + c]), acc);
  z[i] = acc;
}

// Its data gradient, one warp per pixel:
// gx[r] = sum_{t, c} d[r + off(t), c] * w[8 - t, c].
template <typename T>
__global__ void __launch_bounds__(NT) conv0_dgrad_kernel(
    const float* __restrict__ d, const T* __restrict__ w, T* __restrict__ gx,
    const int* __restrict__ valid, int R, int S, long long d_ms, long long w_ms, long long gx_ms) {
  d = member_ptr(d, d_ms, blockIdx.y);
  w = member_ptr(w, w_ms, blockIdx.y);
  gx = member_ptr(gx, gx_ms, blockIdx.y);
  const int r = (blockIdx.x * NT + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (r >= R) return;
  const int vm = valid[r % (S * S)];
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t)
    if ((vm >> t) & 1)
      s = fmaf(d[static_cast<size_t>(r + tap_offset(t, S)) * C0 + lane], to_f32(w[(8 - t) * C0 + lane]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) gx[r] = from_f32<T>(s);
}

// Its weight gradient: partial[chunk, t, c] = sum over the chunk's rows of
// x[r + off(t)] * d[r, c].
template <typename T>
__global__ void __launch_bounds__(NT) conv0_wgrad_kernel(
    const T* __restrict__ x, const float* __restrict__ d, float* __restrict__ partial,
    const int* __restrict__ valid, int R, int S, int rows_per_chunk, long long x_ms, long long d_ms,
    long long partial_ms) {
  __shared__ float red[NT / C0][9][C0];
  x = member_ptr(x, x_ms, blockIdx.y);
  d = member_ptr(d, d_ms, blockIdx.y);
  partial = member_ptr(partial, partial_ms, blockIdx.y);
  const int c = threadIdx.x % C0, lane = threadIdx.x / C0;
  const int r_begin = blockIdx.x * rows_per_chunk, r_end = min(R, r_begin + rows_per_chunk);
  const int SS = S * S;
  float acc[9] = {};
  for (int r = r_begin + lane; r < r_end; r += NT / C0) {
    const float g = d[static_cast<size_t>(r) * C0 + c];
    const int vm = valid[r % SS];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if ((vm >> t) & 1) acc[t] = fmaf(to_f32(x[r + tap_offset(t, S)]), g, acc[t]);
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) red[lane][t][c] = acc[t];
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * C0; i += NT) {
    float s = 0.f;
    for (int l = 0; l < NT / C0; ++l) s += red[l][i / C0][i % C0];
    partial[static_cast<size_t>(blockIdx.x) * 9 * C0 + i] = s;
  }
}

// out[c, e] = sum_n pooled[n, c] * g[n, e]: a 16 x 16 tile of fc weights per
// block, the images brought through shared memory 32 at a time; f32 within
// a batch of 32, double across batches. (bf16: pooled read as a product's
// operand, bf16.)
template <typename T>
__global__ void __launch_bounds__(NT) fc_wgrad_kernel(
    const float* __restrict__ pooled, const T* __restrict__ g, T* __restrict__ out,
    int N, int E, long long pooled_ms, long long g_ms, long long out_ms) {
  __shared__ float p_s[32][16 + 1];
  pooled = member_ptr(pooled, pooled_ms, blockIdx.z);
  g = member_ptr(g, g_ms, blockIdx.z);
  out = member_ptr(out, out_ms, blockIdx.z);
  __shared__ float g_s[32][16 + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * 16, e0 = blockIdx.y * 16;
  double total = 0.0;
  for (int n0 = 0; n0 < N; n0 += 32) {
    for (int i = threadIdx.x; i < 32 * 16; i += NT) {
      const int r = i / 16, col = i % 16, n = n0 + r;
      p_s[r][col] = n < N ? operand<T>(pooled[static_cast<size_t>(n) * C2 + c0 + col]) : 0.f;
      g_s[r][col] = n < N && e0 + col < E ? to_f32(g[static_cast<size_t>(n) * E + e0 + col]) : 0.f;
    }
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) s = fmaf(p_s[r][ty], g_s[r][tx], s);
    total += s;
    __syncthreads();
  }
  if (e0 + tx < E) out[static_cast<size_t>(c0 + ty) * E + e0 + tx] = from_f32<T>(static_cast<float>(total));
}

template <typename T>
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int n, int chunks,
                                  long long partial_ms, long long out_ms) {
  partial = member_ptr(partial, partial_ms, blockIdx.y);
  out = member_ptr(out, out_ms, blockIdx.y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int ch = 0; ch < chunks; ++ch) s += partial[static_cast<size_t>(ch) * n + i];
  out[i] = from_f32<T>(static_cast<float>(s));
}

// Per block of kStatRows rows: partial[blk, 0, c] = mean, [blk, 1, c] =
// centred sum of squares, accumulated in double. Needs C <= NT. Used for the
// initial conv's output; the tensor-core convs write the same partials per
// tile from their epilogue.
__global__ void __launch_bounds__(NT) bn_stats_partial_kernel(
    const float* __restrict__ z, double* __restrict__ partial, int R, int C, long long z_ms,
    long long partial_ms) {
  __shared__ double red[NT];
  __shared__ double mean_s[NT];
  z = member_ptr(z, z_ms, blockIdx.y);
  partial = member_ptr(partial, partial_ms, blockIdx.y);
  const int c = threadIdx.x % C, lane = threadIdx.x / C, lanes = NT / C;
  const bool on = lane < lanes;
  const int r0 = blockIdx.x * kStatRows, r1 = min(R, r0 + kStatRows);
  double s = 0.0;
  if (on)
    for (int r = r0 + lane; r < r1; r += lanes) s += z[static_cast<size_t>(r) * C + c];
  red[threadIdx.x] = s;
  __syncthreads();
  if (lane == 0) {
    double t = 0.0;
    for (int l = 0; l < lanes; ++l) t += red[l * C + c];
    mean_s[c] = t / (r1 - r0);
  }
  __syncthreads();
  const double m = mean_s[c];
  s = 0.0;
  if (on)
    for (int r = r0 + lane; r < r1; r += lanes) {
      const double d = z[static_cast<size_t>(r) * C + c] - m;
      s = fma(d, d, s);
    }
  red[threadIdx.x] = s;
  __syncthreads();
  if (lane == 0) {
    double t = 0.0;
    for (int l = 0; l < lanes; ++l) t += red[l * C + c];
    partial[(static_cast<size_t>(blockIdx.x) * 2) * C + c] = m;
    partial[(static_cast<size_t>(blockIdx.x) * 2 + 1) * C + c] = t;
  }
}

// The kernels that merge per-block partials give kFinalCols columns to a
// block and split the blocks to merge among kFinalThreads / kFinalCols lanes:
// one block alone would pull every partial through a single SM.
constexpr int kFinalCols = 16, kFinalLanes = kFinalThreads / kFinalCols;

// Sum over the lanes' values for the thread's column, in two levels of 8 in
// lane order (fixed, so the result does not depend on timing). All threads
// of the block call it.
__device__ __forceinline__ double sum_over_lanes(double v, double* buf) {
  static_assert(kFinalLanes == 64, "two levels of 8");
  const int col = threadIdx.x % kFinalCols, lane = threadIdx.x / kFinalCols;
  __syncthreads();  // buf may still be read from a previous call
  buf[threadIdx.x] = v;
  __syncthreads();
  double t = 0.0;
  if (lane < 8)
    for (int l = 0; l < 8; ++l) t += buf[(lane * 8 + l) * kFinalCols + col];
  __syncthreads();
  if (lane < 8) buf[threadIdx.x] = t;
  __syncthreads();
  t = 0.0;
  for (int l = 0; l < 8; ++l) t += buf[l * kFinalCols + col];
  return t;
}

// Merge of the partials (mean_b, centred sum of squares m2_b) of `nblk`
// blocks of `block_rows` rows (the last one shorter) into the batch
// statistics: mean = sum n_b mean_b / R, then
// var = sum (m2_b + n_b (mean_b - mean)^2) / R, the pairwise-update formula
// written about the final mean: no E[x^2] - E[x]^2 cancellation, stable at
// 155k rows. In double: each lane sums a contiguous run of blocks in order,
// then the lanes are summed in order. Grid C / kFinalCols.
// st[0:C] = mean, st[CMAX:CMAX+C] = biased var, st[2*CMAX:2*CMAX+C] = rstd
__global__ void __launch_bounds__(kFinalThreads) bn_stats_final_kernel(
    const double* __restrict__ partial, float* __restrict__ st, int nblk, int block_rows, int R,
    int C, long long partial_ms, long long st_ms) {
  __shared__ double buf[kFinalThreads];
  partial = member_ptr(partial, partial_ms, blockIdx.y);
  st = member_ptr(st, st_ms, blockIdx.y);
  const int c = blockIdx.x * kFinalCols + threadIdx.x % kFinalCols;
  const int lane = threadIdx.x / kFinalCols;
  const int per = (nblk + kFinalLanes - 1) / kFinalLanes;
  const int b0 = min(nblk, lane * per), b1 = min(nblk, b0 + per);
  double s = 0.0;
#pragma unroll 4
  for (int b = b0; b < b1; ++b)
    s = fma(static_cast<double>(min(block_rows, R - b * block_rows)),
            partial[(static_cast<size_t>(b) * 2) * C + c], s);
  const double mean = sum_over_lanes(s, buf) / R;
  s = 0.0;
#pragma unroll 4
  for (int b = b0; b < b1; ++b) {
    const double d = partial[(static_cast<size_t>(b) * 2) * C + c] - mean;
    s += fma(static_cast<double>(min(block_rows, R - b * block_rows)), d * d,
             partial[(static_cast<size_t>(b) * 2 + 1) * C + c]);
  }
  const double m2 = sum_over_lanes(s, buf);
  if (lane != 0) return;
  const float var = static_cast<float>(m2 / R);
  st[c] = static_cast<float>(mean);
  st[CMAX + c] = var;
  st[2 * CMAX + c] = rsqrtf(var + kEps);
}

// Member strides of bn_act's arrays: z (za, zb), statistics, scales and
// biases, output.
struct ActStrides {
  long long za, zb, st, bn, out;
};

template <typename T>
__global__ void bn_act_kernel(const float* __restrict__ za, const float* __restrict__ sta,
                              const T* __restrict__ sca, const T* __restrict__ bia,
                              const float* __restrict__ zb, const float* __restrict__ stb,
                              const T* __restrict__ scb, const T* __restrict__ bib,
                              T* __restrict__ out, int R, int C, ActStrides ms) {
  const int m = blockIdx.y;
  za = member_ptr(za, ms.za, m);
  zb = member_ptr(zb, ms.zb, m);
  sta = member_ptr(sta, ms.st, m);
  stb = member_ptr(stb, ms.st, m);
  sca = member_ptr(sca, ms.bn, m);
  scb = member_ptr(scb, ms.bn, m);
  bia = member_ptr(bia, ms.bn, m);
  bib = member_ptr(bib, ms.bn, m);
  out = member_ptr(out, ms.out, m);
  const size_t n = static_cast<size_t>(R) * C;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    float v = (za[i] - sta[c]) * sta[2 * CMAX + c] * to_f32(sca[c]) + to_f32(bia[c]);
    if (zb) v += (zb[i] - stb[c]) * stb[2 * CMAX + c] * to_f32(scb[c]) + to_f32(bib[c]);
    out[i] = from_f32<T>(fmaxf(v, 0.f));
  }
}

// partial[blk, 0, c] = sum g, [blk, 1, c] = sum g * xhat (xhat from z, st;
// skipped when z is null) over the block's kStatRows rows. Each thread sums
// its rows in four independent f32 chains (at most kStatRows / 4 terms each);
// everything beyond that accumulates in double. Needs C <= NT.
template <typename TG>
__global__ void __launch_bounds__(NT) bn_bwd_partial_kernel(
    const TG* __restrict__ g, const float* __restrict__ z,
    const float* __restrict__ st, double* __restrict__ partial, int R, int C, long long g_ms,
    long long z_ms, long long st_ms, long long partial_ms) {
  __shared__ double red0[NT];
  __shared__ double red1[NT];
  g = member_ptr(g, g_ms, blockIdx.y);
  z = member_ptr(z, z_ms, blockIdx.y);
  st = member_ptr(st, st_ms, blockIdx.y);
  partial = member_ptr(partial, partial_ms, blockIdx.y);
  const int c = threadIdx.x % C, lane = threadIdx.x / C, lanes = NT / C;
  const int r0 = blockIdx.x * kStatRows, r1 = min(R, r0 + kStatRows);
  float a0[4] = {}, a1[4] = {};
  if (lane < lanes) {
    const float mean = z ? st[c] : 0.f, rstd = z ? st[2 * CMAX + c] : 0.f;
    for (int r = r0 + lane; r < r1; r += 4 * lanes) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = r + u * lanes;
        if (rr >= r1) continue;
        const size_t o = static_cast<size_t>(rr) * C + c;
        const float gv = to_f32(g[o]);
        a0[u] += gv;
        if (z) a1[u] = fmaf(gv, (z[o] - mean) * rstd, a1[u]);
      }
    }
  }
  red0[threadIdx.x] = (static_cast<double>(a0[0]) + a0[1]) + (static_cast<double>(a0[2]) + a0[3]);
  red1[threadIdx.x] = (static_cast<double>(a1[0]) + a1[1]) + (static_cast<double>(a1[2]) + a1[3]);
  __syncthreads();
  if (lane == 0) {
    double t0 = 0.0, t1 = 0.0;
    for (int l = 0; l < lanes; ++l) {
      t0 += red0[l * C + c];
      t1 += red1[l * C + c];
    }
    partial[(static_cast<size_t>(blockIdx.x) * 2) * C + c] = t0;
    partial[(static_cast<size_t>(blockIdx.x) * 2 + 1) * C + c] = t1;
  }
}

// Sums of the per-block partials, in double: each lane sums a contiguous
// run of blocks in order, then the lanes are summed in order. Grid
// ceil(C / kFinalCols). `f0`/`f1` (optional) receive the sums in f32 too.
template <typename T>
__global__ void __launch_bounds__(kFinalThreads) colsum_final_kernel(
    const double* __restrict__ partial, T* __restrict__ out0, T* __restrict__ out1,
    float* __restrict__ f0, float* __restrict__ f1, int nblk, int C, long long partial_ms,
    long long out_ms, long long f_ms) {
  __shared__ double buf[kFinalThreads];
  partial = member_ptr(partial, partial_ms, blockIdx.y);
  out0 = member_ptr(out0, out_ms, blockIdx.y);
  out1 = member_ptr(out1, out_ms, blockIdx.y);
  f0 = member_ptr(f0, f_ms, blockIdx.y);
  f1 = member_ptr(f1, f_ms, blockIdx.y);
  const int c = blockIdx.x * kFinalCols + threadIdx.x % kFinalCols;
  const int lane = threadIdx.x / kFinalCols;
  const int per = (nblk + kFinalLanes - 1) / kFinalLanes;
  const int b0 = c < C ? min(nblk, lane * per) : nblk, b1 = min(nblk, b0 + per);
  double t0 = 0.0, t1 = 0.0;
#pragma unroll 4
  for (int b = b0; b < b1; ++b) {
    t0 += partial[(static_cast<size_t>(b) * 2) * C + c];
    t1 += partial[(static_cast<size_t>(b) * 2 + 1) * C + c];
  }
  t0 = sum_over_lanes(t0, buf);
  t1 = sum_over_lanes(t1, buf);
  if (lane != 0 || c >= C) return;
  out0[c] = from_f32<T>(static_cast<float>(t0));
  if (out1) out1[c] = from_f32<T>(static_cast<float>(t1));
  if (f0) f0[c] = static_cast<float>(t0);
  if (f1) f1[c] = static_cast<float>(t1);
}

// dz = (g - dbias/R - xhat*dscale/R) * scale * rstd, written as TO (BN 0's
// in place of g: the initial conv reads it in f32).
template <typename T, typename TO>
__global__ void bn_bwd_apply_kernel(const float* g, const float* __restrict__ z,
                                    const float* __restrict__ st, const T* __restrict__ sc,
                                    const float* __restrict__ dbias,
                                    const float* __restrict__ dscale,
                                    TO* out, int R, int C, long long g_ms,
                                    long long z_ms, long long st_ms, long long bn_ms,
                                    long long d_ms, long long out_ms) {
  const int m = blockIdx.y;
  g = member_ptr(g, g_ms, m);
  z = member_ptr(z, z_ms, m);
  st = member_ptr(st, st_ms, m);
  sc = member_ptr(sc, bn_ms, m);
  dbias = member_ptr(dbias, d_ms, m);
  dscale = member_ptr(dscale, d_ms, m);
  out = member_ptr(out, out_ms, m);
  const size_t n = static_cast<size_t>(R) * C;
  const float inv_r = 1.f / static_cast<float>(R);
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    const float rstd = st[2 * CMAX + c];
    const float xh = (z[i] - st[c]) * rstd;
    out[i] = from_f32<TO>((g[i] - dbias[c] * inv_r - xh * (dscale[c] * inv_r)) * (to_f32(sc[c]) * rstd));
  }
}

// The mean pool's factor on an image's sum: f32 divides by S^2; bf16 is the
// JAX kernel's product with bf16(1 / S^2).
template <typename T>
__device__ __forceinline__ float pool_scale(float sum, int SS) {
  if constexpr (tc::kIsBf16<T>) return sum * operand<T>(1.f / static_cast<float>(SS));
  return sum / static_cast<float>(SS);
}

// One block per image: pooled[n] = mean over the image's rows of y2;
// emb[n] = pooled[n] @ wfc + bfc.
template <typename T>
__global__ void pool_fc_kernel(const T* __restrict__ y2, const T* __restrict__ wfc,
                               const T* __restrict__ bfc, float* __restrict__ pooled,
                               T* __restrict__ emb, int SS, int E, long long y2_ms,
                               long long wfc_ms, long long bfc_ms, long long pooled_ms,
                               long long emb_ms) {
  __shared__ float p_s[C2];
  y2 = member_ptr(y2, y2_ms, blockIdx.y);
  wfc = member_ptr(wfc, wfc_ms, blockIdx.y);
  bfc = member_ptr(bfc, bfc_ms, blockIdx.y);
  pooled = member_ptr(pooled, pooled_ms, blockIdx.y);
  emb = member_ptr(emb, emb_ms, blockIdx.y);
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    float s = 0.f;
    for (int pix = 0; pix < SS; ++pix) s += to_f32(y2[(static_cast<size_t>(n) * SS + pix) * C2 + c]);
    p_s[c] = pool_scale<T>(s, SS);
    pooled[static_cast<size_t>(n) * C2 + c] = p_s[c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < C2; ++c) acc = fmaf(operand<T>(p_s[c]), to_f32(wfc[c * E + e]), acc);
    emb[static_cast<size_t>(n) * E + e] = from_f32<T>(acc + to_f32(bfc[e]));
  }
}

// One block per image: gpre[r, c] = (y2[r, c] > 0) * (g[n] @ wfc^T)[c] / SS
// (bf16: the pool's product with its operands rounded).
template <typename T>
__global__ void pool_fc_bwd_kernel(const T* __restrict__ g, const T* __restrict__ wfc,
                                   const T* __restrict__ y2, float* __restrict__ gpre,
                                   int SS, int E, long long g_ms, long long wfc_ms,
                                   long long y2_ms, long long gpre_ms) {
  __shared__ float gp[C2];
  g = member_ptr(g, g_ms, blockIdx.y);
  wfc = member_ptr(wfc, wfc_ms, blockIdx.y);
  y2 = member_ptr(y2, y2_ms, blockIdx.y);
  gpre = member_ptr(gpre, gpre_ms, blockIdx.y);
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    float s = 0.f;
    for (int e = 0; e < E; ++e) s = fmaf(to_f32(g[static_cast<size_t>(n) * E + e]), to_f32(wfc[c * E + e]), s);
    gp[c] = pool_scale<T>(operand<T>(s), SS);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SS * C2; i += blockDim.x) {
    const size_t o = static_cast<size_t>(n) * SS * C2 + i;
    gpre[o] = to_f32(y2[o]) > 0.f ? gp[i % C2] : 0.f;
  }
}

// ---------------------------------------------------------------- launches

// Order of the pointer array both entries take (ops/fused_embedding.py
// builds it from the same list). Weights keep the JAX layout: 3x3 kernels
// tap-major (9 * cin, cout), 1x1 kernels (cin, cout), fc (128, E); BN scales
// and biases packed (7, 128) in BN_LAYOUT order; stats (7, 3, 128) =
// mean, biased var, rstd per BN; VALID the S*S tap-validity words (bit t set
// where tap t of that pixel reads inside the image). Each array is a stack
// of M members; the second array holds each pointer's member stride in
// elements (any value for VALID, which all members share). In the T = bf16
// entries the inputs, EMB, the gradients, the saved post-ReLU activations
// (A, Z1, Y1, Z1B, Y2) and BUF_D1/BUF_D2 are bf16; everything else is f32.
enum Ptr {
  X, WI, W1C1, W1SK, W1C2, W2C1, W2SK, W2C2, SC, BI, WFC, BFC,
  Z0, A, Z1P, Z1, Z2P, IP1, Y1, Z1BP, Z1B, Z2BP, IP2, Y2, POOLED, STATS,
  EMB, SCRATCH, VALID,
  GEMB, GX, GWI, GW1C1, GW1SK, GW1C2, GW2C1, GW2SK, GW2C2, GSC, GBI, GWFC, GBFC,
  BUF_G, BUF_D1, BUF_D2,
  NPTR
};

#define CHECK(call)                  \
  do {                               \
    int e_ = (call);                 \
    if (e_ != 0) return e_;          \
  } while (0)

inline int elementwise_blocks(int R, int C) {
  return std::min(ceil_div(static_cast<long long>(R) * C, NT), conv::kSMs * 16);
}

// Floats of the BN-partial region of the scratch: doubles for the smallest
// conv tile and for the kStatRows-row SIMT reductions.
inline long long stat_floats(int R) {
  const long long tiles = 2LL * ceil_div(R, kMinTileRows) * CMAX;
  const long long blocks = 2LL * ceil_div(R, kStatRows) * NT;
  return 2 * std::max(tiles, blocks);
}

// A stacked array: its base and its member stride in elements.
template <typename T>
struct Arr {
  T* p;
  long long s;
  Arr at(long long off) const { return {p ? p + off : p, s}; }
};
using FArr = Arr<float>;
const FArr kNone{nullptr, 0};

// What every launcher needs of one entry call. The scratch holds, per
// member (at m times `scratch_ms`), the BN partials (doubles), the packed
// weights, the weight-gradient partials and f32 copies of the BN parameter
// gradients.
struct Call {
  int M, R, S;
  cudaStream_t st;
  const int* valid;
  long long scratch_ms;
  Arr<double> stat;
  FArr packed;
  FArr wg;
  FArr bn_grads;       // [scale, bias][7][CMAX]
  FArr w[kNumPacked];  // packed GEMM operands, in kPackedShapes order

  Call(void* const* p, int m, int n, int s, void* stream)
      : M(m), R(n * s * s), S(s), st(static_cast<cudaStream_t>(stream)),
        valid(static_cast<const int*>(p[VALID])) {
    float* scratch = static_cast<float*>(p[SCRATCH]);
    scratch_ms = stat_floats(R) + kPackedFloats + kWgradFloats + kBnGradFloats;
    stat = {reinterpret_cast<double*>(scratch), scratch_ms / 2};
    packed = {scratch + stat_floats(R), scratch_ms};
    wg = packed.at(kPackedFloats);
    bn_grads = wg.at(kWgradFloats);
    for (int i = 0; i < kNumPacked; ++i) w[i] = packed.at(packed_floats_before(i));
  }
};

// The six GEMM-shaped weights packed for the products of T (flipped and
// transposed for the data gradients).
template <typename T>
int pack_weights(const Call& c, void* const* p, const long long* ms, int first_weight, int flip) {
  int largest = 0;
  for (int i = 0; i < kNumPacked; ++i)
    largest = std::max(largest, kPackedShapes[i].taps * kPackedShapes[i].ci * kPackedShapes[i].co);
  const dim3 grid(ceil_div(largest, 4 * NT), kNumPacked, c.M);
  if constexpr (tc::kIsBf16<T>) {
    PackListBf16 list;
    for (int i = 0; i < kNumPacked; ++i) {
      const WeightShape s = kPackedShapes[i];
      list.item[i] = {static_cast<const bf16*>(p[first_weight + i]),
                      c.packed.p + packed_floats_before(i), s.taps,
                      flip ? s.co : s.ci, flip ? s.ci : s.co, ms[first_weight + i], c.packed.s};
    }
    pack_weights_bf16_kernel<<<grid, NT, 0, c.st>>>(list, flip);
  } else {
    PackList list;
    for (int i = 0; i < kNumPacked; ++i) {
      const WeightShape s = kPackedShapes[i];
      list.item[i] = {static_cast<const float*>(p[first_weight + i]),
                      c.packed.p + packed_floats_before(i), s.taps, flip ? s.co : s.ci,
                      flip ? s.ci : s.co, ms[first_weight + i], c.packed.s};
    }
    pack_weights_kernel<<<grid, NT, 0, c.st>>>(list, flip);
  }
  return launched(K_PACK);
}

// Tensor-core conv (f32: conv_rows.cuh, bf16: conv_rows_bf16.cuh); with
// `stats` also the BN statistics of its output.
template <typename T>
int conv_tc(const Call& c, Arr<T> x, FArr wp, FArr add, Arr<T> mask, FArr y, FArr stats, int Ci,
            int Co, int taps) {
  int bm = 0;
  // the packed weights' member stride counts floats; bf16 reads them as bf16
  const long long wp_s = wp.s * static_cast<long long>(sizeof(float) / sizeof(T));
  const conv::ConvStrides ms{x.s, wp_s, add.s, mask.s, y.s, c.stat.s};
  double* partial = stats.p ? c.stat.p : nullptr;
  if constexpr (tc::kIsBf16<T>) {
    CHECK(convbf::launch_conv(x.p, reinterpret_cast<const bf16*>(wp.p), add.p, mask.p, y.p, partial,
                              c.valid, c.R, c.S, Ci, Co, taps, c.M, ms, &bm, c.st));
  } else {
    CHECK(conv::launch_conv(x.p, wp.p, add.p, mask.p, y.p, partial, c.valid, c.R, c.S, Ci, Co, taps,
                            c.M, ms, &bm, c.st));
  }
  ++g_launches[K_CONV_TC];
  if (!stats.p) return 0;
  bn_stats_final_kernel<<<dim3(Co / kFinalCols, c.M), kFinalThreads, 0, c.st>>>(
      c.stat.p, stats.p, ceil_div(c.R, bm), bm, c.R, Co, c.stat.s, stats.s);
  return launched(K_BN_STATS);
}

template <typename T>
int sum_chunks(const Call& c, Arr<T> out, int n, int chunks) {
  sum_chunks_kernel<T><<<dim3(ceil_div(n, NT), c.M), NT, 0, c.st>>>(c.wg.p, out.p, n, chunks, c.wg.s,
                                                                    out.s);
  return launched(K_SUM_CHUNKS);
}

template <int TAPS>
int launch_wgrad(const Call& c, Arr<float> x, Arr<float> g, int Ci, int Co, int* chunks) {
  return conv::launch_wgrad<TAPS>(x.p, g.p, c.wg.p, c.valid, c.R, c.S, Ci, Co, c.M, x.s, g.s, c.wg.s,
                                  chunks, c.st);
}

template <int TAPS>
int launch_wgrad(const Call& c, Arr<bf16> x, Arr<bf16> g, int Ci, int Co, int* chunks) {
  return convbf::launch_wgrad<TAPS>(x.p, g.p, c.wg.p, c.valid, c.R, c.S, Ci, Co, c.M, x.s, g.s, c.wg.s,
                                    chunks, c.st);
}

template <typename T>
int wgrad_tc(const Call& c, Arr<T> x, Arr<T> g, Arr<T> out, int Ci, int Co, int taps) {
  int chunks = 0;
  CHECK(taps == 9 ? launch_wgrad<9>(c, x, g, Ci, Co, &chunks) : launch_wgrad<1>(c, x, g, Ci, Co, &chunks));
  ++g_launches[K_WGRAD_TC];
  return sum_chunks(c, out, taps * Ci * Co, chunks);
}

// BN apply (+ a second BN branch) + ReLU. `st` is the stats array, `bn` the
// packed BN scales (biases share its stride).
template <typename T>
int bn_act(const Call& c, FArr za, FArr sta, Arr<T> sca, Arr<T> bia, FArr zb, FArr stb, Arr<T> scb,
           Arr<T> bib, Arr<T> out, int C) {
  const ActStrides ms{za.s, zb.s, sta.s, sca.s, out.s};
  bn_act_kernel<T><<<dim3(elementwise_blocks(c.R, C), c.M), NT, 0, c.st>>>(
      za.p, sta.p, sca.p, bia.p, zb.p, stb.p, scb.p, bib.p, out.p, c.R, C, ms);
  return launched(K_BN_ACT);
}

// Column sums of g and of g * xhat into out0 (d bias) and out1 (d scale),
// and in f32 into f0 and f1 where given.
template <typename TG, typename T>
int colsum(const Call& c, Arr<TG> g, FArr z, FArr stats, Arr<T> out0, Arr<T> out1, FArr f0, FArr f1,
           int rows, int C) {
  const int nblk = ceil_div(rows, kStatRows);
  bn_bwd_partial_kernel<TG><<<dim3(nblk, c.M), NT, 0, c.st>>>(g.p, z.p, stats.p, c.stat.p, rows, C,
                                                              g.s, z.s, stats.s, c.stat.s);
  CHECK(launched(K_BN_BWD));
  colsum_final_kernel<T><<<dim3(ceil_div(C, kFinalCols), c.M), kFinalThreads, 0, c.st>>>(
      c.stat.p, out0.p, out1.p, f0.p, f1.p, nblk, C, c.stat.s, out0.s, f0.s);
  return launched(K_BN_BWD);
}

// BN backward: d scale and d bias (as T, and in f32 for the apply), then dz
// into `out` (TO).
template <typename T, typename TO>
int bn_bwd(const Call& c, FArr g, FArr z, FArr stats, Arr<T> sc, Arr<T> dsc, Arr<T> dbi, FArr dsc32,
           FArr dbi32, Arr<TO> out, int C) {
  CHECK(colsum(c, g, z, stats, dbi, dsc, dbi32, dsc32, c.R, C));
  bn_bwd_apply_kernel<T, TO><<<dim3(elementwise_blocks(c.R, C), c.M), NT, 0, c.st>>>(
      g.p, z.p, stats.p, sc.p, dbi32.p, dsc32.p, out.p, c.R, C, g.s, z.s, stats.s, sc.s, dbi32.s,
      out.s);
  return launched(K_BN_BWD);
}

// M members of N images of S x S each; E the embedding width.
template <typename T>
int embed_fwd(void* const* p, const long long* ms, int M, int N, int S, int E, void* stream) {
  auto fa = [p, ms](int i) { return FArr{static_cast<float*>(p[i]), ms[i]}; };
  auto ta = [p, ms](int i) { return Arr<T>{static_cast<T*>(p[i]), ms[i]}; };
  const Call c(p, M, N, S, stream);
  std::fill(g_launches, g_launches + NKIND, 0);
  const int R = c.R;
  const FArr stats = fa(STATS);
  const Arr<T> sc = ta(SC), bi = ta(BI);
  auto S_ = [&](int i) { return stats.at(i * 3 * CMAX); };
  auto SC_ = [&](int i) { return sc.at(i * CMAX); };
  auto BI_ = [&](int i) { return bi.at(i * CMAX); };
  const FArr none = kNone;
  const Arr<T> tnone{nullptr, 0};

  CHECK(pack_weights<T>(c, p, ms, W1C1, 0));

  conv0_fwd_kernel<T><<<dim3(ceil_div(static_cast<long long>(R) * C0, NT), M), NT, 0, c.st>>>(
      ta(X).p, ta(WI).p, fa(Z0).p, c.valid, R, S, ta(X).s, ta(WI).s, fa(Z0).s);
  CHECK(launched(K_CONV0));
  bn_stats_partial_kernel<<<dim3(ceil_div(R, kStatRows), M), NT, 0, c.st>>>(fa(Z0).p, c.stat.p, R, C0,
                                                                            fa(Z0).s, c.stat.s);
  CHECK(launched(K_BN_STATS));
  bn_stats_final_kernel<<<dim3(C0 / kFinalCols, M), kFinalThreads, 0, c.st>>>(
      c.stat.p, S_(0).p, ceil_div(R, kStatRows), kStatRows, R, C0, c.stat.s, stats.s);
  CHECK(launched(K_BN_STATS));
  CHECK(bn_act(c, fa(Z0), S_(0), SC_(0), BI_(0), none, none, tnone, tnone, ta(A), C0));

  CHECK(conv_tc(c, ta(A), c.w[0], none, tnone, fa(Z1P), S_(1), C0, C1, 9));
  CHECK(bn_act(c, fa(Z1P), S_(1), SC_(1), BI_(1), none, none, tnone, tnone, ta(Z1), C1));
  CHECK(conv_tc(c, ta(Z1), c.w[2], none, tnone, fa(Z2P), S_(2), C1, C1, 9));
  CHECK(conv_tc(c, ta(A), c.w[1], none, tnone, fa(IP1), S_(3), C0, C1, 1));
  CHECK(bn_act(c, fa(Z2P), S_(2), SC_(2), BI_(2), fa(IP1), S_(3), SC_(3), BI_(3), ta(Y1), C1));

  CHECK(conv_tc(c, ta(Y1), c.w[3], none, tnone, fa(Z1BP), S_(4), C1, C2, 9));
  CHECK(bn_act(c, fa(Z1BP), S_(4), SC_(4), BI_(4), none, none, tnone, tnone, ta(Z1B), C2));
  CHECK(conv_tc(c, ta(Z1B), c.w[5], none, tnone, fa(Z2BP), S_(5), C2, C2, 9));
  CHECK(conv_tc(c, ta(Y1), c.w[4], none, tnone, fa(IP2), S_(6), C1, C2, 1));
  CHECK(bn_act(c, fa(Z2BP), S_(5), SC_(5), BI_(5), fa(IP2), S_(6), SC_(6), BI_(6), ta(Y2), C2));

  pool_fc_kernel<T><<<dim3(N, M), C2, 0, c.st>>>(ta(Y2).p, ta(WFC).p, ta(BFC).p, fa(POOLED).p,
                                                 ta(EMB).p, S * S, E, ta(Y2).s, ta(WFC).s,
                                                 ta(BFC).s, fa(POOLED).s, ta(EMB).s);
  return launched(K_POOL_FC);
}

template <typename T>
int embed_bwd(void* const* p, const long long* ms, int M, int N, int S, int E, void* stream) {
  auto fa = [p, ms](int i) { return FArr{static_cast<float*>(p[i]), ms[i]}; };
  auto ta = [p, ms](int i) { return Arr<T>{static_cast<T*>(p[i]), ms[i]}; };
  const Call c(p, M, N, S, stream);
  std::fill(g_launches, g_launches + NKIND, 0);
  const int R = c.R;
  const FArr stats = fa(STATS);
  const FArr G = fa(BUF_G);
  const Arr<T> D1 = ta(BUF_D1), D2 = ta(BUF_D2);
  const FArr dsc32 = c.bn_grads, dbi32 = c.bn_grads.at(7 * CMAX);
  // BN i of BN_LAYOUT with pre-BN input z: its parameter gradients, and dz to `out`
  auto bn = [&](FArr g, int i, int z, auto out, int C) {
    return bn_bwd(c, g, fa(z), stats.at(i * 3 * CMAX), ta(SC).at(i * CMAX), ta(GSC).at(i * CMAX),
                  ta(GBI).at(i * CMAX), dsc32.at(i * CMAX), dbi32.at(i * CMAX), out, C);
  };
  const FArr none = kNone;
  const Arr<T> tnone{nullptr, 0};

  // the data gradients read the weights tap-flipped and transposed
  CHECK(pack_weights<T>(c, p, ms, W1C1, 1));

  // fc and mean pool; G = d(pre-ReLU output of block 2)
  pool_fc_bwd_kernel<T><<<dim3(N, M), 4 * C2, 0, c.st>>>(ta(GEMB).p, ta(WFC).p, ta(Y2).p, G.p, S * S,
                                                         E, ta(GEMB).s, ta(WFC).s, ta(Y2).s, G.s);
  CHECK(launched(K_POOL_FC));
  fc_wgrad_kernel<T><<<dim3(C2 / 16, ceil_div(E, 16), M), NT, 0, c.st>>>(
      fa(POOLED).p, ta(GEMB).p, ta(GWFC).p, N, E, fa(POOLED).s, ta(GEMB).s, ta(GWFC).s);
  CHECK(launched(K_WGRAD_SIMT));
  CHECK(colsum(c, ta(GEMB), none, none, ta(GBFC), tnone, none, none, N, E));

  // residual block 2: bn2 and skip bn both receive G
  CHECK(bn(G, 5, Z2BP, D1, C2));
  CHECK(bn(G, 6, IP2, D2, C2));
  CHECK(wgrad_tc(c, ta(Z1B), D1, ta(GW2C2), C2, C2, 9));
  CHECK(conv_tc(c, D1, c.w[5], none, ta(Z1B), G, none, C2, C2, 9));
  CHECK(bn(G, 4, Z1BP, D1, C2));
  CHECK(wgrad_tc(c, ta(Y1), D1, ta(GW2C1), C1, C2, 9));
  CHECK(wgrad_tc(c, ta(Y1), D2, ta(GW2SK), C1, C2, 1));
  CHECK(conv_tc(c, D2, c.w[4], none, tnone, G, none, C2, C1, 1));
  CHECK(conv_tc(c, D1, c.w[3], G, ta(Y1), G, none, C2, C1, 9));

  // residual block 1
  CHECK(bn(G, 2, Z2P, D1, C1));
  CHECK(bn(G, 3, IP1, D2, C1));
  CHECK(wgrad_tc(c, ta(Z1), D1, ta(GW1C2), C1, C1, 9));
  CHECK(conv_tc(c, D1, c.w[2], none, ta(Z1), G, none, C1, C1, 9));
  CHECK(bn(G, 1, Z1P, D1, C1));
  CHECK(wgrad_tc(c, ta(A), D1, ta(GW1C1), C0, C1, 9));
  CHECK(wgrad_tc(c, ta(A), D2, ta(GW1SK), C0, C1, 1));
  CHECK(conv_tc(c, D2, c.w[1], none, tnone, G, none, C1, C0, 1));
  CHECK(conv_tc(c, D1, c.w[0], G, ta(A), G, none, C1, C0, 9));

  // initial conv: BN 0's dz in place of G, in f32 (a product in neither
  // JAX's kernel nor here)
  CHECK(bn(G, 0, Z0, G, C0));
  const int chunks = std::min(ceil_div(R, 64), conv::kWgTargetBlocks);
  conv0_wgrad_kernel<T><<<dim3(chunks, M), NT, 0, c.st>>>(ta(X).p, G.p, c.wg.p, c.valid, R, S,
                                                          ceil_div(R, chunks), ta(X).s, G.s, c.wg.s);
  CHECK(launched(K_WGRAD_SIMT));
  CHECK(sum_chunks(c, ta(GWI), 9 * C0, chunks));
  conv0_dgrad_kernel<T><<<dim3(ceil_div(static_cast<long long>(R) * 32, NT), M), NT, 0, c.st>>>(
      G.p, ta(WI).p, ta(GX).p, c.valid, R, S, G.s, ta(WI).s, ta(GX).s);
  return launched(K_CONV0);
}

}  // namespace

extern "C" {

int deep_resnet_num_ptrs() { return NPTR; }

// Floats of scratch either entry needs for each member of R activation rows.
long long deep_resnet_scratch_floats(int R) {
  return stat_floats(R) + kPackedFloats + kWgradFloats + kBnGradFloats;
}

// Kernel launches the last call of any entry made, by kind, in the order of
// `enum Kind`; returns the number of kinds.
int deep_resnet_last_launches(int* out) {
  for (int k = 0; k < NKIND; ++k) out[k] = g_launches[k];
  return NKIND;
}

// K2 / K3: f32 in and out, products in 3xTF32.
int deep_resnet_embed_fwd(void* const* p, const long long* ms, int M, int N, int S, int E,
                          void* stream) {
  return embed_fwd<float>(p, ms, M, N, S, E, stream);
}

int deep_resnet_embed_bwd(void* const* p, const long long* ms, int M, int N, int S, int E,
                          void* stream) {
  return embed_bwd<float>(p, ms, M, N, S, E, stream);
}

// K2-bf16 / K3-bf16: bf16 in and out, bf16 products with f32 accumulation.
int deep_resnet_embed_fwd_bf16(void* const* p, const long long* ms, int M, int N, int S, int E,
                               void* stream) {
  return embed_fwd<bf16>(p, ms, M, N, S, E, stream);
}

int deep_resnet_embed_bwd_bf16(void* const* p, const long long* ms, int M, int N, int S, int E,
                               void* stream) {
  return embed_bwd<bf16>(p, ms, M, N, S, E, stream);
}

}  // extern "C"
