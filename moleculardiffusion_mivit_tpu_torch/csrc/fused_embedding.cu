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

#include <cuda_runtime.h>

#include <algorithm>

#include "conv_rows.cuh"

namespace {

using conv::ceil_div;

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
// Largest set of weight-gradient partials: (target blocks + tiles) * tile.
constexpr long long kWgradFloats =
    static_cast<long long>(conv::kWgTargetBlocks + 8) * 9 * conv::CIB * conv::COB;

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
  const PackItem it = list.item[blockIdx.y];
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

__device__ __forceinline__ int tap_offset(int t, int S) { return (t / 3 - 1) * S + (t % 3 - 1); }

// Initial conv, 1 -> 32 channels: z[r, c] = sum_t x[r + off(t)] * w[t, c].
__global__ void __launch_bounds__(NT) conv0_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ z,
    const int* __restrict__ valid, int R, int S) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= R * C0) return;
  const int r = i / C0, c = i % C0;
  const int vm = valid[r % (S * S)];
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t)
    if ((vm >> t) & 1) acc = fmaf(x[r + tap_offset(t, S)], w[t * C0 + c], acc);
  z[i] = acc;
}

// Its data gradient, one warp per pixel:
// gx[r] = sum_{t, c} d[r + off(t), c] * w[8 - t, c].
__global__ void __launch_bounds__(NT) conv0_dgrad_kernel(
    const float* __restrict__ d, const float* __restrict__ w, float* __restrict__ gx,
    const int* __restrict__ valid, int R, int S) {
  const int r = (blockIdx.x * NT + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (r >= R) return;
  const int vm = valid[r % (S * S)];
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t)
    if ((vm >> t) & 1)
      s = fmaf(d[static_cast<size_t>(r + tap_offset(t, S)) * C0 + lane], w[(8 - t) * C0 + lane], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) gx[r] = s;
}

// Its weight gradient: partial[chunk, t, c] = sum over the chunk's rows of
// x[r + off(t)] * d[r, c].
__global__ void __launch_bounds__(NT) conv0_wgrad_kernel(
    const float* __restrict__ x, const float* __restrict__ d, float* __restrict__ partial,
    const int* __restrict__ valid, int R, int S, int rows_per_chunk) {
  __shared__ float red[NT / C0][9][C0];
  const int c = threadIdx.x % C0, lane = threadIdx.x / C0;
  const int r_begin = blockIdx.x * rows_per_chunk, r_end = min(R, r_begin + rows_per_chunk);
  const int SS = S * S;
  float acc[9] = {};
  for (int r = r_begin + lane; r < r_end; r += NT / C0) {
    const float g = d[static_cast<size_t>(r) * C0 + c];
    const int vm = valid[r % SS];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if ((vm >> t) & 1) acc[t] = fmaf(x[r + tap_offset(t, S)], g, acc[t]);
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
// a batch of 32, double across batches.
__global__ void __launch_bounds__(NT) fc_wgrad_kernel(
    const float* __restrict__ pooled, const float* __restrict__ g, float* __restrict__ out,
    int N, int E) {
  __shared__ float p_s[32][16 + 1];
  __shared__ float g_s[32][16 + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * 16, e0 = blockIdx.y * 16;
  double total = 0.0;
  for (int n0 = 0; n0 < N; n0 += 32) {
    for (int i = threadIdx.x; i < 32 * 16; i += NT) {
      const int r = i / 16, col = i % 16, n = n0 + r;
      p_s[r][col] = n < N ? pooled[static_cast<size_t>(n) * C2 + c0 + col] : 0.f;
      g_s[r][col] = n < N && e0 + col < E ? g[static_cast<size_t>(n) * E + e0 + col] : 0.f;
    }
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) s = fmaf(p_s[r][ty], g_s[r][tx], s);
    total += s;
    __syncthreads();
  }
  if (e0 + tx < E) out[static_cast<size_t>(c0 + ty) * E + e0 + tx] = static_cast<float>(total);
}

__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int ch = 0; ch < chunks; ++ch) s += partial[static_cast<size_t>(ch) * n + i];
  out[i] = static_cast<float>(s);
}

// Per block of kStatRows rows: partial[blk, 0, c] = mean, [blk, 1, c] =
// centred sum of squares, accumulated in double. Needs C <= NT. Used for the
// initial conv's output; the tensor-core convs write the same partials per
// tile from their epilogue.
__global__ void __launch_bounds__(NT) bn_stats_partial_kernel(
    const float* __restrict__ z, double* __restrict__ partial, int R, int C) {
  __shared__ double red[NT];
  __shared__ double mean_s[NT];
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
    int C) {
  __shared__ double buf[kFinalThreads];
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

__global__ void bn_act_kernel(const float* __restrict__ za, const float* __restrict__ sta,
                              const float* __restrict__ sca, const float* __restrict__ bia,
                              const float* __restrict__ zb, const float* __restrict__ stb,
                              const float* __restrict__ scb, const float* __restrict__ bib,
                              float* __restrict__ out, int R, int C) {
  const size_t n = static_cast<size_t>(R) * C;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    float v = (za[i] - sta[c]) * sta[2 * CMAX + c] * sca[c] + bia[c];
    if (zb) v += (zb[i] - stb[c]) * stb[2 * CMAX + c] * scb[c] + bib[c];
    out[i] = fmaxf(v, 0.f);
  }
}

// partial[blk, 0, c] = sum g, [blk, 1, c] = sum g * xhat (xhat from z, st;
// skipped when z is null) over the block's kStatRows rows. Each thread sums
// its rows in four independent f32 chains (at most kStatRows / 4 terms each);
// everything beyond that accumulates in double. Needs C <= NT.
__global__ void __launch_bounds__(NT) bn_bwd_partial_kernel(
    const float* __restrict__ g, const float* __restrict__ z,
    const float* __restrict__ st, double* __restrict__ partial, int R, int C) {
  __shared__ double red0[NT];
  __shared__ double red1[NT];
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
        const float gv = g[o];
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
// ceil(C / kFinalCols).
__global__ void __launch_bounds__(kFinalThreads) colsum_final_kernel(
    const double* __restrict__ partial, float* __restrict__ out0, float* __restrict__ out1,
    int nblk, int C) {
  __shared__ double buf[kFinalThreads];
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
  out0[c] = static_cast<float>(t0);
  if (out1) out1[c] = static_cast<float>(t1);
}

// dz = (g - dbias/R - xhat*dscale/R) * scale * rstd
__global__ void bn_bwd_apply_kernel(const float* __restrict__ g, const float* __restrict__ z,
                                    const float* __restrict__ st, const float* __restrict__ sc,
                                    const float* __restrict__ dbias,
                                    const float* __restrict__ dscale,
                                    float* __restrict__ out, int R, int C) {
  const size_t n = static_cast<size_t>(R) * C;
  const float inv_r = 1.f / static_cast<float>(R);
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    const float rstd = st[2 * CMAX + c];
    const float xh = (z[i] - st[c]) * rstd;
    out[i] = (g[i] - dbias[c] * inv_r - xh * (dscale[c] * inv_r)) * (sc[c] * rstd);
  }
}

// One block per image: pooled[n] = mean over the image's rows of y2;
// emb[n] = pooled[n] @ wfc + bfc.
__global__ void pool_fc_kernel(const float* __restrict__ y2, const float* __restrict__ wfc,
                               const float* __restrict__ bfc, float* __restrict__ pooled,
                               float* __restrict__ emb, int SS, int E) {
  __shared__ float p_s[C2];
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    float s = 0.f;
    for (int pix = 0; pix < SS; ++pix) s += y2[(static_cast<size_t>(n) * SS + pix) * C2 + c];
    p_s[c] = s / static_cast<float>(SS);
    pooled[static_cast<size_t>(n) * C2 + c] = p_s[c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < C2; ++c) acc = fmaf(p_s[c], wfc[c * E + e], acc);
    emb[static_cast<size_t>(n) * E + e] = acc + bfc[e];
  }
}

// One block per image: gpre[r, c] = (y2[r, c] > 0) * (g[n] @ wfc^T)[c] / SS
__global__ void pool_fc_bwd_kernel(const float* __restrict__ g, const float* __restrict__ wfc,
                                   const float* __restrict__ y2, float* __restrict__ gpre,
                                   int SS, int E) {
  __shared__ float gp[C2];
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    float s = 0.f;
    for (int e = 0; e < E; ++e) s = fmaf(g[static_cast<size_t>(n) * E + e], wfc[c * E + e], s);
    gp[c] = s / static_cast<float>(SS);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SS * C2; i += blockDim.x) {
    const size_t o = static_cast<size_t>(n) * SS * C2 + i;
    gpre[o] = y2[o] > 0.f ? gp[i % C2] : 0.f;
  }
}

// ---------------------------------------------------------------- launches

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

// What every launcher needs of one entry call. The scratch holds, in order,
// the BN partials (doubles), the packed weights and the weight-gradient
// partials.
struct Call {
  int R, S;
  cudaStream_t st;
  const int* valid;
  double* stat;
  float* packed;
  float* wg;
  const float* w[kNumPacked];  // packed GEMM operands, in kPackedShapes order

  Call(void* const* p, int n, int s, void* stream, int scratch_index, int valid_index)
      : R(n * s * s), S(s), st(static_cast<cudaStream_t>(stream)),
        valid(static_cast<const int*>(p[valid_index])) {
    float* scratch = static_cast<float*>(p[scratch_index]);
    stat = reinterpret_cast<double*>(scratch);
    packed = scratch + stat_floats(R);
    wg = packed + kPackedFloats;
    for (int i = 0; i < kNumPacked; ++i) w[i] = packed + packed_floats_before(i);
  }
};

int pack_weights(const Call& c, void* const* p, int first_weight, int flip) {
  PackList list;
  int largest = 0;
  for (int i = 0; i < kNumPacked; ++i) {
    const WeightShape s = kPackedShapes[i];
    list.item[i] = {static_cast<const float*>(p[first_weight + i]),
                    c.packed + packed_floats_before(i), s.taps, flip ? s.co : s.ci,
                    flip ? s.ci : s.co};
    largest = std::max(largest, s.taps * s.ci * s.co);
  }
  pack_weights_kernel<<<dim3(ceil_div(largest, 4 * NT), kNumPacked), NT, 0, c.st>>>(list, flip);
  return launched(K_PACK);
}

// Tensor-core conv; with `stats` also the BN statistics of its output.
int conv_tc(const Call& c, const float* x, const float* wp, const float* add, const float* mask,
            float* y, float* stats, int Ci, int Co, int taps) {
  int bm = 0;
  CHECK(conv::launch_conv(x, wp, add, mask, y, stats ? c.stat : nullptr, c.valid, c.R, c.S, Ci,
                          Co, taps, &bm, c.st));
  ++g_launches[K_CONV_TC];
  if (!stats) return 0;
  bn_stats_final_kernel<<<Co / kFinalCols, kFinalThreads, 0, c.st>>>(c.stat, stats, ceil_div(c.R, bm), bm, c.R, Co);
  return launched(K_BN_STATS);
}

int sum_chunks(const Call& c, float* out, int n, int chunks) {
  sum_chunks_kernel<<<ceil_div(n, NT), NT, 0, c.st>>>(c.wg, out, n, chunks);
  return launched(K_SUM_CHUNKS);
}

int wgrad_tc(const Call& c, const float* x, const float* g, float* out, int Ci, int Co,
             int taps) {
  int chunks = 0;
  if (taps == 9) {
    CHECK(conv::launch_wgrad<9>(x, g, c.wg, c.valid, c.R, c.S, Ci, Co, &chunks, c.st));
  } else {
    CHECK(conv::launch_wgrad<1>(x, g, c.wg, c.valid, c.R, c.S, Ci, Co, &chunks, c.st));
  }
  ++g_launches[K_WGRAD_TC];
  return sum_chunks(c, out, taps * Ci * Co, chunks);
}

int bn_act(const Call& c, const float* za, const float* sta, const float* sca, const float* bia,
           const float* zb, const float* stb, const float* scb, const float* bib, float* out,
           int C) {
  bn_act_kernel<<<elementwise_blocks(c.R, C), NT, 0, c.st>>>(za, sta, sca, bia, zb, stb, scb,
                                                             bib, out, c.R, C);
  return launched(K_BN_ACT);
}

// Column sums of g and of g * xhat into out0 (d bias) and out1 (d scale).
int colsum(const Call& c, const float* g, const float* z, const float* stats, float* out0,
           float* out1, int rows, int C) {
  const int nblk = ceil_div(rows, kStatRows);
  bn_bwd_partial_kernel<<<nblk, NT, 0, c.st>>>(g, z, stats, c.stat, rows, C);
  CHECK(launched(K_BN_BWD));
  colsum_final_kernel<<<ceil_div(C, kFinalCols), kFinalThreads, 0, c.st>>>(c.stat, out0, out1, nblk, C);
  return launched(K_BN_BWD);
}

int bn_bwd(const Call& c, const float* g, const float* z, const float* stats, const float* sc,
           float* dsc, float* dbi, float* out, int C) {
  CHECK(colsum(c, g, z, stats, dbi, dsc, c.R, C));
  bn_bwd_apply_kernel<<<elementwise_blocks(c.R, C), NT, 0, c.st>>>(g, z, stats, sc, dbi, dsc,
                                                                   out, c.R, C);
  return launched(K_BN_BWD);
}

}  // namespace

extern "C" {

// Order of the pointer array both entries take (ops/fused_embedding.py
// builds it from the same list). Weights keep the JAX layout: 3x3 kernels
// tap-major (9 * cin, cout), 1x1 kernels (cin, cout), fc (128, E); BN scales
// and biases packed (7, 128) in BN_LAYOUT order; stats (7, 3, 128) =
// mean, biased var, rstd per BN; VALID the S*S tap-validity words (bit t set
// where tap t of that pixel reads inside the image).
enum Ptr {
  X, WI, W1C1, W1SK, W1C2, W2C1, W2SK, W2C2, SC, BI, WFC, BFC,
  Z0, A, Z1P, Z1, Z2P, IP1, Y1, Z1BP, Z1B, Z2BP, IP2, Y2, POOLED, STATS,
  EMB, SCRATCH, VALID,
  GEMB, GX, GWI, GW1C1, GW1SK, GW1C2, GW2C1, GW2SK, GW2C2, GSC, GBI, GWFC, GBFC,
  BUF_G, BUF_D1, BUF_D2,
  NPTR
};

int deep_resnet_num_ptrs() { return NPTR; }

// Floats of scratch either entry needs for R activation rows.
long long deep_resnet_scratch_floats(int R) {
  return stat_floats(R) + kPackedFloats + kWgradFloats;
}

// Kernel launches the last call of either entry made, by kind, in the
// order of `enum Kind`; returns the number of kinds.
int deep_resnet_last_launches(int* out) {
  for (int k = 0; k < NKIND; ++k) out[k] = g_launches[k];
  return NKIND;
}

int deep_resnet_embed_fwd(void* const* p, int N, int S, int E, void* stream) {
  auto f = [p](int i) { return static_cast<float*>(p[i]); };
  const Call c(p, N, S, stream, SCRATCH, VALID);
  std::fill(g_launches, g_launches + NKIND, 0);
  const int R = c.R;
  float* sc = f(SC);
  float* bi = f(BI);
  float* stats = f(STATS);
  auto S_ = [&](int i) { return stats + i * 3 * CMAX; };
  auto SC_ = [&](int i) { return sc + i * CMAX; };
  auto BI_ = [&](int i) { return bi + i * CMAX; };
  const float* none = nullptr;

  CHECK(pack_weights(c, p, W1C1, 0));

  conv0_fwd_kernel<<<ceil_div(static_cast<long long>(R) * C0, NT), NT, 0, c.st>>>(
      f(X), f(WI), f(Z0), c.valid, R, S);
  CHECK(launched(K_CONV0));
  bn_stats_partial_kernel<<<ceil_div(R, kStatRows), NT, 0, c.st>>>(f(Z0), c.stat, R, C0);
  CHECK(launched(K_BN_STATS));
  bn_stats_final_kernel<<<C0 / kFinalCols, kFinalThreads, 0, c.st>>>(c.stat, S_(0), ceil_div(R, kStatRows), kStatRows, R, C0);
  CHECK(launched(K_BN_STATS));
  CHECK(bn_act(c, f(Z0), S_(0), SC_(0), BI_(0), none, none, none, none, f(A), C0));

  CHECK(conv_tc(c, f(A), c.w[0], none, none, f(Z1P), S_(1), C0, C1, 9));
  CHECK(bn_act(c, f(Z1P), S_(1), SC_(1), BI_(1), none, none, none, none, f(Z1), C1));
  CHECK(conv_tc(c, f(Z1), c.w[2], none, none, f(Z2P), S_(2), C1, C1, 9));
  CHECK(conv_tc(c, f(A), c.w[1], none, none, f(IP1), S_(3), C0, C1, 1));
  CHECK(bn_act(c, f(Z2P), S_(2), SC_(2), BI_(2), f(IP1), S_(3), SC_(3), BI_(3), f(Y1), C1));

  CHECK(conv_tc(c, f(Y1), c.w[3], none, none, f(Z1BP), S_(4), C1, C2, 9));
  CHECK(bn_act(c, f(Z1BP), S_(4), SC_(4), BI_(4), none, none, none, none, f(Z1B), C2));
  CHECK(conv_tc(c, f(Z1B), c.w[5], none, none, f(Z2BP), S_(5), C2, C2, 9));
  CHECK(conv_tc(c, f(Y1), c.w[4], none, none, f(IP2), S_(6), C1, C2, 1));
  CHECK(bn_act(c, f(Z2BP), S_(5), SC_(5), BI_(5), f(IP2), S_(6), SC_(6), BI_(6), f(Y2), C2));

  pool_fc_kernel<<<N, C2, 0, c.st>>>(f(Y2), f(WFC), f(BFC), f(POOLED), f(EMB), S * S, E);
  return launched(K_POOL_FC);
}

int deep_resnet_embed_bwd(void* const* p, int N, int S, int E, void* stream) {
  auto f = [p](int i) { return static_cast<float*>(p[i]); };
  const Call c(p, N, S, stream, SCRATCH, VALID);
  std::fill(g_launches, g_launches + NKIND, 0);
  const int R = c.R;
  float* stats = f(STATS);
  float* G = f(BUF_G);
  float* D1 = f(BUF_D1);
  float* D2 = f(BUF_D2);
  // BN i of BN_LAYOUT with pre-BN input z: its parameter gradients, and dz to `out`
  auto bn = [&](const float* g, int i, int z, float* out, int C) {
    return bn_bwd(c, g, f(z), stats + i * 3 * CMAX, f(SC) + i * CMAX, f(GSC) + i * CMAX,
                  f(GBI) + i * CMAX, out, C);
  };
  const float* none = nullptr;

  // the data gradients read the weights tap-flipped and transposed
  CHECK(pack_weights(c, p, W1C1, 1));

  // fc and mean pool; G = d(pre-ReLU output of block 2)
  pool_fc_bwd_kernel<<<N, 4 * C2, 0, c.st>>>(f(GEMB), f(WFC), f(Y2), G, S * S, E);
  CHECK(launched(K_POOL_FC));
  fc_wgrad_kernel<<<dim3(C2 / 16, ceil_div(E, 16)), NT, 0, c.st>>>(f(POOLED), f(GEMB), f(GWFC), N, E);
  CHECK(launched(K_WGRAD_SIMT));
  CHECK(colsum(c, f(GEMB), none, none, f(GBFC), nullptr, N, E));

  // residual block 2: bn2 and skip bn both receive G
  CHECK(bn(G, 5, Z2BP, D1, C2));
  CHECK(bn(G, 6, IP2, D2, C2));
  CHECK(wgrad_tc(c, f(Z1B), D1, f(GW2C2), C2, C2, 9));
  CHECK(conv_tc(c, D1, c.w[5], none, f(Z1B), G, nullptr, C2, C2, 9));
  CHECK(bn(G, 4, Z1BP, D1, C2));
  CHECK(wgrad_tc(c, f(Y1), D1, f(GW2C1), C1, C2, 9));
  CHECK(wgrad_tc(c, f(Y1), D2, f(GW2SK), C1, C2, 1));
  CHECK(conv_tc(c, D2, c.w[4], none, none, G, nullptr, C2, C1, 1));
  CHECK(conv_tc(c, D1, c.w[3], G, f(Y1), G, nullptr, C2, C1, 9));

  // residual block 1
  CHECK(bn(G, 2, Z2P, D1, C1));
  CHECK(bn(G, 3, IP1, D2, C1));
  CHECK(wgrad_tc(c, f(Z1), D1, f(GW1C2), C1, C1, 9));
  CHECK(conv_tc(c, D1, c.w[2], none, f(Z1), G, nullptr, C1, C1, 9));
  CHECK(bn(G, 1, Z1P, D1, C1));
  CHECK(wgrad_tc(c, f(A), D1, f(GW1C1), C0, C1, 9));
  CHECK(wgrad_tc(c, f(A), D2, f(GW1SK), C0, C1, 1));
  CHECK(conv_tc(c, D2, c.w[1], none, none, G, nullptr, C1, C0, 1));
  CHECK(conv_tc(c, D1, c.w[0], G, f(A), G, nullptr, C1, C0, 9));

  // initial conv
  CHECK(bn(G, 0, Z0, D1, C0));
  const int chunks = std::min(ceil_div(R, 64), conv::kWgTargetBlocks);
  conv0_wgrad_kernel<<<chunks, NT, 0, c.st>>>(f(X), D1, c.wg, c.valid, R, S, ceil_div(R, chunks));
  CHECK(launched(K_WGRAD_SIMT));
  CHECK(sum_chunks(c, f(GWI), 9 * C0, chunks));
  conv0_dgrad_kernel<<<ceil_div(static_cast<long long>(R) * 32, NT), NT, 0, c.st>>>(
      D1, f(WI), f(GX), c.valid, R, S);
  return launched(K_CONV0);
}

}  // extern "C"
