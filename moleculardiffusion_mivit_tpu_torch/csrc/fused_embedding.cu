// K2 and K3: the DeepResNetEmbedding training forward and backward for
// NVIDIA Hopper (sm_90a), plain f32 (no tensor cores).
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
// What bounds it on this card: the 3x3 convs at 64 and 128 channels, about
// 5.7e5 multiply-add FLOP per activation row forward and twice that
// backward (rows R = batch * frames * S * S; R = 19,440 at batch 8), against
// 67 TFLOP/s of f32 outside the tensor cores. Activations are 32..128 f32
// per row, so a whole layer (R * 128 * 4 B = 10 MB at batch 8) is far above
// a block's 227 KB of shared memory, and training BN needs statistics over
// all R rows before any row can be normalised. The TPU design (everything
// resident in 110 MB of VMEM, rolls + masks, recompute in the backward)
// cannot carry over.
//
// Design: a short sequence of launches on the caller's stream, holding
// activations in device memory in the channels-last (R, C) row layout.
//  - conv_rows: implicit-GEMM 3x3 SAME (or 1x1) conv, 64x64 output tiles,
//    K = taps * Cin looped through shared memory in chunks of 16. The halo
//    is an index computed inside each S x S image (no padding rows, no
//    masks). With `flip` it reads the weights as the flipped transpose,
//    which makes the same kernel the data gradient; `add` and `mask` fuse
//    the residual-gradient sum and the ReLU mask into its epilogue.
//  - bn_stats: per-block mean and centred sum of squares (two passes over
//    the block's rows), merged in a fixed order with Chan's formula by a
//    second small launch: stable at 155k rows where E[x^2]-E[x]^2 cancels,
//    and deterministic.
//  - bn_act: BN apply + optional second BN branch (the skip) + ReLU.
//  - pool_fc / pool_fc_bwd: one block per image.
//  - wgrad_rows: weight gradients as per-chunk partial products over row
//    chunks, then a fixed-order sum of the chunks: deterministic, no
//    atomics on parameter gradients.
//  - bn_bwd_partial / colsum_final / bn_bwd_apply: BN backward.
// Every reduction over rows (the BN statistics, the BN-backward sums, the
// sum of the weight-gradient chunks) accumulates in double: above ~10^4
// rows the gradients through seven batch-statistics BNs are ill-conditioned
// enough that float sums cost visible accuracy, and these reductions move
// few bytes, so the double rate does not bound them.
// The backward reads the forward's saved pre-BN conv outputs, the post-ReLU
// activations and the BN statistics (saved by the caller through
// ctx.save_for_backward) instead of recomputing the forward: device memory
// is not scarce here (~1 KB per row), and recomputation would double the
// conv work of the backward. x-hat is recomputed from the pre-BN value and
// the statistics inside each BN-backward kernel rather than stored.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int C0 = 32, C1 = 64, C2 = 128, CMAX = 128;
constexpr float kEps = 1e-5f;
constexpr int BM = 64, BN = 64, BK = 16, NT = 256;
constexpr int kStatRows = 256;      // rows per block of the BN reductions
constexpr int kTargetBlocks = 528;  // 4 per SM: grid size the wgrad aims at

__device__ __forceinline__ int src_row(int r, int tap, int S, int SS, int taps) {
  if (taps == 1) return r;
  const int pix = r % SS;
  const int h = pix / S;
  const int w = pix - h * S;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int sh = h + dy, sw = w + dx;
  if (sh < 0 || sh >= S || sw < 0 || sw >= S) return -1;
  return r + dy * S + dx;
}

// y[r, c] = mask(add[r, c] + sum_k A[r, k] * B[k, c]), k = (tap, ci),
// A[r, (tap, ci)] = x[src_row(r, tap), ci], B = w (K, Co) or, with flip, the
// tap-flipped transpose of a (taps * Co, Ci) weight.
__global__ void __launch_bounds__(NT) conv_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* add,
    const float* __restrict__ mask, float* y, int R, int S, int Ci, int Co,
    int taps, int flip) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int K = taps * Ci, SS = S * S;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK, kk = i % BK;
      const int r = row0 + m, k = k0 + kk;
      float v = 0.f;
      if (r < R && k < K) {
        const int tap = k / Ci, ci = k - tap * Ci;
        const int s = src_row(r, tap, S, SS, taps);
        if (s >= 0) v = x[static_cast<size_t>(s) * Ci + ci];
      }
      As[kk][m] = v;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, n = i % BN;
      const int k = k0 + kk, c = col0 + n;
      float v = 0.f;
      if (k < K && c < Co) {
        if (flip) {
          const int tap = k / Ci, ci = k - tap * Ci;
          v = w[(static_cast<size_t>(taps - 1 - tap) * Co + c) * Ci + ci];
        } else {
          v = w[static_cast<size_t>(k) * Co + c];
        }
      }
      Bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= Co) continue;
      const size_t o = static_cast<size_t>(r) * Co + c;
      float v = acc[i][j];
      if (add) v += add[o];
      if (mask && !(mask[o] > 0.f)) v = 0.f;
      y[o] = v;
    }
  }
}

// partial[chunk, k, c] = sum over the chunk's rows r of A[r, k] * g[r, c]
__global__ void __launch_bounds__(NT) wgrad_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    float* __restrict__ partial, int R, int S, int Ci, int Co, int taps,
    int rows_per_chunk) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Gs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BM, c0 = blockIdx.y * BN, chunk = blockIdx.z;
  const int K = taps * Ci, SS = S * S;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(R, r_begin + rows_per_chunk);
  float acc[4][4] = {};
  for (int rb = r_begin; rb < r_end; rb += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int kk = i % BM, rr = i / BM;
      const int r = rb + rr, k = k0 + kk;
      float v = 0.f;
      if (r < r_end && k < K) {
        const int tap = k / Ci, ci = k - tap * Ci;
        const int s = src_row(r, tap, S, SS, taps);
        if (s >= 0) v = x[static_cast<size_t>(s) * Ci + ci];
      }
      As[rr][kk] = v;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int cc = i % BN, rr = i / BN;
      const int r = rb + rr, c = c0 + cc;
      Gs[rr][cc] = (r < r_end && c < Co) ? g[static_cast<size_t>(r) * Co + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < BK; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Gs[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < Co) partial[(static_cast<size_t>(chunk) * K + k) * Co + c] = acc[i][j];
    }
  }
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
// centred sum of squares, accumulated in double. Needs C <= NT.
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

// Chan's merge of the block partials, in block order.
// st[0:C] = mean, st[CMAX:CMAX+C] = biased var, st[2*CMAX:2*CMAX+C] = rstd
__global__ void bn_stats_final_kernel(const double* __restrict__ partial,
                                      float* __restrict__ st, int nblk, int R,
                                      int C) {
  const int c = threadIdx.x;
  if (c >= C) return;
  double n_a = 0.0, mean = 0.0, m2 = 0.0;
  for (int b = 0; b < nblk; ++b) {
    const double n_b = min(kStatRows, R - b * kStatRows);
    const double mb = partial[(static_cast<size_t>(b) * 2) * C + c];
    const double m2b = partial[(static_cast<size_t>(b) * 2 + 1) * C + c];
    const double n = n_a + n_b;
    const double delta = mb - mean;
    mean += delta * (n_b / n);
    m2 += m2b + delta * delta * (n_a * n_b / n);
    n_a = n;
  }
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
// skipped when z is null), accumulated in double. Needs C <= NT.
__global__ void __launch_bounds__(NT) bn_bwd_partial_kernel(
    const float* __restrict__ g, const float* __restrict__ z,
    const float* __restrict__ st, double* __restrict__ partial, int R, int C) {
  __shared__ double red0[NT];
  __shared__ double red1[NT];
  const int c = threadIdx.x % C, lane = threadIdx.x / C, lanes = NT / C;
  const int r0 = blockIdx.x * kStatRows, r1 = min(R, r0 + kStatRows);
  double s0 = 0.0, s1 = 0.0;
  if (lane < lanes) {
    const float mean = z ? st[c] : 0.f, rstd = z ? st[2 * CMAX + c] : 0.f;
    for (int r = r0 + lane; r < r1; r += lanes) {
      const size_t o = static_cast<size_t>(r) * C + c;
      s0 += g[o];
      if (z) s1 = fma(static_cast<double>(g[o]), static_cast<double>((z[o] - mean) * rstd), s1);
    }
  }
  red0[threadIdx.x] = s0;
  red1[threadIdx.x] = s1;
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

__global__ void colsum_final_kernel(const double* __restrict__ partial,
                                    float* __restrict__ out0, float* __restrict__ out1,
                                    int nblk, int C) {
  const int c = threadIdx.x;
  if (c >= C) return;
  double t0 = 0.0, t1 = 0.0;
  for (int b = 0; b < nblk; ++b) {
    t0 += partial[(static_cast<size_t>(b) * 2) * C + c];
    t1 += partial[(static_cast<size_t>(b) * 2 + 1) * C + c];
  }
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

inline int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

inline int elementwise_blocks(int R, int C) {
  return std::min(ceil_div(static_cast<long long>(R) * C, NT), 132 * 16);
}

int conv(const float* x, const float* w, const float* add, const float* mask, float* y,
         int R, int S, int Ci, int Co, int taps, int flip, cudaStream_t st) {
  dim3 grid(ceil_div(R, BM), ceil_div(Co, BN));
  conv_rows_kernel<<<grid, NT, 0, st>>>(x, w, add, mask, y, R, S, Ci, Co, taps, flip);
  return static_cast<int>(cudaGetLastError());
}

int wgrad(const float* x, const float* g, float* out, float* scratch, int R, int S, int Ci,
          int Co, int taps, cudaStream_t st) {
  const int K = taps * Ci;
  const int tiles = ceil_div(K, BM) * ceil_div(Co, BN);
  int chunks = std::max(1, std::min(ceil_div(R, BK), ceil_div(kTargetBlocks, tiles)));
  const int rows_per_chunk = ceil_div(ceil_div(R, chunks), BK) * BK;
  chunks = ceil_div(R, rows_per_chunk);
  dim3 grid(ceil_div(K, BM), ceil_div(Co, BN), chunks);
  wgrad_rows_kernel<<<grid, NT, 0, st>>>(x, g, scratch, R, S, Ci, Co, taps, rows_per_chunk);
  CHECK(static_cast<int>(cudaGetLastError()));
  sum_chunks_kernel<<<ceil_div(K * Co, NT), NT, 0, st>>>(scratch, out, K * Co, chunks);
  return static_cast<int>(cudaGetLastError());
}

int bn_stats(const float* z, float* stats, float* scratch, int R, int C, cudaStream_t st) {
  const int nblk = ceil_div(R, kStatRows);
  double* partial = reinterpret_cast<double*>(scratch);
  bn_stats_partial_kernel<<<nblk, NT, 0, st>>>(z, partial, R, C);
  CHECK(static_cast<int>(cudaGetLastError()));
  bn_stats_final_kernel<<<1, NT, 0, st>>>(partial, stats, nblk, R, C);
  return static_cast<int>(cudaGetLastError());
}

int bn_act(const float* za, const float* sta, const float* sca, const float* bia,
           const float* zb, const float* stb, const float* scb, const float* bib, float* out,
           int R, int C, cudaStream_t st) {
  bn_act_kernel<<<elementwise_blocks(R, C), NT, 0, st>>>(za, sta, sca, bia, zb, stb, scb, bib,
                                                         out, R, C);
  return static_cast<int>(cudaGetLastError());
}

// Column sums of g and of g * xhat into out0 (d bias) and out1 (d scale).
int colsum(const float* g, const float* z, const float* stats, float* out0, float* out1,
           float* scratch, int R, int C, cudaStream_t st) {
  const int nblk = ceil_div(R, kStatRows);
  double* partial = reinterpret_cast<double*>(scratch);
  bn_bwd_partial_kernel<<<nblk, NT, 0, st>>>(g, z, stats, partial, R, C);
  CHECK(static_cast<int>(cudaGetLastError()));
  colsum_final_kernel<<<1, NT, 0, st>>>(partial, out0, out1, nblk, C);
  return static_cast<int>(cudaGetLastError());
}

int bn_bwd(const float* g, const float* z, const float* stats, const float* sc, float* dsc,
           float* dbi, float* out, float* scratch, int R, int C, cudaStream_t st) {
  CHECK(colsum(g, z, stats, dbi, dsc, scratch, R, C, st));
  bn_bwd_apply_kernel<<<elementwise_blocks(R, C), NT, 0, st>>>(g, z, stats, sc, dbi, dsc, out,
                                                               R, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Order of the pointer array both entries take (ops/fused_embedding.py
// builds it from the same list). Weights keep the JAX layout: 3x3 kernels
// tap-major (9 * cin, cout), 1x1 kernels (cin, cout), fc (128, E); BN scales
// and biases packed (7, 128) in BN_LAYOUT order; stats (7, 3, 128) =
// mean, biased var, rstd per BN.
enum Ptr {
  X, WI, W1C1, W1SK, W1C2, W2C1, W2SK, W2C2, SC, BI, WFC, BFC,
  Z0, A, Z1P, Z1, Z2P, IP1, Y1, Z1BP, Z1B, Z2BP, IP2, Y2, POOLED, STATS,
  EMB, SCRATCH,
  GEMB, GX, GWI, GW1C1, GW1SK, GW1C2, GW2C1, GW2SK, GW2C2, GSC, GBI, GWFC, GBFC,
  BUF_G, BUF_D1, BUF_D2,
  NPTR
};

int deep_resnet_num_ptrs() { return NPTR; }

// Floats of scratch either entry needs for R activation rows.
long long deep_resnet_scratch_floats(int R) {
  const long long bn = 4LL * ceil_div(R, kStatRows) * NT;  // doubles
  const long long wg = static_cast<long long>(kTargetBlocks + 64) * BM * BN;
  return bn > wg ? bn : wg;
}

int deep_resnet_embed_fwd(void* const* p, int N, int S, int E, void* stream) {
  auto f = [p](int i) { return static_cast<float*>(p[i]); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = N * S * S;
  float* sc = f(SC);
  float* bi = f(BI);
  float* stats = f(STATS);
  float* scr = f(SCRATCH);
  auto S_ = [&](int i) { return stats + i * 3 * CMAX; };
  auto SC_ = [&](int i) { return sc + i * CMAX; };
  auto BI_ = [&](int i) { return bi + i * CMAX; };

  CHECK(conv(f(X), f(WI), nullptr, nullptr, f(Z0), R, S, 1, C0, 9, 0, st));
  CHECK(bn_stats(f(Z0), S_(0), scr, R, C0, st));
  CHECK(bn_act(f(Z0), S_(0), SC_(0), BI_(0), nullptr, nullptr, nullptr, nullptr, f(A), R, C0, st));

  CHECK(conv(f(A), f(W1C1), nullptr, nullptr, f(Z1P), R, S, C0, C1, 9, 0, st));
  CHECK(bn_stats(f(Z1P), S_(1), scr, R, C1, st));
  CHECK(bn_act(f(Z1P), S_(1), SC_(1), BI_(1), nullptr, nullptr, nullptr, nullptr, f(Z1), R, C1, st));
  CHECK(conv(f(Z1), f(W1C2), nullptr, nullptr, f(Z2P), R, S, C1, C1, 9, 0, st));
  CHECK(bn_stats(f(Z2P), S_(2), scr, R, C1, st));
  CHECK(conv(f(A), f(W1SK), nullptr, nullptr, f(IP1), R, S, C0, C1, 1, 0, st));
  CHECK(bn_stats(f(IP1), S_(3), scr, R, C1, st));
  CHECK(bn_act(f(Z2P), S_(2), SC_(2), BI_(2), f(IP1), S_(3), SC_(3), BI_(3), f(Y1), R, C1, st));

  CHECK(conv(f(Y1), f(W2C1), nullptr, nullptr, f(Z1BP), R, S, C1, C2, 9, 0, st));
  CHECK(bn_stats(f(Z1BP), S_(4), scr, R, C2, st));
  CHECK(bn_act(f(Z1BP), S_(4), SC_(4), BI_(4), nullptr, nullptr, nullptr, nullptr, f(Z1B), R, C2, st));
  CHECK(conv(f(Z1B), f(W2C2), nullptr, nullptr, f(Z2BP), R, S, C2, C2, 9, 0, st));
  CHECK(bn_stats(f(Z2BP), S_(5), scr, R, C2, st));
  CHECK(conv(f(Y1), f(W2SK), nullptr, nullptr, f(IP2), R, S, C1, C2, 1, 0, st));
  CHECK(bn_stats(f(IP2), S_(6), scr, R, C2, st));
  CHECK(bn_act(f(Z2BP), S_(5), SC_(5), BI_(5), f(IP2), S_(6), SC_(6), BI_(6), f(Y2), R, C2, st));

  pool_fc_kernel<<<N, C2, 0, st>>>(f(Y2), f(WFC), f(BFC), f(POOLED), f(EMB), S * S, E);
  return static_cast<int>(cudaGetLastError());
}

int deep_resnet_embed_bwd(void* const* p, int N, int S, int E, void* stream) {
  auto f = [p](int i) { return static_cast<float*>(p[i]); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = N * S * S;
  float* stats = f(STATS);
  float* scr = f(SCRATCH);
  float* G = f(BUF_G);
  float* D1 = f(BUF_D1);
  float* D2 = f(BUF_D2);
  auto S_ = [&](int i) { return stats + i * 3 * CMAX; };
  auto SC_ = [&](int i) { return f(SC) + i * CMAX; };
  auto GSC_ = [&](int i) { return f(GSC) + i * CMAX; };
  auto GBI_ = [&](int i) { return f(GBI) + i * CMAX; };

  // fc and mean pool; G = d(pre-ReLU output of block 2)
  pool_fc_bwd_kernel<<<N, C2, 0, st>>>(f(GEMB), f(WFC), f(Y2), G, S * S, E);
  CHECK(static_cast<int>(cudaGetLastError()));
  CHECK(wgrad(f(POOLED), f(GEMB), f(GWFC), scr, N, 1, C2, E, 1, st));
  CHECK(colsum(f(GEMB), nullptr, nullptr, f(GBFC), nullptr, scr, N, E, st));

  // residual block 2: bn2 and skip bn both receive G
  CHECK(bn_bwd(G, f(Z2BP), S_(5), SC_(5), GSC_(5), GBI_(5), D1, scr, R, C2, st));
  CHECK(bn_bwd(G, f(IP2), S_(6), SC_(6), GSC_(6), GBI_(6), D2, scr, R, C2, st));
  CHECK(wgrad(f(Z1B), D1, f(GW2C2), scr, R, S, C2, C2, 9, st));
  CHECK(conv(D1, f(W2C2), nullptr, f(Z1B), G, R, S, C2, C2, 9, 1, st));
  CHECK(bn_bwd(G, f(Z1BP), S_(4), SC_(4), GSC_(4), GBI_(4), D1, scr, R, C2, st));
  CHECK(wgrad(f(Y1), D1, f(GW2C1), scr, R, S, C1, C2, 9, st));
  CHECK(wgrad(f(Y1), D2, f(GW2SK), scr, R, S, C1, C2, 1, st));
  CHECK(conv(D2, f(W2SK), nullptr, nullptr, G, R, S, C2, C1, 1, 1, st));
  CHECK(conv(D1, f(W2C1), G, f(Y1), G, R, S, C2, C1, 9, 1, st));

  // residual block 1
  CHECK(bn_bwd(G, f(Z2P), S_(2), SC_(2), GSC_(2), GBI_(2), D1, scr, R, C1, st));
  CHECK(bn_bwd(G, f(IP1), S_(3), SC_(3), GSC_(3), GBI_(3), D2, scr, R, C1, st));
  CHECK(wgrad(f(Z1), D1, f(GW1C2), scr, R, S, C1, C1, 9, st));
  CHECK(conv(D1, f(W1C2), nullptr, f(Z1), G, R, S, C1, C1, 9, 1, st));
  CHECK(bn_bwd(G, f(Z1P), S_(1), SC_(1), GSC_(1), GBI_(1), D1, scr, R, C1, st));
  CHECK(wgrad(f(A), D1, f(GW1C1), scr, R, S, C0, C1, 9, st));
  CHECK(wgrad(f(A), D2, f(GW1SK), scr, R, S, C0, C1, 1, st));
  CHECK(conv(D2, f(W1SK), nullptr, nullptr, G, R, S, C1, C0, 1, 1, st));
  CHECK(conv(D1, f(W1C1), G, f(A), G, R, S, C1, C0, 9, 1, st));

  // initial conv
  CHECK(bn_bwd(G, f(Z0), S_(0), SC_(0), GSC_(0), GBI_(0), D1, scr, R, C0, st));
  CHECK(wgrad(f(X), D1, f(GWI), scr, R, S, 1, C0, 9, st));
  return conv(D1, f(WI), nullptr, nullptr, f(GX), R, S, C0, 1, 9, 1, st);
}

}  // extern "C"
