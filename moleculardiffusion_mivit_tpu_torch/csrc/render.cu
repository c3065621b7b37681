// K1: noise-free frame renderer for NVIDIA Hopper (sm_90a), plain f32.
//
// Replaces moleculardiffusion_mivit_tpu/ops/pallas_render.py:
// pallas_render_frames (kernel body _make_kernel). It computes, for every
// frame b,
//
//   frame[b, i, j] = sum_p  w'_p * pool_u(g_y,p)[i] * pool_u(g_x,p)[j],
//   g_x,p[k] = exp(-(c_k - x_p)^2 / (2 sigma^2)),  c = linspace(-L, L, S*u),
//   w'_p = I_p / (max_k g_y,p[k] * max_k g_x,p[k])      (peak renormalisation)
//
// which is the math of the plain version render_frames_reference
// (ops/render.py).
//
// What bounds it on this card: at a main-path call (B = 1920 frames per
// diffusion class, 7680 a cycle; P = 10, S = 9, u = 5) B = 7680 frames read
// 3*B*P floats and write B*S*S floats (3.4 MB, ~1 us at 3.35 TB/s) and do
// 2*P*S*u exponentials plus 2*P*S*S multiply-adds per frame (~0.06 GFLOP,
// ~1 us at 67 TFLOP/s f32). Both bounds lie below the time of one launch, so
// neither the tensor cores (wgmma) nor bulk copies (TMA) have anything to
// win here: a call costs its launch and the instructions it issues. The
// design therefore is one launch with no tensor built around it, a short
// chain of dependent instructions in every thread (u exponentials, not
// S*u), enough blocks to fill the card at B = 1920, and as few instructions
// a frame as the arithmetic allows.
//
// Design. A *segment* is the S pooled cells of one (frame, sub-position p);
// it lives on S neighbouring lanes of one warp (min(S, 32) lanes when S is
// larger; a lane then takes up to three cells), and a warp holds 32 / S
// segments side by side (3 at S = 9, 2 at S = 13). A lane computes its cell
// of both axes: 2u exponentials in two independent chains of u, their u-wide
// means, and the running maximum of the Gaussians (the peak is the maximum
// over the grid of the same values the plain version maxes). ceil(log2 S)
// shuffle steps, each taking the value 1, 2, 4, 8 lanes on cyclically within
// the segment, leave both maxima in every lane; the lane then scales its
// pooled y cell by I_p / (peak_y * peak_x) and stores both cells to shared
// memory. After the
// block's only barrier a thread takes three output pixels of one column: a
// P-term dot product of three scaled y cells with one x cell. A block
// of 10 warps takes as many whole frames as its 10 * (32 / S) segments hold
// (3 frames at S = 9, 2 at S = 13, for P = 10): 640 or 960 blocks for
// B = 1920, the 640 resident at once (5 blocks of 320 threads an SM).
//
// Grid coordinates come from the index (grid_coord below), exactly the
// integers k - L when S*u is odd; no coordinate tensor is read. The
// kernel is bound by instruction issue, not by latency (counted in its
// SASS: about 830 warp instructions a frame, which at 58 frames an SM for
// B = 7680 is most of the time it is measured to take), so the arithmetic
// is kept short: a Gaussian is one MUFU.EX2 (ex2.approx.ftz) of
// d^2 * (-log2(e) / (2 sigma^2)), the factor taken once by the wrapper; the
// division by u is a multiplication by its reciprocal; the peak
// renormalisation is a reciprocal and a product (__fdividef, 2 ulp). S, u and P
// are compiled in for the package's shapes (S = 9 and 13 at u = 5, P = 10)
// and are run-time values in the generic instantiation that takes every
// other shape within the kernel's limits: S <= 96 (32 lanes of 3 cells),
// S*u <= 480, and 8 * frames_per_block * P * S bytes of shared memory at
// most 227 KB (the wide-field movies: S = 63 at u = 5, P = 60 or 100, a
// frame a block, 30,240 or 50,400 bytes). Above 48 KB the launch opts in to
// Hopper's larger dynamic shared memory. ops/render.py states the same
// limits and raises beyond them. The TPU kernel's bf16 hi/lo operand
// splitting, its one-hot assembly matrices and its closed-form peak exist
// for the TPU's matrix unit and VMEM, and are dropped.
//
// Settings. One launch may render several PSF settings (the PSF x noise
// grid: 5 sigmas over one stack of frames): the frames are K runs of
// frames_per_setting, run k rendered with factor k of a small table passed
// by value. A segment looks up its own frame's factor, so a block may
// straddle two runs. The one-sigma launch is a separate instantiation with
// the factor as a scalar, instruction for instruction the kernel above.
//
// The layout arithmetic (lanes per segment, segments per warp, frames per
// block, shared memory, grid step) is computed by the wrapper
// (ops/render.py: block_layout, shared_memory_bytes, grid_step);
// tests/test_torch_render.py holds it against a Python copy of the index
// arithmetic below (thread_cells, grid_coord_value there): change them
// together.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 10;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 5;  // 40 registers a thread: B = 1920 at S = 9 is one wave
constexpr int kRowsPerThread = 3;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSettings = 8;

// -log2(e) / (2 sigma_k^2) of each setting k, and the frames of a setting.
struct Settings {
  float factor[kMaxSettings];
  int frames_per_setting;
};

// Coordinate k of linspace(-L, L, G), L = (G - 1) / 2, step = 2L / (G - 1),
// as PyTorch's CUDA linspace computes it: from the start in the first half,
// from the end in the second, one fused multiply-add each. For odd G the
// step is 1 and the coordinates are the integers k - L.
__device__ __forceinline__ float grid_coord(int k, int G, int L, float step) {
  if (G & 1) return static_cast<float>(k - L);
  return k < G / 2
             ? __fmaf_rn(step, static_cast<float>(k), -static_cast<float>(L))
             : __fmaf_rn(-step, static_cast<float>(G - 1 - k), static_cast<float>(L));
}

// 2^x as one MUFU.EX2 (2 ulp); results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// kS, kU, kP > 0: compiled-in S, u, P. All 0: the run-time values.
// kTable: the factor of each frame comes from `settings`, else it is
// neg_log2e_inv_two_s2.
template <int kS, int kU, int kP, bool kTable>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) render_frames_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, float* __restrict__ out, int B, int P_rt,
    int S_rt, int U_rt, int frames_per_block, float neg_log2e_inv_two_s2,
    float step, Settings settings) {
  const int S = kS ? kS : S_rt;
  const int U = kU ? kU : U_rt;
  const int P = kP ? kP : P_rt;
  constexpr int kCellsPerLane = kS ? 1 : 3;  // S <= 32 compiled in, <= 96 else
  const int lanes_per_seg = S < 32 ? S : 32;
  const int segs_per_warp = 32 / lanes_per_seg;
  const int G = S * U;
  const int L = (G - 1) / 2;
  const float inv_u = 1.0f / static_cast<float>(U);

  extern __shared__ float smem[];
  float* px = smem;                             // [frames*P][S] pooled x
  float* py = smem + frames_per_block * P * S;  // [frames*P][S] pooled y, scaled

  const int f0 = blockIdx.x * frames_per_block;
  const int nf = min(frames_per_block, B - f0);
  const int nseg = nf * P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / lanes_per_seg;      // segment of this lane in its warp
  const int l = lane - sub * lanes_per_seg;  // lane's place in the segment

  // The trip count is the same for all lanes of a warp (the shuffles need
  // every lane); one trip when the block's segments fit its warps.
  for (int base = warp * segs_per_warp; base < nseg; base += kWarps * segs_per_warp) {
    const int seg = base + sub;  // local frame * P + p
    const bool active = sub < segs_per_warp && seg < nseg;
    float cx = 0.f, cy = 0.f, wv = 0.f;
    float factor = neg_log2e_inv_two_s2;
    if (active) {
      const size_t gi = static_cast<size_t>(f0) * P + seg;
      cx = x[gi];
      cy = y[gi];
      wv = w[gi];
      if constexpr (kTable) factor = settings.factor[(f0 + seg / P) / settings.frames_per_setting];
    }
    float mx = 0.f, my = 0.f;
    float pooled_y[kCellsPerLane];
#pragma unroll
    for (int r = 0; r < kCellsPerLane; ++r) {
      const int s = l + r * lanes_per_seg;
      pooled_y[r] = 0.f;
      if (active && s < S) {
        float ax = 0.f, ay = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float c = grid_coord(s * U + u, G, L, step);
          const float dx = c - cx;
          const float dy = c - cy;
          const float gx = exp2_approx((dx * dx) * factor);
          const float gy = exp2_approx((dy * dy) * factor);
          ax += gx;
          ay += gy;
          mx = fmaxf(mx, gx);
          my = fmaxf(my, gy);
        }
        px[seg * S + s] = ax * inv_u;
        pooled_y[r] = ay * inv_u;
      }
    }
    // Peaks: every lane gets the maximum over its segment. Each step takes
    // the value `off` lanes on, cyclically within the segment, so a lane has
    // seen a window of 2 * off lanes after it, and all of them at the end.
#pragma unroll
    for (int off = 1; off < lanes_per_seg; off <<= 1) {
      int src = l + off;
      if (src >= lanes_per_seg) src -= lanes_per_seg;
      src += sub * lanes_per_seg;
      mx = fmaxf(mx, __shfl_sync(kFullMask, mx, src));
      my = fmaxf(my, __shfl_sync(kFullMask, my, src));
    }
    if (active) {
      const float scale = __fdividef(wv, mx * my);
#pragma unroll
      for (int r = 0; r < kCellsPerLane; ++r) {
        const int s = l + r * lanes_per_seg;
        if (s < S) py[seg * S + s] = pooled_y[r] * scale;
      }
    }
  }
  __syncthreads();

  // Pixels: a thread takes column j of up to kRowsPerThread rows of one
  // frame (rows i, i + row_groups, i + 2 row_groups), so a p-step is one x
  // read and three y reads for three multiply-adds.
  const int row_groups = (S + kRowsPerThread - 1) / kRowsPerThread;
  const int per_frame = row_groups * S;
  for (int it = threadIdx.x; it < nf * per_frame; it += kThreads) {
    const int f = it / per_frame;
    const int rest = it - f * per_frame;
    const int i0 = rest / S;
    const int j = rest - i0 * S;
    const float* pyf = py + f * P * S + i0;
    const float* pxf = px + f * P * S + j;
    float acc[kRowsPerThread];
    int row[kRowsPerThread];  // offset of row r from i0; a row past S reads row S - 1, unstored
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      acc[r] = 0.f;
      row[r] = min(i0 + r * row_groups, S - 1) - i0;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float xv = pxf[p * S];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = fmaf(pyf[p * S + row[r]], xv, acc[r]);
    }
    float* dst = out + (static_cast<size_t>(f0) + f) * S * S + j;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = i0 + r * row_groups;
      if (i < S) dst[i * S] = acc[r];
    }
  }
}

__global__ void noop_kernel() {}

template <int kS, int kU, int kP, bool kTable>
int launch(const float* x, const float* y, const float* w, float* out, int B,
           int P, int S, int U, int frames_per_block, float neg_log2e_inv_two_s2,
           float step, const Settings& settings, cudaStream_t stream) {
  const int blocks = (B + frames_per_block - 1) / frames_per_block;
  const size_t smem = sizeof(float) * 2 * frames_per_block * P * S;
  auto kernel = render_frames_kernel<kS, kU, kP, kTable>;
  if (smem > 48 * 1024) {  // the opt-in; a launch without it is refused
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(x, y, w, out, B, P, S, U, frames_per_block,
                                             neg_log2e_inv_two_s2, step, settings);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTable>
int dispatch(const float* x, const float* y, const float* w, float* out, int B, int P, int S,
             int U, int frames_per_block, float neg_log2e_inv_two_s2, float step,
             const Settings& settings, cudaStream_t st) {
  if (U == 5 && P == 10 && S == 9)
    return launch<9, 5, 10, kTable>(x, y, w, out, B, P, S, U, frames_per_block,
                                    neg_log2e_inv_two_s2, step, settings, st);
  if (U == 5 && P == 10 && S == 13)
    return launch<13, 5, 10, kTable>(x, y, w, out, B, P, S, U, frames_per_block,
                                     neg_log2e_inv_two_s2, step, settings, st);
  return launch<0, 0, 0, kTable>(x, y, w, out, B, P, S, U, frames_per_block,
                                 neg_log2e_inv_two_s2, step, settings, st);
}

}  // namespace

extern "C" {

// x, y, w: (B, P) f32; out: (B, S, S) f32. All device pointers, contiguous.
// frames_per_block >= 1 with 8 * frames_per_block * P * S bytes of shared
// memory at most 227 KB; neg_log2e_inv_two_s2 = -log2(e) / (2 sigma^2); step = the grid
// spacing 2L / (S*U - 1) (unused when S*U is odd). S <= 96, S*U <= 480. Returns the
// launch's cudaGetLastError() code.
int render_frames(const float* x, const float* y, const float* w, float* out,
                  int B, int P, int S, int U, int frames_per_block,
                  float neg_log2e_inv_two_s2, float step, void* stream) {
  return dispatch<false>(x, y, w, out, B, P, S, U, frames_per_block, neg_log2e_inv_two_s2, step,
                         Settings{}, static_cast<cudaStream_t>(stream));
}

// The same with K PSF settings (1 <= K <= 8): frames [k F, (k + 1) F),
// F = frames_per_setting = B / K, use factors[k] (a host array of K floats).
int render_frames_settings(const float* x, const float* y, const float* w, float* out,
                           int B, int P, int S, int U, int frames_per_block,
                           const float* factors, int K, int frames_per_setting, float step,
                           void* stream) {
  if (K < 1 || K > kMaxSettings || frames_per_setting < 1 ||
      static_cast<long long>(K) * frames_per_setting != B)
    return static_cast<int>(cudaErrorInvalidValue);
  Settings settings{};
  for (int k = 0; k < K; ++k) settings.factor[k] = factors[k];
  settings.frames_per_setting = frames_per_setting;
  return dispatch<true>(x, y, w, out, B, P, S, U, frames_per_block, 0.f, step, settings,
                        static_cast<cudaStream_t>(stream));
}

// One launch of an empty kernel on the stream: the card's floor for any
// single-launch call, timed beside K1.
int launch_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
