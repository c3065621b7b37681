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
// (ops/render.py) in the same operation order.
//
// What bounds it on this card: at the main-path shape (B = 7680 frames,
// P = 10, S = 9, u = 5) a call reads 3*B*P floats and writes B*S*S floats
// (3.4 MB, ~1 us at 3.35 TB/s) and does ~2*P*S*u exponentials plus 2*P*S*S
// multiply-adds per frame (~0.06 GFLOP, ~1 us at 67 TFLOP/s f32). Both
// bounds are of the order of one launch, so the design keeps everything of
// a frame in shared memory, writes each output pixel once, and does no
// more than one exponential per (frame, sub-position, axis, grid point).
//
// Design: one block per tile of kFramesPerBlock frames. Phase 1 gives one
// (frame, p, axis) to each thread, which evaluates the S*u Gaussians, pools
// them by u into shared memory and keeps their running maximum (the peak,
// exactly as the plain version's max over the grid). Phase 2 scales each
// pooled y row by I_p / (peak_y * peak_x). Phase 3 gives one output pixel to
// each thread: a P-term dot product of a y row and an x row, written
// coalesced. The TPU kernel's bf16 hi/lo operand splitting, its one-hot
// assembly matrices and its closed-form peak exist for the TPU's matrix
// unit and VMEM, and are dropped.

#include <cuda_runtime.h>

namespace {

constexpr int kFramesPerBlock = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) render_frames_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, const float* __restrict__ coords,
    float* __restrict__ out, int B, int P, int S, int U, float two_s2) {
  extern __shared__ float smem[];
  const int G = S * U;
  float* c_s = smem;                             // [G] grid coordinates
  float* px = c_s + G;                           // [F][P][S] pooled x rows
  float* py = px + kFramesPerBlock * P * S;      // [F][P][S] pooled y rows
  float* peak = py + kFramesPerBlock * P * S;    // [F][P][2] peaks (x, y)

  const int f0 = blockIdx.x * kFramesPerBlock;
  const int nf = min(kFramesPerBlock, B - f0);
  for (int i = threadIdx.x; i < G; i += blockDim.x) c_s[i] = coords[i];
  __syncthreads();

  const float fu = static_cast<float>(U);
  for (int it = threadIdx.x; it < nf * P * 2; it += blockDim.x) {
    const int axis = it & 1;
    const int fp = it >> 1;  // local frame * P + p
    const float center = (axis == 0 ? x : y)[static_cast<size_t>(f0) * P + fp];
    float* dst = (axis == 0 ? px : py) + fp * S;
    float m = 0.f;
    for (int s = 0; s < S; ++s) {
      float acc = 0.f;
      for (int u = 0; u < U; ++u) {
        const float d = c_s[s * U + u] - center;
        const float g = expf(-(d * d) / two_s2);
        acc += g;
        m = fmaxf(m, g);
      }
      dst[s] = acc / fu;
    }
    peak[fp * 2 + axis] = m;
  }
  __syncthreads();

  for (int fp = threadIdx.x; fp < nf * P; fp += blockDim.x) {
    const float scale = w[static_cast<size_t>(f0) * P + fp] /
                        (peak[fp * 2] * peak[fp * 2 + 1]);
    for (int s = 0; s < S; ++s) py[fp * S + s] *= scale;
  }
  __syncthreads();

  const int SS = S * S;
  for (int it = threadIdx.x; it < nf * SS; it += blockDim.x) {
    const int f = it / SS;
    const int pix = it - f * SS;
    const int i = pix / S;
    const int j = pix - i * S;
    const float* pyf = py + f * P * S;
    const float* pxf = px + f * P * S;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc = fmaf(pyf[p * S + i], pxf[p * S + j], acc);
    out[static_cast<size_t>(f0) * SS + it] = acc;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes; the wrapper refuses shapes above
// the 48 KB a block gets without opting in.
int render_frames_smem_bytes(int P, int S, int U) {
  return static_cast<int>(sizeof(float)) *
         (S * U + 2 * kFramesPerBlock * P * S + 2 * kFramesPerBlock * P);
}

// x, y, w: (B, P) f32; coords: (S*U,) f32; out: (B, S, S) f32. All device
// pointers, contiguous. two_s2 = 2 * sigma * sigma. Returns the launch's
// cudaGetLastError() code.
int render_frames(const float* x, const float* y, const float* w,
                  const float* coords, float* out, int B, int P, int S, int U,
                  float two_s2, void* stream) {
  const int blocks = (B + kFramesPerBlock - 1) / kFramesPerBlock;
  render_frames_kernel<<<blocks, kThreads, render_frames_smem_bytes(P, S, U),
                         static_cast<cudaStream_t>(stream)>>>(
      x, y, w, coords, out, B, P, S, U, two_s2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
