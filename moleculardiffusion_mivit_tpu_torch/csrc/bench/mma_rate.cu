// Microbenchmark: the rate and latency of the tensor-core instruction the
// embedding kernels use (mma.sync m16n8k8 TF32, also m16n8k4 and bf16 for
// scale), with 1..8 independent accumulator chains a warp and 4..32 warps
// an SM. It is the ceiling any mma.sync kernel on this card can reach, below
// the data-sheet rate that only wgmma attains. Not part of the library
// (ops/_build.py builds only csrc/*.cu). Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate mma_rate.cu && ./mma_rate
//
// The cycles column assumes 1.755 GHz; the TFLOP/s column is measured time.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma4(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) : "r"(a[0]), "r"(a[1]), "r"(b0));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CH, int KIND>
__global__ void k(float* out, int iters) {
  float d[CH][4] = {};
  uint32_t a[4] = {threadIdx.x, 2, 3, 4}; uint32_t a2[2] = {threadIdx.x, 5};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (KIND == 0) mma(d[c], a, 1u, 2u);
      if (KIND == 1) mma4(d[c], a2, 1u);
      if (KIND == 2) mma_bf16(d[c], a, 1u, 2u);
    }
  }
  float s = 0; for (int c = 0; c < CH; ++c) for (int e = 0; e < 4; ++e) s += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int CH, int KIND>
void run(int threads, int blocks_per_sm, float* out, const char* name) {
  const int iters = 4096;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  k<CH, KIND><<<132 * blocks_per_sm, threads>>>(out, iters);
  cudaEventRecord(e0);
  k<CH, KIND><<<132 * blocks_per_sm, threads>>>(out, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  const double n = 132.0 * blocks_per_sm * (threads / 32) * iters * CH;  // mma count
  const double flop = KIND == 0 ? 2048 : KIND == 1 ? 1024 : 4096;
  printf("%s chains=%d warps/SM=%d: %.3f ms, %.1f TFLOP/s, %.2f clk/mma/subpartition at 1.755 GHz\n", name, CH,
         blocks_per_sm * threads / 32, ms, n * flop / ms / 1e9, ms * 1e-3 * 1.755e9 / (n / 132 / 4));
}
int main() {
  float* out; cudaMalloc(&out, 132 * 8 * 1024 * 4);
  run<8, 0>(128, 1, out, "tf32 k8"); run<8, 0>(256, 1, out, "tf32 k8"); run<8, 0>(512, 1, out, "tf32 k8"); run<8, 0>(256, 4, out, "tf32 k8");
  run<4, 0>(512, 1, out, "tf32 k8"); run<2, 0>(512, 1, out, "tf32 k8"); run<1, 0>(128, 1, out, "tf32 k8"); run<1, 0>(512, 1, out, "tf32 k8");
  run<8, 1>(512, 1, out, "tf32 k4"); run<8, 2>(512, 1, out, "bf16 k16"); run<8, 2>(256, 4, out, "bf16 k16");
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
}
