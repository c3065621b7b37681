// Implicit-GEMM 3x3 SAME (or 1x1) convolution, its data gradient and its
// weight gradient on the TF32 tensor cores with f32-grade accuracy
// (3xTF32, see tf32_mma.cuh), over activations in the channels-last row
// layout (R, C), R = images * S * S.
//
// The slab. For output rows [row0, row0 + BM) every one of the 9 taps reads
// the input at a constant row offset dy*S + dx, so all taps read one
// contiguous slab of input rows [row0 - S - 1, row0 + BM + S + 1). The slab
// is brought to shared memory once per block and channel chunk with 16-byte
// cp.async (zero-filled outside [0, R)) and each tap reads it at its offset.
// A slab row that belongs to a neighbouring image, or to the other end of an
// image row, is by construction an out-of-image tap of the output pixel: a
// per-pixel table of 9 validity bits (built by the caller, S*S entries)
// zeroes it when the fragment is read. No index arithmetic per element.
//
// Members. Both kernels take a stack of M independent problems of the same
// shape (the member axis of a model grid): member m reads and writes its
// own arrays at m times the array's member stride (in elements, 64-bit) and
// runs exactly the blocks, tiles and fixed-order sums a call for that
// member alone would run, so its result is bitwise the one-member result.
//
// Operand type. Both kernels are templates over the type T of the
// activations they read (and of the packed weights): f32 runs the 3xTF32
// products, bf16 one mma.sync m16n8k16 bf16 product per f32 product (the
// JAX kernel's arithmetic off its exact mode). The bf16 instantiation runs
// the same tiles, slabs, validity table, pipeline and epilogue; only the
// slab's element, the weight tile's layout and the inner product differ.
#pragma once

#include <algorithm>
#include <type_traits>

#include "tf32_mma.cuh"

namespace conv {

constexpr int kSMs = 132;

inline int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Member m's part of a stacked array; a null array stays null.
template <typename T>
__device__ __forceinline__ T* member_ptr(T* p, long long stride, int m) {
  return p ? p + m * stride : p;
}

constexpr int kMaxGridYZ = 65535;

// Dynamic shared memory above 48 KB has to be allowed per kernel and device.
// A launcher keeps one SmemGrant per kernel: the device it last asked for and
// the largest size allowed there, so the runtime is asked when either grows
// or changes and not before every launch.
struct SmemGrant {
  int device = -1, bytes = 0;
};

template <typename Kernel>
inline cudaError_t grant_smem(Kernel kernel, int bytes, SmemGrant& granted) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device == granted.device && bytes <= granted.bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted = {device, bytes};
  return e;
}

// ------------------------------------------------------------------ forward
// and data gradient:  y[r, c] = mask(add[r, c] + sum_{tap, k} x[r + off(tap), k] * w[tap][k][c])

constexpr int KC = 32;            // input channels per pipeline stage
constexpr int A_STRIDE = KC + 8;  // slab row stride in elements: A-fragment reads hit 32 banks
constexpr int kStages = 3;        // ring of weight tiles in flight

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, tc::bf16>::value;

// 32-bit words of one stage's weight tile, KC x BN: f32 holds a big and a
// small TF32 part of every weight, bf16 one bf16 half-word.
template <typename T, int BN>
__host__ __device__ constexpr int w_tile_words() {
  return kIsBf16<T> ? KC * BN / 2 : 2 * KC * BN;
}

// Two adjacent T of a row, as f32.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const tc::bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Block tile BM x BN = (WM * MT * 16) x (WN * NT * 8): WM x WN warps, each
// MT x NT tiles of 16 x 8. `wp` holds the weight pre-split by
// pack_weights_kernel, for every tap and block of 8 input channels the big
// part then the small part, each as 8 x 4 core matrices (wgmma_b_desc in
// tf32_mma.cuh). Within a block of 8 channels the products' k index is
// permuted (k < 4 reads channel 2 k, k >= 4 reads channel 2 (k - 4) + 1), on
// both operands alike, so a thread's two A values of a row are adjacent and
// come with one 8-byte read. One pipeline stage is one (channel chunk, tap):
// a KC x BN weight tile; the stage of tap 0 also brings the chunk's slab.
// With WG (MT = 1, WN = 1, 4 or 8 warps) each group of four warps multiplies
// its 64 rows by the whole tile with wgmma, which reads the weights from
// shared memory itself; otherwise each warp runs mma.sync on fragments it
// reads itself (the small tiles that cover the card at few rows). With
// `stat_partial` the block also writes, per output channel, the mean and the
// centred sum of squares of its rows (for the BatchNorm statistics). Two
// blocks fit an SM (registers capped at 128, ~96 KB of shared memory each).
// bf16 (T): the slab holds bf16 and the weights come packed by
// pack_weights_bf16_kernel, per tap, block of 16 input channels and block of
// 8 output columns 64 words laid out as the 32 lanes read their mma_bf16 B
// registers (two words a lane); a step of depth 16 is one mma_bf16 per
// 16 x 8 tile, its A registers two adjacent channels a read. The outputs,
// `add` and the statistics stay f32; `mask` is of type T.
template <typename T, int MT, int NT, int WM, int WN, bool WG>
__global__ void __launch_bounds__(WM * WN * 32, 2) conv_rows_tc_kernel(
    const T* __restrict__ x, const float* __restrict__ wp, const float* add,
    const T* __restrict__ mask, float* y, double* __restrict__ stat_partial,
    const int* __restrict__ valid, int R, int S, int Ci, int Co, int taps, long long x_ms,
    long long wp_ms, long long add_ms, long long mask_ms, long long y_ms, long long stat_ms) {
  static_assert(!WG || (MT == 1 && WN == 1 && WM % 4 == 0), "a warpgroup owns 64 rows");
  static_assert(!WG || !kIsBf16<T>, "the bf16 kernels run mma.sync");
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int kThreads = WM * WN * 32;
  // f32: [KC / 8][big, small][BN / 8] core-matrix pairs of 64; bf16: [KC / 16][BN / 8][64]
  constexpr int W_TILE = w_tile_words<T, BN>();
  constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) float smem[];
  const int halo = taps == 9 ? S + 1 : 0;
  const int slab_rows = BM + 2 * halo;
  const int slab_floats = slab_rows * A_STRIDE;  // elements of T
  // a 1x1 conv has one stage per chunk, so its slabs turn over as fast as
  // the weight tiles and need as many buffers
  const int n_slabs = taps == 9 ? 2 : kStages;
  float* w_s = smem;                                       // [kStages][W_TILE]
  T* a_s = reinterpret_cast<T*>(smem + kStages * W_TILE);  // [n_slabs][slab_rows][A_STRIDE]

  const int member = blockIdx.z;
  x = member_ptr(x, x_ms, member);
  wp = member_ptr(wp, wp_ms, member);
  add = member_ptr(add, add_ms, member);
  mask = member_ptr(mask, mask_ms, member);
  y = member_ptr(y, y_ms, member);
  stat_partial = member_ptr(stat_partial, stat_ms, member);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int n_stages = (Ci / KC) * taps;

  int vm[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + (wm * MT + i) * 16 + gid + h * 8;
      vm[i][h] = r < R ? (taps == 9 ? valid[r % (S * S)] : 1) : 0;
    }

  // f32: each thread copies the same NW 16-byte pieces of every weight
  // tile: the tile is KC / 8 * 2 runs of BN * 8 contiguous floats, one per
  // block of 8 channels and part
  constexpr int RUN = BN * 2, NW = kIsBf16<T> ? 1 : (KC / 4) * RUN / kThreads;  // RUN in 16-byte pieces
  static_assert(kIsBf16<T> || NW * kThreads == (KC / 4) * RUN, "the weight tile divides among the threads");
  int w_src[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int i = tid + j * kThreads;
    w_src[j] = (i / RUN) * (Co / 8) * 64 + col0 * 8 + (i % RUN) * 4;
  }

  auto load_stage = [&](int chunk, int tap, int slot, int slab) {
    if (tap == 0) {
      T* dst = a_s + slab * slab_floats;
      const int first = row0 - halo;
      for (int i = tid; i < slab_rows * (KC / VE); i += kThreads) {
        const int row = i / (KC / VE), q = i % (KC / VE);
        const int gr = first + row;
        const bool ok = gr >= 0 && gr < R;
        const T* src = x + (static_cast<size_t>(ok ? gr : 0) * Ci + chunk * KC + q * VE);
        tc::cp_async16(dst + row * A_STRIDE + q * VE, src, ok);
      }
    }
    if constexpr (kIsBf16<T>) {
      // KC / 16 runs of BN * 8 words, one per block of 16 channels
      constexpr int PIECES = (KC / 16) * BN * 2;  // 16-byte pieces of the tile
      const float* src =
          wp + (static_cast<size_t>(tap * (Ci / 16) + chunk * (KC / 16)) * (Co / 8) + col0 / 8) * 64;
      float* dst = w_s + slot * W_TILE;
      for (int i = tid; i < PIECES; i += kThreads) {
        const int kb = i / (BN * 2), q = i % (BN * 2);
        tc::cp_async16(dst + kb * BN * 8 + q * 4, src + static_cast<size_t>(kb) * (Co / 8) * 64 + q * 4,
                       true);
      }
    } else {
      const float* src = wp + static_cast<size_t>(tap * Ci + chunk * KC) * Co * 2;
      float* dst = w_s + slot * W_TILE + tid * 4;
#pragma unroll
      for (int j = 0; j < NW; ++j) tc::cp_async16(dst + j * kThreads * 4, src + w_src[j], true);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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

  int c_tap = 0, c_slot = 0, c_slab = 0;
  for (int it = 0; it < n_stages; ++it) {
    tc::cp_async_wait<kStages - 2>();  // stage `it` has landed
    __syncthreads();                   // and every warp is done with stage it - 1
    load_next();                       // refills the slot of stage it - 1

    const int off = taps == 9 ? (c_tap / 3 - 1) * S + (c_tap % 3 - 1) : 0;
    const T* As =
        a_s + c_slab * slab_floats + (halo + off + wm * MT * 16 + gid) * A_STRIDE + 2 * tig;
    const float* Ws = w_s + c_slot * W_TILE;
    bool v[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      v[i][0] = (vm[i][0] >> c_tap) & 1;
      v[i][1] = (vm[i][1] >> c_tap) & 1;
    }
    if constexpr (kIsBf16<T>) {
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const T* p = As + i * 16 * A_STRIDE + kk * 16;
          const uint32_t* lo = reinterpret_cast<const uint32_t*>(p);
          const uint32_t* hi = reinterpret_cast<const uint32_t*>(p + 8 * A_STRIDE);
          a[i][0] = v[i][0] ? lo[0] : 0u;
          a[i][1] = v[i][1] ? hi[0] : 0u;
          a[i][2] = v[i][0] ? lo[4] : 0u;  // channels 2 tig + 8, + 9
          a[i][3] = v[i][1] ? hi[4] : 0u;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 b = reinterpret_cast<const uint2*>(Ws + (kk * (BN / 8) + wn * NT + j) * 64)[lane];
#pragma unroll
          for (int i = 0; i < MT; ++i) tc::mma_bf16(acc[i][j], a[i], b.x, b.y);
        }
      }
    } else if constexpr (WG) {
      // Each step's three products are chained on the tensor core from zero
      // and join the running sum by f32 adds (tf32_mma.cuh). While the tensor
      // core works on a step the warps fetch and split the next step's A
      // fragments into the other register set; it reads its own set until
      // the wait.
      constexpr int NK = KC / 8;
      uint32_t a_big[2][4], a_small[2][4];
      float t[NT][4];
      auto fetch_a = [&](int kk) {
        const float* p = As + kk * 8;
        const float2 zero = make_float2(0.f, 0.f);
        const float2 lo = v[0][0] ? *reinterpret_cast<const float2*>(p) : zero;
        const float2 hi = v[0][1] ? *reinterpret_cast<const float2*>(p + 8 * A_STRIDE) : zero;
        tc::split_tf32(lo.x, a_big[kk % 2][0], a_small[kk % 2][0]);
        tc::split_tf32(hi.x, a_big[kk % 2][1], a_small[kk % 2][1]);
        tc::split_tf32(lo.y, a_big[kk % 2][2], a_small[kk % 2][2]);
        tc::split_tf32(hi.y, a_big[kk % 2][3], a_small[kk % 2][3]);
      };
      fetch_a(0);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const float* w_big = Ws + kk * 2 * BN * 8;  // this step's big part, then its small part
        const uint64_t d_big = tc::wgmma_b_desc(w_big), d_small = tc::wgmma_b_desc(w_big + BN * 8);
        tc::wgmma_fence();
        tc::wgmma_tf32<NT>(t, a_small[kk % 2], d_big, 0);  // small terms first; overwrites t
        tc::wgmma_tf32<NT>(t, a_big[kk % 2], d_small, 1);
        tc::wgmma_tf32<NT>(t, a_big[kk % 2], d_big, 1);
        tc::wgmma_commit();
        if (kk + 1 < NK) fetch_a(kk + 1);
        tc::wgmma_wait<NT>(t, a_big[kk % 2], a_small[kk % 2]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][j][e] += t[j][e];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        uint32_t a_big[MT][4], a_small[MT][4], b_big[NT][2], b_small[NT][2];
        float t[MT][NT][4];  // this step's products, chained from zero (tf32_mma.cuh)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* p = As + i * 16 * A_STRIDE + kk * 8;
          const float2 zero = make_float2(0.f, 0.f);
          const float2 lo = v[i][0] ? *reinterpret_cast<const float2*>(p) : zero;
          const float2 hi = v[i][1] ? *reinterpret_cast<const float2*>(p + 8 * A_STRIDE) : zero;
          tc::split_tf32(lo.x, a_big[i][0], a_small[i][0]);
          tc::split_tf32(hi.x, a_big[i][1], a_small[i][1]);
          tc::split_tf32(lo.y, a_big[i][2], a_small[i][2]);
          tc::split_tf32(hi.y, a_big[i][3], a_small[i][3]);
        }
        const float* w_big = Ws + kk * 2 * BN * 8;  // this step's big part, then its small part
        const float* w_small = w_big + BN * 8;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = (wn * NT + j) * 64 + gid * 4 + tig;  // k = tig; k = tig + 4 is 32 on
          b_big[j][0] = __float_as_uint(w_big[o]);
          b_big[j][1] = __float_as_uint(w_big[o + 32]);
          b_small[j][0] = __float_as_uint(w_small[o]);
          b_small[j][1] = __float_as_uint(w_small[o + 32]);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[i][j][e] = 0.f;
        }
        // small terms first; each term for all tiles before the next
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) tc::mma_tf32(t[i][j], a_small[i], b_big[j][0], b_big[j][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) tc::mma_tf32(t[i][j], a_big[i], b_small[j][0], b_small[j][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) tc::mma_tf32(t[i][j], a_big[i], b_big[j][0], b_big[j][1]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];
      }
    }
    c_slot = c_slot + 1 == kStages ? 0 : c_slot + 1;
    if (++c_tap == taps) {
      c_tap = 0;
      c_slab = c_slab + 1 == n_slabs ? 0 : c_slab + 1;
    }
  }

  bool in[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) in[i][h] = row0 + (wm * MT + i) * 16 + gid + h * 8 < R;

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!in[i][h]) continue;
        const int r = row0 + (wm * MT + i) * 16 + gid + h * 8;
        const size_t o = static_cast<size_t>(r) * Co + col0 + (wn * NT + j) * 8 + 2 * tig;
        float2 out = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        if (add) {
          const float2 t = *reinterpret_cast<const float2*>(add + o);
          out.x += t.x;
          out.y += t.y;
        }
        if (mask) {
          const float2 m = load2(mask + o);
          if (!(m.x > 0.f)) out.x = 0.f;
          if (!(m.y > 0.f)) out.y = 0.f;
        }
        *reinterpret_cast<float2*>(y + o) = out;
      }

  if (stat_partial == nullptr) return;
  // Per-channel mean and centred sum of squares of this tile's rows, from
  // the accumulators: sum, then squares about the tile's own mean, each
  // reduced over the 8 row lanes by shuffles and over the WM warps through
  // shared memory in a fixed order.
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = smem;              // [WM][BN]
  float* mean_s = smem + WM * BN;  // [BN]
  const float cnt = static_cast<float>(min(BM, R - row0));
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = (wn * NT + j) * 8 + 2 * tig + e;
        const float m = pass == 0 ? 0.f : mean_s[c];
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d = acc[i][j][2 * h + e] - m;
            if (in[i][h]) s += pass == 0 ? d : d * d;
          }
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (gid == 0) red[wm * BN + c] = s;
      }
    __syncthreads();
    if (tid < BN) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WM; ++w) t += red[w * BN + tid];
      if (pass == 0) {
        mean_s[tid] = t / cnt;
      } else {
        const size_t o = static_cast<size_t>(blockIdx.x) * 2 * Co + col0 + tid;
        stat_partial[o] = static_cast<double>(mean_s[tid]);
        stat_partial[o + Co] = static_cast<double>(t);
      }
    }
    __syncthreads();
  }
}

// Member strides of a conv's arrays, in elements (unused with one member).
struct ConvStrides {
  long long x, wp, add, mask, y, stat;
};

template <typename T, int MT, int NT, int WM, int WN, bool WG>
int launch_conv_tile(const T* x, const float* wp, const float* add, const T* mask,
                     float* y, double* stat_partial, const int* valid, int R, int S, int Ci,
                     int Co, int taps, int M, const ConvStrides& ms, cudaStream_t st) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int kThreads = WM * WN * 32;
  static_assert(BN <= kThreads, "the statistics epilogue gives one column to a thread");
  const int halo = taps == 9 ? S + 1 : 0;
  const int n_slabs = taps == 9 ? 2 : kStages;
  const int bytes = 4 * kStages * w_tile_words<T, BN>() +
                    static_cast<int>(sizeof(T)) * n_slabs * (BM + 2 * halo) * A_STRIDE;
  auto kernel = conv_rows_tc_kernel<T, MT, NT, WM, WN, WG>;
  static SmemGrant granted;
  const cudaError_t e = grant_smem(kernel, bytes, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ceil_div(R, BM), Co / BN, M);
  kernel<<<grid, kThreads, bytes, st>>>(x, wp, add, mask, y, stat_partial, valid, R, S, Ci, Co,
                                        taps, ms.x, ms.wp, ms.add, ms.mask, ms.y, ms.stat);
  return static_cast<int>(cudaGetLastError());
}

// The tile is chosen from (R, Co) so that the grid covers the card: 128 rows
// (two warpgroups of wgmma, the fastest: each weight tile is reused over the
// most rows) where that still gives two blocks per SM, else 64 rows (one
// warpgroup), else 32 rows with mma.sync, and then 32 columns instead of 64
// if that is what it takes to give every SM two blocks.
// Returns the rows per tile through `bm` (the BatchNorm merge needs it).
// With M members the tile is the one a member alone gets (R is a member's
// rows), and the grid repeats it M times. bf16 takes the same tiles, each
// warp on mma.sync (wgmma here is for the TF32 products).
template <typename T>
int launch_conv(const T* x, const float* wp, const float* add, const T* mask,
                float* y, double* stat_partial, const int* valid, int R, int S, int Ci,
                int Co, int taps, int M, const ConvStrides& ms, int* bm, cudaStream_t st) {
  if (Ci % KC != 0 || Co % 32 != 0 || (taps != 1 && taps != 9) || M < 1 || M > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool WG = !kIsBf16<T>;
  int bn = Co % 64 == 0 ? 64 : 32;
  const int nb = Co / bn;
  if (ceil_div(R, 128) * nb >= 2 * kSMs) {
    *bm = 128;
  } else if (ceil_div(R, 64) * nb >= 2 * kSMs) {
    *bm = 64;
  } else {
    *bm = 32;
    if (ceil_div(R, 32) * nb < 2 * kSMs) bn = 32;
  }
#define CONV_TILE(MT, NT, WM, WN, WG_) \
  return launch_conv_tile<T, MT, NT, WM, WN, WG_>(x, wp, add, mask, y, stat_partial, valid, R, S, Ci, Co, taps, M, ms, st)
  if (bn == 64) {
    if (*bm == 128) CONV_TILE(1, 8, 8, 1, WG);
    if (*bm == 64) CONV_TILE(1, 8, 4, 1, WG);
    CONV_TILE(1, 4, 2, 2, false);
  }
  if (*bm == 128) CONV_TILE(1, 4, 8, 1, WG);
  if (*bm == 64) CONV_TILE(1, 4, 4, 1, WG);
  CONV_TILE(1, 2, 2, 2, false);
#undef CONV_TILE
}

// ---------------------------------------------------------- weight gradient
// partial[chunk][tap][ci][co] = sum over the chunk's rows r of
//   x[r + off(tap), ci] * g[r, co]
// as the product g^T (M = co) times the tap-shifted slab (N = ci), reduced
// over rows (K). Both operands are activations, so both are split when the
// fragments are read: the g fragment once per 8 rows for all 9 taps. bf16
// (T): one mma_bf16 per 16 rows; its registers pair two rows of one column,
// which lie a row apart in the slabs, so each is built from two 2-byte
// reads (the f32 path reads its single values the same way).

constexpr int kWgThreads = 256;  // 8 warps: 2 over co (32 each) x 4 over ci (8 each)
constexpr int RB = 64;           // rows per pipeline stage
constexpr int CIB = 32, COB = 64;
constexpr int X_STRIDE = CIB + 8, G_STRIDE = COB + 8;  // fragment reads hit 32 banks
constexpr int kWgStages = 2;
constexpr int kWgTargetBlocks = 2 * kSMs;

// Bytes of one stage: the x slab and the g rows (elements of T; each a
// multiple of 16 bytes), then the rows' validity words.
template <typename T>
__host__ __device__ inline int wgrad_stage_bytes(int S, int taps) {
  const int halo = taps == 9 ? S + 1 : 0;
  return static_cast<int>(sizeof(T)) * ((RB + 2 * halo) * X_STRIDE + RB * G_STRIDE) + 4 * RB;
}

template <typename T, int TAPS>
__global__ void __launch_bounds__(kWgThreads) wgrad_rows_tc_kernel(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial,
    const int* __restrict__ valid, int R, int S, int Ci, int Co, int rows_per_chunk, int chunks,
    long long x_ms, long long g_ms, long long partial_ms) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte copy
  const int member = blockIdx.z / chunks;
  x = member_ptr(x, x_ms, member);
  g = member_ptr(g, g_ms, member);
  partial = member_ptr(partial, partial_ms, member);
  const int halo = TAPS == 9 ? S + 1 : 0;
  const int slab_rows = RB + 2 * halo;
  const int stage_bytes = wgrad_stage_bytes<T>(S, TAPS);
  auto stage = [&](int buf) { return reinterpret_cast<T*>(reinterpret_cast<char*>(smem) + buf * stage_bytes); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wco = warp >> 2, wci = warp & 3;
  const int ci0 = blockIdx.x * CIB, co0 = blockIdx.y * COB, chunk = blockIdx.z % chunks;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(R, r_begin + rows_per_chunk);
  const int steps = (r_end - r_begin + RB - 1) / RB;
  const int SS = S * S;
  constexpr int TG = TAPS == 9 ? 3 : 1;  // taps whose products are in flight together

  auto load_step = [&](int step, int buf) {
    T* x_s = stage(buf);
    T* g_s = x_s + slab_rows * X_STRIDE;
    int* m_s = reinterpret_cast<int*>(g_s + RB * G_STRIDE);
    const int rb = r_begin + step * RB;
    for (int i = tid; i < slab_rows * (CIB / VE); i += kWgThreads) {
      const int row = i / (CIB / VE), q = i % (CIB / VE);
      const int gr = rb - halo + row;
      const bool ok = gr >= 0 && gr < R;
      tc::cp_async16(x_s + row * X_STRIDE + q * VE,
                     x + (static_cast<size_t>(ok ? gr : 0) * Ci + ci0 + q * VE), ok);
    }
    for (int i = tid; i < RB * (COB / VE); i += kWgThreads) {
      const int row = i / (COB / VE), q = i % (COB / VE);
      const int gr = rb + row;
      const bool ok = gr < r_end;
      tc::cp_async16(g_s + row * G_STRIDE + q * VE,
                     g + (static_cast<size_t>(ok ? gr : 0) * Co + co0 + q * VE), ok);
    }
    if (tid < RB) {
      const int r = rb + tid;
      m_s[tid] = r < r_end ? (TAPS == 9 ? valid[r % SS] : 1) : 0;
    }
  };

  float acc[TAPS][2][4];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] = 0.f;

  load_step(0, 0);
  tc::cp_async_commit();
  for (int it = 0; it < steps; ++it) {
    tc::cp_async_wait<0>();  // step `it` has landed
    __syncthreads();         // and every warp is done with step it - 1
    if (it + 1 < steps) load_step(it + 1, (it + 1) & 1);
    tc::cp_async_commit();

    const T* x_s = stage(it & 1);
    const T* g_s = x_s + slab_rows * X_STRIDE;
    const int* m_s = reinterpret_cast<const int*>(g_s + RB * G_STRIDE);
    if constexpr (kIsBf16<T>) {
#pragma unroll 1
      for (int rl = 0; rl < RB; rl += 16) {
        // A = g^T: rows 2 tig (+1) and 2 tig + 8 (+9) of columns gid and gid + 8
        uint32_t ga[2][4];
        const T* gp = g_s + (rl + 2 * tig) * G_STRIDE + wco * 32 + gid;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const T* e = gp + (q >> 1) * 8 * G_STRIDE + i * 16 + (q & 1) * 8;
            ga[i][q] = tc::pack_bf16(e[0], e[G_STRIDE]);
          }
        int mrow[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) mrow[q] = m_s[rl + 2 * tig + (q >> 1) * 8 + (q & 1)];
        const T* xp = x_s + (halo + rl + 2 * tig) * X_STRIDE + wci * 8 + gid;
        const T zero = tc::from_f32<T>(0.f);
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          const int off = TAPS == 9 ? (t / 3 - 1) * S + (t % 3 - 1) : 0;
          T b[4];  // B = the tap-shifted slab: rows 2 tig, + 1, + 8, + 9 of column gid
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int dr = (q >> 1) * 8 + (q & 1);
            b[q] = (mrow[q] >> t) & 1 ? xp[(off + dr) * X_STRIDE] : zero;
          }
          const uint32_t b0 = tc::pack_bf16(b[0], b[1]), b1 = tc::pack_bf16(b[2], b[3]);
#pragma unroll
          for (int i = 0; i < 2; ++i) tc::mma_bf16(acc[t][i], ga[i], b0, b1);
        }
      }
    } else {
#pragma unroll 1
      for (int rl = 0; rl < RB; rl += 8) {
        uint32_t g_big[2][4], g_small[2][4];
        const float* gp = g_s + (rl + tig) * G_STRIDE + wco * 32 + gid;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tc::split_tf32(gp[i * 16], g_big[i][0], g_small[i][0]);
          tc::split_tf32(gp[i * 16 + 8], g_big[i][1], g_small[i][1]);
          tc::split_tf32(gp[4 * G_STRIDE + i * 16], g_big[i][2], g_small[i][2]);
          tc::split_tf32(gp[4 * G_STRIDE + i * 16 + 8], g_big[i][3], g_small[i][3]);
        }
        const int m0 = m_s[rl + tig], m1 = m_s[rl + tig + 4];
        const float* xp = x_s + (halo + rl + tig) * X_STRIDE + wci * 8 + gid;
#pragma unroll
        for (int t0 = 0; t0 < TAPS; t0 += TG) {
          uint32_t b_big[TG][2], b_small[TG][2];
          float tmp[TG][2][4];
#pragma unroll
          for (int u = 0; u < TG; ++u) {
            const int t = t0 + u;
            const int off = TAPS == 9 ? (t / 3 - 1) * S + (t % 3 - 1) : 0;
            const float b0 = (m0 >> t) & 1 ? xp[off * X_STRIDE] : 0.f;
            const float b1 = (m1 >> t) & 1 ? xp[(off + 4) * X_STRIDE] : 0.f;
            tc::split_tf32(b0, b_big[u][0], b_small[u][0]);
            tc::split_tf32(b1, b_big[u][1], b_small[u][1]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) tmp[u][i][e] = 0.f;
          }
          // small terms first; each term for the whole group before the next
#pragma unroll
          for (int u = 0; u < TG; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) tc::mma_tf32(tmp[u][i], g_small[i], b_big[u][0], b_big[u][1]);
#pragma unroll
          for (int u = 0; u < TG; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) tc::mma_tf32(tmp[u][i], g_big[i], b_small[u][0], b_small[u][1]);
#pragma unroll
          for (int u = 0; u < TG; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) tc::mma_tf32(tmp[u][i], g_big[i], b_big[u][0], b_big[u][1]);
#pragma unroll
          for (int u = 0; u < TG; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[t0 + u][i][e] += tmp[u][i][e];
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    float* base = partial + (static_cast<size_t>(chunk) * TAPS + t) * Ci * Co;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int co = co0 + wco * 32 + i * 16 + gid;
      const int ci = ci0 + wci * 8 + 2 * tig;
      base[static_cast<size_t>(ci) * Co + co] = acc[t][i][0];
      base[static_cast<size_t>(ci + 1) * Co + co] = acc[t][i][1];
      base[static_cast<size_t>(ci) * Co + co + 8] = acc[t][i][2];
      base[static_cast<size_t>(ci + 1) * Co + co + 8] = acc[t][i][3];
    }
  }
}

// Row chunks of the weight gradient: enough that tiles * chunks covers the
// card twice, in whole stages of RB rows.
inline void wgrad_chunks(int R, int Ci, int Co, int* chunks, int* rows_per_chunk) {
  const int tiles = (Ci / CIB) * (Co / COB);
  const int want = std::max(1, std::min(ceil_div(R, RB), ceil_div(kWgTargetBlocks, tiles)));
  *rows_per_chunk = ceil_div(ceil_div(R, want), RB) * RB;
  *chunks = ceil_div(R, *rows_per_chunk);
}

// With M members (R a member's rows) each member gets the chunks a member
// alone gets; the grid's z runs over (member, chunk).
template <typename T, int TAPS>
int launch_wgrad(const T* x, const T* g, float* partial, const int* valid, int R, int S,
                 int Ci, int Co, int M, long long x_ms, long long g_ms, long long partial_ms,
                 int* chunks, cudaStream_t st) {
  if (Ci % CIB != 0 || Co % COB != 0 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rows_per_chunk;
  wgrad_chunks(R, Ci, Co, chunks, &rows_per_chunk);
  if (static_cast<long long>(*chunks) * M > kMaxGridYZ) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = kWgStages * wgrad_stage_bytes<T>(S, TAPS);
  auto kernel = wgrad_rows_tc_kernel<T, TAPS>;
  static SmemGrant granted;
  const cudaError_t e = grant_smem(kernel, bytes, granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Ci / CIB, Co / COB, *chunks * M);
  kernel<<<grid, kWgThreads, bytes, st>>>(x, g, partial, valid, R, S, Ci, Co, rows_per_chunk,
                                          *chunks, x_ms, g_ms, partial_ms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv
