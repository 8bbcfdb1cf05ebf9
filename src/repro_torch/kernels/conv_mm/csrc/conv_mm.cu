// Matrix-multiplication 2-D convolution for Hopper (sm_90a): a plain
// implicit GEMM.
//
// Replaces the Pallas TPU kernel `conv_mm_kernel` (`_conv_body`) in
// src/repro/kernels/conv_mm/kernel.py.
//
// What it computes: y = conv(x, w) with x (N, H, W, C) NHWC, w (KH, KW, C, O)
// HWIO and y (N, OH, OW, O) NHWC, any stride, symmetric zero padding,
// groups = 1.  Inputs are f32 or bf16 (one type for both), the sum is kept
// in f32 and y is written in x's type.  It is the paper's index-im2col
// variant: the im2col matrix is never written to device memory.
//
// Layout: a GEMM with M = N*OH*OW output pixels, N_gemm = O output
// channels and depth K = KH*KW*C.  Read as a (KH*KW*C, O) row-major
// matrix, HWIO already is the B operand.  Each block of 256 threads owns
// a 64 x 64 tile of (pixels x channels); each thread holds 4 x 4 outputs in
// registers.  The block walks K in chunks of 16 through shared memory:
//   * A (64 pixels x 16 depths) is gathered from x at offsets computed
//     from (n, oh, ow) of the pixel and (kh, kw, c) of the depth index;
//     taps that fall outside the image read as zero, which takes the place
//     of the TPU kernel's padded copy of x (`jnp.pad`, kernel.py:66-67);
//   * B (16 depths x 64 channels) is a plain strided read of w;
//   * every edge of M, O and K is masked, so no size has to divide any
//     other (there is no counterpart of the `largest_dividing_block` snap
//     at kernel.py:72); the wrapper's block_o sets no tile here.
// The TPU kernel's grid gave each program a whole padded image; that does
// not fit a Hopper block's shared memory, so this kernel tiles the output
// pixels instead and gathers each tile's receptive field on the fly.
//
// Bound: at the CNN's shapes (ResNet-50 at 32x32, see PERF.md) a
// convolution does far more flops per byte than f32 FMAs can keep up with
// at 3.35 TB/s, so the f32 operation rate bounds all of them except the
// 3-channel stem, whose few taps per output make it bound by the bytes of
// its output.  This first kernel runs scalar f32 FMAs only: no TF32, no
// `wgmma`, no TMA and no double buffering, so that its result can be held
// to f32 against the plain version; the tensor-core design is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 16;        // depth per shared-memory stage
constexpr int kThreads = 256;
constexpr int kTM = 4;         // pixels per thread
constexpr int kTN = 4;         // channels per thread
constexpr int kRowsA = kThreads / kBK;   // 16 pixel rows gathered per pass
constexpr int kPassA = kBM / kRowsA;     // 4 passes cover the A tile
constexpr int kRowsB = kThreads / kBN;   // 4 depth rows read per pass
constexpr int kPassB = kBK / kRowsB;     // 4 passes cover the B tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's .to(bfloat16)
}

struct Geom {
  int N, H, W, C, KH, KW, O, OH, OW, stride, pad;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, Geom g) {
  // A is stored transposed (depth-major) so a thread reads its 4 pixels as
  // one float4; the row pad keeps 16-byte alignment.
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int64_t M = (int64_t)g.N * g.OH * g.OW;
  const int K = g.KH * g.KW * g.C;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;

  // Gather assignment: neighbouring threads take neighbouring depths of
  // one pixel, i.e. neighbouring channels in NHWC memory.
  const int a_k = tid % kBK;
  const int a_m = tid / kBK;
  int64_t a_base[kPassA];   // offset of pixel's image in x
  int a_ih[kPassA];         // window's top-left row (may be negative)
  int a_iw[kPassA];         // window's top-left column
#pragma unroll
  for (int r = 0; r < kPassA; ++r) {
    const int64_t m = m0 + a_m + kRowsA * r;
    if (m < M) {
      const int ow = (int)(m % g.OW);
      const int64_t t = m / g.OW;
      const int oh = (int)(t % g.OH);
      const int64_t n = t / g.OH;
      a_base[r] = n * g.H * g.W * g.C;
      a_ih[r] = oh * g.stride - g.pad;
      a_iw[r] = ow * g.stride - g.pad;
    } else {                 // past the last pixel: every tap reads zero
      a_base[r] = 0;
      a_ih[r] = -(1 << 30);
      a_iw[r] = 0;
    }
  }
  const int b_o = tid % kBN;
  const int b_k = tid / kBN;

  const int tx = tid % (kBN / kTN);   // channel group of this thread
  const int ty = tid / (kBN / kTN);   // pixel group of this thread
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + a_k;
    const bool k_in = k < K;
    int c = 0, kw = 0, kh = 0;
    if (k_in) {
      c = k % g.C;
      const int t = k / g.C;
      kw = t % g.KW;
      kh = t / g.KW;
    }
#pragma unroll
    for (int r = 0; r < kPassA; ++r) {
      const int ih = a_ih[r] + kh;
      const int iw = a_iw[r] + kw;
      float v = 0.f;
      if (k_in && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        v = to_f32(x[a_base[r] + ((int64_t)ih * g.W + iw) * g.C + c]);
      As[a_k][a_m + kRowsA * r] = v;
    }
    const int o = o0 + b_o;
#pragma unroll
    for (int r = 0; r < kPassB; ++r) {
      const int kk = b_k + kRowsB * r;
      const int kg = k0 + kk;
      Bs[kk][b_o] = (kg < K && o < g.O) ? to_f32(w[(int64_t)kg * g.O + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t m = m0 + ty * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int o = o0 + tx * kTN + j;
      if (o < g.O) y[m * g.O + o] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

// x, w, y: device pointers (NHWC, HWIO, NHWC; contiguous).  Returns the
// cudaError_t of the launch (0 on success).  Launches on `stream`, does
// not synchronise and allocates nothing.
extern "C" int conv_mm_launch(const void* x, const void* w, void* y, int N,
                              int H, int W, int C, int KH, int KW, int O,
                              int OH, int OW, int stride, int pad, int is_bf16,
                              void* stream) {
  const Geom g{N, H, W, C, KH, KW, O, OH, OW, stride, pad};
  const int64_t M = (int64_t)N * OH * OW;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((O + kBN - 1) / kBN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    conv_mm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), g);
  } else {
    conv_mm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), g);
  }
  return (int)cudaGetLastError();
}
