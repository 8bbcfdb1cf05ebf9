// Matrix-multiplication 2-D convolution for Hopper (sm_90a): an implicit
// GEMM.
//
// Replaces the Pallas TPU kernel `conv_mm_kernel` (`_conv_body`) in
// src/repro/kernels/conv_mm/kernel.py.
//
// What it computes: y = conv(x, w) with x (N, H, W, C) NHWC, w (KH, KW, C, O)
// HWIO and y (N, OH, OW, O) NHWC, any stride, symmetric zero padding,
// groups = 1.  Inputs are f32 or bf16 (one type for both), the sum is kept
// in f32 and y is written in x's type.  It is the paper's index-im2col
// variant: the im2col matrix is never written to device memory.  A GEMM
// with M = N*OH*OW output pixels, N_gemm = O output channels and depth
// K = KH*KW*C; read as a (KH*KW*C, O) row-major matrix, HWIO already is
// the B operand.  Taps that fall outside the image read as zero, which
// takes the place of the TPU kernel's padded copy of x (`jnp.pad`,
// kernel.py:66-67); every edge of M, O and K is masked, so no size has to
// divide any other.  The TPU kernel's grid gave each program a whole
// padded image; that does not fit a Hopper block's shared memory, so this
// kernel tiles the output pixels and gathers each tile's receptive field
// on the fly.
//
// Bound: at the CNN's shapes (ResNet-50 at 32x32, see PERF.md) every
// convolution but the 3-channel stem does far more flops per byte than
// the CUDA cores' f32 rate (67 TFLOP/s) can keep up with at 3.35 TB/s, so
// that rate bounds them; the stem is bound by the bytes of its output.
// The result is held to f32 (rtol/atol 1e-4), so the products stay scalar
// f32 FMAs on the CUDA cores: TF32 keeps about three digits.
//
// f32: `conv_mm_f32_kernel<BM, BN, VEC_A>`, a pipelined, register-tiled
// implicit GEMM.
//   * A BM x BN (pixels x channels) block tile, BM, BN in {64, 128}, with
//     BM*BN/64 threads of 8 x 8 outputs each: per depth a thread reads 8
//     pixels and 8 channels from shared memory for 64 FMAs (the earlier
//     4 x 4 tile read 8 values for 16 FMAs, so shared-memory bandwidth set
//     the pace, not the FMA rate).  A thread's pixels are 8 rows apart by
//     BM / 8 and its channels two groups of 4, so its shared-memory reads
//     are 16-byte loads without bank conflicts.
//   * K in chunks of kBK = 16 through a ring of kStages = 3 shared-memory
//     stages filled by `cp.async`, so the gather of chunk k + 2 overlaps
//     the FMAs of chunk k, with one __syncthreads per chunk.  A (BM x 16,
//     pixel-major) is gathered with 16-byte copies of 4 channels of one
//     tap where C % 4 == 0 (VEC_A; every ResNet-50 convolution but the
//     stem) and 4-byte copies otherwise; taps outside the image and depths
//     past K use cp.async's zero fill (source size 0).  B (16 x BN) takes
//     16-byte copies where O % 4 == 0, 4-byte copies otherwise.
//   * Which tile: a fixed rule on (M, O) in tiling.py (`conv_tile`): BN 64
//     where O <= 64, and BM 64 where the BM = 128 grid would not give each
//     of the 132 SMs a block.
//   * Shared memory 4 * kStages * kBK * (BM + BN) bytes
//     (`conv_mm_smem_bytes`; the tiling model reports the same number).
//   * Each output sums its K products in one f32 chain in order, as the
//     earlier kernel did.
//
// bf16: `conv_mm_bf16_kernel`, the first, simpler design kept for bf16
// inputs: 64 x 64 tiles of 4 x 4 outputs a thread, K in 16-deep chunks
// through shared memory as f32, no overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geom {
  int N, H, W, C, KH, KW, O, OH, OW, stride, pad;
};

// ---------------------------------------------------------------------------
// f32: pipelined, register-tiled implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kBK = 16;        // depth per stage
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kTM = 8;         // pixels per thread
constexpr int kTN = 8;         // channels per thread

size_t f32_smem_bytes(int bm, int bn) {
  return sizeof(float) * kStages * kBK * (size_t)(bm + bn);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int BM, int BN, bool VEC_A>
__global__ void __launch_bounds__(BM * BN / (kTM * kTN))
conv_mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, Geom g, int vec_b) {
  constexpr int kThreads = BM * BN / (kTM * kTN);
  constexpr int TX = BN / kTN;                       // threads along channels
  constexpr int TY = BM / kTM;                       // threads along pixels
  // A slots: 4 depths (VEC_A) or 1 depth of one pixel per copy
  constexpr int A_W = VEC_A ? 4 : 1;
  constexpr int A_SLOTS = BM * kBK / A_W / kThreads;
  constexpr int A_PER_ROW = kBK / A_W;               // copies per pixel row
  static_assert(kThreads % A_PER_ROW == 0, "a thread keeps one depth offset");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                  // kStages x [BM][kBK]
  float* Bs = smem + kStages * BM * kBK;             // kStages x [kBK][BN]

  const int M = g.N * g.OH * g.OW;
  const int K = g.KH * g.KW * g.C;
  const int m0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // gather assignment: copy q = tid + kThreads * r covers pixel
  // q / A_PER_ROW at depth (q % A_PER_ROW) * A_W of the chunk
  const int a_k = (tid % A_PER_ROW) * A_W;
  int a_base[A_SLOTS];      // offset of the pixel's image in x
  int a_ih[A_SLOTS];        // window's top-left row (may be negative)
  int a_iw[A_SLOTS];        // window's top-left column
#pragma unroll
  for (int r = 0; r < A_SLOTS; ++r) {
    const int m = m0 + (tid + kThreads * r) / A_PER_ROW;
    if (m < M) {
      const int ow = m % g.OW, t = m / g.OW;
      const int oh = t % g.OH, n = t / g.OH;
      a_base[r] = n * g.H * g.W * g.C;
      a_ih[r] = oh * g.stride - g.pad;
      a_iw[r] = ow * g.stride - g.pad;
    } else {                // past the last pixel: every tap reads zero
      a_base[r] = 0;
      a_ih[r] = -(1 << 30);
      a_iw[r] = 0;
    }
  }

  auto load = [&](int buf, int chunk) {
    const int k0 = chunk * kBK;
    float* as = As + buf * BM * kBK;
    float* bs = Bs + buf * kBK * BN;
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
    for (int r = 0; r < A_SLOTS; ++r) {
      const int ih = a_ih[r] + kh, iw = a_iw[r] + kw;
      const bool ok = k_in && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      const float* src = ok ? x + a_base[r] + (ih * g.W + iw) * g.C + c : x;
      float* dst = as + ((tid + kThreads * r) / A_PER_ROW) * kBK + a_k;
      if (VEC_A)
        cp_async16(dst, src, ok);
      else
        cp_async4(dst, src, ok);
    }
    if (vec_b) {
      constexpr int B_SLOTS = kBK * BN / 4 / kThreads;
#pragma unroll
      for (int r = 0; r < B_SLOTS; ++r) {
        const int q = tid + kThreads * r;
        const int kk = q / (BN / 4), on = (q % (BN / 4)) * 4;
        const bool ok = k0 + kk < K && o0 + on < g.O;
        cp_async16(bs + kk * BN + on, ok ? w + (k0 + kk) * g.O + o0 + on : w, ok);
      }
    } else {
      constexpr int B_SLOTS = kBK * BN / kThreads;
#pragma unroll
      for (int r = 0; r < B_SLOTS; ++r) {
        const int q = tid + kThreads * r;
        const int kk = q / BN, on = q % BN;
        const bool ok = k0 + kk < K && o0 + on < g.O;
        cp_async4(bs + kk * BN + on, ok ? w + (k0 + kk) * g.O + o0 + on : w, ok);
      }
    }
  };

  const int tx = tid % TX, ty = tid / TX;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int n_chunks = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    cp_async_wait<kStages - 2>();      // this thread's copies of chunk kc landed
    __syncthreads();                   // everyone's, and chunk kc - 1 is consumed
    const int next = kc + kStages - 1;
    if (next < n_chunks) load(next % kStages, next);
    cp_async_commit();

    const float* as = As + (kc % kStages) * BM * kBK;
    const float* bs = Bs + (kc % kStages) * kBK * BN;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + TY * i) * kBK + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (k4 + kk) * BN + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + (k4 + kk) * BN + BN / 2 + tx * 4);
        const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool vec_y = g.O % 4 == 0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
    float* yr = y + (int64_t)m * g.O;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = o0 + half * (BN / 2) + tx * 4;
      const float* v = acc[i] + 4 * half;
      if (vec_y && o < g.O) {
        *reinterpret_cast<float4*>(yr + o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (o + j < g.O) yr[o + j] = v[j];
      }
    }
  }
}

template <int BM, int BN, bool VEC_A>
cudaError_t launch_f32(const float* x, const float* w, float* y, const Geom& g, int vec_b,
                       cudaStream_t s) {
  auto kernel = conv_mm_f32_kernel<BM, BN, VEC_A>;
  const size_t smem = f32_smem_bytes(BM, BN);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int M = g.N * g.OH * g.OW;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((g.O + BN - 1) / BN));
  kernel<<<grid, BM * BN / (kTM * kTN), smem, s>>>(x, w, y, g, vec_b);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_tile(const float* x, const float* w, float* y, const Geom& g, int vec_a,
                        int vec_b, cudaStream_t s) {
  return vec_a ? launch_f32<BM, BN, true>(x, w, y, g, vec_b, s)
               : launch_f32<BM, BN, false>(x, w, y, g, vec_b, s);
}

// ---------------------------------------------------------------------------
// bf16: 64 x 64 tiles, 4 x 4 outputs a thread
// ---------------------------------------------------------------------------

constexpr int kBM16 = 64;       // output pixels per block
constexpr int kBN16 = 64;       // output channels per block
constexpr int kThreads16 = 256;
constexpr int kRowsA = kThreads16 / kBK;   // 16 pixel rows gathered per pass
constexpr int kPassA = kBM16 / kRowsA;     // 4 passes cover the A tile
constexpr int kRowsB = kThreads16 / kBN16; // 4 depth rows read per pass
constexpr int kPassB = kBK / kRowsB;       // 4 passes cover the B tile
constexpr size_t kBf16Smem = sizeof(float) * (kBK * (kBM16 + 4) + kBK * kBN16);

__global__ void __launch_bounds__(kThreads16)
conv_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, Geom g) {
  // A is stored transposed (depth-major) so a thread reads its 4 pixels as
  // one float4; the row pad keeps 16-byte alignment.
  __shared__ __align__(16) float As[kBK][kBM16 + 4];
  __shared__ __align__(16) float Bs[kBK][kBN16];

  const int64_t M = (int64_t)g.N * g.OH * g.OW;
  const int K = g.KH * g.KW * g.C;
  const int64_t m0 = (int64_t)blockIdx.x * kBM16;
  const int o0 = blockIdx.y * kBN16;
  const int tid = threadIdx.x;

  // Gather assignment: neighbouring threads take neighbouring depths of
  // one pixel, i.e. neighbouring channels in NHWC memory.
  const int a_k = tid % kBK;
  const int a_m = tid / kBK;
  int64_t a_base[kPassA];
  int a_ih[kPassA];
  int a_iw[kPassA];
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
    } else {
      a_base[r] = 0;
      a_ih[r] = -(1 << 30);
      a_iw[r] = 0;
    }
  }
  const int b_o = tid % kBN16;
  const int b_k = tid / kBN16;

  const int tx = tid % (kBN16 / 4);   // channel group of this thread
  const int ty = tid / (kBN16 / 4);   // pixel group of this thread
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
        v = __bfloat162float(x[a_base[r] + ((int64_t)ih * g.W + iw) * g.C + c]);
      As[a_k][a_m + kRowsA * r] = v;
    }
    const int o = o0 + b_o;
#pragma unroll
    for (int r = 0; r < kPassB; ++r) {
      const int kk = b_k + kRowsB * r;
      const int kg = k0 + kk;
      Bs[kk][b_o] = (kg < K && o < g.O) ? __bfloat162float(w[(int64_t)kg * g.O + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      // round to nearest even, as torch's .to(bfloat16)
      if (o < g.O) y[m * g.O + o] = __float2bfloat16(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block takes with a bm x bn tile (f32) or the fixed
// 64 x 64 bf16 tile (`bf16` != 0), in bytes.
long long conv_mm_smem_bytes(int bm, int bn, int bf16) {
  return (long long)(bf16 ? kBf16Smem : f32_smem_bytes(bm, bn));
}

// x, w, y: device pointers (NHWC, HWIO, NHWC; contiguous; fewer than 2^31
// elements each).  f32: a bm x bn tile, bm and bn in {64, 128}; vec_a when
// C % 4 == 0 and x is 16-byte aligned, vec_b when O % 4 == 0 and w is
// 16-byte aligned (bf16 ignores all four).  Returns the cudaError_t of the
// launch (0 on success).  Launches on `stream`, does not synchronise and
// allocates nothing.
int conv_mm_launch(const void* x, const void* w, void* y, int N, int H, int W, int C, int KH,
                   int KW, int O, int OH, int OW, int stride, int pad, int is_bf16, int bm,
                   int bn, int vec_a, int vec_b, void* stream) {
  const Geom g{N, H, W, C, KH, KW, O, OH, OW, stride, pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int64_t M = (int64_t)N * OH * OW;
    const dim3 grid((unsigned)((M + kBM16 - 1) / kBM16), (unsigned)((O + kBN16 - 1) / kBN16));
    conv_mm_bf16_kernel<<<grid, kThreads16, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), g);
    return (int)cudaGetLastError();
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  if (bm == 128 && bn == 128) return (int)launch_tile<128, 128>(xf, wf, yf, g, vec_a, vec_b, s);
  if (bm == 128 && bn == 64) return (int)launch_tile<128, 64>(xf, wf, yf, g, vec_a, vec_b, s);
  if (bm == 64 && bn == 128) return (int)launch_tile<64, 128>(xf, wf, yf, g, vec_a, vec_b, s);
  if (bm == 64 && bn == 64) return (int)launch_tile<64, 64>(xf, wf, yf, g, vec_a, vec_b, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
