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
// Bound, f32: at the CNN's shapes (ResNet-50 at 32x32, see PERF.md) every
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
// Bound, bf16: operations.  At the bench shape (8, 32, 32, 128) x (3, 3,
// 128, 128) the GEMM does 2.416e9 flops on 4.49e6 bytes (x and w read
// once, y written once): 538 flops a byte, above the 295 at which the
// tensor cores' 989 TFLOP/s and not the 3.35 TB/s bound an H100.  So the
// products run on the tensor cores, summed in f32 (bf16 products of bf16
// inputs are exact in f32).
//
// bf16: `conv_mm_bf16_wgmma_kernel<BM, BN, VEC_A>`, an implicit GEMM on
// `wgmma`.
//   * A BM x BN block tile, BM, BN in {64, 128}, one warpgroup (128
//     threads) for every 64 rows; each issues `wgmma.mma_async` m64nBNk16
//     (bf16 in, f32 accumulators in registers) from shared memory.
//   * K in chunks of kBK16 = 64 bf16, one 128-byte row of the 128-byte
//     swizzle, through a ring of kStages16 = 4 stages filled by
//     `cp.async`: chunk k + kAhead16 (2) loads while chunk k multiplies and
//     chunk k - 1 may still be in flight (`wgmma.wait_group 1`), one
//     __syncthreads per chunk.  Every thread copies; there is no producer
//     warp.
//   * A (BM x 64, K-major) is the im2col tile, gathered on the fly and
//     never written to device memory.  Where C % 8 == 0 (VEC_A; the bench
//     shape and every ResNet-50 convolution but the stem) each 16-byte copy
//     moves 8 channels of one tap, and a thread computes its group's
//     (kh, kw, c) once per chunk; with C % 64 == 0 all eight groups of a row
//     fall in one tap, with C 8 or 16 they span several.  Otherwise (C 3, 4,
//     13) a thread loads one depth of the chunk for 32 pixel rows as plain
//     2-byte loads into the same swizzled layout, its tap once per chunk.
//     Taps outside the image, depths past K and rows past M read as zero
//     (cp.async's source size 0).
//   * B (64 x BN) is HWIO read as the (K, O) row-major matrix, N-major in
//     BN / 64 swizzled atoms of 64 channels, so `wgmma` takes it with its
//     transpose bit and no transpose is made: 16-byte copies of 8 channels
//     where O % 8 == 0 (vec_b), plain loads otherwise, zero past K and O.
//   * Epilogue: f32 to bf16 round-to-nearest-even (`__float2bfloat16`)
//     into a padded tile in the freed ring, then stored to y in 16-byte
//     row segments where O % 8 == 0 (a warp writes whole rows), element by
//     element otherwise, masked at the M and O edges.
//   * Which tile: a fixed rule on (M, O) in tiling.py (`conv_tile_bf16`).
//   * Shared memory 1024 + 2 * kStages16 * kBK16 * (BM + BN) bytes (1024
//     of alignment slack: the swizzle needs 1024-byte aligned stages;
//     `conv_mm_smem_bytes`, and the tiling model reports the same number).

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
// bf16: implicit GEMM on the tensor cores (wgmma), a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kBK16 = 64;          // depth per stage: one 128-byte swizzle row of bf16
constexpr int kStages16 = 4;       // ring depth
constexpr int kAhead16 = 2;        // chunk k + kAhead16 loads while chunk k multiplies
constexpr uint32_t kRowBytes = kBK16 * 2;   // one A row, one B depth row of an atom
constexpr int kPadY = 8;           // bf16 pad of a staged output row: no bank conflicts

size_t bf16_smem_bytes(int bm, int bn) {
  return 1024 + 2 * (size_t)kStages16 * kBK16 * (bm + bn);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the 128-byte swizzle (the layout TMA's SWIZZLE_128B writes and wgmma's
// descriptor layout 1 reads): within each 1024-byte group of eight
// 128-byte rows, the 16-byte unit u of row r sits at unit u ^ r
__device__ __forceinline__ uint32_t swizzle128(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) become
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  // d(64 x 64) += a(64 x 16) b(16 x 64); a K-major, b N-major (transposed), both in
  // shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct Wgmma<128> {
  // d(64 x 128) += a(64 x 16) b(16 x 128); a K-major, b N-major (transposed), both in
  // shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <int BM, int BN, bool VEC_A>
__global__ void __launch_bounds__(2 * BM)
conv_mm_bf16_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y,
                          Geom g, int vec_b) {
  constexpr int kThreads = 2 * BM;                  // a warpgroup per 64 rows
  constexpr uint32_t A_BYTES = BM * kRowBytes;      // [BM][64] bf16, K-major
  constexpr uint32_t ATOM_BYTES = kBK16 * kRowBytes;  // [64 depths][64 channels] bf16
  constexpr uint32_t STAGE_BYTES = A_BYTES + (BN / 64) * ATOM_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);   // the same bytes, generic

  const int M = g.N * g.OH * g.OW;
  const int K = g.KH * g.KW * g.C;
  const int m0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // A gather, VEC_A (C % 8 == 0): copy slot r of a thread moves the 8
  // channels [8 a_j, 8 a_j + 8) of the chunk for pixel row a_row + 32 r;
  // an 8-channel group never spans two taps
  constexpr int A_SLOTS = VEC_A ? BM * 8 / kThreads : 1;   // 4
  const int a_j = tid % 8;
  int a_base[A_SLOTS];      // offset of the pixel's image in x
  int a_ih[A_SLOTS];        // window's top-left row (may be negative)
  int a_iw[A_SLOTS];        // window's top-left column
  if (VEC_A) {
#pragma unroll
    for (int r = 0; r < A_SLOTS; ++r) {
      const int m = m0 + tid / 8 + (kThreads / 8) * r;
      if (m < M) {
        const int ow = m % g.OW, t = m / g.OW;
        const int oh = t % g.OH, n = t / g.OH;
        a_base[r] = n * g.H * g.W * g.C;
        a_ih[r] = oh * g.stride - g.pad;
        a_iw[r] = ow * g.stride - g.pad;
      } else {              // past the last pixel: every tap reads zero
        a_base[r] = 0;
        a_ih[r] = -(1 << 30);
        a_iw[r] = 0;
      }
    }
  }

  auto load = [&](int stage, int chunk) {
    const int k0 = chunk * kBK16;
    const uint32_t sA = base + stage * STAGE_BYTES;
    const uint32_t sB = sA + A_BYTES;
    if (VEC_A) {
      // the group's tap and channel, once per chunk
      const int k = k0 + 8 * a_j;
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
        const int row = tid / 8 + (kThreads / 8) * r;
        const int ih = a_ih[r] + kh, iw = a_iw[r] + kw;
        const bool ok = k_in && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
        cp_async16(sA + swizzle128(row * kRowBytes + a_j * 16),
                   ok ? x + a_base[r] + (ih * g.W + iw) * g.C + c : x, ok);
      }
    } else {
      // C % 8 != 0 (the 3-channel stem): plain loads, depth e of the chunk
      // for pixel rows tid / 64 + (kThreads / 64) r; the tap once per chunk
      const int e = tid % kBK16;
      const int k = k0 + e;
      const bool k_in = k < K;
      int c = 0, kw = 0, kh = 0;
      if (k_in) {
        c = k % g.C;
        const int t = k / g.C;
        kw = t % g.KW;
        kh = t / g.KW;
      }
#pragma unroll 8
      for (int r = 0; r < BM * kBK16 / kThreads; ++r) {
        const int row = tid / kBK16 + (kThreads / kBK16) * r;
        const int m = m0 + row;
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (k_in && m < M) {
          const int ow = m % g.OW, t = m / g.OW;
          const int oh = t % g.OH, n = t / g.OH;
          const int ih = oh * g.stride - g.pad + kh, iw = ow * g.stride - g.pad + kw;
          if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
            v = x[((n * g.H + ih) * g.W + iw) * g.C + c];
        }
        *reinterpret_cast<__nv_bfloat16*>(base_ptr + (sA - base) +
                                          swizzle128(row * kRowBytes + e * 2)) = v;
      }
    }
    // B: depth rows k0 .. k0 + 63 of the (K, O) matrix, channels o0 ..
    // o0 + BN - 1, in BN / 64 atoms of 64 channels (N-major)
    if (vec_b) {            // O % 8 == 0: 16-byte copies of 8 channels
      constexpr int B_SLOTS = kBK16 * BN / 8 / kThreads;
#pragma unroll
      for (int r = 0; r < B_SLOTS; ++r) {
        const int q = tid + kThreads * r;
        const int kk = q / (BN / 8), n = (q % (BN / 8)) * 8;
        const bool ok = k0 + kk < K && o0 + n < g.O;
        cp_async16(sB + (n / 64) * ATOM_BYTES + swizzle128(kk * kRowBytes + (n % 64) * 2),
                   ok ? w + (k0 + kk) * g.O + o0 + n : w, ok);
      }
    } else {
#pragma unroll 8
      for (int r = 0; r < kBK16 * BN / kThreads; ++r) {
        const int q = tid + kThreads * r;
        const int kk = q / BN, n = q % BN;
        const bool ok = k0 + kk < K && o0 + n < g.O;
        *reinterpret_cast<__nv_bfloat16*>(
            base_ptr + (sB - base) + (n / 64) * ATOM_BYTES +
            swizzle128(kk * kRowBytes + (n % 64) * 2)) =
            ok ? w[(k0 + kk) * g.O + o0 + n] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  const int wg = tid / 128;
  const int n_chunks = (K + kBK16 - 1) / kBK16;
#pragma unroll
  for (int c = 0; c < kAhead16; ++c) {
    if (c < n_chunks) load(c, c);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    cp_async_wait<kAhead16 - 1>();   // this thread's copies of chunk kc landed
    fence_proxy_async();
    __syncthreads();        // everyone's; and every warpgroup is done with the
                            // chunk whose stage the next load takes
    const uint32_t sA = base + (kc % kStages16) * STAGE_BYTES + wg * 64 * kRowBytes;
    const uint32_t sB = base + (kc % kStages16) * STAGE_BYTES + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK16 / 16; ++kk)
      Wgmma<BN>::ss(acc, gmma_desc(sA + kk * 32, 16, 8 * kRowBytes),
                    gmma_desc(sB + kk * 16 * kRowBytes, ATOM_BYTES, 8 * kRowBytes));
    wgmma_commit();
    fence_regs(acc);
    // chunk kc + kAhead16 into the stage of chunk kc + kAhead16 - kStages16,
    // while chunk kc multiplies
    if (kc + kAhead16 < n_chunks) load((kc + kAhead16) % kStages16, kc + kAhead16);
    cp_async_commit();
    // at most kStages16 - kAhead16 - 1 chunks' products still in flight
    wgmma_wait<kStages16 - kAhead16 - 1>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();          // the ring is free: stage the output tile there

  // the wgmma accumulator layout: register 4 j + i of thread (warp, lane)
  // holds row 16 warp + lane / 4 (+ 8 for i >= 2), channel 8 j + 2 (lane % 4)
  // + i % 2 of its warpgroup's 64 x BN tile.  Rounded to bf16 (round to
  // nearest even) into a [BM][BN + kPadY] tile, then stored to y a 16-byte
  // row segment a thread, neighbouring threads on neighbouring segments.
  constexpr int LDY = BN + kPadY;
  __nv_bfloat16* const ys = reinterpret_cast<__nv_bfloat16*>(base_ptr);
  {
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int r = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(ys + r * LDY + c) =
          __halves2bfloat162(__float2bfloat16(acc[4 * j]), __float2bfloat16(acc[4 * j + 1]));
      *reinterpret_cast<__nv_bfloat162*>(ys + (r + 8) * LDY + c) =
          __halves2bfloat162(__float2bfloat16(acc[4 * j + 2]),
                             __float2bfloat16(acc[4 * j + 3]));
    }
  }
  __syncthreads();
  const bool vec_y = g.O % 8 == 0;    // a segment is whole and 16-byte aligned in y
#pragma unroll
  for (int i = 0; i < BM * BN / 8 / kThreads; ++i) {
    const int q = tid + kThreads * i;
    const int r = q / (BN / 8), c = (q % (BN / 8)) * 8;
    const int m = m0 + r, o = o0 + c;
    if (m >= M || o >= g.O) continue;
    __nv_bfloat16* dst = y + (int64_t)m * g.O + o;
    const __nv_bfloat16* src = ys + r * LDY + c;
    if (vec_y) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && o + e < g.O; ++e) dst[e] = src[e];
    }
  }
}

template <int BM, int BN, bool VEC_A>
cudaError_t launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y,
                        const Geom& g, int vec_b, cudaStream_t s) {
  auto kernel = conv_mm_bf16_wgmma_kernel<BM, BN, VEC_A>;
  const size_t smem = bf16_smem_bytes(BM, BN);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int M = g.N * g.OH * g.OW;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((g.O + BN - 1) / BN));
  kernel<<<grid, 2 * BM, smem, s>>>(x, w, y, g, vec_b);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_bf16_tile(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y,
                             const Geom& g, int vec_a, int vec_b, cudaStream_t s) {
  return vec_a ? launch_bf16<BM, BN, true>(x, w, y, g, vec_b, s)
               : launch_bf16<BM, BN, false>(x, w, y, g, vec_b, s);
}

}  // namespace

extern "C" {

// Shared memory one block takes with a bm x bn tile, for bf16 (`bf16` != 0)
// or f32 inputs, in bytes.
long long conv_mm_smem_bytes(int bm, int bn, int bf16) {
  return (long long)(bf16 ? bf16_smem_bytes(bm, bn) : f32_smem_bytes(bm, bn));
}

// x, w, y: device pointers (NHWC, HWIO, NHWC; contiguous; fewer than 2^31
// elements each).  A bm x bn tile, bm and bn in {64, 128}.  f32: vec_a when
// C % 4 == 0 and x is 16-byte aligned, vec_b when O % 4 == 0 and w is
// 16-byte aligned; bf16: vec_a when C % 8 == 0 and x is 16-byte aligned,
// vec_b when O % 8 == 0 and w is 16-byte aligned.  Returns the cudaError_t
// of the launch (0 on success).  Launches on `stream`, does not synchronise
// and allocates nothing.
int conv_mm_launch(const void* x, const void* w, void* y, int N, int H, int W, int C, int KH,
                   int KW, int O, int OH, int OW, int stride, int pad, int is_bf16, int bm,
                   int bn, int vec_a, int vec_b, void* stream) {
  const Geom g{N, H, W, C, KH, KW, O, OH, OW, stride, pad};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (bm == 128 && bn == 128)
      return (int)launch_bf16_tile<128, 128>(xb, wb, yb, g, vec_a, vec_b, s);
    if (bm == 128 && bn == 64)
      return (int)launch_bf16_tile<128, 64>(xb, wb, yb, g, vec_a, vec_b, s);
    if (bm == 64 && bn == 128)
      return (int)launch_bf16_tile<64, 128>(xb, wb, yb, g, vec_a, vec_b, s);
    if (bm == 64 && bn == 64)
      return (int)launch_bf16_tile<64, 64>(xb, wb, yb, g, vec_a, vec_b, s);
    return (int)cudaErrorInvalidValue;
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
