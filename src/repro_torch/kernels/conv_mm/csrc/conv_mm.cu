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
// Bound, f32: operations.  At the CNN's shapes (ResNet-50 at 32x32, see
// PERF.md) every convolution but the 3-channel stem does far more flops
// per byte than the card's f32 rate can keep up with at 3.35 TB/s.  On the
// CUDA cores that rate is 67 TFLOP/s.  One TF32 product on the tensor
// cores keeps about three digits, short of the 1e-4 gate, so each f32
// product is three TF32 products (3xTF32): x = hi + lo with hi = x, its
// low 13 mantissa bits cleared, and lo = x - hi exactly, of which the
// tensor cores read the TF32 part; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,
// small terms first.  That is f32-accurate work at 495 / 3 = 165 TFLOP/s,
// the bound this kernel is held to (its TF32 `wgmma` stream alone reaches
// about 63% of that rate on an H100, PERF.md §6).
//
// f32: `conv_mm_tf32_wgmma_kernel<BM, BN, VEC_A>`, an implicit GEMM on
// `wgmma` in 3xTF32.
//   * A BM x BN (pixels x channels) block tile, 64 x 64 or 128 x 128, one
//     warpgroup (128 threads) for every 64 rows; each issues
//     `wgmma.mma_async` m64nBNk8 TF32 with A from registers and B K-major
//     from shared memory through a 128-byte-swizzle descriptor.
//   * K in chunks of kBK32 = 32 f32, one 128-byte swizzle row, through a
//     ring of kStages32 = 4 stages filled by `cp.async`: chunk k + 3 loads
//     while chunk k is prepared and chunk k - 1 multiplies.  Every thread
//     copies; there is no producer warp.
//   * A (BM x 32, K-major, swizzled) is the im2col tile, gathered on the
//     fly and never written to device memory: 16-byte copies of 4 channels
//     of one tap where C % 4 == 0 (VEC_A; every ResNet-50 convolution but
//     the stem), else 4-byte copies, a thread walking its depths' taps;
//     taps outside the image, depths past K and rows past M are zero
//     (cp.async's source size 0).  Per chunk each warp loads its fragments
//     with `ldmatrix` and splits them into hi and lo in registers.
//   * B: HWIO read as the (K, O) row-major matrix is N-major, and TF32
//     `wgmma` takes B only K-major (the transpose bit exists for 16-bit
//     types alone).  So each chunk's w tile lands N-major (16-byte copies
//     where O % 4 == 0, 4-byte otherwise; its 16-byte units XOR-swizzled by
//     depth / 4), and the block rewrites it K-major twice, as hi and as lo,
//     into one of two [hi | lo] pairs (double-buffered, so the rewrite of
//     chunk k overlaps the products of chunk k - 1), then
//     `fence.proxy.async` and a barrier.  No prepass and no workspace.
//   * Products: per k-step a_lo b_hi + a_hi b_lo + a_hi b_hi.  The tensor
//     cores' own sum drops the bits below its accumulator's last place,
//     which over a whole K of 4608 left a bias near 1e-4 |y| and failed
//     the training step's gradient check (PERF.md §6); so a chunk's 12
//     products sum into a partial accumulator (scale-d 0 on its first),
//     which joins the f32 total in one rounded add once they are done.
//     They run while the next chunk's w tile is rewritten.
//   * Epilogue: the f32 tile staged in the freed ring ([BM][BN + 8]), then
//     stored to y in 16-byte row segments where O % 4 == 0, element by
//     element otherwise, masked at the M and O edges.
//   * Which tile: a fixed rule on (M, O) in tiling.py (`conv_tile`): 128 x
//     128 where O > 64 and the 64 x 64 grid has more blocks than the 132
//     SMs hold at once (two each), else 64 x 64, as timed per shape.
//   * Shared memory 1024 + kStages32 * 128 * (BM + BN) + 4 * 128 * BN bytes
//     (1024 of alignment slack; `conv_mm_smem_bytes`, and the tiling model
//     reports the same number): 197,632 at 128 x 128.
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
// cp.async, shared by both kernels
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, or 16 zero bytes where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes where !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// f32: implicit GEMM on the tensor cores (wgmma) in 3xTF32, a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kBK32 = 32;          // depth per stage: one 128-byte swizzle row of f32
constexpr int kStages32 = 4;       // ring depth; chunk k + kStages32 - 1 loads during chunk k
constexpr int kPadY32 = 8;         // f32 pad of a staged output row: no bank conflicts
static_assert(kBK32 * 4 == kRowBytes, "an f32 chunk row is one 128-byte swizzle row");

size_t tf32_smem_bytes(int bm, int bn) {
  // alignment slack, the ring (the A tile and the N-major w tile a stage) and
  // two K-major [hi | lo] pairs of the w tile
  return 1024 + (size_t)kStages32 * kRowBytes * (bm + bn) + 4 * (size_t)kRowBytes * bn;
}

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi exactly; the tensor cores read lo's TF32 part
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// four 8 x 4 f32 matrices (rows of 16 bytes, one address per lane: lanes
// 8i..8i+7 give the rows of matrix i); lane l gets element (l / 4, l % 4)
// of matrix i in r[i], the layout of a TF32 A fragment
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

template <int N> struct WgmmaTf32;

template <> struct WgmmaTf32<64> {
  // d(64 x 64) = a(64 x 8) b(8 x 64) + (scale_d ? d : 0); a in registers, b
  // K-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
        : "memory");
  }
};

template <> struct WgmmaTf32<128> {
  // d(64 x 128) = a(64 x 8) b(8 x 128) + (scale_d ? d : 0); a in registers, b
  // K-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
        : "memory");
  }
};

template <int BM, int BN, bool VEC_A>
__global__ void __launch_bounds__(2 * BM, 1)
conv_mm_tf32_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ y, Geom g, int vec_b) {
  constexpr int kThreads = 2 * BM;                   // a warpgroup per 64 rows
  constexpr uint32_t A_BYTES = BM * kRowBytes;       // [BM][32] f32, K-major, swizzled
  constexpr uint32_t W_BYTES = kBK32 * BN * 4;       // [32][BN] f32, N-major, swizzled
  constexpr uint32_t STAGE_BYTES = A_BYTES + W_BYTES;
  constexpr uint32_t B_BYTES = BN * kRowBytes;       // [BN][32] f32, K-major, swizzled
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);   // the same bytes, generic
  const uint32_t pairs = base + kStages32 * STAGE_BYTES;   // 2 x [hi | lo] of B

  const int M = g.N * g.OH * g.OW;
  const int K = g.KH * g.KW * g.C;
  const int n_chunks = (K + kBK32 - 1) / kBK32;
  const int m0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // A gather: lane a_j of A_LANES copies, for pixel row tid / A_LANES +
  // (kThreads / A_LANES) r, either the 4 channels [4 a_j, 4 a_j + 4) of the
  // chunk in one 16-byte copy (VEC_A: C % 4 == 0, so 4 channels never span
  // two taps) or depths a_j, a_j + 4, ..., a_j + 28 in 4-byte copies
  constexpr int A_LANES = VEC_A ? 8 : 4;
  constexpr int A_SLOTS = BM * A_LANES / kThreads;   // 4 or 2 rows a thread
  const int a_j = tid % A_LANES;
  int a_base[A_SLOTS];      // offset of the pixel's image in x
  int a_ih[A_SLOTS];        // window's top-left row (may be negative)
  int a_iw[A_SLOTS];        // window's top-left column
#pragma unroll
  for (int r = 0; r < A_SLOTS; ++r) {
    const int m = m0 + tid / A_LANES + (kThreads / A_LANES) * r;
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

  auto load = [&](int stage, int chunk) {
    const int k0 = chunk * kBK32;
    const uint32_t sA = base + stage * STAGE_BYTES;
    const uint32_t sW = sA + A_BYTES;
    // the first depth's tap; VEC_A needs no other
    int k = k0 + (VEC_A ? 4 : 1) * a_j;
    int c = k % g.C, kw = (k / g.C) % g.KW, kh = k / g.C / g.KW;
    if (VEC_A) {
      const bool k_in = k < K;
#pragma unroll
      for (int r = 0; r < A_SLOTS; ++r) {
        const int row = tid / A_LANES + (kThreads / A_LANES) * r;
        const int ih = a_ih[r] + kh, iw = a_iw[r] + kw;
        const bool ok = k_in && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
        cp_async16(sA + swizzle128(row * kRowBytes + a_j * 16),
                   ok ? x + a_base[r] + (ih * g.W + iw) * g.C + c : x, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK32 / 4; ++i) {
        const bool k_in = k < K;
#pragma unroll
        for (int r = 0; r < A_SLOTS; ++r) {
          const int row = tid / A_LANES + (kThreads / A_LANES) * r;
          const int ih = a_ih[r] + kh, iw = a_iw[r] + kw;
          const bool ok = k_in && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
          cp_async4(sA + swizzle128(row * kRowBytes + i * 16 + a_j * 4),
                    ok ? x + a_base[r] + (ih * g.W + iw) * g.C + c : x, ok);
        }
        // depth k + 4: walk the tap
        k += 4;
        c += 4;
        while (c >= g.C) {
          c -= g.C;
          if (++kw == g.KW) {
            kw = 0;
            ++kh;
          }
        }
      }
    }
    // w: depth rows k0 .. k0 + 31 of the (K, O) matrix, channels o0 ..
    // o0 + BN - 1, N-major; 16-byte unit u of depth row kk sits at unit
    // u ^ ((kk / 4) % 8), so the K-major rewrite reads it without bank
    // conflicts
    if (vec_b) {            // O % 4 == 0: 16-byte copies of 4 channels
#pragma unroll
      for (int r = 0; r < kBK32 * BN / 4 / kThreads; ++r) {
        const int q = tid + kThreads * r;
        const int kk = q / (BN / 4), u = q % (BN / 4);
        const bool ok = k0 + kk < K && o0 + 4 * u < g.O;
        cp_async16(sW + kk * BN * 4 + ((u ^ ((kk >> 2) & 7)) << 4),
                   ok ? w + (k0 + kk) * g.O + o0 + 4 * u : w, ok);
      }
    } else {
#pragma unroll 8
      for (int r = 0; r < kBK32 * BN / kThreads; ++r) {
        const int q = tid + kThreads * r;
        const int kk = q / BN, n = q % BN;
        const bool ok = k0 + kk < K && o0 + n < g.O;
        cp_async4(sW + kk * BN * 4 + (((n >> 2) ^ ((kk >> 2) & 7)) << 4) + (n & 3) * 4,
                  ok ? w + (k0 + kk) * g.O + o0 + n : w, ok);
      }
    }
  };

  // a chunk's 12 products sum on the tensor cores into `part`, which then
  // joins `acc` by one rounded f32 add: the tensor cores' own sum drops the
  // bits below its accumulator's last place, which over all of K would
  // leave a bias of about 1e-4 |y| (1728 such adds at K 4608)
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

  // ldmatrix rows of this warp's A fragments: row (li & 1) * 8 + lane % 8 of
  // its 16, 16-byte unit 2 kk + (li >> 1) of k-step kk
  const int warp = tid / 32, lane = tid % 32, li = lane / 8;
  const int a_row = 16 * warp + (li & 1) * 8 + lane % 8;
  uint32_t ah[4][4], al[4][4];    // the chunk's A fragments, hi and lo

  // chunk kc: its w tile rewritten K-major as [hi | lo] while chunk kc - 1's
  // products run; then chunk kc - 1's sum joins acc, chunk kc's A fragments
  // are split into registers, and its 4 k-steps of 3 products (small terms
  // first) are left in flight
  auto chunk = [&](int kc) {
    cp_async_wait<kStages32 - 2>();   // this thread's copies of chunk kc landed
    __syncthreads();        // everyone's; and every thread is done with chunk
                            // kc - 1's stage, which this load takes
    if (kc + kStages32 - 1 < n_chunks)
      load((kc + kStages32 - 1) % kStages32, kc + kStages32 - 1);
    cp_async_commit();
    const uint32_t sA = base + (kc % kStages32) * STAGE_BYTES;
    const uint32_t sW = sA + A_BYTES;
    // chunk kc - 2, whose products read this pair, is done
    const uint32_t sB = pairs + (kc % 2) * 2 * B_BYTES;
    // w tile -> K-major hi and lo: a thread moves 4 depths x 4 channels
#pragma unroll
    for (int r = 0; r < (2 * BN + kThreads - 1) / kThreads; ++r) {
      const int q = tid + kThreads * r;
      if (q < 2 * BN) {
        const int k4 = q % 8, n4 = q / 8;
        uint32_t v[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 f = *reinterpret_cast<const float4*>(
              base_ptr + (sW - base) + (4 * k4 + i) * BN * 4 + ((n4 ^ k4) << 4));
          v[i][0] = __float_as_uint(f.x);
          v[i][1] = __float_as_uint(f.y);
          v[i][2] = __float_as_uint(f.z);
          v[i][3] = __float_as_uint(f.w);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(v[i][j], hi[i], lo[i]);
          const uint32_t off = (sB - base) + swizzle128((4 * n4 + j) * kRowBytes + k4 * 16);
          *reinterpret_cast<float4*>(base_ptr + off) =
              make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                          __uint_as_float(hi[2]), __uint_as_float(hi[3]));
          *reinterpret_cast<float4*>(base_ptr + off + B_BYTES) =
              make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                          __uint_as_float(lo[2]), __uint_as_float(lo[3]));
        }
      }
    }
    wgmma_wait<0>();        // chunk kc - 1's products are done
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    // the chunk's A fragments, split
#pragma unroll
    for (int kk = 0; kk < kBK32 / 8; ++kk) {
      uint32_t a[4];
      ldsm_x4(sA + swizzle128(a_row * kRowBytes + (2 * kk + (li >> 1)) * 16), a);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[kk][i], al[kk][i]);
    }
    fence_proxy_async();
    __syncthreads();        // hi and lo written, and visible to wgmma
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK32 / 8; ++kk) {
      const uint64_t b_hi = gmma_desc(sB + kk * 32, 16, 8 * kRowBytes);
      const uint64_t b_lo = gmma_desc(sB + B_BYTES + kk * 32, 16, 8 * kRowBytes);
      WgmmaTf32<BN>::rs(part, al[kk], b_hi, kk > 0);
      WgmmaTf32<BN>::rs(part, ah[kk], b_lo, 1);
      WgmmaTf32<BN>::rs(part, ah[kk], b_hi, 1);
    }
    wgmma_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages32 - 1; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) chunk(kc);
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  cp_async_wait<0>();
  __syncthreads();          // the ring is free: stage the output tile there

  // the wgmma accumulator layout: register 4 j + i of thread (warp, lane)
  // holds row 16 warp + lane / 4 (+ 8 for i >= 2), channel 8 j + 2 (lane % 4)
  // + i % 2 of the block's BM x BN tile; staged in a [BM][BN + kPadY32]
  // tile, then stored to y a 16-byte row segment a thread
  constexpr int LDY = BN + kPadY32;
  float* const ys = reinterpret_cast<float*>(base_ptr);
  {
    const int r = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(ys + r * LDY + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(ys + (r + 8) * LDY + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  const bool vec_y = g.O % 4 == 0;    // a segment is whole and 16-byte aligned in y
#pragma unroll
  for (int i = 0; i < BM * BN / 4 / kThreads; ++i) {
    const int q = tid + kThreads * i;
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    const int m = m0 + r, o = o0 + c;
    if (m >= M || o >= g.O) continue;
    float* dst = y + (int64_t)m * g.O + o;
    const float* src = ys + r * LDY + c;
    if (vec_y) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int e = 0; e < 4 && o + e < g.O; ++e) dst[e] = src[e];
    }
  }
}

template <int BM, int BN, bool VEC_A>
cudaError_t launch_tf32(const float* x, const float* w, float* y, const Geom& g, int vec_b,
                        cudaStream_t s) {
  auto kernel = conv_mm_tf32_wgmma_kernel<BM, BN, VEC_A>;
  const size_t smem = tf32_smem_bytes(BM, BN);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int M = g.N * g.OH * g.OW;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((g.O + BN - 1) / BN));
  kernel<<<grid, 2 * BM, smem, s>>>(x, w, y, g, vec_b);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_tf32_tile(const float* x, const float* w, float* y, const Geom& g, int vec_a,
                             int vec_b, cudaStream_t s) {
  return vec_a ? launch_tf32<BM, BN, true>(x, w, y, g, vec_b, s)
               : launch_tf32<BM, BN, false>(x, w, y, g, vec_b, s);
}

}  // namespace

extern "C" {

// Shared memory one block takes with a bm x bn tile, for bf16 (`bf16` != 0)
// or f32 inputs, in bytes.
long long conv_mm_smem_bytes(int bm, int bn, int bf16) {
  return (long long)(bf16 ? bf16_smem_bytes(bm, bn) : tf32_smem_bytes(bm, bn));
}

// x, w, y: device pointers (NHWC, HWIO, NHWC; contiguous; fewer than 2^31
// elements each).  A bm x bn tile: bf16, bm and bn in {64, 128}; f32, 64 x
// 64 or 128 x 128 (any other returns cudaErrorInvalidValue).  f32: vec_a when
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
  // f32: the square tiles alone, the only ones its tile rule gives
  if (bm == 128 && bn == 128)
    return (int)launch_tf32_tile<128, 128>(xf, wf, yf, g, vec_a, vec_b, s);
  if (bm == 64 && bn == 64)
    return (int)launch_tf32_tile<64, 64>(xf, wf, yf, g, vec_a, vec_b, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
