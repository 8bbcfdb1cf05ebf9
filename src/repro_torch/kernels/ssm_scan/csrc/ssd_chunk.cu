// SSD intra-chunk pass (Mamba-2 state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_chunk_kernel` (`_ssd_body`) in
// src/repro/kernels/ssm_scan/kernel.py.
//
// What it computes, for each (b, chunk c, head h), over the chunk's l steps:
//   cum   = cumsum(a)                          (l,)   f32
//   y     = ((C B^T) o L) x,  L[i][j] = exp(cum_i - cum_j) for j <= i, else 0
//   state = (B o exp(cum_last - cum))^T x      (N, P) f32
//   decay = exp(cum_last)
// with x (B, S, H, P) dt-scaled inputs, a (B, S, H) f32 log-decays, and B, C
// (B, S, N) shared by all heads (one group).  y is written in x's type (the
// reference rounds y_diag there too); everything else is f32.  For j > i,
// exp(cum_i - cum_j) may overflow to inf, and inf * 0 is NaN: the kernel
// selects 0 there (the exponent of a masked entry is -inf, so no inf is
// ever formed), as the reference's jnp.where does (kernel.py:41).
//
// Bound: operations.  Per chunk, C B^T costs l (l + 1) N flops over its
// lower triangle, once for all heads, and each head l (l + 1) P for y and
// 2 l N P for the state: at l = 128, N = 128, P = 64 and 48 heads some 50
// flops a byte moved, above the ~20 at which f32 arithmetic (67 TFLOP/s
// on the CUDA cores) and not HBM (3.35 TB/s) is the limit.  What the
// design does about it:
//   * One block of 16 warps per (head group of kGroup = 6 heads, chunk, b):
//     at mamba2-780m (48 heads, 16 chunks of 128) 128 blocks, one wave on
//     132 SMs (`scripts/ssd_chunk_variants.py` times 4 and 8 heads a block
//     and 8 warps against it).  G_s = C B^T is built once per block into
//     shared memory (16 x 16 tiles of its lower triangle) and serves the
//     block's 6 heads; C is dead after that, and its shared memory holds x.
//   * Products on the tensor cores in 3xTF32: `mma.sync.m16n8k8.tf32`, each
//     f32 operand split into hi = tf32(v) and lo = tf32(v - hi) (round to
//     nearest, low 13 mantissa bits cleared), and hi*lo + lo*hi + hi*hi
//     summed in f32 accumulators.  That keeps f32 accuracy (|y| ~ 10 within
//     1e-3); one TF32 product (about 1e-3 relative) would not.
//   * Per head: y = (G_s o L_h) x_h over the lower-triangle k-steps only,
//     the decay mask exp2(cum2_i - cum2_j) applied while the A operand is
//     formed (cum2 = cum * log2 e); state = (B o w_h)^T x_h, w_h =
//     exp(cum_last - cum) per row.  y's units (16 rows x 32 columns) go to
//     the warps longest first, in a snake, so that where they outnumber the
//     warps a long row of the triangle pairs with a short one.  The next
//     head's x streams in by `cp.async` (f32) while this head is computed.
//   * The cumsum of every head of the group is a warp scan (shuffles).
//   * Shared memory rows are padded so that each mma fragment load hits 32
//     distinct banks: 4 * (lp (Np + 8) + lp (lp + 4) + max(lp (Np + 4),
//     2 lp (Pp + 8)) + 2 kGroup lp) bytes with lp, Np the chunk and N
//     rounded up to 16 and Pp P rounded up to 32 (`ssd_chunk_smem_bytes`;
//     the tiling model reports the same number).  At N = 128, P = 64 that
//     is 217,088 bytes for l = 128 (one block per SM) and 92,160 for
//     l = 64; l = 256 needs 565,248, more than a block's 232,448, so the
//     tuner excludes it under a CUDA spec (the TPU kernel's VMEM held it).
//
// bf16 x, B and C are converted to f32 as they are loaded (by plain loads)
// and take the same path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 6;                // heads per block
constexpr int kYTiles = 4;               // 8-column mma tiles of a warp's y unit
constexpr int kStTiles = 4;              // 8-column mma tiles of a warp's state unit
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Padded sizes and shared-memory row strides (floats).
struct Dims {
  int l, lp, N, Np, P, Pp, ldB, ldC, ldG, ldX;
  __host__ __device__ Dims(int l_, int N_, int P_)
      : l(l_), lp(round_up(l_, 16)), N(N_), Np(round_up(N_, 16)), P(P_), Pp(round_up(P_, 32)),
        ldB(Np + 8), ldC(Np + 4), ldG(lp + 4), ldX(Pp + 8) {}
  __host__ __device__ int union_floats() const {
    return lp * ldC > 2 * lp * ldX ? lp * ldC : 2 * lp * ldX;
  }
  __host__ __device__ size_t floats() const {
    return (size_t)lp * ldB + (size_t)lp * ldG + 2 * kGroup * lp + union_floats();
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// hi = tf32(v), lo = tf32(v - hi): round to nearest, low 13 mantissa bits clear
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const float (&b)[2]) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b[0], bh0, bl0);
  split_tf32(b[1], bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
}

// dst[r][c] (row stride ld) = src[r * stride + c] for r < rows, c < cols, and
// 0 for the padding up to rows_p x cols_p.  f32 rows of whole 16-byte chunks
// go by cp.async (the caller commits and waits); the rest by plain loads.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, long long stride, int rows,
                          int cols, int rows_p, int cols_p) {
  const int tid = threadIdx.x;
  int done = 0;                          // columns copied asynchronously
  if constexpr (sizeof(T) == 4) {
    if (cols % 4 == 0 && stride % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      const int c4 = cols / 4;
      for (int i = tid; i < rows * c4; i += kThreads) {
        const int r = i / c4, c = i % c4;
        cp_async16(smem_u32(dst + r * ld + 4 * c), src + r * stride + 4 * c);
      }
      done = cols;
    }
  }
  const int w = cols_p - done;
  for (int i = tid; i < rows * w; i += kThreads) {
    const int r = i / w, c = done + i % w;
    dst[r * ld + c] = c < cols ? to_f32(src[r * stride + c]) : 0.f;
  }
  for (int i = tid; i < (rows_p - rows) * cols_p; i += kThreads)
    dst[(rows + i / cols_p) * ld + i % cols_p] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decay,
                 float* __restrict__ cum_out, int S, int H, int P, int N, int l) {
  extern __shared__ __align__(16) float smem[];
  const Dims d(l, N, P);
  float* Bs = smem;                          // lp x ldB
  float* Gs = Bs + d.lp * d.ldB;             // lp x ldG: C B^T
  float* cum_s = Gs + d.lp * d.ldG;          // kGroup x lp: cum * log2 e
  float* w_s = cum_s + kGroup * d.lp;        // kGroup x lp: exp(cum_last - cum), 0 past l
  float* Cs = w_s + kGroup * d.lp;           // lp x ldC, until G_s is built
  float* xb[2] = {Cs, Cs + d.lp * d.ldX};    // then two lp x ldX buffers of x

  const int h0 = blockIdx.x * kGroup, c = blockIdx.y, b = blockIdx.z;
  const int nh = min(kGroup, H - h0), nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)b * S + (long long)c * l;   // first step of the chunk
  const long long ch0 = ((long long)b * nc + c) * H + h0;      // (b, c, h0) index
  const long long xstride = (long long)H * P;

  load_tile(Bs, d.ldB, Bm + row0 * N, N, l, N, d.lp, d.Np);
  load_tile(Cs, d.ldC, Cm + row0 * N, N, l, N, d.lp, d.Np);
  cp_async_commit();

  // cum of each head of the group: one warp per head, 32 steps per round
  if (warp < nh) {
    const int h = h0 + warp;
    float* cs = cum_s + warp * d.lp;
    float carry = 0.f;
    for (int r0 = 0; r0 < d.lp; r0 += 32) {
      const int r = r0 + lane;
      float v = r < l ? a[(row0 + r) * H + h] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (r < d.lp) cs[r] = v;              // padded steps hold the chunk's total
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    const float last = carry;
    for (int r = lane; r < d.lp; r += 32) {   // the entries this lane wrote
      const float v = cs[r];
      if (r < l) cum_out[(ch0 + warp) * l + r] = v;
      w_s[warp * d.lp + r] = r < l ? expf(last - v) : 0.f;
      cs[r] = v * kLog2e;
    }
    if (lane == 0) decay[ch0 + warp] = expf(last);
  }
  cp_async_wait<0>();
  __syncthreads();

  // G_s = C B^T over the lower triangle of 16 x 16 tiles (diagonal tiles whole)
  const int R = d.lp / 16;
  for (int u = warp; u < R * (R + 1) / 2; u += kWarps) {
    int ti = 0, tj = u;
    while (tj > ti) tj -= ++ti;
    float acc[2][4] = {};
    const float* ca = Cs + (16 * ti + g) * d.ldC + t;
    const float* bb = Bs + (16 * tj + g) * d.ldB + t;
    for (int k0 = 0; k0 < d.Np; k0 += 8) {
      const float av[4] = {ca[k0], ca[8 * d.ldC + k0], ca[k0 + 4], ca[8 * d.ldC + k0 + 4]};
      uint32_t ah[4], al[4];
      split4(av, ah, al);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float bv[2] = {bb[8 * nt * d.ldB + k0], bb[8 * nt * d.ldB + k0 + 4]};
        mma_3xtf32(acc[nt], ah, al, bv);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* gr = Gs + (16 * ti + g) * d.ldG + 16 * tj + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(gr) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(gr + 8 * d.ldG) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();                            // C is dead: its rows now hold x

  load_tile(xb[0], d.ldX, x + row0 * xstride + (long long)h0 * P, xstride, l, P, d.lp, d.Pp);
  cp_async_commit();
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    if (hh + 1 < nh) {
      load_tile(xb[(hh + 1) & 1], d.ldX, x + row0 * xstride + (long long)(h + 1) * P, xstride,
                l, P, d.lp, d.Pp);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = xb[hh & 1];
    const float* cs = cum_s + hh * d.lp;
    const float* ws = w_s + hh * d.lp;

    // y: units (16-row tile, 8 kYTiles columns) by decreasing length of their
    // k range, dealt to the warps in a snake, so each warp's total is even
    const int CT = d.Pp / (8 * kYTiles);
    for (int k = 0; k < R * CT; ++k) {
      const int round = k / kWarps, pos = k % kWarps;
      if ((round & 1 ? kWarps - 1 - pos : pos) != warp) continue;
      const int i0 = 16 * (R - 1 - k / CT), p0 = 8 * kYTiles * (k % CT);
      const int ia = i0 + g, ib = ia + 8;     // this lane's rows
      const float cia = cs[ia], cib = cs[ib];
      const float* ga = Gs + ia * d.ldG;
      const float* gb = Gs + ib * d.ldG;
      float acc[kYTiles][4] = {};
      for (int j0 = 0; j0 < i0 + 16; j0 += 8) {
        const int ja = j0 + t, jb = ja + 4;
        const float cja = cs[ja], cjb = cs[jb];
        const float av[4] = {ga[ja] * fast_exp2(ja <= ia ? cia - cja : -INFINITY),
                             gb[ja] * fast_exp2(ja <= ib ? cib - cja : -INFINITY),
                             ga[jb] * fast_exp2(jb <= ia ? cia - cjb : -INFINITY),
                             gb[jb] * fast_exp2(jb <= ib ? cib - cjb : -INFINITY)};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        const float* xa = xs + ja * d.ldX + p0 + g;
        const float* xc = xs + jb * d.ldX + p0 + g;
#pragma unroll
        for (int nt = 0; nt < kYTiles; ++nt) {
          const float bv[2] = {xa[8 * nt], xc[8 * nt]};
          mma_3xtf32(acc[nt], ah, al, bv);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kYTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, p = p0 + 8 * nt + 2 * t + (e & 1);
          if (i < l && p < P) y[((row0 + i) * H + h) * P + p] = from_f32<T>(acc[nt][e]);
        }
    }

    // state[n][p] = sum_i B[i][n] w_i x[i][p]: units (16 rows of n, 8 kStTiles
    // columns)
    float* st = states + (ch0 + hh) * N * P;
    const int CS = d.Pp / (8 * kStTiles);
    for (int u = warp; u < (d.Np / 16) * CS; u += kWarps) {
      const int n0 = 16 * (u / CS), p0 = 8 * kStTiles * (u % CS);
      float acc[kStTiles][4] = {};
      for (int k0 = 0; k0 < d.lp; k0 += 8) {
        const int ia = k0 + t, ib = ia + 4;
        const float wa = ws[ia], wb = ws[ib];
        const float* ba = Bs + ia * d.ldB + n0 + g;
        const float* bb = Bs + ib * d.ldB + n0 + g;
        const float av[4] = {ba[0] * wa, ba[8] * wa, bb[0] * wb, bb[8] * wb};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        const float* xa = xs + ia * d.ldX + p0 + g;
        const float* xc = xs + ib * d.ldX + p0 + g;
#pragma unroll
        for (int nt = 0; nt < kStTiles; ++nt) {
          const float bv[2] = {xa[8 * nt], xc[8 * nt]};
          mma_3xtf32(acc[nt], ah, al, bv);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kStTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + g + (e < 2 ? 0 : 8), p = p0 + 8 * nt + 2 * t + (e & 1);
          if (n < N && p < P) st[n * P + p] = acc[nt][e];
        }
    }
    __syncthreads();                          // x of this head is free for head hh + 2
  }
}

size_t smem_bytes(int l, int N, int P) { return sizeof(float) * Dims(l, N, P).floats(); }

template <typename T>
cudaError_t launch_typed(const void* x, const float* a, const void* Bm, const void* Cm,
                         void* y, float* states, float* decay, float* cum, int B, int S,
                         int H, int P, int N, int l, cudaStream_t stream) {
  const size_t smem = smem_bytes(l, N, P);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ssd_chunk_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((H + kGroup - 1) / kGroup, S / l, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), states, decay, cum, S, H, P, N, l);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block takes at (chunk l, N, P), in bytes.
long long ssd_chunk_smem_bytes(int l, int N, int P) {
  return (long long)smem_bytes(l, N, P);
}

// Launch on `stream`.  x (B, S, H, P), Bm/Cm (B, S, N) contiguous in one
// type (bf16 when `bf16`, else f32); a (B, S, H) f32; outputs y (B, S, H, P)
// in x's type, states (B, S/l, H, N, P), decay (B, S/l, H), cum (B, S/l, H, l)
// f32.  l must divide S.  Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape or shared-memory size out of range.
int ssd_chunk_launch(const void* x, const void* a, const void* Bm, const void* Cm, void* y,
                     void* states, void* decay, void* cum, int B, int S, int H, int P, int N,
                     int l, int bf16, void* stream) {
  if (B < 1 || H < 1 || P < 1 || N < 1 || l < 1 || S < l || S % l)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float *st = static_cast<float*>(states), *dc = static_cast<float*>(decay),
        *cm = static_cast<float*>(cum);
  cudaError_t e = bf16 ? launch_typed<__nv_bfloat16>(x, af, Bm, Cm, y, st, dc, cm, B, S, H,
                                                     P, N, l, s)
                       : launch_typed<float>(x, af, Bm, Cm, y, st, dc, cm, B, S, H, P, N,
                                             l, s);
  return (int)e;
}

}  // extern "C"
