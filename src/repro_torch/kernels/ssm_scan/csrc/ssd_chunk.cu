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
// selects 0 there, as the reference's jnp.where does (kernel.py:41).
//
// Layout.  One block of 256 threads per (h, c, b); grid (H, S / l, B), h
// fastest, so the blocks of one chunk that share B and C run together.  The
// block holds B, C (l x N) and x (l x P) as f32 in shared memory, rows padded
// by one float so that no access has a bank conflict, and the chunk's cum.
// y is built 16 rows at a time: a 16 x (i0 + 16) strip of masked, decayed
// scores in shared memory, then the strip times x; the state is one pass
// over the chunk.  Shared memory per block:
// 4 * (2 l (N + 1) + l (P + 1) + l + 16 (l + 1)) bytes (`ssd_chunk_smem_bytes`;
// the tiling model reports the same number).  At N = 128, P = 64 that is
// 174,144 bytes for l = 128; l = 256 needs 348,224, more than a block's
// 232,448, so the tuner excludes it under a CUDA spec (the TPU kernel's
// VMEM held it whole).
//
// Bound: operations, in f32.  A chunk-head needs l (l + 1) (N + P) flops for
// the masked scores and y (the lower triangle only: this kernel skips j > i)
// plus 2 l N P for the state, about 5.3 M at l = 128, N = 128, P = 64, and
// moves about 100 KB (x in, y and the state out, its share of B and C): some
// 50 flops a byte, above the 20 at which the f32 FMA rate (67 TFLOP/s) and
// not HBM (3.35 TB/s) is the limit.  This first kernel runs scalar f32 FMAs
// out of shared memory; no tensor cores, no pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 16;               // y rows per score strip
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int l, int N, int P) {
  return sizeof(float) * (2 * (size_t)l * (N + 1) + (size_t)l * (P + 1) + l +
                          (size_t)kStrip * (l + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                 const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decay,
                 float* __restrict__ cum_out, int S, int H, int P, int N, int l) {
  extern __shared__ float smem[];
  const int ldN = N + 1, ldP = P + 1, ldL = l + 1;
  float* Bs = smem;                      // l x ldN
  float* Cs = Bs + l * ldN;              // l x ldN
  float* xs = Cs + l * ldN;              // l x ldP
  float* cs = xs + l * ldP;              // l
  float* Ss = cs + l;                    // kStrip x ldL

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, tid = threadIdx.x;
  const size_t row0 = (size_t)b * S + (size_t)c * l;     // first step of the chunk
  const size_t ch = ((size_t)b * nc + c) * H + h;        // (b, c, h) index

  for (int i = tid; i < l * N; i += kThreads) {
    const int r = i / N, n = i % N;
    Bs[r * ldN + n] = to_f32(Bm[(row0 + r) * N + n]);
    Cs[r * ldN + n] = to_f32(Cm[(row0 + r) * N + n]);
  }
  for (int i = tid; i < l * P; i += kThreads) {
    const int r = i / P, p = i % P;
    xs[r * ldP + p] = to_f32(x[((row0 + r) * H + h) * P + p]);
  }
  if (tid == 0) {
    float run = 0.f;
    for (int r = 0; r < l; ++r) {
      run += a[(row0 + r) * H + h];
      cs[r] = run;
    }
  }
  __syncthreads();
  const float last = cs[l - 1];
  for (int r = tid; r < l; r += kThreads) cum_out[ch * l + r] = cs[r];
  if (tid == 0) decay[ch] = expf(last);

  // y = ((C B^T) o L) x, kStrip rows at a time
  for (int i0 = 0; i0 < l; i0 += kStrip) {
    const int ni = min(kStrip, l - i0), nj = i0 + ni;
    for (int e = tid; e < ni * nj; e += kThreads) {
      const int i = e / nj, j = e % nj, gi = i0 + i;
      float val = 0.f;
      if (j <= gi) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(Cs[gi * ldN + n], Bs[j * ldN + n], dot);
        val = dot * expf(cs[gi] - cs[j]);
      }
      Ss[i * ldL + j] = val;
    }
    __syncthreads();
    for (int e = tid; e < ni * P; e += kThreads) {
      const int i = e / P, p = e % P, gi = i0 + i;
      float acc = 0.f;
      for (int j = 0; j <= gi; ++j) acc = fmaf(Ss[i * ldL + j], xs[j * ldP + p], acc);
      y[((row0 + gi) * H + h) * P + p] = from_f32<T>(acc);
    }
    __syncthreads();
  }

  // state[n][p] = sum_i B[i][n] exp(last - cum_i) x[i][p]; the weights reuse Ss
  for (int r = tid; r < l; r += kThreads) Ss[r] = expf(last - cs[r]);
  __syncthreads();
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P, p = e % P;
    float acc = 0.f;
    for (int i = 0; i < l; ++i) acc = fmaf(Bs[i * ldN + n] * Ss[i], xs[i * ldP + p], acc);
    states[(ch * N + n) * P + p] = acc;
  }
}

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
  kernel<<<dim3(H, S / l, B), kThreads, smem, stream>>>(
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
