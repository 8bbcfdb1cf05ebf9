// Blockwise flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` (`_attn_body`) in
// src/repro/kernels/flash_attention/kernel.py.
//
// What it computes: o = softmax(q k^T * scale + mask) v for q (B, H, Sq, Dh)
// and k, v (B, Hkv, Sk, Dh), one type for all three (f32 or bf16), o in that
// type.  GQA: query head h reads KV head h / (H / Hkv).  The causal mask
// keeps key j for query row i iff q_offset + i >= j, and a masked score is
// the finite -1e30, as in the reference: a row with no visible key
// (q_offset + i < 0) gives every key the weight exp(0) = 1 and returns the
// mean of V.  There is no l == 0 case: the row maximum always contributes 1.
// Scores, the running max m and sum l and the accumulator are f32.
//
// Layout.  One block of 256 threads per (q-block, h, b); grid
// (Sq / block_q, H, B).  The TPU kernel kept a head's whole K and V in VMEM
// (kernel.py:101-102); a Hopper block has 227 KB of shared memory, so this
// kernel streams them instead, with its own tile:
//   * the block walks its block_q query rows in passes of kRows = 64; a
//     pass holds its q rows (pre-scaled, f32) in shared memory;
//   * block_k is the online-softmax step, as in the TPU kernel's fori_loop:
//     for each step the block computes a 64 x block_k f32 score strip in
//     shared memory, staging K through a kKeys = 64 row buffer; then one
//     warp per 8 rows takes the strip's max, turns it into probabilities,
//     sums them and records the rescale factor; then P V is accumulated
//     with V staged through the same buffer;
//   * each thread owns a 4-row x 4-key tile of the strip and a 4-row x
//     Dh/16 tile of the accumulator, in registers; shared rows are padded
//     to Dh + 1 and block_k + 1 floats, so no access has a bank conflict;
//   * under the causal mask a pass whose rows all see key 0 stops at the
//     step that holds its last visible key: the later steps are masked for
//     every row, and since each row's maximum is a real score they would
//     add exactly 0.  A pass with a fully masked row reads every step, so
//     that row averages all of V as the reference does.
// Shared memory per block: 4 * (64 (Dh+1) + 64 (Dh+1) + 64 (block_k+1) + 192)
// bytes (`flash_attention_smem_bytes`; the tiling model reports the same
// number and the tuner rejects configs above 232,448 bytes).
//
// Bound: operations.  Causal prefill does 2 B H Sq Sk Dh flops on
// 2 B (H Sq + Hkv Sk) Dh elements, thousands of flops per byte.  This first
// kernel runs scalar f32 FMAs from shared memory (no wgmma, no TMA, no
// pipelining), so it is far from the bf16 tensor-core bound; the design
// that closes on it is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                // query rows per pass
constexpr int kKeys = 64;                // keys per K/V stage
constexpr int kTR = 4;                   // rows per thread
constexpr int kTC = kKeys / 16;          // keys per thread in a stage
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int Dh, int block_k) {
  return sizeof(float) * ((size_t)kRows * (Dh + 1) + (size_t)kKeys * (Dh + 1) +
                          (size_t)kRows * (block_k + 1) + 3 * kRows);
}

// rows [0, n) of a (rows, DH) tile at src -> dst (stride DH + 1), f32;
// rows n..kKeys-1 are zero
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < kKeys * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 1) + d] = r < n ? to_f32(src[(size_t)r * DH + d]) : 0.f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H, int Hkv,
                       int Sq, int Sk, int block_q, int block_k, int causal, int q_offset,
                       float scale) {
  constexpr int LD = DH + 1;
  constexpr int DPT = DH / 16;           // accumulator columns per thread
  extern __shared__ float smem[];
  const int ldS = block_k + 1;
  float* Qs = smem;                      // kRows x LD
  float* KVs = Qs + kRows * LD;          // kKeys x LD
  float* Ss = KVs + kKeys * LD;          // kRows x ldS
  float* m_s = Ss + kRows * ldS;         // kRows
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const T* qh = q + (size_t)(b * H + h) * Sq * DH;
  const T* kh = k + (size_t)(b * Hkv + hk) * Sk * DH;
  const T* vh = v + (size_t)(b * Hkv + hk) * Sk * DH;
  T* oh = out + (size_t)(b * H + h) * Sq * DH;

  const int row_begin = blockIdx.x * block_q;
  const int row_end = min(row_begin + block_q, Sq);
  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    const int nr = min(kRows, row_end - r0);
    for (int i = tid; i < kRows * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      Qs[r * LD + d] = r < nr ? to_f32(qh[(size_t)(r0 + r) * DH + d]) * scale : 0.f;
    }
    for (int r = tid; r < kRows; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }
    float acc[kTR][DPT];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

    int k_end = Sk;
    if (causal && q_offset + r0 >= 0) k_end = min(Sk, q_offset + r0 + nr);
    for (int k0 = 0; k0 < k_end; k0 += block_k) {
      const int w = min(block_k, Sk - k0);
      // 1. the score strip S[r][c] = q_r . k_(k0+c), masked
      for (int p0 = 0; p0 < w; p0 += kKeys) {
        const int pw = min(kKeys, w - p0);
        __syncthreads();                   // KVs free (and Qs, m_s, l_s written)
        stage<T, DH>(KVs, kh + (size_t)(k0 + p0) * DH, pw);
        __syncthreads();
        float s[kTR][kTC];
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTC; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DH; ++d) {
          float qv[kTR], kv[kTC];
#pragma unroll
          for (int i = 0; i < kTR; ++i) qv[i] = Qs[(tr * kTR + i) * LD + d];
#pragma unroll
          for (int j = 0; j < kTC; ++j) kv[j] = KVs[(tc + 16 * j) * LD + d];
#pragma unroll
          for (int i = 0; i < kTR; ++i)
#pragma unroll
            for (int j = 0; j < kTC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const int r = tr * kTR + i;
#pragma unroll
          for (int j = 0; j < kTC; ++j) {
            const int c = tc + 16 * j;
            if (c < pw) {
              const bool masked = causal && (q_offset + r0 + r < k0 + p0 + c);
              Ss[r * ldS + p0 + c] = masked ? kNegInf : s[i][j];
            }
          }
        }
      }
      __syncthreads();
      // 2. online softmax over the step: one warp per 8 rows
      for (int rr = 0; rr < kRows / kWarps; ++rr) {
        const int r = warp * (kRows / kWarps) + rr;
        float* row = Ss + r * ldS;
        float mx = kNegInf;
        for (int c = lane; c < w; c += 32) mx = fmaxf(mx, row[c]);
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int c = lane; c < w; c += 32) {
          const float p = __expf(row[c] - m_new);
          row[c] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = __expf(m_prev - m_new);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const float alpha = a_s[tr * kTR + i];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      }
      // 3. acc += P V, V staged through the same buffer
      for (int p0 = 0; p0 < w; p0 += kKeys) {
        const int pw = min(kKeys, w - p0);
        __syncthreads();
        stage<T, DH>(KVs, vh + (size_t)(k0 + p0) * DH, pw);
        __syncthreads();
        for (int c = 0; c < pw; ++c) {
          float pv[kTR];
#pragma unroll
          for (int i = 0; i < kTR; ++i) pv[i] = Ss[(tr * kTR + i) * ldS + p0 + c];
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            const float vv = KVs[c * LD + tc + 16 * j];
#pragma unroll
            for (int i = 0; i < kTR; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();                       // l_s final
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = tr * kTR + i;
      if (r < nr) {
        const float inv = 1.f / l_s[r];
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          oh[(size_t)(r0 + r) * DH + tc + 16 * j] = from_f32<T>(acc[i][j] * inv);
      }
    }
    __syncthreads();                       // before the next pass rewrites Qs, m_s, l_s
  }
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out, int B, int H,
                      int Hkv, int Sq, int Sk, int block_q, int block_k, int causal,
                      int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(DH, block_k);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + block_q - 1) / block_q, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hkv, Sq, Sk, block_q, block_k, causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int Dh, const void* q, const void* k, const void* v, void* out,
                         int B, int H, int Hkv, int Sq, int Sk, int block_q, int block_k,
                         int causal, int q_offset, float scale, cudaStream_t stream) {
  if (Dh == 128)
    return launch_dh<T, 128>(q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k, causal,
                             q_offset, scale, stream);
  if (Dh == 64)
    return launch_dh<T, 64>(q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k, causal,
                            q_offset, scale, stream);
  if (Dh == 32)
    return launch_dh<T, 32>(q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k, causal,
                            q_offset, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one block takes at (Dh, block_k), in bytes.
long long flash_attention_smem_bytes(int Dh, int block_k) {
  return (long long)smem_bytes(Dh, block_k);
}

// Launch on `stream`.  q/out (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh), contiguous,
// one type (bf16 when `bf16`, else f32); Dh in {32, 64, 128}; block_q >= 1
// query rows per block, block_k >= 1 keys per softmax step.  Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue when the shape
// or the shared memory (block_k) is out of range.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B,
                           int H, int Hkv, int Sq, int Sk, int Dh, int block_q, int block_k,
                           int causal, int q_offset, float scale, int bf16, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 || block_q < 1 ||
      block_k < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16)
    e = launch_typed<__nv_bfloat16>(Dh, q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k,
                                    causal, q_offset, scale, s);
  else
    e = launch_typed<float>(Dh, q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k, causal,
                            q_offset, scale, s);
  return (int)e;
}

}  // extern "C"
