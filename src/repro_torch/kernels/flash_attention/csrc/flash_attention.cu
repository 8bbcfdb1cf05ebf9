// Blockwise flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` (`_attn_body`) in
// src/repro/kernels/flash_attention/kernel.py.
//
// What it computes: o = softmax(q k^T * scale + mask) v for q (B, H, Sq, Dh)
// and k, v (B, Hkv, Sk, Dh), one type for all three (bf16 or f32), o in that
// type.  GQA: query head h reads KV head h / (H / Hkv).  The causal mask
// keeps key j for query row i iff q_offset + i >= j, and a masked score is
// the finite -1e30, as in the reference: a row with no visible key
// (q_offset + i < 0) gives every key the weight exp(0) = 1 and returns the
// mean of V.  Scores, the running max m and sum l and the accumulator are
// f32.  One block per (q-block of block_q rows, head, batch).
//
// Bound: operations.  Causal prefill does 2 B H Sq Sk Dh flops on
// 2 B (H Sq + Hkv Sk) Dh elements, thousands of flops per byte, so the
// tensor cores' bf16 rate (989 TFLOP/s) is the bound for bf16 inputs.
//
// bf16 inputs: `flash_attention_bf16_kernel`, on the tensor cores.
//   * Two consumer warpgroups of 64 query rows each (a 128-row pass; the
//     block walks its block_q rows in passes) and one producer warpgroup,
//     whose one working thread starts the TMA loads; `setmaxnreg` moves
//     the producer's registers to the consumers (24 and 240 a thread), so
//     the score and output accumulators and P stay in registers without
//     spilling.  Q of the pass is loaded once into shared memory by TMA.
//   * K and V stream through a ring of kStages tiles of BN keys each
//     (BN = 64 for block_k <= 64, else 128: `kv_tile`), loaded by TMA from
//     3-D tensor maps (Dh, S, B*heads) and signalled by mbarriers (full:
//     bytes landed; empty: all 256 consumer threads are done with the
//     tile); the two warpgroups never wait for each other, so one's
//     softmax runs while the other's products do.  A box never crosses into the next head: keys past Sk read as
//     zero, and their columns are dropped (score -inf, weight exactly 0),
//     so a fully masked row still averages exactly Sk rows of V.
//   * S = Q K^T is a `wgmma` (bf16 in, f32 accumulate) into registers;
//     scale, mask, the running max and sum and the rescale of the
//     accumulator stay in registers (no score strip in shared memory).
//   * O += P V is a second `wgmma` with P from registers as the A operand
//     and V (N-major) from shared memory.  P enters as two bf16 terms,
//     P_hi = bf16(P) and P_lo = bf16(P - P_hi), two `wgmma`s into the same
//     accumulator: a single bf16 P would move outputs near |o| = 2 by a
//     bf16 ulp of 0.0156, beyond the 1e-2 gate.  That costs 1.5x the
//     tensor-core work of the plain algorithm.
//   * Shared memory: 1024 B of alignment slack, the Q pass (128 x Dh),
//     kStages K and V tiles (BN x Dh each), all bf16, and 128 B of
//     mbarriers (`flash_attention_smem_bytes`; the tiling model reports
//     the same number).  Tiles are 128-byte swizzled (64-byte at Dh 32),
//     the layout both TMA and `wgmma` read without bank conflicts.
//   * The causal early stop: a pass whose rows all see key 0 stops at the
//     tile that holds its last visible key, and each warpgroup skips the
//     tiles masked for all of its rows (masked terms add exactly 0 once a
//     row's maximum is a real score).  A pass with a fully masked row
//     reads every tile, so that row averages all of V.
//
// f32 inputs: `flash_attention_f32_kernel`, scalar f32 FMAs on the CUDA
// cores (no tensor-core path keeps f32 to the 1e-4 gate; TF32 keeps about
// three digits).  256 threads; the block walks its rows in 64-row passes
// (q pre-scaled, f32, in shared memory); block_k is the online-softmax
// step, a 64 x block_k f32 score strip in shared memory, K and V staged
// through one 64-row buffer.  Shared memory 4 * (64 (Dh+1) + 64 (Dh+1) +
// 64 (block_k+1) + 192) bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;

// ---------------------------------------------------------------------------
// f32: scalar kernel on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                // query rows per pass
constexpr int kKeys = 64;                // keys per K/V stage
constexpr int kTR = 4;                   // rows per thread
constexpr int kTC = kKeys / 16;          // keys per thread in a stage

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t f32_smem_bytes(int Dh, int block_k) {
  return sizeof(float) * ((size_t)kRows * (Dh + 1) + (size_t)kKeys * (Dh + 1) +
                          (size_t)kRows * (block_k + 1) + 3 * kRows);
}

// rows [0, n) of a (rows, DH) tile at src -> dst (stride DH + 1);
// rows n..kKeys-1 are zero
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < kKeys * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 1) + d] = r < n ? src[(size_t)r * DH + d] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int H,
                           int Hkv, int Sq, int Sk, int block_q, int block_k, int causal,
                           int q_offset, float scale) {
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
  const float* qh = q + (size_t)(b * H + h) * Sq * DH;
  const float* kh = k + (size_t)(b * Hkv + hk) * Sk * DH;
  const float* vh = v + (size_t)(b * Hkv + hk) * Sk * DH;
  float* oh = out + (size_t)(b * H + h) * Sq * DH;

  const int row_begin = blockIdx.x * block_q;
  const int row_end = min(row_begin + block_q, Sq);
  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    const int nr = min(kRows, row_end - r0);
    for (int i = tid; i < kRows * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      Qs[r * LD + d] = r < nr ? qh[(size_t)(r0 + r) * DH + d] * scale : 0.f;
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
        stage<DH>(KVs, kh + (size_t)(k0 + p0) * DH, pw);
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
        stage<DH>(KVs, vh + (size_t)(k0 + p0) * DH, pw);
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
          oh[(size_t)(r0 + r) * DH + tc + 16 * j] = acc[i][j] * inv;
      }
    }
    __syncthreads();                       // before the next pass rewrites Qs, m_s, l_s
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H,
                       int Hkv, int Sq, int Sk, int block_q, int block_k, int causal,
                       int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(DH, block_k);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = flash_attention_f32_kernel<DH>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + block_q - 1) / block_q, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Hkv, Sq, Sk, block_q,
      block_k, causal, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA and an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kWG = 2;                        // consumer warpgroups
constexpr int kPassRows = 64 * kWG;           // query rows per pass
constexpr int kConsumers = 128 * kWG;
constexpr int kTCThreads = kConsumers + 128;  // + one producer warpgroup
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kBarBytes = 128;                // 2 + 4 * kStages mbarriers

int kv_tile(int block_k) { return block_k <= 64 ? 64 : 128; }

size_t bf16_smem_bytes(int Dh, int bn) {
  return 1024 + 2 * ((size_t)kPassRows * Dh + 2 * (size_t)kStages * bn * Dh) + kBarBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed; a phase that
// never completes (a fault in the ring's bookkeeping) traps after about ten
// seconds instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all >> 4), swizzle mode (128 B -> 1, 64 B -> 2)
template <int SW>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// (p0, p1) -> bf16 pair hi and the bf16 pair of what hi misses, lo
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  // d(64 x 32) += a(64 x 16) b(16 x 32); a in registers, b in shared memory, N-major
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct Wgmma<64> {
  // d(64 x 64) = [d +] a(64 x 16) b(16 x 64); a and b in shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc)
        : "memory");
  }
  // d(64 x 64) += a(64 x 16) b(16 x 64); a in registers, b in shared memory, N-major
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct Wgmma<128> {
  // d(64 x 128) = [d +] a(64 x 16) b(16 x 128); a and b in shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc)
        : "memory");
  }
  // d(64 x 128) += a(64 x 16) b(16 x 128); a in registers, b in shared memory, N-major
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

// The 128-row pass starting at row r0 (nr valid rows) reads keys [0, kv_end).
__device__ __forceinline__ int kv_end(int r0, int nr, int Sk, int causal, int q_offset) {
  return (causal && q_offset + r0 >= 0) ? min(Sk, q_offset + r0 + nr) : Sk;
}

template <int DH, int BN>
__global__ void __launch_bounds__(kTCThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ out, int H, int Hkv, int Sq, int Sk,
                            int block_q, int causal, int q_offset, float scale_log2) {
  constexpr int SW = DH >= 64 ? 128 : 64;    // swizzle span = bytes of one tile row
  constexpr int ATOM = SW / 2;               // head-dim columns per swizzle atom
  constexpr int NATOM = DH / ATOM;
  constexpr int KPA = ATOM / 16;             // k16 steps per atom
  constexpr uint32_t Q_BYTES = kPassRows * DH * 2;
  constexpr uint32_t KV_BYTES = BN * DH * 2;
  constexpr int NS = BN / 2;                 // score registers per thread
  constexpr int NO = DH / 2;                 // accumulator registers per thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                  // [NATOM][kPassRows][ATOM]
  const uint32_t sK = sQ + Q_BYTES;          // kStages x [NATOM][BN][ATOM]
  const uint32_t sV = sK + kStages * KV_BYTES;
  const uint32_t sBar = sV + kStages * KV_BYTES;
  const uint32_t q_full = sBar, q_empty = sBar + 8;
  auto k_full = [&](int s) { return sBar + 16 + 8 * s; };
  auto k_empty = [&](int s) { return sBar + 16 + 8 * (kStages + s); };
  auto v_full = [&](int s) { return sBar + 16 + 8 * (2 * kStages + s); };
  auto v_empty = [&](int s) { return sBar + 16 + 8 * (3 * kStages + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // q-blocks in the slowest grid dimension, the last (under the causal
  // mask the heaviest) first
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int row_begin = qb * block_q;
  const int row_end = min(row_begin + block_q, Sq);
  const int n_pass = (row_end - row_begin + kPassRows - 1) / kPassRows;

  if (tid >= kConsumers) {
    // producer warpgroup: gives its registers to the consumers; one thread
    // keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == kConsumers) {
      int it = 0;
      for (int p = 0; p < n_pass; ++p) {
        const int r0 = row_begin + p * kPassRows;
        const int n_tiles =
            (kv_end(r0, min(kPassRows, row_end - r0), Sk, causal, q_offset) + BN - 1) / BN;
        mbar_wait(q_empty, (p & 1) ^ 1);
        mbar_expect_tx(q_full, Q_BYTES);
        for (int a = 0; a < NATOM; ++a)
          tma_load(sQ + a * kPassRows * SW, &tm_q, q_full, a * ATOM, r0, b * H + h);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % kStages;
          const uint32_t ph = ((it / kStages) & 1) ^ 1;
          mbar_wait(k_empty(s), ph);
          mbar_expect_tx(k_full(s), KV_BYTES);
          for (int a = 0; a < NATOM; ++a)
            tma_load(sK + s * KV_BYTES + a * BN * SW, &tm_k, k_full(s), a * ATOM, t * BN,
                     b * Hkv + hk);
          mbar_wait(v_empty(s), ph);
          mbar_expect_tx(v_full(s), KV_BYTES);
          for (int a = 0; a < NATOM; ++a)
            tma_load(sV + s * KV_BYTES + a * BN * SW, &tm_v, v_full(s), a * ATOM, t * BN,
                     b * Hkv + hk);
        }
      }
    }
  } else {
    // consumer warpgroups: take the producer's registers.  Warpgroup wg
    // owns rows [64 wg, 64 wg + 64) of each pass; a thread holds rows g and
    // g + 8 of its warp's 16 (the wgmma layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    __nv_bfloat16* oh = out + (size_t)(b * H + h) * Sq * DH;
    int it = 0;
    for (int p = 0; p < n_pass; ++p) {
      const int r0 = row_begin + p * kPassRows;
      const int n_tiles =
          (kv_end(r0, min(kPassRows, row_end - r0), Sk, causal, q_offset) + BN - 1) / BN;
      const int wr0 = r0 + 64 * wg;                      // the warpgroup's first row
      const int wnr = min(64, row_end - wr0);            // its valid rows (may be <= 0)
      const int w_tiles =
          wnr > 0 ? (kv_end(wr0, wnr, Sk, causal, q_offset) + BN - 1) / BN : 0;
      const int lr_a = 16 * warp + g, lr_b = lr_a + 8;   // rows within the warpgroup
      const int pos_a = q_offset + wr0 + lr_a, pos_b = pos_a + 8;
      float o[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
      mbar_wait(q_full, p & 1);
      if (w_tiles == 0) mbar_arrive(q_empty);
      const uint32_t sQw = sQ + wg * 64 * SW;
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        mbar_wait(k_full(s), ph);
        if (t >= w_tiles) {                // masked for every row of this warpgroup
          mbar_arrive(k_empty(s));
          mbar_wait(v_full(s), ph);
          mbar_arrive(v_empty(s));
          continue;
        }
        // S = Q K^T
        float sc[NS];
        const uint32_t sKs = sK + s * KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t off = (kk % KPA) * 32;
          Wgmma<BN>::ss(sc,
                        gmma_desc<SW>(sQw + (kk / KPA) * kPassRows * SW + off, 16, 8 * SW),
                        gmma_desc<SW>(sKs + (kk / KPA) * BN * SW + off, 16, 8 * SW), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        mbar_arrive(k_empty(s));
        if (t == w_tiles - 1) mbar_arrive(q_empty);

        // scale (log2 domain), mask, online softmax
        const int k0 = t * BN;
        const bool edge = k0 + BN > Sk;
        const bool diag = causal && k0 + BN - 1 > q_offset + wr0;
        const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
        float mx_a = neg_inf, mx_b = neg_inf;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float va = sc[4 * j + e] * scale_log2, vb = sc[4 * j + 2 + e] * scale_log2;
            if (edge || diag) {
              const int key = k0 + 8 * j + 2 * t4 + e;
              if (key >= Sk) {
                va = vb = neg_inf;          // past the last key: no weight at all
              } else if (causal) {
                if (key > pos_a) va = kNegInf;
                if (key > pos_b) vb = kNegInf;
              }
            }
            sc[4 * j + e] = va;
            sc[4 * j + 2 + e] = vb;
            mx_a = fmaxf(mx_a, va);
            mx_b = fmaxf(mx_b, vb);
          }
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
        uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float pa0 = ex2(sc[4 * j] - mn_a), pa1 = ex2(sc[4 * j + 1] - mn_a);
          const float pb0 = ex2(sc[4 * j + 2] - mn_b), pb1 = ex2(sc[4 * j + 3] - mn_b);
          sum_a += pa0 + pa1;
          sum_b += pb0 + pb1;
          // A fragment of k-step j / 2: regs 0/1 hold keys 0-7 (rows g, g + 8),
          // regs 2/3 keys 8-15
          const int kk = j / 2, r = (j % 2) * 2;
          split_bf16(pa0, pa1, p_hi[kk][r], p_lo[kk][r]);
          split_bf16(pb0, pb1, p_hi[kk][r + 1], p_lo[kk][r + 1]);
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[4 * j] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }

        // O += P_hi V + P_lo V
        mbar_wait(v_full(s), ph);
        const uint32_t sVs = sV + s * KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          Wgmma<DH>::rs(o, p_hi[kk], gmma_desc<SW>(sVs + kk * 16 * SW, BN * SW, 8 * SW));
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          Wgmma<DH>::rs(o, p_lo[kk], gmma_desc<SW>(sVs + kk * 16 * SW, BN * SW, 8 * SW));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        mbar_arrive(v_empty(s));
      }
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (lr_a < wnr)
          *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)(wr0 + lr_a) * DH + col) =
              __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (lr_b < wnr)
          *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)(wr0 + lr_b) * DH + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda.so.1 that the CUDA
// runtime has already loaded (no link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// (Dh, S, heads) bf16 tensor, boxes of (sw / 2, rows, 1), swizzled; reads
// past S fill with zeros
bool make_map(CUtensorMap* map, const void* ptr, int Dh, int S, int heads, int rows, int sw) {
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)Dh * 2, (cuuint64_t)S * Dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)sw / 2, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int BN>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int Hkv, int Sq, int Sk, int block_q, int causal, int q_offset,
                        float scale, cudaStream_t stream) {
  constexpr int SW = DH >= 64 ? 128 : 64;
  if (!encoder()) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, DH, Sq, B * H, kPassRows, SW) ||
      !make_map(&mk, k, DH, Sk, B * Hkv, BN, SW) || !make_map(&mv, v, DH, Sk, B * Hkv, BN, SW))
    return cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes(DH, BN);
  auto kernel = flash_attention_bf16_kernel<DH, BN>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (Sq + block_q - 1) / block_q);
  kernel<<<grid, kTCThreads, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out), H,
                                             Hkv, Sq, Sk, block_q, causal, q_offset,
                                             scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(bool bf16, const void* q, const void* k, const void* v, void* out, int B,
                      int H, int Hkv, int Sq, int Sk, int block_q, int block_k, int causal,
                      int q_offset, float scale, cudaStream_t s) {
  if (!bf16)
    return launch_f32<DH>(q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k, causal, q_offset,
                          scale, s);
  if (kv_tile(block_k) == 64)
    return launch_bf16<DH, 64>(q, k, v, out, B, H, Hkv, Sq, Sk, block_q, causal, q_offset,
                               scale, s);
  return launch_bf16<DH, 128>(q, k, v, out, B, H, Hkv, Sq, Sk, block_q, causal, q_offset,
                              scale, s);
}

}  // namespace

extern "C" {

// Shared memory one block takes at (Dh, block_k) for bf16 (`bf16` != 0) or
// f32 inputs, in bytes.
long long flash_attention_smem_bytes(int Dh, int block_k, int bf16) {
  return (long long)(bf16 ? bf16_smem_bytes(Dh, kv_tile(block_k))
                          : f32_smem_bytes(Dh, block_k));
}

// Launch on `stream`.  q/out (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh), contiguous,
// one type (bf16 when `bf16`, else f32; bf16 tensors 16-byte aligned);
// Dh in {32, 64, 128}; block_q >= 1 query rows per block, block_k >= 1 (f32:
// keys per softmax step; bf16: sets the ring's tile, `kv_tile`).  Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue when the shape,
// the shared memory or a tensor map is out of range.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B,
                           int H, int Hkv, int Sq, int Sk, int Dh, int block_q, int block_k,
                           int causal, int q_offset, float scale, int bf16, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 || block_q < 1 ||
      block_k < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    return (int)launch_dh<128>(bf16, q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k,
                               causal, q_offset, scale, s);
  if (Dh == 64)
    return (int)launch_dh<64>(bf16, q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k,
                              causal, q_offset, scale, s);
  if (Dh == 32)
    return (int)launch_dh<32>(bf16, q, k, v, out, B, H, Hkv, Sq, Sk, block_q, block_k,
                              causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
