// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_decode_kernel` (`_decode_body` and
// `combine_splits`) in src/repro/kernels/paged_decode/kernel.py.
//
// What it computes: for each batch row b and query head, softmax-weighted
// attention over the row's K/V history, read in place from the block pool
// through `block_table[b, :]`.  Logical position `pos` lives at physical
// token (block_table[b, pos / bs], pos % bs); positions <= cache_len[b] are
// attended (inclusive: the freshly written token at cache_len sees itself).
// All rep = H / Hkv query heads of one KV head share each K/V load (GQA).
// Online softmax in f32 with the finite NEG_INF = -1e30, so a dead split
// underflows to 0 instead of producing NaN; a row whose sum l is 0 divides
// by 1.
//
// Bound: HBM bytes.  A decode step reads 2 * B * Hkv * live_tokens * Dh
// elements of K and V and does 4 flops per element pair per query head
// (rep of them), far below the ~295 flop/byte at which bf16 tensor cores
// would become the limit.  What the design does about it:
//   * it reads only live tokens: split s covers the blocks
//     [s*npb, min((s+1)*npb, cache_len/bs + 1)) and stops at cache_len,
//     where the TPU kernel clamped dead grid steps onto the last live block
//     (kernel.py:140-144);
//   * each K/V row is read once per KV head, for all rep query heads;
//   * 8 lanes share one token: each loads 16 (Dh 128) or 8 (Dh 64)
//     contiguous elements of the token's K and V rows in 16-byte loads, so
//     a warp holds 4 tokens at once, and it issues kUnroll rounds of loads
//     (8 tokens) before it computes, so device-memory latency is covered by
//     loads in flight rather than waited out token by token;
//   * a token's scores reduce in 3 shuffle steps inside its 8-lane group
//     (not 5 across the warp), and the query rows sit in shared memory;
//   * each 8-lane group runs its own online softmax with (m, l, acc) in
//     registers; the groups of a warp merge by shuffles and the 8 warps
//     through shared memory, once per block: no barrier in the token loop;
//   * no gathered (B, NB*bs) view is ever written.
// What it does not do yet: the per-token chain of shuffles, exponentials
// and rescales, not the bytes, sets its time; and at qwen3-4b decode with
// 8 slots and no split the grid (B, Hkv, n_splits) is only 64 blocks for
// 132 SMs.  Splitting the KV axis fills the card and is left to tuning.
//
// Query rows are processed ROWS at a time (rep rounded up to 1, 2 or 4;
// rep > 4 takes ceil(rep / 4) passes over K/V).  The wrapper's block_kv
// sets no tile here.
//
// n_splits == 1 writes the normalised output directly; n_splits > 1 writes
// f32 partials (acc, m, l) and a second small kernel merges them by a
// max-shift, as `combine_splits` does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;     // rounds of K/V loads a lane issues before computing

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) VecN {
  T v[N];
};

template <typename QT, typename KT, int DH, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool, const int* __restrict__ block_table,
                    const int* __restrict__ cache_len, QT* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int H, int Hkv, int bs, int NB,
                    int n_splits, int npb, float scale) {
  constexpr int GL = 8;                 // lanes that share one token
  constexpr int EPL = DH / GL;          // elements of a K/V row per lane
  constexpr int TPW = 32 / GL;          // tokens a warp holds at once
  constexpr int STEP = kUnroll * kWarps * TPW;
  using Vec = VecN<KT, EPL>;
  __shared__ __align__(16) float q_s[ROWS][DH];
  __shared__ float acc_s[kWarps][ROWS][DH];
  __shared__ float m_s[kWarps][ROWS];
  __shared__ float l_s[kWarps][ROWS];

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane % GL, grp = lane / GL;

  const int cl = cache_len[b];
  const int n_live = min(cl / bs + 1, NB);
  const int blk_lo = s * npb;
  const int blk_hi = min((s + 1) * npb, n_live);
  const int pos_lo = blk_lo * bs;
  const int pos_hi = blk_hi > blk_lo ? min(blk_hi * bs, cl + 1) : pos_lo;

  const int* bt_row = block_table + (long long)b * NB;
  const long long tok_stride = (long long)Hkv * DH;
  const long long lane_off = (long long)h * DH + lg * EPL;

  for (int r0 = 0; r0 < rep; r0 += ROWS) {
    for (int i = tid; i < ROWS * DH; i += kThreads) {
      const int r = i / DH;
      q_s[r][i % DH] = r0 + r < rep
          ? to_f32(q[((long long)b * H + h * rep + r0) * DH + i]) * scale : 0.f;
    }
    __syncthreads();
    float acc[ROWS][EPL], m[ROWS], l[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
      m[r] = kNegInf;
      l[r] = 0.f;
    }

    for (int p0 = pos_lo; p0 < pos_hi; p0 += STEP) {
      Vec kv[kUnroll], vv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = p0 + (u * kWarps + warp) * TPW + grp;
        if (pos < pos_hi) {
          const long long off =
              ((long long)bt_row[pos / bs] * bs + pos % bs) * tok_stride + lane_off;
          kv[u] = *reinterpret_cast<const Vec*>(k_pool + off);
          vv[u] = *reinterpret_cast<const Vec*>(v_pool + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // every lane runs the shuffles; a lane past the end contributes p = 0
        const bool valid = p0 + (u * kWarps + warp) * TPW + grp < pos_hi;
        float kf[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[e] = valid ? to_f32(kv[u].v[e]) : 0.f;
        float sc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float* qr = &q_s[r][lg * EPL];
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kf[e], dot);
#pragma unroll
          for (int o = GL / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          sc[r] = dot;
        }
        if (!valid) continue;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float m_new = fmaxf(m[r], sc[r]);
          const float alpha = __expf(m[r] - m_new);
          const float pw = __expf(sc[r] - m_new);
          l[r] = l[r] * alpha + pw;
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[r][e] = fmaf(acc[r][e], alpha, pw * to_f32(vv[u].v[e]));
          m[r] = m_new;
        }
      }
    }

    // merge the TPW token groups of each warp (lanes lg, lg+8, lg+16, lg+24)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float m_g = m[r];
#pragma unroll
      for (int o = GL; o < 32; o <<= 1) m_g = fmaxf(m_g, __shfl_xor_sync(0xffffffffu, m_g, o));
      const float w = __expf(m[r] - m_g);
      float l_g = l[r] * w;
#pragma unroll
      for (int o = GL; o < 32; o <<= 1) l_g += __shfl_xor_sync(0xffffffffu, l_g, o);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[r][e] * w;
#pragma unroll
        for (int o = GL; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (grp == 0) acc_s[warp][r][lg * EPL + e] = a;
      }
      if (lane == 0) {
        m_s[warp][r] = m_g;
        l_s[warp][r] = l_g;
      }
    }
    __syncthreads();
    // merge the warps: max-shift, as across splits
    for (int i = tid; i < ROWS * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      if (r0 + r >= rep) continue;
      float m_g = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_g = fmaxf(m_g, m_s[w][r]);
      float l_g = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = __expf(m_s[w][r] - m_g);
        l_g += wt * l_s[w][r];
        o += wt * acc_s[w][r][d];
      }
      const int row = h * rep + r0 + r;
      if (n_splits == 1) {
        out[((long long)b * H + row) * DH + d] = from_f32<QT>(o / (l_g == 0.f ? 1.f : l_g));
      } else {
        const long long prow = (((long long)b * Hkv + h) * n_splits + s) * rep + r0 + r;
        part_acc[prow * DH + d] = o;
        if (d == 0) {
          part_m[prow] = m_g;
          part_l[prow] = l_g;
        }
      }
    }
    __syncthreads();   // the next pass of rows reuses the shared state
  }
}

// Merge split partials (B, Hkv, n_splits, rep[, Dh]) -> (B, H, Dh).
template <typename QT>
__global__ void __launch_bounds__(kThreads)
combine_splits_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                      const float* __restrict__ part_l, QT* __restrict__ out, int H,
                      int Hkv, int Dh, int n_splits) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int rep = H / Hkv;
  for (int i = threadIdx.x; i < rep * Dh; i += kThreads) {
    const int r = i / Dh, d = i % Dh;
    const long long row0 = ((long long)b * Hkv + h) * n_splits * rep + r;
    float m_g = kNegInf;
    for (int s = 0; s < n_splits; ++s) m_g = fmaxf(m_g, part_m[row0 + (long long)s * rep]);
    float l_g = 0.f, o = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const long long row = row0 + (long long)s * rep;
      const float w = __expf(part_m[row] - m_g);
      l_g += w * part_l[row];
      o += w * part_acc[row * Dh + d];
    }
    out[((long long)b * H + h * rep) * Dh + i] = from_f32<QT>(o / (l_g == 0.f ? 1.f : l_g));
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *block_table, *cache_len;
  void* out;
  float *part_acc, *part_m, *part_l;
  int B, H, Hkv, bs, NB, n_splits;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, int DH, int ROWS>
cudaError_t launch_rows(const Args& a) {
  const int npb = (a.NB + a.n_splits - 1) / a.n_splits;
  paged_decode_kernel<QT, KT, DH, ROWS><<<dim3(a.B, a.Hkv, a.n_splits), kThreads, 0, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), a.block_table, a.cache_len, static_cast<QT*>(a.out),
      a.part_acc, a.part_m, a.part_l, a.H, a.Hkv, a.bs, a.NB, a.n_splits, npb, a.scale);
  if (a.n_splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    combine_splits_kernel<QT><<<dim3(a.B, a.Hkv), kThreads, 0, a.stream>>>(
        a.part_acc, a.part_m, a.part_l, static_cast<QT*>(a.out), a.H, a.Hkv, DH, a.n_splits);
  }
  return cudaGetLastError();
}

template <typename QT, typename KT, int DH>
cudaError_t launch_dh(const Args& a) {
  const int rep = a.H / a.Hkv;
  if (rep == 1) return launch_rows<QT, KT, DH, 1>(a);
  if (rep == 2) return launch_rows<QT, KT, DH, 2>(a);
  return launch_rows<QT, KT, DH, 4>(a);
}

template <typename QT, typename KT>
cudaError_t launch_typed(int Dh, const Args& a) {
  if (Dh == 128) return launch_dh<QT, KT, 128>(a);
  if (Dh == 64) return launch_dh<QT, KT, 64>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`.  q/out: (B, H, Dh) in q's type; k/v pools
// (P, bs, Hkv, Dh) in the pool type; block_table (B, NB) int32; cache_len
// (B,) int32; part_* are f32 scratch of (B, Hkv, n_splits, rep[, Dh]),
// unused when n_splits == 1.  Returns cudaGetLastError() (0 = launched).
int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                        const void* block_table, const void* cache_len, void* out,
                        void* part_acc, void* part_m, void* part_l, int B, int H, int Hkv,
                        int Dh, int bs, int NB, int n_splits, float scale, int q_bf16,
                        int kv_bf16, void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const int*>(block_table),
               static_cast<const int*>(cache_len), out, static_cast<float*>(part_acc),
               static_cast<float*>(part_m), static_cast<float*>(part_l), B, H, Hkv, bs, NB,
               n_splits, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (q_bf16 && kv_bf16)
    e = launch_typed<__nv_bfloat16, __nv_bfloat16>(Dh, a);
  else if (q_bf16)
    e = launch_typed<__nv_bfloat16, float>(Dh, a);
  else if (kv_bf16)
    e = launch_typed<float, __nv_bfloat16>(Dh, a);
  else
    e = launch_typed<float, float>(Dh, a);
  return (int)e;
}

}  // extern "C"
