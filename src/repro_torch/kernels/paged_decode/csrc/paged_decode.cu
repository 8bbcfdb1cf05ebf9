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
// by 1.  Grid (B, Hkv, n_splits): split s covers the table's blocks
// [s*npb, min((s+1)*npb, cache_len/bs + 1)) and stops at cache_len, so only
// live tokens are read (the TPU kernel clamped dead grid steps onto the last
// live block, kernel.py:140-144).  n_splits == 1 writes the normalised
// output; n_splits > 1 writes f32 partials (acc, m, l) and a second small
// kernel merges them by a max-shift, as `combine_splits` does.
//
// Bound: HBM bytes.  A decode step reads 2 * B * Hkv * live_tokens * Dh
// elements of K and V and does 4 flops per element pair per query head
// (rep of them): at rep 4 in bf16 about 4 flops a byte, far below the ~295
// at which the tensor cores would be the limit.  So the design's aim is to
// keep device memory busy: enough bytes in flight, and little work between
// the bytes.
//
// bf16 q and pools, rep <= 8: `paged_decode_tc_kernel<DH, TK>`.
//   * The tile is `block_kv` tokens (a divisor of bs, as in the reference),
//     held in TK slots, TK = block_kv rounded up to a power of two >= 16;
//     slots past block_kv or past cache_len are zero-filled and masked.  A
//     tile never straddles a page: the page number is read once per tile,
//     and page and offset advance by block_kv with no integer division.
//   * K and V tiles stream through a ring of kStages = 3 shared-memory
//     stages by 16-byte `cp.async` copies (a K/V row is Dh*2 bytes at a
//     stride of Hkv*Dh*2), so two tiles are in flight while one is scored.
//     16-byte chunks are XOR-swizzled by token (chunk ^ (token & 7)), so
//     `ldmatrix` reads them without bank conflicts.  The ring is the only
//     shared memory: 3 * 2 * TK * Dh * 2 bytes (`paged_decode_smem_bytes`;
//     the tiling model reports the same number, and the tuner rejects a
//     block_kv whose ring does not fit: 256 at Dh 128).
//   * Products on the tensor cores, `mma.sync.m16n8k16` (bf16 in, f32
//     accumulate), in the FlashAttention-2 register layout.  min(4, TK/16)
//     warps each score their own 16-token slabs of a tile.  Q is the A
//     operand, loaded once into registers: its rows are the rep query heads
//     (rows rep..7 zero).  K is the B operand by `ldmatrix`; V by
//     `ldmatrix.trans`.  Rows 8-15 of the m16 tile carry the low half of P:
//     P enters P·V as P_hi = bf16(p) in rows 0-7 and P_lo = bf16(p - P_hi)
//     in rows 8-15 of the same A operand, so one product gives both terms
//     and the output is row r + row r + 8.  A single bf16 P would move
//     outputs near |o| >= 2 by a bf16 ulp, beyond the 1e-2 gate.
//   * Softmax once per tile, not once per token: per query row one max over
//     the warp's slab of the tile (a 4-lane shuffle), one rescale of the
//     accumulator, exponentials for the tile's scores only.  `scale` is
//     applied to the f32 scores, never to a bf16 Q.  The warps merge once
//     at the end through shared memory (the drained ring), by a max-shift.
//   * The padded rows and the second P term cost tensor-core work this
//     kernel can afford: at qwen3-4b decode the step is about 0.12 GFLOP
//     against 30.6 MB.
//
// Other types (f32 q or pools), and rep > 8: `paged_decode_kernel`, scalar
// FMAs on the CUDA cores.  8 lanes share one token: each loads 16 (Dh 128)
// or 8 (Dh 64) contiguous elements of the token's K and V rows in 16-byte
// loads, kUnroll rounds of loads before computing; a token's scores reduce
// in 3 shuffles inside its 8-lane group; each group runs its own online
// softmax and the groups and warps merge once per block.  Query rows are
// processed ROWS at a time (rep rounded up to 1, 2 or 4; rep > 4 takes
// ceil(rep / 4) passes over K/V); block_kv sets no tile there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

// ---------------------------------------------------------------------------
// bf16 q and pools: tensor cores, K/V through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kStages = 3;          // ring stages of K and V tiles
constexpr int kMaxRep = 8;          // query rows of the m16 tile (rows 8-15 hold P_lo)
constexpr int kMaxTile = 256;       // largest TK instantiated
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int tc_warps(int tk) { return tk >= 64 ? 4 : tk / 16; }

// slots of a ring stage for a tile of block_kv tokens
int tc_tile(int block_kv) {
  int tk = 16;
  while (tk < block_kv) tk <<= 1;
  return tk;
}

__host__ __device__ constexpr size_t tc_smem_bytes(int Dh, int tk) {
  return (size_t)kStages * 2 * tk * Dh * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src-size 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH, int TK>
__global__ void __launch_bounds__(32 * tc_warps(TK))
paged_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ block_table, const int* __restrict__ cache_len,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                       float* __restrict__ part_m, float* __restrict__ part_l, int H, int Hkv,
                       int bs, int NB, int n_splits, int npb, int bkv, float scale_log2) {
  constexpr int W = tc_warps(TK);
  constexpr int NT = 32 * W;
  constexpr int SLAB = TK / W;         // slots of a tile one warp scores
  constexpr int NSUB = SLAB / 16;      // 16-token sub-slabs (the k of P·V)
  constexpr int CH = DH / 8;           // 16-byte chunks of a K/V row
  constexpr int STAGE = TK * DH;       // bf16 elements of one K (or V) tile
  constexpr int KS = DH / 16;          // k-steps of Q·Kᵀ, 16-dim pairs of P·V
  extern __shared__ __align__(128) __nv_bfloat16 ring[];   // [kStages][K, V][TK][DH]

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  const int cl = cache_len[b];
  const int n_live = min(cl / bs + 1, NB);
  const int blk_lo = s * npb;
  const int blk_hi = min((s + 1) * npb, n_live);
  const int pos_lo = blk_lo * bs;
  const int pos_hi = blk_hi > blk_lo ? min(blk_hi * bs, cl + 1) : pos_lo;
  const int n_tiles = (pos_hi - pos_lo + bkv - 1) / bkv;

  const int* bt_row = block_table + (long long)b * NB;
  const long long tok_stride = (long long)Hkv * DH;

  // The next tile to copy: its first position and its page and offset.
  int next_pos = pos_lo, next_blk = blk_lo, next_off = 0;
  auto copy_tile = [&](int stage) {
    const int n_ok = min(bkv, pos_hi - next_pos);
    const long long base = ((long long)bt_row[next_blk] * bs + next_off) * tok_stride +
                           (long long)h * DH;
    __nv_bfloat16* ks = ring + 2 * stage * STAGE;
    for (int i = tid; i < TK * CH; i += NT) {
      const int slot = i / CH, c = i % CH;
      const bool ok = slot < n_ok;
      const long long off = ok ? base + slot * tok_stride + c * 8 : 0;
      const int dst = slot * DH + ((c ^ (slot & 7)) << 3);
      cp_async16(smem_u32(ks + dst), k_pool + off, ok);
      cp_async16(smem_u32(ks + STAGE + dst), v_pool + off, ok);
    }
    next_pos += bkv;
    next_off += bkv;
    if (next_off == bs) {
      next_off = 0;
      ++next_blk;
    }
  };

  // Q rows g < rep as A fragments: (row g, dims 16ks + 2t..) and (row g,
  // dims 16ks + 8 + 2t..); rows g + 8 of the tile are zero for Q·Kᵀ.
  uint32_t qa[KS][2];
  {
    const __nv_bfloat16* qr = q + ((long long)b * H + h * rep + min(g, rep - 1)) * DH;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = g < rep ? *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 2 * t) : 0u;
      qa[ks][1] = g < rep ? *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 8 + 2 * t) : 0u;
    }
  }

  float o[2 * KS][4];                  // per 8 dims: rows g (P_hi·V) and g + 8 (P_lo·V)
#pragma unroll
  for (int d = 0; d < 2 * KS; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m = kNegInf, l = 0.f;          // row g's max (log2 units) and this lane's share of l

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) copy_tile(st);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // tile `it` landed; every warp is done with it - 1
    if (it + kStages - 1 < n_tiles) copy_tile((it + kStages - 1) % kStages);
    cp_async_commit();

    const int n_ok = min(bkv, pos_hi - (pos_lo + it * bkv));
    const int slot0 = warp * SLAB;
    if (slot0 >= n_ok) continue;       // warp-uniform: nothing of this tile is the warp's
    const __nv_bfloat16* ks = ring + 2 * (it % kStages) * STAGE;
    const __nv_bfloat16* vs = ks + STAGE;

    // scores of row g at slots slot0 + 16 sub + 8 nt + 2t + e
    float sc[NSUB][2][2];
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      const int tok = slot0 + 16 * sub + ((lane >> 4) << 3) + (lane & 7);
#pragma unroll
      for (int ks_ = 0; ks_ < KS; ++ks_) {
        uint32_t kb[4];
        const int c = 2 * ks_ + ((lane >> 3) & 1);
        ldmatrix_x4(kb, smem_u32(ks + tok * DH + ((c ^ (tok & 7)) << 3)));
        const uint32_t a[4] = {qa[ks_][0], 0u, qa[ks_][1], 0u};
        mma_bf16(s0, a, kb[0], kb[1]);
        mma_bf16(s1, a, kb[2], kb[3]);
      }
      sc[sub][0][0] = s0[0];
      sc[sub][0][1] = s0[1];
      sc[sub][1][0] = s1[0];
      sc[sub][1][1] = s1[1];
    }

    float mx = kNegInf;
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int slot = slot0 + 16 * sub + 8 * nt + 2 * t + e;
          const float v = slot < n_ok ? sc[sub][nt][e] * scale_log2 : -INFINITY;
          sc[sub][nt][e] = v;
          mx = fmaxf(mx, v);
        }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = fast_exp2(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < 2 * KS; ++d) {
      o[d][0] *= alpha;
      o[d][1] *= alpha;
      o[d][2] *= alpha;
      o[d][3] *= alpha;
    }

#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      uint32_t pa[4];                  // {P_hi, P_lo} x {slots 2t.., slots 8 + 2t..}
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float p0 = fast_exp2(sc[sub][nt][0] - m), p1 = fast_exp2(sc[sub][nt][1] - m);
        l += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        pa[2 * nt] = bf16_bits(hi);
        pa[2 * nt + 1] = bf16_bits(
            __floats2bfloat162_rn(p0 - __low2float(hi), p1 - __high2float(hi)));
      }
      const int tok = slot0 + 16 * sub + (((lane >> 3) & 1) << 3) + (lane & 7);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        const int c = 2 * dp + (lane >> 4);
        ldmatrix_x4_trans(vb, smem_u32(vs + tok * DH + ((c ^ (tok & 7)) << 3)));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();                     // the ring is free: it holds the warps' partials now
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* acc_s = reinterpret_cast<float*>(ring);   // [W][kMaxRep][DH]
  float* m_s = acc_s + W * kMaxRep * DH;           // [W][kMaxRep]
  float* l_s = m_s + W * kMaxRep;                  // [W][kMaxRep]
  if (g < rep) {
#pragma unroll
    for (int d = 0; d < 2 * KS; ++d)
      *reinterpret_cast<float2*>(&acc_s[(warp * kMaxRep + g) * DH + 8 * d + 2 * t]) =
          make_float2(o[d][0] + o[d][2], o[d][1] + o[d][3]);
    if (t == 0) {
      m_s[warp * kMaxRep + g] = m;
      l_s[warp * kMaxRep + g] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    float m_g = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) m_g = fmaxf(m_g, m_s[w * kMaxRep + r]);
    float l_g = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float wt = fast_exp2(m_s[w * kMaxRep + r] - m_g);
      l_g += wt * l_s[w * kMaxRep + r];
      acc += wt * acc_s[(w * kMaxRep + r) * DH + d];
    }
    if (n_splits == 1) {
      out[((long long)b * H + h * rep + r) * DH + d] =
          __float2bfloat16_rn(acc / (l_g == 0.f ? 1.f : l_g));
    } else {
      const long long prow = (((long long)b * Hkv + h) * n_splits + s) * rep + r;
      part_acc[prow * DH + d] = acc;
      if (d == 0) {
        // natural log, as the combine kernel reads it
        part_m[prow] = m_g == kNegInf ? kNegInf : m_g * kLn2;
        part_l[prow] = l_g;
      }
    }
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *block_table, *cache_len;
  void* out;
  float *part_acc, *part_m, *part_l;
  int B, H, Hkv, bs, NB, n_splits, block_kv;
  float scale;
  cudaStream_t stream;
};

int split_blocks(const Args& a) { return (a.NB + a.n_splits - 1) / a.n_splits; }

template <typename QT>
cudaError_t launch_combine(const Args& a, int Dh) {
  if (a.n_splits == 1) return cudaGetLastError();
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_splits_kernel<QT><<<dim3(a.B, a.Hkv), kThreads, 0, a.stream>>>(
      a.part_acc, a.part_m, a.part_l, static_cast<QT*>(a.out), a.H, a.Hkv, Dh, a.n_splits);
  return cudaGetLastError();
}

template <int DH, int TK>
cudaError_t launch_tc_tile(const Args& a) {
  if constexpr (tc_smem_bytes(DH, TK) > kMaxSmem) {   // the ring cannot fit: no kernel
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = tc_smem_bytes(DH, TK);
    auto kernel = paged_decode_tc_kernel<DH, TK>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(a.B, a.Hkv, a.n_splits), 32 * tc_warps(TK), smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k_pool),
        static_cast<const __nv_bfloat16*>(a.v_pool), a.block_table, a.cache_len,
        static_cast<__nv_bfloat16*>(a.out), a.part_acc, a.part_m, a.part_l, a.H, a.Hkv, a.bs,
        a.NB, a.n_splits, split_blocks(a), a.block_kv, a.scale * kLog2e);
    return launch_combine<__nv_bfloat16>(a, DH);
  }
}

template <int DH>
cudaError_t launch_tc(const Args& a) {
  switch (tc_tile(a.block_kv)) {
    case 16: return launch_tc_tile<DH, 16>(a);
    case 32: return launch_tc_tile<DH, 32>(a);
    case 64: return launch_tc_tile<DH, 64>(a);
    case 128: return launch_tc_tile<DH, 128>(a);
    case 256: return launch_tc_tile<DH, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KT, int DH, int ROWS>
cudaError_t launch_rows(const Args& a) {
  paged_decode_kernel<QT, KT, DH, ROWS><<<dim3(a.B, a.Hkv, a.n_splits), kThreads, 0, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pool),
      static_cast<const KT*>(a.v_pool), a.block_table, a.cache_len, static_cast<QT*>(a.out),
      a.part_acc, a.part_m, a.part_l, a.H, a.Hkv, a.bs, a.NB, a.n_splits, split_blocks(a),
      a.scale);
  return launch_combine<QT>(a, DH);
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

bool tensor_core_path(int rep, int q_bf16, int kv_bf16) {
  return q_bf16 && kv_bf16 && rep <= kMaxRep;
}

}  // namespace

extern "C" {

// Shared memory one block takes, in bytes: the tensor-core kernel's ring
// (bf16 q and pools, rep <= 8) for a tile of block_kv tokens, else the
// CUDA-core kernel's static arrays (q_s, acc_s, m_s, l_s over ROWS = 1, 2
// or 4 query rows and 8 warps).
long long paged_decode_smem_bytes(int Dh, int rep, int block_kv, int q_bf16, int kv_bf16) {
  if (tensor_core_path(rep, q_bf16, kv_bf16))
    return (long long)tc_smem_bytes(Dh, tc_tile(block_kv));
  const int rows = rep == 1 ? 1 : rep == 2 ? 2 : 4;
  return 4LL * rows * (9 * Dh + 16);
}

// Launch on `stream`.  q/out: (B, H, Dh) in q's type; k/v pools
// (P, bs, Hkv, Dh) in the pool type; block_table (B, NB) int32; cache_len
// (B,) int32; part_* are f32 scratch of (B, Hkv, n_splits, rep[, Dh]),
// unused when n_splits == 1.  block_kv (a divisor of bs) is the tensor-core
// kernel's tile.  Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head dim or tile the kernels do not take.
int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                        const void* block_table, const void* cache_len, void* out,
                        void* part_acc, void* part_m, void* part_l, int B, int H, int Hkv,
                        int Dh, int bs, int NB, int n_splits, int block_kv, float scale,
                        int q_bf16, int kv_bf16, void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const int*>(block_table),
               static_cast<const int*>(cache_len), out, static_cast<float*>(part_acc),
               static_cast<float*>(part_m), static_cast<float*>(part_l), B, H, Hkv, bs, NB,
               n_splits, block_kv, scale, static_cast<cudaStream_t>(stream)};
  if (block_kv < 1 || bs % block_kv) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (tensor_core_path(H / Hkv, q_bf16, kv_bf16)) {
    if (block_kv > kMaxTile) return (int)cudaErrorInvalidValue;
    e = Dh == 128 ? launch_tc<128>(a) : Dh == 64 ? launch_tc<64>(a) : cudaErrorInvalidValue;
  } else if (q_bf16 && kv_bf16) {
    e = launch_typed<__nv_bfloat16, __nv_bfloat16>(Dh, a);
  } else if (q_bf16) {
    e = launch_typed<__nv_bfloat16, float>(Dh, a);
  } else if (kv_bf16) {
    e = launch_typed<float, __nv_bfloat16>(Dh, a);
  } else {
    e = launch_typed<float, float>(Dh, a);
  }
  return (int)e;
}

}  // extern "C"
