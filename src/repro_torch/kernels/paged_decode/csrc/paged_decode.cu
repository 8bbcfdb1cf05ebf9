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
// (rep of them): at rep 4 about 4 flops a byte in bf16 and 2 in f32, far
// below the ~295 (bf16) or ~148 (TF32) at which the tensor cores would be
// the limit.  So the design's aim is to keep device memory busy: enough
// bytes in flight, and little work between the bytes.
//
// Both kernels share the layout of the work:
//   * The tile is `block_kv` tokens (a divisor of bs, as in the reference),
//     held in TK slots, TK = block_kv rounded up to a power of two >= 16;
//     slots past block_kv or past cache_len are zero-filled and masked.  A
//     tile never straddles a page: the page number is read once per tile,
//     and page and offset advance by block_kv with no integer division.
//   * K and V tiles stream through a ring of kStages = 3 shared-memory
//     stages by 16-byte `cp.async` copies, in the pool's own type (a K/V
//     row is Dh elements at a stride of Hkv*Dh), so two tiles are in flight
//     while one is scored.  16-byte chunks are XOR-swizzled by token (chunk
//     ^ (token & 7)), so `ldmatrix` and the scalar V reads below are free of
//     bank conflicts.  The ring is the only shared memory: 3 * 2 * TK * Dh
//     elements (`paged_decode_smem_bytes`; the tiling model reports the same
//     number, and the tuner rejects a block_kv whose ring does not fit: 256
//     tokens at Dh 128 in bf16, 128 at Dh 128 or 256 at Dh 64 in f32).
//   * Softmax once per group of tokens, not once per token: per query row
//     one max over a warp's tokens of the tile (a 4-lane shuffle), one
//     rescale of the accumulator, exponentials for those scores only.
//     `scale` is applied to the f32 scores, in log2 units.  The warps that
//     share a tile merge once at the end through shared memory (the
//     drained ring), by a max-shift.
//   * A query head is a row of an m16 tensor-core tile, whose rows 8-15
//     carry low parts: at most 8 query rows a warp.
//
// bf16 q and pools, rep <= 8: `paged_decode_tc_kernel<DH, TK>`,
// `mma.sync.m16n8k16` (bf16 in, f32 accumulate) in the FlashAttention-2
// register layout.  Q is the A operand, loaded once into registers: its rows
// are the rep query heads (rows rep..7 zero).  K is the B operand by
// `ldmatrix`; V by `ldmatrix.trans`.  P enters P·V as P_hi = bf16(p) in rows
// 0-7 and P_lo = bf16(p - P_hi) in rows 8-15 of the same A operand, so one
// product gives both terms and the output is row r + row r + 8.  A single
// bf16 P would move outputs near |o| >= 2 by a bf16 ulp, beyond the 1e-2
// gate.  min(4, TK/16) warps each score their own slab of a tile, 16
// tokens a product, one softmax step a tile.  At qwen3-4b decode the step
// is about 0.12 GFLOP against 30.6 MB.
//
// Every other type pair (f32 q or pools), and rep > 8:
// `paged_decode_tf32_kernel<QT, KT, DH, TK>`, `mma.sync.m16n8k8` TF32 in
// 3xTF32 (x = hi + lo, hi = x with its low 13 mantissa bits cleared, lo =
// x - hi exactly; one TF32 product keeps about three digits, far from the
// 2e-5 gate of f32 outputs).
//   * S = Q·Kᵀ: A = [Q_hi; Q_lo], q's hi part in rows 0-7 and its lo part in
//     rows 8-15, split once into registers; one product gives Q_hi·K in row
//     g and Q_lo·K in row g + 8 of the C fragment, and the score is c0 + c2
//     in the same thread.  An f32 pool's K fragment comes by `ldmatrix` (8
//     x 4-float matrices) and is split in registers: a second product with
//     A = [Q_hi; 0] adds Q_hi·K_lo, two products a k-step.  A bf16 pool's K
//     is exact in TF32 (no lo part): one product a k-step; `ldmatrix` gives
//     a lane a pair of dims (2t, 2t + 1), which become k-columns t and t + 4,
//     and q's fragment is loaded in that order.
//   * O += P·V on the same instruction with A = [P_hi; P_lo]: the S
//     fragment's keys 2t and 2t + 1 are A's k-columns t and t + 4, and V's B
//     fragment is read at those keys: for an f32 pool two scalar reads a
//     product, conflict-free under the swizzle (lane (g, t) reads float
//     8 (n ^ t) + g of row 2t), split in registers, plus A = [P_hi; 0]
//     against V_lo; for a bf16 pool one `ldmatrix.trans` serves four
//     products.
//   * A tile's 8-token groups are dealt to min(TK/8, 8) warps (one group a
//     warp a tile up to 64-token tiles), each group one softmax step; S
//     in two or four accumulators, so that the products of a k-step do not
//     wait on the last k-step's.  With one warp a scheduler, an f32 tile's
//     products and splits (about 600 instructions a warp for 16 tokens at
//     Dh 128) did not hide behind its bytes: 8 warps of 8 tokens in place
//     of 4 of 16 cut the time at one split by 19-45% on the card, and the
//     best config's by 13% in f32, not over a bf16 pool (PERF.md).
//   * rep > 8: warps are (slab warp, group of 8 query heads), the slab
//     warps fewer as the row groups grow, so that a pass of up to 8 warps
//     takes every row group over each tile already in shared memory: rep
//     <= 64 reads K and V once (but rep 17-32 over 16-token bf16 tiles at
//     Dh 64, whose drained ring cannot hold the merge of 8 warps: two
//     passes); a larger rep takes more passes.
//   * q of either type is split the same way (a bf16 q has lo = 0); the
//     output is written in q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;       // threads of a combine block
constexpr int kStages = 3;          // ring stages of K and V tiles
constexpr int kMaxRep = 8;          // query rows of the m16 tile (rows 8-15 hold low parts)
constexpr int kMaxTile = 256;       // largest TK instantiated
constexpr int kPassWarps = 8;       // most warps of a tf32 block: slab warps x row groups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int tc_warps(int tk) { return tk >= 64 ? 4 : tk / 16; }

// slots of a ring stage for a tile of block_kv tokens
int tc_tile(int block_kv) {
  int tk = 16;
  while (tk < block_kv) tk <<= 1;
  return tk;
}

// the ring: kStages stages of a K and a V tile of tk slots, elements of `elt` bytes
__host__ __device__ constexpr size_t ring_bytes(int Dh, int tk, int elt) {
  return (size_t)kStages * 2 * tk * Dh * elt;
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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The next tile of a split to copy into the ring, in the pool's type T:
// its first position and its page and offset.  Slots past the tile's live
// tokens are zero-filled.
template <typename T, int DH, int TK>
struct TileCopier {
  static constexpr int EPC = 16 / sizeof(T);   // elements of a 16-byte chunk
  static constexpr int CH = DH / EPC;          // chunks of a K/V row
  static constexpr int STAGE = TK * DH;        // elements of one K (or V) tile
  const T *k_pool, *v_pool;
  const int* bt_row;
  long long tok_stride, head_off;
  int bs, bkv, pos_hi, next_pos, next_blk, next_off;

  __device__ __forceinline__ void copy(T* ring, int stage, int tid, int nt) {
    const int n_ok = min(bkv, pos_hi - next_pos);
    const long long base = ((long long)bt_row[next_blk] * bs + next_off) * tok_stride + head_off;
    T* ks = ring + 2 * stage * STAGE;
    for (int i = tid; i < TK * CH; i += nt) {
      const int slot = i / CH, c = i % CH;
      const bool ok = slot < n_ok;
      const long long off = ok ? base + slot * tok_stride + c * EPC : 0;
      const int dst = slot * DH + (c ^ (slot & 7)) * EPC;
      cp_async16(smem_u32(ks + dst), k_pool + off, ok);
      cp_async16(smem_u32(ks + STAGE + dst), v_pool + off, ok);
    }
    next_pos += bkv;
    next_off += bkv;
    if (next_off == bs) {
      next_off = 0;
      ++next_blk;
    }
  }
};

// The positions [pos_lo, pos_hi) that split s of a row with this cache_len
// reads, and the table block they start in: the split's blocks
// [s*npb, min((s+1)*npb, cl/bs + 1)), stopping at cl.
struct Split {
  int blk_lo, pos_lo, pos_hi;
};
__device__ __forceinline__ Split split_of(int cl, int s, int bs, int NB, int npb) {
  const int n_live = min(cl / bs + 1, NB);
  const int blk_lo = s * npb;
  const int blk_hi = min((s + 1) * npb, n_live);
  const int pos_lo = blk_lo * bs;
  return {blk_lo, pos_lo, blk_hi > blk_lo ? min(blk_hi * bs, cl + 1) : pos_lo};
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

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  constexpr int STAGE = TK * DH;       // bf16 elements of one K (or V) tile
  constexpr int KS = DH / 16;          // k-steps of Q·Kᵀ, 16-dim pairs of P·V
  extern __shared__ __align__(128) __nv_bfloat16 ring[];   // [kStages][K, V][TK][DH]

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  const Split sp = split_of(cache_len[b], s, bs, NB, npb);
  const int pos_lo = sp.pos_lo, pos_hi = sp.pos_hi;
  const int n_tiles = (pos_hi - pos_lo + bkv - 1) / bkv;
  TileCopier<__nv_bfloat16, DH, TK> tiles{k_pool, v_pool, block_table + (long long)b * NB,
                                          (long long)Hkv * DH, (long long)h * DH, bs, bkv,
                                          pos_hi, pos_lo, sp.blk_lo, 0};

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
    if (st < n_tiles) tiles.copy(ring, st, tid, NT);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // tile `it` landed; every warp is done with it - 1
    if (it + kStages - 1 < n_tiles) tiles.copy(ring, (it + kStages - 1) % kStages, tid, NT);
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

// ---------------------------------------------------------------------------
// Every other type pair, and rep > 8: 3xTF32 on mma.sync, the same ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t f32_bits(float x) { return __float_as_uint(x); }

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi exactly; the tensor cores read lo's TF32 part
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = f32_bits(__uint_as_float(x) - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the two bf16 values of a word as f32 bits (exact TF32 values)
__device__ __forceinline__ uint32_t bf16_lo(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t w) { return w & 0xffff0000u; }

// The dim that k-column j of k-step ks holds, in the order K's fragment
// arrives: an f32 pool's in order; a bf16 pool's word t holds dims 2t and
// 2t + 1, which become k-columns t and t + 4.
template <typename KT>
__device__ __forceinline__ int k_dim(int ks, int j) {
  if constexpr (sizeof(KT) == 4) {
    return 8 * ks + j;
  } else {
    return 8 * ks + 2 * (j & 3) + (j >> 2);
  }
}

// Scores of one group of 8 tokens from slot tok0 of K tile `kt`: the sum
// of s[0..3] is the group's C fragment, row g Q_hi·K (and Q_hi·K_lo), row
// g + 8 Q_lo·K.  A k-step's products go to an accumulator of their own,
// four in turn over a bf16 pool, two over an f32 pool (whose Dh 128
// instantiations have no registers to spare for four).
template <typename KT, int DH>
__device__ __forceinline__ void group_scores(float (&s)[4][4], const uint32_t (&qa)[DH / 8][4],
                                             const KT* kt, int tok0, int lane) {
  const int tok = tok0 + (lane & 7);
  if constexpr (sizeof(KT) == 4) {
#pragma unroll
    for (int p = 0; p < DH / 16; ++p) {          // k-steps 2p, 2p + 1: chunks 4p..4p+3
      const int c = 4 * p + (lane >> 3);
      uint32_t kb[4];
      ldmatrix_x4(kb, smem_u32(kt + tok * DH + ((c ^ (tok & 7)) << 2)));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t* a = qa[2 * p + e];
        const uint32_t a_hi[4] = {a[0], 0u, a[2], 0u};
        uint32_t h0, l0, h1, l1;
        split_tf32(kb[2 * e], h0, l0);
        split_tf32(kb[2 * e + 1], h1, l1);
        mma_tf32(s[e], a_hi, l0, l1);
        mma_tf32(s[e], qa[2 * p + e], h0, h1);
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < DH / 32; ++p) {          // k-steps 4p..4p+3: chunks 4p..4p+3
      const int c = 4 * p + (lane >> 3);
      uint32_t kb[4];
      ldmatrix_x4(kb, smem_u32(kt + tok * DH + ((c ^ (tok & 7)) << 3)));
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_tf32(s[e], qa[4 * p + e], bf16_lo(kb[e]), bf16_hi(kb[e]));
    }
  }
}

// o += [P_hi; P_lo] V for one group of 8 tokens from slot tok0 of V tile
// `vt`; p0, p1 are row g's weights of its tokens 2t and 2t + 1 (A's
// k-columns t and t + 4).  o[n] holds output dims 8n + 2t, 8n + 2t + 1: row
// g the P_hi terms, row g + 8 the P_lo ones.
template <typename KT, int DH>
__device__ __forceinline__ void group_pv(float (&o)[DH / 8][4], float p0, float p1,
                                         const KT* vt, int tok0, int lane) {
  uint32_t h0, l0, h1, l1;
  split_tf32(f32_bits(p0), h0, l0);
  split_tf32(f32_bits(p1), h1, l1);
  const uint32_t pa[4] = {h0, l0, h1, l1};
  if constexpr (sizeof(KT) == 4) {
    // V[2t][8n + g] and V[2t + 1][8n + g] under the swizzle: floats
    // 8 (n ^ t) + g and 8 (n ^ t) + (g ^ 4) of the two rows
    const int g = lane >> 2, t = lane & 3;
    const uint32_t pa_hi[4] = {h0, 0u, h1, 0u};
    const float* v0 = vt + (tok0 + 2 * t) * DH + g;
    const float* v1 = vt + (tok0 + 2 * t + 1) * DH + (g ^ 4);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      uint32_t vh0, vl0, vh1, vl1;
      split_tf32(f32_bits(v0[8 * (n ^ t)]), vh0, vl0);
      split_tf32(f32_bits(v1[8 * (n ^ t)]), vh1, vl1);
      mma_tf32(o[n], pa_hi, vl0, vl1);
      mma_tf32(o[n], pa, vh0, vh1);
    }
  } else {
    const int tok = tok0 + (lane & 7);
#pragma unroll
    for (int p = 0; p < DH / 32; ++p) {          // output tiles 4p..4p+3: chunks 4p..4p+3
      const int c = 4 * p + (lane >> 3);
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, smem_u32(vt + tok * DH + ((c ^ (tok & 7)) << 3)));
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_tf32(o[4 * p + e], pa, bf16_lo(vb[e]), bf16_hi(vb[e]));
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Block: `slab_warps` warps share each tile's 8-token groups, for each of
// the row groups of a pass (blockDim.x / 32 warps in all, at most
// kPassWarps).
template <typename QT, typename KT, int DH, int TK>
__global__ void __launch_bounds__(32 * kPassWarps, 1)
paged_decode_tf32_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                         const KT* __restrict__ v_pool, const int* __restrict__ block_table,
                         const int* __restrict__ cache_len, QT* __restrict__ out,
                         float* __restrict__ part_acc, float* __restrict__ part_m,
                         float* __restrict__ part_l, int H, int Hkv, int bs, int NB,
                         int n_splits, int npb, int bkv, float scale_log2, int slab_warps) {
  constexpr int STAGE = TK * DH;       // elements of one K (or V) tile
  constexpr int KS = DH / 8;           // k-steps of Q·Kᵀ, 8-dim tiles of the output
  extern __shared__ __align__(128) uint8_t smem_raw[];
  KT* ring = reinterpret_cast<KT*>(smem_raw);   // [kStages][K, V][TK][DH]

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int rep = H / Hkv;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_groups = (rep + kMaxRep - 1) / kMaxRep;   // row groups of 8 query heads
  const int pass_groups = nt / (32 * slab_warps);
  const int ws = warp % slab_warps, wr = warp / slab_warps;   // slab warp, row group

  const Split sp = split_of(cache_len[b], s, bs, NB, npb);
  const int pos_lo = sp.pos_lo, pos_hi = sp.pos_hi;
  const int n_tiles = (pos_hi - pos_lo + bkv - 1) / bkv;

  for (int rg0 = 0; rg0 < n_groups; rg0 += pass_groups) {
    const bool active = rg0 + wr < n_groups;
    const int row = (rg0 + wr) * kMaxRep + g;          // this lane's query head of the rep
    const bool live_row = active && row < rep;

    // q's row as A fragments: rows 0-7 hi, rows 8-15 lo, k-columns in K's order
    uint32_t qa[KS][4];
    {
      const QT* qr = q + ((long long)b * H + h * rep + (live_row ? row : 0)) * DH;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float x = live_row ? to_f32(qr[k_dim<KT>(ks, t + 4 * jj)]) : 0.f;
          split_tf32(f32_bits(x), qa[ks][2 * jj], qa[ks][2 * jj + 1]);
        }
    }
    float o[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m = kNegInf, l = 0.f;        // row g's max (log2 units) and this lane's share of l

    TileCopier<KT, DH, TK> tiles{k_pool, v_pool, block_table + (long long)b * NB,
                                 (long long)Hkv * DH, (long long)h * DH, bs, bkv,
                                 pos_hi, pos_lo, sp.blk_lo, 0};
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles) tiles.copy(ring, st, tid, nt);
      cp_async_commit();
    }

    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();                 // tile `it` landed; every warp is done with it - 1
      if (it + kStages - 1 < n_tiles) tiles.copy(ring, (it + kStages - 1) % kStages, tid, nt);
      cp_async_commit();
      if (!active) continue;           // warp-uniform: no rows of this pass are the warp's

      const int n_ok = min(bkv, pos_hi - (pos_lo + it * bkv));
      const KT* kt = ring + 2 * (it % kStages) * STAGE;
      const KT* vt = kt + STAGE;
      // the warp's 8-token groups of the tile, one softmax step each
      for (int tok0 = 8 * ws; tok0 < n_ok; tok0 += 8 * slab_warps) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        group_scores<KT, DH>(acc, qa, kt, tok0, lane);

        // row g's scores at slots tok0 + 2t + e: rows g and g + 8 of C
        float sc[2];
        float mx = kNegInf;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) x += acc[i][e] + acc[i][e + 2];
          sc[e] = tok0 + 2 * t + e < n_ok ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, sc[e]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m, mx);
        const float alpha = fast_exp2(m - m_new);
        m = m_new;
        l *= alpha;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          o[n][0] *= alpha;
          o[n][1] *= alpha;
          o[n][2] *= alpha;
          o[n][3] *= alpha;
        }
        const float p0 = fast_exp2(sc[0] - m), p1 = fast_exp2(sc[1] - m);
        l += p0 + p1;
        group_pv<KT, DH>(o, p0, p1, vt, tok0, lane);
      }
    }

    cp_async_wait<0>();
    __syncthreads();                   // the ring is free: it holds the warps' partials now
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (slab_warps == 1) {
      // one warp holds its rows' whole split: write them from registers
      if (live_row) {
        if (n_splits == 1) {
          const float inv = 1.f / (l == 0.f ? 1.f : l);
          QT* orow = out + ((long long)b * H + h * rep + row) * DH;
#pragma unroll
          for (int n = 0; n < KS; ++n)
            store2(orow + 8 * n + 2 * t, (o[n][0] + o[n][2]) * inv, (o[n][1] + o[n][3]) * inv);
        } else {
          const long long prow = (((long long)b * Hkv + h) * n_splits + s) * rep + row;
#pragma unroll
          for (int n = 0; n < KS; ++n)
            store2(part_acc + prow * DH + 8 * n + 2 * t, o[n][0] + o[n][2], o[n][1] + o[n][3]);
          if (t == 0) {
            // natural log, as the combine kernel reads it
            part_m[prow] = m == kNegInf ? kNegInf : m * kLn2;
            part_l[prow] = l;
          }
        }
      }
    } else {
      // merge the slab warps of each row group, by a max-shift
      const int nw = nt / 32;
      float* acc_s = reinterpret_cast<float*>(smem_raw);   // [nw][kMaxRep][DH]
      float* m_s = acc_s + nw * kMaxRep * DH;              // [nw][kMaxRep]
      float* l_s = m_s + nw * kMaxRep;                     // [nw][kMaxRep]
      if (live_row) {
#pragma unroll
        for (int n = 0; n < KS; ++n)
          store2(acc_s + (warp * kMaxRep + g) * DH + 8 * n + 2 * t, o[n][0] + o[n][2],
                 o[n][1] + o[n][3]);
        if (t == 0) {
          m_s[warp * kMaxRep + g] = m;
          l_s[warp * kMaxRep + g] = l;
        }
      }
      __syncthreads();
      for (int i = tid; i < pass_groups * kMaxRep * DH; i += nt) {
        const int d = i % DH, r8 = (i / DH) % kMaxRep, rl = i / (kMaxRep * DH);
        const int r = (rg0 + rl) * kMaxRep + r8;
        if (r >= rep) continue;
        const int w0 = rl * slab_warps;
        float m_g = kNegInf;
        for (int w = 0; w < slab_warps; ++w) m_g = fmaxf(m_g, m_s[(w0 + w) * kMaxRep + r8]);
        float l_g = 0.f, a = 0.f;
        for (int w = 0; w < slab_warps; ++w) {
          const float wt = fast_exp2(m_s[(w0 + w) * kMaxRep + r8] - m_g);
          l_g += wt * l_s[(w0 + w) * kMaxRep + r8];
          a += wt * acc_s[((w0 + w) * kMaxRep + r8) * DH + d];
        }
        if (n_splits == 1) {
          out[((long long)b * H + h * rep + r) * DH + d] =
              from_f32<QT>(a / (l_g == 0.f ? 1.f : l_g));
        } else {
          const long long prow = (((long long)b * Hkv + h) * n_splits + s) * rep + r;
          part_acc[prow * DH + d] = a;
          if (d == 0) {
            part_m[prow] = m_g == kNegInf ? kNegInf : m_g * kLn2;
            part_l[prow] = l_g;
          }
        }
      }
    }
    __syncthreads();                   // the next pass refills the ring
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
  if constexpr (ring_bytes(DH, TK, 2) > kMaxSmem) {   // the ring cannot fit: no kernel
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = ring_bytes(DH, TK, 2);
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

template <typename QT, typename KT, int DH, int TK>
cudaError_t launch_tf32_tile(const Args& a) {
  if constexpr (ring_bytes(DH, TK, sizeof(KT)) > kMaxSmem) {   // the ring cannot fit
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = ring_bytes(DH, TK, sizeof(KT));
    // Warps a tile's 8-token groups are dealt to: all of them up to
    // kPassWarps, as many as the row groups leave room for.  Row groups a
    // pass takes: up to kPassWarps warps in all, and (w0 > 1) no more than
    // the drained ring holds the merge of.
    const int n_groups = (a.H / a.Hkv + kMaxRep - 1) / kMaxRep;
    const int w0 = max(1, min(TK / 8, kPassWarps / min(n_groups, kPassWarps)));
    int groups = min(n_groups, kPassWarps / w0);
    if (w0 > 1) groups = min(groups, (int)(smem / ((size_t)w0 * kMaxRep * (DH + 2) * 4)));
    auto kernel = paged_decode_tf32_kernel<QT, KT, DH, TK>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(a.B, a.Hkv, a.n_splits), 32 * w0 * groups, smem, a.stream>>>(
        static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pool),
        static_cast<const KT*>(a.v_pool), a.block_table, a.cache_len, static_cast<QT*>(a.out),
        a.part_acc, a.part_m, a.part_l, a.H, a.Hkv, a.bs, a.NB, a.n_splits, split_blocks(a),
        a.block_kv, a.scale * kLog2e, w0);
    return launch_combine<QT>(a, DH);
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

template <typename QT, typename KT, int DH>
cudaError_t launch_tf32_dh(const Args& a) {
  switch (tc_tile(a.block_kv)) {
    case 16: return launch_tf32_tile<QT, KT, DH, 16>(a);
    case 32: return launch_tf32_tile<QT, KT, DH, 32>(a);
    case 64: return launch_tf32_tile<QT, KT, DH, 64>(a);
    case 128: return launch_tf32_tile<QT, KT, DH, 128>(a);
    case 256: return launch_tf32_tile<QT, KT, DH, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KT>
cudaError_t launch_tf32(int Dh, const Args& a) {
  if (Dh == 128) return launch_tf32_dh<QT, KT, 128>(a);
  if (Dh == 64) return launch_tf32_dh<QT, KT, 64>(a);
  return cudaErrorInvalidValue;
}

bool tensor_core_path(int rep, int q_bf16, int kv_bf16) {
  return q_bf16 && kv_bf16 && rep <= kMaxRep;
}

}  // namespace

extern "C" {

// Shared memory one block takes, in bytes: the ring of either kernel for a
// tile of block_kv tokens, in the pools' type (bf16 when kv_bf16, else f32).
long long paged_decode_smem_bytes(int Dh, int block_kv, int kv_bf16) {
  return (long long)ring_bytes(Dh, tc_tile(block_kv), kv_bf16 ? 2 : 4);
}

// Launch on `stream`.  q/out: (B, H, Dh) in q's type; k/v pools
// (P, bs, Hkv, Dh) in the pool type; block_table (B, NB) int32; cache_len
// (B,) int32; part_* are f32 scratch of (B, Hkv, n_splits, rep[, Dh]),
// unused when n_splits == 1.  block_kv (a divisor of bs, at most 256) is
// the token tile.  bf16 q and pools with rep <= 8 run the bf16 tensor-core
// kernel, every other pair and rep the 3xTF32 one.  Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a head
// dim or tile the kernels do not take (a ring that does not fit included).
int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                        const void* block_table, const void* cache_len, void* out,
                        void* part_acc, void* part_m, void* part_l, int B, int H, int Hkv,
                        int Dh, int bs, int NB, int n_splits, int block_kv, float scale,
                        int q_bf16, int kv_bf16, void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const int*>(block_table),
               static_cast<const int*>(cache_len), out, static_cast<float*>(part_acc),
               static_cast<float*>(part_m), static_cast<float*>(part_l), B, H, Hkv, bs, NB,
               n_splits, block_kv, scale, static_cast<cudaStream_t>(stream)};
  if (block_kv < 1 || block_kv > kMaxTile || bs % block_kv) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (tensor_core_path(H / Hkv, q_bf16, kv_bf16)) {
    e = Dh == 128 ? launch_tc<128>(a) : Dh == 64 ? launch_tc<64>(a) : cudaErrorInvalidValue;
  } else if (q_bf16 && kv_bf16) {
    e = launch_tf32<__nv_bfloat16, __nv_bfloat16>(Dh, a);
  } else if (q_bf16) {
    e = launch_tf32<__nv_bfloat16, float>(Dh, a);
  } else if (kv_bf16) {
    e = launch_tf32<float, __nv_bfloat16>(Dh, a);
  } else {
    e = launch_tf32<float, float>(Dh, a);
  }
  return (int)e;
}

}  // extern "C"
