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
// f32 inputs: `flash_attention_f32_kernel`, on the tensor cores in 3xTF32.
//   * Bound: operations.  One TF32 product keeps about three digits (an
//     error near 1e-3 against the 1e-4 gate), so each f32 product is three
//     TF32 products: x = hi + lo with hi = x, its low 13 mantissa bits
//     cleared, and lo = x - hi exactly, of which the tensor cores read the
//     TF32 part; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first
//     (an error near 1e-6).  The bound is three times the work at the TF32
//     rate (495 TFLOP/s); on the CUDA cores it would be the work at 67.
//   * Eight warps, two warpgroups of 64 query rows of a 128-row pass (16 a
//     warp); the block walks its block_q rows in passes.  S and P stay in
//     registers; the online softmax runs on the accumulator fragments (a
//     thread holds two rows, reduced over the 4 threads of a quad).
//   * S = Q K^T is `wgmma.m64nNk8` TF32 (N = the K/V tile), three a k-step.
//     A comes from registers: q, pre-scaled, lies in shared memory for the
//     pass and is split as its fragments are loaded (`ldmatrix`).  B comes
//     from shared memory, K-major, 128-byte swizzled: the raw K tile is its
//     own hi part (the tensor cores read only its TF32 bits), and each tile
//     K - hi is written once beside it in the same layout, for the block.
//   * O += P V is `mma.sync.m16n8k8` TF32, three a product, a warp's 16 rows
//     at a time: the C fragment holds keys 2t and 2t + 1 of each 8-key slice
//     of P, used as A's k-columns t and t + 4, and V's B fragment is read at
//     keys 8j + 2t and 8j + 2t + 1 to match and split in registers.  V would
//     need a transposed tile (and its lo part) in shared memory for `wgmma`,
//     which the budget does not hold beside the ring.
//   * K and V stream through a kF32Stages-deep `cp.async` ring of f32 tiles
//     of BN keys (`f32_kv_tile`: 32 for block_k <= 32, else 64 where it
//     fits); V's rows are padded to Dh + 4 floats, so its fragment loads are
//     free of bank conflicts, as the swizzle makes Q's.  Keys past Sk are
//     zero-filled and dropped (score -inf, weight exactly 0).
//   * The causal early stop and the skip of tiles masked for all rows of a
//     warpgroup are the bf16 kernel's; a warpgroup with a fully masked row
//     reads every tile.  Shared memory 1024 B of alignment slack and 4
//     (kF32Rows Dh + (kF32Stages + 1) BN Dh + kF32Stages BN (Dh + 4)) bytes
//     (`flash_attention_smem_bytes`).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;

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

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (S on wgmma, P V on mma.sync), a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Rows = 16 * kF32Warps;      // query rows per pass: 16 a warp
constexpr int kF32Stages = 2;                 // K/V ring depth

size_t f32_smem_bytes(int Dh, int bn) {
  return 1024 + 4 * ((size_t)kF32Rows * Dh + (size_t)(kF32Stages + 1) * bn * Dh +
                     (size_t)kF32Stages * bn * (Dh + 4));
}

// keys in one K/V tile of the f32 kernel
int f32_kv_tile(int Dh, int block_k) {
  return block_k > 32 && f32_smem_bytes(Dh, 64) <= (size_t)kMaxSmem ? 64 : 32;
}

// 16 bytes global -> shared, or 16 zero bytes where `src_bytes` is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// four 8 x 4 f32 matrices (rows of 16 bytes, one address per lane: lanes
// 8i..8i+7 give the rows of matrix i); lane l gets element (l / 4, l % 4)
// of matrix i in r[i], the layout of an m16n8k8 TF32 fragment
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi exactly; the tensor cores read lo's TF32 part
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int N> struct WgmmaTf32;

template <> struct WgmmaTf32<32> {
  // d(64 x 32) += a(64 x 8) b(8 x 32); a in registers, b K-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct WgmmaTf32<64> {
  // d(64 x 64) += a(64 x 8) b(8 x 64); a in registers, b K-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from reusing an in-flight wgmma's A registers
__device__ __forceinline__ void hold_regs(const uint32_t (&r)[4]) {
  asm volatile("" ::"r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// float offset of 16-byte chunk c of row r in a [c / 8][rows][32] f32 tile
// whose 128-byte rows are swizzled (chunk c % 8 at (c % 8) ^ (r % 8)), the
// layout `wgmma` reads through a 128-byte-swizzle descriptor
__device__ __forceinline__ int swz(int rows, int r, int c) {
  return (c >> 3) * rows * 32 + r * 32 + (((c & 7) ^ (r & 7)) << 2);
}

template <int DH, int BN>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int H,
                           int Hkv, int Sq, int Sk, int block_q, int causal, int q_offset,
                           float scale) {
  constexpr int LD = DH + 4;                 // V's shared-memory row stride, floats
  constexpr int CH = DH / 4;                 // 16-byte chunks of a row
  constexpr int NT = DH / 8;                 // 8-column tiles of the output
  constexpr int KT = BN / 8;                 // 8-key slices of a K/V tile
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(16) float smem_f32[];
  float* base = smem_f32 + (((smem_addr(smem_f32) + 1023u) & ~1023u) - smem_addr(smem_f32)) / 4;
  float* Qs = base;                          // kF32Rows x DH, swizzled: q * scale
  float* Kr = Qs + kF32Rows * DH;            // kF32Stages x BN x DH, swizzled: K (its hi part)
  float* Kl = Kr + kF32Stages * BN * DH;     // BN x DH, swizzled: K - hi
  float* Vs = Kl + BN * DH;                  // kF32Stages x BN x LD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (H / Hkv);
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int row_begin = qb * block_q;
  const int row_end = min(row_begin + block_q, Sq);
  const float* qh = q + (size_t)(b * H + h) * Sq * DH;
  const float* kh = k + (size_t)(b * Hkv + hk) * Sk * DH;
  const float* vh = v + (size_t)(b * Hkv + hk) * Sk * DH;
  float* oh = out + (size_t)(b * H + h) * Sq * DH;

  // the K and V rows of tile t -> stage s
  auto load_tile = [&](int t, int s) {
    for (int i = tid; i < BN * CH; i += kF32Threads) {
      const int r = i / CH, c = i % CH, key = t * BN + r;
      const size_t off = (size_t)min(key, Sk - 1) * DH + 4 * c;
      const int bytes = key < Sk ? 16 : 0;
      cp_async16(smem_addr(Kr + s * BN * DH + swz(BN, r, c)), kh + off, bytes);
      cp_async16(smem_addr(Vs + (s * BN + r) * LD + 4 * c), vh + off, bytes);
    }
  };

  // ldmatrix rows of this warp's Q fragments: row (li & 1) * 8 + lr of its
  // 16, chunk 2 kk + (li >> 1) of k-step kk
  const int lr = lane % 8, li = lane / 8;
  const int q_row = 16 * warp + (li & 1) * 8 + lr;
  const int wg = warp / 4;

  for (int r0 = row_begin; r0 < row_end; r0 += kF32Rows) {
    const int nr = min(kF32Rows, row_end - r0);
    const int n_tiles = (kv_end(r0, nr, Sk, causal, q_offset) + BN - 1) / BN;
    const int gr0 = r0 + 64 * wg;                      // the warpgroup's first row
    const int gnr = min(64, row_end - gr0);
    const int g_tiles = gnr > 0 ? (kv_end(gr0, gnr, Sk, causal, q_offset) + BN - 1) / BN : 0;
    const int wr0 = r0 + 16 * warp;                    // the warp's first row
    const int pos_a = q_offset + wr0 + g, pos_b = pos_a + 8;

    __syncthreads();
#pragma unroll
    for (int p = 0; p < kF32Stages - 1; ++p) {
      if (p < n_tiles) load_tile(p, p);
      cp_async_commit();
    }
    for (int i = tid; i < kF32Rows * CH; i += kF32Threads) {
      const int r = i / CH, c = i % CH;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr) {
        x = *reinterpret_cast<const float4*>(qh + (size_t)(r0 + r) * DH + 4 * c);
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
      }
      *reinterpret_cast<float4*>(Qs + swz(kF32Rows, r, c)) = x;
    }

    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const int nt_ = t + kF32Stages - 1;
      if (nt_ < n_tiles) load_tile(nt_, nt_ % kF32Stages);
      cp_async_commit();
      cp_async_wait<kF32Stages - 1>();
      __syncthreads();                       // tile t (and Q) landed for every thread
      const int s = t % kF32Stages;
      // K's lo part beside its raw tile, in the same layout
      {
        const float4* src = reinterpret_cast<const float4*>(Kr + s * BN * DH);
        float4* dst = reinterpret_cast<float4*>(Kl);
        for (int i = tid; i < BN * CH; i += kF32Threads) {
          float4 x = src[i];
          x.x -= __uint_as_float(__float_as_uint(x.x) & 0xffffe000u);
          x.y -= __uint_as_float(__float_as_uint(x.y) & 0xffffe000u);
          x.z -= __uint_as_float(__float_as_uint(x.z) & 0xffffe000u);
          x.w -= __uint_as_float(__float_as_uint(x.w) & 0xffffe000u);
          dst[i] = x;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();                       // K's lo part written and visible to wgmma
      if (t < g_tiles) {
        // S = Q K^T: per k-step, a_lo K_hi + a_hi K_lo + a_hi K_hi on wgmma
        float sc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
        const uint32_t kr = smem_addr(Kr + s * BN * DH), kl = smem_addr(Kl);
        uint32_t ah_prev[4], al_prev[4];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 8; ++kk) {
          uint32_t a[4], ah[4], al[4];
          ldsm_x4(smem_addr(Qs + swz(kF32Rows, q_row, 2 * kk + (li >> 1))), a);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
          const uint32_t off = (kk / 4) * BN * 128 + (kk % 4) * 32;
          wgmma_fence();
          WgmmaTf32<BN>::rs(sc, al, gmma_desc<128>(kr + off, 16, 1024));
          WgmmaTf32<BN>::rs(sc, ah, gmma_desc<128>(kl + off, 16, 1024));
          WgmmaTf32<BN>::rs(sc, ah, gmma_desc<128>(kr + off, 16, 1024));
          wgmma_commit();
          if (kk > 0) {
            wgmma_wait<1>();
            hold_regs(ah_prev);
            hold_regs(al_prev);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah_prev[i] = ah[i];
            al_prev[i] = al[i];
          }
        }
        wgmma_wait<0>();
        hold_regs(ah_prev);
        hold_regs(al_prev);
        fence_regs(sc);

        // mask, online softmax (log2 domain)
        const int k0 = t * BN;
        const bool edge = k0 + BN > Sk;
        const bool diag = causal && k0 + BN - 1 > q_offset + wr0;
        const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
        float mx_a = neg_inf, mx_b = neg_inf;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float va = sc[4 * j + e] * kLog2e, vb = sc[4 * j + 2 + e] * kLog2e;
            if (edge || diag) {
              const int key = k0 + 8 * j + 2 * t4 + e;
              if (key >= Sk) {
                va = vb = neg_inf;
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
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          sc[4 * j] = ex2(sc[4 * j] - mn_a);
          sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn_a);
          sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn_b);
          sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn_b);
          sum_a += sc[4 * j] + sc[4 * j + 1];
          sum_b += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          o[j][0] *= al_a;
          o[j][1] *= al_a;
          o[j][2] *= al_b;
          o[j][3] *= al_b;
        }

        // O += P V on mma.sync (see the fragment note of the mma.sync kernel)
        const float* v_frag = Vs + (s * BN + 2 * t4) * LD + g;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          uint32_t ph[4], pl[4];
          split_tf32(__float_as_uint(sc[4 * j]), ph[0], pl[0]);
          split_tf32(__float_as_uint(sc[4 * j + 2]), ph[1], pl[1]);
          split_tf32(__float_as_uint(sc[4 * j + 1]), ph[2], pl[2]);
          split_tf32(__float_as_uint(sc[4 * j + 3]), ph[3], pl[3]);
          const float* vj = v_frag + 8 * j * LD;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(__float_as_uint(vj[8 * n]), bh0, bl0);
            split_tf32(__float_as_uint(vj[LD + 8 * n]), bh1, bl1);
            mma_3xtf32(o[n], ph, pl, bh0, bh1, bl0, bl1);
          }
        }
      }
      __syncthreads();                       // every warp is done with stage s and K's lo part
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
    const int row_a = wr0 + g, row_b = row_a + 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t4;
      if (row_a < row_end)
        *reinterpret_cast<float2*>(oh + (size_t)row_a * DH + col) =
            make_float2(o[j][0] * inv_a, o[j][1] * inv_a);
      if (row_b < row_end)
        *reinterpret_cast<float2*>(oh + (size_t)row_b * DH + col) =
            make_float2(o[j][2] * inv_b, o[j][3] * inv_b);
    }
  }
}

template <int DH, int BN>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H,
                       int Hkv, int Sq, int Sk, int block_q, int causal, int q_offset,
                       float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(DH, BN);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = flash_attention_f32_kernel<DH, BN>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, (Sq + block_q - 1) / block_q);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Hkv, Sq, Sk, block_q, causal,
      q_offset, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(bool bf16, const void* q, const void* k, const void* v, void* out, int B,
                      int H, int Hkv, int Sq, int Sk, int block_q, int block_k, int causal,
                      int q_offset, float scale, cudaStream_t s) {
  if (!bf16) {
    if (f32_kv_tile(DH, block_k) == 64)
      return launch_f32<DH, 64>(q, k, v, out, B, H, Hkv, Sq, Sk, block_q, causal, q_offset,
                                scale, s);
    return launch_f32<DH, 32>(q, k, v, out, B, H, Hkv, Sq, Sk, block_q, causal, q_offset,
                              scale, s);
  }
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
                          : f32_smem_bytes(Dh, f32_kv_tile(Dh, block_k)));
}

// Launch on `stream`.  q/out (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh), contiguous,
// 16-byte aligned, one type (bf16 when `bf16`, else f32); Dh in {32, 64,
// 128}; block_q >= 1 query rows per block, block_k >= 1 (sets the ring's
// tile: `kv_tile` for bf16, `f32_kv_tile` for f32).  Returns
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
