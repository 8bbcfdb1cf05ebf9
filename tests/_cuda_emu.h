// A functional CPU emulation of the CUDA features that the f32 flash
// attention kernel (src/repro_torch/kernels/flash_attention/csrc/
// flash_attention.cu), the 3xTF32 paged decode kernel
// (src/repro_torch/kernels/paged_decode/csrc/paged_decode.cu) and the
// 3xTF32 convolution kernel (src/repro_torch/kernels/conv_mm/csrc/
// conv_mm.cu) use, so that their sources, rewritten by
// tests/test_torch_flash_f32_emulated.py,
// tests/test_torch_paged_decode_emulated.py and
// tests/test_torch_conv_mm_f32_emulated.py, compile with g++ and run:
// one OS thread per CUDA thread, a block at a time; __syncthreads is a
// barrier of the block; a warp-wide instruction (ldmatrix, also .trans on
// 16-bit elements, mma.sync, __shfl_xor_sync) gathers the operands of its
// 32 lanes behind a barrier of the warp and gives each lane its part of
// the result; wgmma (m64nNk8 TF32, A from registers, B through a
// 128-byte-swizzle descriptor) does the same over the 128 lanes of its
// warpgroup and completes at once (its fences, commits and waits compile
// to nothing).  cp.async (16 or 4 bytes, zero fill) copies at once (its
// wait is then a no-op).
// mma.sync and wgmma read the TF32 part of their operands (low 13 mantissa
// bits cleared), form exact products and sum them in f32.  bf16 values
// convert as on the card (round to nearest even); the bf16 tensor-core
// instructions compile to nothing, and the kernels that use them are never
// launched here.
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
#define __grid_constant__
#define EMU_NO_ASM(...) ((void)0)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
inline long long clock64() { return 0; }
inline void __trap() { abort(); }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }

inline float __expf(float x) { return expf(x); }

struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<unsigned short>((u >> 16) | 0x40)};
  return {static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline __nv_bfloat16 __float2bfloat16(float f) { return __float2bfloat16_rn(f); }
inline __nv_bfloat162 __halves2bfloat162(__nv_bfloat16 a, __nv_bfloat16 b) { return {a, b}; }
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(unsigned(b.x) << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };
struct CUtensorMap { char bytes[128]; };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_SWIZZLE_64B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_256B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };

struct EmuWarp {
  std::barrier<> bar{32};
  uint32_t lane[32][12];
};
struct EmuWarpgroup {
  std::barrier<> bar{128};
  uint32_t lane[128][4 + 64];
};
struct EmuBlock {
  std::barrier<> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  std::vector<std::unique_ptr<EmuWarpgroup>> groups;
  std::vector<char> smem;
  EmuBlock(int threads, size_t bytes) : bar(threads), smem(bytes + 16) {
    for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new EmuWarp);
    for (int w = 0; w < threads / 128; ++w) groups.emplace_back(new EmuWarpgroup);
  }
};
inline thread_local emu_uint3 threadIdx, blockIdx, gridDim, blockDim;
inline thread_local EmuBlock* emu_block;

inline char* emu_smem() { return emu_block->smem.data(); }
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<const char*>(p) - emu_smem();
}
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline EmuWarp& emu_warp() { return *emu_block->warps[threadIdx.x / 32]; }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  EmuWarp& w = emu_warp();
  const int l = threadIdx.x % 32;
  w.lane[l][0] = __float_as_uint(v);
  w.bar.arrive_and_wait();
  const float r = __uint_as_float(w.lane[l ^ mask][0]);
  w.bar.arrive_and_wait();
  return r;
}

inline void emu_cp_async16(uint32_t dst, const void* src, int src_bytes) {
  if (src_bytes) memcpy(emu_smem() + dst, src, 16);
  else memset(emu_smem() + dst, 0, 16);
}

inline void emu_cp_async4(uint32_t dst, const void* src, int src_bytes) {
  if (src_bytes) memcpy(emu_smem() + dst, src, 4);
  else memset(emu_smem() + dst, 0, 4);
}

// ldmatrix .x4 .b16 on 32-bit elements: lane l gets word l % 4 of row
// l / 4 of matrix i, whose rows lanes 8i..8i+7 address
inline void emu_ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  EmuWarp& w = emu_warp();
  const int l = threadIdx.x % 32;
  w.lane[l][0] = addr;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) memcpy(&r[i], emu_smem() + w.lane[8 * i + l / 4][0] + 4 * (l % 4), 4);
  w.bar.arrive_and_wait();
}

// ldmatrix .x4 .trans .b16: lane l gets the 16-bit elements (2 (l % 4), l / 4)
// and (2 (l % 4) + 1, l / 4) of matrix i, low and high half of r[i]
inline void emu_ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  EmuWarp& w = emu_warp();
  const int l = threadIdx.x % 32;
  w.lane[l][0] = addr;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    memcpy(&lo, emu_smem() + w.lane[8 * i + 2 * (l % 4)][0] + 2 * (l / 4), 2);
    memcpy(&hi, emu_smem() + w.lane[8 * i + 2 * (l % 4) + 1][0] + 2 * (l / 4), 2);
    r[i] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
  w.bar.arrive_and_wait();
}

inline float emu_tf32(uint32_t x) { return __uint_as_float(x & 0xffffe000u); }

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d = a b + d
inline void emu_mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuWarp& w = emu_warp();
  const int l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) w.lane[l][i] = a[i];
  w.lane[l][4] = b0;
  w.lane[l][5] = b1;
  for (int i = 0; i < 4; ++i) w.lane[l][6 + i] = __float_as_uint(d[i]);
  w.bar.arrive_and_wait();
  float A[16][8], B[8][8], C[16][8];
  for (int ln = 0; ln < 32; ++ln) {
    const int g = ln / 4, t = ln % 4;
    A[g][t] = emu_tf32(w.lane[ln][0]);
    A[g + 8][t] = emu_tf32(w.lane[ln][1]);
    A[g][t + 4] = emu_tf32(w.lane[ln][2]);
    A[g + 8][t + 4] = emu_tf32(w.lane[ln][3]);
    B[t][g] = emu_tf32(w.lane[ln][4]);
    B[t + 4][g] = emu_tf32(w.lane[ln][5]);
    C[g][2 * t] = __uint_as_float(w.lane[ln][6]);
    C[g][2 * t + 1] = __uint_as_float(w.lane[ln][7]);
    C[g + 8][2 * t] = __uint_as_float(w.lane[ln][8]);
    C[g + 8][2 * t + 1] = __uint_as_float(w.lane[ln][9]);
  }
  w.bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int i = 0; i < 4; ++i) {
    float s = C[rows[i]][cols[i]];
    for (int k = 0; k < 8; ++k) s += A[rows[i]][k] * B[k][cols[i]];
    d[i] = s;
  }
}

// wgmma.mma_async m64nNk8 .f32.tf32.tf32, A from registers, B K-major from
// shared memory through a descriptor (128-byte swizzle): d = a b + (scale_d
// ? d : 0)
template <int N>
inline void emu_wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                              int scale_d = 1) {
  EmuWarpgroup& w = *emu_block->groups[threadIdx.x / 128];
  const int l = threadIdx.x % 128;
  for (int i = 0; i < 4; ++i) w.lane[l][i] = a[i];
  for (int i = 0; i < N / 2; ++i) w.lane[l][4 + i] = __float_as_uint(d[i]);
  w.bar.arrive_and_wait();
  static thread_local float A[64][8], D[64][N];
  for (int ln = 0; ln < 128; ++ln) {
    const int wr = 16 * (ln / 32), g = (ln % 32) / 4, t = ln % 4;
    A[wr + g][t] = emu_tf32(w.lane[ln][0]);
    A[wr + g + 8][t] = emu_tf32(w.lane[ln][1]);
    A[wr + g][t + 4] = emu_tf32(w.lane[ln][2]);
    A[wr + g + 8][t + 4] = emu_tf32(w.lane[ln][3]);
    for (int j = 0; j < N / 8; ++j) {
      D[wr + g][8 * j + 2 * t] = __uint_as_float(w.lane[ln][4 + 4 * j]);
      D[wr + g][8 * j + 2 * t + 1] = __uint_as_float(w.lane[ln][4 + 4 * j + 1]);
      D[wr + g + 8][8 * j + 2 * t] = __uint_as_float(w.lane[ln][4 + 4 * j + 2]);
      D[wr + g + 8][8 * j + 2 * t + 1] = __uint_as_float(w.lane[ln][4 + 4 * j + 3]);
    }
  }
  w.bar.arrive_and_wait();
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  if ((desc >> 62) != 1) abort();         // the 128-byte swizzle only
  float B[8][N];
  for (int n = 0; n < N; ++n)
    for (int k = 0; k < 8; ++k) {
      uint32_t logical = start + (n / 8) * sbo + (n % 8) * 128 + 4 * k;
      uint32_t phys = logical ^ (((logical >> 7) & 7) << 4);
      uint32_t bits;
      memcpy(&bits, emu_smem() + phys, 4);
      B[k][n] = emu_tf32(bits);
    }
  const int wr = 16 * (l / 32), g = (l % 32) / 4, t = l % 4;
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = wr + g + (e >= 2 ? 8 : 0), c = 8 * j + 2 * t + (e & 1);
      float s = scale_d ? D[r][c] : 0.f;
      for (int k = 0; k < 8; ++k) s += A[r][k] * B[k][c];
      d[4 * j + e] = s;
    }
}

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, A... args) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        EmuBlock block(threads, smem);
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([&, t] {
            emu_block = &block;
            threadIdx = {static_cast<unsigned>(t), 0, 0};
            blockIdx = {bx, by, bz};
            gridDim = {grid.x, grid.y, grid.z};
            blockDim = {static_cast<unsigned>(threads), 1, 1};
            kernel(args...);
          });
        for (auto& th : pool) th.join();
      }
}
