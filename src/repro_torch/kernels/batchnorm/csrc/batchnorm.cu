// BatchNorm with batch statistics and its activation, forward and
// backward, for Hopper (sm_90a), over NHWC f32.
//
// Replaces no TPU kernel: the reference's CNN (src/repro/models/cnn.py,
// `C.apply`) leaves BatchNorm to XLA, which fuses it.  The port ran it as
// six eager ops and the activation, and autograd differentiated them op by
// op; that chain set every cell of the CNN benchmark (PERF.md §5), so it is
// fused here.
//
// What it computes, for y (M, C) row-major (M = N*H*W pixels, C channels):
//   forward   mean = (1/M) sum y,  var = (1/M) sum (y - mean)^2 (biased),
//             rstd = rsqrt(var + 1e-5),
//             z = act(((y - mean) * rstd) * scale + shift),
//   backward  x = (y - mean) * rstd,  p = x * scale + shift,
//             dz' = dz masked by act'(p) ([p > 0] relu, [0 < p < 6] relu6),
//             dshift = sum dz',  dscale = sum dz' * x,
//             dy = scale * rstd * (dz' - (dshift + x * dscale) / M).
// Each operation of the forward's z and of the backward's x and p is
// rounded as the plain formula rounds it (`__fsub_rn`, `__fmul_rn`,
// `__fadd_rn`: no contraction into a fused multiply-add, and no folding into
// a * y + b), so z is the plain formula of the same mean and rstd to the
// bit, and the backward's mask sees the forward's p.
//
// Bound: bytes.  A few operations per element against 4 bytes; the
// forward needs 3 passes over y (read for the statistics, read again, write
// z) and the backward 5 (read dz and y for the two sums, read them again and
// write dy), at 3.35 TB/s.  Nothing of full size is kept between the
// passes: the backward recomputes x and p from y, mean and rstd.
//
// Design.
//   * Row kernels (statistics, apply, reduce, grad): a 256-thread block
//     takes a slice of at most 64 column units (a unit is 4 channels, one
//     16-byte load, where C % 4 == 0 and the tensors are 16-byte aligned;
//     else 1 channel) and a chunk of rows; its threads are (column, lane),
//     lane r walking rows r, r + lanes, ... of the chunk, four rows' loads
//     (eight in the statistics kernel) issued before their arithmetic.
//     Where a slice holds whole rows a warp reads contiguous memory across
//     rows.  The grid is the slices
//     times enough chunks for one wave of resident blocks on every SM
//     (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), from stage 1 of
//     ResNet-50 at bs 256 (M 262,144, C 64: one slice, ~800 chunks) to
//     stage 4 (M 4,096, C 2,048: eight slices).  A thread keeps its
//     channels' mean, rstd, scale and shift in registers.
//   * Statistics: each thread keeps Welford's (count, mean, M2) for its
//     channels over its rows (one reciprocal a row for all its channels);
//     the block merges its lanes in lane order with Chan's formula and
//     writes one partial (mean, M2) a chunk to scratch.  The mean comes
//     first and the variance is centred: there is no sum of squares.
//   * Reduce (backward): plain f32 sums of dz' and dz' * x a thread, the
//     lanes summed in lane order, one partial a chunk.
//   * Finalize: a block of 8 channels x 128 lanes; lane l merges chunks
//     l, l + 128, ... in order (four chunks' loads issued together), then
//     the lanes in a fixed tree.  So every sum is taken in one fixed
//     order: the result does not change from run to run, and no value goes
//     through an atomic.
//   * Launches: forward statistics, finalize, apply; backward reduce,
//     finalize, grad, on the caller's stream.  The scratch of partials,
//     2 * chunks * C floats, is the caller's (`batchnorm_chunks` gives
//     chunks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads of a row kernel's block
constexpr int kMaxCols = 64;     // column units of a block's slice
constexpr int kFinCols = 8;      // channels of a finalize block
constexpr int kFinLanes = 128;   // chunk lanes of a finalize block
constexpr int kUnroll = 4;       // rows whose loads a thread issues together
constexpr int kStatsUnroll = 8;  // the same for the statistics kernel
constexpr float kEps = 1e-5f;

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2 };

struct Geom {
  int M, C;          // rows (pixels) and channels
  int cols, lanes;   // column units and row lanes of a block
  int slices;        // blocks across the channels
  int chunk_rows;    // rows of a block (a multiple of lanes)
  int chunks;        // blocks across the rows
};

// `blocks`: how many blocks of the kernel the card holds at once.
Geom make_geom(int M, int C, int V, int blocks) {
  Geom g;
  g.M = M;
  g.C = C;
  const int units = C / V;
  g.cols = units < kMaxCols ? units : kMaxCols;
  g.lanes = kThreads / g.cols;
  g.slices = (units + g.cols - 1) / g.cols;
  long long want = blocks / g.slices;
  if (want < 1) want = 1;
  long long rows = ((long long)M + want - 1) / want;
  rows = (rows + g.lanes - 1) / g.lanes * g.lanes;
  g.chunk_rows = (int)rows;
  g.chunks = (int)(((long long)M + rows - 1) / rows);
  return g;
}

template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// A thread's place in a row kernel's block.
struct Place {
  int col, lane, c;    // column unit in the slice, row lane, first channel
  bool active;         // holds a lane (lanes * cols may be < kThreads)
  bool inside;         // active and its channels exist
  long long r0, r1;    // the block's rows [r0, r1)
};

template <int V>
__device__ __forceinline__ Place place(const Geom& g) {
  Place p;
  p.col = threadIdx.x % g.cols;
  p.lane = threadIdx.x / g.cols;
  const int unit = blockIdx.x * g.cols + p.col;
  p.c = unit * V;
  p.active = p.lane < g.lanes;
  p.inside = p.active && p.c < g.C;
  p.r0 = (long long)blockIdx.y * g.chunk_rows;
  p.r1 = p.r0 + g.chunk_rows < g.M ? p.r0 + g.chunk_rows : g.M;
  return p;
}

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ src, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(src);
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ dst, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    dst[0] = v[0];
  }
}

template <int V>
__device__ __forceinline__ void load_params(const float* __restrict__ a, int c, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = __ldg(a + c + i);
}

template <int ACT>
__device__ __forceinline__ float activate(float p) {
  if constexpr (ACT == kRelu) return p <= 0.f ? 0.f : p;            // NaN stays NaN
  if constexpr (ACT == kRelu6) return p <= 0.f ? 0.f : (p >= 6.f ? 6.f : p);
  return p;
}

template <int ACT>
__device__ __forceinline__ float mask(float dz, float p) {
  if constexpr (ACT == kRelu) return p > 0.f ? dz : 0.f;
  if constexpr (ACT == kRelu6) return (p > 0.f && p < 6.f) ? dz : 0.f;
  return dz;
}

// (y - mean) * rstd, rounded as the plain formula rounds it
__device__ __forceinline__ float normalized(float y, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(y, mean), rstd);
}

// x * scale + shift, rounded as the plain formula rounds it
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

// Chan's merge of (nb, mb, qb) into (n, m, q): counts, means, M2s.
__device__ __forceinline__ void chan(float& n, float& m, float& q, float nb, float mb, float qb) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - m;
  const float wb = nb / nn;
  m = m + d * wb;
  q = q + qb + d * d * n * wb;
  n = nn;
}

// Runs `body(k)` for the rows r0 + lane, r0 + lane + lanes, ... below r1,
// after `fetch(r, k)` for up to U of them at once (k is the row's slot).
template <int U, class Fetch, class Body>
__device__ __forceinline__ void walk_rows(const Place& p, int lanes, Fetch fetch, Body body) {
  long long r = p.r0 + p.lane;
  for (; r + (long long)(U - 1) * lanes < p.r1; r += (long long)U * lanes) {
#pragma unroll
    for (int k = 0; k < U; ++k) fetch(r + (long long)k * lanes, k);
#pragma unroll
    for (int k = 0; k < U; ++k) body(k);
  }
  for (; r < p.r1; r += lanes) {
    fetch(r, 0);
    body(0);
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads)
batchnorm_stats_kernel(const float* __restrict__ y, float* __restrict__ part_mean,
                       float* __restrict__ part_m2, Geom g) {
  __shared__ float sh_mean[kThreads * V];
  __shared__ float sh_m2[kThreads * V];
  __shared__ float sh_n[kThreads];
  const Place p = place<V>(g);
  float n = 0.f, mean[V], m2[V], buf[kStatsUnroll][V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
  if (p.inside) {
    walk_rows<kStatsUnroll>(
        p, g.lanes, [&](long long r, int k) { load<V>(y + r * g.C + p.c, buf[k]); },
        [&](int k) {
          n += 1.f;
          const float inv = __frcp_rn(n);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float d = buf[k][i] - mean[i];
            mean[i] += d * inv;
            m2[i] += d * (buf[k][i] - mean[i]);
          }
        });
  }
  const int slots = g.cols * V;
  if (p.active) {
    if (p.col == 0) sh_n[p.lane] = n;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sh_mean[p.lane * slots + p.col * V + i] = mean[i];
      sh_m2[p.lane * slots + p.col * V + i] = m2[i];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int ch = blockIdx.x * slots + t;
  if (t < slots && ch < g.C) {
    float bn = 0.f, bm = 0.f, bq = 0.f;
    for (int l = 0; l < g.lanes; ++l)
      chan(bn, bm, bq, sh_n[l], sh_mean[l * slots + t], sh_m2[l * slots + t]);
    part_mean[(long long)blockIdx.y * g.C + ch] = bm;
    part_m2[(long long)blockIdx.y * g.C + ch] = bq;
  }
}

// The chunks' partials merged into mean and rstd (WELFORD) or summed into
// the two sums (otherwise), kFinCols channels a block.
template <bool WELFORD>
__global__ void __launch_bounds__(kFinCols * kFinLanes)
batchnorm_finalize_kernel(const float* __restrict__ part_a, const float* __restrict__ part_b,
                          float* __restrict__ out_a, float* __restrict__ out_b, Geom g) {
  __shared__ float sn[kFinLanes][kFinCols + 1];
  __shared__ float sa[kFinLanes][kFinCols + 1];
  __shared__ float sb[kFinLanes][kFinCols + 1];
  const int col = threadIdx.x % kFinCols, lane = threadIdx.x / kFinCols;
  const int c = blockIdx.x * kFinCols + col;
  float n = 0.f, a = 0.f, b = 0.f;
  if (c < g.C) {
    auto take = [&](int k, float pa, float pb) {
      if constexpr (WELFORD) {
        const long long rows = (long long)g.M - (long long)k * g.chunk_rows;
        chan(n, a, b, (float)(rows < g.chunk_rows ? rows : g.chunk_rows), pa, pb);
      } else {
        a += pa;
        b += pb;
      }
    };
    int k = lane;
    for (; k + 3 * kFinLanes < g.chunks; k += 4 * kFinLanes) {
      float pa[4], pb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long at = (long long)(k + u * kFinLanes) * g.C + c;
        pa[u] = part_a[at];
        pb[u] = part_b[at];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) take(k + u * kFinLanes, pa[u], pb[u]);
    }
    for (; k < g.chunks; k += kFinLanes) {
      const long long at = (long long)k * g.C + c;
      take(k, part_a[at], part_b[at]);
    }
  }
  sn[lane][col] = n;
  sa[lane][col] = a;
  sb[lane][col] = b;
  __syncthreads();
  for (int s = kFinLanes / 2; s > 0; s >>= 1) {
    if (lane < s) {
      if constexpr (WELFORD) {
        chan(n, a, b, sn[lane + s][col], sa[lane + s][col], sb[lane + s][col]);
        sn[lane][col] = n;
      } else {
        a += sa[lane + s][col];
        b += sb[lane + s][col];
      }
      sa[lane][col] = a;
      sb[lane][col] = b;
    }
    __syncthreads();
  }
  if (lane == 0 && c < g.C) {
    if constexpr (WELFORD) {
      out_a[c] = a;
      out_b[c] = rsqrtf(b / (float)g.M + kEps);
    } else {
      out_a[c] = a;
      out_b[c] = b;
    }
  }
}

template <int V, int ACT>
__global__ void __launch_bounds__(kThreads)
batchnorm_apply_kernel(const float* __restrict__ y, const float* __restrict__ mean,
                       const float* __restrict__ rstd, const float* __restrict__ scale,
                       const float* __restrict__ shift, float* __restrict__ z, Geom g) {
  const Place p = place<V>(g);
  if (!p.inside) return;
  float mu[V], rs[V], ga[V], be[V], buf[kUnroll][V];
  load_params<V>(mean, p.c, mu);
  load_params<V>(rstd, p.c, rs);
  load_params<V>(scale, p.c, ga);
  load_params<V>(shift, p.c, be);
  long long row[kUnroll];
  walk_rows<kUnroll>(
      p, g.lanes,
      [&](long long r, int k) {
        row[k] = r;
        load<V>(y + r * g.C + p.c, buf[k]);
      },
      [&](int k) {
        float out[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          out[i] = activate<ACT>(affine(normalized(buf[k][i], mu[i], rs[i]), ga[i], be[i]));
        store<V>(z + row[k] * g.C + p.c, out);
      });
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <int V, int ACT>
__global__ void __launch_bounds__(kThreads)
batchnorm_reduce_kernel(const float* __restrict__ dz, const float* __restrict__ y,
                        const float* __restrict__ mean, const float* __restrict__ rstd,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        float* __restrict__ part_s1, float* __restrict__ part_s2, Geom g) {
  __shared__ float sh_s1[kThreads * V];
  __shared__ float sh_s2[kThreads * V];
  const Place p = place<V>(g);
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (p.inside) {
    float mu[V], rs[V], ga[V], be[V], bd[kUnroll][V], by[kUnroll][V];
    load_params<V>(mean, p.c, mu);
    load_params<V>(rstd, p.c, rs);
    load_params<V>(scale, p.c, ga);
    load_params<V>(shift, p.c, be);
    walk_rows<kUnroll>(
        p, g.lanes,
        [&](long long r, int k) {
          load<V>(dz + r * g.C + p.c, bd[k]);
          load<V>(y + r * g.C + p.c, by[k]);
        },
        [&](int k) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float x = normalized(by[k][i], mu[i], rs[i]);
            const float d = mask<ACT>(bd[k][i], affine(x, ga[i], be[i]));
            s1[i] += d;
            s2[i] += d * x;
          }
        });
  }
  const int slots = g.cols * V;
  if (p.active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sh_s1[p.lane * slots + p.col * V + i] = s1[i];
      sh_s2[p.lane * slots + p.col * V + i] = s2[i];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int ch = blockIdx.x * slots + t;
  if (t < slots && ch < g.C) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < g.lanes; ++l) {
      a += sh_s1[l * slots + t];
      b += sh_s2[l * slots + t];
    }
    part_s1[(long long)blockIdx.y * g.C + ch] = a;
    part_s2[(long long)blockIdx.y * g.C + ch] = b;
  }
}

template <int V, int ACT>
__global__ void __launch_bounds__(kThreads)
batchnorm_grad_kernel(const float* __restrict__ dz, const float* __restrict__ y,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ dshift, const float* __restrict__ dscale,
                      float* __restrict__ dy, Geom g) {
  const Place p = place<V>(g);
  if (!p.inside) return;
  float mu[V], rs[V], ga[V], be[V], s1[V], s2[V], k0[V], bd[kUnroll][V], by[kUnroll][V];
  load_params<V>(mean, p.c, mu);
  load_params<V>(rstd, p.c, rs);
  load_params<V>(scale, p.c, ga);
  load_params<V>(shift, p.c, be);
  load_params<V>(dshift, p.c, s1);
  load_params<V>(dscale, p.c, s2);
#pragma unroll
  for (int i = 0; i < V; ++i) k0[i] = __fmul_rn(ga[i], rs[i]);
  const float m = (float)g.M;
  long long row[kUnroll];
  walk_rows<kUnroll>(
      p, g.lanes,
      [&](long long r, int k) {
        row[k] = r;
        load<V>(dz + r * g.C + p.c, bd[k]);
        load<V>(y + r * g.C + p.c, by[k]);
      },
      [&](int k) {
        float out[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float x = normalized(by[k][i], mu[i], rs[i]);
          const float d = mask<ACT>(bd[k][i], affine(x, ga[i], be[i]));
          const float mean_part = __fdiv_rn(__fadd_rn(s1[i], __fmul_rn(x, s2[i])), m);
          out[i] = __fmul_rn(k0[i], __fsub_rn(d, mean_part));
        }
        store<V>(dy + row[k] * g.C + p.c, out);
      });
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int V>
int stats_blocks() {
  static const int n = resident_blocks(batchnorm_stats_kernel<V>);
  return n;
}

template <int V, int ACT>
int reduce_blocks() {
  static const int n = resident_blocks(batchnorm_reduce_kernel<V, ACT>);
  return n;
}

template <int V, int ACT>
cudaError_t forward(const float* y, const float* scale, const float* shift, float* z,
                    float* mean, float* rstd, float* scratch, int M, int C, int chunks,
                    cudaStream_t s) {
  const Geom gs = make_geom(M, C, V, stats_blocks<V>());
  if (gs.chunks != chunks) return cudaErrorInvalidValue;
  float* part_mean = scratch;
  float* part_m2 = scratch + (long long)chunks * C;
  batchnorm_stats_kernel<V><<<dim3(gs.slices, gs.chunks), kThreads, 0, s>>>(y, part_mean,
                                                                          part_m2, gs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  batchnorm_finalize_kernel<true><<<(C + kFinCols - 1) / kFinCols, kFinCols * kFinLanes, 0, s>>>(
      part_mean, part_m2, mean, rstd, gs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static const int apply_blocks = resident_blocks(batchnorm_apply_kernel<V, ACT>);
  const Geom ga = make_geom(M, C, V, apply_blocks);
  batchnorm_apply_kernel<V, ACT><<<dim3(ga.slices, ga.chunks), kThreads, 0, s>>>(
      y, mean, rstd, scale, shift, z, ga);
  return cudaGetLastError();
}

template <int V, int ACT>
cudaError_t backward(const float* dz, const float* y, const float* scale, const float* shift,
                     const float* mean, const float* rstd, float* dy, float* dscale,
                     float* dshift, float* scratch, int M, int C, int chunks, cudaStream_t s) {
  const Geom gr = make_geom(M, C, V, reduce_blocks<V, ACT>());
  if (gr.chunks != chunks) return cudaErrorInvalidValue;
  float* part_s1 = scratch;
  float* part_s2 = scratch + (long long)chunks * C;
  batchnorm_reduce_kernel<V, ACT><<<dim3(gr.slices, gr.chunks), kThreads, 0, s>>>(
      dz, y, mean, rstd, scale, shift, part_s1, part_s2, gr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  batchnorm_finalize_kernel<false><<<(C + kFinCols - 1) / kFinCols, kFinCols * kFinLanes, 0,
                                     s>>>(part_s1, part_s2, dshift, dscale, gr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  static const int grad_blocks = resident_blocks(batchnorm_grad_kernel<V, ACT>);
  const Geom gg = make_geom(M, C, V, grad_blocks);
  batchnorm_grad_kernel<V, ACT><<<dim3(gg.slices, gg.chunks), kThreads, 0, s>>>(
      dz, y, mean, rstd, scale, shift, dshift, dscale, dy, gg);
  return cudaGetLastError();
}

bool valid(int M, int C, int act, int vec) {
  return M > 0 && C > 0 && act >= kNone && act <= kRelu6 && (!vec || C % 4 == 0);
}

}  // namespace

extern "C" {

// Rows of partials (the scratch holds 2 * chunks * C floats) that
// `batchnorm_forward` (backward = 0) or `batchnorm_backward` (backward != 0)
// takes for these arguments; -1 if they are invalid.
int batchnorm_chunks(int M, int C, int act, int vec, int backward) {
  if (!valid(M, C, act, vec)) return -1;
  const int V = vec ? 4 : 1;
  int blocks;
  if (!backward) {
    blocks = vec ? stats_blocks<4>() : stats_blocks<1>();
  } else if (vec) {
    blocks = act == kRelu ? reduce_blocks<4, kRelu>()
             : act == kRelu6 ? reduce_blocks<4, kRelu6>() : reduce_blocks<4, kNone>();
  } else {
    blocks = act == kRelu ? reduce_blocks<1, kRelu>()
             : act == kRelu6 ? reduce_blocks<1, kRelu6>() : reduce_blocks<1, kNone>();
  }
  return make_geom(M, C, V, blocks).chunks;
}

// y, z: (M, C) row-major f32; scale, shift, mean, rstd: (C,); scratch:
// 2 * chunks * C floats.  act: 0 none, 1 relu, 2 relu6.  vec: 16-byte loads
// (C % 4 == 0 and y, z 16-byte aligned).  Writes z, mean and rstd.
// Returns the cudaError_t of the launches (0 on success); launches on
// `stream`, does not synchronise and allocates nothing.
int batchnorm_forward(const void* y, const void* scale, const void* shift, void* z, void* mean,
                      void* rstd, void* scratch, int M, int C, int chunks, int act, int vec,
                      void* stream) {
  if (!valid(M, C, act, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* yf = static_cast<const float*>(y);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* zf = static_cast<float*>(z);
  auto* mu = static_cast<float*>(mean);
  auto* rs = static_cast<float*>(rstd);
  auto* sf = static_cast<float*>(scratch);
#define BN_FORWARD(V, A) (int)forward<V, A>(yf, sc, sh, zf, mu, rs, sf, M, C, chunks, s)
  if (vec) {
    if (act == kRelu) return BN_FORWARD(4, kRelu);
    if (act == kRelu6) return BN_FORWARD(4, kRelu6);
    return BN_FORWARD(4, kNone);
  }
  if (act == kRelu) return BN_FORWARD(1, kRelu);
  if (act == kRelu6) return BN_FORWARD(1, kRelu6);
  return BN_FORWARD(1, kNone);
#undef BN_FORWARD
}

// dz, y, dy: (M, C) row-major f32; scale, shift, mean, rstd (the forward's),
// dscale, dshift: (C,); scratch: 2 * chunks * C floats.  vec: 16-byte loads
// (C % 4 == 0 and dz, y, dy 16-byte aligned).  Writes dy, dscale and dshift.
// Returns the cudaError_t of the launches (0 on success); launches on
// `stream`, does not synchronise and allocates nothing.
int batchnorm_backward(const void* dz, const void* y, const void* scale, const void* shift,
                       const void* mean, const void* rstd, void* dy, void* dscale, void* dshift,
                       void* scratch, int M, int C, int chunks, int act, int vec, void* stream) {
  if (!valid(M, C, act, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dzf = static_cast<const float*>(dz);
  const auto* yf = static_cast<const float*>(y);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  const auto* mu = static_cast<const float*>(mean);
  const auto* rs = static_cast<const float*>(rstd);
  auto* dyf = static_cast<float*>(dy);
  auto* dsc = static_cast<float*>(dscale);
  auto* dsh = static_cast<float*>(dshift);
  auto* sf = static_cast<float*>(scratch);
#define BN_BACKWARD(V, A) \
  (int)backward<V, A>(dzf, yf, sc, sh, mu, rs, dyf, dsc, dsh, sf, M, C, chunks, s)
  if (vec) {
    if (act == kRelu) return BN_BACKWARD(4, kRelu);
    if (act == kRelu6) return BN_BACKWARD(4, kRelu6);
    return BN_BACKWARD(4, kNone);
  }
  if (act == kRelu) return BN_BACKWARD(1, kRelu);
  if (act == kRelu6) return BN_BACKWARD(1, kRelu6);
  return BN_BACKWARD(1, kNone);
#undef BN_BACKWARD
}

}  // extern "C"
