// K1: fused GroupNorm with an optional relu epilogue, forward and backward,
// on channels-last activations x[B, S, C] (S = H*W), G groups of cg = C/G
// channels, f32 statistics, output in the input dtype (f32 or bf16).
//
// Replaces the TPU kernel dynamic_load_balance_distributeddnn_tpu/ops/pallas/
// groupnorm.py: _gn_fwd_kernel (forward) and _fused_gn_bwd (its backward,
// plain jnp in the JAX package, a kernel here).
//
// The variance is max(E[x^2] - mean^2, 0), the TPU kernel's formula (not
// torch's two-pass one), so the two agree to rounding. The backward
// recomputes the relu mask from the saved [B, G] mean and rstd. Parameter
// gradients are per-batch-element partial sums, [B, C] f32, summed over B
// in a fixed order by a second small kernel: no float atomics, so the
// backward's bits repeat from run to run.
//
// Bound: memory bandwidth. The forward must read x once and write y once,
// the backward read x and dy and write dx: bytes over 3.35 TB/s on an H100,
// against a handful of flops per element. The TPU kernel keeps one batch
// element's whole [S, C] slab in VMEM (up to 1024 x 224 f32 = 0.9 MB), past
// the 227 KB of shared memory a block may hold. Two routes, chosen by the
// caller (ops/kernels/groupnorm.py plan) by shape:
//
// - The tiled route (see "Tiled route" below): a block, or a cluster of up
//   to 8 blocks that split S, owns a (batch element, channel tile) slab,
//   where a tile is a whole number of groups whose rows are 16-byte vectors.
//   The slab is staged in shared memory with cp.async, reduced, and
//   normalised from there: x (and dy) is read from device memory once.
// - The general route, for what the tiled one cannot take (C not a multiple
//   of the 16-byte vector, a slab too large for a cluster's shared memory):
//   one block per (batch element, group) strip of S x cg values, scalar
//   loads, two passes over the strip, the second served mostly from L2.
//   These are the first port's kernels, kept as they were but for the
//   rounding of the affine step (affine below) and the sum of the parameter
//   gradients over B, which both routes take from gn_param_sum_kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace coop = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // the general route's block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// xhat * w + b rounded after the product and after the sum, as the plain
// version's two torch ops round it (no fused multiply-add): the relu mask
// that the backward recomputes from the saved statistics then matches the
// plain backward's bit for bit, and the forward's relu agrees with both.
__device__ __forceinline__ float affine(float xh, float w, float b) {
  return __fadd_rn(__fmul_rn(xh, w), b);
}

// dscale[c] = sum_b dscale_part[b, c] (same for dbias), both routes' second
// kernel: a block takes 32 channels; its kSumWarps warps sum the rows
// b = warp, warp + kSumWarps, ... in order, and the warp sums are added in
// order of warp.
constexpr int kSumWarps = 8;
__global__ void __launch_bounds__(32 * kSumWarps)
gn_param_sum_kernel(const float* __restrict__ dscale_part, const float* __restrict__ dbias_part,
                    float* __restrict__ dscale, float* __restrict__ dbias, int B, int C) {
  __shared__ float red[2][kSumWarps][33];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.f, d = 0.f;
  if (c < C) {
    for (int b = wp; b < B; b += kSumWarps) {
      a += dscale_part[(int64_t)b * C + c];
      d += dbias_part[(int64_t)b * C + c];
    }
  }
  red[0][wp][lane] = a;
  red[1][wp][lane] = d;
  __syncthreads();
  if (wp < 2 && c < C) {  // warp 0 sums dscale, warp 1 dbias
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kSumWarps; ++i) s += red[wp][i][lane];
    (wp == 0 ? dscale : dbias)[c] = s;
  }
}

// ------------------------------------------------------------------ general route

// Block-wide sum of two values, returned to every thread. blockDim.x is a
// multiple of 32 and at most 1024; scratch holds 33 entries.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float2 v = lane < nw ? scratch[lane] : make_float2(0.f, 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  const float2 r = scratch[32];
  __syncthreads();  // scratch may be reused by the caller
  return r;
}

// One block per (b, g): grid = B * G.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_fwd_general_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      int S, int C, int G, float eps, int relu) {
  __shared__ float2 scratch[33];
  const int bg = blockIdx.x;
  const int b = bg / G, g = bg - (bg / G) * G;
  const int cg = C / G;
  const int n = S * cg;
  const int64_t base = (int64_t)b * S * C + (int64_t)g * cg;
  const T* xb = x + base;
  T* yb = y + base;

  float s1 = 0.f, s2 = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int s = e / cg, c = e - s * cg;
    const float v = to_f32(xb[s * C + c]);
    s1 += v;
    s2 += v * v;
  }
  const float2 tot = block_sum2(s1, s2, scratch);
  const float mean = tot.x / (float)n;
  const float var = fmaxf(tot.y / (float)n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (threadIdx.x == 0) {
    mean_out[bg] = mean;
    rstd_out[bg] = rstd;
  }
  const float* sc = scale + g * cg;
  const float* bi = bias + g * cg;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int s = e / cg, c = e - s * cg;
    float v = affine((to_f32(xb[s * C + c]) - mean) * rstd, sc[c], bi[c]);
    if (relu) v = fmaxf(v, 0.f);
    yb[s * C + c] = from_f32<T>(v);
  }
}

// One block per (b, g). Threads form R row phases x cg channel lanes
// (R = max(1, blockDim / cg)), so each virtual lane v = r0 * cg + cl keeps
// one channel and accumulates its dscale/dbias partial in registers; the
// partials of the R phases are then summed in a fixed order from shared
// memory (2 * R * cg floats, dynamic).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_general_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      T* __restrict__ dx, float* __restrict__ dscale_part,
                      float* __restrict__ dbias_part, int S, int C, int G, int relu) {
  extern __shared__ float part[];
  __shared__ float2 scratch[33];
  const int bg = blockIdx.x;
  const int b = bg / G, g = bg - (bg / G) * G;
  const int cg = C / G;
  const int n = S * cg;
  const int64_t base = (int64_t)b * S * C + (int64_t)g * cg;
  const T* xb = x + base;
  const T* dyb = dy + base;
  T* dxb = dx + base;
  const float mu = mean[bg], rs = rstd[bg];
  const float* sc = scale + g * cg;
  const float* bi = bias + g * cg;

  const int R = max(1, (int)blockDim.x / cg);
  const int V = R * cg;
  float sdx = 0.f, sdxx = 0.f;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const int cl = v % cg, r0 = v / cg;
    const float w = sc[cl], bb = bi[cl];
    float ds = 0.f, db = 0.f;
    for (int s = r0; s < S; s += R) {
      const int off = s * C + cl;
      const float xh = (to_f32(xb[off]) - mu) * rs;
      float d = to_f32(dyb[off]);
      // relu VJP: the pre-relu sign recomputed from the saved statistics
      if (relu && !(affine(xh, w, bb) > 0.f)) d = 0.f;
      const float dxh = d * w;
      sdx += dxh;
      sdxx += dxh * xh;
      ds += d * xh;
      db += d;
    }
    part[v] = ds;
    part[V + v] = db;
  }
  const float2 tot = block_sum2(sdx, sdxx, scratch);  // also orders `part`
  for (int cl = threadIdx.x; cl < cg; cl += blockDim.x) {
    float ds = 0.f, db = 0.f;
    for (int r = 0; r < R; ++r) {
      ds += part[r * cg + cl];
      db += part[V + r * cg + cl];
    }
    dscale_part[(int64_t)b * C + g * cg + cl] = ds;
    dbias_part[(int64_t)b * C + g * cg + cl] = db;
  }
  const float k = rs / (float)n;
  const float fn = (float)n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int s = e / cg, cl = e - s * cg;
    const int off = s * C + cl;
    const float w = sc[cl];
    const float xh = (to_f32(xb[off]) - mu) * rs;
    float d = to_f32(dyb[off]);
    if (relu && !(affine(xh, w, bi[cl]) > 0.f)) d = 0.f;
    const float dxh = d * w;
    dxb[off] = from_f32<T>(k * (fn * dxh - tot.x - xh * tot.y));
  }
}

// ------------------------------------------------------------------ tiled route
//
// What held the general route back at DenseNet-121's shapes (cg = 2 ... 32
// channels, rows of 8-128 bytes at a stride of C * 4): scalar loads behind
// an integer division per element, 32-byte sectors fetched by up to four
// blocks, and a second read of x that block-1 calls (2-5x the 50 MB L2)
// take from device memory. Here:
//
// - A block owns a slab of one batch element: `rows` rows of S times a
//   channel tile of W channels, a whole number of groups, W a multiple of
//   the 16-byte vector (4 f32 or 8 bf16) and at least 128 bytes where C
//   allows. Thread t owns vector slot v = t % vpad of the tile's rows (vpad:
//   the vectors a row, rounded up to a power of two; slots past the row
//   idle) and row phase r = t / vpad: it copies rows r, r + R, ... of its
//   column with 16-byte cp.async, all in flight before one wait. A warp
//   reads whole 128-byte lines of consecutive rows.
// - The slab stays in shared memory: the thread that copied a vector is the
//   one that reads it, in the reduction and again in the elementwise pass,
//   so there is no barrier between copy and use and no second read from L2
//   or device memory.
// - Sums are per channel: a thread adds its V channels over its rows, the
//   lanes of one slot combine by xor shuffles, the warps' partial rows by a
//   fixed-order loop in shared memory. A group's sums are its channels' sums
//   in channel order; a group may straddle two vectors (cg = 3, 5, 7 ...).
//   The backward's per-channel sums of d and d * xhat are also the dbias
//   and dscale partials, and w-weighted give the group sums of dxhat and
//   dxhat * xhat. The channel-to-group map is a division per thread and
//   channel, once, not per element.
// - Where one slab would not fit a block's shared memory, a thread-block
//   cluster of up to 8 blocks splits S. Each block keeps its rows on chip;
//   the blocks exchange their per-channel totals through distributed shared
//   memory and every rank adds them in rank order, so all ranks hold the
//   same bits. A final cluster barrier keeps a block's totals alive until
//   every rank has read them.
//
// Shared memory (dynamic), bytes: the slab (rows * W * sizeof(T), twice in
// the backward: x then dy), then floats: 2 * P * W warp partials (P =
// blockDim / max(vpad, 32)), 2 * W block totals, 2 * W cluster totals,
// 2 * k group values (k = W / cg). ops/kernels/groupnorm.py plan computes
// the same size.

constexpr int kMaxThreads = 512;

struct TilePlan {
  int S, C, G;
  int W;        // channels a block owns
  int cg;       // channels a group
  int vshift;   // log2 of the vector slots a tile row
  int rows;     // rows of S a block stages: ceil(S / cluster)
  int cluster;  // blocks that split S (1: no cluster)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// 16 bytes <-> V floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Per-channel totals of two per-thread partials a, q (V channels from slot
// v): over the block's row phases, then over the cluster's ranks, in a fixed
// order. Returns [2][W] in shared memory (a's totals, then q's), the same
// bits in every rank of a cluster. `part` is the float region after the
// slab; ends with a block barrier.
template <int V, bool kCluster>
__device__ __forceinline__ const float* channel_totals(float (&a)[V], float (&q)[V], float* part,
                                                       int W, int vshift, bool live,
                                                       int cluster) {
  const int tid = threadIdx.x, nt = blockDim.x, vpad = 1 << vshift;
  // the row phases a warp holds: lanes v, v + vpad, ... (xor butterfly:
  // every lane ends with the same bits)
  for (int o = vpad; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] += __shfl_xor_sync(0xffffffffu, a[j], o);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
    }
  }
  // one partial row a warp (a row phase, where a tile row spans warps)
  const int span_shift = vshift > 5 ? vshift : 5;
  const int P = nt >> span_shift, pr = tid >> span_shift;
  const int v = tid & (vpad - 1);
  if (live && (tid & 31) < vpad) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part[pr * W + v * V + j] = a[j];
      part[(P + pr) * W + v * V + j] = q[j];
    }
  }
  __syncthreads();
  float* ctot = part + 2 * P * W;
  for (int c = tid; c < 2 * W; c += nt) {
    const float* src = part + (c < W ? c : P * W + c - W);
    float s = 0.f;
    for (int i = 0; i < P; ++i) s += src[i * W];
    ctot[c] = s;
  }
  if constexpr (!kCluster) {
    __syncthreads();
    return ctot;
  } else {
    coop::cluster_group cl = coop::this_cluster();
    cl.sync();  // every rank's totals are written
    float* tot = ctot + 2 * W;
    for (int c = tid; c < 2 * W; c += nt) {
      float s = 0.f;
      for (int rk = 0; rk < cluster; ++rk) s += cl.map_shared_rank(ctot, rk)[c];
      tot[c] = s;
    }
    __syncthreads();
    return tot;
  }
}

// Grid (C / W * cluster, B); blockIdx.x = tile * cluster + rank.
template <typename T, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_tiled_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out, TilePlan p,
                    float eps, int relu) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, vpad = 1 << p.vshift, nvec = p.W / V;
  const int v = tid & (vpad - 1), r = tid >> p.vshift, R = blockDim.x >> p.vshift;
  const bool live = v < nvec;
  const int rank = kCluster ? (int)coop::this_cluster().block_rank() : 0;
  const int tile = blockIdx.x / p.cluster, b = blockIdx.y;
  const int c0 = tile * p.W, k = p.W / p.cg;
  const int s0 = rank * p.rows, n_rows = max(0, min(p.rows, p.S - s0));
  uint4* slab = reinterpret_cast<uint4*>(smem);
  float* part = reinterpret_cast<float*>(smem + (size_t)p.rows * nvec * 16);
  const int64_t off = ((int64_t)b * p.S + s0) * p.C + c0 + v * V;

  if (live)
    for (int i = r; i < n_rows; i += R) cp_async16(&slab[i * nvec + v], x + off + (int64_t)i * p.C);
  // this thread's parameters and groups, while the copies are in flight
  float w[V], bb[V];
  int gi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = live ? v * V + j : 0;
    gi[j] = c / p.cg;
    w[j] = scale[c0 + c];
    bb[j] = bias[c0 + c];
  }
  cp_async_wait_all();
  float a[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = q[j] = 0.f;
  if (live) {
    for (int i = r; i < n_rows; i += R) {
      float f[V];
      unpack(slab[i * nvec + v], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[j] += f[j];
        q[j] = fmaf(f[j], f[j], q[j]);
      }
    }
  }
  const float* tot = channel_totals<V, kCluster>(a, q, part, p.W, p.vshift, live, p.cluster);

  const int P = blockDim.x >> (p.vshift > 5 ? p.vshift : 5);
  float* gstat = part + 2 * P * p.W + 4 * p.W;  // [2][k]: mean, rstd
  const float n = (float)p.S * (float)p.cg;
  for (int g = tid; g < k; g += blockDim.x) {
    float s = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int c = g * p.cg; c < (g + 1) * p.cg; ++c) {
      s += tot[c];
      s2 += tot[p.W + c];
    }
    const float mean = s / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    gstat[g] = mean;
    gstat[k + g] = rstd;
    if (rank == 0) {
      mean_out[b * p.G + tile * k + g] = mean;
      rstd_out[b * p.G + tile * k + g] = rstd;
    }
  }
  __syncthreads();
  if (live) {
    float mu[V], rs[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = gstat[gi[j]];
      rs[j] = gstat[k + gi[j]];
    }
    for (int i = r; i < n_rows; i += R) {
      float f[V];
      unpack(slab[i * nvec + v], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float o = affine((f[j] - mu[j]) * rs[j], w[j], bb[j]);
        f[j] = relu ? fmaxf(o, 0.f) : o;
      }
      *reinterpret_cast<uint4*>(y + off + (int64_t)i * p.C) = pack(f);
    }
  }
  if constexpr (kCluster) coop::this_cluster().sync();  // the other ranks have read our totals
}

template <typename T, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_tiled_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    T* __restrict__ dx, float* __restrict__ dscale_part,
                    float* __restrict__ dbias_part, TilePlan p, int relu) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, vpad = 1 << p.vshift, nvec = p.W / V;
  const int v = tid & (vpad - 1), r = tid >> p.vshift, R = blockDim.x >> p.vshift;
  const bool live = v < nvec;
  const int rank = kCluster ? (int)coop::this_cluster().block_rank() : 0;
  const int tile = blockIdx.x / p.cluster, b = blockIdx.y;
  const int c0 = tile * p.W, k = p.W / p.cg;
  const int s0 = rank * p.rows, n_rows = max(0, min(p.rows, p.S - s0));
  uint4* sx = reinterpret_cast<uint4*>(smem);
  uint4* sdy = sx + (size_t)p.rows * nvec;
  float* part = reinterpret_cast<float*>(smem + 2 * (size_t)p.rows * nvec * 16);
  const int64_t off = ((int64_t)b * p.S + s0) * p.C + c0 + v * V;

  if (live) {
    for (int i = r; i < n_rows; i += R) {
      cp_async16(&sx[i * nvec + v], x + off + (int64_t)i * p.C);
      cp_async16(&sdy[i * nvec + v], dy + off + (int64_t)i * p.C);
    }
  }
  // the statistics and parameters of this thread's channels, while the
  // copies are in flight
  float mu[V], rs[V], w[V], bb[V];
  int gi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = live ? v * V + j : 0;
    gi[j] = c / p.cg;
    mu[j] = mean[b * p.G + tile * k + gi[j]];
    rs[j] = rstd[b * p.G + tile * k + gi[j]];
    w[j] = scale[c0 + c];
    bb[j] = bias[c0 + c];
  }
  cp_async_wait_all();
  float db[V], ds[V];
#pragma unroll
  for (int j = 0; j < V; ++j) db[j] = ds[j] = 0.f;
  if (live) {
    for (int i = r; i < n_rows; i += R) {
      float fx[V], fd[V];
      unpack(sx[i * nvec + v], fx);
      unpack(sdy[i * nvec + v], fd);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (fx[j] - mu[j]) * rs[j];
        // relu VJP: the pre-relu sign recomputed from the saved statistics
        const float d = (relu && !(affine(xh, w[j], bb[j]) > 0.f)) ? 0.f : fd[j];
        db[j] += d;
        ds[j] = fmaf(d, xh, ds[j]);
      }
    }
  }
  // tot[c] = sum of d (dbias), tot[W + c] = sum of d * xhat (dscale)
  const float* tot = channel_totals<V, kCluster>(db, ds, part, p.W, p.vshift, live, p.cluster);

  const int P = blockDim.x >> (p.vshift > 5 ? p.vshift : 5);
  float* gsum = part + 2 * P * p.W + 4 * p.W;  // [2][k]: sum of dxhat, of dxhat * xhat
  if (rank == 0) {
    for (int c = tid; c < p.W; c += blockDim.x) {
      dbias_part[(int64_t)b * p.C + c0 + c] = tot[c];
      dscale_part[(int64_t)b * p.C + c0 + c] = tot[p.W + c];
    }
  }
  for (int g = tid; g < k; g += blockDim.x) {
    float s = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int c = g * p.cg; c < (g + 1) * p.cg; ++c) {
      const float wc = scale[c0 + c];
      s = fmaf(wc, tot[c], s);
      s2 = fmaf(wc, tot[p.W + c], s2);
    }
    gsum[g] = s;
    gsum[k + g] = s2;
  }
  __syncthreads();
  if (live) {
    const float n = (float)p.S * (float)p.cg;
    float gs[V], gs2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      gs[j] = gsum[gi[j]];
      gs2[j] = gsum[k + gi[j]];
    }
    for (int i = r; i < n_rows; i += R) {
      float fx[V], fd[V];
      unpack(sx[i * nvec + v], fx);
      unpack(sdy[i * nvec + v], fd);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (fx[j] - mu[j]) * rs[j];
        const float d = (relu && !(affine(xh, w[j], bb[j]) > 0.f)) ? 0.f : fd[j];
        fx[j] = rs[j] / n * (n * (d * w[j]) - gs[j] - xh * gs2[j]);
      }
      *reinterpret_cast<uint4*>(dx + off + (int64_t)i * p.C) = pack(fx);
    }
  }
  if constexpr (kCluster) coop::this_cluster().sync();  // the other ranks have read our totals
}

// Dynamic shared memory above 48 KB must be allowed per kernel and device
// first. Each (kernel, device) remembers the largest size allowed so far, so
// cudaFuncSetAttribute runs once per kernel and size, not on every launch.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{kernel, dev}];
  if (smem <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) have = smem;
  return e;
}

// Launch a tiled kernel on grid (tiles * cluster, B), as clusters of
// `cluster` blocks along x when cluster > 1.
template <typename... Params, typename... Args>
cudaError_t launch_tiled(void (*kernel)(Params...), const TilePlan& p, int B, int threads,
                         int smem, cudaStream_t st, Args... args) {
  cudaError_t e = allow_smem((const void*)kernel, (size_t)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.C / p.W) * p.cluster, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

TilePlan tile_plan(int S, int C, int G, int W, int vshift, int rows, int cluster) {
  return TilePlan{S, C, G, W, C / G, vshift, rows, cluster};
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 = float32, 1 = bfloat16. Each entry returns cudaGetLastError()
// after its launches (or the first error), and does not synchronise. Shapes
// and plans are validated by the Python wrapper (ops/kernels/groupnorm.py).

// The general route.
int gn_forward(const void* x, const float* scale, const float* bias, void* y,
               float* mean, float* rstd, int B, int S, int C, int G, float eps,
               int relu, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * G), block(kThreads);
  if (dtype == 0) {
    gn_fwd_general_kernel<float><<<grid, block, 0, st>>>(
        (const float*)x, scale, bias, (float*)y, mean, rstd, S, C, G, eps, relu);
  } else {
    gn_fwd_general_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)x, scale, bias, (__nv_bfloat16*)y, mean, rstd, S,
        C, G, eps, relu);
  }
  return (int)cudaGetLastError();
}

int gn_backward(const void* x, const void* dy, const float* scale,
                const float* bias, const float* mean, const float* rstd,
                void* dx, float* dscale_part, float* dbias_part, float* dscale,
                float* dbias, int B, int S, int C, int G, int relu, int dtype,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int cg = C / G;
  const int R = kThreads / cg > 1 ? kThreads / cg : 1;
  const size_t smem = 2 * sizeof(float) * (size_t)R * cg;
  const dim3 grid(B * G), block(kThreads);
  if (dtype == 0) {
    gn_bwd_general_kernel<float><<<grid, block, smem, st>>>(
        (const float*)x, (const float*)dy, scale, bias, mean, rstd, (float*)dx,
        dscale_part, dbias_part, S, C, G, relu);
  } else {
    gn_bwd_general_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, scale, bias, mean,
        rstd, (__nv_bfloat16*)dx, dscale_part, dbias_part, S, C, G, relu);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_param_sum_kernel<<<(C + 31) / 32, 32 * kSumWarps, 0, st>>>(dscale_part, dbias_part,
                                                                dscale, dbias, B, C);
  return (int)cudaGetLastError();
}

// The tiled route: W channels a tile (C % W == 0, W % (16 / sizeof(T)) == 0,
// a whole number of groups), 1 << vshift vector slots a tile row, `rows`
// rows a block, `cluster` blocks splitting S (rows * cluster >= S), threads
// a power of two from max(32, 1 << vshift) to 512, smem bytes as plan gives.
int gn_forward_tiled(const void* x, const float* scale, const float* bias, void* y,
                     float* mean, float* rstd, int B, int S, int C, int G, int W,
                     int vshift, int rows, int cluster, int threads, int smem, float eps,
                     int relu, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const TilePlan p = tile_plan(S, C, G, W, vshift, rows, cluster);
  cudaError_t e;
  if (dtype == 0) {
    const float* xx = (const float*)x;
    float* yy = (float*)y;
    e = cluster > 1
            ? launch_tiled(gn_fwd_tiled_kernel<float, true>, p, B, threads, smem, st, xx, scale,
                           bias, yy, mean, rstd, p, eps, relu)
            : launch_tiled(gn_fwd_tiled_kernel<float, false>, p, B, threads, smem, st, xx, scale,
                           bias, yy, mean, rstd, p, eps, relu);
  } else {
    const __nv_bfloat16* xx = (const __nv_bfloat16*)x;
    __nv_bfloat16* yy = (__nv_bfloat16*)y;
    e = cluster > 1
            ? launch_tiled(gn_fwd_tiled_kernel<__nv_bfloat16, true>, p, B, threads, smem, st, xx,
                           scale, bias, yy, mean, rstd, p, eps, relu)
            : launch_tiled(gn_fwd_tiled_kernel<__nv_bfloat16, false>, p, B, threads, smem, st,
                           xx, scale, bias, yy, mean, rstd, p, eps, relu);
  }
  return (int)e;
}

int gn_backward_tiled(const void* x, const void* dy, const float* scale, const float* bias,
                      const float* mean, const float* rstd, void* dx, float* dscale_part,
                      float* dbias_part, float* dscale, float* dbias, int B, int S, int C,
                      int G, int W, int vshift, int rows, int cluster, int threads, int smem,
                      int relu, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const TilePlan p = tile_plan(S, C, G, W, vshift, rows, cluster);
  cudaError_t e;
  if (dtype == 0) {
    const float *xx = (const float*)x, *dd = (const float*)dy;
    float* out = (float*)dx;
    e = cluster > 1
            ? launch_tiled(gn_bwd_tiled_kernel<float, true>, p, B, threads, smem, st, xx, dd,
                           scale, bias, mean, rstd, out, dscale_part, dbias_part, p, relu)
            : launch_tiled(gn_bwd_tiled_kernel<float, false>, p, B, threads, smem, st, xx, dd,
                           scale, bias, mean, rstd, out, dscale_part, dbias_part, p, relu);
  } else {
    const __nv_bfloat16 *xx = (const __nv_bfloat16*)x, *dd = (const __nv_bfloat16*)dy;
    __nv_bfloat16* out = (__nv_bfloat16*)dx;
    e = cluster > 1
            ? launch_tiled(gn_bwd_tiled_kernel<__nv_bfloat16, true>, p, B, threads, smem, st, xx,
                           dd, scale, bias, mean, rstd, out, dscale_part, dbias_part, p, relu)
            : launch_tiled(gn_bwd_tiled_kernel<__nv_bfloat16, false>, p, B, threads, smem, st,
                           xx, dd, scale, bias, mean, rstd, out, dscale_part, dbias_part, p,
                           relu);
  }
  if (e != cudaSuccess) return (int)e;
  gn_param_sum_kernel<<<(C + 31) / 32, 32 * kSumWarps, 0, st>>>(dscale_part, dbias_part,
                                                                dscale, dbias, B, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
