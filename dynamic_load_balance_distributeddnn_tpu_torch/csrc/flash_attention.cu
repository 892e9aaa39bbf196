// K3: flash attention, f32, D <= 128, in two routes chosen by the caller
// (ops/kernels/flash_attention.py) by the sequence length T:
//
// - T <= 64, the short route (the language model's T = 35): one tile covers
//   the whole sequence. attn_fwd_short_kernel and attn_bwd_short_kernel take
//   [B, H, T, D] strided views (last dimension contiguous, strides of b, h
//   and t given), so the projections' [B, T, H, D] memory is read in place
//   and o, dq, dk, dv are written in whatever layout the caller allocated.
//   See "Short route" below.
// - T > 64, the tiled route: the streaming-softmax kernels below, on
//   row-contiguous [BH, T, D] (BH = batch * heads), with the per-row
//   log-sum-exp lse[BH, T] f32 saved by the forward and delta[BH, T] =
//   rowsum(dO * O) computed by the caller.
//
// Replaces the TPU kernels of dynamic_load_balance_distributeddnn_tpu/ops/
// pallas/flash_attention.py:
//   _attn_fwd_kernel (:58)      -> attn_fwd_short_kernel, attn_fwd_kernel
//   _attn_bwd_dkv_kernel (:106) -> attn_bwd_short_kernel, attn_bwd_dkv_kernel
//   _attn_bwd_dq_kernel (:153)  -> attn_bwd_short_kernel, attn_bwd_dq_kernel
// with the same math: scores s = scale * q.k (scale = 1/sqrt(D)), keys at or
// past T and, if causal, keys after the query masked to -1e30; the forward
// takes each row's max m, sum l of exp(s - m) and accumulator acc = sum of
// exp(s - m) v (the tiled kernel as running values over key tiles, the
// short one over the whole row at once) and writes o = acc / max(l, 1e-30)
// and lse = m + log(max(l, 1e-30)); the backward recomputes p = exp(s -
// lse) and forms dV = P^T dO, dS = P * (dP - delta) with dP = dO V^T,
// dK = scale * dS^T Q and dQ = scale * dS K.
//
// What differs from the TPU kernels, and why (both routes):
// - The TPU pads T to a multiple of the tile and D to 128 in device memory
//   before the call. Here nothing is padded in memory: each tile is loaded
//   into shared memory with zeros past row T and column D, and the masks
//   above keep padded keys and queries out of every sum. A masked entry
//   gives p = 0 explicitly, so a row with no visible key yields o = 0 and
//   finite lse, never NaN.
// - Each output element is owned by one block, so there are no float
//   atomics and the gradients are the same on every run.
//
// Tiled route (T > 64). The TPU's sequential grid axis over key tiles
// (forward, dQ) or query tiles (dK/dV) carries its running sums in VMEM
// scratch between grid steps. Blocks on a GPU run in no order and carry
// nothing, so that axis is a loop inside the block: one block per (bh,
// 64-row tile), the accumulators in registers. Causally dead tiles are not
// visited: the forward and dQ loops stop at the diagonal tile, the dK/dV
// loop starts at it. At long T the work is O(T^2 D) against O(T D) bytes, so
// it is bound by operations. These kernels compute in f32 on the CUDA cores
// (67 TFLOP/s peak), not on the tensor cores: 256 threads per block, each
// owning a 4 x 4 patch of the 64 x 64 score tile and a 4 x 8 patch of the
// 64 x D output tile in registers, with q, k, v and dO tiles staged in shared
// memory (rows padded to an odd stride so the 16 threads reading 16
// different rows hit 16 different banks). A later redesign would move the
// products to wgmma.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kTile = 64;      // rows of a query or key tile
constexpr int kThreads = 256;  // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr int kMaxD = 128;
constexpr int kPStride = kTile + 1;  // [64][65] score-tile scratch
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask value

// Odd row stride for a [64][D] tile in shared memory: thread tx reads row
// tx (+16 j) at column d, and an odd stride puts the 16 rows on 16 banks.
__host__ __device__ __forceinline__ int row_stride(int D) { return (D & 1) ? D : D + 1; }

// Rows r0 .. r0+63 of a row-contiguous [T, D] matrix into dst[64][ld], zero
// past row T. The tile is one contiguous run of memory, read coalesced.
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int r0, int T, int D, int ld) {
  const int n = kTile * D;
  const float* s = src + (size_t)r0 * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * ld + c] = (r0 + r < T) ? s[idx] : 0.f;
  }
}

// Rows r0 .. r0+63 of a [T] vector into dst[64], zero past T.
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int r0, int T) {
  if (threadIdx.x < kTile) dst[threadIdx.x] = (r0 + threadIdx.x < T) ? src[r0 + threadIdx.x] : 0.f;
}

// Max / sum over the 16 threads of one half-warp (the threads sharing ty).
__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kCausal>
__device__ __forceinline__ bool visible(int qi, int kj, int T) {
  return qi < T && kj < T && (!kCausal || kj <= qi);
}

// acc[i][j] += sum_d A[ra_i][d] * B[rb_j][d]: rows ra_i = ty*4 + i of A and
// rb_j = tx + 16 j of B, both [64][ld] tiles in shared memory.
__device__ __forceinline__ void dot_patch(const float* __restrict__ A, const float* __restrict__ B,
                                          int D, int ld, int ty, int tx, float acc[4][4]) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[i][c] += sum_r P[ty*4 + i][r] * M[r][tx + 16 c] over r < n: a [64][65]
// score tile times a [64][ld] tile, columns past D skipped.
__device__ __forceinline__ void pm_patch(const float* __restrict__ P, const float* __restrict__ M,
                                         int n, int D, int ld, int ty, int tx, float out[4][8]) {
#pragma unroll 2
  for (int r = 0; r < n; ++r) {
    float p[4], m[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty * 4 + i) * kPStride + r];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      m[c] = col < D ? M[r * ld + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) out[i][c] = fmaf(p[i], m[c], out[i][c]);
  }
}

// One block per (query tile, bh). Shared: Q, K, V tiles [64][ld], P [64][65].
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int T, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = row_stride(D);
  float* Qs = smem;
  float* Ks = Qs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ps = Vs + kTile * ld;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * T * D;

  load_tile(Qs, q + base, q0, T, D, ld);
  float acc[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  // causal: key tiles past the last query row of this tile are all masked
  const int k_end = kCausal ? min(q0 + kTile, T) : T;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous iteration is done with Ks, Vs, Ps
    load_tile(Ks, k + base, k0, T, D, ld);
    load_tile(Vs, v + base, k0, T, D, ld);
    __syncthreads();
    float s[4][4] = {};
    dot_patch(Qs, Ks, D, ld, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible<kCausal>(qi, k0 + tx + 16 * j, T) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible<kCausal>(qi, k0 + tx + 16 * j, T) ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + group16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    pm_patch(Ps, Vs, min(kTile, T - k0), D, ld, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= T) continue;
    const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) o[base + (size_t)qi * D + col] = acc[i][c] / ls;
    }
    if (tx == 0) lse[(size_t)bh * T + qi] = m[i] + logf(ls);
  }
}

// One block per (key tile, bh); loops over query tiles from the diagonal on.
// Shared: K, V, Q, dO tiles [64][ld], P^T and dS^T [64][65], lse and delta
// of the query tile [64] each.
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int T, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = row_stride(D);
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* dOs = Qs + kTile * ld;
  float* Pt = dOs + kTile * ld;
  float* dSt = Pt + kTile * kPStride;
  float* Ls = dSt + kTile * kPStride;
  float* Dl = Ls + kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * T * D;
  const float* lse_b = lse + (size_t)bh * T;
  const float* delta_b = delta + (size_t)bh * T;

  load_tile(Ks, k + base, k0, T, D, ld);
  load_tile(Vs, v + base, k0, T, D, ld);
  float dk_acc[4][8] = {}, dv_acc[4][8] = {};
  // causal: query tiles before the diagonal see none of these keys
  for (int q0 = kCausal ? k0 : 0; q0 < T; q0 += kTile) {
    __syncthreads();
    load_tile(Qs, q + base, q0, T, D, ld);
    load_tile(dOs, dout + base, q0, T, D, ld);
    load_rows(Ls, lse_b, q0, T);
    load_rows(Dl, delta_b, q0, T);
    __syncthreads();
    // transposed tiles: row = key ty*4 + i, column = query tx + 16 j
    float s[4][4] = {}, dp[4][4] = {};
    dot_patch(Ks, Qs, D, ld, ty, tx, s);
    dot_patch(Vs, dOs, D, ld, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const float p = visible<kCausal>(q0 + qc, kj, T) ? expf(s[i][j] * scale - Ls[qc]) : 0.f;
        Pt[(ty * 4 + i) * kPStride + qc] = p;
        dSt[(ty * 4 + i) * kPStride + qc] = p * (dp[i][j] - Dl[qc]);
      }
    }
    __syncthreads();
    const int n = min(kTile, T - q0);
    pm_patch(Pt, dOs, n, D, ld, ty, tx, dv_acc);
    pm_patch(dSt, Qs, n, D, ld, ty, tx, dk_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= T) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk[base + (size_t)kj * D + col] = scale * dk_acc[i][c];
        dv[base + (size_t)kj * D + col] = dv_acc[i][c];
      }
    }
  }
}

// One block per (query tile, bh); loops over key tiles up to the diagonal.
// Shared: Q, dO, K, V tiles [64][ld], dS [64][65], lse and delta [64].
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int T, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = row_stride(D);
  float* Qs = smem;
  float* dOs = Qs + kTile * ld;
  float* Ks = dOs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* dS = Vs + kTile * ld;
  float* Ls = dS + kTile * kPStride;
  float* Dl = Ls + kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * T * D;

  load_tile(Qs, q + base, q0, T, D, ld);
  load_tile(dOs, dout + base, q0, T, D, ld);
  load_rows(Ls, lse + (size_t)bh * T, q0, T);
  load_rows(Dl, delta + (size_t)bh * T, q0, T);
  float dq_acc[4][8] = {};
  const int k_end = kCausal ? min(q0 + kTile, T) : T;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, k + base, k0, T, D, ld);
    load_tile(Vs, v + base, k0, T, D, ld);
    __syncthreads();
    // row = query ty*4 + i, column = key tx + 16 j
    float s[4][4] = {}, dp[4][4] = {};
    dot_patch(Qs, Ks, D, ld, ty, tx, s);
    dot_patch(dOs, Vs, D, ld, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const float p = visible<kCausal>(q0 + qr, k0 + kc, T) ? expf(s[i][j] * scale - Ls[qr]) : 0.f;
        dS[qr * kPStride + kc] = p * (dp[i][j] - Dl[qr]);
      }
    }
    __syncthreads();
    pm_patch(dS, Ks, min(kTile, T - k0), D, ld, ty, tx, dq_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= T) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dq[base + (size_t)qi * D + col] = scale * dq_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// Short route (T <= 64). One tile covers the whole sequence, so the softmax is
// taken directly over each row (one max, one sum, no running rescale), and
// rows are padded to a multiple of 4 (the row tile), not to 64: at T = 35 the
// score work covers 36 x 35 entries in place of 64 x 64.
//
// Bound on this card. At the language model's shapes a call moves 0.1-3 MB
// and does a few MFLOP, so neither bytes nor operations bound it: latency
// does (bringing the operands on chip, then a few dependent phases), and at
// the validation chunk (B*H = 2,048) the bytes. The design:
// - All loads in flight at once. Every row of every operand a block needs
//   goes to shared memory by cp.async (16 bytes a lane where the head's rows
//   are 16-byte aligned and D is a multiple of 4, 4 bytes otherwise), all
//   issued before one wait. Warps walk rows and lanes columns, so no thread
//   divides an index.
// - No layout copies. Each operand is a [B, H, T, D] view given by its
//   pointer and the strides of b, h and t; its last dimension is contiguous.
// - Bank-conflict-free shared memory. Rows lie ld floats apart, ld a multiple
//   of 4 with ld / 4 odd, so the 8 lanes of a quarter-warp reading 8 rows at
//   one float4 column hit 32 different banks; the other operand of each
//   product is read by all lanes at one address (a broadcast).
// - Register tiles of 4 rows: a lane owns one key of 4 score rows, or one
//   float4 column of 4 output rows, whose weights it reads 4 keys at a time;
//   each shared-memory load feeds 4 to 16 FMAs. A block is latency-bound, so
//   work items are many and short: up to 12 warps (a warp for each 4 rows of
//   a 36-row head) rather than fewer items with more keys each (measured
//   slower).
// - Forward launch plan (plan() in ops/kernels/flash_attention.py, set by
//   measurement): a block takes `rows` query rows of one head, a few blocks
//   per head when there are few heads, and loads only the keys they can see.
// - One backward launch. A block owns a head, or with parts = 2 the dK/dV or
//   the dQ half of a head's outputs (both halves build the scores). It takes
//   delta = rowsum(dO * O) from the saved o itself, builds P and dS once in
//   shared memory, and writes dq, dk and dv, each element from one block.

constexpr int kShortT = 64;         // longest sequence of the short route
constexpr int kSSt = kShortT;       // row stride of the [rows][64] score tiles
constexpr int kShortThreads = 384;  // most threads a short-route block takes

struct View {  // one [B, H, T, D] operand: pointer, strides (elements) of b, h, t
  float* p;
  long long sb, sh, st;
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Row stride (floats) of an operand staged as [rows][D]: a multiple of 4
// (16-byte rows for cp.async and float4 reads) with ld / 4 odd.
__host__ __device__ __forceinline__ int short_ld(int D) {
  const int d = round4(D);
  return ((d >> 2) & 1) ? d : d + 4;
}

// Shared-memory floats of the short forward: Q [rq][ld], K and V [rk][ld],
// scores [rq][64], row max and row sum [rq] each.
__host__ __device__ __forceinline__ int fwd_short_floats(int rows, int T, int D) {
  const int rq = round4(rows < T ? rows : T), rk = round4(T);
  return (rq + 2 * rk) * short_ld(D) + rq * kSSt + 2 * rq;
}

// ... and of the short backward: Q, K, V, dO, O [t4][ld], P and dS [t4][64],
// lse and delta [t4].
__host__ __device__ __forceinline__ int bwd_short_floats(int T, int D) {
  const int t4 = round4(T);
  return 5 * t4 * short_ld(D) + 2 * t4 * kSSt + 2 * t4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float* head_of(const View& x, int b, int h) {
  return x.p + b * x.sb + h * x.sh;
}

// Whether every row of a head is 16-byte aligned and D a multiple of 4.
__device__ __forceinline__ bool rows_vec(const float* head, long long st, int D) {
  return ((reinterpret_cast<uintptr_t>(head) & 15) == 0) && ((st & 3) == 0) && ((D & 3) == 0);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& y) {
  y.x = fmaf(s, x.x, y.x);
  y.y = fmaf(s, x.y, y.y);
  y.z = fmaf(s, x.z, y.z);
  y.w = fmaf(s, x.w, y.w);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Issue the copies of rows r0 .. r0+n-1 of a head's [T, D] rows into
// dst[0 .. n-1][ld]; rows n .. npad-1 and, on the 4-byte path, columns D ..
// round4(D)-1 are zeroed. Nothing waits here.
__device__ __forceinline__ void stage(float* dst, const float* src, long long st, int r0, int n,
                                      int npad, int D, int ld) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5, d4 = (D + 3) >> 2;
  const bool vec = rows_vec(src, st, D);
  for (int r = threadIdx.x >> 5; r < npad; r += nw) {
    float* drow = dst + r * ld;
    const float* srow = src + (r0 + r) * st;
    if (r >= n) {
      for (int c = lane; c < 4 * d4; c += 32) drow[c] = 0.f;
    } else if (vec) {
      if (lane < d4) cp_async16(drow + 4 * lane, srow + 4 * lane);
    } else {
      for (int c = lane; c < D; c += 32) cp_async4(drow + c, srow + c);
      for (int c = D + lane; c < 4 * d4; c += 32) drow[c] = 0.f;
    }
  }
}

// Columns 4c .. 4c+3 (those below D) of row `row` of a head.
__device__ __forceinline__ void store4(float* head, long long st, int row, int c, int D, bool vec,
                                       float4 a) {
  float* dst = head + row * st + 4 * c;
  if (vec) {
    *reinterpret_cast<float4*>(dst) = a;
    return;
  }
  const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (4 * c + u < D) dst[u] = e[u];
}

__device__ __forceinline__ float4 mul4(float s, float4 a) {
  return make_float4(s * a.x, s * a.y, s * a.z, s * a.w);
}

// Scores of 4 query rows (A, rows ld apart) against key row `key` of K:
// s[r] = A[r] . K[key]; with A2 and K2 also dp[r] = A2[r] . K2[key] (the
// backward's dO V^T). A lane owns its key; all lanes read the A rows at one
// address.
__device__ __forceinline__ void score_rows(const float* A, const float* K, const float* A2,
                                           const float* K2, int ld, int d4, int key, float s[4],
                                           float dp[4]) {
  const float* kr = K + key * ld;
  const float* vr = K2 == nullptr ? nullptr : K2 + key * ld;
#pragma unroll 5
  for (int c = 0; c < 4 * d4; c += 4) {
    const float4 kv = ld4(kr + c);
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r] = dot4(ld4(A + r * ld + c), kv, s[r]);
    if (A2 != nullptr) {
      const float4 vv = ld4(vr + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) dp[r] = dot4(ld4(A2 + r * ld + c), vv, dp[r]);
    }
  }
}

// acc[r] = sum over j < jend (a multiple of 4) of W[r][j] * M[j], for 4 rows
// of a [rows][64] weight tile W and a float4 column of M (rows ld apart):
// each lane reads its column of M, the weights 4 keys at a time at one
// address for all lanes.
__device__ __forceinline__ void rows_times(const float* W, const float* M, int ld, int jend,
                                           float4 acc[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int j = 0; j < jend; j += 4) {
    float4 w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = ld4(W + r * kSSt + j);
    const float4 m0 = ld4(M + j * ld), m1 = ld4(M + (j + 1) * ld), m2 = ld4(M + (j + 2) * ld),
                 m3 = ld4(M + (j + 3) * ld);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      axpy4(w[r].x, m0, acc[r]);
      axpy4(w[r].y, m1, acc[r]);
      axpy4(w[r].z, m2, acc[r]);
      axpy4(w[r].w, m3, acc[r]);
    }
  }
}

// Grid (B*H, ceil(T / rows)): a block takes query rows q0 .. q0+rows-1 of
// one head and the keys they can see.
template <bool kCausal>
__global__ void __launch_bounds__(kShortThreads)
attn_fwd_short_kernel(View q, View k, View v, View o, float* __restrict__ lse, int H, int T,
                      int D, int rows, float scale) {
  extern __shared__ __align__(16) float short_smem[];
  const int ld = short_ld(D), d4 = (D + 3) >> 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * rows;
  const int nq = min(rows, T - q0), nq4 = round4(nq);  // this block's query rows
  const int nk = kCausal ? q0 + nq : T;                 // the keys they can see
  const int nk4 = round4(nk);
  const int rq = round4(min(rows, T)), rk = round4(T);
  float* Qs = short_smem;
  float* Ks = Qs + rq * ld;
  float* Vs = Ks + rk * ld;
  float* Ss = Vs + rk * ld;  // scores, then probabilities
  float* Ms = Ss + rq * kSSt;
  float* Ls = Ms + rq;

  stage(Qs, head_of(q, b, h), q.st, q0, nq, nq4, D, ld);
  stage(Ks, head_of(k, b, h), k.st, 0, nk, nk, D, ld);
  stage(Vs, head_of(v, b, h), v.st, 0, nk, nk4, D, ld);
  cp_async_wait_all();
  __syncthreads();

  // scores: a work item is 4 query rows by 32 keys, a lane a key
  const int nkb = (nk + 31) >> 5;
  for (int it = warp; it < (nq4 >> 2) * nkb; it += nw) {
    const int i0 = (it / nkb) << 2, j = ((it % nkb) << 5) + lane;
    if (j >= nk) continue;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (!kCausal || j <= q0 + i0 + 3)
      score_rows(Qs + i0 * ld, Ks, nullptr, nullptr, ld, d4, j, s, nullptr);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      Ss[(i0 + r) * kSSt + j] = visible<kCausal>(q0 + i0 + r, j, T) ? s[r] * scale : kNegInf;
  }
  __syncthreads();

  // softmax over each whole row: a warp a row, two keys a lane
  for (int i = warp; i < nq4; i += nw) {
    const int qi = q0 + i;
    float* srow = Ss + i * kSSt;
    const bool v0 = lane < nk && visible<kCausal>(qi, lane, T);
    const bool v1 = lane + 32 < nk && visible<kCausal>(qi, lane + 32, T);
    const float s0 = v0 ? srow[lane] : kNegInf, s1 = v1 ? srow[lane + 32] : kNegInf;
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = v0 ? expf(s0 - m) : 0.f, p1 = v1 ? expf(s1 - m) : 0.f;
    const float l = warp_sum(p0 + p1);
    if (lane < nk4) srow[lane] = p0;  // zeros from nk to nk4: the P V loop
    if (lane + 32 < nk4) srow[lane + 32] = p1;  // runs over 4 keys at a time
    if (lane == 0) {
      Ms[i] = m;
      Ls[i] = l;
    }
  }
  __syncthreads();

  // o = P V / l: lane = float4 column, 4 query rows a work item
  float* oh = head_of(o, b, h);
  const bool ovec = rows_vec(oh, o.st, D);
  for (int it = warp; it < (nq4 >> 2); it += nw) {
    const int i0 = it << 2;
    if (lane < d4) {
      float4 acc[4];
      rows_times(Ss + i0 * kSSt, Vs + 4 * lane, ld, kCausal ? min(nk4, q0 + i0 + 4) : nk4, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + r >= nq) break;
        const float ls = fmaxf(Ls[i0 + r], 1e-30f);
        const float4 a = acc[r];
        store4(oh, o.st, q0 + i0 + r, lane, D, ovec,
               make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls));
      }
    }
    if (lane < 4 && i0 + lane < nq)
      lse[(size_t)bh * T + q0 + i0 + lane] = Ms[i0 + lane] + logf(fmaxf(Ls[i0 + lane], 1e-30f));
  }
}

// Grid (B*H, parts): a block takes one head's dK/dV and dQ (parts = 1), or
// with parts = 2 block 0 the dK/dV and block 1 the dQ.
template <bool kCausal>
__global__ void __launch_bounds__(kShortThreads)
attn_bwd_short_kernel(View q, View k, View v, View dout, View o, const float* __restrict__ lse,
                      View dq, View dk, View dv, int H, int T, int D, float scale) {
  extern __shared__ __align__(16) float short_smem[];
  const int ld = short_ld(D), d4 = (D + 3) >> 2, t4 = round4(T), n4 = t4 >> 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  float* Qs = short_smem;
  float* Ks = Qs + t4 * ld;
  float* Vs = Ks + t4 * ld;
  float* dOs = Vs + t4 * ld;
  float* Os = dOs + t4 * ld;
  float* Ps = Os + t4 * ld;
  float* dSs = Ps + t4 * kSSt;
  float* Lse = dSs + t4 * kSSt;
  float* Dl = Lse + t4;

  stage(Qs, head_of(q, b, h), q.st, 0, T, t4, D, ld);
  stage(Ks, head_of(k, b, h), k.st, 0, T, t4, D, ld);
  stage(Vs, head_of(v, b, h), v.st, 0, T, t4, D, ld);
  stage(dOs, head_of(dout, b, h), dout.st, 0, T, t4, D, ld);
  stage(Os, head_of(o, b, h), o.st, 0, T, t4, D, ld);
  for (int i = threadIdx.x; i < t4; i += blockDim.x) Lse[i] = i < T ? lse[(size_t)bh * T + i] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  // delta = rowsum(dO * O): a warp a row
  for (int i = warp; i < t4; i += nw) {
    const int c = 4 * lane;
    const float a = warp_sum(lane < d4 ? dot4(ld4(dOs + i * ld + c), ld4(Os + i * ld + c), 0.f) : 0.f);
    if (lane == 0) Dl[i] = a;
  }
  __syncthreads();

  // P and dS, zero where masked and up to column t4: a work item is 4 query
  // rows by 32 keys, a lane a key
  const int nkb = (t4 + 31) >> 5;
  for (int it = warp; it < n4 * nkb; it += nw) {
    const int i0 = (it / nkb) << 2, j = ((it % nkb) << 5) + lane;
    if (j >= t4) continue;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < T && (!kCausal || j <= i0 + 3))
      score_rows(Qs + i0 * ld, Ks, dOs + i0 * ld, Vs, ld, d4, j, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      const bool vis = visible<kCausal>(i, j, T);
      const float p = vis ? expf(s[r] * scale - Lse[i]) : 0.f;
      Ps[i * kSSt + j] = p;
      dSs[i * kSSt + j] = vis ? p * (dp[r] - Dl[i]) : 0.f;
    }
  }
  __syncthreads();

  // products, lane = float4 column: items 0 .. n4-1 are dK/dV of key rows
  // 4w .. 4w+3, items n4 .. 2 n4 - 1 dQ of query rows
  const int first = (gridDim.y == 2 && blockIdx.y == 1) ? n4 : 0;
  const int last = (gridDim.y == 2 && blockIdx.y == 0) ? n4 : 2 * n4;
  float* dqh = head_of(dq, b, h);
  float* dkh = head_of(dk, b, h);
  float* dvh = head_of(dv, b, h);
  const bool dqv = rows_vec(dqh, dq.st, D), dkv = rows_vec(dkh, dk.st, D),
             dvv = rows_vec(dvh, dv.st, D);
  const int c = 4 * lane;
  for (int it = first + warp; it < last; it += nw) {
    if (lane >= d4) continue;
    if (it < n4) {
      const int j0 = it << 2;
      float4 ak[4], av[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ak[r] = av[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int i = kCausal ? j0 : 0; i < T; ++i) {
        const float4 p4 = ld4(Ps + i * kSSt + j0), s4 = ld4(dSs + i * kSSt + j0);
        const float4 dov = ld4(dOs + i * ld + c), qv = ld4(Qs + i * ld + c);
        axpy4(p4.x, dov, av[0]);
        axpy4(p4.y, dov, av[1]);
        axpy4(p4.z, dov, av[2]);
        axpy4(p4.w, dov, av[3]);
        axpy4(s4.x, qv, ak[0]);
        axpy4(s4.y, qv, ak[1]);
        axpy4(s4.z, qv, ak[2]);
        axpy4(s4.w, qv, ak[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (j0 + r >= T) break;
        store4(dkh, dk.st, j0 + r, lane, D, dkv, mul4(scale, ak[r]));
        store4(dvh, dv.st, j0 + r, lane, D, dvv, av[r]);
      }
    } else {
      const int i0 = (it - n4) << 2;
      float4 aq[4];
      rows_times(dSs + i0 * kSSt, Ks + c, ld, kCausal ? min(t4, i0 + 4) : t4, aq);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i0 + r >= T) break;
        store4(dqh, dq.st, i0 + r, lane, D, dqv, mul4(scale, aq[r]));
      }
    }
  }
}

size_t fwd_smem(int D) { return sizeof(float) * (3 * kTile * row_stride(D) + kTile * kPStride); }
size_t dkv_smem(int D) {
  return sizeof(float) * (4 * kTile * row_stride(D) + 2 * kTile * kPStride + 2 * kTile);
}
size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * row_stride(D) + kTile * kPStride + 2 * kTile);
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

View view_of(const float* p, const long long* s) { return View{const_cast<float*>(p), s[0], s[1], s[2]}; }

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shapes, types and contiguity are validated by the Python wrapper
// (ops/kernels/flash_attention.py); D must be in [1, 128]. Each entry
// returns cudaGetLastError() after its launch (or the attribute call's
// error), and does not synchronise.
int attn_forward(const float* q, const float* k, const float* v, float* o, float* lse,
                 int BH, int T, int D, int causal, float scale, void* stream) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(D);
  const dim3 grid((T + kTile - 1) / kTile, BH);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (causal) {
    if ((e = allow_smem((const void*)attn_fwd_kernel<true>, smem)) != cudaSuccess) return (int)e;
    attn_fwd_kernel<true><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, T, D, scale);
  } else {
    if ((e = allow_smem((const void*)attn_fwd_kernel<false>, smem)) != cudaSuccess) return (int)e;
    attn_fwd_kernel<false><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, T, D, scale);
  }
  return (int)cudaGetLastError();
}

int attn_backward_dkv(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dk, float* dv,
                      int BH, int T, int D, int causal, float scale, void* stream) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = dkv_smem(D);
  const dim3 grid((T + kTile - 1) / kTile, BH);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (causal) {
    if ((e = allow_smem((const void*)attn_bwd_dkv_kernel<true>, smem)) != cudaSuccess) return (int)e;
    attn_bwd_dkv_kernel<true><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dk, dv,
                                                            T, D, scale);
  } else {
    if ((e = allow_smem((const void*)attn_bwd_dkv_kernel<false>, smem)) != cudaSuccess) return (int)e;
    attn_bwd_dkv_kernel<false><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dk, dv,
                                                             T, D, scale);
  }
  return (int)cudaGetLastError();
}

int attn_backward_dq(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dq,
                     int BH, int T, int D, int causal, float scale, void* stream) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = dq_smem(D);
  const dim3 grid((T + kTile - 1) / kTile, BH);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (causal) {
    if ((e = allow_smem((const void*)attn_bwd_dq_kernel<true>, smem)) != cudaSuccess) return (int)e;
    attn_bwd_dq_kernel<true><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dq,
                                                           T, D, scale);
  } else {
    if ((e = allow_smem((const void*)attn_bwd_dq_kernel<false>, smem)) != cudaSuccess) return (int)e;
    attn_bwd_dq_kernel<false><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dq,
                                                            T, D, scale);
  }
  return (int)cudaGetLastError();
}

// Short route, T in [1, 64]. strides holds (b, h, t) strides in elements for
// each operand in argument order: q, k, v, o for the forward; q, k, v, dout,
// o, dq, dk, dv for the backward. Every operand's last dimension is
// contiguous, lse is a contiguous [B, H, T]. rows (a multiple of 4) and
// threads (a multiple of 32, at most 384) are the forward's launch plan;
// threads and parts (1 or 2) the backward's.
int attn_forward_short(const float* q, const float* k, const float* v, float* o, float* lse,
                       const long long* strides, int B, int H, int T, int D, int causal,
                       float scale, int rows, int threads, void* stream) {
  if (B < 1 || H < 1 || T < 1 || T > kShortT || D < 1 || D > kMaxD || rows < 4 ||
      rows > kShortT || (rows & 3) || threads < 32 || threads > kShortThreads || (threads & 31))
    return (int)cudaErrorInvalidValue;
  const View vq = view_of(q, strides), vk = view_of(k, strides + 3), vv = view_of(v, strides + 6),
             vo = view_of(o, strides + 9);
  const size_t smem = sizeof(float) * fwd_short_floats(rows, T, D);
  const dim3 grid(B * H, (T + rows - 1) / rows);
  auto kernel = causal ? attn_fwd_short_kernel<true> : attn_fwd_short_kernel<false>;
  const cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(vq, vk, vv, vo, lse, H, T, D, rows, scale);
  return (int)cudaGetLastError();
}

int attn_backward_short(const float* q, const float* k, const float* v, const float* dout,
                        const float* o, const float* lse, float* dq, float* dk, float* dv,
                        const long long* strides, int B, int H, int T, int D, int causal,
                        float scale, int threads, int parts, void* stream) {
  if (B < 1 || H < 1 || T < 1 || T > kShortT || D < 1 || D > kMaxD || threads < 32 ||
      threads > kShortThreads || (threads & 31) || parts < 1 || parts > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * bwd_short_floats(T, D);
  const dim3 grid(B * H, parts);
  auto kernel = causal ? attn_bwd_short_kernel<true> : attn_bwd_short_kernel<false>;
  const cudaError_t e = allow_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      view_of(q, strides), view_of(k, strides + 3), view_of(v, strides + 6),
      view_of(dout, strides + 9), view_of(o, strides + 12), lse, view_of(dq, strides + 15),
      view_of(dk, strides + 18), view_of(dv, strides + 21), H, T, D, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
