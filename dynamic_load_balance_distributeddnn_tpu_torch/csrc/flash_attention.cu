// K3: flash attention (streaming softmax), forward, dK/dV and dQ, on
// row-contiguous f32 q, k, v, o, dO of shape [BH, T, D] (BH = batch * heads),
// D <= 128, with the per-row log-sum-exp lse[BH, T] f32 saved by the forward
// and delta[BH, T] = rowsum(dO * O) computed by the caller.
//
// Replaces the TPU kernels of dynamic_load_balance_distributeddnn_tpu/ops/
// pallas/flash_attention.py:
//   attn_fwd_kernel     <- _attn_fwd_kernel      (:58)
//   attn_bwd_dkv_kernel <- _attn_bwd_dkv_kernel  (:106)
//   attn_bwd_dq_kernel  <- _attn_bwd_dq_kernel   (:153)
// with the same math: scores s = scale * q.k (scale = 1/sqrt(D)), keys at or
// past T and, if causal, keys after the query masked to -1e30; the forward
// keeps a running max m, sum l and f32 accumulator over key tiles and writes
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); the backward
// recomputes p = exp(s - lse) and forms dV = P^T dO, dS = P * (dP - delta)
// with dP = dO V^T, dK = scale * dS^T Q and dQ = scale * dS K.
//
// What differs from the TPU kernels, and why:
// - The TPU pads T to a multiple of the tile and D to 128 in device memory
//   before the call. Here nothing is padded in memory: each tile is loaded
//   into shared memory with zeros past row T and column D, and the masks
//   above keep padded keys and queries out of every sum. A masked entry
//   gives p = 0 explicitly, so a row with no visible key yields o = 0 and
//   finite lse, never NaN.
// - The TPU's sequential grid axis over key tiles (forward, dQ) or query
//   tiles (dK/dV) carries its running sums in VMEM scratch between grid
//   steps. Blocks on a GPU run in no order and carry nothing, so that axis
//   is a loop inside the block: one block per (bh, 64-row tile), the
//   accumulators in registers. Causally dead tiles are not visited: the
//   forward and dQ loops stop at the diagonal tile, the dK/dV loop starts
//   at it. Each output tile is owned by one block, so there are no float
//   atomics and the gradients are the same on every run.
//
// Bound on this card. At the language model's shape (T = 35, D = 100, BH up
// to 80) a call moves well under a megabyte and does a few MFLOP: it is
// bound by launch and latency (a few microseconds of setup, one or two
// dependent tile iterations per block), not by bytes or operations. At long
// T the work is O(T^2 D) against O(T D) bytes, so it is bound by operations.
// These first kernels compute in f32 on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores: 256 threads per block, each owning a 4 x 4 patch
// of the 64 x 64 score tile and a 4 x 8 patch of the 64 x D output tile in
// registers, with q, k, v and dO tiles staged in shared memory (rows padded
// to an odd stride so the 16 threads reading 16 different rows hit 16
// different banks). A later redesign would move the products to wgmma.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

size_t fwd_smem(int D) { return sizeof(float) * (3 * kTile * row_stride(D) + kTile * kPStride); }
size_t dkv_smem(int D) {
  return sizeof(float) * (4 * kTile * row_stride(D) + 2 * kTile * kPStride + 2 * kTile);
}
size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * row_stride(D) + kTile * kPStride + 2 * kTile);
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename K>
cudaError_t launch_prep(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

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
    if ((e = launch_prep(attn_fwd_kernel<true>, smem)) != cudaSuccess) return (int)e;
    attn_fwd_kernel<true><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, T, D, scale);
  } else {
    if ((e = launch_prep(attn_fwd_kernel<false>, smem)) != cudaSuccess) return (int)e;
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
    if ((e = launch_prep(attn_bwd_dkv_kernel<true>, smem)) != cudaSuccess) return (int)e;
    attn_bwd_dkv_kernel<true><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dk, dv,
                                                            T, D, scale);
  } else {
    if ((e = launch_prep(attn_bwd_dkv_kernel<false>, smem)) != cudaSuccess) return (int)e;
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
    if ((e = launch_prep(attn_bwd_dq_kernel<true>, smem)) != cudaSuccess) return (int)e;
    attn_bwd_dq_kernel<true><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dq,
                                                           T, D, scale);
  } else {
    if ((e = launch_prep(attn_bwd_dq_kernel<false>, smem)) != cudaSuccess) return (int)e;
    attn_bwd_dq_kernel<false><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dq,
                                                            T, D, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
