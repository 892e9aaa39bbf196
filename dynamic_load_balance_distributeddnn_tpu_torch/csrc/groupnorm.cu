// K1: fused GroupNorm with an optional relu epilogue, forward and backward,
// on channels-last activations x[B, S, C] (S = H*W), G groups of C/G
// channels, f32 statistics, output in the input dtype (f32 or bf16).
//
// Replaces the TPU kernel dynamic_load_balance_distributeddnn_tpu/ops/pallas/
// groupnorm.py: _gn_fwd_kernel (forward) and _fused_gn_bwd (its backward,
// plain jnp in the JAX package, a kernel here).
//
// Bound: memory bandwidth. The forward must read x once and write y once,
// the backward read x and dy and write dx: bytes over 3.35 TB/s on an H100,
// against a handful of flops per element. The TPU kernel keeps one batch
// element's whole [S, C] slab in VMEM (up to 1024x224 f32 = 0.9 MB), far
// past the 227 KB of shared memory a block may hold, so that design is not
// carried over. Here one block owns one (batch element, group) strip of
// S x C/G values: it reduces the strip in f32, then makes a second pass to
// normalize and write. The strip is at most a few hundred KB and the card
// runs ~130 such blocks at once, so the second read is served mostly from
// the 50 MB L2, not from device memory. Neighbouring groups of one row
// share 32-byte sectors and run as neighbouring blocks, which keeps the
// device-memory traffic close to one read of x.
//
// The variance is max(E[x^2] - mean^2, 0), the TPU kernel's formula (not
// torch's two-pass one), so the two agree to rounding.
//
// The backward writes per-batch-element partial sums of dscale and dbias,
// [B, C] f32, and a second small kernel sums them over B in a fixed order:
// float atomics would make the parameter gradients change from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
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
    float v = (to_f32(xb[s * C + c]) - mean) * rstd * sc[c] + bi[c];
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
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
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
      if (relu && !(xh * w + bb > 0.f)) d = 0.f;
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
    if (relu && !(xh * w + bi[cl] > 0.f)) d = 0.f;
    const float dxh = d * w;
    dxb[off] = from_f32<T>(k * (fn * dxh - tot.x - xh * tot.y));
  }
}

// dscale[c] = sum_b dscale_part[b, c] (same for dbias), in order of b.
__global__ void gn_param_reduce_kernel(const float* __restrict__ dscale_part,
                                       const float* __restrict__ dbias_part,
                                       float* __restrict__ dscale,
                                       float* __restrict__ dbias, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, d = 0.f;
  for (int b = 0; b < B; ++b) {
    a += dscale_part[(int64_t)b * C + c];
    d += dbias_part[(int64_t)b * C + c];
  }
  dscale[c] = a;
  dbias[c] = d;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch. Shapes are validated by the Python wrapper.
int gn_forward(const void* x, const float* scale, const float* bias, void* y,
               float* mean, float* rstd, int B, int S, int C, int G, float eps,
               int relu, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B * G), block(kThreads);
  if (dtype == 0) {
    gn_fwd_kernel<float><<<grid, block, 0, st>>>(
        (const float*)x, scale, bias, (float*)y, mean, rstd, S, C, G, eps, relu);
  } else {
    gn_fwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
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
    gn_bwd_kernel<float><<<grid, block, smem, st>>>(
        (const float*)x, (const float*)dy, scale, bias, mean, rstd, (float*)dx,
        dscale_part, dbias_part, S, C, G, relu);
  } else {
    gn_bwd_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, scale, bias, mean,
        rstd, (__nv_bfloat16*)dx, dscale_part, dbias_part, S, C, G, relu);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_param_reduce_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      dscale_part, dbias_part, dscale, dbias, B, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
