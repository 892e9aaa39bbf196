// K2: per-example softmax cross-entropy, forward and backward, on
// row-contiguous logits[R, V] (f32 or bf16) with int64 labels[R].
//
// Replaces the TPU kernels dynamic_load_balance_distributeddnn_tpu/ops/
// pallas/xent.py: _xent_fwd_kernel (forward: f32 max-shifted logsumexp minus
// the gold logit) and _xent_bwd_kernel (backward: recomputes the softmax
// from the logits and writes g * (softmax - onehot), storing no softmax).
//
// Bound: memory bandwidth — one read of the logits (plus one write of the
// gradient in the backward) over 3.35 TB/s, against a few flops and one exp
// per element. The TPU kernel works on 8-row blocks held in VMEM; here one
// warp owns one row and loops over V in strides of 32 lanes, so any V works
// (V = 10 for the CNNs, 33278 for the language model later). A row is read
// twice (max, then sum of exp); the second read hits L1/L2. The gold logit
// is picked by an index == label test, as the TPU kernel's iota mask does:
// a label outside [0, V) contributes 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// Row max and sum of exp(x - max) over one row, returned to every lane.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ x, int V, int lane,
                                          float* m_out, float* s_out) {
  float m = -INFINITY;
  for (int v = lane; v < V; v += 32) m = fmaxf(m, to_f32(x[v]));
  m = warp_max(m);
  float s = 0.f;
  for (int v = lane; v < V; v += 32) s += expf(to_f32(x[v]) - m);
  *m_out = m;
  *s_out = warp_sum(s);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
xent_fwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                float* __restrict__ loss, int R, int V) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* x = logits + (int64_t)row * V;
  const int64_t lbl = labels[row];
  float m, s;
  row_stats(x, V, lane, &m, &s);
  float gold = 0.f;
  for (int v = lane; v < V; v += 32)
    if (v == lbl) gold = to_f32(x[v]);
  gold = warp_sum(gold);
  if (lane == 0) loss[row] = logf(s) + m - gold;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
xent_bwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                const float* __restrict__ g, T* __restrict__ dx, int R, int V) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* x = logits + (int64_t)row * V;
  T* d = dx + (int64_t)row * V;
  const int64_t lbl = labels[row];
  float m, s;
  row_stats(x, V, lane, &m, &s);
  const float gr = g[row];
  for (int v = lane; v < V; v += 32) {
    const float p = expf(to_f32(x[v]) - m) / s;
    d[v] = from_f32<T>(gr * (p - (v == lbl ? 1.f : 0.f)));
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch. Shapes are validated by the Python wrapper.
int xent_forward(const void* logits, const int64_t* labels, float* loss, int R,
                 int V, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((R + kWarps - 1) / kWarps), block(kWarps * 32);
  if (dtype == 0) {
    xent_fwd_kernel<float><<<grid, block, 0, st>>>((const float*)logits, labels,
                                                   loss, R, V);
  } else {
    xent_fwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)logits, labels, loss, R, V);
  }
  return (int)cudaGetLastError();
}

int xent_backward(const void* logits, const int64_t* labels, const float* g,
                  void* dx, int R, int V, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((R + kWarps - 1) / kWarps), block(kWarps * 32);
  if (dtype == 0) {
    xent_bwd_kernel<float><<<grid, block, 0, st>>>((const float*)logits, labels,
                                                   g, (float*)dx, R, V);
  } else {
    xent_bwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)logits, labels, g, (__nv_bfloat16*)dx, R, V);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
