// K2: per-example softmax cross-entropy, forward and backward, on
// row-contiguous logits[R, V] (f32 or bf16) with int64 labels[R].
//
// Replaces the TPU kernels dynamic_load_balance_distributeddnn_tpu/ops/
// pallas/xent.py: _xent_fwd_kernel (forward: f32 max-shifted logsumexp minus
// the gold logit) and _xent_bwd_kernel (backward: recomputes the softmax
// from the logits and writes g * (softmax - onehot), storing no softmax).
//
// Bound: memory bytes. The forward reads the logits once (plus a few bytes
// per row), the backward reads them once and writes the gradient once; at
// the language model's width (V = 18,328) a row is 73 KB of f32 against a
// handful of operations and one exp per element. So the design is about
// keeping enough 16-byte loads in flight and touching each byte once:
//
// - Forward, one pass. Each thread keeps an online (max, sum of exp) pair
//   over kUnroll 16-byte vector loads at a time (float4, or 8 x bf16). The
//   pairs (m_i, s_i) merge into (M, sum_i s_i e^(m_i - M)), M the largest
//   m_i: a max and then a sum by warp shuffles, across the warp and then
//   across the block's warps (through a small shared array).
//   The gold logit is one guarded direct load of x[label], issued first and
//   used last (the TPU kernel's iota mask exists because a TPU has no cheap
//   lane gather; a label outside [0, V) still gives gold 0). In the warp-
//   per-row kernel the lane that loads column label keeps it and one
//   shuffle hands it over: there the row is a few loads long, and a load
//   that waits on the label's load sat on the critical path. It writes the
//   loss and the row's logsumexp (lse), both f32.
// - Backward, one pass: with the forward's lse saved (4 bytes a row),
//   p = exp(x - lse) needs no max, no sum and no divide, so the logits are
//   read once and the gradient written once. No softmax is ever stored.
// - Grid by regime. Large V: one block per row, of as many threads as the
//   wrapper's plan (ops/kernels/xent.py, set by measurement) asks for: the
//   block size is a launch argument, not a template parameter, so one
//   kernel serves every size a measurement tries. Small V (the CNNs' 10
//   or 100 classes): one warp per row, 8 rows per block. A row is never
//   split over several blocks: a cluster of blocks merging their pairs
//   through distributed shared memory measured slower at every language-
//   model shape on an H100, 105 rows included.
// - Alignment: a row need not start on 16 bytes (V = 33,278 or 10 f32, or a
//   row slice such as logits[1:]). Each row's misaligned head and ragged
//   tail (fewer than one vector each) are peeled with scalar loads inside
//   the kernel; the gradient is stored by vectors where its row has the
//   same offset as the logits', else element by element.
// - Deterministic: every thread's elements and the shuffle trees over the
//   warp and over the block's warps go in a fixed order; no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;       // 16-byte loads in flight per thread
constexpr int kWarpRows = 8;     // rows per block in the warp-per-row kernels
constexpr int kMaxThreads = 512; // largest block of the block-per-row kernels

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Elements per 16-byte vector.
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

// A row's (or a part's) running max m and sum s of exp(x - m).
struct Stats {
  float m, s;
};

// Fold U x K values into st: one rescale for the group, one exp per value.
// Padding is -inf and adds exp(-inf) = 0.
template <int U, int K>
__device__ __forceinline__ void absorb(Stats& st, const float (&a)[U][K]) {
  float cm = a[0][0];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < K; ++k) cm = fmaxf(cm, a[u][k]);
  if (cm > st.m) {
    st.s *= expf(st.m - cm);  // st.m = -inf gives 0 * 0
    st.m = cm;
  }
  if (st.m == -INFINITY) return;  // nothing but -inf so far
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < K; ++k) st.s += expf(a[u][k] - st.m);
}

// The warp's 32 pairs merged, in every lane: the max by a butterfly, then
// each lane's sum rescaled to it once and summed by a butterfly (the same
// additions in every lane, so every lane holds the same bits).
__device__ __forceinline__ Stats warp_merge(Stats st) {
  float m = st.m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (m == -INFINITY) return {m, 0.f};  // the whole warp saw nothing
  float s = st.s * expf(st.m - m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return {m, s};
}

// Where the 16-byte-aligned body of row x starts (elements) and how many
// whole vectors it holds; the rest of [0, V) is a scalar head and tail.
template <typename T>
__device__ __forceinline__ void row_layout(const T* x, int V, int* head, int* nvec) {
  const int off = (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(x) & 15u)) & 15u) / sizeof(T));
  *head = min(V, off);
  *nvec = (V - *head) / Vec<T>::n;
}

// ------------------------------------------------ large V: a block per row

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
xent_fwd_block_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                      float* __restrict__ loss, float* __restrict__ lse, int V) {
  constexpr int N = Vec<T>::n;
  static_assert(kMaxThreads / 32 <= 32, "one warp merges the warps' pairs");
  __shared__ Stats warp_st[kMaxThreads / 32];

  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;  // a multiple of 32, at most kMaxThreads
  const T* x = logits + row * V;
  int head, nvec;
  row_layout(x, V, &head, &nvec);

  float gold = 0.f;  // loaded now, used at the end
  if (tid == 0) {
    const int64_t lbl = labels[row];
    if (lbl >= 0 && lbl < V) gold = to_f32(x[lbl]);
  }
  Stats st{-INFINITY, 0.f};
  const T* body = x + head;
  for (int i = tid; i < nvec; i += kUnroll * threads) {
    float a[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * threads;
      if (j < nvec) {
        load_vec(body + (int64_t)j * N, a[u]);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) a[u][k] = -INFINITY;
      }
    }
    absorb(st, a);
  }
  {  // the scalar head and tail, fewer than N elements each
    const int tail = head + nvec * N + tid;
    float a[1][1];
    a[0][0] = tid < head ? to_f32(x[tid]) : -INFINITY;
    absorb(st, a);
    a[0][0] = tail < V ? to_f32(x[tail]) : -INFINITY;
    absorb(st, a);
  }

  st = warp_merge(st);
  if ((tid & 31) == 0) warp_st[tid >> 5] = st;
  __syncthreads();
  if (tid < 32) {
    st = tid < threads / 32 ? warp_st[tid] : Stats{-INFINITY, 0.f};
    st = warp_merge(st);
    if (tid == 0) {
      const float l = st.m + logf(st.s);
      lse[row] = l;
      loss[row] = l - gold;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
xent_bwd_block_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                      const float* __restrict__ g, const float* __restrict__ lse,
                      T* __restrict__ dx, int V) {
  constexpr int N = Vec<T>::n;
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const T* x = logits + row * V;
  T* d = dx + row * V;
  int head, nvec;
  row_layout(x, V, &head, &nvec);
  const int64_t lbl = labels[row];
  const float gr = g[row], l = lse[row];
  // the gradient's rows have the logits' offset mod 16 unless the logits
  // are a slice of a larger buffer; then it is stored element by element
  const bool vec_store =
      ((reinterpret_cast<uintptr_t>(d) ^ reinterpret_cast<uintptr_t>(x)) & 15u) == 0;

  const T* xb = x + head;
  T* db = d + head;
  for (int i = tid; i < nvec; i += kUnroll * threads) {
    float a[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * threads;
      if (j < nvec) load_vec(xb + (int64_t)j * N, a[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * threads;
      if (j < nvec) {
        const int64_t e0 = head + (int64_t)j * N;  // the vector's first column
#pragma unroll
        for (int k = 0; k < N; ++k)
          a[u][k] = gr * (expf(a[u][k] - l) - (e0 + k == lbl ? 1.f : 0.f));
        if (vec_store) {
          store_vec(db + (int64_t)j * N, a[u]);
        } else {
#pragma unroll
          for (int k = 0; k < N; ++k) db[(int64_t)j * N + k] = from_f32<T>(a[u][k]);
        }
      }
    }
  }
  const int tail = head + nvec * N + tid;  // the scalar head and tail
  if (tid < head) d[tid] = from_f32<T>(gr * (expf(to_f32(x[tid]) - l) - (tid == lbl ? 1.f : 0.f)));
  if (tail < V) d[tail] = from_f32<T>(gr * (expf(to_f32(x[tail]) - l) - (tail == lbl ? 1.f : 0.f)));
}

// ------------------------------------------------ small V: a warp per row

template <typename T>
__global__ void __launch_bounds__(kWarpRows * 32)
xent_fwd_warp_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                     float* __restrict__ loss, float* __restrict__ lse, int R, int V) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= R) return;  // a whole warp leaves together
  const T* x = logits + row * V;
  const int64_t lbl = labels[row];
  float gold = 0.f;  // kept by the lane that loads column lbl
  Stats st{-INFINITY, 0.f};
  for (int i = lane; i < V; i += kUnroll * 32) {
    float a[kUnroll][1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * 32;
      a[u][0] = j < V ? to_f32(x[j]) : -INFINITY;
      if (j < V && j == lbl) gold = a[u][0];
    }
    absorb(st, a);
  }
  st = warp_merge(st);
  gold = __shfl_sync(0xffffffffu, gold, (int)(lbl & 31));  // column lbl's lane
  if (lane == 0) {
    const float l = st.m + logf(st.s);
    lse[row] = l;
    loss[row] = l - gold;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpRows * 32)
xent_bwd_warp_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                     const float* __restrict__ g, const float* __restrict__ lse,
                     T* __restrict__ dx, int R, int V) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* x = logits + row * V;
  T* d = dx + row * V;
  const int64_t lbl = labels[row];
  const float gr = g[row], l = lse[row];
#pragma unroll 4
  for (int v = lane; v < V; v += 32)
    d[v] = from_f32<T>(gr * (expf(to_f32(x[v]) - l) - (v == lbl ? 1.f : 0.f)));
}

// ------------------------------------------------ launchers

// threads: 0 = a warp per row, else the block size of the block-per-row
// kernel (a multiple of 32, at most kMaxThreads).
bool bad_threads(int threads) {
  return threads < 0 || threads % 32 != 0 || threads > kMaxThreads;
}

template <typename T>
cudaError_t launch_fwd(const T* x, const int64_t* labels, float* loss, float* lse, int R, int V,
                       int threads, cudaStream_t st) {
  if (bad_threads(threads)) return cudaErrorInvalidValue;
  if (threads == 0)
    xent_fwd_warp_kernel<T><<<(R + kWarpRows - 1) / kWarpRows, kWarpRows * 32, 0, st>>>(
        x, labels, loss, lse, R, V);
  else
    xent_fwd_block_kernel<T><<<R, threads, 0, st>>>(x, labels, loss, lse, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const T* x, const int64_t* labels, const float* g, const float* lse, T* dx,
                       int R, int V, int threads, cudaStream_t st) {
  if (bad_threads(threads)) return cudaErrorInvalidValue;
  if (threads == 0)
    xent_bwd_warp_kernel<T><<<(R + kWarpRows - 1) / kWarpRows, kWarpRows * 32, 0, st>>>(
        x, labels, g, lse, dx, R, V);
  else
    xent_bwd_block_kernel<T><<<R, threads, 0, st>>>(x, labels, g, lse, dx, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 = float32, 1 = bfloat16. threads: 0 = a warp per row, else the
// block size (a multiple of 32, at most 512) of the block-per-row kernels.
// Returns the launch's CUDA error. Shapes are validated by the Python
// wrapper.
int xent_forward(const void* logits, const int64_t* labels, float* loss, float* lse, int R, int V,
                 int dtype, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fwd((const float*)logits, labels, loss, lse, R, V, threads, st);
  return (int)launch_fwd((const __nv_bfloat16*)logits, labels, loss, lse, R, V, threads, st);
}

int xent_backward(const void* logits, const int64_t* labels, const float* g, const float* lse,
                  void* dx, int R, int V, int dtype, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_bwd((const float*)logits, labels, g, lse, (float*)dx, R, V, threads, st);
  return (int)launch_bwd((const __nv_bfloat16*)logits, labels, g, lse, (__nv_bfloat16*)dx, R, V,
                         threads, st);
}

}  // extern "C"
