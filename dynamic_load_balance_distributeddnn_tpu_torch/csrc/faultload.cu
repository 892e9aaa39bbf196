// The compute-mode straggler's synthetic load: n dependent products of a
// 256 x 256 f32 matrix, acc <- tanh(acc @ acc) * 0.5 + 0.5, starting from
// the matrix filled with 1e-4 + seed * 1e-8, and the scalar
// sum(acc) * 1e-12 that keeps the chain live.
//
// Replaces the JAX package's dynamic_load_balance_distributeddnn_tpu/ops/
// faultload.py synthetic_load (a lax.fori_loop that XLA runs on the device;
// no Pallas kernel).
//
// The load exists to be device time. One iteration is about 34 MFLOP, a few
// microseconds of an H100, so a launch an iteration leaves the card waiting
// on the host, and even replayed CUDA graphs pay a gap at every kernel
// boundary: on an H100 80GB HBM3 at 700 W the card was busy 88-91% of a
// 1,000-iteration chain of cuBLAS products and elementwise kernels replayed
// from graphs (chip_smoke.py). So the whole chain is one persistent kernel,
// launched cooperatively:
//
// - 64 blocks, each owning a 32 x 32 tile of the product (256 threads, four
//   outputs a thread). An iteration stages 32-wide k slices of its 32 rows
//   and 32 columns in shared memory and accumulates over k = 0..255 in
//   order, one fused multiply-add a step; then tanh, scale and shift.
// - The matrix lives in two global buffers, read in one iteration and
//   written in the next (ping-pong), with a grid-wide barrier between
//   iterations. Reads go through L2 (ld.global.cg): a block's L1 may still
//   hold a line of the buffer from two iterations back.
// - The sum: each thread keeps its four outputs of the last iteration in
//   registers; a block sums its tile (warp shuffles, then its warps in
//   order) into one partial, and after a last barrier block 0 sums the 64
//   partials in order. No float atomics, so the result repeats bit for bit.
// - The iteration count is read from device memory (an int32 scalar), not
//   passed by value: a launch captured into a CUDA graph (train/supersteps.py)
//   keeps its arguments, so a count that changes between replays (a
//   time-varying straggler schedule) is copied into that scalar before each
//   replay instead. The launch is cudaLaunchKernelEx with the cooperative
//   attribute, the form a graph's kernel node carries.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 256;                         // the product's side
constexpr int kTile = 32;                       // a block's output tile
constexpr int kBlocks = (kN / kTile) * (kN / kTile);
constexpr int kThreads = 256;
constexpr int kChunk = 32;                      // k slice staged per step

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// work: two kN x kN buffers, then kBlocks partial sums.
__global__ void __launch_bounds__(kThreads) synthetic_load_kernel(const float* seed,
                                                                   const int* n_iters, float* work,
                                                                   float* out) {
  cg::grid_group grid = cg::this_grid();
  const int n = *n_iters;  // every thread reads the same count; n <= 0 runs none
  __shared__ float a_s[kTile][kChunk + 1];  // rows r0.., k slice (padded)
  __shared__ __align__(16) float b_s[kChunk][kTile];  // k slice, columns c0..
  __shared__ float warp_part[kThreads / 32];

  float* buf[2] = {work, work + kN * kN};
  float* partial = work + 2 * kN * kN;
  const int r0 = (blockIdx.x / (kN / kTile)) * kTile;
  const int c0 = (blockIdx.x % (kN / kTile)) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the staging copy: a thread moves one float4 of each 32 x 32 slice
  const int lr = threadIdx.x / 8, lc = (threadIdx.x % 8) * 4;

  // the seed matrix, rounded as the plain version's f32 ops round it
  const float x0 = __fadd_rn(1e-4f, __fmul_rn(*seed, 1e-8f));
  float mine[2][2] = {{x0, x0}, {x0, x0}};
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) buf[0][(r0 + ty + 16 * i) * kN + c0 + tx + 16 * j] = x0;
  grid.sync();

  for (int it = 0; it < n; ++it) {
    const float* src = buf[it & 1];
    float* dst = buf[(it + 1) & 1];
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < kN; k0 += kChunk) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(src + (r0 + lr) * kN + k0 + lc));
      const float4 b = __ldcg(reinterpret_cast<const float4*>(src + (k0 + lr) * kN + c0 + lc));
      a_s[lr][lc] = a.x; a_s[lr][lc + 1] = a.y; a_s[lr][lc + 2] = a.z; a_s[lr][lc + 3] = a.w;
      *reinterpret_cast<float4*>(&b_s[lr][lc]) = b;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float a0 = a_s[ty][k], a1 = a_s[ty + 16][k];
        const float b0 = b_s[k][tx], b1 = b_s[k][tx + 16];
        acc[0][0] = fmaf(a0, b0, acc[0][0]);
        acc[0][1] = fmaf(a0, b1, acc[0][1]);
        acc[1][0] = fmaf(a1, b0, acc[1][0]);
        acc[1][1] = fmaf(a1, b1, acc[1][1]);
      }
      __syncthreads();
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        mine[i][j] = __fadd_rn(__fmul_rn(tanhf(acc[i][j]), 0.5f), 0.5f);
        dst[(r0 + ty + 16 * i) * kN + c0 + tx + 16 * j] = mine[i][j];
      }
    grid.sync();
  }

  float s = warp_sum((mine[0][0] + mine[0][1]) + (mine[1][0] + mine[1][1]));
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_part[w];
    partial[blockIdx.x] = t;
  }
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float t = __ldcg(partial + threadIdx.x) + __ldcg(partial + threadIdx.x + 32);
    t = warp_sum(t);
    if (threadIdx.x == 0) *out = __fmul_rn(t, 1e-12f);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The floats of scratch the kernel needs: two matrices and the partials.
int synthetic_load_work_floats() { return 2 * kN * kN + kBlocks; }

// *n_iters iterations; seed, n_iters, work and out are device pointers (f32
// scalar, int32 scalar, synthetic_load_work_floats() floats, f32 scalar).
// Returns the launch's CUDA error (a device without cooperative launch
// refuses it).
int synthetic_load(const float* seed, const int* n_iters, float* work, float* out, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, synthetic_load_kernel, seed, n_iters, work, out);
}

}  // extern "C"
