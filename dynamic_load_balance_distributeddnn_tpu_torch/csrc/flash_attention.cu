// K3: flash attention, f32, D <= 128, in two routes chosen by the caller
// (ops/kernels/flash_attention.py) by the sequence length T:
//
// - T <= 64, the short route (the language model's T = 35): one tile covers
//   the whole sequence. attn_fwd_short_kernel and attn_bwd_short_kernel take
//   [B, H, T, D] strided views (last dimension contiguous, strides of b, h
//   and t given), so the projections' [B, T, H, D] memory is read in place
//   and o, dq, dk, dv are written in whatever layout the caller allocated.
//   See "Short route" below.
// - T > 64, the tiled route (the language model at --bptt 256, longer
//   contexts): the streaming-softmax kernels of "Tiled route" below, on
//   row-contiguous [BH, T, D] (BH = batch * heads), with the per-row
//   log-sum-exp lse[BH, T] f32 saved by the forward and delta[BH, T] =
//   rowsum(dO * O) computed by the caller.
//
// Replaces the TPU kernels of dynamic_load_balance_distributeddnn_tpu/ops/
// pallas/flash_attention.py:
//   _attn_fwd_kernel (:58)      -> attn_fwd_short_kernel, attn_fwd_tc_kernel
//   _attn_bwd_dkv_kernel (:106) -> attn_bwd_short_kernel, attn_bwd_dkv_tc_kernel
//   _attn_bwd_dq_kernel (:153)  -> attn_bwd_short_kernel, attn_bwd_dq_tc_kernel
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
// nothing, so that axis is a loop inside the block, over tiles that stream
// through a ring in shared memory. At long T the work is O(T^2 D) against
// O(T D) bytes, so it is bound by operations. The design:
// - Products on the tensor cores in 3xTF32, the arithmetic of PyTorch's own
//   f32 memory-efficient attention (CUTLASS's OpMultiplyAddFastF32): each
//   f32 operand x is split into hi = x rounded to TF32 (to nearest, as
//   cvt.rna.tf32 rounds, but by two integer operations: cvt runs on the
//   conversion unit, and with it the split, not the products, bound the
//   kernels) and lo = x - hi (which the unit reads to TF32 by dropping its
//   low bits), and mma.sync.m16n8k8 (tf32 in, f32 accumulate) sums lo*hi +
//   hi*lo + hi*hi. That keeps f32-level accuracy (one TF32 term alone keeps
//   about three digits and fails the tolerances; tests/test_torch_flash.py
//   emulates both) at up to 494.7 / 3 = 165 TFLOP/s of f32 work, against 67
//   for f32 FMAs. Bound: 3 x the product flops over 494.7 TFLOP/s. mma.sync
//   rather than wgmma, chosen by argument (no wgmma version was built or
//   timed): wgmma's tf32 operands must be K-major in shared
//   memory, which for P V, dV += P^T dO, dK += dS^T Q and dQ += dS K means
//   staging P or dS and transposing V, dO, Q or K tiles through shared
//   memory, and the hi / lo split of a shared operand would need a second
//   copy of each tile; mma.sync takes P and dS from registers and splits
//   each operand as it is loaded.
// - Flash-attention-2 warp layout. A warp owns 16 rows: of queries
//   (forward, dQ) or keys (dK/dV). Scores and outputs stay in registers
//   (mma accumulator fragments); row max and row sum take two quad
//   shuffles. P and dS go from accumulator fragments straight to A operands:
//   the fragment holds keys 2t and 2t+1 of an 8-key step where the A operand
//   wants t and t+4, so the B operand's rows are read in the same permuted
//   order and nothing moves.
// - An asynchronous tile ring. Tiles come by 16-byte cp.async (4-byte where
//   D is not a multiple of 4 or the base is misaligned) and the next tile's
//   copy is in flight behind this tile's products. Shared rows are D padded
//   with zeros to the kernel's class of D (64, 104 or 128 columns: a
//   multiple of 8; in shared memory only) plus 4 floats: a row stride of 4
//   mod 8 words puts the 32 lanes of every fragment load on 32 banks.
// - Occupancy. The forward is 4 warps (64 query rows) with Q staged once
//   and K and V of each 32-key tile passing through 3 slots in turn (K of
//   tile j, V of tile j, ...; 2 copies in flight): 3 blocks (12 warps) an SM
//   up to D = 104, 2 (8 warps) at D = 128. Two slots would let 3 blocks
//   share an SM at D = 128 as well, but with one copy in flight the 12
//   warps measured slower than the 8 (scripts/flash_bench.py on an H100),
//   so the slots are fixed at 3 for every D. The backward kernels are 8 warps in 4
//   pairs, 2 blocks (16 warps) an SM, streaming 16-row stages: in dK/dV a
//   pair owns 16 keys, one warp builds P^T and accumulates dV, the other
//   builds dP^T, takes P^T from its partner through shared memory (a named
//   barrier for the two warps) to form dS^T and accumulates dK; in dQ a
//   pair owns 16 query rows, one warp builds P, the other dP and dS, and
//   each accumulates half of dQ's columns from the shared dS. So each warp
//   holds one 16 x D accumulator (dQ: half of one), no score tile is
//   computed twice, and the two warps of a pair do equal products. Each
//   kernel is compiled for a class of D (up to 64, 104 or 128 columns):
//   its loops over D unroll with no test, and the products of a k-step are
//   independent, so the tensor cores are kept fed.
// - Causal order. A block's index runs over (tile, bh) with the heaviest
//   tiles first (the forward's and dQ's last query tiles, dK/dV's first key
//   tiles), so the long blocks start in the first wave and the short ones
//   fill the tail. Tiles no row of a warp can see are skipped (the block's
//   loop stops at the diagonal); only tiles that cross the diagonal or T are
//   masked element by element.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

template <bool kCausal>
__device__ __forceinline__ bool visible(int qi, int kj, int T) {
  return qi < T && kj < T && (!kCausal || kj <= qi);
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


// ---------------------------------------------------------------------------
// Tiled route (T > 64), on the tensor cores. See the header for the design.

constexpr int kRows = 64;          // query rows (forward, dQ) or key rows (dK/dV) of a block
constexpr int kFwdTile = 32;       // keys of a forward slot
constexpr int kFwdSlots = 3;       // slots of the forward's ring (2 copies in flight)
constexpr int kBwdTile = 16;       // query (dK/dV) or key (dQ) rows of a backward stage
constexpr int kFwdThreads = 128;   // 4 warps of 16 rows
constexpr int kBwdThreads = 256;   // 4 pairs of warps, a pair per 16 rows
constexpr int kMaxSmem = 232448;   // the most dynamic shared memory a block may take

// Head dims by class: a kernel is compiled for ND 8-column groups (D <= 8
// ND), so its loops over D unroll with no test; columns D .. 8 ND - 1 of
// every staged row are zero.
__host__ __device__ __forceinline__ int nd_class(int D) { return D <= 64 ? 8 : D <= 104 ? 13 : 16; }
// Row stride (floats) of a staged tile: 8 ND plus 4 (4 mod 8 words).
__host__ __device__ __forceinline__ int tc_ld(int D) { return 8 * nd_class(D) + 4; }

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` (1..15) for the two warps of a pair: the writer arrives, the
// reader waits. The fence makes the writer's shared stores visible first.
__device__ __forceinline__ void pair_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) { asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory"); }

// x = hi + lo for the TF32 tensor cores: hi is x rounded to nearest (ties
// away from zero, cvt.rna.tf32.f32's rounding) by adding half a TF32 unit to
// the bits and clearing the 13 below; lo = x - hi exactly, whose low 13 bits
// the unit ignores. Two integer operations and one add: cvt to TF32 runs on
// the conversion unit at a sixteenth of the FMA rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small terms first, then hi * hi.
__device__ __forceinline__ void mma3(float c[4], const uint32_t ahi[4], const uint32_t alo[4],
                                     const uint32_t bhi[2], const uint32_t blo[2]) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

// Fragments (lane = 4 g + t): an accumulator c[4] of a 16 x 8 tile holds
// rows g (c0, c1) and g + 8 (c2, c3), columns 2t (c0, c2) and 2t + 1 (c1, c3).

// acc[n] += A B_n^T over the padded head dim: A the warp's 16 rows, B_n rows
// 8n .. 8n+7 of a tile, both staged [rows][8 ND + 4]. The two small terms
// add into their own accumulators, so each k-step's products form 2 NT
// independent chains rather than NT chains of three.
template <int NT, int ND>
__device__ __forceinline__ void mma_rows(const float* __restrict__ A, const float* __restrict__ B,
                                         float acc[NT][4]) {
  constexpr int ld = 8 * ND + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a = A + g * ld + t;
  const float* b = B + g * ld + t;
  float small[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) small[n][0] = small[n][1] = small[n][2] = small[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    uint32_t ahi[4], alo[4];
    split_tf32(a[8 * kk], ahi[0], alo[0]);
    split_tf32(a[8 * kk + 8 * ld], ahi[1], alo[1]);
    split_tf32(a[8 * kk + 4], ahi[2], alo[2]);
    split_tf32(a[8 * kk + 8 * ld + 4], ahi[3], alo[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bhi[2], blo[2];
      split_tf32(b[8 * n * ld + 8 * kk], bhi[0], blo[0]);
      split_tf32(b[8 * n * ld + 8 * kk + 4], bhi[1], blo[1]);
      mma_tf32(small[n], alo, bhi);
      mma_tf32(small[n], ahi, blo);
      mma_tf32(acc[n], ahi, bhi);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += small[n][i];
}

// acc[j] += P M_j: P the warp's 16 x 8NK weights in accumulator fragments
// (p[kk] the 8 columns 8kk .. 8kk+7), M a staged [8NK][8 ND + 4] tile, M_j
// its columns 8n .. 8n+7 for n = first + j (a group past ND - 1 reads group
// ND - 1 again, into an accumulator no one stores). No test inside: every
// product of a k-step is independent of the others. The A operand takes
// P's columns 2t, 2t+1 where it expects t, t+4, so M's rows are read in
// that order too.
template <int NK, int NJ, int ND>
__device__ __forceinline__ void mma_pm(const float p[NK][4], const float* __restrict__ M, int first,
                                       float acc[NJ][4]) {
  constexpr int ld = 8 * ND + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* m = M + 2 * t * ld + g;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t ahi[4], alo[4];
    split_tf32(p[kk][0], ahi[0], alo[0]);
    split_tf32(p[kk][2], ahi[1], alo[1]);
    split_tf32(p[kk][1], ahi[2], alo[2]);
    split_tf32(p[kk][3], ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 8 * (NJ == ND ? j : min(first + j, ND - 1));
      uint32_t bhi[2], blo[2];
      split_tf32(m[8 * kk * ld + col], bhi[0], blo[0]);
      split_tf32(m[(8 * kk + 1) * ld + col], bhi[1], blo[1]);
      mma3(acc[j], ahi, alo, bhi, blo);
    }
  }
}

// Whether a head's rows can go by 16-byte copies.
__device__ __forceinline__ bool rows16(const float* p, int D) {
  return ((reinterpret_cast<uintptr_t>(p) & 15) == 0) && ((D & 3) == 0);
}

// Issue the copies of rows r0 .. r0+n-1 of a row-contiguous [T, D] head into
// dst[n][ld]; rows at or past T are zeroed (columns below dp). A warp a row,
// a lane 4 (or 1) columns. Nothing waits here.
__device__ __forceinline__ void stage_tile(float* dst, const float* head, int r0, int n, int T,
                                           int D, int ld, int dp, bool vec) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < n; r += nw) {
    float* drow = dst + r * ld;
    if (r0 + r >= T) {
      for (int c = lane; c < dp; c += 32) drow[c] = 0.f;
      continue;
    }
    const float* srow = head + (size_t)(r0 + r) * D;
    if (vec) {
      for (int c = 4 * lane; c < D; c += 128) cp_async16(drow + c, srow + c);
    } else {
      for (int c = lane; c < D; c += 32) cp_async4(drow + c, srow + c);
    }
  }
}

// Entries r0 .. r0+n-1 of a [T] row vector into dst[n], zero past T.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int r0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (r0 + i < T) cp_async4(dst + i, src + r0 + i);
    else dst[i] = 0.f;
  }
}

// Columns D .. dp - 1 of the first `rows` staged rows, which no copy writes,
// to zero: once a kernel.
__device__ __forceinline__ void zero_pad_columns(float* buf, int rows, int D, int ld, int dp) {
  const int w = dp - D;
  if (w == 0) return;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int r = i / w;
    buf[r * ld + D + (i - r * w)] = 0.f;
  }
}

// The fragment exchange of a pair: [NT][32 lanes][4], each lane its own
// float4s (conflict-free).
template <int NT>
__device__ __forceinline__ void put_frag(float* x, const float s[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    *reinterpret_cast<float4*>(x + (n * 32 + lane) * 4) = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
}
template <int NT>
__device__ __forceinline__ void get_frag(const float* x, float s[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 f = *reinterpret_cast<const float4*>(x + (n * 32 + lane) * 4);
    s[n][0] = f.x;
    s[n][1] = f.y;
    s[n][2] = f.z;
    s[n][3] = f.w;
  }
}

// A warp's 16 x 8NJ accumulator out to rows r0 .. r0+15 of [T, D] memory,
// times mul: acc[j] holds columns 8 (first + j) .. +7.
template <int NJ>
__device__ __forceinline__ void store_rows(float* __restrict__ head, const float acc[NJ][4], int r0,
                                           int T, int D, int first, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= T) continue;
    float* row = head + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * (first + j) + 2 * t + e;
        if (col < D) row[col] = mul * acc[j][2 * h + e];
      }
  }
}

// Grid: (query tiles) x BH blocks, block i on query tile (nqt - 1 - i / BH)
// under causal (heaviest first), i / BH otherwise, head i % BH. Shared: Q
// [64][ld], then kFwdSlots slots [32][ld] that K and V of each key tile
// pass through in turn (load i: K of tile i / 2 if i is even, V if odd, into
// slot i % kFwdSlots; kFwdSlots - 1 loads in flight behind the products).
template <int ND, bool kCausal>
__global__ void __launch_bounds__(kFwdThreads, 3)
attn_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   int BH, int T, int D, float scale) {
  constexpr int BC = kFwdTile, NT = BC / 8, ld = 8 * ND + 4, dp = 8 * ND, SLOTS = kFwdSlots;
  extern __shared__ __align__(16) float tc_smem[];
  const int nqt = (T + kRows - 1) / kRows, tile = blockIdx.x / BH, bh = blockIdx.x - tile * BH;
  const int q0 = (kCausal ? nqt - 1 - tile : tile) * kRows;
  const size_t base = (size_t)bh * T * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* Qs = tc_smem;
  float* ring = Qs + kRows * ld;
  const bool vk = rows16(k, D), vv = rows16(v, D);

  zero_pad_columns(tc_smem, kRows + SLOTS * BC, D, ld, dp);
  const int k_end = kCausal ? min(q0 + kRows, T) : T;
  const int loads = 2 * ((k_end + BC - 1) / BC);
  auto issue = [&](int i) {
    stage_tile(ring + (i % SLOTS) * BC * ld, ((i & 1) ? v : k) + base, (i >> 1) * BC, BC, T, D, ld,
               dp, (i & 1) ? vv : vk);
  };
  stage_tile(Qs, q + base, q0, kRows, T, D, ld, dp, rows16(q, D));
#pragma unroll
  for (int i = 0; i < SLOTS - 1; ++i) {  // loads >= 2: K and V of the first tile
    issue(i);
    cp_async_commit();
  }

  float acc[ND][4], s[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int w0 = q0 + 16 * warp;  // the warp's first query row
  const float* Qw = Qs + 16 * warp * ld;
  for (int i = 0; i < loads; ++i) {
    cp_async_wait<SLOTS - 2>();  // load i has landed (the SLOTS - 2 after it may be in flight)
    __syncthreads();             // ... for every thread; and slot (i - 1) % SLOTS is read by no one
    if (i + SLOTS - 1 < loads) issue(i + SLOTS - 1);
    cp_async_commit();
    const float* tl = ring + (i % SLOTS) * BC * ld;
    const int k0 = (i >> 1) * BC;
    if (kCausal && k0 > w0 + 15) continue;  // no row of this warp sees the tile
    if ((i & 1) == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      mma_rows<NT, ND>(Qw, tl, s);
      const bool edge = k0 + BC > T || (kCausal && k0 + BC - 1 > w0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = w0 + g + 8 * h;
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[n][2 * h + e] * scale;
            if (edge && !visible<kCausal>(r, k0 + 8 * n + 2 * t + e, T)) x = kNegInf;
            s[n][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx), corr = expf(m[h] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool vis = !edge || visible<kCausal>(r, k0 + 8 * n + 2 * t + e, T);
            const float p = vis ? expf(s[n][2 * h + e] - m_new) : 0.f;
            s[n][2 * h + e] = p;
            rs += p;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[h] = l[h] * corr + rs;
        m[h] = m_new;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * h] *= corr;
          acc[n][2 * h + 1] *= corr;
        }
      }
    } else {
      mma_pm<NT, ND, ND>(s, tl, 0, acc);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w0 + g + 8 * h;
    if (r >= T) continue;
    const float ls = fmaxf(l[h], 1e-30f);
    float* row = o + base + (size_t)r * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < D) row[col] = acc[n][2 * h + e] / ls;
      }
    if (t == 0) lse[(size_t)bh * T + r] = m[h] + logf(ls);
  }
}

// Grid: (key tiles) x BH blocks, block i on key tile i / BH (under causal
// the first key tiles see the most queries: heaviest first), head i % BH;
// loops over query tiles of BQ rows from the diagonal on. Pair p = warp % 4
// owns keys k0 + 16p .. +15; warp p builds P^T and accumulates dV, warp p + 4
// builds dP^T and dS^T and accumulates dK. Shared: K, V [64][ld]; 2 stages
// of Q, dO [BQ][ld]; 2 stages of lse, delta [BQ]; the pairs' exchange.
template <int ND, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, 2)
attn_bwd_dkv_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int BH, int T, int D,
                       float scale) {
  constexpr int BQ = kBwdTile, NT = BQ / 8, ld = 8 * ND + 4, dp = 8 * ND;
  extern __shared__ __align__(16) float tc_smem[];
  const int kt = blockIdx.x / BH, bh = blockIdx.x - kt * BH, k0 = kt * kRows;
  const size_t base = (size_t)bh * T * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, role = warp >> 2;
  float* Ks = tc_smem;
  float* Vs = Ks + kRows * ld;
  float* ring = Vs + kRows * ld;     // stage st: Q at ring + 2 st BQ ld, dO BQ ld after
  float* rows = ring + 4 * BQ * ld;  // stage st: lse at rows + 2 st BQ, delta BQ after
  float* xw = rows + 4 * BQ + pair * NT * 128;
  const bool vq = rows16(q, D), vdo = rows16(dout, D);

  zero_pad_columns(tc_smem, 2 * kRows + 4 * BQ, D, ld, dp);
  const int q_begin = kCausal ? k0 : 0;  // BQ divides 64: a tile boundary
  const int tiles = (T - q_begin + BQ - 1) / BQ;
  auto issue = [&](int it) {
    const int q0 = q_begin + it * BQ, st = it & 1;
    float* Qt = ring + 2 * st * BQ * ld;
    stage_tile(Qt, q + base, q0, BQ, T, D, ld, dp, vq);
    stage_tile(Qt + BQ * ld, dout + base, q0, BQ, T, D, ld, dp, vdo);
    stage_vec(rows + 2 * st * BQ, lse + (size_t)bh * T, q0, BQ, T);
    stage_vec(rows + 2 * st * BQ + BQ, delta + (size_t)bh * T, q0, BQ, T);
  };
  stage_tile(Ks, k + base, k0, kRows, T, D, ld, dp, rows16(k, D));
  stage_tile(Vs, v + base, k0, kRows, T, D, ld, dp, rows16(v, D));
  issue(0);
  cp_async_commit();

  float acc[ND][4], s[NT][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int kf = k0 + 16 * pair;  // the pair's first key
  const float* Aw = (role == 0 ? Ks : Vs) + 16 * pair * ld;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();  // tile it has landed
    __syncthreads();     // ... for every thread; the other stage and the exchange are free
    if (it + 1 < tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    const int q0 = q_begin + it * BQ, st = it & 1;
    const float* Qt = ring + 2 * st * BQ * ld;
    const float* dOt = Qt + BQ * ld;
    const float* Lt = rows + 2 * st * BQ;
    const float* Dt = Lt + BQ;
    if (kf >= T || (kCausal && q0 + BQ - 1 < kf)) continue;  // no query of the tile sees the pair's keys
    const bool edge = q0 + BQ > T || kf + 15 >= T || (kCausal && kf + 15 > q0);
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // rows: keys kf + g (+ 8); columns: queries q0 + 8n + 2t (+ 1)
    mma_rows<NT, ND>(Aw, role == 0 ? Qt : dOt, s);
    if (role == 0) {  // S^T -> P^T; dV += P^T dO
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = kf + g + 8 * (i >> 1), qc = 8 * n + 2 * t + (i & 1);
          const bool vis = !edge || visible<kCausal>(q0 + qc, kj, T);
          s[n][i] = vis ? expf(s[n][i] * scale - Lt[qc]) : 0.f;
        }
      put_frag<NT>(xw, s);
      pair_arrive(1 + pair);
      mma_pm<NT, ND, ND>(s, dOt, 0, acc);
    } else {  // dP^T -> dS^T = P^T (dP^T - delta); dK += dS^T Q
      float p[NT][4];
      pair_sync(1 + pair);
      get_frag<NT>(xw, p);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = p[n][i] * (s[n][i] - Dt[8 * n + 2 * t + (i & 1)]);
      mma_pm<NT, ND, ND>(s, Qt, 0, acc);
    }
  }
  store_rows<ND>((role == 0 ? dv : dk) + base, acc, kf, T, D, 0, role == 0 ? 1.f : scale);
}

// Grid as the forward's. Pair p = warp % 4 owns query rows q0 + 16p .. +15;
// warp p builds P, warp p + 4 builds dP and dS = P (dP - delta) and hands dS
// back; warp p accumulates the first (ND + 1) / 2 8-column groups of dQ,
// warp p + 4 the rest. Shared: Q, dO [64][ld]; 2 stages of K, V [BC][ld];
// lse, delta [64]; the pairs' exchange.
template <int ND, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, 2)
attn_bwd_dq_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, int BH, int T, int D, float scale) {
  constexpr int BC = kBwdTile, NT = BC / 8, ld = 8 * ND + 4, dp = 8 * ND, NJ = (ND + 1) / 2;
  extern __shared__ __align__(16) float tc_smem[];
  const int nqt = (T + kRows - 1) / kRows, tile = blockIdx.x / BH, bh = blockIdx.x - tile * BH;
  const int q0 = (kCausal ? nqt - 1 - tile : tile) * kRows;
  const size_t base = (size_t)bh * T * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pair = warp & 3, role = warp >> 2;
  float* Qs = tc_smem;
  float* dOs = Qs + kRows * ld;
  float* ring = dOs + kRows * ld;  // stage st: K at ring + 2 st BC ld, V BC ld after
  float* Ls = ring + 4 * BC * ld;
  float* Dl = Ls + kRows;
  float* xw = Dl + kRows + pair * NT * 128;
  const bool vk = rows16(k, D), vv = rows16(v, D);

  zero_pad_columns(tc_smem, 2 * kRows + 4 * BC, D, ld, dp);
  const int k_end = kCausal ? min(q0 + kRows, T) : T;
  const int tiles = (k_end + BC - 1) / BC;
  auto issue = [&](int it) {
    float* Kt = ring + 2 * (it & 1) * BC * ld;
    stage_tile(Kt, k + base, it * BC, BC, T, D, ld, dp, vk);
    stage_tile(Kt + BC * ld, v + base, it * BC, BC, T, D, ld, dp, vv);
  };
  stage_tile(Qs, q + base, q0, kRows, T, D, ld, dp, rows16(q, D));
  stage_tile(dOs, dout + base, q0, kRows, T, D, ld, dp, rows16(dout, D));
  stage_vec(Ls, lse + (size_t)bh * T, q0, kRows, T);
  stage_vec(Dl, delta + (size_t)bh * T, q0, kRows, T);
  issue(0);
  cp_async_commit();

  float acc[NJ][4], s[NT][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int rf = q0 + 16 * pair;  // the pair's first query row
  const float* Aw = (role == 0 ? Qs : dOs) + 16 * pair * ld;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    const int k0 = it * BC;
    const float* Kt = ring + 2 * (it & 1) * BC * ld;
    const float* Vt = Kt + BC * ld;
    if (rf >= T || (kCausal && k0 > rf + 15)) continue;  // no row of the pair sees the tile
    const bool edge = k0 + BC > T || rf + 15 >= T || (kCausal && k0 + BC - 1 > rf);
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // rows: queries rf + g (+ 8); columns: keys k0 + 8n + 2t (+ 1)
    mma_rows<NT, ND>(Aw, role == 0 ? Kt : Vt, s);
    if (role == 0) {  // S -> P, out; dS in
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int lr = 16 * pair + g + 8 * (i >> 1), kj = k0 + 8 * n + 2 * t + (i & 1);
          const bool vis = !edge || visible<kCausal>(q0 + lr, kj, T);
          s[n][i] = vis ? expf(s[n][i] * scale - Ls[lr]) : 0.f;
        }
      put_frag<NT>(xw, s);
      pair_arrive(1 + pair);
      pair_sync(5 + pair);
      get_frag<NT>(xw, s);
    } else {  // dP, P in; dS = P (dP - delta) out
      float p[NT][4];
      pair_sync(1 + pair);
      get_frag<NT>(xw, p);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = p[n][i] * (s[n][i] - Dl[16 * pair + g + 8 * (i >> 1)]);
      put_frag<NT>(xw, s);
      pair_arrive(5 + pair);
    }
    mma_pm<NT, NJ, ND>(s, Kt, role * NJ, acc);
  }
  store_rows<NJ>(dq + base, acc, rf, T, D, role * NJ, scale);
}

size_t fwd_tc_smem(int D) {
  return sizeof(float) * (size_t)(kRows + kFwdSlots * kFwdTile) * tc_ld(D);
}
size_t dkv_tc_smem(int D) {
  return sizeof(float) * ((size_t)(2 * kRows + 4 * kBwdTile) * tc_ld(D) + 68 * kBwdTile);
}
size_t dq_tc_smem(int D) {
  return sizeof(float) * ((size_t)(2 * kRows + 4 * kBwdTile) * tc_ld(D) + 2 * kRows + 64 * kBwdTile);
}


// Dynamic shared memory above 48 KB must be allowed per kernel and device
// first; with max_carveout the SM's unified L1 / shared memory is also set
// to its largest shared share for the kernel. Each (kernel, device)
// remembers the largest size allowed so far, so cudaFuncSetAttribute runs
// once per kernel and size, not on every launch.
cudaError_t allow_smem(const void* kernel, size_t smem, bool max_carveout = false) {
  if (smem <= 48 * 1024 && !max_carveout) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{kernel, dev}];
  if (smem <= have) return cudaSuccess;
  if (max_carveout && have == 0)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) have = smem;
  return e;
}

View view_of(const float* p, const long long* s) { return View{const_cast<float*>(p), s[0], s[1], s[2]}; }

// The tiled kernels by head-dim class (nd_class) and causality.
using FwdKernel = void (*)(const float*, const float*, const float*, float*, float*, int, int, int,
                           float);
using DkvKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, float*, float*, int, int, int, float);
using DqKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, float*, int, int, int, float);

template <int N>
FwdKernel fwd_of(bool c) { return c ? attn_fwd_tc_kernel<N, true> : attn_fwd_tc_kernel<N, false>; }
template <int N>
DkvKernel dkv_of(bool c) { return c ? attn_bwd_dkv_tc_kernel<N, true> : attn_bwd_dkv_tc_kernel<N, false>; }
template <int N>
DqKernel dq_of(bool c) { return c ? attn_bwd_dq_tc_kernel<N, true> : attn_bwd_dq_tc_kernel<N, false>; }

template <typename K, K (*of8)(bool), K (*of13)(bool), K (*of16)(bool)>
K by_class(int D, bool causal) {
  const int nd = nd_class(D);
  return (nd == 8 ? of8 : nd == 13 ? of13 : of16)(causal);
}
FwdKernel fwd_tc(int D, bool c) { return by_class<FwdKernel, fwd_of<8>, fwd_of<13>, fwd_of<16>>(D, c); }
DkvKernel dkv_tc(int D, bool c) { return by_class<DkvKernel, dkv_of<8>, dkv_of<13>, dkv_of<16>>(D, c); }
DqKernel dq_tc(int D, bool c) { return by_class<DqKernel, dq_of<8>, dq_of<13>, dq_of<16>>(D, c); }

// A tiled kernel's launch, checked: its shared memory allowed (and the SM's
// carveout set to shared memory, so the planned blocks fit side by side).
cudaError_t tc_ready(const void* kernel, size_t smem, int BH, int T, int D) {
  if (kernel == nullptr || BH < 1 || T < 1 || D < 1 || D > kMaxD || smem > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  return allow_smem(kernel, smem, true);
}

unsigned tc_blocks(int T, int BH) { return (unsigned)((T + kRows - 1) / kRows) * (unsigned)BH; }

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shapes, types and contiguity are validated by the Python wrapper
// (ops/kernels/flash_attention.py); D must be in [1, 128]. Each entry returns cudaGetLastError() after its
// launch (or the attribute call's error), and does not synchronise.
int attn_forward(const float* q, const float* k, const float* v, float* o, float* lse,
                 int BH, int T, int D, int causal, float scale, void* stream) {
  const FwdKernel kernel = fwd_tc(D, causal != 0);
  const size_t smem = fwd_tc_smem(D);
  const cudaError_t e = tc_ready((const void*)kernel, smem, BH, T, D);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tc_blocks(T, BH), kFwdThreads, smem, (cudaStream_t)stream>>>(q, k, v, o, lse, BH, T, D,
                                                                         scale);
  return (int)cudaGetLastError();
}

int attn_backward_dkv(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dk, float* dv,
                      int BH, int T, int D, int causal, float scale, void* stream) {
  const DkvKernel kernel = dkv_tc(D, causal != 0);
  const size_t smem = dkv_tc_smem(D);
  const cudaError_t e = tc_ready((const void*)kernel, smem, BH, T, D);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tc_blocks(T, BH), kBwdThreads, smem, (cudaStream_t)stream>>>(q, k, v, dout, lse, delta,
                                                                         dk, dv, BH, T, D, scale);
  return (int)cudaGetLastError();
}

int attn_backward_dq(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dq,
                     int BH, int T, int D, int causal, float scale, void* stream) {
  const DqKernel kernel = dq_tc(D, causal != 0);
  const size_t smem = dq_tc_smem(D);
  const cudaError_t e = tc_ready((const void*)kernel, smem, BH, T, D);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tc_blocks(T, BH), kBwdThreads, smem, (cudaStream_t)stream>>>(q, k, v, dout, lse, delta,
                                                                         dq, BH, T, D, scale);
  return (int)cudaGetLastError();
}

// Blocks of a tiled kernel (which: 0 the forward, 1 dK/dV, 2 dQ; causal) an
// SM holds at head dim D, by the occupancy calculator; its shared memory per
// block in *smem and the columns it stages a row (D padded to its class of
// D) in *cols.
int attn_tiled_occupancy(int which, int D, int* blocks, int* smem, int* cols) {
  const void* kernel = which == 0 ? (const void*)fwd_tc(D, true)
                     : which == 1 ? (const void*)dkv_tc(D, true)
                                  : (const void*)dq_tc(D, true);
  const size_t bytes = which == 0 ? fwd_tc_smem(D) : which == 1 ? dkv_tc_smem(D)
                                                                       : dq_tc_smem(D);
  const cudaError_t e = tc_ready(kernel, bytes, 1, kRows + 1, D);
  if (e != cudaSuccess) return (int)e;
  *smem = (int)bytes;
  *cols = 8 * nd_class(D);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, which == 0 ? kFwdThreads : kBwdThreads, bytes);
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
