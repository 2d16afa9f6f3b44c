// image_wise_dynamic's normalised-ReLU vertex attention on Hopper (sm_90a): a
// forward kernel and a backward kernel pair (H), behind one autograd.Function.
//
// Replaces no TPU kernel. The JAX package computes this attention outside any
// kernel, as a lax.scan over vertex chunks (smpl_nerf_tpu/ops/vertex_attention.py,
// relu_attention_warp); the port's eager version of that scan, run under
// autograd, launched ~160 operations forward and ~350 backward a step and sent
// every [rows, 512] chunk of (sample, vertex) pairs to device memory and back
// about ten times each way: ~107 of ~110 device ms of an image_wise_dynamic
// training step at SMPL's 6,890 vertices. Plain versions: ops/vertex_attention.py,
// relu_attention_eager (forward, differentiable) and relu_attention_backward_plain
// (the closed-form gradient below).
//
// N samples s_n (a step's rays x samples) share one mesh: goal vertices v and
// warp vectors w, [V, 3] each.
//
//   d2   = (dx*dx + dz*dz) + dy*dy, dx = s - v      (every product and sum rounded,
//   d    = sqrt(max(d2, 1e-24))                       no FMA: the eager path's d2 on
//                                                     the card, see eager_pair)
//   a    = relu(r - d)
//   out  = sum_v a w_v / (sum_v a + 1e-5)
//
// and, given g = dL/dout, D = sum_v a + 1e-5, gw = g / D, ga = -(g . out) / D, over
// the pairs with a > 0 (relu's derivative is 0 at 0, as PyTorch's):
//
//   c      = gw . w_v + ga
//   dL/dw_v = sum_n a gw_n
//   dL/dv   = sum_n c (s_n - v) / d               (0 where d2 < 1e-24, as the
//   dL/ds_n = -sum_v c (s_n - v) / d                clamp's gradient is 0 there)
//
// What bounds it on the H100: the FP32 pipe. The inputs and outputs are a few MB
// (samples, out, the cotangent: 1.5 MB each at 131,072 samples; the mesh 165 KB,
// L2-resident), while the pairs are 903 M a step: the published math is ~10 FP32
// operations a pair forward and ~20 backward, 27 GFLOP a step, 0.4 ms at 67
// TFLOP/s. This design spends 4 FP32 instructions a pair on a test (three FMAs
// and a compare) in each kernel, and the published math only on the pairs that
// pass it (a few per cent lie inside a sphere): ~0.12 ms of FP32 issue a kernel.
//
// Design.
// 1. The pass test (G's, csrc/vertex_attention.cu). |s - v|^2 < r^2 is tested as
//    |v|^2 (1 - k) - 2 s.v < r^2 (1 + k) - |s|^2 (1 - k), k = 1e-5: the point held
//    in shared memory as (-2x, -2y, -2z, |x|^2 (1 - k)), three FMAs against the
//    point in registers. k covers the rounding of the FMA chain (a few ulps of
//    |s|^2 + 2|s||v| + |v|^2, far below k (|s|^2 + |v|^2)) and of the eager d2 (a
//    few ulps of r^2, below k r^2), so every pair with a > 0 passes. A pair that
//    passes takes d2 the eager way, then the sqrt and the relu: its a is the eager
//    path's bit for bit, and a pair that passed but lies outside adds exactly 0.
//    Only the order of the sums differs from the eager path.
// 2. Forward, sample-major (relu_attention_rows_kernel<false>). A block owns 64
//    consecutive samples (256 threads: 16 sample groups x 16 vertex lanes; thread
//    t holds samples t % 16 + 16 k, k < 4, and takes vertices t / 16 + 16 j of
//    each tile) and streams the whole mesh through shared memory in double-
//    buffered tiles of 512 vertices (8 KB of goal, 8 KB of warps), the next
//    tile's loads in registers while the current one is computed. It writes
//    out [N, 3] and sum_v a [N], which the backward keeps: 2 MB, no [N, V] array.
// 3. Backward, vertex-major (relu_attention_vertex_kernel). A block owns 64
//    vertices (thread t holds vertices t % 16 + 16 k, k < 4, and takes samples
//    t / 16 + 16 j of each tile) and streams one split of the samples through
//    shared memory in tiles of 512, each sample as (-2s, |s|^2 (1 - k)) and
//    (gw, ga), both worked out from the cotangent, out and sum_v a as the tile is
//    loaded. 108 vertex tiles would leave SMs idle, so the samples are split
//    into about 1,056 / tiles pieces (a number fixed by N and V alone); each
//    block writes its 64 vertices' six sums to a scratch [splits, V, 6], and
//    relu_attention_reduce_kernel adds the splits in order.
// 4. The samples' gradient (relu_attention_rows_kernel<true>), only when the
//    samples need one (no caller on the card asks today): the forward's
//    sample-major loop with gw and ga in registers and c (s - v) / d summed.
// 5. Determinism. Each thread sums its pairs in order; the 16 lanes' partials
//    are combined through shared memory in lane order, the splits in split
//    order; no float atomics. Two runs give the same bits.
// 6. Non-finite inputs, forward: the eager path makes a NaN sample's row NaN, a
//    NaN vertex every row NaN, and a non-finite component of a warp vector that
//    component NaN in every row (0 x inf in its product); the epilogue writes
//    the same NaNs. The gradients of non-finite inputs are not the eager path's.
// Compiled without --use_fast_math: sqrtf and the divisions are IEEE-rounded,
// and denormals are kept.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;                   // point groups (the points held in registers)
constexpr int kLanes = kThreads / kGroups;    // lanes over the streamed points
constexpr int kPer = 4;                       // points a thread holds
constexpr int kChunk = kGroups * kPer;        // points a block holds
constexpr int kTile = 512;                    // streamed points a tile
constexpr int kLoads = kTile / kThreads;      // streamed points a thread loads a tile
constexpr int kTargetBlocks = 8 * 132;        // the backward's blocks: 8 an SM of an H100
constexpr float kSlack = 1e-5f;               // k of the pass test
constexpr float kEps = 1e-5f;                 // the normaliser's epsilon
constexpr float kMinD2 = 1e-24f;              // the distance's clamp
// padding: far from every real point, and from each other, with every square
// and sum still finite
constexpr float kFarSample = 1e18f;
constexpr float kFarVertex = -1e18f;
static_assert(kLanes * kChunk == 2 * kTile, "the forward's partials reuse the goal tiles");
static_assert(kLanes * kChunk * 6 <= 4 * kTile * 4, "the backward's partials reuse its tiles");

struct Pair {
  float dx, dy, dz, d2, d, a;
};

// s - v, d2, d and a as the eager path rounds them on the card: products and
// sums apart, no FMA, and d2 summed as torch's CUDA reduction sums a last axis of
// 3 (two lanes: lane 0 adds elements 0 and 2, then lane 1's element 1 joins it),
// (dx^2 + dz^2) + dy^2; the CPU's sum adds in index order.
__device__ __forceinline__ Pair eager_pair(float sx, float sy, float sz, float vx, float vy,
                                           float vz, float radius) {
  Pair p;
  p.dx = __fsub_rn(sx, vx);
  p.dy = __fsub_rn(sy, vy);
  p.dz = __fsub_rn(sz, vz);
  p.d2 = __fadd_rn(__fadd_rn(__fmul_rn(p.dx, p.dx), __fmul_rn(p.dz, p.dz)),
                   __fmul_rn(p.dy, p.dy));
  p.d = sqrtf(fmaxf(p.d2, kMinD2));
  p.a = fmaxf(__fsub_rn(radius, p.d), 0.f);
  return p;
}

// a point as the pass test reads it from shared memory
__device__ __forceinline__ float4 test_point(float x, float y, float z) {
  const float q = __fmul_rn(fmaf(x, x, fmaf(y, y, __fmul_rn(z, z))), 1.f - kSlack);
  return make_float4(-2.f * x, -2.f * y, -2.f * z, q);
}

// r^2 (1 + k) - |x|^2 (1 - k) for a point held in registers
__device__ __forceinline__ float test_threshold(float x, float y, float z, float r2_slack) {
  const float q = fmaf(x, x, fmaf(y, y, __fmul_rn(z, z)));
  return __fsub_rn(r2_slack, __fmul_rn(q, 1.f - kSlack));
}

__device__ __forceinline__ bool passes(float x, float y, float z, float4 p, float thr) {
  return fmaf(x, p.x, fmaf(y, p.y, fmaf(z, p.z, p.w))) < thr;
}

// gw = g / D and ga = -(g . out) / D of one sample
__device__ __forceinline__ float4 sample_cotangent(const float* __restrict__ grad_out,
                                                   const float* __restrict__ out,
                                                   const float* __restrict__ s_att, size_t n) {
  const float D = __fadd_rn(s_att[n], kEps);
  const float gx = grad_out[3 * n], gy = grad_out[3 * n + 1], gz = grad_out[3 * n + 2];
  const float go = fmaf(gx, out[3 * n], fmaf(gy, out[3 * n + 1], __fmul_rn(gz, out[3 * n + 2])));
  return make_float4(__fdiv_rn(gx, D), __fdiv_rn(gy, D), __fdiv_rn(gz, D), -__fdiv_rn(go, D));
}

// Tile t's vertices of this thread (t * kTile + tid + kThreads i) into registers.
__device__ __forceinline__ void load_vertices(const float* __restrict__ base, int t, int V,
                                              float pad, float (&x)[kLoads][3]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int v = t * kTile + threadIdx.x + kThreads * i;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[i][c] = v < V ? base[3 * (size_t)v + c] : pad;
  }
}

// kGrad false: the forward, out [N, 3] and s_att [N]. kGrad true: the samples'
// gradient into res [N, 3], from grad_out, out_in and s_att_in.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
relu_attention_rows_kernel(const float* __restrict__ samples, const float* __restrict__ goal,
                           const float* __restrict__ warps, const float* __restrict__ grad_out,
                           const float* __restrict__ out_in, const float* __restrict__ s_att_in,
                           float* __restrict__ res, float* __restrict__ s_att, int N, int V,
                           float radius, float r2_slack) {
  __shared__ float4 gt[2][kTile];   // test_point of each vertex; then the lanes' partials
  __shared__ float4 wt[2][kTile];   // (wx, wy, wz, 0)
  const int g = threadIdx.x % kGroups, lane = threadIdx.x / kGroups;
  const int n0 = blockIdx.x * kChunk;
  const int n_tiles = (V + kTile - 1) / kTile;
  int bad = 0;   // bit c < 3: a non-finite component c of a warp; bit 3: a NaN vertex

  float sx[kPer], sy[kPer], sz[kPer], thr[kPer];
  float4 cot[kPer];                 // (gw, ga) of each sample (kGrad)
  float4 acc[kPer];                 // (sum a, sum a w) or (-, d samples)
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int n = n0 + g + kGroups * k;
    const bool in = n < N;
    sx[k] = in ? samples[3 * (size_t)n] : kFarSample;
    sy[k] = in ? samples[3 * (size_t)n + 1] : kFarSample;
    sz[k] = in ? samples[3 * (size_t)n + 2] : kFarSample;
    thr[k] = test_threshold(sx[k], sy[k], sz[k], r2_slack);
    if constexpr (kGrad) cot[k] = in ? sample_cotangent(grad_out, out_in, s_att_in, n)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  auto put = [&](int buf, const float (&gx)[kLoads][3], const float (&wx)[kLoads][3]) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      gt[buf][threadIdx.x + kThreads * i] = test_point(gx[i][0], gx[i][1], gx[i][2]);
      wt[buf][threadIdx.x + kThreads * i] = make_float4(wx[i][0], wx[i][1], wx[i][2], 0.f);
      if constexpr (!kGrad) {
#pragma unroll
        for (int c = 0; c < 3; ++c) bad |= (isfinite(wx[i][c]) ? 0 : 1 << c) |
                                           (isnan(gx[i][c]) ? 8 : 0);
      }
    }
  };

  if (n_tiles > 0) {
    float gnext[kLoads][3], wnext[kLoads][3];
    load_vertices(goal, 0, V, kFarVertex, gnext);
    load_vertices(warps, 0, V, 0.f, wnext);
    put(0, gnext, wnext);
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      const bool more = t + 1 < n_tiles;
      if (more) {
        load_vertices(goal, t + 1, V, kFarVertex, gnext);
        load_vertices(warps, t + 1, V, 0.f, wnext);
      }
      const float4* gc = gt[t & 1];
      const float4* wc = wt[t & 1];
#pragma unroll 2
      for (int j = lane; j < kTile; j += kLanes) {
        const float4 v = gc[j];
        bool hit[kPer];
        bool any = false;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          hit[k] = passes(sx[k], sy[k], sz[k], v, thr[k]);
          any |= hit[k];
        }
        if (!any) continue;
        const float4 w = wc[j];
        const float vx = -0.5f * v.x, vy = -0.5f * v.y, vz = -0.5f * v.z;   // exact
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (!hit[k]) continue;
          const Pair p = eager_pair(sx[k], sy[k], sz[k], vx, vy, vz, radius);
          if (!(p.a > 0.f)) continue;
          if constexpr (kGrad) {
            if (!(p.d2 >= kMinD2)) continue;
            const float c = fmaf(cot[k].x, w.x, fmaf(cot[k].y, w.y, fmaf(cot[k].z, w.z, cot[k].w)));
            const float f = -__fdiv_rn(c, p.d);
            acc[k].y = fmaf(f, p.dx, acc[k].y);
            acc[k].z = fmaf(f, p.dy, acc[k].z);
            acc[k].w = fmaf(f, p.dz, acc[k].w);
          } else {
            acc[k].x = __fadd_rn(acc[k].x, p.a);
            acc[k].y = fmaf(p.a, w.x, acc[k].y);
            acc[k].z = fmaf(p.a, w.y, acc[k].z);
            acc[k].w = fmaf(p.a, w.z, acc[k].w);
          }
        }
      }
      if (more) put((t + 1) & 1, gnext, wnext);
      __syncthreads();
    }
  }
  // the 16 lanes' partials, summed in lane order by one thread a sample
  float4* part = &gt[0][0];
#pragma unroll
  for (int k = 0; k < kPer; ++k) part[lane * kChunk + g + kGroups * k] = acc[k];
  const int flags = __syncthreads_or(bad & 1) | (__syncthreads_or(bad & 2) << 1) |
                    (__syncthreads_or(bad & 4) << 2) | (__syncthreads_or(bad & 8) << 3);
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < kChunk && n < N) {
    float4 sum = part[threadIdx.x];
    for (int l = 1; l < kLanes; ++l) {
      const float4 p = part[l * kChunk + threadIdx.x];
      sum.x = __fadd_rn(sum.x, p.x);
      sum.y = __fadd_rn(sum.y, p.y);
      sum.z = __fadd_rn(sum.z, p.z);
      sum.w = __fadd_rn(sum.w, p.w);
    }
    float* o = res + 3 * (size_t)n;
    if constexpr (kGrad) {
      o[0] = sum.y;
      o[1] = sum.z;
      o[2] = sum.w;
    } else {
      const float nan = __int_as_float(0x7fffffff);
      const float* s = samples + 3 * (size_t)n;
      const bool row_nan = (flags & 8) || isnan(s[0]) || isnan(s[1]) || isnan(s[2]);
      const float D = __fadd_rn(sum.x, kEps);
      o[0] = row_nan || (flags & 1) ? nan : __fdiv_rn(sum.y, D);
      o[1] = row_nan || (flags & 2) ? nan : __fdiv_rn(sum.z, D);
      o[2] = row_nan || (flags & 4) ? nan : __fdiv_rn(sum.w, D);
      s_att[n] = row_nan ? nan : sum.x;
    }
  }
}

// One split of the samples against 64 vertices: the six sums (dL/dw, dL/dv) of
// each vertex into partials [split, V, 6].
__global__ void __launch_bounds__(kThreads)
relu_attention_vertex_kernel(const float* __restrict__ samples, const float* __restrict__ goal,
                             const float* __restrict__ warps, const float* __restrict__ grad_out,
                             const float* __restrict__ out, const float* __restrict__ s_att,
                             float* __restrict__ partials, int N, int V, int per_split,
                             float radius, float r2_slack) {
  // tiles [0, 1]: test_point of each sample; [2, 3]: its (gw, ga); then the partials
  __shared__ float4 smem[4][kTile];
  const int g = threadIdx.x % kGroups, lane = threadIdx.x / kGroups;
  const int v0 = blockIdx.x * kChunk;
  const int n_begin = blockIdx.y * per_split;
  const int n_end = min(N, n_begin + per_split);
  const int n_tiles = (n_end - n_begin + kTile - 1) / kTile;

  float vx[kPer], vy[kPer], vz[kPer], thr[kPer], wx[kPer], wy[kPer], wz[kPer];
  float acc[kPer][6];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int v = v0 + g + kGroups * k;
    const bool in = v < V;
    vx[k] = in ? goal[3 * (size_t)v] : kFarVertex;
    vy[k] = in ? goal[3 * (size_t)v + 1] : kFarVertex;
    vz[k] = in ? goal[3 * (size_t)v + 2] : kFarVertex;
    wx[k] = in ? warps[3 * (size_t)v] : 0.f;
    wy[k] = in ? warps[3 * (size_t)v + 1] : 0.f;
    wz[k] = in ? warps[3 * (size_t)v + 2] : 0.f;
    thr[k] = test_threshold(vx[k], vy[k], vz[k], r2_slack);
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[k][c] = 0.f;
  }

  // tile t's samples of this thread into registers: the test point and (gw, ga)
  auto load = [&](int t, float4 (&pt)[kLoads], float4 (&ct)[kLoads]) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int n = n_begin + t * kTile + threadIdx.x + kThreads * i;
      if (n < n_end) {
        const size_t m = n;
        pt[i] = test_point(samples[3 * m], samples[3 * m + 1], samples[3 * m + 2]);
        ct[i] = sample_cotangent(grad_out, out, s_att, m);
      } else {
        pt[i] = test_point(kFarSample, kFarSample, kFarSample);
        ct[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto put = [&](int buf, const float4 (&pt)[kLoads], const float4 (&ct)[kLoads]) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      smem[buf][threadIdx.x + kThreads * i] = pt[i];
      smem[2 + buf][threadIdx.x + kThreads * i] = ct[i];
    }
  };

  if (n_tiles > 0) {
    float4 pnext[kLoads], cnext[kLoads];
    load(0, pnext, cnext);
    put(0, pnext, cnext);
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      const bool more = t + 1 < n_tiles;
      if (more) load(t + 1, pnext, cnext);
      const float4* pc = smem[t & 1];
      const float4* cc = smem[2 + (t & 1)];
#pragma unroll 2
      for (int j = lane; j < kTile; j += kLanes) {
        const float4 s = pc[j];
        bool hit[kPer];
        bool any = false;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          hit[k] = passes(vx[k], vy[k], vz[k], s, thr[k]);
          any |= hit[k];
        }
        if (!any) continue;
        const float4 ct = cc[j];
        const float sx = -0.5f * s.x, sy = -0.5f * s.y, sz = -0.5f * s.z;   // exact
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (!hit[k]) continue;
          const Pair p = eager_pair(sx, sy, sz, vx[k], vy[k], vz[k], radius);
          if (!(p.a > 0.f)) continue;
          acc[k][0] = fmaf(p.a, ct.x, acc[k][0]);
          acc[k][1] = fmaf(p.a, ct.y, acc[k][1]);
          acc[k][2] = fmaf(p.a, ct.z, acc[k][2]);
          if (!(p.d2 >= kMinD2)) continue;
          const float c = fmaf(ct.x, wx[k], fmaf(ct.y, wy[k], fmaf(ct.z, wz[k], ct.w)));
          const float f = __fdiv_rn(c, p.d);
          acc[k][3] = fmaf(f, p.dx, acc[k][3]);
          acc[k][4] = fmaf(f, p.dy, acc[k][4]);
          acc[k][5] = fmaf(f, p.dz, acc[k][5]);
        }
      }
      if (more) put((t + 1) & 1, pnext, cnext);
      __syncthreads();
    }
  }
  // the 16 lanes' partials of each vertex, summed in lane order
  float* part = reinterpret_cast<float*>(&smem[0][0]);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
#pragma unroll
    for (int c = 0; c < 6; ++c) part[(lane * kChunk + g + kGroups * k) * 6 + c] = acc[k][c];
  __syncthreads();
  for (int i = threadIdx.x; i < kChunk * 6; i += kThreads) {
    const int vtx = i / 6, c = i % 6;
    if (v0 + vtx >= V) continue;
    float sum = part[vtx * 6 + c];
    for (int l = 1; l < kLanes; ++l) sum = __fadd_rn(sum, part[(l * kChunk + vtx) * 6 + c]);
    partials[((size_t)blockIdx.y * V + v0 + vtx) * 6 + c] = sum;
  }
}

// The splits' sums of each vertex, in split order: dL/dw into grad_warps and
// dL/dv into grad_goal (either may be null).
__global__ void relu_attention_reduce_kernel(const float* __restrict__ partials,
                                             float* __restrict__ grad_goal,
                                             float* __restrict__ grad_warps, int V, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= V * 6) return;
  float sum = partials[i];
  for (int s = 1; s < splits; ++s) sum = __fadd_rn(sum, partials[(size_t)s * V * 6 + i]);
  const int v = i / 6, c = i % 6;
  if (c < 3) {
    if (grad_warps) grad_warps[3 * v + c] = sum;
  } else if (grad_goal) {
    grad_goal[3 * v + c - 3] = sum;
  }
}

// r^2 (1 + k) in double, then float; no pair passes where r <= 0 (a = 0 there)
float r2_with_slack(float radius) {
  const double r = radius;
  return radius > 0.f ? (float)(r * r * (1.0 + (double)kSlack)) : -INFINITY;
}

// samples a split of the backward, a whole number of tiles
int per_split(int N, int V) {
  const int vertex_tiles = (V + kChunk - 1) / kChunk;
  const int want = (kTargetBlocks + vertex_tiles - 1) / vertex_tiles;
  const int tiles = (N + kTile - 1) / kTile;
  return ((tiles + want - 1) / want) * kTile;
}

}  // namespace

extern "C" {

// The backward's scratch: floats of partials [splits, V, 6] (0 where N or V is 0).
long long relu_attention_workspace_floats(int N, int V) {
  if (N <= 0 || V <= 0) return 0;
  const int splits = (N + per_split(N, V) - 1) / per_split(N, V);
  return (long long)splits * V * 6;
}

// samples [N, 3], goal [V, 3], warps [V, 3] -> out [N, 3], s_att [N] (sum_v a):
// float32, contiguous, on one device; launched on `stream`. Returns the first CUDA
// error (0 on success).
int relu_attention_forward(const float* samples, const float* goal, const float* warps,
                           float* out, float* s_att, int N, int V, float radius,
                           cudaStream_t stream) {
  if (N < 0 || V < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  relu_attention_rows_kernel<false><<<(N + kChunk - 1) / kChunk, kThreads, 0, stream>>>(
      samples, goal, warps, nullptr, nullptr, nullptr, out, s_att, N, V, radius,
      r2_with_slack(radius));
  return (int)cudaGetLastError();
}

// The gradients given grad_out [N, 3] and the forward's out and s_att: grad_samples
// [N, 3], grad_goal [V, 3], grad_warps [V, 3], each null where not wanted;
// workspace: relu_attention_workspace_floats(N, V) floats, needed where grad_goal
// or grad_warps is wanted. Returns the first CUDA error (0 on success).
int relu_attention_backward(const float* samples, const float* goal, const float* warps,
                            const float* grad_out, const float* out, const float* s_att,
                            float* grad_samples, float* grad_goal, float* grad_warps,
                            float* workspace, int N, int V, float radius, cudaStream_t stream) {
  if (N < 0 || V < 0) return (int)cudaErrorInvalidValue;
  const float r2_slack = r2_with_slack(radius);
  cudaError_t err = cudaSuccess;
  if ((grad_goal || grad_warps) && V > 0) {
    if (N == 0) {
      if (grad_goal) err = cudaMemsetAsync(grad_goal, 0, sizeof(float) * 3 * V, stream);
      if (err == cudaSuccess && grad_warps)
        err = cudaMemsetAsync(grad_warps, 0, sizeof(float) * 3 * V, stream);
      if (err != cudaSuccess) return (int)err;
    } else {
      const int split = per_split(N, V);
      const int splits = (N + split - 1) / split;
      const dim3 grid((V + kChunk - 1) / kChunk, splits);
      relu_attention_vertex_kernel<<<grid, kThreads, 0, stream>>>(
          samples, goal, warps, grad_out, out, s_att, workspace, N, V, split, radius, r2_slack);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      relu_attention_reduce_kernel<<<(V * 6 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          workspace, grad_goal, grad_warps, V, splits);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (grad_samples && N > 0) {
    relu_attention_rows_kernel<true><<<(N + kChunk - 1) / kChunk, kThreads, 0, stream>>>(
        samples, goal, warps, grad_out, out, s_att, grad_samples, nullptr, N, V, radius,
        r2_slack);
    err = cudaGetLastError();
  }
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
