// The dynamic families' vertex-attention warp on Hopper (sm_90a): a grid-wide
// max pass, then one fused pass over the vertices.
//
// Replaces no TPU kernel. The JAX package computes this attention outside any
// kernel, as a lax.scan over vertex chunks (smpl_nerf_tpu/ops/vertex_attention.py,
// vertex_attention_warp); the port's eager version of that scan launched ~24
// operations a chunk and sent every (sample, vertex) pair to device memory and
// back several times, which made it ~86 % of a dummy_dynamic training step at
// SMPL's 6,890 vertices. Plain version: ops/vertex_attention.py,
// vertex_attention_eager.
//
//   d2    = |s - v|^2                      s: a sample [R, S, 3], v: a vertex of
//   att   = relu(r - sqrt(d2)) * T            its ray's goal mesh [R, V, 3]
//   M     = max att over the WHOLE batch    (and 0)
//   e     = exp(att - M), e0 = exp(-M)
//   warp  = sum_v (e - e0) w_v / max(sum_v e, 1e-30)    w: [R, V, 3]
//
// (e - e0) / sum e is the modified softmax's weight: a vertex whose sphere of
// radius r does not hold the sample has att = 0, e = e0 and weight exactly 0.
//
// What bounds it on the H100: the FP32 pipe. At a 2048-ray step of 64 samples
// over 6,890 vertices the inputs are 2 x 169 MB ([R, V, 3] twice, ~0.1 ms at
// 3.35 TB/s even read twice), while the published math once a pair is 15
// FP32-pipe and 2 special-function instructions over 903 M pairs: 0.41 ms on
// the FP32 pipe and 0.43 ms on the special-function pipe (132 SMs, 128 and 16
// results a clock, 1,980 MHz; port_bench/counts_dynamic.py). This design does
// ~9 FP32 instructions a pair in launch 1 and ~4 in launch 2, and the square
// root and exp only for pairs inside a sphere (a few per cent), so its floor
// is ~0.35 ms of FP32 issue; loop, shared-memory and branch overhead come on
// top of that.
//
// Design.
// 1. The global max. M must be the max over the whole batch: a per-ray or
//    per-sample max gives another result wherever exp underflows (at T = 1e4
//    a logit is a distance times 1e4). att does not increase with d2, so
//    launch 1 takes the min of d2 alone (no sqrt, no exp): each block reduces
//    its ray's min and does one atomicMin on the bits of that non-negative
//    float, which orders as an int; a min is the same in any order, so M is
//    deterministic. The word is set on the stream before launch 1 and read by
//    launch 2 from device memory: no host sync. d2 is computed as the eager
//    path computes it ((dx^2 + dy^2) + dz^2, every product and sum rounded,
//    no FMA), so M is the eager path's M bit for bit: exp(att - M) near the
//    underflow edge then agrees too.
// 2. The fused sum. Launch 2 streams the same tiles and, per pair, tests
//    t = |v|^2 (1 - k) - 2 s.v against r^2 (1 + k) - |s|^2 (1 - k), k = 1e-5:
//    three FMAs a pair. k covers the rounding of the FMA chain (a few ulps of
//    |v|^2 + 2|s||v|, far below k (|v|^2 + |s|^2)), so every pair with
//    att > 0 passes; a pair that passes but lies outside gets att = 0 from
//    the relu and adds exactly 0. Only a passing pair takes d2 the eager
//    way, the sqrt and exp(att - M), then adds (e - e0) to the sample's
//    normaliser and (e - e0) w_v to its numerator. Every other pair has
//    e = e0: its weight is exactly 0 and its share of the normaliser is e0,
//    which the epilogue adds as V e0 (sum_v e = sum_v (e - e0) + V e0). No
//    pair is left out; the eager path's e0 sum_v w_v, subtracted after the
//    sums, becomes a per-pair 0, which also spares it that cancellation.
// 3. Occupancy. A block owns one ray and 64 of its samples at a time (256
//    threads: 16 sample groups x 16 vertex lanes; thread t holds samples
//    t % 16 + 16 k, k < 4, and takes vertices t / 16 + 16 j of each tile).
//    The vertex axis is split across warps instead of giving a thread a whole
//    mesh: a ray's mesh is 6,890 x 24 B = 165 KB, which would leave one block
//    an SM. Tiles of 512 vertices (8 KB of goal, 8 KB of warps) are double
//    buffered in shared memory, the next tile's loads in registers while the
//    current one is computed, one barrier a tile: several blocks per SM.
//    Shared memory holds a vertex as a float4 (-2x, -2y, -2z, |v|^2 (1 - k)):
//    a warp reads two vertices per load, each a broadcast. Samples of a ray
//    lie in order along it, so the few that fall in one vertex's sphere sit
//    in neighbouring threads at the same k, and a warp branches for one k.
// 4. Determinism. Each thread sums its vertices in order; the 16 lanes'
//    partials are combined through shared memory in lane order; no float
//    atomics. Two runs of a step give the same bits.
// 5. Non-finite inputs. A NaN sample or vertex makes the eager path's M NaN
//    and every warp NaN: launch 1 then stores -1, launch 2 reads M = NaN. A
//    non-finite component of a warp vector makes that component of the eager
//    path's warps NaN on its ray (0 x inf and 0 x NaN in its product), and the
//    epilogue writes that component of the ray NaN.
// Compiled without --use_fast_math: sqrtf and expf are the IEEE-rounded and
// the 2-ulp versions PyTorch's own kernels use, and denormals are kept.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 16;                   // sample groups
constexpr int kLanes = kThreads / kGroups;    // vertex lanes
constexpr int kPer = 4;                       // samples a thread holds
constexpr int kChunk = kGroups * kPer;        // samples a pass over the vertices
constexpr int kTile = 512;                    // vertices a tile
constexpr int kLoads = kTile / kThreads;      // vertices a thread loads a tile
constexpr float kSlack = 1e-5f;               // k of the pass test
// padding: far from every real point, and from each other, with every square
// and sum still finite
constexpr float kFarSample = 1e18f;
constexpr float kFarVertex = -1e18f;
constexpr int kNoPair = 0x7f7f7f7f;           // the word's start: 3.4e38 as a float
static_assert(kLanes * kChunk == 2 * kTile, "the lanes' partials reuse the goal tiles");

// |s - v|^2 as the eager path rounds it: products and sums apart, no FMA
__device__ __forceinline__ float eager_d2(float sx, float sy, float sz, float vx, float vy,
                                          float vz) {
  const float dx = __fsub_rn(sx, vx), dy = __fsub_rn(sy, vy), dz = __fsub_rn(sz, vz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// relu(r - sqrt(max(d2, 1e-24))) * T, as the eager path rounds it
__device__ __forceinline__ float logit(float d2, float radius, float temperature) {
  const float a = __fsub_rn(radius, sqrtf(fmaxf(d2, 1e-24f)));
  return __fmul_rn(fmaxf(a, 0.f), temperature);
}

__device__ __forceinline__ bool is_nan3(float x, float y, float z) {
  return isnan(x) || isnan(y) || isnan(z);
}

// The chunk's samples of this thread: s0 + g + 16 k; past S, far away.
__device__ __forceinline__ void load_samples(const float* __restrict__ sp, int s0, int g, int S,
                                             float (&sx)[kPer], float (&sy)[kPer],
                                             float (&sz)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int s = s0 + g + kGroups * k;
    sx[k] = s < S ? sp[3 * s] : kFarSample;
    sy[k] = s < S ? sp[3 * s + 1] : kFarSample;
    sz[k] = s < S ? sp[3 * s + 2] : kFarSample;
  }
}

// Tile t's vertices of this thread (t * kTile + tid + kThreads i) into registers.
__device__ __forceinline__ void load_vertices(const float* __restrict__ base, int t, int V,
                                              float (&x)[kLoads][3]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int v = t * kTile + threadIdx.x + kThreads * i;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[i][c] = v < V ? base[3 * (size_t)v + c] : kFarVertex;
  }
}

__global__ void __launch_bounds__(kThreads)
vertex_attention_max_kernel(const float* __restrict__ samples, const float* __restrict__ goal,
                            int* __restrict__ word, int S, int V) {
  __shared__ float4 tile[2][kTile];
  __shared__ float warp_min[kThreads / 32];
  const int ray = blockIdx.x;
  const int g = threadIdx.x % kGroups, lane = threadIdx.x / kGroups;
  const float* sp = samples + (size_t)ray * S * 3;
  const float* gp = goal + (size_t)ray * V * 3;
  const int n_tiles = (V + kTile - 1) / kTile;
  float best = __int_as_float(kNoPair);
  bool bad = false;
  for (int s0 = 0; s0 < S && n_tiles > 0; s0 += kChunk) {
    float sx[kPer], sy[kPer], sz[kPer];
    load_samples(sp, s0, g, S, sx, sy, sz);
#pragma unroll
    for (int k = 0; k < kPer; ++k) bad |= is_nan3(sx[k], sy[k], sz[k]);
    float ahead[kLoads][3];
    load_vertices(gp, 0, V, ahead);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      bad |= is_nan3(ahead[i][0], ahead[i][1], ahead[i][2]);
      tile[0][threadIdx.x + kThreads * i] = make_float4(ahead[i][0], ahead[i][1], ahead[i][2], 0.f);
    }
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      const bool more = t + 1 < n_tiles;
      if (more) load_vertices(gp, t + 1, V, ahead);
      const float4* cur = tile[t & 1];
#pragma unroll 4
      for (int j = lane; j < kTile; j += kLanes) {
        const float4 v = cur[j];
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          best = fminf(best, eager_d2(sx[k], sy[k], sz[k], v.x, v.y, v.z));
      }
      if (more) {
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          bad |= is_nan3(ahead[i][0], ahead[i][1], ahead[i][2]);
          tile[(t + 1) & 1][threadIdx.x + kThreads * i] =
              make_float4(ahead[i][0], ahead[i][1], ahead[i][2], 0.f);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = fminf(best, __shfl_xor_sync(0xffffffffu, best, o));
  if (threadIdx.x % 32 == 0) warp_min[threadIdx.x / 32] = best;
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) best = fminf(best, warp_min[w]);
    // best >= 0, so its bits order as an int; -1 (a NaN input) is below all
    atomicMin(word, bad ? -1 : __float_as_int(best));
  }
}

__global__ void __launch_bounds__(kThreads)
vertex_attention_sum_kernel(const float* __restrict__ samples, const float* __restrict__ goal,
                            const float* __restrict__ warps, const int* __restrict__ word,
                            float* __restrict__ out, int S, int V, float radius,
                            float temperature, float r2_slack) {
  __shared__ float4 gt[2][kTile];   // (-2x, -2y, -2z, |v|^2 (1 - k)); then the lanes' partials
  __shared__ float4 wt[2][kTile];   // (wx, wy, wz, 0)
  const int ray = blockIdx.x;
  const int g = threadIdx.x % kGroups, lane = threadIdx.x / kGroups;
  const float* sp = samples + (size_t)ray * S * 3;
  const float* gp = goal + (size_t)ray * V * 3;
  const float* wp = warps + (size_t)ray * V * 3;
  const int n_tiles = (V + kTile - 1) / kTile;

  const int bits = *word;
  const float M = bits < 0 ? __int_as_float(0x7fffffff)
                           : fmaxf(logit(__int_as_float(bits), radius, temperature), 0.f);
  const float e0 = expf(-M);
  const float base = __fmul_rn((float)V, e0);   // the normaliser's share of the pairs with e = e0
  int bad = 0;                                  // bit c: a non-finite component c of a warp

  auto put = [&](int buf, const float (&gx)[kLoads][3], const float (&wx)[kLoads][3]) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const float x = gx[i][0], y = gx[i][1], z = gx[i][2];
      const float q = __fmul_rn(fmaf(x, x, fmaf(y, y, __fmul_rn(z, z))), 1.f - kSlack);
      gt[buf][threadIdx.x + kThreads * i] = make_float4(-2.f * x, -2.f * y, -2.f * z, q);
      wt[buf][threadIdx.x + kThreads * i] = make_float4(wx[i][0], wx[i][1], wx[i][2], 0.f);
#pragma unroll
      for (int c = 0; c < 3; ++c) bad |= isfinite(wx[i][c]) ? 0 : 1 << c;
    }
  };

  for (int s0 = 0; s0 < S; s0 += kChunk) {
    float sx[kPer], sy[kPer], sz[kPer], thr[kPer];
    float den[kPer], nx[kPer], ny[kPer], nz[kPer];
    load_samples(sp, s0, g, S, sx, sy, sz);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float s2 = fmaf(sx[k], sx[k], fmaf(sy[k], sy[k], __fmul_rn(sz[k], sz[k])));
      thr[k] = __fsub_rn(r2_slack, __fmul_rn(s2, 1.f - kSlack));
      den[k] = nx[k] = ny[k] = nz[k] = 0.f;
    }
    if (n_tiles > 0) {
      float gnext[kLoads][3], wnext[kLoads][3];
      load_vertices(gp, 0, V, gnext);
      load_vertices(wp, 0, V, wnext);
      put(0, gnext, wnext);
      __syncthreads();
      for (int t = 0; t < n_tiles; ++t) {
        const bool more = t + 1 < n_tiles;
        if (more) {
          load_vertices(gp, t + 1, V, gnext);
          load_vertices(wp, t + 1, V, wnext);
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
            hit[k] = fmaf(sx[k], v.x, fmaf(sy[k], v.y, fmaf(sz[k], v.z, v.w))) < thr[k];
            any |= hit[k];
          }
          if (!any) continue;
          const float4 w = wc[j];
          const float vx = -0.5f * v.x, vy = -0.5f * v.y, vz = -0.5f * v.z;   // exact
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            if (!hit[k]) continue;
            const float att = logit(eager_d2(sx[k], sy[k], sz[k], vx, vy, vz), radius,
                                    temperature);
            const float de = __fsub_rn(expf(__fsub_rn(att, M)), e0);
            den[k] = __fadd_rn(den[k], de);
            nx[k] = fmaf(de, w.x, nx[k]);
            ny[k] = fmaf(de, w.y, ny[k]);
            nz[k] = fmaf(de, w.z, nz[k]);
          }
        }
        if (more) put((t + 1) & 1, gnext, wnext);
        __syncthreads();
      }
    }
    // the 16 lanes' partials, summed in lane order by one thread a sample
    float4* part = &gt[0][0];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      part[lane * kChunk + g + kGroups * k] = make_float4(den[k], nx[k], ny[k], nz[k]);
    const bool bad_x = __syncthreads_or(bad & 1), bad_y = __syncthreads_or(bad & 2),
               bad_z = __syncthreads_or(bad & 4);
    const int s = s0 + threadIdx.x;
    if (threadIdx.x < kChunk && s < S) {
      float4 acc = part[threadIdx.x];
      for (int l = 1; l < kLanes; ++l) {
        const float4 p = part[l * kChunk + threadIdx.x];
        acc.x = __fadd_rn(acc.x, p.x);
        acc.y = __fadd_rn(acc.y, p.y);
        acc.z = __fadd_rn(acc.z, p.z);
        acc.w = __fadd_rn(acc.w, p.w);
      }
      float d = __fadd_rn(base, acc.x);
      d = d < 1e-30f ? 1e-30f : d;              // the eager clamp; a NaN stays NaN
      const float nan = __int_as_float(0x7fffffff);
      float* o = out + ((size_t)ray * S + s) * 3;
      o[0] = bad_x ? nan : __fdiv_rn(acc.y, d);
      o[1] = bad_y ? nan : __fdiv_rn(acc.z, d);
      o[2] = bad_z ? nan : __fdiv_rn(acc.w, d);
    }
    __syncthreads();   // the partials are read before the next chunk's tile 0 lands on them
  }
}

}  // namespace

extern "C" {

// samples [R, S, 3], goal [R, V, 3], warps [R, V, 3], out [R, S, 3]: float32,
// contiguous, on one device; word: one int32 of scratch on that device. Sets
// the word, then launches the max pass and the sum pass on `stream`. Returns
// the first CUDA error (0 on success).
int vertex_attention_launch(const float* samples, const float* goal, const float* warps,
                            float* out, int* word, int R, int S, int V, float radius,
                            float temperature, cudaStream_t stream) {
  if (R <= 0 || S <= 0 || V < 0) return (int)cudaErrorInvalidValue;
  // r^2 (1 + k) in double, then float; no pair passes where r <= 0 (att = 0 there)
  const double r = radius;
  const float r2_slack = radius > 0.f ? (float)(r * r * (1.0 + (double)kSlack)) : -INFINITY;
  cudaError_t err = cudaMemsetAsync(word, 0x7f, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  vertex_attention_max_kernel<<<R, kThreads, 0, stream>>>(samples, goal, word, S, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vertex_attention_sum_kernel<<<R, kThreads, 0, stream>>>(samples, goal, warps, word, out, S, V,
                                                          radius, temperature, r2_slack);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
