// Inverse-CDF fine sampling on Hopper (sm_90a): one warp per ray, the cdf
// built from registers and inverted as a merge.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/sample_pdf_pallas.py:sample_pdf_fused
// (body `_kernel`). Plain version: smpl_nerf_tpu_torch/core/sampling.py:sample_pdf.
//
//   pdf = (w + 1e-5) / sum(w + 1e-5)            w: [R, K-1]
//   cdf = [0, cumsum(pdf)]                      [R, K]
//   u_f = f * u_step, f = 0..F-1                (u_step = float32(1/(F-1)))
//   inds = #{k : cdf_k <= u}                    (searchsorted side='right')
//   below = max(inds-1, 0), above = min(inds, K-1)
//   out = bins[below] + (u - cdf[below]) / denom * (bins[above] - bins[below]),
//   denom = cdf[above] - cdf[below], replaced by 1 when < 1e-5
//
// What bounds it on the H100: launch latency. Per ray it reads (2K-1) floats
// and writes F floats (~1 KB at K=63, F=128); at the main path's 2048-ray
// batches the whole call moves ~1 MB, 0.6 us at 3.35 TB/s, below the few us
// a launch takes. So the design cuts the serial steps of one ray's warp.
//
// Design. A warp owns a ray; blocks of four rays, so R=2048 gives 512 blocks,
// about four on each of the 132 SMs (one and two rays per block measured no
// faster).
// 1. Lane l owns the contiguous run [l*C, l*C+C) of the K-1 weights (C the
//    least power of two with 32*C >= K-1: two at K=63) and reads it once
//    into registers. The total is a shuffle sum, lane 0's copy broadcast so
//    that every lane divides by the same value.
// 2. The scan: each lane runs its own entries sequentially (s += pdf_i), a
//    shuffle scan of the lanes' totals gives each lane its offset, and entry
//    i is offset + s_i. That cdf is not non-decreasing by construction: the
//    offset of lane l and lane l-1's last entry are two roundings of sums
//    taken in different orders, and with empty bins a step (~1e-5 / total)
//    is below an ulp of the running sum. So every entry is then raised to
//    the largest last entry of the lanes before it (a shuffle max-scan: max
//    is exact). Within a lane the entries cannot fall (offset + s_i rounds
//    monotonically in s_i, and s_i only grows); across lanes every entry is
//    at least the previous lane's last. The cdf is non-decreasing whatever
//    the rounding, which is what makes the inversion below exact.
// 3. The inversion is a merge: u is sorted by construction, and lane l owns
//    the contiguous run of samples [l*P, l*P+P) (P = ceil(F/32), rounded up to
//    a multiple of 4 when F is, so that a run starts 16-byte aligned). It
//    binary-searches its first sample's count over the cdf in shared memory
//    (upper bound: the first k with cdf_k > u), then walks forward sample by
//    sample: O(log K + K/32 + F/32) per lane instead of the count's O(K*F/32).
//    On a non-decreasing cdf the upper bound is exactly #{k : cdf_k <= u},
//    ties included.
// 4. The lerp rounds as the plain version (__fmul_rn / __fadd_rn; the
//    compiler may not contract it into an FMA), and stores go out as one
//    float4 per four samples where F is a multiple of 4: a warp writes a
//    ray's 512 B row (F=128) in one coalesced instruction.
// The bins go to shared memory with coalesced loads. No block barrier: a
// warp past the last ray leaves, the others sync only themselves.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sample_at(const float* cdf, const float* bin, int K, int inds,
                                           float u) {
  const int below = max(inds - 1, 0);
  const int above = min(inds, K - 1);
  const float c0 = cdf[below], c1 = cdf[above];
  const float b0 = bin[below], b1 = bin[above];
  float denom = __fsub_rn(c1, c0);
  if (denom < 1e-5f) denom = 1.f;
  const float t = __fdiv_rn(__fsub_rn(u, c0), denom);
  // separate rounding of the product and the sum, as the plain version does
  return __fadd_rn(b0, __fmul_rn(t, __fsub_rn(b1, b0)));
}

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sample_pdf_kernel(const float* __restrict__ bins, const float* __restrict__ weights,
                  float* __restrict__ out, int R, int K, int F, int per_lane, float u_step) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // whole warp leaves together; no block-wide barrier below

  float* cdf = smem + warp * 2 * K;
  float* bin = cdf + K;
  const int n = K - 1;
  const float* w = weights + (size_t)ray * n;
  const float* b = bins + (size_t)ray * K;
  for (int k = lane; k < K; k += 32) bin[k] = b[k];

  // 1. this lane's run of weights, read once
  const int first = lane * C;
  float v[C];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    v[i] = first + i < n ? __fadd_rn(w[first + i], 1e-5f) : 0.f;
    part = __fadd_rn(part, v[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  const float total = __shfl_sync(kFull, part, 0);

  // 2. the lane's entries in order, then its offset among the lanes
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (first + i < n) s = __fadd_rn(s, __fdiv_rn(v[i], total));
    v[i] = s;
  }
  float incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  float offset = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) offset = 0.f;
  // ... raised to the largest last entry of the lanes before it
  float top = __fadd_rn(offset, s);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, top, o);
    if (lane >= o) top = fmaxf(top, t);
  }
  float floor_below = __shfl_up_sync(kFull, top, 1);
  if (lane == 0) {
    floor_below = 0.f;
    cdf[0] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (first + i < n) cdf[first + i + 1] = fmaxf(__fadd_rn(offset, v[i]), floor_below);
  __syncwarp();

  // 3. the merge: search the run's first sample, walk the rest
  const int f0 = lane * per_lane;
  if (f0 >= F) return;
  const int f1 = min(f0 + per_lane, F);
  int inds;
  {
    const float u = __fmul_rn((float)f0, u_step);
    int lo = 0, hi = K;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= u) lo = mid + 1;
      else hi = mid;
    }
    inds = lo;
  }
  float* o_row = out + (size_t)ray * F;
  const bool vec4 = (F & 3) == 0;   // then f0 and f1 are multiples of 4
  for (int f = f0; f < f1; f += 4) {
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (f + j < f1) {
        const float u = __fmul_rn((float)(f + j), u_step);
        while (inds < K && cdf[inds] <= u) ++inds;
        r[j] = sample_at(cdf, bin, K, inds, u);
      }
    }
    if (vec4) {
      *reinterpret_cast<float4*>(o_row + f) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (f + j < f1) o_row[f + j] = r[j];
    }
  }
}

template <int C>
cudaError_t launch(const float* bins, const float* weights, float* out, int R, int K, int F,
                   cudaStream_t stream) {
  int per_lane = (F + 31) / 32;
  if ((F & 3) == 0) per_lane = (per_lane + 3) & ~3;
  // u_step = float32(1 / (F-1)), one correctly rounded float32 division, as
  // the plain version's `fine_u_step`
  const float u_step = 1.0f / (float)(F > 1 ? F - 1 : 1);
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)kWarpsPerBlock * 2 * K * sizeof(float);
  sample_pdf_kernel<C><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(bins, weights, out, R, K,
                                                                       F, per_lane, u_step);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bins [R, K], weights [R, K-1], out [R, F]: float32, contiguous, on one
// device; 2 <= K <= 1025 (the wrapper's MAX_BINS is lower). Returns the CUDA
// error of the launch (0 on success).
int sample_pdf_launch(const float* bins, const float* weights, float* out, int R, int K, int F,
                      cudaStream_t stream) {
  const int n = K - 1;
  cudaError_t err;
  if (n <= 32) err = launch<1>(bins, weights, out, R, K, F, stream);
  else if (n <= 64) err = launch<2>(bins, weights, out, R, K, F, stream);
  else if (n <= 128) err = launch<4>(bins, weights, out, R, K, F, stream);
  else if (n <= 256) err = launch<8>(bins, weights, out, R, K, F, stream);
  else if (n <= 512) err = launch<16>(bins, weights, out, R, K, F, stream);
  else if (n <= 1024) err = launch<32>(bins, weights, out, R, K, F, stream);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
