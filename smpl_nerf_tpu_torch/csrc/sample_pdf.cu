// Inverse-CDF fine sampling on Hopper (sm_90a): one warp per ray.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/sample_pdf_pallas.py:sample_pdf_fused
// (body `_kernel`). Plain version: smpl_nerf_tpu_torch/core/sampling.py:sample_pdf.
//
//   pdf = (w + 1e-5) / sum(w + 1e-5)            w: [R, K-1]
//   cdf = [0, cumsum(pdf)]                      [R, K]
//   u_f = f * u_step, f = 0..F-1                (u_step = float32(1/(F-1)), from the wrapper)
//   inds = #{k : cdf_k <= u}                    (searchsorted side='right')
//   below = max(inds-1, 0), above = min(inds, K-1)
//   out = bins[below] + (u - cdf[below]) / denom * (bins[above] - bins[below]),
//   denom = cdf[above] - cdf[below], replaced by 1 when < 1e-5
//
// What bounds it on the H100: memory and launch latency. Per ray it reads
// (2K-1) floats and writes F floats (~1 KB at K=63, F=128); the arithmetic is
// a few hundred operations per ray. At the slice's 2048-ray batches the whole
// call moves ~2 MB, under a microsecond at 3.35 TB/s, so the launch dominates.
//
// Design: a warp owns a ray. It sums the weights with shuffles, scans the pdf
// into cdf[K] in shared memory with a warp shuffle scan, then each lane takes
// the fine samples f = lane, lane+32, ... and counts `cdf_k <= u` over the K
// shared entries (all lanes read the same entry: a broadcast, no bank
// conflict). The count, like the Pallas kernel's, needs no sorted cdf. Stores
// are coalesced: consecutive lanes write consecutive samples of one ray. The
// ragged last block is masked by the ray index; nothing is padded.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void sample_pdf_kernel(const float* __restrict__ bins,
                                  const float* __restrict__ weights,
                                  float* __restrict__ out,
                                  int R, int K, int F, float u_step) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // whole warp leaves together; no block-wide barrier below

  float* cdf = smem + warp * 2 * K;
  float* bin = cdf + K;
  const float* w = weights + (size_t)ray * (K - 1);
  const float* b = bins + (size_t)ray * K;

  for (int k = lane; k < K; k += 32) bin[k] = b[k];

  float part = 0.f;
  for (int k = lane; k < K - 1; k += 32) part += w[k] + 1e-5f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  const float total = part;

  if (lane == 0) cdf[0] = 0.f;
  float carry = 0.f;
  for (int base = 0; base < K - 1; base += 32) {
    const int k = base + lane;
    float v = (k < K - 1) ? (w[k] + 1e-5f) / total : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += n;
    }
    v += carry;
    if (k < K - 1) cdf[k + 1] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
  __syncwarp();

  float* o_row = out + (size_t)ray * F;
  for (int f = lane; f < F; f += 32) {
    const float u = __fmul_rn((float)f, u_step);
    int inds = 0;
    for (int k = 0; k < K; ++k) inds += (cdf[k] <= u) ? 1 : 0;
    const int below = max(inds - 1, 0);
    const int above = min(inds, K - 1);
    const float c0 = cdf[below], c1 = cdf[above];
    const float b0 = bin[below], b1 = bin[above];
    float denom = __fsub_rn(c1, c0);
    if (denom < 1e-5f) denom = 1.f;
    const float t = __fdiv_rn(__fsub_rn(u, c0), denom);
    // separate rounding of the product and the sum, as the plain version does
    o_row[f] = __fadd_rn(b0, __fmul_rn(t, __fsub_rn(b1, b0)));
  }
}

}  // namespace

extern "C" {

// bins [R, K], weights [R, K-1], out [R, F]: float32, contiguous, on one device.
// Returns cudaGetLastError() after the launch (0 on success).
int sample_pdf_launch(const float* bins, const float* weights, float* out,
                      int R, int K, int F, float u_step, cudaStream_t stream) {
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)kWarpsPerBlock * 2 * K * sizeof(float);
  sample_pdf_kernel<<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      bins, weights, out, R, K, F, u_step);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
