// The sin/cos encoding argument shared by the kernels that encode raw
// coordinates themselves: expert_tiles.cu (kernel E) and, through
// render_net.cuh, the producer of fused_mlp_v2_fwd.cu (kernel B) and
// fused_mlp_v2_bwd.cu (kernel C), whose dX also reads it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_mlp {

constexpr float kHalfPi = 1.57079637050628662109375f;  // float32(pi / 2)

// The encoding argument of column c (< 6 * n_freqs) for the raw coordinates
// (x0, x1, x2): x * 2^k for the sin blocks, + pi/2 for the cos blocks
// (cos(t) = sin(t + pi/2)), in the block order [sin f0 | cos f0 | sin f1 | ...].
// x * 2^k is exact, as the JAX dot with a one-hot M is. The coordinate is
// picked by value, so a caller's coordinates can stay in registers.
__device__ __forceinline__ float encoding_arg(float x0, float x1, float x2, int c) {
  const int k = c / 6;
  const int within = c - 6 * k;
  const int j = within % 3;
  float t = __fmul_rn(j == 0 ? x0 : (j == 1 ? x1 : x2), (float)(1 << k));
  if (within >= 3) t = __fadd_rn(t, kHalfPi);
  return t;
}

__device__ __forceinline__ float encoding_arg(const float* coords, int c) {
  return encoding_arg(coords[0], coords[1], coords[2], c);
}

}  // namespace fused_mlp
