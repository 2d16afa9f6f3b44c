// Fused sorted-tile expert forward on Hopper (sm_90a): positional encoding and
// both layers of one expert's tiny MLP per tile of the sorted token stream.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/expert_tiles_pallas.py:
// expert_tiles_forward (math in `_tile_math`). Plain version:
// smpl_nerf_tpu_torch/ops/expert_tiles.py:expert_tiles_reference.
//
//   enc = [local | sin(local*2^k (+pi/2)) | dirs | sin(dirs*2^k (+pi/2))]   (D columns)
//   h   = relu(cdt(enc) @ cdt(w0[e]) + b0[e])          float32 sums, float32 bias
//   out = (cdt(h) @ cdt(w1[e]) + b1[e]) where valid, else 0     [L, O] float32
// with e = tile_expert[slot / tile] and cdt = round to bf16 or identity.
//
// What bounds it on the H100: bytes. A slot reads 25 B (two float3 and one
// validity byte) and writes 16 B against 1,472 multiply-adds at D=42, H=32,
// O=4: ~72 operations per byte if done on tensor cores, below the ~295 of the
// ridge point. In this first version the products are scalar float32 FMAs,
// whose 67 TFLOP/s peak puts the arithmetic (~18 us at L=413,696) above the
// byte time (~5 us), so it is the FMA pipes and the shared-memory reads that
// feed them that set the pace; moving the products to `mma` is left to tuning.
//
// Design. On the TPU the grid walks the tiles in order and a scalar-prefetched
// index map fetches the tile's expert row. Here blocks run in any order: block
// (t, s) owns rows [s*128, s*128+128) of tile t, reads tile_expert[t] itself
// (clamped into [0, E), so a tile past the used stream reads a real expert),
// and copies that expert's w0 [D, H], b0, w1 [H, O], b1 into shared memory
// (~6 KB, rounded to bf16 there when asked; H zero-padded to a multiple of 32
// and O to 4, so the inner loops have no edge). One thread owns one row: it
// writes the row's D encoded values into a shared column (stride 128: no bank
// conflicts), then accumulates 32 hidden units at a time in registers, reading
// w0 as broadcast float4s. Only [tile, O] goes back to device memory; the
// encoded stream [L, D] and the gathered weights never exist there. A block
// whose rows are all invalid writes zeros and stops before touching weights.
// sinf, not __sinf: the argument reaches 2^(l_pos-1) * |x|.
#include "fused_mlp_common.cuh"

namespace {

using fused_mlp::encoding_arg;

constexpr int kRows = 128;   // rows (threads) per block
constexpr int kHChunk = 32;  // hidden units accumulated in registers at a time
constexpr int kOutPad = 4;   // O is padded to 4 in shared memory

__device__ inline float round_to(float v, int use_bf16) {
  return use_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__global__ void __launch_bounds__(kRows)
expert_tiles_kernel(const float* __restrict__ local, const float* __restrict__ dirs,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ tile_expert, const float* __restrict__ w0,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, float* __restrict__ out, int tile, int E,
                    int D, int H, int O, int l_pos, int l_dir, int use_bf16) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = (H + kHChunk - 1) / kHChunk * kHChunk;
  float* w0s = smem;                      // [D, Hp]
  float* b0s = w0s + D * Hp;              // [Hp]
  float* w1s = b0s + Hp;                  // [Hp, kOutPad]
  float* b1s = w1s + Hp * kOutPad;        // [kOutPad]
  float* encs = b1s + kOutPad;            // [D, kRows]

  const int tid = threadIdx.x;
  const int in_tile = blockIdx.y * kRows + tid;
  const bool in_range = in_tile < tile;
  const size_t row = (size_t)blockIdx.x * tile + in_tile;
  const bool ok = in_range && valid[row] != 0;

  if (!__syncthreads_or(ok)) {            // nothing real here: zeros, no weights read
    if (in_range)
      for (int o = 0; o < O; ++o) out[row * O + o] = 0.f;
    return;
  }

  int e = tile_expert[blockIdx.x];
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);
  for (int i = tid; i < D * Hp; i += kRows) {
    const int d = i / Hp, j = i - d * Hp;
    w0s[i] = j < H ? round_to(w0[((size_t)e * D + d) * H + j], use_bf16) : 0.f;
  }
  for (int j = tid; j < Hp; j += kRows) b0s[j] = j < H ? b0[(size_t)e * H + j] : 0.f;
  for (int i = tid; i < Hp * kOutPad; i += kRows) {
    const int j = i / kOutPad, o = i - j * kOutPad;
    w1s[i] = (j < H && o < O) ? round_to(w1[((size_t)e * H + j) * O + o], use_bf16) : 0.f;
  }
  if (tid < kOutPad) b1s[tid] = tid < O ? b1[(size_t)e * O + tid] : 0.f;

  if (in_range) {
    float p[3], q[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = local[row * 3 + c];
      q[c] = dirs[row * 3 + c];
    }
    const int np = 6 * l_pos, nd = 6 * l_dir;
    int d = 0;
    for (int c = 0; c < 3; ++c) encs[(d++) * kRows + tid] = round_to(p[c], use_bf16);
    for (int c = 0; c < np; ++c)
      encs[(d++) * kRows + tid] = round_to(sinf(encoding_arg(p, c)), use_bf16);
    for (int c = 0; c < 3; ++c) encs[(d++) * kRows + tid] = round_to(q[c], use_bf16);
    for (int c = 0; c < nd; ++c)
      encs[(d++) * kRows + tid] = round_to(sinf(encoding_arg(q, c)), use_bf16);
  }
  __syncthreads();
  if (!in_range) return;

  float acc[kOutPad];
#pragma unroll
  for (int o = 0; o < kOutPad; ++o) acc[o] = b1s[o];
  for (int hc = 0; hc < Hp; hc += kHChunk) {
    float h[kHChunk];
#pragma unroll
    for (int j = 0; j < kHChunk; ++j) h[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = encs[d * kRows + tid];
      const float4* w = reinterpret_cast<const float4*>(w0s + d * Hp + hc);
#pragma unroll
      for (int j4 = 0; j4 < kHChunk / 4; ++j4) {
        const float4 v = w[j4];
        h[4 * j4 + 0] = fmaf(x, v.x, h[4 * j4 + 0]);
        h[4 * j4 + 1] = fmaf(x, v.y, h[4 * j4 + 1]);
        h[4 * j4 + 2] = fmaf(x, v.z, h[4 * j4 + 2]);
        h[4 * j4 + 3] = fmaf(x, v.w, h[4 * j4 + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHChunk; ++j) {
      float a = h[j] + b0s[hc + j];
      a = a > 0.f ? a : 0.f;
      a = round_to(a, use_bf16);
      const float4 v = *reinterpret_cast<const float4*>(w1s + (hc + j) * kOutPad);
      acc[0] = fmaf(a, v.x, acc[0]);
      acc[1] = fmaf(a, v.y, acc[1]);
      acc[2] = fmaf(a, v.z, acc[2]);
      acc[3] = fmaf(a, v.w, acc[3]);
    }
  }
  if (O == kOutPad) {
    *reinterpret_cast<float4*>(out + row * kOutPad) =
        ok ? make_float4(acc[0], acc[1], acc[2], acc[3]) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int o = 0; o < kOutPad; ++o)
      if (o < O) out[row * O + o] = ok ? acc[o] : 0.f;
  }
}

size_t shared_bytes(int D, int H) {
  const int Hp = (H + kHChunk - 1) / kHChunk * kHChunk;
  return sizeof(float) * ((size_t)D * Hp + Hp + Hp * kOutPad + kOutPad + (size_t)D * kRows);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses experts whose
// block does not fit.
int expert_tiles_shared_bytes(int D, int H) { return (int)shared_bytes(D, H); }

// local, dirs [L, 3] float32; valid [L] bytes; tile_expert [L / tile] int32;
// w0 [E, D, H], b0 [E, H], w1 [E, H, O], b1 [E, O] float32; out [L, O] float32,
// every element written. D = 6 + 6 * (l_pos + l_dir), O <= 4, L a multiple of
// tile. Returns the CUDA error of the launch (0 on success).
int expert_tiles_launch(const float* local, const float* dirs, const unsigned char* valid,
                        const int* tile_expert, const float* w0, const float* b0,
                        const float* w1, const float* b1, float* out, int L, int tile, int E,
                        int D, int H, int O, int l_pos, int l_dir, int use_bf16,
                        cudaStream_t stream) {
  const size_t bytes = shared_bytes(D, H);
  cudaError_t err = cudaFuncSetAttribute(expert_tiles_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L / tile, (tile + kRows - 1) / kRows);
  expert_tiles_kernel<<<grid, kRows, bytes, stream>>>(local, dirs, valid, tile_expert, w0, b0,
                                                      w1, b1, out, tile, E, D, H, O, l_pos,
                                                      l_dir, use_bf16);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
