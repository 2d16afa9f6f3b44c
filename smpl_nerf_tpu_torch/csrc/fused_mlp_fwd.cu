// Fused RenderRayNet v1 forward on Hopper (sm_90a): the whole MLP per 64-row
// tile on pre-encoded rows, with any conditioning prefix, bf16 tensor-core
// products with float32 accumulation.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/fused_mlp.py:_pallas_forward (math
// in `_make_kernel`). Plain version:
// smpl_nerf_tpu_torch/ops/fused_mlp.py:reference_forward.
//
//   x = [prefix (add) | pos_enc (P) | dir_enc (D)] float32, in_dim = add + P + D
//   pos = bf16(x[:, :add+P]), dir = bf16(x[:, in_dim-D:])
//   then the body of fused_mlp_v2_fwd.cu: trunk with skip concats of `pos`,
//   additional_linear_layer, sigma head, directional branch, rgb head;
//   out = [rgb, sigma]   (float32 [N, 4])
// Biases are added in float32; activations round to bf16 where the TPU kernel
// rounds them.
//
// What bounds it on the H100: at the append_smpl_params shape (add = 621,
// P = 60, D = 24, W = 256, 8 layers, skip 4) one sample costs 925,824
// multiply-adds and moves 2,836 bytes (705 floats in, 4 out): ~650 operations
// per byte, above the ~295 of the bf16 ridge point, so tensor-core operations,
// with the memory bound at 0.45 of the operations bound. Without a prefix
// (84 floats per row) it is far on the operations side.
//
// Design: fused_mlp_v2_fwd.cu minus the in-kernel encoding. The tile's `pos`
// block [64, round16(add+P)] and `dir` block are read from the float32 rows
// (coalesced along a row), rounded to bf16 and kept in shared memory for the
// skip layers; the weights stream through shared memory in 32-row chunks.
// The new trouble is size: with a 621-wide prefix the pos block alone is
// 64 x 696 x 2 B = 89 KB beside two 34 KB activation buffers, so a block
// takes ~190 KB of the SM's 227 KB and one block runs per SM (two without a
// prefix, ~110 KB). The wrapper refuses a net whose tile does not fit.
#include "fused_mlp_common.cuh"

using namespace fused_mlp;

namespace {

struct Dims {
  int W, PB, PBpad, D, Dpad, lda, ldp, ldd;
  size_t off_act_a, off_act_b, off_pos, off_dir, off_w, off_scratch, off_out, total;
};

// Mirrored by ops/fused_mlp.py:shared_bytes.
__host__ __device__ inline Dims make_dims(int W, int pos_block, int dir_dim) {
  Dims d;
  d.W = W;
  d.PB = pos_block;
  d.PBpad = round16(pos_block);
  d.D = dir_dim;
  d.Dpad = round16(dir_dim);
  d.lda = W + kPadCols;
  d.ldp = d.PBpad + kPadCols;
  d.ldd = d.Dpad + kPadCols;
  size_t o = 0;
  d.off_act_a = o;   o = align128(o + sizeof(bf16) * kTile * d.lda);
  d.off_act_b = o;   o = align128(o + sizeof(bf16) * kTile * d.lda);
  d.off_pos = o;     o = align128(o + sizeof(bf16) * kTile * d.ldp);
  d.off_dir = o;     o = align128(o + sizeof(bf16) * kTile * d.ldd);
  d.off_w = o;       o = align128(o + sizeof(bf16) * kChunk * (W + kPadCols));
  d.off_scratch = o; o = align128(o + sizeof(float) * kWarps * 256);
  d.off_out = o;     o = align128(o + sizeof(float) * kTile * 4);
  d.total = o;
  return d;
}

// dst [kTile, cols_pad] = bf16(x[row0 + r, col0 + c]) for c < cols, else 0;
// rows past N read as zeros.
__device__ void load_block(const float* __restrict__ x, int row0, int N, int in_dim, int col0,
                           int cols, int cols_pad, bf16* dst, int ld) {
  for (int i = threadIdx.x; i < kTile * cols_pad; i += kThreads) {
    const int r = i / cols_pad;
    const int c = i - r * cols_pad;
    float v = 0.f;
    if (c < cols && row0 + r < N) v = x[(size_t)(row0 + r) * in_dim + col0 + c];
    dst[r * ld + c] = __float2bfloat16_rn(v);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                     const bf16* __restrict__ wts, const float* __restrict__ bias,
                     const int* __restrict__ table, int N, int n_layers, int W,
                     int pos_block, int dir_dim, int in_dim, unsigned skip_mask, int use_dir) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims d = make_dims(W, pos_block, dir_dim);
  bf16* cur = reinterpret_cast<bf16*>(smem + d.off_act_a);
  bf16* nxt = reinterpret_cast<bf16*>(smem + d.off_act_b);
  bf16* pos = reinterpret_cast<bf16*>(smem + d.off_pos);
  bf16* dir = reinterpret_cast<bf16*>(smem + d.off_dir);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + d.off_w);
  float* scratch = reinterpret_cast<float*>(smem + d.off_scratch) + (threadIdx.x >> 5) * 256;
  float* outT = reinterpret_cast<float*>(smem + d.off_out);
  const int row0 = blockIdx.x * kTile;

  load_block(x, row0, N, in_dim, 0, d.PB, d.PBpad, pos, d.ldp);
  load_block(x, row0, N, in_dim, in_dim - d.D, d.D, d.Dpad, dir, d.ldd);
  __syncthreads();

  const Seg pos_seg = {pos, d.ldp, d.PBpad};
  const Seg dir_seg = {dir, d.ldd, use_dir ? d.Dpad : 0};
  net_forward(pos_seg, dir_seg, cur, nxt, d.lda, wts, bias, table, n_layers, W, skip_mask, wbuf,
              scratch, outT);
  for (int i = threadIdx.x; i < kTile * 4; i += kThreads)
    if (row0 + i / 4 < N) y[(size_t)row0 * 4 + i] = outT[i];
}

}  // namespace

extern "C" {

// x [N, in_dim] float32 pre-encoded rows (prefix || pos_enc || dir_enc),
// y [N, 4] float32 (rgb || sigma). w/b/table: the weight pack of
// ops/fused_mlp.py:pack_weights. W must be a multiple of 32 in [32, 256].
// Returns the CUDA error of the launch (0 on success).
int fused_mlp_fwd_launch(const float* x, float* y, const void* w, const float* b,
                         const int* table, int N, int n_layers, int W, int pos_block,
                         int dir_dim, int in_dim, unsigned skip_mask, int use_dir,
                         cudaStream_t stream) {
  const Dims d = make_dims(W, pos_block, dir_dim);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)d.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kTile - 1) / kTile;
  fused_mlp_fwd_kernel<<<blocks, kThreads, d.total, stream>>>(
      x, y, static_cast<const bf16*>(w), b, table, N, n_layers, W, pos_block, dir_dim,
      in_dim, skip_mask, use_dir);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
