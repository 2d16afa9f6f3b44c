// Fused RenderRayNet v2 forward on Hopper (sm_90a): in-kernel encoding + the
// whole MLP per 64-row tile, bf16 tensor-core products with float32 accumulation.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/fused_mlp_v2.py:_pallas_forward
// (math in `_tile_forward`). Plain version:
// smpl_nerf_tpu_torch/ops/fused_mlp_v2.py:reference_forward_raw.
//
//   pos = bf16(sin(xyz @ Mp + Pp)), dir = bf16(sin(d @ Md + Pd))     (block order
//         [sin f0 | cos f0 | sin f1 | ...], cos(t) = sin(t + pi/2))
//   o = bf16(relu(pos @ W0 + b0))
//   for i in 0..n_layers-2: o = [o, pos] if i in skips; o = bf16(relu(o @ Wi + bi))
//   o = bf16(o @ Wadd + badd);  sigma = o @ Wsig + bsig
//   o = bf16([o, dir] @ Wdi + bdi);  o = bf16(relu(o @ Wd0 + bd0));  rgb = o @ Wrgb + brgb
//   out = [rgb, sigma]   (float32 [N, 4])
// Biases are added in float32; activations round to bf16 exactly where
// `_tile_forward` rounds.
//
// What bounds it on the H100: tensor-core operations. At W=256, 8 layers,
// skip at 4, 60/24 encoded dims, one sample costs 607,872 multiply-adds and
// moves 40 bytes (6 floats in, 4 out): ~30,000 operations per byte, a hundred
// times past the bf16 ridge point.
//
// Why the weights stream instead of staying resident: the TPU kernel holds
// all weights (~1.2 MB bf16 at W=256) in its 16 MB VMEM. A Hopper block has
// at most 227 KB of shared memory. So a block keeps only its 64-row tile's
// activations (two ping-pong bf16 buffers, the encodings) in shared memory
// and streams each layer's [K, N] weights through a 32-row shared buffer;
// across the ~thousands of blocks the weights stay hot in the 50 MB L2. The
// skip and direction concatenations are never materialised: a K-chunk's A
// operand comes from the activation buffer or from the encoding buffer.
// Rows are padded by 8 bf16 against shared-memory bank conflicts. ~107 KB of
// shared memory per block lets two blocks share an SM.
//
// This is the simple, correct first version: products use `nvcuda::wmma`
// 16x16x16 (mma.sync), not `wgmma`, and weight loads are not overlapped with
// the products (no cp.async / TMA pipeline yet). The dense layer, the heads
// and the encoding live in fused_mlp_common.cuh, shared with the v1 forward
// and the v2 backward.
#include "fused_mlp_common.cuh"

using namespace fused_mlp;

namespace {

struct Dims {
  int W, P, Ppad, D, Dpad, lda, ldp, ldd;
  size_t off_act_a, off_act_b, off_pos, off_dir, off_w, off_scratch, off_out, off_raw, total;
};

__host__ __device__ inline Dims make_dims(int W, int pos_freqs, int dir_freqs) {
  Dims d;
  d.W = W;
  d.P = 6 * pos_freqs;
  d.Ppad = round16(d.P);
  d.D = 6 * dir_freqs;
  d.Dpad = round16(d.D);
  d.lda = W + kPadCols;
  d.ldp = d.Ppad + kPadCols;
  d.ldd = d.Dpad + kPadCols;
  size_t o = 0;
  d.off_act_a = o;   o = align128(o + sizeof(bf16) * kTile * d.lda);
  d.off_act_b = o;   o = align128(o + sizeof(bf16) * kTile * d.lda);
  d.off_pos = o;     o = align128(o + sizeof(bf16) * kTile * d.ldp);
  d.off_dir = o;     o = align128(o + sizeof(bf16) * kTile * d.ldd);
  d.off_w = o;       o = align128(o + sizeof(bf16) * kChunk * (W + kPadCols));
  d.off_scratch = o; o = align128(o + sizeof(float) * kWarps * 256);
  d.off_out = o;     o = align128(o + sizeof(float) * kTile * 4);
  d.off_raw = o;     o = align128(o + sizeof(float) * kTile * 6);
  d.total = o;
  return d;
}

__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_v2_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                        const bf16* __restrict__ wts, const float* __restrict__ bias,
                        const int* __restrict__ table, int N, int n_layers, int W,
                        int pos_freqs, int dir_freqs, unsigned skip_mask, int use_dir) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims d = make_dims(W, pos_freqs, dir_freqs);
  bf16* cur = reinterpret_cast<bf16*>(smem + d.off_act_a);
  bf16* nxt = reinterpret_cast<bf16*>(smem + d.off_act_b);
  bf16* pos = reinterpret_cast<bf16*>(smem + d.off_pos);
  bf16* dir = reinterpret_cast<bf16*>(smem + d.off_dir);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + d.off_w);
  float* scratch = reinterpret_cast<float*>(smem + d.off_scratch) + (threadIdx.x >> 5) * 256;
  float* outT = reinterpret_cast<float*>(smem + d.off_out);
  float* raw = reinterpret_cast<float*>(smem + d.off_raw);
  const int row0 = blockIdx.x * kTile;

  // raw rows of the tile; the ragged last tile reads zeros and stores nothing
  for (int i = threadIdx.x; i < kTile * 6; i += kThreads)
    raw[i] = (row0 + i / 6 < N) ? x[(size_t)row0 * 6 + i] : 0.f;
  __syncthreads();
  encode(raw, 0, pos_freqs, d.Ppad, pos, d.ldp);
  encode(raw, 3, dir_freqs, d.Dpad, dir, d.ldd);
  __syncthreads();

  const Seg pos_seg = {pos, d.ldp, d.Ppad};
  const Seg dir_seg = {dir, d.ldd, use_dir ? d.Dpad : 0};
  net_forward(pos_seg, dir_seg, cur, nxt, d.lda, wts, bias, table, n_layers, W, skip_mask, wbuf,
              scratch, outT);
  for (int i = threadIdx.x; i < kTile * 4; i += kThreads)
    if (row0 + i / 4 < N) y[(size_t)row0 * 4 + i] = outT[i];
}

}  // namespace

extern "C" {

// x [N, 6] float32 raw rows (xyz || unit dir), y [N, 4] float32 (rgb || sigma).
// w/b/table: the weight pack of ops/fused_mlp.py:pack_weights. W must be a
// multiple of 32 in [32, 256]. Returns the CUDA error of the launch (0 on success).
int fused_mlp_v2_fwd_launch(const float* x, float* y, const void* w, const float* b,
                            const int* table, int N, int n_layers, int W, int pos_freqs,
                            int dir_freqs, unsigned skip_mask, int use_dir,
                            cudaStream_t stream) {
  const Dims d = make_dims(W, pos_freqs, dir_freqs);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_v2_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)d.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kTile - 1) / kTile;
  fused_mlp_v2_fwd_kernel<<<blocks, kThreads, d.total, stream>>>(
      x, y, static_cast<const bf16*>(w), b, table, N, n_layers, W, pos_freqs, dir_freqs,
      skip_mask, use_dir);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
