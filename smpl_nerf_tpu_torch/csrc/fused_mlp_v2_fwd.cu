// Fused RenderRayNet v2 forward on Hopper (sm_90a): in-kernel encoding + the
// whole MLP per 128-row tile, bf16 tensor-core products (wgmma) with float32
// accumulation.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/fused_mlp_v2.py:_pallas_forward
// (math in `_tile_forward`). Plain version:
// smpl_nerf_tpu_torch/ops/fused_mlp_v2.py:reference_forward_raw.
//
//   x = [prefix (add) | xyz | d] float32 raw rows
//   pos = [bf16(prefix) | bf16(sin(xyz @ Mp + Pp))], dir = bf16(sin(d @ Md + Pd))
//         (block order [sin f0 | cos f0 | sin f1 | ...], cos(t) = sin(t + pi/2))
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
// times past the bf16 ridge point. Beside them, every 128-row tile streams the
// whole weight set (1.2 MB) from L2: ~1.2 GB per 131,072 rows. With the
// append_smpl_params prefix (add = 621) a sample costs 925,824 multiply-adds
// against 2,524 bytes (627 floats in, 4 out): ~730 operations per byte, still
// above the ridge point (0.2454 ms at 131,072 rows, as kernel D's bound).
//
// Design: the mainloop of render_net.cuh, the one kernel D runs (persistent
// 128-row tiles, pack_weights_d's chunks through an mbarrier ring, two
// consumer warpgroups on wgmma with the activations in registers, float32
// heads). Only the A chunks of the pos and dir blocks differ (EncodeSrc): the
// producer thread that owns a row of the tile holds its six raw floats in
// registers (the next tile's are loaded meanwhile) and writes
// bf16(sinf(encoding_arg)) of the chunk's 64 columns into the swizzled A
// chunk, for the first layer, each skip layer and directional_input. The
// encodings never exist in device memory, and x is read once. A conditioning
// prefix leads the prefix+pos block as D's loader lays it out, so B, C and D
// read one weight pack: its whole 64-column chunks are copied and rounded by
// the producer's threads spread along each row (a warp reads 64 neighbouring
// floats of a row; no TMA, since add + 6 floats leave rows unaligned), the
// chunk that straddles the prefix's end mixes copied and encoded columns, and
// the skip layer reads the prefix again from L2.
// sinf, never __sinf: the argument reaches 2^(L-1) * |x|.
#include "render_net.cuh"

namespace {

using namespace render_net;

template <int WP>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_v2_fwd_kernel(const Net p) {
  forward_body<WP, EncodeSrc>(p);
}

}  // namespace

extern "C" {

// x [N, add + 6] float32 raw rows (prefix || xyz || unit dir), y [N, 4]
// float32 (rgb || sigma). w / b / heads: the pack of
// ops/fused_mlp.py:pack_weights_d (kernel D's). W a multiple of 32 in
// [32, 256], add >= 0, N >= 1. Returns the CUDA error of the launch (0 on
// success).
int fused_mlp_v2_fwd_launch(const float* x, float* y, const void* w, const float* b,
                            const float* heads, int N, int n_layers, int W, int add,
                            int pos_freqs, int dir_freqs, unsigned skip_mask, int use_dir,
                            cudaStream_t stream) {
  Net p;
  p.x = x;
  p.y = y;
  p.w = static_cast<const unsigned char*>(w);
  p.bias = b;
  p.heads = heads;
  p.N = N;
  p.n_layers = n_layers;
  p.pos_block = add + 6 * pos_freqs;
  p.dir_dim = 6 * dir_freqs;
  p.in_dim = add + 6;
  p.add = add;
  p.P = (p.pos_block + kChunkK - 1) / kChunkK;
  p.Dc = (p.dir_dim + kChunkK - 1) / kChunkK;
  p.skip_mask = skip_mask;
  p.use_dir = use_dir;
  p.enc_out = nullptr;
  p.enc_ld = 0;
  const int tiles = (N + kTileRows - 1) / kTileRows;
  return padded_width(W) == 256
             ? launch_persistent(fused_mlp_v2_fwd_kernel<256>, Cfg<256, 0>::kSmem, tiles, stream, p)
             : launch_persistent(fused_mlp_v2_fwd_kernel<128>, Cfg<128, 0>::kSmem, tiles, stream, p);
}

// Dynamic shared memory the launch asks for, for a W-wide net.
int fused_mlp_v2_fwd_shared_bytes(int W) {
  return padded_width(W) == 256 ? Cfg<256, 0>::kSmem : Cfg<128, 0>::kSmem;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
