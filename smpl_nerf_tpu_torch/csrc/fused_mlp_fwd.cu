// Fused RenderRayNet v1 forward on Hopper (sm_90a): the whole MLP per 128-row
// tile on pre-encoded rows, with any conditioning prefix, bf16 tensor-core
// products (wgmma) with float32 accumulation.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/fused_mlp.py:_pallas_forward (math
// in `_make_kernel`). Plain version:
// smpl_nerf_tpu_torch/ops/fused_mlp.py:reference_forward.
//
//   x = [prefix (add) | pos_enc (P) | dir_enc (D)] float32, in_dim = add + P + D
//   pos = bf16(x[:, :add+P]), dir = bf16(x[:, in_dim-D:])
//   trunk with skip concats of `pos`, additional_linear_layer, sigma head,
//   directional branch, rgb head; out = [rgb, sigma]   (float32 [N, 4])
// Biases are added in float32; activations round to bf16 after each ReLU,
// after additional_linear_layer and after directional_input, as the TPU
// kernel rounds them; the heads are float32 dots of the rounded activations.
//
// What bounds it on the H100: at the append_smpl_params shape (add = 621,
// P = 60, D = 24, W = 256, 8 layers, skip 4) one row costs 925,824
// multiply-adds and moves 2,836 bytes (705 floats in, 4 out): ~650 operations
// per byte, above the ~295 of the bf16 ridge point, so tensor-core operations
// (0.2454 ms at 131,072 rows). Two costs sit beside them: every 128-row tile
// streams the whole weight set (1.85 MB) from L2, ~1.9 GB per 131,072 rows;
// and the prefix+pos block is read from x twice (the first layer and the
// skip layer): 2 x 370 MB, ~0.22 ms of memory time that the bound does not
// count, since it counts each input byte once.
//
// Design: the mainloop of render_net.cuh (persistent 128-row tiles, a
// producer warpgroup streaming pack_weights_d's chunks through an mbarrier
// ring, two consumer warpgroups running wgmma with the activations in
// registers, float32 heads), with this kernel's A chunks (XSrc):
//  - the prefix+pos and dir blocks are streamed, never resident: for the
//    first layer, every skip layer and directional_input the producer builds
//    the 128 x 64 A chunk beside the weight chunk in the same stage. Rows of
//    x are not 16-byte aligned (in_dim is odd at the flagship shape), so TMA
//    cannot read them: the producer lands the next chunk's float32 values
//    with 4-byte cp.async (zero-filled past the tile's rows and the block's
//    columns) into one of two landing slots while it rounds the current one
//    to bf16 into the swizzled A chunk. No register holds a load in flight.
#include "render_net.cuh"

namespace {

using namespace render_net;

constexpr int kRawBytes = kTileRows * kChunkK * 4;  // float32 landing slot
constexpr int kRawSlots = 2;

// x columns [col0, col0 + cols) of A chunk j of a tile.
__device__ __forceinline__ void x_chunk(const Net& p, int j, int& col0, int& cols) {
  bool is_dir;
  int cc;
  a_chunk(p, j, is_dir, cc);
  col0 = (is_dir ? p.in_dim - p.dir_dim : 0) + cc * kChunkK;
  cols = min(kChunkK, (is_dir ? p.dir_dim : p.pos_block) - cc * kChunkK);
}

// Producer: land x-chunk j of the tile at row0 as float32 in `raw` (the
// thread's own pairs of columns; zeros past N rows and past `cols`).
__device__ __forceinline__ void issue_x(const Net& p, int row0, int j, float* raw, int pt) {
  int col0, cols;
  x_chunk(p, j, col0, cols);
#pragma unroll 2
  for (int i = pt; i < kTileRows * kChunkK / 2; i += kProducerThreads) {
    const int row = i >> 5, col = (i & 31) * 2;
    const int grow = row0 + row;
    const float* src = p.x + (size_t)grow * p.in_dim + col0 + col;
    const bool in_row = grow < p.N;
    cp_async4(raw + row * kChunkK + col, in_row && col < cols ? src : p.x,
              in_row && col < cols ? 4 : 0);
    cp_async4(raw + row * kChunkK + col + 1, in_row && col + 1 < cols ? src + 1 : p.x,
              in_row && col + 1 < cols ? 4 : 0);
  }
}

// Producer: round the landed float32 chunk to bf16 into the swizzled A chunk.
__device__ __forceinline__ void convert_x(const float* raw, unsigned char* xs, int pt) {
#pragma unroll 2
  for (int i = pt; i < kTileRows * kChunkK / 2; i += kProducerThreads) {
    const int row = i >> 5, col = (i & 31) * 2;
    const float2 v = *reinterpret_cast<const float2*>(raw + row * kChunkK + col);
    *reinterpret_cast<uint32_t*>(xs + swizzle128(row, col)) = pack_bf16(v.x, v.y);
  }
}

// D's A chunks: float32 columns of x through two landing slots.
struct XSrc {
  static constexpr int kExtraBytes = kRawSlots * kRawBytes;
  float* raw;
  int xs;

  __device__ __forceinline__ void start(const Net& p, unsigned char* extra, int pt) {
    raw = reinterpret_cast<float*>(extra);
    xs = 0;
    if ((int)blockIdx.x * kTileRows < p.N) issue_x(p, blockIdx.x * kTileRows, 0, raw, pt);
    cp_async_commit();
  }

  __device__ __forceinline__ void begin_tile(const Net&, int, int) {}

  // the tile's A chunk j from the slot that has landed, while the one after
  // it (or the next tile's first) lands in the other
  __device__ __forceinline__ void fill(const Net& p, int t, int j, unsigned char* a, int pt) {
    const int tiles = (p.N + kTileRows - 1) / kTileRows;
    float* next = raw + ((xs + 1) & 1) * (kRawBytes / 4);
    if (j + 1 < a_chunks_per_tile(p))
      issue_x(p, t * kTileRows, j + 1, next, pt);
    else if (t + (int)gridDim.x < tiles)
      issue_x(p, (t + gridDim.x) * kTileRows, 0, next, pt);
    cp_async_commit();
    cp_async_wait<1>();
    convert_x(raw + (xs & 1) * (kRawBytes / 4), a, pt);
    ++xs;
  }
};

template <int WP>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_fwd_kernel(const Net p) {
  forward_body<WP, XSrc>(p);
}

template <int WP>
int launch(const Net& p, cudaStream_t stream) {
  return launch_persistent(fused_mlp_fwd_kernel<WP>, Cfg<WP, XSrc::kExtraBytes>::kSmem,
                           (p.N + kTileRows - 1) / kTileRows, stream, p);
}

}  // namespace

extern "C" {

// x [N, in_dim] float32 pre-encoded rows (prefix || pos_enc || dir_enc),
// y [N, 4] float32 (rgb || sigma). w / b / heads: the D-only pack of
// ops/fused_mlp.py:pack_weights_d for W padded to padded_width(W). W a
// multiple of 32 in [32, 256], pos_block >= 1, N >= 1. Returns the CUDA error
// of the launch (0 on success).
int fused_mlp_fwd_launch(const float* x, float* y, const void* w, const float* b,
                         const float* heads, int N, int n_layers, int W, int pos_block,
                         int dir_dim, int in_dim, unsigned skip_mask, int use_dir,
                         cudaStream_t stream) {
  Net p;
  p.x = x;
  p.y = y;
  p.w = static_cast<const unsigned char*>(w);
  p.bias = b;
  p.heads = heads;
  p.N = N;
  p.n_layers = n_layers;
  p.pos_block = pos_block;
  p.dir_dim = dir_dim;
  p.in_dim = in_dim;
  p.add = 0;                 // XSrc reads the prefix as the first columns of its block
  p.P = (pos_block + kChunkK - 1) / kChunkK;
  p.Dc = (dir_dim + kChunkK - 1) / kChunkK;
  p.skip_mask = skip_mask;
  p.use_dir = use_dir;
  p.enc_out = nullptr;
  p.enc_ld = 0;
  return padded_width(W) == 256 ? launch<256>(p, stream) : launch<128>(p, stream);
}

// Dynamic shared memory the launch asks for, for a W-wide net.
int fused_mlp_fwd_shared_bytes(int W) {
  return padded_width(W) == 256 ? Cfg<256, XSrc::kExtraBytes>::kSmem
                                : Cfg<128, XSrc::kExtraBytes>::kSmem;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
