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
// Design (hopper.cuh has the PTX):
//  - a persistent block per SM of 384 threads walks 128-row tiles. Warpgroups
//    0 and 1 consume (64 rows each), warpgroup 2 produces. setmaxnreg gives
//    the consumers 224 registers and the producer 56: 2 x 128 x 224 +
//    128 x 56 = 64,512, what the block holds at launch (168 a thread).
//  - the weights are a D-only pack (ops/fused_mlp.py:pack_weights_d): every
//    layer's [K, N] cut in 64-row chunks, each laid out as the 128B-swizzled
//    K-major image wgmma reads, so one cp.async.bulk lands a chunk. Chunks
//    stream through a ring of 3 (W = 256) or 4 (W <= 128) stages with full
//    and empty mbarriers; no block barrier anywhere in the main loop. Each
//    chunk serves both consumer warpgroups, so the L2 weight traffic per row
//    is half that of a 64-row tile.
//  - activations stay in registers between layers: layer l's accumulator
//    (started from the bias) goes through ReLU and bf16 rounding straight
//    into layer l+1's A fragments (the m64 accumulator of columns 16 s ..
//    16 s + 15 is the A fragment of k-step s), and wgmma reads A from
//    registers. No activation buffer and no float32 scratch. At W = 256 a
//    thread holds 128 accumulators and 64 A fragments; the heads' weights
//    are loaded where they are used, never held through the tile loop.
//  - the prefix+pos and dir blocks are streamed, never resident: for the
//    first layer, every skip layer and directional_input the producer builds
//    the 128 x 64 A chunk beside the weight chunk in the same stage. Rows of
//    x are not 16-byte aligned (in_dim is odd at the flagship shape), so TMA
//    cannot read them: the producer lands the next chunk's float32 values
//    with 4-byte cp.async (zero-filled past the tile's rows and the block's
//    columns) into one of two landing slots while it rounds the current one
//    to bf16 into the swizzled A chunk. No register holds a load in flight.
//  - heads: sigma_out_layer (N = 1) and rgb_out_layer (N = 3) are float32
//    dots; a thread sums the columns its registers hold, a quad shuffle
//    finishes the row.
//  - W is padded to 128 or 256 (zero weights, zero biases: padding columns
//    stay 0 through every layer), so two instantiations serve W = 32..256.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTileRows = 128;
constexpr int kChunkK = 64;                        // weight rows (and x columns) per chunk
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kProducerThreads = 128;
constexpr int kXBytes = kTileRows * kChunkK * 2;    // bf16 A chunk of the tile
constexpr int kRawBytes = kTileRows * kChunkK * 4;  // float32 landing slot
constexpr int kRawSlots = 2;

template <int WP>
struct Cfg {
  static constexpr int kStages = WP == 256 ? 3 : 4;
  static constexpr int kWBytes = kChunkK * WP * 2;  // widest weight chunk
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kRawOff = kStages * kStageBytes;
  static constexpr int kBarOff = kRawOff + kRawSlots * kRawBytes;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + 1024 B alignment slack
};

// Mirrored by ops/fused_mlp.py:shared_bytes and padded_width.
int padded_width(int W) { return W <= 128 ? 128 : 256; }

struct Net {
  const float* x;              // [N, in_dim]
  float* y;                    // [N, 4]
  const unsigned char* w;      // D-only weight pack (bf16 chunk images)
  const float* bias;           // per layer, padded to its N
  const float* heads;          // sigma w [WP], rgb w [WP / 2][3], rgb b [3], sigma b
  int N, n_layers, pos_block, dir_dim, in_dim;
  int P, Dc;                   // 64-column chunks of the prefix+pos and dir blocks
  unsigned skip_mask;
  int use_dir;
};

// x columns [col0, col0 + cols) of x-chunk j of a tile, in the order the
// layers read them: the prefix+pos block for the first layer and for each
// skip layer, then the dir block.
__device__ __forceinline__ void x_chunk(const Net& p, int j, int& col0, int& cols) {
  const int n_pos = p.P * (1 + __popc(p.skip_mask));
  if (j < n_pos) {
    col0 = (j % p.P) * kChunkK;
    cols = min(kChunkK, p.pos_block - col0);
  } else {
    const int jj = j - n_pos;
    col0 = p.in_dim - p.dir_dim + jj * kChunkK;
    cols = min(kChunkK, p.dir_dim - jj * kChunkK);
  }
}

__device__ __forceinline__ int x_chunks_per_tile(const Net& p) {
  return p.P * (1 + __popc(p.skip_mask)) + (p.use_dir ? p.Dc : 0);
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

// Consumer: one layer, N output columns, acc = bias + A @ W. NA chunks of its
// K come from the previous layer's activations (A in registers: frag), then
// nx chunks of x (A in shared memory, the stage's x chunk). `it` is the ring
// position.
template <int WP, int N, int NA>
__device__ __forceinline__ void consume_layer(float* acc, uint32_t* frag, const float* bias,
                                              int nx, int& it, unsigned char* smem,
                                              uint64_t* full, uint64_t* empty, int wg, int q) {
  using C = Cfg<WP>;
  // the accumulator starts from the bias: no bias register stays live
  // through the epilogue, where the activations of two layers meet
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * q));
    acc[4 * j] = acc[4 * j + 2] = b.x;
    acc[4 * j + 1] = acc[4 * j + 3] = b.y;
  }
  const int first = it;
#pragma unroll
  for (int c = 0; c < NA; ++c, ++it) {
    const int s = it % C::kStages;
    mbar_wait(&full[s], (it / C::kStages) & 1);
    const unsigned char* wst = smem + s * C::kStageBytes;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reg_fence(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ++ks)
      wgmma_rs<N, 0>(acc, frag + (4 * c + ks) * 4, desc_sw128(wst + 32 * ks, 16, 1024), 1);
    wgmma_commit();
    if (it > first) {
      wgmma_wait<1>();
      mbar_arrive(&empty[(it - 1) % C::kStages]);
    }
  }
  for (int c = 0; c < nx; ++c, ++it) {
    const int s = it % C::kStages;
    mbar_wait(&full[s], (it / C::kStages) & 1);
    const unsigned char* wst = smem + s * C::kStageBytes;
    const unsigned char* xst = wst + C::kWBytes + wg * (64 * 128);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reg_fence(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ++ks)
      wgmma_ss<N, 0>(acc, desc_sw128(xst + 32 * ks, 16, 1024),
                     desc_sw128(wst + 32 * ks, 16, 1024), 1);
    wgmma_commit();
    if (it > first) {
      wgmma_wait<1>();
      mbar_arrive(&empty[(it - 1) % C::kStages]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) reg_fence(acc[i]);
#pragma unroll
  for (int i = 0; i < WP / 4; ++i) reg_fence(frag[i]);
  mbar_arrive(&empty[(it - 1) % C::kStages]);
}

// Consumer: (ReLU and) round to bf16 into the next layer's A fragments.
template <int N, bool RELU>
__device__ __forceinline__ void epilogue(const float* acc, uint32_t* frag) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float v00 = acc[4 * j], v01 = acc[4 * j + 1], v10 = acc[4 * j + 2], v11 = acc[4 * j + 3];
    if (RELU) {  // keeps NaN, as relu does
      v00 = v00 < 0.f ? 0.f : v00;
      v01 = v01 < 0.f ? 0.f : v01;
      v10 = v10 < 0.f ? 0.f : v10;
      v11 = v11 < 0.f ? 0.f : v11;
    }
    frag[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(v00, v01);
    frag[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(v10, v11);
  }
}

// Consumer: a head's float32 dots over the rounded activations in frag (the
// first K columns) with hw [K][HEAD], for the thread's two rows; a quad
// shuffle sums the row. Runs once the accumulator is dead.
template <int K, int HEAD>
__device__ __forceinline__ void head(const uint32_t* frag, const float* hw, int q, float* top,
                                     float* bot) {
#pragma unroll
  for (int o = 0; o < HEAD; ++o) top[o] = bot[o] = 0.f;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const uint32_t t = frag[4 * (j / 2) + 2 * (j % 2)], u = frag[4 * (j / 2) + 2 * (j % 2) + 1];
    const float2 tf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t));
    const float2 uf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
#pragma unroll
    for (int o = 0; o < HEAD; ++o) {
      const float w0 = __ldg(hw + c * HEAD + o), w1 = __ldg(hw + (c + 1) * HEAD + o);
      top[o] = fmaf(tf.x, w0, fmaf(tf.y, w1, top[o]));
      bot[o] = fmaf(uf.x, w0, fmaf(uf.y, w1, bot[o]));
    }
  }
#pragma unroll
  for (int o = 0; o < HEAD; ++o) {
    top[o] += __shfl_xor_sync(0xffffffffu, top[o], 1);
    top[o] += __shfl_xor_sync(0xffffffffu, top[o], 2);
    bot[o] += __shfl_xor_sync(0xffffffffu, bot[o], 1);
    bot[o] += __shfl_xor_sync(0xffffffffu, bot[o], 2);
  }
}

template <int WP>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_fwd_kernel(const Net p) {
  using C = Cfg<WP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* raw = reinterpret_cast<float*>(smem + C::kRawOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int tiles = (p.N + kTileRows - 1) / kTileRows;
  constexpr int kActChunks = WP / kChunkK;
  constexpr int kWB = kChunkK * WP * 2, kHB = kChunkK * (WP / 2) * 2;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_dealloc<56>();
    const int pt = tid - 256;
    const int xt = x_chunks_per_tile(p);
    int it = 0, xs = 0;
    if (blockIdx.x < tiles) issue_x(p, blockIdx.x * kTileRows, 0, raw, pt);
    cp_async_commit();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      size_t woff = 0;
      int xj = 0;
      // one ring stage: a weight chunk of `wbytes`, and with_x the tile's
      // next A chunk of x (while the one after it lands)
      auto produce = [&](int wbytes, bool with_x) {
        const int s = it % C::kStages;
        mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
        unsigned char* stage = smem + s * C::kStageBytes;
        if (pt == 0) {
          mbar_expect_tx(&full[s], wbytes);
          bulk_load(stage, p.w + woff, wbytes, &full[s]);
        }
        if (with_x) {
          if (xj + 1 < xt)
            issue_x(p, t * kTileRows, xj + 1, raw + ((xs + 1) & 1) * (kRawBytes / 4), pt);
          else if (t + (int)gridDim.x < tiles)
            issue_x(p, (t + gridDim.x) * kTileRows, 0, raw + ((xs + 1) & 1) * (kRawBytes / 4),
                    pt);
          cp_async_commit();
          cp_async_wait<1>();
          convert_x(raw + (xs & 1) * (kRawBytes / 4), stage + C::kWBytes, pt);
          fence_async_shared();
          ++xj;
          ++xs;
        }
        mbar_arrive(&full[s]);
        woff += wbytes;
        ++it;
      };
      for (int c = 0; c < p.P; ++c) produce(kWB, true);                 // positions_pose_input
      for (int i = 0; i < p.n_layers - 1; ++i) {                         // positional_net_i
        for (int c = 0; c < kActChunks; ++c) produce(kWB, false);
        if ((p.skip_mask >> i) & 1u)
          for (int c = 0; c < p.P; ++c) produce(kWB, true);
      }
      for (int c = 0; c < kActChunks; ++c) produce(kWB, false);         // additional_linear_layer
      for (int c = 0; c < kActChunks; ++c) produce(kHB, false);         // directional_input
      if (p.use_dir)
        for (int c = 0; c < p.Dc; ++c) produce(kHB, true);
      for (int c = 0; c < kActChunks / 2; ++c) produce(kHB, false);     // directional_net_0
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<224>();
    float acc[WP / 2] = {};
    uint32_t frag[WP / 4] = {};
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r = warp * 16 + lane / 4, q = lane % 4;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      // the weights of the heads and the biases are the same for every tile;
      // opaque pointers keep the compiler from hoisting their loads out of
      // the tile loop, where they would hold ~100 registers through it
      const float* bias = p.bias;
      const float* heads = p.heads;
      asm volatile("" : "+l"(bias), "+l"(heads));
      const float* hw_sigma = heads;
      const float* hw_rgb = heads + WP;
      const float* hb = heads + WP + 3 * (WP / 2);   // rgb b [3], sigma b
      float sig_top[1], sig_bot[1], rgb_top[3], rgb_bot[3];
      consume_layer<WP, WP, 0>(acc, frag, bias, p.P, it, smem, full, empty, wg, q);
      epilogue<WP, true>(acc, frag);
      bias += WP;
      for (int i = 0; i < p.n_layers - 1; ++i) {
        consume_layer<WP, WP, kActChunks>(acc, frag, bias, ((p.skip_mask >> i) & 1u) ? p.P : 0,
                                          it, smem, full, empty, wg, q);
        epilogue<WP, true>(acc, frag);
        bias += WP;
      }
      consume_layer<WP, WP, kActChunks>(acc, frag, bias, 0, it, smem, full, empty, wg, q);
      epilogue<WP, false>(acc, frag);
      head<WP, 1>(frag, hw_sigma, q, sig_top, sig_bot);
      const int row = t * kTileRows + wg * 64 + r + (q == 1 ? 8 : 0);
      if (q < 2 && row < p.N)
        p.y[(size_t)row * 4 + 3] = (q == 0 ? sig_top[0] : sig_bot[0]) + hb[3];
      bias += WP;
      consume_layer<WP, WP / 2, kActChunks>(acc, frag, bias, p.use_dir ? p.Dc : 0, it, smem,
                                            full, empty, wg, q);
      epilogue<WP / 2, false>(acc, frag);
      bias += WP / 2;
      consume_layer<WP, WP / 2, kActChunks / 2>(acc, frag, bias, 0, it, smem, full, empty, wg, q);
      epilogue<WP / 2, true>(acc, frag);
      head<WP / 2, 3>(frag, hw_rgb, q, rgb_top, rgb_bot);
      if (q < 2 && row < p.N) {
#pragma unroll
        for (int o = 0; o < 3; ++o)
          p.y[(size_t)row * 4 + o] = (q == 0 ? rgb_top[o] : rgb_bot[o]) + hb[o];
      }
    }
  }
}

template <int WP>
int launch(const Net& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_fwd_kernel<WP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<WP>::kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles = (p.N + kTileRows - 1) / kTileRows;
  fused_mlp_fwd_kernel<WP><<<tiles < sms ? tiles : sms, kThreads, Cfg<WP>::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
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
  p.P = (pos_block + kChunkK - 1) / kChunkK;
  p.Dc = (dir_dim + kChunkK - 1) / kChunkK;
  p.skip_mask = skip_mask;
  p.use_dir = use_dir;
  return padded_width(W) == 256 ? launch<256>(p, stream) : launch<128>(p, stream);
}

// Dynamic shared memory the launch asks for, for a W-wide net.
int fused_mlp_fwd_shared_bytes(int W) {
  return padded_width(W) == 256 ? Cfg<256>::kSmem : Cfg<128>::kSmem;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
