// The RenderRayNet mainloop on Hopper (sm_90a) that three kernels share:
// fused_mlp_fwd.cu (kernel D, pre-encoded rows), fused_mlp_v2_fwd.cu (kernel
// B, raw rows encoded in the kernel) and fused_mlp_v2_bwd.cu (kernel C, whose
// first phase recomputes B's forward). hopper.cuh has the PTX.
//
//  - a persistent block per SM of 384 threads walks 128-row tiles. Warpgroups
//    0 and 1 consume (64 rows each), warpgroup 2 produces. setmaxnreg gives
//    the consumers 224 registers and the producer 56: 2 x 128 x 224 +
//    128 x 56 = 64,512, what the block holds at launch (168 a thread).
//  - the weights are the pack of ops/fused_mlp.py:pack_weights_d: every
//    layer's [K, N] cut in 64-row chunks, each laid out as the 128B-swizzled
//    K-major image wgmma reads, so one cp.async.bulk lands a chunk. Chunks
//    stream through a ring of 3 (W = 256) or 4 (W <= 128) stages with full
//    and empty mbarriers; no block barrier anywhere in the main loop. Each
//    chunk serves both consumer warpgroups.
//  - activations stay in registers between layers: layer l's accumulator
//    (started from the bias) goes through ReLU and bf16 rounding straight
//    into layer l+1's A fragments (the m64 accumulator of columns 16 s ..
//    16 s + 15 is the A fragment of k-step s), and wgmma reads A from
//    registers. At W = 256 a thread holds 128 accumulators and 64 A
//    fragments; the heads' weights are loaded where they are used.
//  - the blocks a layer concatenates (prefix+pos for the first layer and
//    every skip layer, dir for directional_input) reach the consumers as
//    128 x 64 bf16 A chunks that the producer writes into the stage beside
//    the weight chunk. Where they come from is the kernel's `Src`:
//    D rounds float32 columns of x landed with cp.async (XSrc in
//    fused_mlp_fwd.cu); B and C round the raw rows' prefix columns and
//    encode their xyz and dir (EncodeSrc below).
//  - heads: sigma_out_layer (N = 1) and rgb_out_layer (N = 3) are float32
//    dots; a thread sums the columns its registers hold, a quad shuffle
//    finishes the row.
//  - W is padded to 128 or 256 (zero weights, zero biases: padding columns
//    stay 0 through every layer), so two instantiations serve W = 32..256.
#pragma once

#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace render_net {

using namespace hopper;

constexpr int kTileRows = 128;
constexpr int kChunkK = 64;                        // weight rows (and x columns) per chunk
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kProducerThreads = 128;
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;
constexpr int kXBytes = kTileRows * kChunkK * 2;    // bf16 A chunk of the tile

// Shared memory: the ring, then EXTRA bytes of the kernel's own, then the
// mbarriers. Mirrored by ops/fused_mlp.py:shared_bytes.
template <int WP, int EXTRA>
struct Cfg {
  static constexpr int kStages = WP == 256 ? 3 : 4;
  static constexpr int kWBytes = kChunkK * WP * 2;        // a chunk of a W-wide layer
  static constexpr int kHBytes = kChunkK * (WP / 2) * 2;  // ... of a W/2-wide layer
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kExtraOff = kStages * kStageBytes;
  static constexpr int kBarOff = kExtraOff + EXTRA;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + 1024 B alignment slack
};

// Mirrored by ops/fused_mlp.py:padded_width.
inline int padded_width(int W) { return W <= 128 ? 128 : 256; }

struct Net {
  const float* x;              // D: [N, in_dim] pre-encoded rows; B, C: [N, add + 6] raw rows
  float* y;                    // [N, 4] (B, D)
  const unsigned char* w;      // pack_weights_d chunk images
  const float* bias;           // per layer, padded to its N
  const float* heads;          // sigma w [WP], rgb w [WP / 2][3], rgb b [3], sigma b
  int N, n_layers, pos_block, dir_dim, in_dim;   // pos_block: prefix + pos columns
  int add;                     // B, C: the prefix columns leading each raw row
  int P, Dc;                   // 64-column chunks of the prefix+pos and dir blocks
  unsigned skip_mask;
  int use_dir;
  __nv_bfloat16* enc_out;      // C: each tile's encoded blocks go here too (else null)
  int enc_ld;                  // its row pitch in elements
};

// Chunk j of a tile's A chunks, in the order the layers read them: the
// prefix+pos block for the first layer and each skip layer, then the dir
// block. Sets is_dir and the chunk's index cc within its block.
__device__ __forceinline__ void a_chunk(const Net& p, int j, bool& is_dir, int& cc) {
  const int n_pos = p.P * (1 + __popc(p.skip_mask));
  is_dir = j >= n_pos;
  cc = is_dir ? j - n_pos : j % p.P;
}

__device__ __forceinline__ int a_chunks_per_tile(const Net& p) {
  return p.P * (1 + __popc(p.skip_mask)) + (p.use_dir ? p.Dc : 0);
}

// Producer: wait for stage `it` to be free and start the bulk copy of a
// weight chunk of `wbytes` at `src` into it. The caller fills the stage's A
// chunk if it has one, then arrives on full[it % kStages].
template <class C>
__device__ __forceinline__ unsigned char* acquire_stage(int it, unsigned char* smem,
                                                        uint64_t* full, uint64_t* empty,
                                                        const unsigned char* src, int wbytes,
                                                        int pt) {
  const int s = it % C::kStages;
  mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
  unsigned char* stage = smem + s * C::kStageBytes;
  if (pt == 0) {
    mbar_expect_tx(&full[s], wbytes);
    bulk_load(stage, src, wbytes, &full[s]);
  }
  return stage;
}

// Producer: the stages of one tile's forward, in the pack's order.
template <int WP, class C, class Src>
__device__ __forceinline__ void produce_forward(const Net& p, int t, Src& src, int& it,
                                                unsigned char* smem, uint64_t* full,
                                                uint64_t* empty, int pt) {
  constexpr int kActChunks = WP / kChunkK;
  size_t woff = 0;
  int xj = 0;
  // one ring stage: a weight chunk of `wbytes`, and with_x the tile's next A chunk
  auto produce = [&](int wbytes, bool with_x) {
    unsigned char* stage = acquire_stage<C>(it, smem, full, empty, p.w + woff, wbytes, pt);
    if (with_x) {
      src.fill(p, t, xj, stage + C::kWBytes, pt);
      fence_async_shared();
      ++xj;
    }
    mbar_arrive(&full[it % C::kStages]);
    woff += wbytes;
    ++it;
  };
  for (int c = 0; c < p.P; ++c) produce(C::kWBytes, true);             // positions_pose_input
  for (int i = 0; i < p.n_layers - 1; ++i) {                           // positional_net_i
    for (int c = 0; c < kActChunks; ++c) produce(C::kWBytes, false);
    if ((p.skip_mask >> i) & 1u)
      for (int c = 0; c < p.P; ++c) produce(C::kWBytes, true);
  }
  for (int c = 0; c < kActChunks; ++c) produce(C::kWBytes, false);     // additional_linear_layer
  for (int c = 0; c < kActChunks; ++c) produce(C::kHBytes, false);     // directional_input
  if (p.use_dir)
    for (int c = 0; c < p.Dc; ++c) produce(C::kHBytes, true);
  for (int c = 0; c < kActChunks / 2; ++c) produce(C::kHBytes, false); // directional_net_0
}

// Consumer: one layer, N output columns, acc = bias + A @ W. NA chunks of its
// K come from the previous layer's activations (A in registers: frag), then
// nx A chunks of the stage (A in shared memory). `it` is the ring position.
template <class C, int WP, int N, int NA>
__device__ __forceinline__ void consume_layer(float* acc, uint32_t* frag, const float* bias,
                                              int nx, int& it, unsigned char* smem,
                                              uint64_t* full, uint64_t* empty, int wg, int q) {
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

// Consumer: the whole forward of tile t with both heads, y written.
template <int WP, class C>
__device__ __forceinline__ void consume_forward(const Net& p, int t, float* acc, uint32_t* frag,
                                                int& it, unsigned char* smem, uint64_t* full,
                                                uint64_t* empty, int wg, int r, int q) {
  constexpr int kActChunks = WP / kChunkK;
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
  consume_layer<C, WP, WP, 0>(acc, frag, bias, p.P, it, smem, full, empty, wg, q);
  epilogue<WP, true>(acc, frag);
  bias += WP;
  for (int i = 0; i < p.n_layers - 1; ++i) {
    consume_layer<C, WP, WP, kActChunks>(acc, frag, bias, ((p.skip_mask >> i) & 1u) ? p.P : 0,
                                         it, smem, full, empty, wg, q);
    epilogue<WP, true>(acc, frag);
    bias += WP;
  }
  consume_layer<C, WP, WP, kActChunks>(acc, frag, bias, 0, it, smem, full, empty, wg, q);
  epilogue<WP, false>(acc, frag);
  head<WP, 1>(frag, hw_sigma, q, sig_top, sig_bot);
  const int row = t * kTileRows + wg * 64 + r + (q == 1 ? 8 : 0);
  if (q < 2 && row < p.N) p.y[(size_t)row * 4 + 3] = (q == 0 ? sig_top[0] : sig_bot[0]) + hb[3];
  bias += WP;
  consume_layer<C, WP, WP / 2, kActChunks>(acc, frag, bias, p.use_dir ? p.Dc : 0, it, smem,
                                           full, empty, wg, q);
  epilogue<WP / 2, false>(acc, frag);
  bias += WP / 2;
  consume_layer<C, WP, WP / 2, kActChunks / 2>(acc, frag, bias, 0, it, smem, full, empty, wg, q);
  epilogue<WP / 2, true>(acc, frag);
  head<WP / 2, 3>(frag, hw_rgb, q, rgb_top, rgb_bot);
  if (q < 2 && row < p.N) {
#pragma unroll
    for (int o = 0; o < 3; ++o)
      p.y[(size_t)row * 4 + o] = (q == 0 ? rgb_top[o] : rgb_bot[o]) + hb[o];
  }
}

// The block's shared memory, 1024-aligned for the swizzled operands.
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

template <class C>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The body of a forward kernel (B, D): y = RenderRayNet(x) for every tile.
template <int WP, class Src>
__device__ __forceinline__ void forward_body(const Net& p) {
  using C = Cfg<WP, Src::kExtraBytes>;
  unsigned char* smem = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int tiles = (p.N + kTileRows - 1) / kTileRows;
  init_ring<C>(full, empty);

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_dealloc<kProducerRegs>();
    const int pt = tid - 256;
    Src src;
    src.start(p, smem + C::kExtraOff, pt);
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      src.begin_tile(p, t, pt);
      produce_forward<WP, C>(p, t, src, it, smem, full, empty, pt);
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<kConsumerRegs>();
    float acc[WP / 2] = {};
    uint32_t frag[WP / 4] = {};
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r = warp * 16 + lane / 4, q = lane % 4;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      consume_forward<WP, C>(p, t, acc, frag, it, smem, full, empty, wg, r, q);
  }
}

// B's and C's A chunks from raw rows [prefix (add) | xyz | dir]. The
// prefix+pos block is [bf16(prefix) | pos encoding], the dir block the dir
// encoding. The producer thread pt encodes row pt of the tile: its six
// coordinates sit in registers, the next tile's loaded while this one is
// produced. A chunk of prefix columns alone is copied with the producer's
// threads spread along rows instead, so that a warp reads 64 neighbouring
// floats of one row; the chunk that straddles the prefix's end reads its
// prefix columns row by row (rows are not 16-byte aligned: add + 6 floats).
struct EncodeSrc {
  static constexpr int kExtraBytes = 0;
  float cur[6], nxt[6];

  __device__ __forceinline__ void load(const Net& p, int t, float* dst, int pt) {
    const int row = t * kTileRows + pt;
    const bool in = row < p.N;   // also false past the last tile
    const float* src = p.x + (size_t)(in ? row : 0) * p.in_dim + p.add;
#pragma unroll
    for (int e = 0; e < 6; ++e) dst[e] = in ? __ldg(src + e) : 0.f;
  }

  __device__ __forceinline__ void start(const Net& p, unsigned char*, int pt) {
    load(p, blockIdx.x, nxt, pt);
  }

  __device__ __forceinline__ void begin_tile(const Net& p, int t, int pt) {
#pragma unroll
    for (int e = 0; e < 6; ++e) cur[e] = nxt[e];
    load(p, t + gridDim.x, nxt, pt);
  }

  // Prefix columns [c0, c0 + 64) of tile t (all below add), rounded to bf16
  // into the swizzled chunk, and with `store` into enc_out too; zeros for
  // rows past N.
  __device__ __forceinline__ void copy_prefix(const Net& p, int t, int c0, unsigned char* a,
                                              bool store, int pt) {
#pragma unroll 2
    for (int i = pt; i < kTileRows * kChunkK / 2; i += kProducerThreads) {
      const int row = i >> 5, col = (i & 31) * 2;
      const int grow = t * kTileRows + row;
      float lo = 0.f, hi = 0.f;
      if (grow < p.N) {
        const float* src = p.x + (size_t)grow * p.in_dim + c0 + col;
        lo = __ldg(src);
        hi = __ldg(src + 1);
      }
      const uint32_t v = pack_bf16(lo, hi);
      *reinterpret_cast<uint32_t*>(a + swizzle128(row, col)) = v;
      if (store && grow < p.N)
        *reinterpret_cast<uint32_t*>(p.enc_out + (size_t)grow * p.enc_ld + c0 + col) = v;
    }
  }

  // A chunk j of tile t: the pos or dir block's 64 columns cc * 64 .. into
  // the swizzled chunk; with enc_out, the block's first use also goes to
  // device memory. Columns of an encoding are bf16(sin(encoding_arg)), zero
  // past the block (padding columns meet zero weight rows).
  __device__ __forceinline__ void fill(const Net& p, int t, int j, unsigned char* a, int pt) {
    bool is_dir;
    int cc;
    a_chunk(p, j, is_dir, cc);
    const bool store = p.enc_out != nullptr && (is_dir || j < p.P);
    const int c0 = cc * kChunkK;
    const bool prefix = !is_dir && c0 < p.add;
    if (prefix && c0 + kChunkK <= p.add) {
      copy_prefix(p, t, c0, a, store, pt);
      return;
    }
    const int lead = is_dir ? 0 : p.add;
    const int cols = is_dir ? p.dir_dim : p.pos_block;
    const float x0 = is_dir ? cur[3] : cur[0], x1 = is_dir ? cur[4] : cur[1],
                x2 = is_dir ? cur[5] : cur[2];
    const int row = t * kTileRows + pt;
    __nv_bfloat16* out = nullptr;
    if (store && row < p.N)
      out = p.enc_out + (size_t)row * p.enc_ld + (is_dir ? p.P * kChunkK : 0) + c0;
    if (prefix) {
      // the chunk that straddles the prefix's end: the row's own prefix
      // columns, then its encoding; one chunk per use of the block, left
      // rolled, which keeps the producer within its registers
      const float* xr = p.x + (size_t)(row < p.N ? row : 0) * p.in_dim;
#pragma unroll 1
      for (int g = 0; g < 8; ++g) {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float f[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = c0 + 8 * g + 2 * e + h;
            f[h] = c < lead ? (row < p.N ? __ldg(xr + c) : 0.f)
                 : c < cols ? sinf(fused_mlp::encoding_arg(x0, x1, x2, c - lead)) : 0.f;
          }
          v[e] = pack_bf16(f[0], f[1]);
        }
        const uint4 chunk = make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(a + swizzle128(pt, 8 * g)) = chunk;
        if (out != nullptr) *reinterpret_cast<uint4*>(out + 8 * g) = chunk;
      }
      return;
    }
#pragma unroll 2
    for (int g = 0; g < 8; ++g) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 - lead + 8 * g + 2 * e;     // the encoding's column
        const float lo = c < cols - lead ? sinf(fused_mlp::encoding_arg(x0, x1, x2, c)) : 0.f;
        const float hi =
            c + 1 < cols - lead ? sinf(fused_mlp::encoding_arg(x0, x1, x2, c + 1)) : 0.f;
        v[e] = pack_bf16(lo, hi);
      }
      const uint4 chunk = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(a + swizzle128(pt, 8 * g)) = chunk;
      if (out != nullptr) *reinterpret_cast<uint4*>(out + 8 * g) = chunk;
    }
  }
};

// Launch `kernel` on a persistent grid: one block per SM, at most one per tile.
template <typename... Args>
inline int launch_persistent(void (*kernel)(Args...), int smem, int tiles, cudaStream_t stream,
                             Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  kernel<<<tiles < sms ? tiles : sms, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace render_net
