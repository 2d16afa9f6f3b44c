// Fused RenderRayNet v2 backward on Hopper (sm_90a): dX and every dW and db of
// the net for raw rows x [N, add + 6] (prefix || xyz || dir) and the output
// cotangent g [N, 4].
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/fused_mlp_v2.py:_pallas_backward
// (jax.vjp of `_tile_forward` per 256-row tile, dW summed over tiles). Plain
// version: smpl_nerf_tpu_torch/ops/fused_mlp_v2.py:reference_backward_raw.
//
//   forward as fused_mlp_v2_fwd.cu, every layer's bf16 output H kept;
//   rgb head:   dY = bf16(g[:, :3] @ Wrgb^T) * (H > 0)
//   each dense layer, last to first:  dW = A^T @ dY,  db = sum_rows(dY),
//       dH = bf16(dY @ W^T), times (H > 0) where H came out of a ReLU; the
//       columns of dH that belong to a concatenated encoding add into
//       d pos / d dir (bf16 adds);
//   sigma head: dY(additional) = bf16(dH + bf16(g[:, 3] * Wsig^T))
//   dX[:, j] = sum_k d enc[:, col(k, j)] * cos(arg(k, j)) * 2^k   (float32)
//   dX[:, :add] = d prefix: the bf16 sum of the first layer's and each skip
//       layer's cotangent on the prefix rows, as float32 (the VJP of the
//       prefix's bf16 rounding: no cos, no 2^k)
// The roundings are those of jax.vjp through `_tile_forward`: a cotangent that
// reaches a bf16 value is rounded to bf16 (so every dY of a dense layer is
// exactly bf16 and the tensor-core products lose nothing), and the dW of each
// 256-row tile (_TILE_BWD) is rounded to bf16 before the float32 sum over
// tiles; db and the heads' sums stay float32.
//
// What bounds it on the H100: three times the forward's tensor-core
// operations (the recompute, the dH chain, the dW products): 3 x 2 x 607,872
// FLOP per sample at W = 256, 0.48 ms at 131,072 rows (3 x 2 x 925,824 with
// the 621-wide prefix of append_smpl_params: 0.74 ms). This design adds bytes
// the bound does not count: every layer's input H and cotangent dY go through
// device memory once (10,496 B per row at W = 256, written and read: ~0.8 ms
// of memory time at 131,072 rows; the prefix adds 1,280 B of bf16 prefix
// columns to the scratch row).
//
// Three launches, no atomics, so dX, dW and db are the same bits on every run:
//  1. fused_mlp_v2_bwd_kernel: the mainloop of render_net.cuh per 128-row
//     tile (persistent grid, the pack_weights_d chunk ring, two consumer
//     warpgroups, B's encoding producer). After the forward (heads skipped)
//     the producer streams the same chunk images again, last layer first,
//     and the consumers run the dH chain; W^T is the chunk image read through
//     wgmma's transpose bit (its 128-byte lines are the contraction, each
//     chunk gives 64 whole columns of dH): no second weight pack. Each
//     layer's output H and cotangent dY is rounded into the warpgroup's
//     128B-swizzled staging tile, stored from there to a row-major bf16
//     scratch [N, ld] by TMA, and read from there by the next layer's wgmma
//     as its A operand, so only the accumulators live in registers (A from
//     registers, as in B, leaves no room here for the stores and the
//     backward). The tile's encodings (with the bf16 prefix) go to the
//     scratch too; the ReLU bits wait in a per-block buffer and d pos / d
//     dir in a per-block bf16 buffer (both stay in L2); dX is written at the
//     end of the tile.
//     A conditioning prefix is the leading columns of the prefix+pos block
//     (kernel D's pack), so its cotangent gathers in that block's share of
//     the d-encoding buffer like d pos: at add = 621 the buffer is 12 chunks
//     wide, 196 KB per block, 26 MB for 132 blocks, which L2 holds. The
//     other way, d prefix as a GEMM of the stored cotangents against the
//     prefix rows of the first and skip layers' weights after the chain,
//     would re-read dY from the scratch and need a launch and a reduction of
//     its own for what the chain already computes (the dH chain's products
//     on the encoding rows give d prefix with the same bf16 adds), so the
//     buffer stays.
//  2. fused_mlp_v2_dw_kernel: dW = A^T @ dY of every layer as a split-K
//     GEMM over the rows: a unit is (split of rows, 128 x 128 tile of one
//     layer's dW). A TMA producer lands 64-row boxes of A and dY from the
//     scratch; both are M/N-major, read by wgmma through its transpose bits.
//     Each 256-row slice's product is rounded to bf16 and added in float32
//     registers; units of a layer's first row of tiles also sum db from the
//     dY boxes. After them, one unit per 256-row slice does the float32 heads
//     (dW rounded per slice as above, db) on CUDA cores. Each unit writes its
//     own partial sums.
//  3. fused_mlp_v2_dw_reduce_kernel: the partials summed over the splits (and
//     the heads' over the slices) in a fixed order into the gradient buffer.
// Gradient buffer layout (ops/fused_mlp_v2.py:grad_layout): every dense layer
// of d_layout as float32 [K_pad, N_pad] (plain, not swizzled), then each
// layer's db [N_pad], then the heads as in pack_weights_d's heads.
// Rows past N read zeros for x and g, so they add nothing and store nothing.
// sinf / cosf, never __sinf / __cosf: the argument reaches 2^(L-1) * |x|.
#include "render_net.cuh"

namespace {

using namespace render_net;
typedef __nv_bfloat16 bf16;

constexpr int kSlice = 256;      // rows per bf16-rounded dW partial (JAX's _TILE_BWD)
constexpr int kDwStages = 5;
constexpr int kBox = 64 * 128;   // a 64-row x 64-column bf16 TMA box
constexpr int kDwStageBytes = 4 * kBox;
constexpr int kDwSmem = kDwStages * kDwStageBytes + 2 * 128 * 4 + 2 * kDwStages * 8 + 1024;

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// ------------------------------------------------------------ the geometry

struct Geo {
  int N, WP, n, P, Dc, use_dir;
  unsigned skip_mask;
  int ld;            // scratch row pitch (elements)
};

// Dense layer l of d_layout (0 = positions_pose_input, 1..n-1 the trunk,
// n additional_linear_layer, n+1 directional_input, n+2 directional_net_0):
// rows of K from the previous layer's H (k_act) and from an encoding block
// (k_enc, the dir block for l = n+1), and its N.
__host__ __device__ __forceinline__ void layer_dims(const Geo& g, int l, int& k_act, int& k_enc,
                                                    int& n_out) {
  k_act = l == 0 ? 0 : (l == g.n + 2 ? g.WP / 2 : g.WP);
  k_enc = l == 0 ? 64 * g.P
        : l < g.n ? (((g.skip_mask >> (l - 1)) & 1u) ? 64 * g.P : 0)
        : l == g.n + 1 ? (g.use_dir ? 64 * g.Dc : 0) : 0;
  n_out = l <= g.n ? g.WP : g.WP / 2;
}

// Scratch columns: [enc pos (64 P) | enc dir (64 Dc) | H_0 .. H_{n+2} | dY_0 .. dY_{n+2}].
__host__ __device__ __forceinline__ int h_col(const Geo& g, int l) {
  return 64 * (g.P + g.Dc) + g.WP * min(l, g.n + 1) + (g.WP / 2) * max(0, l - (g.n + 1));
}
__host__ __device__ __forceinline__ int dy_col(const Geo& g, int l) {
  return h_col(g, g.n + 3) + h_col(g, l) - h_col(g, 0);
}
__host__ __device__ __forceinline__ int scratch_ld(const Geo& g) { return dy_col(g, g.n + 3); }

// Scratch column of row m of layer l's input (A^T's row m of dW).
__host__ __device__ __forceinline__ int in_col(const Geo& g, int l, int m) {
  int k_act, k_enc, n_out;
  layer_dims(g, l, k_act, k_enc, n_out);
  if (m < k_act) return h_col(g, l - 1) + m;
  return (l == g.n + 1 ? 64 * g.P : 0) + m - k_act;
}

// Float32 gradients of one split (and of the result): dW blocks, db, heads.
__host__ __device__ __forceinline__ void grad_sizes(const Geo& g, long long& dw, int& db,
                                                    int& tiles) {
  dw = 0;
  db = 0;
  tiles = 0;
  for (int l = 0; l <= g.n + 2; ++l) {
    int k_act, k_enc, n_out;
    layer_dims(g, l, k_act, k_enc, n_out);
    dw += (long long)(k_act + k_enc) * n_out;
    db += n_out;
    tiles += ((k_act + k_enc + 127) / 128) * ((n_out + 127) / 128);
  }
}

__host__ __device__ __forceinline__ int head_grads(int WP) { return WP + 3 * (WP / 2) + 4; }

// ------------------------------------------------- phase 1: forward + dH chain

struct Bwd {
  Net net;
  Geo geo;
  const float* g;          // [N, 4]
  float* dx;               // [N, add + 6]
  bf16* scratch;           // [N, ld]
  uint32_t* masks;         // per block: [n][WP / 64][256] ReLU bits of the trunk's outputs
  bf16* denc;              // per block: [128][64 (P + Dc)] d pos || d dir
};

// Producer: the chunk images of the backward, last layer first, each layer's
// encoding chunks before its activation chunks.
template <int WP, class C>
__device__ __forceinline__ void produce_backward(const Net& p, int& it, unsigned char* smem,
                                                 uint64_t* full, uint64_t* empty, int pt) {
  constexpr int A = WP / kChunkK;
  const int n = p.n_layers;
  auto produce = [&](size_t off, int bytes) {
    acquire_stage<C>(it, smem, full, empty, p.w + off, bytes, pt);
    mbar_arrive(&full[it % C::kStages]);
    ++it;
  };
  const size_t off_add =
      (size_t)C::kWBytes * (p.P + (n - 1) * A + p.P * __popc(p.skip_mask));
  const size_t off_di = off_add + (size_t)C::kWBytes * A;
  const size_t off_dn0 = off_di + (size_t)C::kHBytes * (A + (p.use_dir ? p.Dc : 0));
  for (int c = 0; c < A / 2; ++c) produce(off_dn0 + (size_t)c * C::kHBytes, C::kHBytes);
  if (p.use_dir)
    for (int c = 0; c < p.Dc; ++c) produce(off_di + (size_t)(A + c) * C::kHBytes, C::kHBytes);
  for (int c = 0; c < A; ++c) produce(off_di + (size_t)c * C::kHBytes, C::kHBytes);
  for (int c = 0; c < A; ++c) produce(off_add + (size_t)c * C::kWBytes, C::kWBytes);
  for (int l = n - 1; l >= 1; --l) {             // positional_net_{l-1}
    const unsigned below = p.skip_mask & ((1u << (l - 1)) - 1u);
    const size_t off = (size_t)C::kWBytes * (p.P + (l - 1) * A + p.P * __popc(below));
    if ((p.skip_mask >> (l - 1)) & 1u)
      for (int c = 0; c < p.P; ++c) produce(off + (size_t)(A + c) * C::kWBytes, C::kWBytes);
    for (int c = 0; c < A; ++c) produce(off + (size_t)c * C::kWBytes, C::kWBytes);
  }
  for (int c = 0; c < p.P; ++c) produce((size_t)c * C::kWBytes, C::kWBytes);   // layer 0
}

// The consumers keep almost nothing live beside the accumulators and the A
// fragments (at W = 256 those two take 192 of the 224 registers): every
// address below is rebuilt from the kernel's parameters where it is used.

// Consumer: the first NC columns of frag to scratch columns [col, col + NC)
// of the warpgroup's 64 rows (from row0), through its 128B-swizzled staging
// tile and TMA stores of 64 x 64 boxes (rows past N are not written). The
// warpgroup's last stores must have read the staging tile before it is
// written again.
template <int NC>
__device__ __forceinline__ void stage_store(const CUtensorMap* tmap, unsigned char* staging,
                                            const uint32_t* frag, int col, int row0) {
  const int lt = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int r = (lt / 32) * 16 + (lt % 32) / 4, q = lt % 4;
  if (lt == 0) bulk_wait_read();
  named_sync(1 + wg, 128);
  // rows r and r + 8 share r % 8; opaque, so that the compiler cannot hoist
  // a swizzled address per column out of the tile loop and hold them all
  uint32_t r7 = r & 7;
  asm volatile("" : "+r"(r7));
  unsigned char* line = staging + r * 128 + 4 * q;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    unsigned char* at = line + (j / 8) * (64 * 128) + (((j & 7) ^ r7) << 4);
    *reinterpret_cast<uint32_t*>(at) = frag[4 * (j / 2) + 2 * (j % 2)];
    *reinterpret_cast<uint32_t*>(at + 8 * 128) = frag[4 * (j / 2) + 2 * (j % 2) + 1];
  }
  fence_async_shared();
  named_sync(1 + wg, 128);
  if (lt == 0) {
#pragma unroll
    for (int bx = 0; bx < NC / 64; ++bx)
      tma_store_2d(tmap, staging + bx * (64 * 128), col + 64 * bx, row0);
    bulk_commit();
  }
}

// The thread's word w of trunk layer l's ReLU bits in the block's buffer.
__device__ __forceinline__ uint32_t* mask_word(const Bwd& b, int l, int w, int ct) {
  return b.masks + (((size_t)blockIdx.x * b.net.n_layers + l) * (b.geo.WP / 64) + w) * 256 + ct;
}

// Row `row` (of the tile's 128) of the block's d-encoding buffer.
__device__ __forceinline__ bf16* denc_row(const Bwd& b, int row) {
  return b.denc + ((size_t)blockIdx.x * kTileRows + row) * 64 * (b.net.P + b.net.Dc);
}

// Consumer: ReLU and round to bf16 into frag, and the ReLU's bits (which
// outputs are > 0) into trunk layer l's mask words.
template <int N>
__device__ __forceinline__ void epilogue_relu_mask(const Bwd& b, const float* acc, uint32_t* frag,
                                                   int l, int ct) {
#pragma unroll
  for (int w = 0; w < N / 64; ++w) {
    uint32_t bits = 0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * w + jj;
      float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bits |= (v[e] > 0.f ? 1u : 0u) << (4 * jj + e);
        v[e] = v[e] < 0.f ? 0.f : v[e];     // keeps NaN, as relu does
      }
      frag[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(v[0], v[1]);
      frag[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(v[2], v[3]);
    }
    *mask_word(b, l, w, ct) = bits;
  }
}

// Consumer: dY = bf16(acc) where trunk layer l's ReLU let the value through,
// else 0, into frag.
template <int N>
__device__ __forceinline__ void epilogue_masked(const Bwd& b, const float* acc, uint32_t* frag,
                                                int l, int ct) {
#pragma unroll
  for (int w = 0; w < N / 64; ++w) {
    const uint32_t bits = *mask_word(b, l, w, ct);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * w + jj;
      const uint32_t m = bits >> (4 * jj);
      frag[4 * (j / 2) + 2 * (j % 2)] =
          pack_bf16((m & 1u) ? acc[4 * j] : 0.f, (m & 2u) ? acc[4 * j + 1] : 0.f);
      frag[4 * (j / 2) + 2 * (j % 2) + 1] =
          pack_bf16((m & 4u) ? acc[4 * j + 2] : 0.f, (m & 8u) ? acc[4 * j + 3] : 0.f);
    }
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Consumer: d enc += bf16(acc) with bf16 adds, for the thread's elements of a
// 64-column chunk (an n64 accumulator) at column `col` of the block's buffer.
__device__ __forceinline__ void add_denc(const Bwd& b, const float* acc, int row, int col,
                                         int q) {
  const int E = 64 * (b.net.P + b.net.Dc);
  bf16* top = denc_row(b, row) + col + 2 * q;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t* t = reinterpret_cast<uint32_t*>(top + 8 * j);
    uint32_t* u = reinterpret_cast<uint32_t*>(top + 8 * E + 8 * j);
    const float2 ot = unpack_bf16(*t), ou = unpack_bf16(*u);
    *t = pack_bf16(ot.x + bf16r(acc[4 * j]), ot.y + bf16r(acc[4 * j + 1]));
    *u = pack_bf16(ou.x + bf16r(acc[4 * j + 2]), ou.y + bf16r(acc[4 * j + 3]));
  }
}

// Consumer: the backward of one dense layer of NL outputs whose dY is in the
// warpgroup's staging tile (swizzled K-major, as stage_store left it): n_enc
// chunks of its encoding rows first (each 64 columns of d enc, added at
// column enc_col + 64 c of the block's buffer), then NA chunks of its
// activation rows into acc (dH, NA x 64 columns). Both operands come from
// shared memory, so only the accumulators take registers. W^T is the chunk
// image through the transpose bit: its NL lines are the contraction.
template <class C, int NL, int NA>
__device__ __forceinline__ void consume_bwd(const Bwd& b, float* acc, const unsigned char* dys,
                                            int n_enc, int enc_col, int row, int& it,
                                            unsigned char* smem, uint64_t* full, uint64_t* empty,
                                            int q) {
  constexpr int KS = NL / 16;
  // the KS k-steps of one chunk: dY's 16 columns of the 64-column box ks / 4
  // and 16 lines of the image. The descriptors advance by adding to their
  // start-address field (address / 16), one live pair at a time: KS pairs
  // computed up front would hold 4 KS registers beside the accumulators.
  auto chunk = [&](float* d, const unsigned char* wst) {
    uint64_t da = desc_sw128(dys, 16, 1024), dw = desc_sw128(wst, 8192, 1024);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wgmma_ss<64, 1>(d, da, dw, 1);
      da += (ks % 4 == 3) ? (64 * 128 - 3 * 32) / 16 : 32 / 16;
      dw += 2048 / 16;
      asm volatile("" : "+l"(da), "+l"(dw));
    }
  };
  for (int c = 0; c < n_enc; ++c, ++it) {
    const int s = it % C::kStages;
    mbar_wait(&full[s], (it / C::kStages) & 1);
    const unsigned char* wst = smem + s * C::kStageBytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(acc[i]);
    wgmma_fence();
    chunk(acc, wst);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(acc[i]);
    mbar_arrive(&empty[s]);
    add_denc(b, acc, row, enc_col + 64 * c, q);
  }
  if (NA == 0) return;
  const int first = it;
#pragma unroll
  for (int c = 0; c < NA; ++c, ++it) {
    const int s = it % C::kStages;
    mbar_wait(&full[s], (it / C::kStages) & 1);
    const unsigned char* wst = smem + s * C::kStageBytes;
    // from zeros with scale_d = 1: a first wgmma that overwrites (scale_d = 0)
    // makes ptxas serialise the chunks
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * c + i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(acc[32 * c + i]);
    wgmma_fence();
    chunk(acc + 32 * c, wst);
    wgmma_commit();
    if (it > first) {
      wgmma_wait<1>();
      mbar_arrive(&empty[(it - 1) % C::kStages]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32 * NA; ++i) reg_fence(acc[i]);
  mbar_arrive(&empty[(it - 1) % C::kStages]);
}

// Consumer: one forward layer, N output columns, acc = bias + A @ W, as
// render_net.cuh's consume_layer but with the previous activations (NA
// chunks of K) read from the warpgroup's staging tile, where stage_store left
// them, instead of from registers; then nx A chunks of the ring stage.
template <class C, int N, int NA>
__device__ __forceinline__ void consume_layer_smem(float* acc, const unsigned char* act,
                                                   const float* bias, int nx, int& it,
                                                   unsigned char* smem, uint64_t* full,
                                                   uint64_t* empty, int wg, int q) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * q));
    acc[4 * j] = acc[4 * j + 2] = b.x;
    acc[4 * j + 1] = acc[4 * j + 3] = b.y;
  }
  const int first = it;
  for (int c = 0; c < NA + nx; ++c, ++it) {
    const int s = it % C::kStages;
    mbar_wait(&full[s], (it / C::kStages) & 1);
    const unsigned char* wst = smem + s * C::kStageBytes;
    const unsigned char* a = c < NA ? act + c * (64 * 128) : wst + C::kWBytes + wg * (64 * 128);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reg_fence(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kChunkK / 16; ++ks)
      wgmma_ss<N, 0>(acc, desc_sw128(a + 32 * ks, 16, 1024), desc_sw128(wst + 32 * ks, 16, 1024),
                     1);
    wgmma_commit();
    if (it > first) {
      wgmma_wait<1>();
      mbar_arrive(&empty[(it - 1) % C::kStages]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) reg_fence(acc[i]);
  mbar_arrive(&empty[(it - 1) % C::kStages]);
}

// Consumer: one tile, forward then backward, then dX. `row` is the thread's
// first row within the tile (wg * 64 + r; the other is row + 8).
template <int WP, class C>
__device__ __forceinline__ void consume_tile(const Bwd& b, const CUtensorMap* tmap, int t,
                                             float* acc, uint32_t* frag, int& it,
                                             unsigned char* smem, uint64_t* full,
                                             uint64_t* empty, int wg, int row, int q, int ct) {
  constexpr int A = WP / kChunkK;
  const Net& p = b.net;
  const Geo& geo = b.geo;
  const int n = p.n_layers;
  const int row_top = t * kTileRows + row;
  const int row0 = t * kTileRows + 64 * wg;
  unsigned char* staging = smem + C::kExtraOff + wg * (64 * WP * 2);
  // loop-invariant pointers stay opaque, so that nothing is hoisted out of
  // the tile loop into registers held through it (as in consume_forward)
  const float* bias = p.bias;
  asm volatile("" : "+l"(bias));

  // ---- forward: every layer's H to the scratch, the trunk's ReLU bits kept;
  // the staging tile holds the previous layer's H, the next layer's A
  consume_layer_smem<C, WP, 0>(acc, staging, bias, p.P, it, smem, full, empty, wg, q);
  epilogue_relu_mask<WP>(b, acc, frag, 0, ct);
  stage_store<WP>(tmap, staging, frag, h_col(geo, 0), row0);
  bias += WP;
  for (int i = 0; i < n - 1; ++i) {
    consume_layer_smem<C, WP, A>(acc, staging, bias, ((p.skip_mask >> i) & 1u) ? p.P : 0, it,
                                 smem, full, empty, wg, q);
    epilogue_relu_mask<WP>(b, acc, frag, i + 1, ct);
    stage_store<WP>(tmap, staging, frag, h_col(geo, i + 1), row0);
    bias += WP;
  }
  consume_layer_smem<C, WP, A>(acc, staging, bias, 0, it, smem, full, empty, wg, q);
  epilogue<WP, false>(acc, frag);
  stage_store<WP>(tmap, staging, frag, h_col(geo, n), row0);
  bias += WP;
  consume_layer_smem<C, WP / 2, A>(acc, staging, bias, p.use_dir ? p.Dc : 0, it, smem, full,
                                   empty, wg, q);
  epilogue<WP / 2, false>(acc, frag);
  stage_store<WP / 2>(tmap, staging, frag, h_col(geo, n + 1), row0);
  bias += WP / 2;
  consume_layer_smem<C, WP / 2, A / 2>(acc, staging, bias, 0, it, smem, full, empty, wg, q);
  epilogue<WP / 2, true>(acc, frag);
  stage_store<WP / 2>(tmap, staging, frag, h_col(geo, n + 2), row0);

  // ---- backward. The thread's words of d enc start at 0.
  {
    const int E = 64 * (p.P + p.Dc);
    uint32_t* top = reinterpret_cast<uint32_t*>(denc_row(b, row));
    for (int c = q; c < E / 2; c += 4) top[c] = top[4 * E + c] = 0u;
  }
  const float4* g4 = reinterpret_cast<const float4*>(b.g);
  // rgb head: dY(directional_net_0) = bf16(g[:, :3] @ Wrgb^T) * (H > 0)
  {
    const float4 gt = row_top < p.N ? __ldg(g4 + row_top) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 gb = row_top + 8 < p.N ? __ldg(g4 + row_top + 8) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* hw_rgb = p.heads + WP;
#pragma unroll
    for (int j = 0; j < WP / 16; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 ht = unpack_bf16(frag[4 * (j / 2) + 2 * (j % 2)]);
      const float2 hb = unpack_bf16(frag[4 * (j / 2) + 2 * (j % 2) + 1]);
      float v[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float w0 = __ldg(hw_rgb + (c + e) * 3), w1 = __ldg(hw_rgb + (c + e) * 3 + 1),
                    w2 = __ldg(hw_rgb + (c + e) * 3 + 2);
        v[e] = bf16r(fmaf(gt.z, w2, fmaf(gt.y, w1, gt.x * w0)));
        v[2 + e] = bf16r(fmaf(gb.z, w2, fmaf(gb.y, w1, gb.x * w0)));
      }
      frag[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(ht.x > 0.f ? v[0] : 0.f, ht.y > 0.f ? v[1] : 0.f);
      frag[4 * (j / 2) + 2 * (j % 2) + 1] =
          pack_bf16(hb.x > 0.f ? v[2] : 0.f, hb.y > 0.f ? v[3] : 0.f);
    }
  }
  stage_store<WP / 2>(tmap, staging, frag, dy_col(geo, n + 2), row0);
  // directional_net_0: dY(directional_input) = bf16(dY @ W^T)  (no ReLU there)
  consume_bwd<C, WP / 2, A / 2>(b, acc, staging, 0, 0, row, it, smem, full, empty, q);
  epilogue<WP / 2, false>(acc, frag);
  stage_store<WP / 2>(tmap, staging, frag, dy_col(geo, n + 1), row0);
  // directional_input: d dir, then dH(additional) plus the sigma head's share
  consume_bwd<C, WP / 2, A>(b, acc, staging, p.use_dir ? p.Dc : 0, 64 * p.P, row, it, smem,
                                full, empty, q);
  {
    // volatile loads: ptxas would hoist ordinary ones, and the 64 bf16(g * w)
    // products made from them, into the wgmmas above, and spill 17 registers
    const volatile float* gv = b.g;
    const float gt = row_top < p.N ? gv[(size_t)row_top * 4 + 3] : 0.f;
    const float gb = row_top + 8 < p.N ? gv[(size_t)(row_top + 8) * 4 + 3] : 0.f;
    const volatile float* hw_sigma = p.heads;
#pragma unroll
    for (int j = 0; j < WP / 8; ++j) {
      const float2 w = make_float2(hw_sigma[8 * j + 2 * q], hw_sigma[8 * j + 2 * q + 1]);
      frag[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(bf16r(acc[4 * j]) + bf16r(gt * w.x),
                                                  bf16r(acc[4 * j + 1]) + bf16r(gt * w.y));
      frag[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(bf16r(acc[4 * j + 2]) + bf16r(gb * w.x),
                                                      bf16r(acc[4 * j + 3]) + bf16r(gb * w.y));
    }
  }
  stage_store<WP>(tmap, staging, frag, dy_col(geo, n), row0);
  // additional_linear_layer, then the trunk: dY(l - 1) = bf16(dY(l) @ W_l^T) * (H_{l-1} > 0)
  for (int l = n; l >= 1; --l) {
    const int n_enc = (l < n && ((p.skip_mask >> (l - 1)) & 1u)) ? p.P : 0;
    consume_bwd<C, WP, A>(b, acc, staging, n_enc, 0, row, it, smem, full, empty, q);
    epilogue_masked<WP>(b, acc, frag, l - 1, ct);
    stage_store<WP>(tmap, staging, frag, dy_col(geo, l - 1), row0);
  }
  // positions_pose_input: its rows are all encoding
  consume_bwd<C, WP, 0>(b, acc, staging, p.P, 0, row, it, smem, full, empty, q);

  // ---- dX: the prefix columns are d prefix itself, written by the thread
  // that holds them; each coordinate sums d enc * cos(arg) * 2^k over the
  // thread's columns, then the quad
  float d[2][6] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int grow = row_top + 8 * h;
    const float* xr = p.x + (size_t)(grow < p.N ? grow : 0) * p.in_dim + p.add;
    float x[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) x[e] = grow < p.N ? __ldg(xr + e) : 0.f;
    const bf16* de = denc_row(b, row + 8 * h);
    float* dx_prefix = b.dx + (size_t)(grow < p.N ? grow : 0) * p.in_dim;
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      if (blk == 1 && !p.use_dir) continue;   // no directional input: d dir stays 0
      const int chunks = blk == 0 ? p.P : p.Dc, cols = blk == 0 ? p.pos_block : p.dir_dim;
      const int lead = blk == 0 ? p.add : 0;
      const float x0 = blk ? x[3] : x[0], x1 = blk ? x[4] : x[1], x2 = blk ? x[5] : x[2];
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int cc = 0; cc < chunks; ++cc) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 64 * cc + 8 * j + 2 * q + e;
            if (c < lead) {
              if (grow < p.N) dx_prefix[c] = __bfloat162float(de[c]);
            } else if (c < cols) {
              const int ce = c - lead;
              const float v = __bfloat162float(de[(blk ? 64 * p.P : 0) + c]) *
                              cosf(fused_mlp::encoding_arg(x0, x1, x2, ce)) *
                              (float)(1 << (ce / 6));
              const int coord = (ce % 6) % 3;
              if (coord == 0) s0 += v;
              else if (coord == 1) s1 += v;
              else s2 += v;
            }
          }
        }
      }
      d[h][3 * blk] = s0;
      d[h][3 * blk + 1] = s1;
      d[h][3 * blk + 2] = s2;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      d[h][e] += __shfl_xor_sync(0xffffffffu, d[h][e], 1);
      d[h][e] += __shfl_xor_sync(0xffffffffu, d[h][e], 2);
    }
  const int grow = row_top + (q == 1 ? 8 : 0);
  if (q < 2 && grow < p.N) {
#pragma unroll
    for (int e = 0; e < 6; ++e)
      b.dx[(size_t)grow * p.in_dim + p.add + e] = q == 0 ? d[0][e] : d[1][e];
  }
}

template <int WP>
using BwdCfg = Cfg<WP, 2 * 64 * WP * 2>;   // the ring, then a staging tile per consumer warpgroup

template <int WP>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_v2_bwd_kernel(const __grid_constant__ CUtensorMap tmap, const Bwd b) {
  using C = BwdCfg<WP>;
  const Net& p = b.net;
  unsigned char* smem = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int tiles = (p.N + kTileRows - 1) / kTileRows;
  init_ring<C>(full, empty);

  if (wg == 2) {
    regs_dealloc<kProducerRegs>();
    const int pt = tid - 256;
    EncodeSrc src;
    src.start(p, nullptr, pt);
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      src.begin_tile(p, t, pt);
      produce_forward<WP, C>(p, t, src, it, smem, full, empty, pt);
      produce_backward<WP, C>(p, it, smem, full, empty, pt);
    }
  } else {
    regs_alloc<kConsumerRegs>();
    float acc[WP / 2] = {};
    uint32_t frag[WP / 4] = {};
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row = wg * 64 + warp * 16 + lane / 4, q = lane % 4;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      consume_tile<WP, C>(b, &tmap, t, acc, frag, it, smem, full, empty, wg, row, q, tid);
    if (tid % 128 == 0) bulk_wait();
  }
}

// ------------------------------------------------------------ phase 2: dW

struct Dw {
  Geo geo;
  const bf16* scratch;
  const float* g;
  float* partial;      // [S][dw_total + db_total]: each split's dW and db
  float* heads_part;   // [slices][head_grads]: each slice's heads
  long long dw_total;
  int db_total;
  int slices, sps, S, tiles;  // 256-row slices, slices per split, splits, dW tiles per split
};

// dW tile `tile` of a split: layer l's [m0, m0 + tm) x [n0, n0 + tn), with
// the offsets of the layer's dW block and db.
__device__ __forceinline__ void dw_tile(const Geo& g, int tile, int& l, int& m0, int& n0,
                                        int& tm, int& tn, long long& dw_off, int& db_off) {
  dw_off = 0;
  db_off = 0;
  for (l = 0; l <= g.n + 2; ++l) {
    int k_act, k_enc, n_out;
    layer_dims(g, l, k_act, k_enc, n_out);
    const int K = k_act + k_enc, mt = (K + 127) / 128, nt = (n_out + 127) / 128;
    if (tile < mt * nt) {
      m0 = (tile / nt) * 128;
      n0 = (tile % nt) * 128;
      tm = min(128, K - m0);
      tn = min(128, n_out - n0);
      return;
    }
    tile -= mt * nt;
    dw_off += (long long)K * n_out;
    db_off += n_out;
  }
}

// The heads of one 256-row slice, by the 256 consumer threads (a column
// each): sigma_out_layer's and rgb_out_layer's dW rounded to bf16, and the
// float32 db, summed over the slice's rows in order. Units of slices, not of
// splits, so that this streaming work spreads over every SM.
__device__ __forceinline__ void heads_unit(const Dw& a, int sl, int ct) {
  const Geo& g = a.geo;
  const int WP = g.WP;
  const bf16* h_add = a.scratch + h_col(g, g.n) + ct;
  const bf16* h_dn0 = a.scratch + h_col(g, g.n + 2) + ct;
  const float4* g4 = reinterpret_cast<const float4*>(a.g);
  float ss = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sg = 0.f;
  const int r1 = min(g.N, (sl + 1) * kSlice);
#pragma unroll 8
  for (int r = sl * kSlice; r < r1; ++r) {
    const float4 gr = __ldg(g4 + r);
    if (ct < WP) ss = fmaf(__bfloat162float(h_add[(size_t)r * g.ld]), gr.w, ss);
    if (ct < WP / 2) {
      const float h = __bfloat162float(h_dn0[(size_t)r * g.ld]);
      s0 = fmaf(h, gr.x, s0);
      s1 = fmaf(h, gr.y, s1);
      s2 = fmaf(h, gr.z, s2);
    }
    if (ct < 4) sg += ct == 0 ? gr.x : ct == 1 ? gr.y : ct == 2 ? gr.z : gr.w;
  }
  float* out = a.heads_part + (size_t)sl * head_grads(WP);
  if (ct < WP) out[ct] = bf16r(ss);
  if (ct < WP / 2) {
    out[WP + 3 * ct] = bf16r(s0);
    out[WP + 3 * ct + 1] = bf16r(s1);
    out[WP + 3 * ct + 2] = bf16r(s2);
  }
  if (ct < 4) out[WP + 3 * (WP / 2) + ct] = sg;   // rgb b [3], then sigma b
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_v2_dw_kernel(const __grid_constant__ CUtensorMap tmap, const Dw a) {
  unsigned char* smem = aligned_smem();
  float* dbuf = reinterpret_cast<float*>(smem + kDwStages * kDwStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kDwStageBytes + 2 * 128 * 4);
  uint64_t* empty = full + kDwStages;
  const Geo& g = a.geo;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // split-major dW units (the blocks that share a split's rows run together
  // and share them in L2), then one heads unit per slice
  const int gemm_units = a.S * a.tiles;
  const int units = gemm_units + a.slices;
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_dealloc<40>();
    if (tid == 256) {
      int it = 0;
      for (int u = blockIdx.x; u < gemm_units; u += gridDim.x) {
        const int s = u / a.tiles;
        int l, m0, n0, tm, tn, db_off;
        long long dw_off;
        dw_tile(g, u % a.tiles, l, m0, n0, tm, tn, dw_off, db_off);
        // always two boxes of each: a narrow tile's second box holds other
        // columns (or TMA's zeros past the scratch), whose sums are not stored
        const int a0 = in_col(g, l, m0), a1 = in_col(g, l, m0 + 64);
        const int y0 = dy_col(g, l) + n0;
        const int row0 = s * a.sps * kSlice;
        const int chunks = 4 * (min(a.slices, (s + 1) * a.sps) - s * a.sps);
        for (int ch = 0; ch < chunks; ++ch, ++it) {
          const int st = it % kDwStages;
          mbar_wait(&empty[st], ((it / kDwStages) & 1) ^ 1);
          unsigned char* stage = smem + st * kDwStageBytes;
          mbar_arrive_expect_tx(&full[st], kDwStageBytes);
          const int row = row0 + 64 * ch;
          tma_load_2d(stage, &tmap, a0, row, &full[st]);
          tma_load_2d(stage + kBox, &tmap, a1, row, &full[st]);
          tma_load_2d(stage + 2 * kBox, &tmap, y0, row, &full[st]);
          tma_load_2d(stage + 3 * kBox, &tmap, y0 + 64, row, &full[st]);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<232>();
    float acc[64], sum[64];
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r = warp * 16 + lane / 4, q = lane % 4;
    const int col = tid % 128, half = tid / 128;   // db: a column, 32 rows of each box
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      if (u >= gemm_units) {
        heads_unit(a, u - gemm_units, tid);
        continue;
      }
      const int s = u / a.tiles;
      int l, m0, n0, tm, tn, db_off;
      long long dw_off;
      dw_tile(g, u % a.tiles, l, m0, n0, tm, tn, dw_off, db_off);
      const bool active = wg == 0 || tm > 64;     // this warpgroup's rows are in the tile
      const bool do_db = m0 == 0;
      const int n_slices = min(a.slices, (s + 1) * a.sps) - s * a.sps;
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.f;
      float dbp = 0.f;
      for (int sl = 0; sl < n_slices; ++sl) {
        for (int ch = 0; ch < 4; ++ch, ++it) {
          const int st = it % kDwStages;
          mbar_wait(&full[st], (it / kDwStages) & 1);
          const unsigned char* stage = smem + st * kDwStageBytes;
#pragma unroll
          for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss<128, 1, 1>(acc, desc_sw128(stage + wg * kBox + 2048 * ks, 8192, 1024),
                                desc_sw128(stage + 2 * kBox + 2048 * ks, kBox, 1024),
                                ch > 0 || ks > 0);
          wgmma_commit();
          if (do_db && col < tn) {
            const unsigned char* box = stage + (2 + col / 64) * kBox;
#pragma unroll 8
            for (int rr = 0; rr < 32; ++rr)
              dbp += __bfloat162float(*reinterpret_cast<const bf16*>(
                  box + swizzle128(32 * half + rr, col % 64)));
          }
          if (ch > 0) {
            wgmma_wait<1>();
            mbar_arrive(&empty[(it - 1) % kDwStages]);
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += bf16r(acc[i]);
        mbar_arrive(&empty[(it - 1) % kDwStages]);
      }
      int k_act, k_enc, n_out;
      layer_dims(g, l, k_act, k_enc, n_out);
      float* part = a.partial + (size_t)s * (a.dw_total + a.db_total);
      if (active) {
        float* top = part + dw_off + (size_t)(m0 + 64 * wg + r) * n_out + n0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (8 * j < tn) {
            *reinterpret_cast<float2*>(top + 8 * j + 2 * q) = make_float2(sum[4 * j], sum[4 * j + 1]);
            *reinterpret_cast<float2*>(top + 8 * n_out + 8 * j + 2 * q) =
                make_float2(sum[4 * j + 2], sum[4 * j + 3]);
          }
        }
      }
      if (do_db) {
        named_sync(1, kConsumerThreads);
        dbuf[half * 128 + col] = dbp;
        named_sync(1, kConsumerThreads);
        if (tid < tn) part[a.dw_total + db_off + n0 + tid] = dbuf[tid] + dbuf[128 + tid];
      }
    }
  }
}

// ------------------------------------------------------ phase 3: the splits

// grads[e] = the sum over the splits, in split order, of their partial dW and
// db (a thread per element); then the heads, the sum over the slices (a warp
// per element: each lane sums its slices in order, then a fixed shuffle tree).
__global__ void fused_mlp_v2_dw_reduce_kernel(const float* partial, const float* heads_part,
                                              float* grads, long long dense, int S, int slices,
                                              int heads, int dense_blocks) {
  if ((int)blockIdx.x < dense_blocks) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= dense) return;
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += partial[(size_t)k * dense + e];
    grads[e] = s;
    return;
  }
  const int e = ((int)blockIdx.x - dense_blocks) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= heads) return;   // whole warps
  float s = 0.f;
  for (int k = lane; k < slices; k += 32) s += heads_part[(size_t)k * heads + e];
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) grads[dense + e] = s;
}

// ------------------------------------------------------------------- host

struct Plan {
  Geo geo;
  long long dw_total, G;
  int db_total, tiles, slices, sps, S, grid1;
  size_t off_masks, off_denc, off_partial, off_heads, bytes;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

int make_plan(Plan& pl, int N, int n_layers, int W, int add, int pos_freqs, int dir_freqs,
              unsigned skip_mask, int use_dir) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  Geo& g = pl.geo;
  g.N = N;
  g.WP = padded_width(W);
  g.n = n_layers;
  g.P = (add + 6 * pos_freqs + kChunkK - 1) / kChunkK;
  g.Dc = (6 * dir_freqs + kChunkK - 1) / kChunkK;
  g.use_dir = use_dir;
  g.skip_mask = skip_mask;
  g.ld = scratch_ld(g);
  grad_sizes(g, pl.dw_total, pl.db_total, pl.tiles);
  pl.G = pl.dw_total + pl.db_total + head_grads(g.WP);
  pl.slices = (N + kSlice - 1) / kSlice;
  // about 8 dW units per SM: enough to even out the blocks, few partials to sum
  const int want = max(1, (8 * sms + pl.tiles - 1) / pl.tiles);
  pl.sps = max(1, (pl.slices + want - 1) / want);
  pl.S = (pl.slices + pl.sps - 1) / pl.sps;
  const int tiles = (N + kTileRows - 1) / kTileRows;
  pl.grid1 = tiles < sms ? tiles : sms;
  size_t o = align256((size_t)N * g.ld * 2);
  pl.off_masks = o;
  o = align256(o + (size_t)pl.grid1 * g.n * (g.WP / 64) * 256 * 4);
  pl.off_denc = o;
  o = align256(o + (size_t)pl.grid1 * kTileRows * 64 * (g.P + g.Dc) * 2);
  pl.off_partial = o;
  o = align256(o + (size_t)pl.S * (pl.dw_total + pl.db_total) * 4);
  pl.off_heads = o;
  pl.bytes = o + (size_t)pl.slices * head_grads(g.WP) * 4;
  return 0;
}

template <int WP>
int launch_phase1(const CUtensorMap& tmap, const Bwd& b, int tiles, cudaStream_t stream) {
  return launch_persistent(fused_mlp_v2_bwd_kernel<WP>, BwdCfg<WP>::kSmem, tiles, stream, tmap,
                           b);
}

}  // namespace

extern "C" {

// out[0] = workspace bytes, out[1] = float32 gradients (the grads buffer's
// length) for a backward of N rows.
int fused_mlp_v2_bwd_sizes(int N, int n_layers, int W, int add, int pos_freqs, int dir_freqs,
                           unsigned skip_mask, int use_dir, long long* out) {
  Plan pl;
  const int err = make_plan(pl, N, n_layers, W, add, pos_freqs, dir_freqs, skip_mask, use_dir);
  if (err != 0) return err;
  out[0] = (long long)pl.bytes;
  out[1] = pl.G;
  return 0;
}

// x [N, add + 6] float32 raw rows, g [N, 4] float32 cotangent of (rgb ||
// sigma), dx [N, add + 6] float32 and grads (the layout above) written;
// workspace of fused_mlp_v2_bwd_sizes bytes; w / b / heads:
// ops/fused_mlp.py:pack_weights_d. N >= 1. Three launches; returns the first
// CUDA error (0 on success).
int fused_mlp_v2_bwd_launch(const float* x, const float* g, float* dx, float* grads,
                            void* workspace, const void* w, const float* b, const float* heads,
                            int N, int n_layers, int W, int add, int pos_freqs, int dir_freqs,
                            unsigned skip_mask, int use_dir, cudaStream_t stream) {
  Plan pl;
  int err = make_plan(pl, N, n_layers, W, add, pos_freqs, dir_freqs, skip_mask, use_dir);
  if (err != 0) return err;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  Bwd bw;
  Net& p = bw.net;
  p.x = x;
  p.y = nullptr;
  p.w = static_cast<const unsigned char*>(w);
  p.bias = b;
  p.heads = heads;
  p.N = N;
  p.n_layers = n_layers;
  p.pos_block = add + 6 * pos_freqs;
  p.dir_dim = 6 * dir_freqs;
  p.in_dim = add + 6;
  p.add = add;
  p.P = pl.geo.P;
  p.Dc = pl.geo.Dc;
  p.skip_mask = skip_mask;
  p.use_dir = use_dir;
  p.enc_out = reinterpret_cast<bf16*>(ws);
  p.enc_ld = pl.geo.ld;
  bw.geo = pl.geo;
  bw.g = g;
  bw.dx = dx;
  bw.scratch = reinterpret_cast<bf16*>(ws);
  bw.masks = reinterpret_cast<uint32_t*>(ws + pl.off_masks);
  bw.denc = reinterpret_cast<bf16*>(ws + pl.off_denc);
  // the scratch as a tensor: 64 x 64 boxes, 128B swizzle, rows past N clipped
  // (stores) or read as zeros (loads)
  CUtensorMap tmap;
  err = encode_tensor_map_bf16(&tmap, ws, pl.geo.ld, N, (uint64_t)pl.geo.ld * 2, 64, 64);
  if (err != 0) return err;
  const int tiles = (N + kTileRows - 1) / kTileRows;
  err = pl.geo.WP == 256 ? launch_phase1<256>(tmap, bw, tiles, stream)
                         : launch_phase1<128>(tmap, bw, tiles, stream);
  if (err != 0) return err;
  Dw a;
  a.geo = pl.geo;
  a.scratch = reinterpret_cast<const bf16*>(ws);
  a.g = g;
  a.partial = reinterpret_cast<float*>(ws + pl.off_partial);
  a.heads_part = reinterpret_cast<float*>(ws + pl.off_heads);
  a.dw_total = pl.dw_total;
  a.db_total = pl.db_total;
  a.slices = pl.slices;
  a.sps = pl.sps;
  a.S = pl.S;
  a.tiles = pl.tiles;
  err = launch_persistent(fused_mlp_v2_dw_kernel, kDwSmem, pl.S * pl.tiles + pl.slices, stream,
                          tmap, a);
  if (err != 0) return err;

  const long long dense = pl.dw_total + pl.db_total;
  const int dense_blocks = (int)((dense + 255) / 256), n_heads = head_grads(pl.geo.WP);
  fused_mlp_v2_dw_reduce_kernel<<<dense_blocks + (n_heads + 7) / 8, 256, 0, stream>>>(
      a.partial, a.heads_part, grads, dense, pl.S, pl.slices, n_heads, dense_blocks);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the first phase's launch, for a W-wide net.
int fused_mlp_v2_bwd_shared_bytes(int W) {
  return padded_width(W) == 256 ? BwdCfg<256>::kSmem : BwdCfg<128>::kSmem;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
