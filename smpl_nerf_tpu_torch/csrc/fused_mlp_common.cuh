// Device code shared by the fused RenderRayNet kernels (fused_mlp_v2_fwd.cu,
// fused_mlp_fwd.cu, fused_mlp_v2_bwd.cu): one dense layer of a 64-row tile on
// bf16 tensor cores with the weights streamed through shared memory, and the
// narrow float32 heads.
//
// A block owns kTile rows and runs kWarps warps. A layer's input is up to two
// column segments (the activation, then the encoded block a skip or the
// directional layer concatenates), each a multiple of 16 columns wide, so the
// concatenation is never materialised. Weights are the pack of
// ops/fused_mlp.py:pack_weights: [K, N] bf16 row-major per layer, each
// segment's rows zero-padded to a multiple of 16.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace fused_mlp {

using namespace nvcuda;

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;       // rows per block (4 m-tiles of 16)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;      // weight rows per shared-memory step
constexpr int kPadCols = 8;     // bf16 row padding in shared memory
constexpr int kMaxNTilesPerWarp = 2;  // W <= 256: 16 n-tiles over 8 warps
static_assert(kThreads == kTile * 4, "heads use 4 threads per row");

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// One input segment of a layer: `cols` columns (a multiple of 16) at `ptr`
// (shared or global memory).
struct Seg {
  const bf16* ptr;
  int ld;
  int cols;
};

// Copy rows [kc, kc + klen) of the [K, N] weights into the shared chunk buffer.
__device__ inline void load_weight_chunk(const bf16* __restrict__ Wg, int kc, int klen, int N,
                                         bf16* wbuf) {
  const int ldw = N + kPadCols;
  const int n8 = N / 8;
  for (int i = threadIdx.x; i < klen * n8; i += kThreads) {
    const int r = i / n8;
    const int c = (i - r * n8) * 8;
    *reinterpret_cast<uint4*>(wbuf + r * ldw + c) =
        *reinterpret_cast<const uint4*>(Wg + (size_t)(kc + r) * N + c);
  }
}

// out[:, :N] = bf16(act(A @ Wg + bias)), A = [s0 | s1] of K columns.
// Wg is [K, N] bf16 row-major in global memory; N is a multiple of 16.
// Starts by writing `wbuf` and ends with a block barrier after its last read
// of A and `wbuf`; its epilogue writes are ordered before the next layer's
// reads by the barrier that follows the next layer's first weight load.
__device__ inline void dense_layer(Seg s0, Seg s1, const bf16* __restrict__ Wg,
                                   const float* __restrict__ bias, int K, int N, bf16* out,
                                   int ldo, bool relu, bf16* wbuf, float* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = N / 16;
  const int ldw = N + kPadCols;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxNTilesPerWarp][4];
#pragma unroll
  for (int j = 0; j < kMaxNTilesPerWarp; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[j][m], 0.f);

  for (int kc = 0; kc < K; kc += kChunk) {
    const int klen = min(kChunk, K - kc);
    load_weight_chunk(Wg, kc, klen, N, wbuf);
    __syncthreads();
    for (int ks = 0; ks < klen; ks += 16) {
      const int kk = kc + ks;
      const bf16* a_ptr;
      int lda;
      if (kk < s0.cols) {
        a_ptr = s0.ptr + kk;
        lda = s0.ld;
      } else {
        a_ptr = s1.ptr + (kk - s0.cols);
        lda = s1.ld;
      }
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) wmma::load_matrix_sync(a[m], a_ptr + m * 16 * lda, lda);
#pragma unroll
      for (int j = 0; j < kMaxNTilesPerWarp; ++j) {
        const int nt = warp + kWarps * j;
        if (nt < n_tiles) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wbuf + ks * ldw + nt * 16, ldw);
#pragma unroll
          for (int m = 0; m < 4; ++m) wmma::mma_sync(acc[j][m], a[m], b, acc[j][m]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxNTilesPerWarp; ++j) {
    const int nt = warp + kWarps * j;
    if (nt < n_tiles) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        wmma::store_matrix_sync(scratch, acc[j][m], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = lane + 32 * e;
          const int r = i >> 4;
          const int c = i & 15;
          float v = scratch[i] + bias[nt * 16 + c];
          if (relu && v < 0.f) v = 0.f;  // keeps NaN, as relu does
          out[(m * 16 + r) * ldo + nt * 16 + c] = __float2bfloat16_rn(v);
        }
        __syncwarp();
      }
    }
  }
}

// outT[:, col0:col0+N] = act[:, :K] @ Wg + b, float32 dots (N = 1 or 3),
// 4 threads per row. Callers put a block barrier before (act written) and
// after (outT read).
__device__ inline void head(const bf16* act, int lda, int K, const bf16* __restrict__ Wg,
                            const float* __restrict__ b, int N, float* outT, int col0) {
  const int r = threadIdx.x >> 2;
  const int q = threadIdx.x & 3;
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    for (int k = q; k < K; k += 4)
      s += __bfloat162float(act[r * lda + k]) * __bfloat162float(Wg[k * N + n]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0) outT[r * 4 + col0 + n] = s + b[n];
  }
}

// The RenderRayNet body of both forwards on one tile: the encoded position
// block `pos_seg` and direction block `dir_seg` (cols 0: no directional input)
// are in shared memory, `cur` / `nxt` are two [kTile, lda] activation buffers.
// Writes outT [kTile, 4] = rgb || sigma and ends with a block barrier.
// Layers are addressed through the pack's table: row l = (weight offset, bias
// offset, K, N).
__device__ inline void net_forward(Seg pos_seg, Seg dir_seg, bf16* cur, bf16* nxt, int lda,
                                   const bf16* __restrict__ wts, const float* __restrict__ bias,
                                   const int* __restrict__ table, int n_layers, int W,
                                   unsigned skip_mask, bf16* wbuf, float* scratch, float* outT) {
  const Seg none = {nullptr, 0, 0};
#define LAYER(l, s0, s1, relu)                                                       \
  dense_layer((s0), (s1), wts + table[4 * (l)], bias + table[4 * (l) + 1],          \
              table[4 * (l) + 2], table[4 * (l) + 3], nxt, lda, (relu), wbuf, scratch); \
  { bf16* t_ = cur; cur = nxt; nxt = t_; }

  LAYER(0, pos_seg, none, true);
  for (int i = 0; i < n_layers - 1; ++i) {
    const Seg s1 = ((skip_mask >> i) & 1u) ? pos_seg : none;
    LAYER(1 + i, (Seg{cur, lda, W}), s1, true);
  }
  LAYER(n_layers, (Seg{cur, lda, W}), none, false);          // additional_linear_layer
  __syncthreads();
  const int ls = n_layers + 3;                               // sigma_out_layer
  head(cur, lda, W, wts + table[4 * ls], bias + table[4 * ls + 1], 1, outT, 3);
  LAYER(n_layers + 1, (Seg{cur, lda, W}), dir_seg, false);   // directional_input
  LAYER(n_layers + 2, (Seg{cur, lda, W / 2}), none, true);   // directional_net_0
#undef LAYER
  __syncthreads();
  const int lr = n_layers + 4;                               // rgb_out_layer
  head(cur, lda, W / 2, wts + table[4 * lr], bias + table[4 * lr + 1], 3, outT, 0);
  __syncthreads();
}

constexpr float kHalfPi = 1.57079637050628662109375f;  // float32(pi / 2)

// The encoding argument of column c (< 6 * n_freqs) for raw coordinates
// coords[0..2]: x * 2^k for the sin blocks, + pi/2 for the cos blocks
// (cos(t) = sin(t + pi/2)), in the block order [sin f0 | cos f0 | sin f1 | ...].
// x * 2^k is exact, as the JAX dot with a one-hot M is.
__device__ inline float encoding_arg(const float* coords, int c) {
  const int k = c / 6;
  const int within = c - 6 * k;
  float t = __fmul_rn(coords[within % 3], (float)(1 << k));
  if (within >= 3) t = __fadd_rn(t, kHalfPi);
  return t;
}

// Encoded block of coordinates raw[:, coord0:coord0+3] -> dst [kTile, cols_pad].
__device__ inline void encode(const float* raw, int coord0, int n_freqs, int cols_pad,
                              bf16* dst, int ld) {
  const int cols = 6 * n_freqs;
  for (int i = threadIdx.x; i < kTile * cols_pad; i += kThreads) {
    const int r = i / cols_pad;
    const int c = i - r * cols_pad;
    // zero padding columns: they meet zero weight rows
    const float v = c < cols ? sinf(encoding_arg(raw + r * 6 + coord0, c)) : 0.f;
    dst[r * ld + c] = __float2bfloat16_rn(v);
  }
}

}  // namespace fused_mlp
