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
// the products (no cp.async / TMA pipeline yet).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;       // rows per block (4 m-tiles of 16)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;      // weight rows per shared-memory step
constexpr int kPadCols = 8;     // bf16 row padding in shared memory
constexpr int kMaxNTilesPerWarp = 2;  // W <= 256: 16 n-tiles over 8 warps
constexpr float kHalfPi = 1.57079637050628662109375f;  // float32(pi / 2)
static_assert(kThreads == kTile * 4, "heads use 4 threads per row");

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

struct Dims {
  int W, P, Ppad, D, Dpad, lda, ldp, ldd;
  size_t off_act_a, off_act_b, off_pos, off_dir, off_w, off_scratch, off_out, off_raw, total;
};

__host__ __device__ inline Dims make_dims(int W, int pos_freqs, int dir_freqs) {
  Dims d;
  d.W = W;
  d.P = 6 * pos_freqs;
  d.Ppad = (d.P + 15) / 16 * 16;
  d.D = 6 * dir_freqs;
  d.Dpad = (d.D + 15) / 16 * 16;
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

// One input segment of a layer: `cols` columns (a multiple of 16) at `ptr`.
struct Seg {
  const bf16* ptr;
  int ld;
  int cols;
};

// Encoded block of coordinates raw[:, coord0:coord0+3] -> dst [kTile, cols_pad].
__device__ void encode(const float* raw, int coord0, int n_freqs, int cols_pad,
                       bf16* dst, int ld) {
  const int cols = 6 * n_freqs;
  for (int i = threadIdx.x; i < kTile * cols_pad; i += kThreads) {
    const int r = i / cols_pad;
    const int c = i - r * cols_pad;
    float v = 0.f;  // zero padding columns: they meet zero weight rows
    if (c < cols) {
      const int k = c / 6;
      const int within = c - 6 * k;
      // x * 2^k is exact, as the JAX dot with a one-hot M is
      float t = __fmul_rn(raw[r * 6 + coord0 + within % 3], (float)(1 << k));
      if (within >= 3) t = __fadd_rn(t, kHalfPi);
      v = sinf(t);
    }
    dst[r * ld + c] = __float2bfloat16_rn(v);
  }
}

// out[:, :N] = bf16(act(A @ Wg + bias)), A = [s0 | s1] of K columns.
// Wg is [K, N] bf16 row-major in global memory; N is a multiple of 16.
// Starts by writing `wbuf` and ends with a block barrier after its last read
// of A and `wbuf`; its epilogue writes are ordered before the next layer's
// reads by the barrier that follows the next layer's first weight load.
__device__ void dense_layer(Seg s0, Seg s1, const bf16* __restrict__ Wg,
                            const float* __restrict__ bias, int K, int N, bf16* out,
                            int ldo, bool relu, bf16* wbuf, float* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = N / 16;
  const int ldw = N + kPadCols;
  const int n8 = N / 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxNTilesPerWarp][4];
#pragma unroll
  for (int j = 0; j < kMaxNTilesPerWarp; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[j][m], 0.f);

  for (int kc = 0; kc < K; kc += kChunk) {
    const int klen = min(kChunk, K - kc);
    for (int i = threadIdx.x; i < klen * n8; i += kThreads) {
      const int r = i / n8;
      const int c = (i - r * n8) * 8;
      *reinterpret_cast<uint4*>(wbuf + r * ldw + c) =
          *reinterpret_cast<const uint4*>(Wg + (size_t)(kc + r) * N + c);
    }
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
__device__ void head(const bf16* act, int lda, int K, const bf16* __restrict__ Wg,
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

  const Seg none = {nullptr, 0, 0};
  const Seg pos_seg = {pos, d.ldp, d.Ppad};
#define LAYER(l, s0, s1, relu)                                                       \
  dense_layer((s0), (s1), wts + table[4 * (l)], bias + table[4 * (l) + 1],          \
              table[4 * (l) + 2], table[4 * (l) + 3], nxt, d.lda, (relu), wbuf, scratch); \
  { bf16* t_ = cur; cur = nxt; nxt = t_; }

  LAYER(0, pos_seg, none, true);
  for (int i = 0; i < n_layers - 1; ++i) {
    const Seg s1 = ((skip_mask >> i) & 1u) ? pos_seg : none;
    LAYER(1 + i, (Seg{cur, d.lda, W}), s1, true);
  }
  LAYER(n_layers, (Seg{cur, d.lda, W}), none, false);        // additional_linear_layer
  __syncthreads();
  const int ls = n_layers + 3;                               // sigma_out_layer
  head(cur, d.lda, W, wts + table[4 * ls], bias + table[4 * ls + 1], 1, outT, 3);
  const Seg dir_seg = {dir, d.ldd, d.Dpad};
  LAYER(n_layers + 1, (Seg{cur, d.lda, W}), (use_dir ? dir_seg : none), false);  // directional_input
  LAYER(n_layers + 2, (Seg{cur, d.lda, W / 2}), none, true);                     // directional_net_0
#undef LAYER
  __syncthreads();
  const int lr = n_layers + 4;                               // rgb_out_layer
  head(cur, d.lda, W / 2, wts + table[4 * lr], bias + table[4 * lr + 1], 3, outT, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * 4; i += kThreads)
    if (row0 + i / 4 < N) y[(size_t)row0 * 4 + i] = outT[i];
}

}  // namespace

extern "C" {

// x [N, 6] float32 raw rows (xyz || unit dir), y [N, 4] float32 (rgb || sigma).
// w/b/table: the weight pack of ops/fused_mlp_v2.py:pack_weights. W must be a
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
