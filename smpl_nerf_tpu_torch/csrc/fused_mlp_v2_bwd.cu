// Fused RenderRayNet v2 backward on Hopper (sm_90a): per 64-row tile, rebuild
// the encodings and the forward, then walk the layers backwards on bf16 tensor
// cores; writes dX and adds every layer's dW and db into global memory.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/fused_mlp_v2.py:_pallas_backward
// (jax.vjp of `_tile_forward` per tile, dW summed over tiles). Plain version:
// smpl_nerf_tpu_torch/ops/fused_mlp_v2.py:reference_backward_raw.
//
// For a tile with raw rows x [64, 6] and output cotangent g [64, 4] (rgb, sigma):
//   forward as fused_mlp_v2_fwd.cu, every layer's bf16 output kept;
//   rgb head:   dE = bf16(g[:, :3] @ Wrgb^T) * (E > 0)
//   each dense layer, last to first:  dW += bf16(A^T @ dY),  db += sum_rows(dY),
//       dH = bf16(dY @ W^T), times (H > 0) where H came out of a ReLU;
//       the columns of dH that belong to a concatenated encoding add into
//       d pos / d dir (bf16 adds);
//   sigma head: dA += bf16(g[:, 3] * Wsig^T)   (bf16 add, as the two uses of A)
//   dX[:, j] = sum_k d enc[:, col(k, j)] * cos(arg(k, j)) * 2^k   (float32)
// The roundings are those of jax.vjp through `_tile_forward`: a cotangent that
// reaches a bf16 value is rounded to bf16 (so every dY of a dense layer is
// exactly bf16 and the tensor-core products lose nothing), and a tile's dW is
// rounded to bf16 before the float32 sum over tiles. The heads are N = 1 and
// N = 3 and stay in float32 scalar code, where g is not bf16.
//
// What bounds it on the H100: tensor-core operations, three times the
// forward's (the recompute, the dH chain, the dW products): 3 x 2 x 607,872
// FLOP per sample at W = 256 against 64 bytes moved per sample.
//
// What differs from the TPU design, and must:
// * The TPU kernel keeps every weight and every dW resident in VMEM and lets
//   all grid steps revisit the dW blocks in order. Here dW and db live in
//   global memory (float32, zeroed by the wrapper); each block forms its
//   tile's A^T @ dY in tensor-core accumulators, 16x16 at a time, and adds it
//   with atomicAdd. The order of those adds changes from run to run, so dW
//   and db are not bit-reproducible (float32 sum order; ~1e-6 relative).
// * The 13 saved layer inputs of a 64-row tile (~0.35 MB) do not fit in
//   shared memory. The grid is persistent (one block per SM, each looping
//   over tiles), and every block owns a slice of a global scratch buffer,
//   [n_layers + 3 slots][64][W] bf16, that its forward writes and its
//   backward reads back; at one block per SM the buffer is ~46 MB and stays
//   mostly in the 50 MB L2. Shared memory holds the encodings, their
//   gradients, two [64, W] bf16 gradient buffers and the weight chunk
//   (~124 KB), so one block runs per SM.
// * W^T for dH is not packed a second time: a 32-row chunk of the packed
//   [K, N] weights in shared memory is read as a col_major wmma operand, and
//   gives 32 complete columns of dH (8 output tiles, one per warp).
// * The ragged last tile reads zeros for x and g, so its padded rows add
//   nothing to dW and db, and stores no dX.
// sinf / cosf, never __sinf / __cosf: the argument reaches 2^9 * x.
//
// This is the simple, correct first version: wmma (mma.sync), scalar float32
// atomics, no overlap of the weight stream with the products.
#include "fused_mlp_common.cuh"

using namespace fused_mlp;

namespace {

struct Dims {
  int W, P, Ppad, D, Dpad, lda, ldp, ldd;
  size_t off_pos, off_dir, off_dpos, off_ddir, off_ga, off_gb, off_w, off_scratch, off_g,
      off_raw, total;
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
  d.off_pos = o;     o = align128(o + sizeof(bf16) * kTile * d.ldp);
  d.off_dir = o;     o = align128(o + sizeof(bf16) * kTile * d.ldd);
  d.off_dpos = o;    o = align128(o + sizeof(bf16) * kTile * d.ldp);
  d.off_ddir = o;    o = align128(o + sizeof(bf16) * kTile * d.ldd);
  d.off_ga = o;      o = align128(o + sizeof(bf16) * kTile * d.lda);
  d.off_gb = o;      o = align128(o + sizeof(bf16) * kTile * d.lda);
  d.off_w = o;       o = align128(o + sizeof(bf16) * kChunk * (W + kPadCols));
  d.off_scratch = o; o = align128(o + sizeof(float) * kWarps * 256);
  d.off_g = o;       o = align128(o + sizeof(float) * kTile * 4);
  d.off_raw = o;     o = align128(o + sizeof(float) * kTile * 6);
  d.total = o;
  return d;
}

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Backward of out = act(A @ W + b) for one tile, A = [s0 | s1] of K columns
// (s0 may be empty), dY [kTile, N] bf16 in shared memory:
//   dbg[:N] += sum_rows(dY);  dWg[K, N] += bf16(A^T @ dY)   (atomic adds)
//   dH = bf16(dY @ W^T): columns of s0 go to out0 (zeroed where s0 <= 0 if
//   mask0: s0 came out of a ReLU), columns of s1 add into acc1 (bf16 add).
// Ends with a block barrier.
__device__ void layer_backward(Seg s0, Seg s1, bool mask0, const bf16* dY, int ldy,
                               const bf16* __restrict__ Wg, int K, int N,
                               float* __restrict__ dWg, float* __restrict__ dbg, bf16* out0,
                               int ldo, bf16* acc1, int ld1, bf16* wbuf, float* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = N / 16;
  const int k_tiles = K / 16;
  const int ldw = N + kPadCols;

  for (int n = threadIdx.x; n < N; n += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kTile; ++r) s += __bfloat162float(dY[r * ldy + n]);
    if (s != 0.f) atomicAdd(dbg + n, s);
  }

  // dW = A^T @ dY: a warp owns n-tiles, keeps their dY fragments and walks K
  for (int nt = warp; nt < n_tiles; nt += kWarps) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) wmma::load_matrix_sync(b[m], dY + m * 16 * ldy + nt * 16, ldy);
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int kk = kt * 16;
      const bf16* a_ptr;
      int lda;
      if (kk < s0.cols) {
        a_ptr = s0.ptr + kk;
        lda = s0.ld;
      } else {
        a_ptr = s1.ptr + (kk - s0.cols);
        lda = s1.ld;
      }
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        // A^T[k, row] = A[row, k]: the row-major tile read as col_major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, a_ptr + m * 16 * lda, lda);
        wmma::mma_sync(acc, a, b[m], acc);
      }
      wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = lane + 32 * e;
        const float v = bf16_round(scratch[i]);
        if (v != 0.f) atomicAdd(dWg + (size_t)(kk + (i >> 4)) * N + nt * 16 + (i & 15), v);
      }
      __syncwarp();
    }
  }

  // dH = dY @ W^T, 32 columns (one weight chunk) at a time, one tile per warp
  const int m = warp & 3;
  const int kt = warp >> 2;
  for (int kc = 0; kc < K; kc += kChunk) {
    const int klen = min(kChunk, K - kc);
    load_weight_chunk(Wg, kc, klen, N, wbuf);
    __syncthreads();
    if (kt * 16 < klen) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int nt = 0; nt < n_tiles; ++nt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        // W^T[n, k] = W[k, n]: the chunk's rows read as col_major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, dY + m * 16 * ldy + nt * 16, ldy);
        wmma::load_matrix_sync(b, wbuf + kt * 16 * ldw + nt * 16, ldw);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = lane + 32 * e;
        const int r = m * 16 + (i >> 4);
        const int col = kc + kt * 16 + (i & 15);
        float v = bf16_round(scratch[i]);
        if (col < s0.cols) {
          if (mask0 && !(__bfloat162float(s0.ptr[r * s0.ld + col]) > 0.f)) v = 0.f;
          out0[r * ldo + col] = __float2bfloat16_rn(v);
        } else {
          bf16* dst = acc1 + r * ld1 + (col - s0.cols);
          *dst = __float2bfloat16_rn(__bfloat162float(*dst) + v);
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// Backward of a float32 head outT[:, gcol0:gcol0+Nh] = act[:, :K] @ Wg + b:
//   out[:, :K] (+)= bf16(g @ Wg^T), zeroed where act <= 0 if relu_mask;
//   dWg[K, Nh] += bf16(act^T @ g);  dbg[:Nh] += sum_rows(g).
// Callers put a block barrier before (out, act ready) and after.
__device__ void head_backward(const bf16* act, int lda, int K, const bf16* __restrict__ Wg,
                              int Nh, const float* gT, int gcol0, float* __restrict__ dWg,
                              float* __restrict__ dbg, bf16* out, int ldo, bool relu_mask,
                              bool accumulate) {
  for (int i = threadIdx.x; i < kTile * K; i += kThreads) {
    const int r = i / K;
    const int k = i - r * K;
    float s = 0.f;
    for (int n = 0; n < Nh; ++n) s += gT[r * 4 + gcol0 + n] * __bfloat162float(Wg[k * Nh + n]);
    float v = bf16_round(s);
    if (relu_mask && !(__bfloat162float(act[r * lda + k]) > 0.f)) v = 0.f;
    if (accumulate) v += __bfloat162float(out[r * ldo + k]);
    out[r * ldo + k] = __float2bfloat16_rn(v);
  }
  for (int i = threadIdx.x; i < K * Nh; i += kThreads) {
    const int k = i / Nh;
    const int n = i - k * Nh;
    float s = 0.f;
    for (int r = 0; r < kTile; ++r)
      s += __bfloat162float(act[r * lda + k]) * gT[r * 4 + gcol0 + n];
    s = bf16_round(s);
    if (s != 0.f) atomicAdd(dWg + i, s);
  }
  if (threadIdx.x < Nh) {
    float s = 0.f;
    for (int r = 0; r < kTile; ++r) s += gT[r * 4 + gcol0 + threadIdx.x];
    if (s != 0.f) atomicAdd(dbg + threadIdx.x, s);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_v2_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        float* __restrict__ dx, float* __restrict__ dw, float* __restrict__ db,
                        bf16* acts, const bf16* __restrict__ wts,
                        const float* __restrict__ bias, const int* __restrict__ table, int N,
                        int n_layers, int W, int pos_freqs, int dir_freqs, unsigned skip_mask,
                        int use_dir) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims d = make_dims(W, pos_freqs, dir_freqs);
  bf16* pos = reinterpret_cast<bf16*>(smem + d.off_pos);
  bf16* dir = reinterpret_cast<bf16*>(smem + d.off_dir);
  bf16* dpos = reinterpret_cast<bf16*>(smem + d.off_dpos);
  bf16* ddir = reinterpret_cast<bf16*>(smem + d.off_ddir);
  bf16* gA = reinterpret_cast<bf16*>(smem + d.off_ga);
  bf16* gB = reinterpret_cast<bf16*>(smem + d.off_gb);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + d.off_w);
  float* scratch = reinterpret_cast<float*>(smem + d.off_scratch) + (threadIdx.x >> 5) * 256;
  float* gT = reinterpret_cast<float*>(smem + d.off_g);
  float* raw = reinterpret_cast<float*>(smem + d.off_raw);

  const int n_tiles = (N + kTile - 1) / kTile;
  const int n = n_layers;
  // this block's saved layer outputs: slots 0..n-1 = the trunk's ReLU outputs,
  // n = additional_linear_layer, n+1 = directional_input, n+2 = directional_net_0
  bf16* slots = acts + (size_t)blockIdx.x * (n + 3) * kTile * W;
#define SLOT(s) (slots + (size_t)(s) * kTile * W)
#define WT(l) (wts + table[4 * (l)])
#define BIAS(l) (bias + table[4 * (l) + 1])
#define DW(l) (dw + table[4 * (l)])
#define DB(l) (db + table[4 * (l) + 1])
#define KDIM(l) (table[4 * (l) + 2])
#define NDIM(l) (table[4 * (l) + 3])
  const Seg none = {nullptr, 0, 0};
  const Seg pos_seg = {pos, d.ldp, d.Ppad};
  const Seg dir_seg = {dir, d.ldd, d.Dpad};
  const Seg dir_in = use_dir ? dir_seg : none;
  const bf16 zero = __float2bfloat16_rn(0.f);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kTile;
    // the ragged last tile reads zeros, so its padded rows add nothing
    for (int i = threadIdx.x; i < kTile * 6; i += kThreads)
      raw[i] = (row0 + i / 6 < N) ? x[(size_t)row0 * 6 + i] : 0.f;
    for (int i = threadIdx.x; i < kTile * 4; i += kThreads)
      gT[i] = (row0 + i / 4 < N) ? g[(size_t)row0 * 4 + i] : 0.f;
    for (int i = threadIdx.x; i < kTile * d.ldp; i += kThreads) dpos[i] = zero;
    for (int i = threadIdx.x; i < kTile * d.ldd; i += kThreads) ddir[i] = zero;
    __syncthreads();
    encode(raw, 0, pos_freqs, d.Ppad, pos, d.ldp);
    encode(raw, 3, dir_freqs, d.Dpad, dir, d.ldd);
    __syncthreads();

    // ---- forward, every layer's output kept in this block's scratch slots
    dense_layer(pos_seg, none, WT(0), BIAS(0), KDIM(0), NDIM(0), SLOT(0), W, true, wbuf,
                scratch);
    for (int i = 0; i < n - 1; ++i) {
      const Seg s1 = ((skip_mask >> i) & 1u) ? pos_seg : none;
      dense_layer(Seg{SLOT(i), W, W}, s1, WT(1 + i), BIAS(1 + i), KDIM(1 + i), NDIM(1 + i),
                  SLOT(i + 1), W, true, wbuf, scratch);
    }
    dense_layer(Seg{SLOT(n - 1), W, W}, none, WT(n), BIAS(n), KDIM(n), NDIM(n), SLOT(n), W,
                false, wbuf, scratch);                         // additional_linear_layer
    dense_layer(Seg{SLOT(n), W, W}, dir_in, WT(n + 1), BIAS(n + 1), KDIM(n + 1), NDIM(n + 1),
                SLOT(n + 1), W, false, wbuf, scratch);         // directional_input
    dense_layer(Seg{SLOT(n + 1), W, W / 2}, none, WT(n + 2), BIAS(n + 2), KDIM(n + 2),
                NDIM(n + 2), SLOT(n + 2), W, true, wbuf, scratch);  // directional_net_0
    __syncthreads();

    // ---- backward
    bf16* dY = gA;
    bf16* dH = gB;
#define SWAP() { bf16* t_ = dY; dY = dH; dH = t_; }
    // rgb head -> gradient of directional_net_0's output
    head_backward(SLOT(n + 2), W, W / 2, WT(n + 4), 3, gT, 0, DW(n + 4), DB(n + 4), dY, d.lda,
                  true, false);
    __syncthreads();
    layer_backward(Seg{SLOT(n + 1), W, W / 2}, none, false, dY, d.lda, WT(n + 2), KDIM(n + 2),
                   NDIM(n + 2), DW(n + 2), DB(n + 2), dH, d.lda, nullptr, 0, wbuf, scratch);
    SWAP();
    layer_backward(Seg{SLOT(n), W, W}, dir_in, false, dY, d.lda, WT(n + 1), KDIM(n + 1),
                   NDIM(n + 1), DW(n + 1), DB(n + 1), dH, d.lda, ddir, d.ldd, wbuf, scratch);
    // sigma head: the second use of additional_linear_layer's output
    head_backward(SLOT(n), W, W, WT(n + 3), 1, gT, 3, DW(n + 3), DB(n + 3), dH, d.lda, false,
                  true);
    __syncthreads();
    SWAP();
    layer_backward(Seg{SLOT(n - 1), W, W}, none, true, dY, d.lda, WT(n), KDIM(n), NDIM(n),
                   DW(n), DB(n), dH, d.lda, nullptr, 0, wbuf, scratch);
    SWAP();
    for (int i = n - 2; i >= 0; --i) {
      const Seg s1 = ((skip_mask >> i) & 1u) ? pos_seg : none;
      layer_backward(Seg{SLOT(i), W, W}, s1, true, dY, d.lda, WT(1 + i), KDIM(1 + i),
                     NDIM(1 + i), DW(1 + i), DB(1 + i), dH, d.lda, dpos, d.ldp, wbuf, scratch);
      SWAP();
    }
    layer_backward(none, pos_seg, false, dY, d.lda, WT(0), KDIM(0), NDIM(0), DW(0), DB(0),
                   nullptr, 0, dpos, d.ldp, wbuf, scratch);
#undef SWAP

    // ---- dX: d enc * cos(arg) * 2^k, summed over a coordinate's 2L columns
    for (int i = threadIdx.x; i < kTile * 6; i += kThreads) {
      const int r = i / 6;
      const int j = i - 6 * r;
      const bool is_pos = j < 3;
      const float* coords = raw + r * 6 + (is_pos ? 0 : 3);
      const bf16* dsrc = is_pos ? dpos + r * d.ldp : ddir + r * d.ldd;
      const int freqs = is_pos ? pos_freqs : dir_freqs;
      const int jj = is_pos ? j : j - 3;
      float s = 0.f;
      for (int k = 0; k < freqs; ++k) {
        const float f = (float)(1 << k);
        const int c_sin = 6 * k + jj;
        const int c_cos = c_sin + 3;
        s += __bfloat162float(dsrc[c_sin]) * cosf(encoding_arg(coords, c_sin)) * f;
        s += __bfloat162float(dsrc[c_cos]) * cosf(encoding_arg(coords, c_cos)) * f;
      }
      if (row0 + r < N) dx[(size_t)row0 * 6 + i] = s;
    }
    __syncthreads();
  }
#undef SLOT
#undef WT
#undef BIAS
#undef DW
#undef DB
#undef KDIM
#undef NDIM
}

}  // namespace

extern "C" {

// Rows of global scratch (bf16 elements) one block needs: (n_layers + 3) slots
// of [64, W]. The wrapper allocates grid * this.
int fused_mlp_v2_bwd_scratch_elems(int n_layers, int W) {
  return (n_layers + 3) * kTile * W;
}

// x [N, 6] float32 raw rows, g [N, 4] float32 cotangent of (rgb || sigma),
// dx [N, 6] float32 (written), dw / db float32 in the layout of the weight
// pack (added into: zero them first), acts: grid * scratch_elems bf16,
// w/b/table: the weight pack of ops/fused_mlp.py:pack_weights. `grid`
// blocks loop over the tiles. Returns the CUDA error of the launch.
int fused_mlp_v2_bwd_launch(const float* x, const float* g, float* dx, float* dw, float* db,
                            void* acts, const void* w, const float* b, const int* table,
                            int N, int n_layers, int W, int pos_freqs, int dir_freqs,
                            unsigned skip_mask, int use_dir, int grid, cudaStream_t stream) {
  const Dims d = make_dims(W, pos_freqs, dir_freqs);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_v2_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)d.total);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_v2_bwd_kernel<<<grid, kThreads, d.total, stream>>>(
      x, g, dx, dw, db, static_cast<bf16*>(acts), static_cast<const bf16*>(w), b, table, N,
      n_layers, W, pos_freqs, dir_freqs, skip_mask, use_dir);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
