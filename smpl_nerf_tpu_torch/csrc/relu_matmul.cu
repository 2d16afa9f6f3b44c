// y = relu(x @ w) on Hopper (sm_90a): bf16 operands, float32 accumulation on
// tensor cores, bf16 result. One layer of the roofline script's matmul chain.
//
// Replaces the TPU kernel scripts/mlp_roofline.py:_pallas_layer (a row tile of
// x against the whole of w, resident in VMEM). Plain version:
// smpl_nerf_tpu_torch/ops/relu_matmul.py:relu_matmul_reference.
//
// What bounds it on the H100: for square layers of width W on n rows it moves
// 4 n W bytes (x in, y out; w is small) and does 2 n W^2 operations, W / 2
// operations per byte: below the ~295 of the bf16 ridge point at W = 256 and
// 512 (bytes bound it), above it at W = 1024 (operations).
//
// Design: a block computes a 128 x 128 tile of y with 8 warps (4 down, 2
// across; a warp owns 32 x 64 = 2 x 4 wmma accumulators). K advances in
// chunks of 32: the 128 x 32 slice of x and the 32 x 128 slice of w are
// copied to shared memory with 16-byte cp.async, double-buffered so that the
// next chunk's copy overlaps this chunk's products. The epilogue takes each
// accumulator through a per-warp float32 scratch, applies relu, rounds to
// bf16 and writes 16 bytes per lane. Column tiles are the fast grid axis, so
// the blocks that share a row slice of x run together and find it in L2.
// Rows past n read row n-1 and are not stored. No library call anywhere.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
relu_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ y, int n, int K, int N) {
  __shared__ __align__(128) bf16 As[2][BM][BK + PAD];
  __shared__ __align__(128) bf16 Bs[2][BK][BN + PAD];
  __shared__ __align__(128) float scratch[kThreads / 32][256];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;          // 4 x 2 warps
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int ar = idx >> 2, ac = (idx & 3) * 8;   // 128 rows x 4 x 16 B
      const int gr = min(row0 + ar, n - 1);
      __pipeline_memcpy_async(&As[stage][ar][ac], x + (size_t)gr * K + k0 + ac, 16);
      const int br = idx >> 4, bc = (idx & 15) * 8;  // 32 rows x 16 x 16 B
      __pipeline_memcpy_async(&Bs[stage][br][bc], w + (size_t)(k0 + br) * N + col0 + bc, 16);
    }
    __pipeline_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = K / BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk) {
      load(stage ^ 1, (kt + 1) * BK);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[stage][wm * 32 + i * 16][ks], BK + PAD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[stage][ks][wn * 64 + j * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();   // this stage is overwritten by the copy started next turn
  }

  float* mine = scratch[warp];
  const int r = lane >> 1, c = (lane & 1) * 8;       // a lane: 8 values of one row
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(mine, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = mine[r * 16 + c + e];
        v[e] = __float2bfloat16_rn(f < 0.f ? 0.f : f);   // keeps NaN, as relu does
      }
      const int gr = row0 + wm * 32 + i * 16 + r;
      if (gr < n)
        *reinterpret_cast<uint4*>(y + (size_t)gr * N + col0 + wn * 64 + j * 16 + c) =
            *reinterpret_cast<const uint4*>(v);
      __syncwarp();
    }
}

}  // namespace

extern "C" {

// x [n, K], w [K, N], y [n, N], all bf16 row-major; K a multiple of 32, N a
// multiple of 128, n >= 1. Returns the CUDA error of the launch (0 on success).
int relu_matmul_launch(const void* x, const void* w, void* y, int n, int K, int N,
                       cudaStream_t stream) {
  const dim3 grid(N / BN, (n + BM - 1) / BM);
  relu_matmul_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), n, K, N);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
