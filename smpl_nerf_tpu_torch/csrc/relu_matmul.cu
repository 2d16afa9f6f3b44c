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
// 512 (bytes bound it), above it at W = 1024 (operations). So the copies must
// run at the memory's rate while the tensor cores run at theirs: neither may
// wait on the other.
//
// Design (the Hopper GEMM shape; hopper.cuh has the PTX):
//  - warp specialisation: 384 threads; warpgroups 0 and 1 consume, warpgroup
//    2 produces (one thread issues every copy). setmaxnreg gives the
//    consumers 232 registers and the producer 40.
//  - the producer streams 128 x 64 boxes of x and 64 x BN boxes of w (as
//    64-column TMA boxes) with TMA, 128B swizzle, into a ring of 3 (BN = 256)
//    or 4 (BN = 128) stages; a full mbarrier per stage completes on the
//    copies' bytes, an empty mbarrier on the 256 consumer threads' release.
//  - each consumer warpgroup runs wgmma m64nBNk16 over its 64 rows of the
//    128 x BN tile, A (x, K-major) and B (w, N-major: the transpose bit) both
//    read from shared memory, so w is never transposed on the host. One
//    k-block's wgmmas stay in flight while the next is issued; a stage is
//    released as soon as the wgmmas that read it are done.
//  - persistent grid: one block per SM walks the output tiles with the N
//    tiles fastest, so the blocks that share a row slice of x run together
//    and find it in L2, and the producer loads the next tile while the
//    consumers run the epilogue of this one.
//  - epilogue: relu in float32 (NaN stays NaN), one rounding to bf16, into a
//    128B-swizzled staging tile per warpgroup, then TMA stores of 64 x 64
//    boxes; rows past n are not written by the TMA unit.
//  - ragged edges need no path of their own: TMA reads zeros past n rows and
//    past K columns (K a multiple of 32, not of 64).
// No library call anywhere.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BK = 64;
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;

template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr int kABytes = BM * BK * 2;              // x box, 16 KB
  static constexpr int kBBytes = BK * BN * 2;              // BN / 64 w boxes of 8 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kCBytes = 64 * BN * 2;              // staging per consumer warpgroup
  static constexpr int kBarOff = kStages * kStageBytes + 2 * kCBytes;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;   // + 1024 B alignment slack
};

__device__ __forceinline__ float relu(float f) { return f < 0.f ? 0.f : f; }  // keeps NaN

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
relu_matmul_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap ty, int n, int K, int N) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n_tiles = N / BN;
  const int tiles = (n + BM - 1) / BM * n_tiles;
  const int k_blocks = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
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
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int s = it % C::kStages;
          mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
          unsigned char* stage = smem + s * C::kStageBytes;
          mbar_arrive_expect_tx(&full[s], C::kStageBytes);
          tma_load_2d(stage, &tx, kb * BK, m0, &full[s]);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_load_2d(stage + C::kABytes + b * (BK * 128), &tw, n0 + 64 * b, kb * BK, &full[s]);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<232>();
    float acc[BN / 2] = {};
    unsigned char* staging = smem + C::kStages * C::kStageBytes + wg * C::kCBytes;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r = warp * 16 + lane / 4, q = lane % 4;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
      for (int kb = 0; kb < k_blocks; ++kb, ++it) {
        const int s = it % C::kStages;
        mbar_wait(&full[s], (it / C::kStages) & 1);
        const unsigned char* a = smem + s * C::kStageBytes + wg * (64 * 128);
        const unsigned char* b = smem + s * C::kStageBytes + C::kABytes;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_ss<BN, 1>(acc, desc_sw128(a + 32 * ks, 16, 1024),
                          desc_sw128(b + ks * 16 * 128, BK * 128, 1024), kb > 0 || ks > 0);
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty[(it - 1) % C::kStages]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
      mbar_arrive(&empty[(it - 1) % C::kStages]);

      // epilogue: the last tile's TMA stores must have read the staging tile
      if (tid % 128 == 0) bulk_wait_read();
      named_sync(1 + wg, 128);
      // rows r and r + 8 share r % 8; opaque here, so that the compiler
      // cannot hoist a swizzled address per column out of the tile loop and
      // hold them all through the mainloop
      uint32_t r7 = r & 7;
      asm volatile("" : "+r"(r7));
      unsigned char* row = staging + r * 128 + 4 * q;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        unsigned char* p = row + (j / 8) * (64 * 128) + (((j & 7) ^ r7) << 4);
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(relu(acc[4 * j]), relu(acc[4 * j + 1]));
        *reinterpret_cast<uint32_t*>(p + 8 * 128) =
            pack_bf16(relu(acc[4 * j + 2]), relu(acc[4 * j + 3]));
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (tid % 128 == 0) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_store_2d(&ty, staging + b * (64 * 128), n0 + 64 * b, m0 + 64 * wg);
        bulk_commit();
      }
    }
    if (tid % 128 == 0) bulk_wait();
  }
}

template <int BN>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& ty, int n, int K,
           int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(relu_matmul_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<BN>::kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles = (n + BM - 1) / BM * (N / BN);
  relu_matmul_kernel<BN><<<tiles < sms ? tiles : sms, kThreads, Cfg<BN>::kSmem, stream>>>(
      tx, tw, ty, n, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, K], w [K, N], y [n, N], all bf16 row-major; K a multiple of 32, N a
// multiple of 128, n >= 1. Returns the CUDA error of the launch (0 on success).
int relu_matmul_launch(const void* x, const void* w, void* y, int n, int K, int N,
                       cudaStream_t stream) {
  CUtensorMap tx, tw, ty;
  int err = encode_tensor_map_bf16(&tx, x, K, n, (uint64_t)K * 2, 64, BM);
  if (err == 0) err = encode_tensor_map_bf16(&tw, w, N, K, (uint64_t)N * 2, 64, BK);
  if (err == 0) err = encode_tensor_map_bf16(&ty, y, N, n, (uint64_t)N * 2, 64, 64);
  if (err != 0) return err;
  return N % 256 == 0 ? launch<256>(tx, tw, ty, n, K, N, stream)
                      : launch<128>(tx, tw, ty, n, K, N, stream);
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
