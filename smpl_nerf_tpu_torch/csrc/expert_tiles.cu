// Fused sorted-tile expert forward on Hopper (sm_90a): positional encoding and
// both layers of one expert's tiny MLP per tile of the sorted token stream.
//
// Replaces the TPU kernel smpl_nerf_tpu/ops/expert_tiles_pallas.py:
// expert_tiles_forward (math in `_tile_math`). Plain version:
// smpl_nerf_tpu_torch/ops/expert_tiles.py:expert_tiles_reference.
//
//   enc = [local | sin(local*2^k (+pi/2)) | dirs | sin(dirs*2^k (+pi/2))]   (D columns)
//   h   = relu(cdt(enc) @ cdt(w0[e]) + b0[e])          float32 sums, float32 bias
//   out = (cdt(h) @ cdt(w1[e]) + b1[e]) where valid, else 0     [L, O] float32
// with e = tile_expert[slot / tile] and cdt = round to bf16 or identity.
//
// What bounds it on the H100: bytes. A slot reads 25 B (two float3 and one
// validity byte) and writes 16 B against 1,472 multiply-adds at D=42, H=32,
// O=4: ~72 operations per byte on tensor cores, far below the ~295 of the
// bf16 ridge point. Besides the bytes, each row evaluates 36 sines (sinf on
// the exact argument; `__sinf` is badly wrong at 2^(l_pos-1) * |x|), about as
// much work on the FMA pipes as the bytes take on the memory.
//
// bf16 (the served form), `expert_tiles_kernel_mma`:
// - One block per tile (256 threads, 8 warps), not per row segment. It
//   reads tile_expert[t] itself (clamped into [0, E), so a tile past the
//   used stream reads a real expert) and stages that expert once: w0 and w1
//   rounded to bf16 straight into the order of mma.m16n8k16's B fragments
//   (64 bits per lane per k16 x n8 step: conflict-free shared loads), b0 and
//   b1 in float32, a warp per row of w0 so that the reads coalesce. D is
//   padded to KS k16 steps (a template parameter), H to a multiple of 32, O
//   to one n8 tile; the padding is zeros. ~3.7 KB at D=42, H=32. A tile with
//   no valid slot writes zeros and reads no weights.
// - Products on tensor cores with `mma.sync.m16n8k16` (bf16 in, float32
//   accumulate). Not `wgmma`: the kernel is bound by bytes and sines, not by
//   products (3.4 us of bytes against 0.5 us of operations at the bf16 peak
//   on a served chunk), and wgmma's 64-row granule would waste the rows of
//   half-empty tiles.
// - A warp owns 16-row m-tiles of its tile (warp, warp + 8, ...), the next
//   one's inputs loaded while the current one computes (the first during the
//   staging). An m-tile whose slots are all padding (a ballot of valid)
//   writes zeros and skips the rest. Otherwise each lane encodes exactly the
//   values of its A fragments: rows g and g+8 (g = lane / 4), columns
//   16s + 2t + {0, 1, 8, 9} of k-step s (t = lane % 4), from its two rows'
//   six floats in registers; the encoding never touches shared or device
//   memory. The kernel orders the columns sines first ([sines of local |
//   sines of dirs | local | dirs | zeros], w0's rows staged to match), so
//   that an 8-column group past the sines runs no sine at all: 40 sines per
//   row at D=42 where 36 are needed (48 in the plain order). One sinf per
//   value, on an argument picked by select.
// - Layer 1 per 32 hidden units: KS x 4 mma into four n8 accumulators; then
//   + b0, relu, bf16. The accumulators of n8 tiles 2j and 2j+1 are exactly
//   the A fragment of layer 2's k16 step j, so layer 2 (2 mma per 32 hidden
//   units, n = O padded to 8) runs from registers. + b1, masked by valid; a
//   quad shuffle gathers a row's four outputs so that one lane stores them
//   with one 16-byte write (O = 4).
// - What it costs: the 1,344 FMAs a row took on CUDA cores are now 14 mma
//   per 16 rows, but the sines stay, and they and their column decode are
//   most of the time; `sinf` with the exact argument is kept (the plain
//   version's rounding), so a cheaper sine is a change of numbers, left out.
//
// float32 (`compute_dtype=None`), `expert_tiles_kernel_f32`: products stay
// exact float32 FMAs (TF32 would change the numbers against the Pallas
// kernel's float32 path). A block per 128-row segment of a tile, one row per
// thread: the row's D encoded values go to a shared column (stride 128: no
// bank conflicts), then 32 hidden units at a time accumulate in registers
// from broadcast float4 reads of w0. (One block per tile, its threads
// walking the segments, measured slower: fewer blocks in flight.)
//
// The launcher sets the dynamic shared-memory limit once per kernel and
// size, not on every launch.
#include "fused_mlp_common.cuh"
#include "hopper.cuh"

namespace {

using fused_mlp::encoding_arg;
using hopper::pack_bf16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHChunk = 32;       // hidden units per pass (4 n8 tiles; f32: registers)
constexpr int kOutN = 8;          // O padded to one n8 tile (bf16 path)
constexpr int kRows = 128;        // rows (threads) per block of the f32 path
constexpr int kOutPad = 4;        // O is padded to 4 in shared memory (f32 path)

__host__ __device__ inline int padded_hidden(int H) {
  return (H + kHChunk - 1) / kHChunk * kHChunk;
}

// ------------------------------------------------------------ bf16, mma.sync

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The kernel's column order puts the sines first, so that fewer lanes of a
// warp run a sine for a column that needs none: [np sines of local | sines of
// dirs | local(3) | dirs(3) | 0 ...] (D - 6 = ns sine columns). This maps a
// kernel column to the plain version's [local | sines | dirs | sines].
__device__ __forceinline__ int original_column(int c, int np, int ns) {
  if (c < np) return 3 + c;
  if (c < ns) return 6 + c;
  if (c < ns + 3) return c - ns;
  return c - ns + np;
}

// Kernel column c >= ns of a row: local, then dirs, then zeros.
__device__ __forceinline__ float identity_column(const float (&p)[3], const float (&q)[3], int c,
                                                 int ns) {
  const int j = c - ns;
  const float x = j < 3 ? (j == 0 ? p[0] : (j == 1 ? p[1] : p[2]))
                        : (j == 3 ? q[0] : (j == 4 ? q[1] : q[2]));
  return j < 6 ? x : 0.f;
}

// The four values of a lane's A registers for group (s, h): kernel columns
// c0 = 16s + 8h + 2t and c0 + 1 of its rows g and g+8, packed as bf16 pairs.
// One sinf per value, on an argument picked by select: a ternary between two
// sinf calls would have the compiler evaluate both. A group whose columns
// are all past the sines (a warp-uniform test) runs no sine at all.
__device__ __forceinline__ void encode_group(const float (&pa)[3], const float (&qa)[3],
                                             const float (&pb)[3], const float (&qb)[3], int c0,
                                             bool any_sine, int np, int ns, uint32_t& row_a,
                                             uint32_t& row_b) {
  float v[2][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = c0 + half;
    v[0][half] = identity_column(pa, qa, c, ns);
    v[1][half] = identity_column(pb, qb, c, ns);
  }
  if (any_sine) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + half;
      const bool is_pos = c < np, is_sine = c < ns;
      const int cc = is_pos ? c : (is_sine ? c - np : 0);
      const float ta = is_pos ? encoding_arg(pa[0], pa[1], pa[2], cc)
                              : encoding_arg(qa[0], qa[1], qa[2], cc);
      const float tb = is_pos ? encoding_arg(pb[0], pb[1], pb[2], cc)
                              : encoding_arg(qb[0], qb[1], qb[2], cc);
      const float sa = sinf(ta), sb = sinf(tb);
      if (is_sine) v[0][half] = sa, v[1][half] = sb;
    }
  }
  row_a = pack_bf16(v[0][0], v[0][1]);
  row_b = pack_bf16(v[1][0], v[1][1]);
}

// The slot of element (k, n) of a [KS*16, N] B operand in the fragment order:
// step k/16, n8 tile n/8, lane 4*(n%8) + (k%8)/2, register (k%16)/8, half k%2.
__device__ __forceinline__ int fragment_half(int k, int n, int n_tiles) {
  const int kk = k & 15;
  const int lane = 4 * (n & 7) + ((kk & 7) >> 1);
  return (((k >> 4) * n_tiles + (n >> 3)) * 32 + lane) * 4 + (kk >> 3) * 2 + (kk & 1);
}

// Shared memory of the bf16 kernel: the expert in fragment order (bf16 B
// fragments of w0 and w1, float32 biases).
size_t mma_shared_bytes(int KS, int H) {
  const int Hp = padded_hidden(H);
  return sizeof(uint2) * ((size_t)KS * (Hp / 8) * 32 + (size_t)(Hp / 16) * 32)
         + sizeof(float) * (Hp + kOutN);
}

__device__ __forceinline__ void store_row(float* out, size_t row, int O, float4 v) {
  if (O == 4) {
    *reinterpret_cast<float4*>(out + row * 4) = v;
  } else {
    const float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int o = 0; o < 4; ++o)
      if (o < O) out[row * O + o] = r[o];
  }
}

// One 16-row m-tile's inputs for a lane: the ballot of valid slots (bit i =
// row row0 + i) and the coordinates of its rows g and g+8 (zero past the tile).
struct MTile {
  unsigned vm;
  float pa[3], qa[3], pb[3], qb[3];
};

__device__ __forceinline__ MTile load_m_tile(const float* __restrict__ local,
                                             const float* __restrict__ dirs,
                                             const unsigned char* __restrict__ valid,
                                             size_t base, int row0, int tile, int lane) {
  MTile m;
  const int r = row0 + (lane & 15);
  m.vm = __ballot_sync(kFull, lane < 16 && r < tile && valid[base + r] != 0);
  const int g = lane >> 2;
  const size_t ra = base + row0 + g, rb = ra + 8;
  const bool in_a = row0 + g < tile, in_b = row0 + g + 8 < tile;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m.pa[c] = in_a ? local[ra * 3 + c] : 0.f;
    m.qa[c] = in_a ? dirs[ra * 3 + c] : 0.f;
    m.pb[c] = in_b ? local[rb * 3 + c] : 0.f;
    m.qb[c] = in_b ? dirs[rb * 3 + c] : 0.f;
  }
  return m;
}

constexpr int kThreadsMma = 256;  // 8 warps per tile
constexpr int kWarpsMma = kThreadsMma / 32;
// Blocks per SM the register budget is cut for: three (85 registers a
// thread) up to D=48, where ptxas spills a few words at D=42 and that still
// ran faster than two blocks without a spill; two for wider encodings,
// whose A fragments spill hundreds of bytes under three (two: less; neither
// timed).
#define EXPERT_TILES_MIN_BLOCKS(KS) ((KS) <= 3 ? 3 : 2)

// Expert e's weights, rounded to bf16 into the B-fragment order (rows of w0
// in the kernel's column order, zero padding), biases in float32. A warp
// per row of w0: coalesced reads, all of a thread's loads in flight at once.
template <int KS>
__device__ __forceinline__ void stage_expert(const float* __restrict__ w0e,
                                             const float* __restrict__ b0e,
                                             const float* __restrict__ w1e,
                                             const float* __restrict__ b1e, uint2* w0f,
                                             uint2* w1f, float* b0s, float* b1s, int D, int H,
                                             int O, int np, int ns, int tid) {
  const int Hp = padded_hidden(H), NT = Hp / 8;
  const int warp = tid >> 5, lane = tid & 31;
  __nv_bfloat16* w0h = reinterpret_cast<__nv_bfloat16*>(w0f);
#pragma unroll
  for (int k = warp; k < KS * 16; k += kWarpsMma) {
    const float* row = w0e + (k < D ? original_column(k, np, ns) : 0) * H;
    for (int n = lane; n < Hp; n += 32)
      w0h[fragment_half(k, n, NT)] = __float2bfloat16_rn(k < D && n < H ? row[n] : 0.f);
  }
  __nv_bfloat16* w1h = reinterpret_cast<__nv_bfloat16*>(w1f);
  for (int i = tid; i < Hp * kOutN; i += kThreadsMma) {
    const int k = i / kOutN, n = i - k * kOutN;
    w1h[fragment_half(k, n, 1)] = __float2bfloat16_rn(k < H && n < O ? w1e[k * O + n] : 0.f);
  }
  for (int j = tid; j < Hp; j += kThreadsMma) b0s[j] = j < H ? b0e[j] : 0.f;
  if (tid < kOutN) b1s[tid] = tid < O ? b1e[tid] : 0.f;
}

template <int KS>
__global__ void __launch_bounds__(kThreadsMma, EXPERT_TILES_MIN_BLOCKS(KS))
expert_tiles_kernel_mma(const float* __restrict__ local, const float* __restrict__ dirs,
                        const unsigned char* __restrict__ valid,
                        const int* __restrict__ tile_expert, const float* __restrict__ w0,
                        const float* __restrict__ b0, const float* __restrict__ w1,
                        const float* __restrict__ b1, float* __restrict__ out, int tile, int E,
                        int D, int H, int O, int l_pos) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hp = padded_hidden(H);
  const int NT = Hp / 8;                                       // n8 tiles of layer 1
  uint2* w0f = reinterpret_cast<uint2*>(smem);                 // [KS][NT][32]
  uint2* w1f = w0f + KS * NT * 32;                             // [Hp/16][32]
  float* b0s = reinterpret_cast<float*>(w1f + (Hp / 16) * 32);  // [Hp]
  float* b1s = b0s + Hp;                                       // [kOutN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = 6 * l_pos, ns = D - 6;
  const int m_tiles = (tile + 15) / 16;
  const size_t base = (size_t)blockIdx.x * tile;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  int e = tile_expert[blockIdx.x];          // issued early: its latency overlaps the check

  int any = 0;
  for (int r = tid; r < tile; r += kThreadsMma) any |= valid[base + r];
  if (!__syncthreads_or(any)) {            // nothing real here: zeros, no weights read
    for (int r = tid; r < tile; r += kThreadsMma) store_row(out, base + r, O, zero4);
    return;
  }
  // the warp's first m-tile's inputs, in flight during the staging
  MTile m = load_m_tile(local, dirs, valid, base, 16 * warp, tile, lane);
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);
  stage_expert<KS>(w0 + (size_t)e * D * H, b0 + (size_t)e * H, w1 + (size_t)e * H * O,
                   b1 + (size_t)e * O, w0f, w1f, b0s, b1s, D, H, O, np, ns, tid);
  __syncthreads();

  for (int mt = warp; mt < m_tiles; mt += kWarpsMma) {
    const int row0 = mt * 16;
    const MTile cur = m;
    if (mt + kWarpsMma < m_tiles)        // the next m-tile's loads fly during this one
      m = load_m_tile(local, dirs, valid, base, row0 + 16 * kWarpsMma, tile, lane);
    if (cur.vm == 0) {                   // all padding: zeros
      const int r = row0 + (lane & 15);
      if (lane < 16 && r < tile) store_row(out, base + r, O, zero4);
      continue;
    }
    // A fragments of the encoding: registers 2h (row g) and 2h+1 (row g+8)
    // hold kernel columns 16s + 8h + 2t, +1
    uint32_t a[KS][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        encode_group(cur.pa, cur.qa, cur.pb, cur.qb, 16 * s + 8 * h + 2 * t,
                     16 * s + 8 * h < ns, np, ns, a[s][2 * h], a[s][2 * h + 1]);
    }
    float acc2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int hc = 0; hc < Hp / kHChunk; ++hc) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[j], a[s], w0f[(s * NT + hc * 4 + j) * 32 + lane]);
      }
      // + b0, relu, bf16: n8 tiles 2j2 and 2j2+1 are layer 2's k-step j2
      uint32_t h2[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bias0 = b0s[hc * kHChunk + 8 * j + 2 * t];
        const float bias1 = b0s[hc * kHChunk + 8 * j + 2 * t + 1];
        h2[j >> 1][2 * (j & 1)] =
            pack_bf16(fmaxf(acc[j][0] + bias0, 0.f), fmaxf(acc[j][1] + bias1, 0.f));
        h2[j >> 1][2 * (j & 1) + 1] =
            pack_bf16(fmaxf(acc[j][2] + bias0, 0.f), fmaxf(acc[j][3] + bias1, 0.f));
      }
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) mma_bf16(acc2, h2[j2], w1f[(hc * 2 + j2) * 32 + lane]);
    }
    // outputs 2t, 2t+1 of rows g (acc2[0..1]) and g+8 (acc2[2..3]), + b1, masked
    const bool ok_a = (cur.vm >> g) & 1u, ok_b = (cur.vm >> (g + 8)) & 1u;
    const float bias0 = b1s[2 * t], bias1 = b1s[2 * t + 1];
    const float2 oa =
        ok_a ? make_float2(acc2[0] + bias0, acc2[1] + bias1) : make_float2(0.f, 0.f);
    const float2 ob =
        ok_b ? make_float2(acc2[2] + bias0, acc2[3] + bias1) : make_float2(0.f, 0.f);
    // lane t=0 writes row g, t=1 row g+8: each takes its partner's half
    const float2 send = (t & 1) ? oa : ob;
    const float2 got = make_float2(__shfl_xor_sync(kFull, send.x, 1),
                                   __shfl_xor_sync(kFull, send.y, 1));
    const size_t ra = base + row0 + g;
    if (t == 0 && row0 + g < tile) store_row(out, ra, O, make_float4(oa.x, oa.y, got.x, got.y));
    if (t == 1 && row0 + g + 8 < tile)
      store_row(out, ra + 8, O, make_float4(got.x, got.y, ob.x, ob.y));
  }
}

// ------------------------------------------------------ float32, CUDA cores

__global__ void __launch_bounds__(kRows)
expert_tiles_kernel_f32(const float* __restrict__ local, const float* __restrict__ dirs,
                        const unsigned char* __restrict__ valid,
                        const int* __restrict__ tile_expert, const float* __restrict__ w0,
                        const float* __restrict__ b0, const float* __restrict__ w1,
                        const float* __restrict__ b1, float* __restrict__ out, int tile, int E,
                        int D, int H, int O, int l_pos, int l_dir) {
  extern __shared__ __align__(16) float smemf[];
  const int Hp = padded_hidden(H);
  float* w0s = smemf;                     // [D, Hp]
  float* b0s = w0s + D * Hp;              // [Hp]
  float* w1s = b0s + Hp;                  // [Hp, kOutPad]
  float* b1s = w1s + Hp * kOutPad;        // [kOutPad]
  float* encs = b1s + kOutPad;            // [D, kRows]

  const int tid = threadIdx.x;
  const int in_tile = blockIdx.y * kRows + tid;
  const bool in_range = in_tile < tile;
  const size_t row = (size_t)blockIdx.x * tile + in_tile;
  const bool ok = in_range && valid[row] != 0;

  if (!__syncthreads_or(ok)) {            // nothing real here: zeros, no weights read
    if (in_range) store_row(out, row, O, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }

  int e = tile_expert[blockIdx.x];
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);
  for (int i = tid; i < D * Hp; i += kRows) {
    const int d = i / Hp, j = i - d * Hp;
    w0s[i] = j < H ? w0[((size_t)e * D + d) * H + j] : 0.f;
  }
  for (int j = tid; j < Hp; j += kRows) b0s[j] = j < H ? b0[(size_t)e * H + j] : 0.f;
  for (int i = tid; i < Hp * kOutPad; i += kRows) {
    const int j = i / kOutPad, o = i - j * kOutPad;
    w1s[i] = (j < H && o < O) ? w1[((size_t)e * H + j) * O + o] : 0.f;
  }
  if (tid < kOutPad) b1s[tid] = tid < O ? b1[(size_t)e * O + tid] : 0.f;

  if (in_range) {
    float p[3], q[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = local[row * 3 + c];
      q[c] = dirs[row * 3 + c];
    }
    const int np = 6 * l_pos, nd = 6 * l_dir;
    int d = 0;
    for (int c = 0; c < 3; ++c) encs[(d++) * kRows + tid] = p[c];
    for (int c = 0; c < np; ++c) encs[(d++) * kRows + tid] = sinf(encoding_arg(p, c));
    for (int c = 0; c < 3; ++c) encs[(d++) * kRows + tid] = q[c];
    for (int c = 0; c < nd; ++c) encs[(d++) * kRows + tid] = sinf(encoding_arg(q, c));
  }
  __syncthreads();
  if (!in_range) return;

  float acc[kOutPad];
#pragma unroll
  for (int o = 0; o < kOutPad; ++o) acc[o] = b1s[o];
  for (int hc = 0; hc < Hp; hc += kHChunk) {
    float h[kHChunk];
#pragma unroll
    for (int j = 0; j < kHChunk; ++j) h[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = encs[d * kRows + tid];
      const float4* w = reinterpret_cast<const float4*>(w0s + d * Hp + hc);
#pragma unroll
      for (int j4 = 0; j4 < kHChunk / 4; ++j4) {
        const float4 v = w[j4];
        h[4 * j4 + 0] = fmaf(x, v.x, h[4 * j4 + 0]);
        h[4 * j4 + 1] = fmaf(x, v.y, h[4 * j4 + 1]);
        h[4 * j4 + 2] = fmaf(x, v.z, h[4 * j4 + 2]);
        h[4 * j4 + 3] = fmaf(x, v.w, h[4 * j4 + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHChunk; ++j) {
      float a = h[j] + b0s[hc + j];
      a = a > 0.f ? a : 0.f;
      const float4 v = *reinterpret_cast<const float4*>(w1s + (hc + j) * kOutPad);
      acc[0] = fmaf(a, v.x, acc[0]);
      acc[1] = fmaf(a, v.y, acc[1]);
      acc[2] = fmaf(a, v.z, acc[2]);
      acc[3] = fmaf(a, v.w, acc[3]);
    }
  }
  store_row(out, row, O, ok ? make_float4(acc[0], acc[1], acc[2], acc[3])
                            : make_float4(0.f, 0.f, 0.f, 0.f));
}

size_t f32_shared_bytes(int D, int H) {
  const int Hp = padded_hidden(H);
  return sizeof(float) * ((size_t)D * Hp + Hp + Hp * kOutPad + kOutPad + (size_t)D * kRows);
}

// cudaFuncSetAttribute once per kernel, device and size: a launch needs it
// only above 48 KB, and a larger maximum covers every smaller size.
cudaError_t allow_shared(const void* kernel, size_t bytes) {
  constexpr int kSlots = 16, kDevices = 16;
  static const void* kernels[kSlots];
  static size_t allowed[kSlots][kDevices];
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int slot = 0;
  while (slot < kSlots && kernels[slot] != nullptr && kernels[slot] != kernel) ++slot;
  const bool cached = slot < kSlots && dev < kDevices;
  if (cached && kernels[slot] == kernel && allowed[slot][dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && cached) {
    kernels[slot] = kernel;
    allowed[slot][dev] = bytes;
  }
  return err;
}

template <int KS>
cudaError_t launch_mma(const float* local, const float* dirs, const unsigned char* valid,
                       const int* tile_expert, const float* w0, const float* b0, const float* w1,
                       const float* b1, float* out, int L, int tile, int E, int D, int H, int O,
                       int l_pos, cudaStream_t stream) {
  const size_t bytes = mma_shared_bytes(KS, H);
  cudaError_t err = allow_shared((const void*)expert_tiles_kernel_mma<KS>, bytes);
  if (err != cudaSuccess) return err;
  expert_tiles_kernel_mma<KS><<<L / tile, kThreadsMma, bytes, stream>>>(
      local, dirs, valid, tile_expert, w0, b0, w1, b1, out, tile, E, D, H, O, l_pos);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses experts whose
// block does not fit.
int expert_tiles_shared_bytes(int D, int H, int use_bf16) {
  return (int)(use_bf16 ? mma_shared_bytes((D + 15) / 16, H) : f32_shared_bytes(D, H));
}

// local, dirs [L, 3] float32; valid [L] bytes; tile_expert [L / tile] int32;
// w0 [E, D, H], b0 [E, H], w1 [E, H, O], b1 [E, O] float32; out [L, O] float32,
// every element written. D = 6 + 6 * (l_pos + l_dir), O <= 4, L a multiple of
// tile; bf16 needs D <= 128. Returns the CUDA error of the launch (0 on success).
int expert_tiles_launch(const float* local, const float* dirs, const unsigned char* valid,
                        const int* tile_expert, const float* w0, const float* b0,
                        const float* w1, const float* b1, float* out, int L, int tile, int E,
                        int D, int H, int O, int l_pos, int l_dir, int use_bf16,
                        cudaStream_t stream) {
  cudaError_t err;
  if (use_bf16) {
#define EXPERT_TILES_MMA(KS)                                                                    \
  case KS:                                                                                     \
    err = launch_mma<KS>(local, dirs, valid, tile_expert, w0, b0, w1, b1, out, L, tile, E, D, \
                         H, O, l_pos, stream);                                                 \
    break;
    switch ((D + 15) / 16) {  // KS <= 8: D <= 128 (the wrapper's MAX_BF16_INPUTS)
      EXPERT_TILES_MMA(1)
      EXPERT_TILES_MMA(2)
      EXPERT_TILES_MMA(3)
      EXPERT_TILES_MMA(4)
      EXPERT_TILES_MMA(5)
      EXPERT_TILES_MMA(6)
      EXPERT_TILES_MMA(7)
      EXPERT_TILES_MMA(8)
      default: err = cudaErrorInvalidValue;
    }
#undef EXPERT_TILES_MMA
  } else {
    const size_t bytes = f32_shared_bytes(D, H);
    err = allow_shared((const void*)expert_tiles_kernel_f32, bytes);
    if (err == cudaSuccess) {
      const dim3 grid(L / tile, (tile + kRows - 1) / kRows);
      expert_tiles_kernel_f32<<<grid, kRows, bytes, stream>>>(
          local, dirs, valid, tile_expert, w0, b0, w1, b1, out, tile, E, D, H, O, l_pos, l_dir);
      err = cudaGetLastError();
    }
  }
  return (int)err;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
