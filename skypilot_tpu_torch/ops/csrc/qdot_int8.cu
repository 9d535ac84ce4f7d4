// W8A16 product for Hopper (sm_90a): y[M, N] = bf16(bf16(sum_k x[m, k] *
// q[k, n]) * scale[n]), bf16 x [M, K] and int8 q [K, N], both row-major,
// a bf16 scale per output column, fp32 sums.
//
// Replaces: no Pallas kernel. The reference's qdot on a QuantArray
// (skypilot_tpu/ops/quant.py, qdot, lines 73-81) is x @ q.astype(bf16)
// followed by the scale, and XLA fuses the int8 -> bf16 convert into the
// dot's operand read, so the weight stays int8 in device memory. Eager
// torch would write a bf16 copy of every weight on every step; this
// kernel is that fusion.
//
// What bounds it on the H100: bytes, at the row counts serving runs (M =
// 1 for a chunk's last-row logits, 64 or 128 for a decode or verify step
// on 8 or 16 slots, up to 256 for a prefill chunk). The weight's K * N
// int8 bytes dominate (58.7 MB for an 8B MLP weight: 17.5 us at 3.35
// TB/s), against 2 * M * K * N operations (7.5 GFLOP at M = 64: 7.6 us
// at 989 TFLOP/s). At 64 rows that is 128 FLOP a weight byte, about 430
// TFLOP/s at the memory's rate: warpgroup products reach it with the
// instruction slots to spare for the convert. On the H100 the tile loads
// alone (no convert, no product) take most of the kernel's time, an
// SM's load rate barely moves with its ring's depth, and each launch
// pays a fixed cost (the first loads, the merge, the stores) that rivals
// a small weight's streaming time: so the design spreads every weight
// over as many SMs as it can and keeps those fixed costs short.
//
// What the design does about it:
//
// - Swapped operands. A block computes y^T = q^T x^T for a tile of 128
//   output columns and 64 or 128 rows of x. Its consumer warpgroup owns
//   the 128 columns as the 64-row A side of two wgmma products per
//   16-deep step, A from registers: the weight, converted from int8
//   once, on its way from shared memory into the A fragments (no bf16
//   weight tile anywhere). x is the B side, K-major in shared memory (x
//   is row-major [M, K]): n = 64 rows of x when M <= 64, else n = 128
//   (128 fp32 sums a thread), so a tile of 128 rows converts each weight
//   tile once; above 128 rows a grid dimension takes each further 128
//   rows. Rows past M are TMA's zeros. A row's bits are the same in an
//   n = 64 and an n = 128 product (chip_smoke.py phase 3 holds every row
//   bitwise across M), so they cannot depend on M.
// - The A fragment's K pairs. A register of an A fragment pairs two
//   K-neighbours of one A row, which lie a staged row apart in the int8
//   tile. Output columns are independent, so the kernel picks which
//   column each fragment row carries: thread (warp w, g = lane / 4, t =
//   lane % 4) carries columns 32w + 4g .. 32w + 4g + 3 of the 128 in its
//   two products' rows (16w + g, 16w + g + 8), so one 32-bit read of a
//   staged row gives its four values of that row. Four reads (rows 2t,
//   2t + 1, 2t + 8, 2t + 9 of a 16-deep step) give both products' A
//   fragments; under the 128-byte swizzle a warp's reads hit 32 banks.
//   Each byte becomes a bf16 exactly (|q| <= 127) by integer and add
//   instructions (byte_perm into the bits of 2^23 + 128 + q, minus 2^23
//   + 128), and the high halves of two such floats make a bf16 pair.
// - Loads. One thread of a producer warpgroup (registers handed to the
//   consumer by setmaxnreg) feeds a ring of stages by TMA, each a 64 x
//   128 int8 weight box and one or two 64 x 64 bf16 x boxes (hopper.cuh's
//   subtile layout), completion counted on mbarriers; TMA fills boxes
//   past M and N with zeros, and an x box wholly past M is not loaded
//   (its products run on stale data and are dropped). The weight is
//   loaded with an L2 evict-first policy: it is read once, and its lines
//   should not push out what the step reads again (x, activations, the
//   KV pages), nor make the loads pay for writing back dirty lines. The
//   consumer is a
//   software pipeline: step i's products run while step i + 1's A
//   fragments are read and converted into the other register buffer,
//   and a stage is released once its products are done. Two blocks share
//   an SM, so one block's merge and stores overlap the other's loads.
// - Split-K by a cluster. A [K, N] weight with few column tiles would
//   leave most of the 132 SMs idle (4096 x 1024 has 8), so K splits into
//   S contiguous ranges: the most splits (at most kMaxSplits) that keep
//   each at least kMinStepsPerSplit steps deep, the grid at most
//   kTargetBlocks blocks, and all its clusters of S on the card at once
//   (cudaOccupancyMaxActiveClusters: a cluster that does not fit waits
//   for a second wave). Fixed by (K, N) and the card, never by M. The S
//   blocks of a tile form one thread-block cluster.
// - Epilogue. The sums hold y^T. After a cluster barrier (every block is
//   done with its ring), each thread stores its sums, a float4 of four
//   neighbouring columns a row, straight into the shared memory of the
//   block of the cluster that merges those rows (remote stores do not
//   wait; remote loads, each block pulling its rows, were slower).
//   After a second barrier each block adds its rows' S partial sums from
//   its own shared memory in split order 0, 1, ..., S - 1, and writes 8
//   neighbouring columns of a row with one 16-byte store: the fp32 sum
//   rounded to bf16, times the column's bf16 scale (loaded before the
//   main loop), rounded again (the reference's two roundings). No
//   workspace, no atomics: the same bits on every run, and capturable in
//   a CUDA graph.
//
// A row's bits depend on its own x row and on (K, N) only: the reduction
// order over K is the 16-deep products in order within a split, the
// split order after, and neither depends on M or on which block or row
// tile holds the row. So a decode step's rows equal the same rows in a
// verify or chunk product, which the serving invariants (verify query 0
// == decode, fused on == off, depth 0 == 1) rest on.
//
// Interface: plain C functions bound with ctypes. qdot_int8 encodes its
// two tensor maps on every call (a cached map could outlive its
// tensor), launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or -1 for a shape it does not take: M >= 1, K a
// multiple of 64, N a multiple of 16; or hopper::kNoEncoder /
// kEncodeFailed when a tensor map cannot be made); the pointers must be
// 16-byte aligned. qdot_int8_splits(K, N) is S.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

// Tuning constants.
constexpr int kRingBytes = 98304;   // shared memory of a block's ring
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kTargetBlocks = 264;  // two blocks on each of 132 SMs
constexpr int kMinStepsPerSplit = 4;

constexpr int kBK = 64;              // K a step
constexpr int kBN = 128;             // columns a block
constexpr int kThreads = 256;        // producer + consumer warpgroup
constexpr int kBlocksPerSm = 2;
constexpr int kBox = 8192;           // a weight box or an x box, bytes
constexpr int kPartRow = kBN + 4;    // fp32 receive tile row, padded

// Rows of a block's receive tiles (see the exchange below) at the split
// count that needs the most, for 64 TT rows.
constexpr int recv_rows(int tt) {
  int most = 0;
  for (int s = 1; s <= kMaxSplits; ++s) {
    const int rows = (8 * tt + s - 1) / s * 8 * s;
    most = rows > most ? rows : most;
  }
  return most;
}

// Shared memory of the instance with TT row tiles of 64 a block.
template <int TT>
struct Layout {
  static constexpr int kRows = 64 * TT;
  static constexpr int kStageBytes = (1 + TT) * kBox;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kBarOff = kStages * kStageBytes;  // full[], empty[]
  static constexpr size_t kSmem = kBarOff + 16 * kStages + 1024;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(recv_rows(TT) * kPartRow * 4 <= kBarOff,
                "the receive tiles must fit over the ring");
  static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472,
                "two blocks' rings exceed an SM's shared memory");
};


// Byte e of w (int8) as an fp32, exactly: w ^ 0x80 turns each signed
// byte into q + 128, byte_perm puts it under the exponent of 2^23, and
// subtracting 2^23 + 128 leaves q.
__device__ __forceinline__ float byte_as_float(uint32_t w_xor, int e) {
  return __uint_as_float(__byte_perm(w_xor, 0x4B000000u, 0x7540 | e)) -
         8388736.f;
}

// b[j] = bf16 pair (lo row's byte j, hi row's byte j), the lower K in the
// lower half.
__device__ __forceinline__ void b_pairs(uint32_t lo, uint32_t hi,
                                        uint32_t* b) {
  lo ^= 0x80808080u;
  hi ^= 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = __byte_perm(__float_as_uint(byte_as_float(lo, j)),
                       __float_as_uint(byte_as_float(hi, j)), 0x7632);
}

// bf16(bf16(sum) * scale) for 8 neighbouring columns (their 8 scales
// in s), one 16-byte store.
__device__ __forceinline__ void store8(__nv_bfloat16* out, const uint4& s,
                                       const float (&v)[8]) {
  const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(&s);
  uint4 y;
  __nv_bfloat16* yv = reinterpret_cast<__nv_bfloat16*>(&y);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    yv[e] = __float2bfloat16_rn(
        __bfloat162float(__float2bfloat16_rn(v[e])) *
        __bfloat162float(sv[e]));
  *reinterpret_cast<uint4*>(out) = y;
}

// Product p of a 16-deep step over the block's 64 TT rows (n = 64 TT).
template <int TT>
__device__ __forceinline__ void product(float (&d)[32 * TT],
                                        const uint32_t* a, uint64_t desc_b,
                                        int accumulate) {
  if constexpr (TT == 1)
    wgmma_rs_kb_n64(d, a, desc_b, accumulate);
  else
    wgmma_rs_kb_n128(d, a, desc_b, accumulate);
}

// grid (splits, ceil(M / (64 TT)), ceil(N / kBN)), clusters of (splits,
// 1, 1); TT row tiles of 64 a block (1 when M <= 64, else 2).
template <int TT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
qdot_int8_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __nv_bfloat16* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N,
                 int splits) {
  using L = Layout<TT>;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring so.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + L::kBarOff;
  const uint32_t empty0 = full0 + 8 * L::kStages;

  const int split = blockIdx.x;
  const int m0 = blockIdx.y * L::kRows;
  const int n0 = blockIdx.z * kBN;
  const int k_steps = K / kBK;
  const int s0 = split * k_steps / splits;
  const int n_steps = (split + 1) * k_steps / splits - s0;
  const int x_live = min(TT, (M - m0 + 63) / 64);  // x boxes below M

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      // The weight is read once: its lines leave L2 first.
      const uint64_t once = evict_first_policy();
      const uint32_t bytes = (1 + x_live) * kBox;
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % L::kStages;
        mbar_wait(empty0 + 8 * s, ((i / L::kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t stage = base + s * L::kStageBytes;
        const int k = (s0 + i) * kBK;
        mbar_expect_tx(full, bytes);
        tma_load(stage, &tm_q, full, n0, k, once);
        for (int t = 0; t < x_live; ++t)
          tma_load(stage + (1 + t) * kBox, &tm_x, full, k, m0 + 64 * t);
      }
    }
    __syncwarp();
    if (splits > 1) {
      cluster.sync();  // every block is done with its ring
      cluster.sync();  // every block's sums are in place
    }
    return;
  }

  regs_alloc<232>();
  // The 8 columns this thread writes in the epilogue are the same in
  // every row it merges: their scales are loaded now, off the tail.
  const int tid = threadIdx.x - 128;
  const int col = (tid % (kBN / 8)) * 8;
  const bool col_live = col < N - n0;
  const uint4 col_scale = col_live
      ? *reinterpret_cast<const uint4*>(scale + n0 + col) : uint4{};
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  // This thread's 32-bit word of a staged weight row 2t (+ 16 kk, + 8)
  // and of row 2t + 1, under the 128-byte swizzle (16-byte chunk j of
  // row r lies at chunk j ^ (r % 8)).
  const int chunk = 2 * warp + (g >> 2);
  const int word = 4 * (g & 3);
  const int even = 2 * t * 128 + ((chunk ^ (2 * t)) << 4) + word;
  const int odd = (2 * t + 1) * 128 + ((chunk ^ (2 * t + 1)) << 4) + word;

  // Step i's A fragments, once its stage has landed: a[8 kk + 4 p ..] is
  // product p's fragment of 16-deep step kk. No product or conversion
  // is in a branch: ptxas serializes the products of a divergent path.
  auto convert = [&](int i, uint32_t(&a)[kBK / 2]) {
    const int s = i % L::kStages;
    mbar_wait(full0 + 8 * s, (i / L::kStages) & 1);
    const unsigned char* w = smem + s * L::kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned char* r = w + kk * 16 * 128;
      uint32_t lo[4], hi[4];
      b_pairs(*reinterpret_cast<const uint32_t*>(r + even),
              *reinterpret_cast<const uint32_t*>(r + odd), lo);
      b_pairs(*reinterpret_cast<const uint32_t*>(r + even + 8 * 128),
              *reinterpret_cast<const uint32_t*>(r + odd + 8 * 128), hi);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        a[8 * kk + 4 * p] = lo[2 * p];
        a[8 * kk + 4 * p + 1] = lo[2 * p + 1];
        a[8 * kk + 4 * p + 2] = hi[2 * p];
        a[8 * kk + 4 * p + 3] = hi[2 * p + 1];
      }
    }
  };

  // A software pipeline over the steps: step i's products run while
  // step i + 1's fragments are read and converted into the other
  // buffer (whose products, step i - 1's, are waited for first); a
  // stage is released once its products are done.
  float acc[2][32 * TT];
  uint32_t a_even[kBK / 2], a_odd[kBK / 2];
  auto step = [&](int i, uint32_t(&cur)[kBK / 2], uint32_t(&next)[kBK / 2]) {
    const uint32_t xs = base + (i % L::kStages) * L::kStageBytes + kBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
        product<TT>(acc[p], cur + 8 * kk + 4 * p, desc_k(xs, kk),
                    i > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    pin(next);
    if (i > 0) {  // step i - 1's products are done: free its stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % L::kStages));
    }
    if (i + 1 < n_steps) convert(i + 1, next);
  };
  convert(0, a_even);
  for (int i = 0; i < n_steps; i += 2) {
    step(i, a_even, a_odd);
    if (i + 1 < n_steps) step(i + 1, a_odd, a_even);
  }
  wgmma_wait_all();
  pin(acc[0]);
  pin(acc[1]);
  pin(a_even);
  pin(a_odd);

  // The exchange: the rows of 8-row group j are merged by block j %
  // splits of the cluster. Once every block is done with its ring (the
  // receive tiles lie over it), each thread stores its sums straight
  // into the merging block's shared memory: its local row lr = (j /
  // splits) * 8 + r % 8, split sp at [lr][sp][kBN] fp32. Product p's
  // d[4j + e] is column 32 warp + 4g + 2p of the tile, row 8j + 2t + e;
  // d[4j + 2 + e] the next column.
  const int rank = (int)cluster.block_rank();
  if (splits > 1)
    cluster.sync();
  else
    bar_sync(1, 128);
  float* recv = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 8 * TT; ++j) {
    float* dst = cluster.map_shared_rank(recv, (unsigned)(j % splits)) +
                 32 * warp + 4 * g;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int lr = (j / splits) * 8 + 2 * t + e;
      *reinterpret_cast<float4*>(dst + (lr * splits + split) * kPartRow) =
          make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                      acc[1][4 * j + e], acc[1][4 * j + 2 + e]);
    }
  }
  if (splits > 1)
    cluster.sync();
  else
    bar_sync(1, 128);

  // This block's rows, summed in split order: thread tid takes 8-column
  // group tid % 16 of local rows tid / 16, + 8, ...
  const int rows = min(L::kRows, M - m0);
  for (int lr = tid / (kBN / 8); col_live; lr += 128 / (kBN / 8)) {
    const int r = (lr / 8 * splits + rank) * 8 + lr % 8;
    if (r >= rows) break;
    const float4* p =
        reinterpret_cast<const float4*>(recv + lr * splits * kPartRow + col);
    float4 lo = p[0], hi = p[1];
    for (int sp = 1; sp < splits; ++sp) {
      const float4 a = p[sp * kPartRow / 4], b = p[sp * kPartRow / 4 + 1];
      lo.x += a.x, lo.y += a.y, lo.z += a.z, lo.w += a.w;
      hi.x += b.x, hi.y += b.y, hi.z += b.z, hi.w += b.w;
    }
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store8(out + (size_t)(m0 + r) * N + n0 + col, col_scale, v);
  }
}

// The launch configuration of the instance with TT row tiles a block:
// `grid`, in clusters of (grid.x, 1, 1); `attr` holds the cluster size.
template <int TT>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1],
                      dim3 grid, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Layout<TT>::kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaFuncSetAttribute(qdot_int8_kernel<TT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Layout<TT>::kSmem);
}

// One launch of the instance with TT row tiles a block.
template <int TT>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_q,
           const void* scale, void* out, int M, int K, int N, int splits,
           cudaStream_t stream) {
  using L = Layout<TT>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<TT>(
      cfg, attr,
      dim3(splits, (M + L::kRows - 1) / L::kRows, (N + kBN - 1) / kBN),
      stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, qdot_int8_kernel<TT>, tm_x, tm_q,
                           static_cast<const __nv_bfloat16*>(scale),
                           static_cast<__nv_bfloat16*>(out), M, K, N, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `size` blocks the card runs at once, once per device.
int max_clusters(int size) {
  static int known[16][kMaxSplits + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  int& n = known[dev][size];
  if (n == 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int found = 0;
    if (configure<1>(cfg, attr, dim3(size, 1, 1), nullptr) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&found, (void*)qdot_int8_kernel<1>,
                                       &cfg) != cudaSuccess)
      found = 0;
    cudaGetLastError();
    n = found > 0 ? found : -1;
  }
  return n;
}

// S: the most splits that keep every split at least kMinStepsPerSplit
// steps, the grid at most kTargetBlocks blocks, and all the tiles'
// clusters on the card at once. Fixed by (K, N) and the card.
int n_splits(int K, int N) {
  const int tiles = (N + kBN - 1) / kBN;
  const int by_k = K / kBK / kMinStepsPerSplit;
  int best = 1;
  for (int s = 2; s <= kMaxSplits && s <= by_k && tiles * s <= kTargetBlocks;
       ++s)
    if (tiles <= max_clusters(s)) best = s;
  return best;
}

}  // namespace

extern "C" int qdot_int8_splits(int K, int N) { return n_splits(K, N); }

extern "C" int qdot_int8(const void* x, const void* q, const void* scale,
                         void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < kBK || K % kBK != 0 || N < 16 || N % 16 != 0) return -1;
  if ((M + 127) / 128 > 65535 || (N + kBN - 1) / kBN > 65535) return -1;
  CUtensorMap tm_x, tm_q;
  int err = make_map(&tm_x, x, (uint64_t)M, K);
  if (!err) err = make_map_i8(&tm_q, q, (uint64_t)K, N);
  if (err) return err;
  const int splits = n_splits(K, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M <= 64 ? launch<1>(tm_x, tm_q, scale, out, M, K, N, splits, s)
                 : launch<2>(tm_x, tm_q, scale, out, M, K, N, splits, s);
}
