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
// at 989 TFLOP/s). At 64 rows the x tiles are as many bytes a step as
// the weight's (from L2), and the small weights are dominated by the
// fill and drain of their few steps (times in PERF.md).
//
// What the design does about it:
//
// - Tiles. A block computes a 64-row x 128-column tile of y over a range
//   of K in 64-deep steps, with 4 warps: warp w owns columns 32w..32w+31
//   of the tile and every row, as 4 M-tiles of 16 rows x 4 N-tiles of 8
//   columns of mma.sync m16n8k16 (bf16 in, fp32 sums). The M-tile count
//   is a template parameter, ceil(M / 16) when M < 64 and 4 otherwise
//   (a last, partial block computes zero rows), so M = 1 runs one M-tile
//   and no branch splits the unrolled loop.
// - A cp.async ring of kStages (3) stages, each a 64 x 64 bf16 x tile and a
//   64 x 128 int8 weight tile, filled by 16-byte copies; one barrier a
//   step: once step i has landed and every warp has passed the barrier
//   (so is done with step i - 1), step i + kStages - 1 is requested into
//   step i - 1's stage and lands while step i is multiplied. Rows are
//   padded by 16 bytes, so the fragment reads below hit 32 banks.
// - The convert in shared memory, into registers. An mma B fragment pairs
//   two K-neighbours of one column, which lie a row apart in the int8
//   tile. Output columns are independent, so the kernel picks which
//   column each fragment lane carries: thread (g = lane / 4, t = lane %
//   4) carries columns 4g..4g+3 of its warp's 32 in its four N-tiles, so
//   one 32-bit read of a staged row gives its four values of that row.
//   Four reads (rows 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-deep step) give
//   all its B fragments; each byte becomes a bf16 exactly (|q| <= 127)
//   by integer and add instructions (byte_perm into the bits of 2^23 +
//   128 + q, minus 2^23 + 128), and the high halves of two such floats
//   make a bf16 pair. A step reads and converts all its B fragments
//   first (16 independent reads), then runs its products, their x
//   fragments by ldmatrix. In the result a thread holds 8 neighbouring
//   columns of a row: one 16-byte store.
// - The epilogue rounds the fp32 sum to bf16, then multiplies by the
//   column's bf16 scale and rounds again: the reference's two roundings.
// - Split-K by a cluster. A [K, N] weight with few column tiles would
//   leave most of the 132 SMs idle (4096 x 1024 has 8 tiles), and one
//   block per SM cannot keep enough copies in flight to near the
//   memory's rate, so K splits into S contiguous ranges, S = min(8,
//   264 / column tiles, K steps / 4) and at least 1 (about 2 blocks an
//   SM; ``tune_prefill.py --source qdot_int8`` on the H100 chose these
//   and the ring's depth): fixed by (K, N) alone. The S blocks of a tile
//   form one thread-block cluster; each leaves its fp32 partial
//   tile in its own shared memory, and after a cluster barrier every
//   block merges an S-th of the tile, reading the partials through
//   distributed shared memory in split order 0, 1, ..., S - 1, then
//   runs the epilogue. No workspace, no atomics: the same bits on every
//   run, and capturable in a CUDA graph.
//
// A row's bits depend on its own x row and on (K, N) only: the reduction
// order over K is the tile steps in order within a split, the split
// order after, and neither depends on M or on which block holds the row.
// So a decode step's rows equal the same rows in a verify or chunk
// product, which the serving invariants (verify query 0 == decode, fused
// on == off, depth 0 == 1) rest on.
//
// Interface: plain C functions bound with ctypes. qdot_int8 launches on
// the given stream, allocates nothing and returns cudaGetLastError() (or
// -1 for a shape it does not take: M >= 1, K a multiple of 64, N a
// multiple of 16); the pointers must be 16-byte aligned.
// qdot_int8_splits(K, N) is S.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace paged;

constexpr int kBM = 64;   // rows a block
constexpr int kWarps = 4;  // each owns 32 columns of the tile
constexpr int kBN = 32 * kWarps;  // columns a block
constexpr int kBK = 64;   // K a step
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = kWarps == 4 ? 4 : 2;  // an SM's, for registers
constexpr int kStages = 3;
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kTargetBlocks = 264;  // 2 blocks on each of 132 SMs
constexpr int kMinStepsPerSplit = 4;
// 16-byte pieces of a staged x row and of a staged weight row, and the
// rows one pass of the block's threads copies.
constexpr int kXPieces = kBK * 2 / 16;
constexpr int kQPieces = kBN / 16;
constexpr int kXCopyRows = kThreads / kXPieces;
constexpr int kQCopyRows = kThreads / kQPieces;

constexpr int kXRow = kBK * 2 + 16;  // staged x row bytes
constexpr int kQRow = kBN + 16;      // staged weight row bytes
constexpr int kXTile = kBM * kXRow;
constexpr int kQTile = kBK * kQRow;
constexpr int kStage = kXTile + kQTile;
constexpr int kSmem = kStages * kStage;
constexpr int kPartRow = kBN + 4;  // fp32 partial tile row, padded
static_assert(kBM * kPartRow * 4 <= kSmem, "partial tile must fit");

int n_splits(int K, int N) {
  const int n_tiles = (N + kBN - 1) / kBN;
  int s = kTargetBlocks / n_tiles;
  s = s < kMaxSplits ? s : kMaxSplits;
  const int by_k = K / kBK / kMinStepsPerSplit;
  s = s < by_k ? s : by_k;
  return s > 1 ? s : 1;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

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
                                        uint32_t (&b)[4]) {
  lo ^= 0x80808080u;
  hi ^= 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = __byte_perm(__float_as_uint(byte_as_float(lo, j)),
                       __float_as_uint(byte_as_float(hi, j)), 0x7632);
}

// bf16(bf16(sum) * scale) for 8 neighbouring columns, one 16-byte store.
__device__ __forceinline__ void store8(__nv_bfloat16* out,
                                       const __nv_bfloat16* scale,
                                       const float (&v)[8]) {
  const uint4 s = *reinterpret_cast<const uint4*>(scale);
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

// grid (splits, ceil(M / kBM), ceil(N / kBN)), clusters of (splits, 1, 1);
// MT M-tiles of 16 rows a block (fewer than 4 only when M < 64, so the
// products of M-tiles past M are never issued).
template <int MT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
qdot_int8_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q,
                 const __nv_bfloat16* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N,
                 int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rows = min(kBM, M - m0);
  const int cols = min(kBN, N - n0);
  const int k_steps = K / kBK;
  const int s0 = split * k_steps / splits;
  const int n_steps = (split + 1) * k_steps / splits - s0;

  // Rows past M in the block's M-tiles and columns past N are never
  // copied: zero them once in every stage (their results are dropped).
  for (int st = 0; st < kStages; ++st) {
    unsigned char* base = smem + st * kStage;
    for (int c = tid; c < (MT * 16 - rows) * (kBK * 2 / 16);
         c += kThreads) {
      const int r = rows + c / (kBK * 2 / 16);
      *reinterpret_cast<uint4*>(base + r * kXRow + (c % (kBK * 2 / 16)) *
                                                       16) = uint4{};
    }
    const int pad = (kBN - cols) / 16;
    for (int c = tid; c < kBK * pad; c += kThreads)
      *reinterpret_cast<uint4*>(base + kXTile + (c / pad) * kQRow + cols +
                                (c % pad) * 16) = uint4{};
  }

  // Step s0 + i into stage i % kStages: this thread copies one 16-byte
  // piece of every kXCopyRows-th row of the x tile (those below M) and of
  // every kQCopyRows-th row of the weight tile (if the piece lies below
  // N), its source addresses computed once.
  const int x_row = tid / kXPieces;
  const int x_piece = tid % kXPieces;
  const int q_row = tid / kQPieces;
  const int q_piece = tid % kQPieces;
  const unsigned char* x_src = reinterpret_cast<const unsigned char*>(
      x + (size_t)(m0 + x_row) * K + (size_t)s0 * kBK) + x_piece * 16;
  const int8_t* q_src =
      q + ((size_t)s0 * kBK + q_row) * N + n0 + q_piece * 16;
  const bool q_live = q_piece * 16 < cols;
  auto load = [&](int i) {
    unsigned char* xs = smem + (i % kStages) * kStage + x_row * kXRow +
                        x_piece * 16;
#pragma unroll
    for (int c = 0; c < kBM / kXCopyRows; ++c)
      if (x_row + c * kXCopyRows < rows)
        cp_async16(xs + c * kXCopyRows * kXRow,
                   x_src + ((size_t)c * kXCopyRows * K + (size_t)i * kBK) * 2);
    unsigned char* qs = smem + (i % kStages) * kStage + kXTile +
                        q_row * kQRow + q_piece * 16;
    if (q_live) {
#pragma unroll
      for (int c = 0; c < kBK / kQCopyRows; ++c)
        cp_async16(qs + c * kQCopyRows * kQRow,
                   q_src + ((size_t)i * kBK + c * kQCopyRows) * N);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) load(i);
    cp_async_commit();
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n_steps) load(i + kStages - 1);
    cp_async_commit();
    const unsigned char* xs = smem + (i % kStages) * kStage;
    const unsigned char* qs = xs + kXTile;
    // The whole step's B fragments first (16 independent reads and their
    // converts), then its products: the convert's latency hides behind
    // its own independent work instead of stalling each product.
    uint32_t b[kBK / 16][2][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned char* qb =
          qs + (kk * 16 + 2 * t) * kQRow + warp * 32 + 4 * g;
      b_pairs(*reinterpret_cast<const uint32_t*>(qb),
              *reinterpret_cast<const uint32_t*>(qb + kQRow), b[kk][0]);
      b_pairs(*reinterpret_cast<const uint32_t*>(qb + 8 * kQRow),
              *reinterpret_cast<const uint32_t*>(qb + 9 * kQRow), b[kk][1]);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, xs + (mt * 16 + (lane & 15)) * kXRow +
                       (kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[mt][j], a, b[kk][0][j], b[kk][1][j]);
      }
    }
  }
  cp_async_wait<0>();

  // This thread's values of row (16 mt + g + 8 h): columns 8t..8t+7 of
  // its warp's 32, in order.
  auto row_values = [&](int mt, int h, float (&v)[8]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[mt][j][2 * h];
      v[4 + j] = acc[mt][j][2 * h + 1];
    }
  };
  const int col = warp * 32 + 8 * t;  // in the tile

  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r < rows && col < cols) {
          float v[8];
          row_values(mt, h, v);
          store8(out + (size_t)(m0 + r) * N + n0 + col, scale + n0 + col, v);
        }
      }
    }
    return;
  }

  // Split-K: the partial tile into this block's shared memory, then each
  // block of the cluster merges its share of the tile in split order.
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // every warp is done reading the ring
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];
      row_values(mt, h, v);
      float* p = part + (mt * 16 + g + 8 * h) * kPartRow + col;
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  constexpr int kGroups = kBN / 8;  // 8-column groups a row
  for (int v8 = rank * kThreads + tid; v8 < rows * kGroups;
       v8 += splits * kThreads) {
    const int r = v8 / kGroups;
    const int c = (v8 - r * kGroups) * 8;
    if (c >= cols) continue;
    float v[8];
    for (int s = 0; s < splits; ++s) {
      const float* p =
          cluster.map_shared_rank(part, (unsigned)s) + r * kPartRow + c;
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      if (s == 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = w[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += w[e];
      }
    }
    store8(out + (size_t)(m0 + r) * N + n0 + c, scale + n0 + c, v);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// One launch of the instance with MT M-tiles a block.
template <int MT>
int launch(const void* x, const void* q, const void* scale, void* out, int M,
           int K, int N, int splits, cudaStream_t stream) {
  auto kernel = qdot_int8_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const int8_t*>(q),
                           static_cast<const __nv_bfloat16*>(scale),
                           static_cast<__nv_bfloat16*>(out), M, K, N, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qdot_int8_splits(int K, int N) { return n_splits(K, N); }

extern "C" int qdot_int8(const void* x, const void* q, const void* scale,
                         void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < kBK || K % kBK != 0 || N < 16 || N % 16 != 0) return -1;
  if ((M + kBM - 1) / kBM > 65535 || (N + kBN - 1) / kBN > 65535) return -1;
  const int splits = n_splits(K, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M < kBM ? (M + 15) / 16 : 4) {
    case 1:
      return launch<1>(x, q, scale, out, M, K, N, splits, s);
    case 2:
      return launch<2>(x, q, scale, out, M, K, N, splits, s);
    case 3:
      return launch<3>(x, q, scale, out, M, K, N, splits, s);
    default:
      return launch<4>(x, q, scale, out, M, K, N, splits, s);
  }
}
