// Fused cross-entropy forward for Hopper (sm_90a): per-token NLL of
// softmax(x @ w) at the targets, and the per-token logsumexp, without
// ever writing the [T, V] logits.
//
// Replaces: skypilot_tpu/ops/cross_entropy.py, _ce_fwd_kernel (entry
// _fused_fwd).
//
// What bounds it on the H100: arithmetic. The logits product takes
// 2 * T * d * V FLOPs (1.24e12 at the bench_1b shapes T 12288, d 1536,
// V 32768) against the 138 MB of x and w it must read: 1.25 ms at 989
// TFLOP/s (bf16 tensor cores), thirty times the time the bytes take.
//
// The design: a GEMM main loop with the softmax statistics as its
// epilogue. A CTA owns a 128-row tile of T and a split: kTilesPerSplit
// consecutive kBN-column tiles of V (the TPU kernel walks all of V in
// one sequential grid axis; here the vocabulary is split across CTAs so
// that 96 row tiles fill 132 SMs). It has three warpgroups. Warpgroup 0
// is the producer: one thread streams (x slice [128 rows x 64 deep], w
// slice [64 deep x kBN columns]) pairs by TMA through a ring of
// kStages shared-memory stages guarded by full/empty mbarriers, and the
// warpgroup hands its registers to the consumers (setmaxnreg). x is
// 384 KB a row tile at d 1536, so it cannot stay resident and is
// re-streamed for every V tile. Warpgroups 1 and 2 each own 64 rows and
// accumulate their [64 x kBN] logits tile over d with wgmma m64nkBNk16:
// A is the x slice, K-major; B is the w slice read down its rows,
// MN-major (w is [d, V] row-major). Each slice's products are left in
// flight while the next slice's are issued; the stage is released when
// they are done. The products of bf16 values are exact and summed in
// fp32, as the reference's preferred_element_type=float32 product is.
// When a tile's d loop ends, each consumer folds the accumulator
// fragment straight into its rows' running max m (from -1e30), sum l
// and target logit tl, in registers: columns >= V (zeros from TMA's
// out-of-bounds fill) are set to -1e30 first, the row max comes from
// two shuffles within a quad, the exponentials are exp2f(logit * log2 e
// - m * log2 e), and only the thread holding the target's column picks
// it (a target outside [0, V) picks nothing, so its NLL is the
// logsumexp, as in the reference). Rows past T are computed on TMA's
// zero rows and dropped. Each (row tile, split) writes its rows'
// partial (m, l, tl) to an fp32 workspace; the last CTA of a row tile
// to finish (a counter per row tile, which it resets) merges the splits
// in split order -- m = max m_i, l = sum l_i exp(m_i - m), tl = sum
// tl_i -- and writes nll = lse - tl and lse = m + log(max(l, 1e-30)).
// No float atomics: the outputs are the same bits every run. CTAs are
// numbered so that those resident together cover a few row tiles and
// all their splits (kRaster 0): each w slice and each x slice is then
// read from L2 by several CTAs at about the same time. Known limit: the
// two consumers fold their tiles at the same moment, so the tensor
// cores wait through each epilogue while the ring keeps the next
// tile's loads going.
//
// Interface: a plain C function bound with ctypes; it launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: d a positive multiple of 64, V a
// positive multiple of 8; or hopper::kNoEncoder / kEncodeFailed when a
// tensor map cannot be made). Layouts: x [T, d] and w [d, V] bf16,
// targets [T] int32, nll [T] and lse [T, 1] fp32, all contiguous; ws
// holds ceil(T / 128) x n_splits x 3 x 128 fp32 and counters
// ceil(T / 128) int32, zero between launches (n_splits =
// ceil(ceil(V / kBN) / kTilesPerSplit)).

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// Tuning constants.
constexpr int kBN = 256;            // vocabulary columns of a V tile
constexpr int kStages = 4;          // depth of the (x, w) slice ring
constexpr int kTilesPerSplit = 32;  // V tiles of a split
constexpr int kRaster = 0;          // 0: a row tile's splits adjacent;
                                    // 1: a split's row tiles adjacent

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kBT = 128;       // rows of T per CTA (64 per consumer)
constexpr int kBD = 64;        // depth of one slice of d
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kXBytes = 2 * kSubtileBytes;           // 128 rows x 64 deep
constexpr int kWBytes = kBN / 64 * kSubtileBytes;    // 64 deep x kBN
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kBarOff = kStages * kStageBytes;       // full[], empty[], flag
constexpr size_t kSmem = kBarOff + 16 * kStages + 16 + 1024;
static_assert(kBN == 128 || kBN == 256, "kBN is 128 or 256");
static_assert(kSmem <= 232448, "the ring exceeds shared memory");

template <int N>
__device__ __forceinline__ void product(float (&acc)[N / 2], uint64_t a,
                                        uint64_t b, int accumulate) {
  if constexpr (N == 256)
    wgmma_ss_tb_n256(acc, a, b, accumulate);
  else
    wgmma_ss_tb_n128(acc, a, b, accumulate);
}

__global__ void __launch_bounds__(kThreads, 1)
ce_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              const int* __restrict__ targets, float* __restrict__ nll,
              float* __restrict__ lse_out, float* __restrict__ ws,
              int* __restrict__ counters, int T, int d, int V,
              int n_splits) {
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles so.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + kBarOff;
  const uint32_t empty0 = full0 + 8 * kStages;
  int* flag = reinterpret_cast<int*>(smem + kBarOff + 16 * kStages);

  const int n_rt = (T + kBT - 1) / kBT;
  const int rt = kRaster == 0 ? blockIdx.x / n_splits : blockIdx.x % n_rt;
  const int split = kRaster == 0 ? blockIdx.x % n_splits : blockIdx.x / n_rt;
  const int row0 = rt * kBT;
  const int vt0 = split * kTilesPerSplit;
  const int n_tiles = min(kTilesPerSplit, (V + kBN - 1) / kBN - vt0);
  const int n_d = d / kBD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      // Boxes wholly past T or V are not loaded (their rows and columns
      // are dropped or masked); a partial box counts all its bytes.
      const int n_x = row0 + 64 < T ? 2 : 1;
      int it = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int v0 = (vt0 + t) * kBN;
        const int n_w = min(kBN, V - v0 + 63) / 64;
        const uint32_t bytes = (n_x + n_w) * kSubtileBytes;
        for (int dt = 0; dt < n_d; ++dt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t stage = base + s * kStageBytes;
          mbar_expect_tx(full, bytes);
          for (int h = 0; h < n_x; ++h)
            tma_load(stage + h * kSubtileBytes, &tm_x, full, kBD * dt,
                     row0 + 64 * h);
          for (int j = 0; j < n_w; ++j)
            tma_load(stage + kXBytes + j * kSubtileBytes, &tm_w, full,
                     v0 + 64 * j, kBD * dt);
        }
      }
    }
    return;
  }

  regs_alloc<232>();
  const int c = wg - 1;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int ra = 16 * warp + (lane >> 2);  // fragment rows ra, ra + 8
  const int cq = 2 * (lane & 3);           // fragment column offset
  const int crow0 = row0 + 64 * c;         // this consumer's first row
  const bool active = crow0 < T;

  // A target no column matches is -1 here: it never picks.
  int tgt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = crow0 + ra + 8 * r;
    const int t = row < T ? targets[row] : -1;
    tgt[r] = t >= 0 && t < V ? t : -1;
  }
  // m is the row's (quad-wide); l and tl are this thread's shares.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, tl[2] = {0.f, 0.f};
  float acc[kBN / 2];

  int it = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int v0 = (vt0 + t) * kBN;
    int pending = -1;  // the stage whose products are still in flight
    for (int dt = 0; dt < n_d; ++dt, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      if (active) {
        const uint32_t stage = base + s * kStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBD / 16; ++kk)
          product<kBN>(acc, desc_k(stage + c * kSubtileBytes, kk),
                       desc_mn(stage + kXBytes, kk), dt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
      }
      if (pending >= 0 && lane == 0) mbar_arrive(empty0 + 8 * pending);
      pending = s;
    }
    if (active) {
      wgmma_wait<0>();
      pin(acc);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * pending);
    if (!active) continue;

    // The finished [64 x kBN] logits tile, in registers: d[4j + e] is
    // row ra, column 8j + cq + e; d[4j + 2 + e] row ra + 8.
    if (v0 + kBN > V) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        if (v0 + 8 * (i >> 2) + cq + (i & 1) >= V) acc[i] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i]);
    float neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      l[r] *= exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      neg[r] = -m_new * kLog2e;
    }
    // Two sums a row, so the adds are not one long chain.
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      sum[(i >> 1) & 3] += exp2f(fmaf(acc[i], kLog2e, neg[(i >> 1) & 1]));
    l[0] += sum[0] + sum[2];
    l[1] += sum[1] + sum[3];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tj = tgt[r] - v0;
      if (tj >= 0 && tj < kBN && (tj & 7) >> 1 == (lane & 3)) {
        const int jt = tj >> 3;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          if (j == jt) v = tj & 1 ? acc[4 * j + 2 * r + 1] : acc[4 * j + 2 * r];
        tl[r] += v;
      }
    }
  }

  // This split's partial statistics of each row.
  if (active) {
    float* part = ws + ((size_t)rt * n_splits + split) * 3 * kBT;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 1);
      tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 2);
      if ((lane & 3) == 0) {
        const int row = 64 * c + ra + 8 * r;
        part[row] = m[r];
        part[kBT + row] = l[r];
        part[2 * kBT + row] = tl[r];
      }
    }
  }

  // The last of the row tile's splits to finish merges them in order.
  __threadfence();
  bar_sync(1, 256);
  if (threadIdx.x == 128)
    *flag = atomicAdd(counters + rt, 1) == n_splits - 1;
  bar_sync(1, 256);
  if (!*flag || c != 0) return;
  __threadfence();
  const int r = threadIdx.x - 128;
  if (row0 + r < T) {
    // Partials are read from L2 (__ldcg): other CTAs wrote them.
    const float* p = ws + (size_t)rt * n_splits * 3 * kBT + r;
    float M = kNegInf, L = 0.f, TL = 0.f;
    for (int i = 0; i < n_splits; ++i) M = fmaxf(M, __ldcg(p + i * 3 * kBT));
    for (int i = 0; i < n_splits; ++i) {
      const float* q = p + i * 3 * kBT;
      L = fmaf(__ldcg(q + kBT), exp2f((__ldcg(q) - M) * kLog2e), L);
      TL += __ldcg(q + 2 * kBT);
    }
    const float lse = M + logf(fmaxf(L, 1e-30f));
    nll[row0 + r] = lse - TL;
    lse_out[row0 + r] = lse;
  }
  if (r == 0) counters[rt] = 0;
}

}  // namespace

extern "C" int ce_fwd_tiles_per_split() { return kTilesPerSplit; }

extern "C" int ce_fwd_block_v() { return kBN; }

extern "C" int ce_fwd_bf16(const void* x, const void* w, const void* targets,
                           void* nll, void* lse, void* ws, void* counters,
                           int T, int d, int V, void* stream) {
  if (T < 1 || d < kBD || d % kBD || V < 8 || V % 8) return -1;
  CUtensorMap tm_x, tm_w;
  int err = make_map(&tm_x, x, (uint64_t)T, d);
  if (!err) err = make_map(&tm_w, w, (uint64_t)d, V);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_rt = (T + kBT - 1) / kBT;
  const int n_splits = ((V + kBN - 1) / kBN + kTilesPerSplit - 1) /
                       kTilesPerSplit;
  ce_fwd_kernel<<<n_rt * n_splits, kThreads, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<const int*>(targets), static_cast<float*>(nll),
      static_cast<float*>(lse), static_cast<float*>(ws),
      static_cast<int*>(counters), T, d, V, n_splits);
  return (int)cudaGetLastError();
}
