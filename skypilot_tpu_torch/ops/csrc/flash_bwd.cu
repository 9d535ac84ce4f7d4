// Flash attention backward for Hopper (sm_90a), FlashAttention-2 style:
// two kernels that rebuild P = exp(S - lse) from the forward's saved
// logsumexp instead of storing the s x s probabilities.
//
//   dS = P * (dO V^T - delta),  delta = rowsum(dO * O) (computed by the
//   caller in fp32, as the reference computes it in XLA)
//   dQ = dS K * sm_scale        (kernel flash_bwd_dq)
//   dK = dS^T Q * sm_scale, dV = P^T dO   (kernel flash_bwd_dkv)
//
// Replaces: skypilot_tpu/ops/attention.py, _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (entry _flash_backward).
//
// What bounds it on the H100: arithmetic. At the bench_1b shapes (b 6,
// 12 heads, s 2048, d 128, causal) dQ takes three products, 1.16e11
// FLOPs, and dK/dV four, 1.55e11, against 190 and 227 MB of inputs and
// outputs: floors of 0.117 and 0.156 ms at 989 TFLOP/s (bf16 tensor
// cores), above the 0.06-0.07 ms the bytes take.
//
// The dQ kernel (Hopper tensor cores, TMA): the forward's structure
// plus one product. One CTA owns one (b, q-head, 128-row q tile) and has
// three warpgroups. One thread of warpgroup 0 loads the tile's q and dO
// once by TMA and its lse and delta rows by bulk copy, then streams
// 64-key K/V tiles (K/V head = q-head / group) up to the causal bound
// through a ring of shared-memory stages guarded by full/empty mbarriers
// (a fully masked tile is never loaded); the warpgroup hands its
// registers to the consumers (setmaxnreg). Warpgroups 1 and 2 each own
// 64 q rows. Per K/V tile a consumer runs S = q k^T and dP = dO v^T as
// bf16 wgmma products with both operands K-major in shared memory,
// scales S in fp32 after the product (as the reference's backward
// does), and forms P = exp(S - lse) (p = 0 where masked) and dS = P *
// (dP - delta) in fp32 in the accumulator fragments. Then dQ += dS K:
// dS is a register A operand split into hi = bf16(x) and lo = bf16(x -
// hi), two products into one fp32 accumulator, with K read MN-major from
// the very tile the S product read K-major (the reduction runs down K's
// rows). dQ x sm_scale goes to bf16, written once per row: no atomics
// (the same bits run to run). Tiles are launched heaviest first. Rows
// past the sequence's end in a CTA that only half fits (seq an odd
// multiple of 64) are skipped, but their warpgroup still releases every
// stage.
//
// The dK/dV kernel (Hopper tensor cores, TMA): the reference grids over
// q-heads and group-sums a [b, hq, s, d] transient in XLA. Here one CTA
// owns one (b, KV head, 128-key tile) and has three warpgroups. One
// thread of warpgroup 0 loads the CTA's K and V once by TMA, then
// streams the 64-row q and dO tiles with their lse and delta rows
// through a two-stage ring guarded by full/empty mbarriers, over the
// group's q-heads and from the causal lower bound (the first tile whose
// rows can see these keys); the warpgroup hands its registers to the
// consumers (setmaxnreg). Warpgroups 1 and 2 each own 64 keys and work
// in the transposed formulation, so nothing goes through shared memory:
// S^T = K q^T and dP^T = V dO^T are bf16 wgmma products with K-major
// operands (S^T scaled in fp32 after the product, as the reference's
// backward does); P^T = exp(S^T - lse) (0 where masked) and dS^T =
// P^T * (dP^T - delta) stay fp32 in the accumulator fragments; then
// dV += P^T dO and dK += dS^T q take those fragments as register A
// operands, each split into hi = bf16(x) and lo = bf16(x - hi) against
// the same bf16 tile (about 2^-16 relative: the reference's fp32 P and
// dS, at one extra product each), with dO and q read MN-major from the
// very tiles the first two products read K-major. dK x sm_scale and dV
// go to bf16, written once per KV head: no atomics (the same bits run
// to run) and no per-q-head transient. A q tile a warpgroup's keys
// cannot see, and keys past the sequence's end in a CTA that only half
// fits (seq an odd multiple of 64), are skipped but still release their
// stage.
//
// Interface: plain C functions bound with ctypes; they launch on the
// given stream, allocate nothing, and return cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, seq a positive multiple of 64 -- the shapes chip_smoke.py
// checks; or hopper::kNoEncoder / kEncodeFailed when a tensor map cannot
// be made). Layouts: q/dO/dQ [b, hq, s, d],
// k/v/dK/dV [b, hkv, s, d] bf16, lse/delta [b, hq, 1, s] fp32, all
// contiguous.

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// dK/dV: TMA tiles, wgmma products (see the header comment).
// ---------------------------------------------------------------------------
namespace dkv {

using namespace hopper;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kBK = 128;       // keys per CTA (64 per consumer)
constexpr int kBQ = 64;        // q rows per streamed tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Smem {
  static constexpr int CH = HD / 64;                // 64-column halves
  static constexpr int KV = 2 * CH * kSubtileBytes;  // 128 keys of K or V
  static constexpr int QT = CH * kSubtileBytes;      // one q or dO tile
  // A stage: q, dO, then lse and delta (256 bytes each), 1024-aligned.
  static constexpr int STAGE = 2 * QT + 1024;
  static constexpr int v_off = KV;
  static constexpr int st_off = 2 * KV;
  static constexpr int bar_off = st_off + kStages * STAGE;  // kv, full, empty
  static constexpr size_t total = bar_off + (1 + 2 * kStages) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int hq, int hkv,
                     int seq, int causal, float sm_scale) {
  using L = Smem<HD>;
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles so.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t kv_full = base + L::bar_off;
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * S;

  const int kt = blockIdx.x;  // low key tiles see the most rows: first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kBK;
  const int group = hq / hkv;
  const int kv_row = (b * hkv + kvh) * seq;   // row of the [*, d] view
  const int first = causal ? k0 / kBQ : 0;    // first q tile that sees k0
  const int n_q = seq / kBQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < L::CH; ++c) {
          const int off = (r * L::CH + c) * kSubtileBytes;
          tma_load(base + off, &tm_k, kv_full, 64 * c, kv_row + k0 + 64 * r);
          tma_load(base + L::v_off + off, &tm_v, kv_full, 64 * c,
                   kv_row + k0 + 64 * r);
        }
      int t = 0;
      for (int g = 0; g < group; ++g) {
        const int q_row = (b * hq + kvh * group + g) * seq;
        for (int qt = first; qt < n_q; ++qt, ++t) {
          const int s = t % S;
          mbar_wait(empty0 + 8 * s, ((t / S) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t stage = base + L::st_off + s * L::STAGE;
          const int row = q_row + kBQ * qt;
          mbar_expect_tx(full, 2 * L::QT + 2 * kBQ * 4);
          for (int c = 0; c < L::CH; ++c) {
            tma_load(stage + c * kSubtileBytes, &tm_q, full, 64 * c, row);
            tma_load(stage + L::QT + c * kSubtileBytes, &tm_do, full, 64 * c,
                     row);
          }
          bulk_load(stage + 2 * L::QT, lse + row, kBQ * 4, full);
          bulk_load(stage + 2 * L::QT + kBQ * 4, delta + row, kBQ * 4, full);
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int w = wg - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int kw0 = k0 + 64 * w;               // this warpgroup's first key
    const bool active = kw0 < seq;
    const int ra = 16 * warp + (lane >> 2);    // fragment keys ra, ra + 8
    const int cq = 2 * (lane & 3);             // fragment column (q) offset
    const float scale_log2 = sm_scale * kLog2e;
    const uint32_t k_tile = base + w * L::CH * kSubtileBytes;
    const uint32_t v_tile = base + L::v_off + w * L::CH * kSubtileBytes;

    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(kv_full, 0);
    int t = 0;
    for (int g = 0; g < group; ++g) {
      for (int qt = first; qt < n_q; ++qt, ++t) {
        const int s = t % S;
        const int r0 = kBQ * qt;
        mbar_wait(full0 + 8 * s, (t / S) & 1);
        if (active && (!causal || r0 + kBQ - 1 >= kw0)) {
          const uint32_t q_tile = base + L::st_off + s * L::STAGE;
          const uint32_t do_tile = q_tile + L::QT;
          const float* lse_s = reinterpret_cast<const float*>(
              smem + L::st_off + s * L::STAGE + 2 * L::QT);
          const float* delta_s = lse_s + kBQ;
          // S^T = K q^T and dP^T = V dO^T: keys down, q rows across.
          float st[32], dpt[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            wgmma_ss_n64(st, desc_k(k_tile, kk), desc_k(q_tile, kk), kk > 0);
            wgmma_ss_n64(dpt, desc_k(v_tile, kk), desc_k(do_tile, kk),
                         kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          pin(st);
          pin(dpt);

          // P^T = exp(S^T * scale - lse) (0 where masked), dS^T = P^T *
          // (dP^T - delta), both in fp32 as in the reference.
          const bool diag = causal && r0 < kw0 + 63;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = 8 * (i >> 2) + cq + (i & 1);
            const int key = ra + 8 * ((i >> 1) & 1);
            float p = exp2f(fmaf(st[i], scale_log2, -lse_s[col] * kLog2e));
            if (diag && r0 + col < kw0 + key) p = 0.f;
            st[i] = p;
            dpt[i] = p * (dpt[i] - delta_s[col]);
          }
          uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            split_bf16(st[2 * i], st[2 * i + 1], p_hi[i], p_lo[i]);
            split_bf16(dpt[2 * i], dpt[2 * i + 1], ds_hi[i], ds_lo[i]);
          }

          // dV += P^T dO and dK += dS^T q: dO and q as MN-major B
          // operands from the same tiles the first products read K-major.
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBQ / 16; ++kk) {
            if constexpr (HD == 128) {
              wgmma_rs_n128(acc_v, p_hi + 4 * kk, desc_mn(do_tile, kk));
              wgmma_rs_n128(acc_v, p_lo + 4 * kk, desc_mn(do_tile, kk));
              wgmma_rs_n128(acc_k, ds_hi + 4 * kk, desc_mn(q_tile, kk));
              wgmma_rs_n128(acc_k, ds_lo + 4 * kk, desc_mn(q_tile, kk));
            } else {
              wgmma_rs_n64(acc_v, p_hi + 4 * kk, desc_mn(do_tile, kk));
              wgmma_rs_n64(acc_v, p_lo + 4 * kk, desc_mn(do_tile, kk));
              wgmma_rs_n64(acc_k, ds_hi + 4 * kk, desc_mn(q_tile, kk));
              wgmma_rs_n64(acc_k, ds_lo + 4 * kk, desc_mn(q_tile, kk));
            }
          }
          wgmma_commit();
          wgmma_wait_all();
          pin(acc_k);
          pin(acc_v);
          pin(p_hi);
          pin(p_lo);
          pin(ds_hi);
          pin(ds_lo);
        }
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }
    }

    if (active) {
      const size_t row = (size_t)kv_row + kw0 + ra;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t at = (row + 8 * r) * HD + 8 * j + cq;
          store_bf16x2(dk + at, acc_k[4 * j + 2 * r] * sm_scale,
                       acc_k[4 * j + 2 * r + 1] * sm_scale);
          store_bf16x2(dv + at, acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

}  // namespace dkv

// ---------------------------------------------------------------------------
// dQ: TMA tiles, wgmma products (see the header comment).
// ---------------------------------------------------------------------------
namespace dq {

using namespace hopper;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kBQ = 128;       // q rows per CTA (64 per consumer)
constexpr int kBK = 64;        // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Smem {
  static constexpr int CH = HD / 64;                   // 64-column halves
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int Q = 2 * CH * kSubtileBytes;     // 128 q (or dO) rows
  static constexpr int KV = CH * kSubtileBytes;        // one K or V tile
  static constexpr int do_off = Q;
  static constexpr int k_off = 2 * Q;
  static constexpr int v_off = 2 * Q + STAGES * KV;
  static constexpr int rows_off = 2 * Q + 2 * STAGES * KV;  // lse, delta
  static constexpr int bar_off = rows_off + 2 * kBQ * 4;  // q, full[], empty[]
  static constexpr size_t total = bar_off + (1 + 2 * STAGES) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq_out, int hq, int hkv,
                    int seq, int causal, float sm_scale) {
  using L = Smem<HD>;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles so.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + L::bar_off;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * S;

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = tile * kBQ;
  const int q_row = (b * hq + h) * seq + row0;  // row of the [*, d] view
  const int kv_row = (b * hkv + h / (hq / hkv)) * seq;
  const int n_rows = min(kBQ, seq - row0);      // 64 in a half-fitting CTA
  const int n_tiles = causal ? min(row0 + kBQ, seq) / kBK : seq / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::Q + 2 * n_rows * 4);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < L::CH; ++c) {
          const int off = (r * L::CH + c) * kSubtileBytes;
          tma_load(base + off, &tm_q, q_full, 64 * c, q_row + 64 * r);
          tma_load(base + L::do_off + off, &tm_do, q_full, 64 * c,
                   q_row + 64 * r);
        }
      bulk_load(base + L::rows_off, lse + q_row, n_rows * 4, q_full);
      bulk_load(base + L::rows_off + kBQ * 4, delta + q_row, n_rows * 4,
                q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        mbar_wait(empty0 + 8 * s, ((t / S) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * L::KV);
        for (int c = 0; c < L::CH; ++c) {
          tma_load(base + L::k_off + s * L::KV + c * kSubtileBytes, &tm_k,
                   full, 64 * c, kv_row + kBK * t);
          tma_load(base + L::v_off + s * L::KV + c * kSubtileBytes, &tm_v,
                   full, 64 * c, kv_row + kBK * t);
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int w = wg - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int wrow0 = row0 + 64 * w;           // this warpgroup's first row
    const bool active = wrow0 < seq;
    const int ra = 16 * warp + (lane >> 2);    // fragment rows ra, ra + 8
    const int cq = 2 * (lane & 3);             // fragment column offset
    const float scale_log2 = sm_scale * kLog2e;
    const uint32_t q_tile = base + w * L::CH * kSubtileBytes;
    const uint32_t do_tile = q_tile + L::do_off;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    // This thread's rows' lse (log2 domain) and delta.
    float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
    if (active) {
      const float* rows = reinterpret_cast<const float*>(smem + L::rows_off);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = rows[64 * w + ra + 8 * r] * kLog2e;
        dlt[r] = rows[kBQ + 64 * w + ra + 8 * r];
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      const int k0 = kBK * t;
      mbar_wait(full0 + 8 * s, (t / S) & 1);
      if (active && (!causal || k0 <= wrow0 + 63)) {
        const uint32_t k_tile = base + L::k_off + s * L::KV;
        const uint32_t v_tile = base + L::v_off + s * L::KV;
        // S = q k^T and dP = dO v^T: q rows down, keys across.
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wgmma_ss_n64(sc, desc_k(q_tile, kk), desc_k(k_tile, kk), kk > 0);
          wgmma_ss_n64(dp, desc_k(do_tile, kk), desc_k(v_tile, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);
        pin(dp);

        // P = exp(S * scale - lse) (0 where masked), dS = P * (dP -
        // delta), both in fp32 as in the reference.
        const bool diag = causal && k0 + kBK - 1 > wrow0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int half = (i >> 1) & 1;
          float p = exp2f(fmaf(sc[i], scale_log2, -lse2[half]));
          if (diag && k0 + 8 * (i >> 2) + cq + (i & 1) > wrow0 + ra + 8 * half)
            p = 0.f;
          dp[i] = p * (dp[i] - dlt[half]);
        }
        uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          split_bf16(dp[2 * i], dp[2 * i + 1], ds_hi[i], ds_lo[i]);

        // dQ += dS K: K as the MN-major B operand from the same tile the
        // S product read K-major.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          if constexpr (HD == 128) {
            wgmma_rs_n128(acc, ds_hi + 4 * kk, desc_mn(k_tile, kk));
            wgmma_rs_n128(acc, ds_lo + 4 * kk, desc_mn(k_tile, kk));
          } else {
            wgmma_rs_n64(acc, ds_hi + 4 * kk, desc_mn(k_tile, kk));
            wgmma_rs_n64(acc, ds_lo + 4 * kk, desc_mn(k_tile, kk));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        pin(ds_hi);
        pin(ds_lo);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    if (active) {
      const size_t grow = (size_t)(b * hq + h) * seq + wrow0 + ra;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store_bf16x2(dq_out + (grow + 8 * r) * HD + 8 * j + cq,
                       acc[4 * j + 2 * r] * sm_scale,
                       acc[4 * j + 2 * r + 1] * sm_scale);
      }
    }
  }
}

}  // namespace dq

namespace {

// The shapes both kernels take; the tensor maps address rows with 32-bit
// coordinates.
bool takes(int b, int hq, int hkv, int seq) {
  if (b < 1 || hkv < 1 || hq % hkv || seq < 64 || seq % 64 || b > 65535 ||
      hq > 65535 || hkv > 65535 || (long long)b * hq * seq >= (1ll << 31))
    return false;
  const int group = hq / hkv;
  return group == 1 || group == 2 || group == 4 || group == 8;
}

// The four tensor maps both kernels read: q, k, v, dO.
struct Maps {
  CUtensorMap q, k, v, dout;
};

int make_maps(Maps* m, const void* q, const void* k, const void* v,
              const void* dout, int b, int hq, int hkv, int seq, int hd) {
  int err = hopper::make_map(&m->q, q, (uint64_t)b * hq * seq, hd);
  if (!err) err = hopper::make_map(&m->k, k, (uint64_t)b * hkv * seq, hd);
  if (!err) err = hopper::make_map(&m->v, v, (uint64_t)b * hkv * seq, hd);
  if (!err) err = hopper::make_map(&m->dout, dout, (uint64_t)b * hq * seq, hd);
  return err;
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq_out, int b, int hq,
              int hkv, int seq, int causal, float sm_scale,
              cudaStream_t stream) {
  Maps m;
  int err = make_maps(&m, q, k, v, dout, b, hq, hkv, seq, HD);
  if (err) return err;
  const size_t smem = dq::Smem<HD>::total;
  cudaError_t cerr = cudaFuncSetAttribute(
      dq::flash_bwd_dq_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid((seq + dq::kBQ - 1) / dq::kBQ, hq, b);
  dq::flash_bwd_dq_kernel<HD><<<grid, dq::kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq_out),
      hq, hkv, seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int b,
               int hq, int hkv, int seq, int causal, float sm_scale,
               cudaStream_t stream) {
  Maps m;
  int err = make_maps(&m, q, k, v, dout, b, hq, hkv, seq, HD);
  if (err) return err;
  const size_t smem = dkv::Smem<HD>::total;
  cudaError_t cerr = cudaFuncSetAttribute(
      dkv::flash_bwd_dkv_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid((seq + dkv::kBK - 1) / dkv::kBK, hkv, b);
  dkv::flash_bwd_dkv_kernel<HD><<<grid, dkv::kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), hq, hkv, seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int hq,
                                 int hkv, int seq, int head_dim, int causal,
                                 float sm_scale, void* stream) {
  if (!takes(b, hq, hkv, seq)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, b, hq, hkv, seq,
                           causal, sm_scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, b, hq, hkv, seq,
                            causal, sm_scale, s);
    default:
      return -1;
  }
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int b,
                                  int hq, int hkv, int seq, int head_dim,
                                  int causal, float sm_scale, void* stream) {
  if (!takes(b, hq, hkv, seq)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, seq,
                            causal, sm_scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv,
                             seq, causal, sm_scale, s);
    default:
      return -1;
  }
}
