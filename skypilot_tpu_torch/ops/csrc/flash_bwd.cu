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
// The dQ kernel (still the first, CUDA-core version): one block owns one
// (b, q-head, 64-row q tile), holds q, dO, lse and delta for its rows,
// and loops over 64-key K/V tiles up to the causal bound (later tiles
// are fully masked: P = 0 there exactly). Per tile it forms S = q k^T *
// sm_scale (the product is scaled, not q, as the reference's backward
// does) and dP = dO v^T in one pass over d, then dS in shared memory,
// then dQ += dS K in registers. Every tile is staged in shared memory
// with 16-byte loads; each thread owns a 4 x 4 tile of S/dP and a 4 x
// (d/16) tile of dQ. Its products run on the CUDA cores in fp32, far
// from the tensor-core bound; moving it to wgmma is later work.
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
// checks; the dK/dV entry also hopper::kNoEncoder / kEncodeFailed when a
// tensor map cannot be made). Layouts: q/dO/dQ [b, hq, s, d],
// k/v/dK/dV [b, hkv, s, d] bf16, lse/delta [b, hq, 1, s] fp32, all
// contiguous.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int KS = HD + 4;   // bf16 row stride (padded)
  static constexpr int SS = kBK + 1;  // fp32 score row stride (padded)
  static constexpr size_t tile_bytes = (size_t)64 * KS * sizeof(__nv_bfloat16);
  static constexpr size_t s_bytes = (size_t)kBQ * SS * sizeof(float);
  // dQ: q, dO, K, V tiles + dS + lse, delta.
  static constexpr size_t dq_total = 4 * tile_bytes + s_bytes + 2 * kBQ * 4;
};

__device__ __forceinline__ float4 bf16x4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float4 f) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// 64 contiguous rows of HD bf16 from device memory into shared memory
// rows of stride KS, with 16-byte loads.
template <int HD>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int tid) {
  constexpr int VPR = HD / 8;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = tid; i < 64 * VPR; i += kThreads) {
    const int j = i / VPR;
    const int col = (i - j * VPR) * 8;
    const uint4 v = s[i];
    uint2* d = reinterpret_cast<uint2*>(dst + j * Layout<HD>::KS + col);
    d[0] = make_uint2(v.x, v.y);
    d[1] = make_uint2(v.z, v.w);
  }
}

// sc = a_rows . b_rows^T and dp = c_rows . d_rows^T over HD, for rows
// rl + 16i of (a, c) and rows cl + 16c of (b, d), all tiles of stride KS.
template <int HD>
__device__ __forceinline__ void two_products(
    const __nv_bfloat16* a, const __nv_bfloat16* bm, const __nv_bfloat16* c,
    const __nv_bfloat16* dm, int rl, int cl, float sc[4][4], float dp[4][4]) {
  constexpr int KS = Layout<HD>::KS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], cv[4], bv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = bf16x4(a + (rl + 16 * i) * KS + d);
      cv[i] = bf16x4(c + (rl + 16 * i) * KS + d);
      bv[i] = bf16x4(bm + (cl + 16 * i) * KS + d);
      dv[i] = bf16x4(dm + (cl + 16 * i) * KS + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = dot4(av[i], bv[j], sc[i][j]);
        dp[i][j] = dot4(cv[i], dv[j], dp[i][j]);
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int hq, int hkv, int seq,
                    int causal, float sm_scale) {
  using L = Layout<HD>;
  constexpr int NC4 = HD / 64;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row0 = tile * kBQ;
  const size_t q_base = ((size_t)b * hq + h) * seq;
  const size_t kv_base = ((size_t)b * hkv + h / (hq / hkv)) * seq;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + 64 * L::KS;
  __nv_bfloat16* k_s = do_s + 64 * L::KS;
  __nv_bfloat16* v_s = k_s + 64 * L::KS;
  float* ds_s = reinterpret_cast<float*>(smem + 4 * L::tile_bytes);
  float* lse_s = ds_s + kBQ * L::SS;
  float* delta_s = lse_s + kBQ;

  stage<HD>(q_s, q + (q_base + row0) * HD, tid);
  stage<HD>(do_s, dout + (q_base + row0) * HD, tid);
  if (tid < kBQ) {
    lse_s[tid] = lse[q_base + row0 + tid];
    delta_s[tid] = delta[q_base + row0 + tid];
  }

  const int n_tiles = causal ? tile + 1 : seq / kBK;
  const int cl = tid & 15;
  const int rl = tid >> 4;
  float4 acc[4][NC4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();
    stage<HD>(k_s, k + (kv_base + k0) * HD, tid);
    stage<HD>(v_s, v + (kv_base + k0) * HD, tid);
    __syncthreads();

    float sc[4][4], dp[4][4];
    two_products<HD>(q_s, k_s, do_s, v_s, rl, cl, sc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rl + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = cl + 16 * c;
        float s = sc[i][c] * sm_scale;
        if (causal && row0 + r < k0 + j) s = kNegInf;
        const float p = expf(s - lse_s[r]);
        ds_s[r * L::SS + j] = p * (dp[i][c] - delta_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS @ K.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ds_s[(rl + 16 * i) * L::SS + j];
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        const float4 kv = bf16x4(k_s + j * L::KS + 4 * (cl + 16 * c));
#pragma unroll
        for (int i = 0; i < 4; ++i) fma4(acc[i][c], ds[i], kv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat16* row = dq + (q_base + row0 + rl + 16 * i) * HD;
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      const float4 a = acc[i][c];
      store_bf16x4(row + 4 * (cl + 16 * c),
                   make_float4(a.x * sm_scale, a.y * sm_scale, a.z * sm_scale,
                               a.w * sm_scale));
    }
  }
}

}  // namespace

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

namespace {

bool takes(int b, int hq, int hkv, int seq) {
  if (b < 1 || hkv < 1 || hq % hkv || seq < kBQ || seq % kBQ || b > 65535 ||
      hq > 65535)
    return false;
  const int group = hq / hkv;
  return group == 1 || group == 2 || group == 4 || group == 8;
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int hq,
              int hkv, int seq, int causal, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = Layout<HD>::dq_total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(seq / kBQ, hq, b);
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), hq,
      hkv, seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int b,
               int hq, int hkv, int seq, int causal, float sm_scale,
               cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int err = hopper::make_map(&tm_q, q, (uint64_t)b * hq * seq, HD);
  if (!err) err = hopper::make_map(&tm_k, k, (uint64_t)b * hkv * seq, HD);
  if (!err) err = hopper::make_map(&tm_v, v, (uint64_t)b * hkv * seq, HD);
  if (!err) err = hopper::make_map(&tm_do, dout, (uint64_t)b * hq * seq, HD);
  if (err) return err;
  const size_t smem = dkv::Smem<HD>::total;
  cudaError_t cerr = cudaFuncSetAttribute(
      dkv::flash_bwd_dkv_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid((seq + dkv::kBK - 1) / dkv::kBK, hkv, b);
  dkv::flash_bwd_dkv_kernel<HD><<<grid, dkv::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
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
  // The tensor maps address rows with 32-bit coordinates.
  if (!takes(b, hq, hkv, seq) || hkv > 65535 ||
      (long long)b * hq * seq >= (1ll << 31))
    return -1;
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
