// Flash attention forward for Hopper (sm_90a): causal or not, GQA by
// head -> head / group, bf16 in, fp32 accumulators, bf16 out plus the
// per-row logsumexp the backward pass rebuilds P from.
//
// Replaces: skypilot_tpu/ops/attention.py, _flash_fwd_kernel (entry
// _flash_forward).
//
// What bounds it on the H100: arithmetic. At the bench_1b shapes (b 6,
// 12 heads, s 2048, d 128, causal) the products take 4 * b * h * d *
// s(s+1)/2 = 7.7e10 FLOPs against about 151 MB of q/k/v/out, so the
// floor is those FLOPs over 989 TFLOP/s (bf16 tensor cores), 0.078 ms,
// three times the time the bytes take.
//
// The design: one CTA owns (b, q-head, 128-row q tile) and has three
// warpgroups. Warpgroup 0 is the producer: one thread loads the q tile
// once by TMA, then streams 64-key K/V tiles up to the causal bound
// through a ring of shared-memory stages guarded by full/empty
// mbarriers (a fully masked tile is never loaded), and the warpgroup
// hands its registers to the consumers (setmaxnreg). Warpgroups 1 and 2
// each own 64 q rows. Per K/V tile a consumer runs S = q k^T as bf16
// wgmma products with both operands K-major in shared memory, scales S
// in fp32 after the product (the reference scales q first: S moves by
// about 1e-7 relative), masks (-1e30), and runs the online softmax on
// the accumulator fragment in registers (a row's max and sum from two
// shuffles within its quad; no scores go through shared memory). Then
// O += P V: P stays fp32 as in the reference, split into hi = bf16(P)
// and lo = bf16(P - hi); both halves are register A operands against
// the same MN-major V tile into one fp32 accumulator (about 2^-16
// relative, one extra product on the tensor cores). A tile a
// warpgroup's rows cannot see, and the rows past the sequence's end in
// a tile that only half fits (seq an odd multiple of 64), are skipped
// but still release their stage. out = acc / max(l, 1e-30) goes to bf16
// and lse = m + log(l) is written once per row. Tiles are launched
// heaviest first. The two consumers overlap each other's softmax with
// their products; within a warpgroup the products and the softmax still
// alternate.
//
// Interface: a plain C function bound with ctypes; it launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, seq a positive multiple of 64 -- the shapes chip_smoke.py
// checks; or hopper::kNoEncoder / kEncodeFailed when a tensor map cannot
// be made). Layouts: q/out [b, hq, s, d], k/v [b, hkv, s, d], lse
// [b, hq, 1, s] fp32, all contiguous.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kBQ = 128;       // query rows per CTA (64 per consumer)
constexpr int kBK = 64;        // keys per K/V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Smem {
  static constexpr int CH = HD / 64;                   // 64-column halves
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int Q = 2 * CH * kSubtileBytes;     // 128 q rows
  static constexpr int KV = CH * kSubtileBytes;        // one K or V tile
  static constexpr int k_off = Q;
  static constexpr int v_off = Q + STAGES * KV;
  static constexpr int bar_off = Q + 2 * STAGES * KV;  // q, full[], empty[]
  static constexpr size_t total = bar_off + (1 + 2 * STAGES) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int hq, int hkv, int seq, int causal, float sm_scale) {
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
      mbar_expect_tx(q_full, L::Q);
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < L::CH; ++c)
          tma_load(base + (r * L::CH + c) * kSubtileBytes, &tm_q, q_full,
                   64 * c, q_row + 64 * r);
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

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    // Row statistics in the log2 domain (m scaled by log2 e); l is this
    // thread's share of the row sum, summed over the quad at the end.
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      const int k0 = kBK * t;
      mbar_wait(full0 + 8 * s, (t / S) & 1);
      if (active && (!causal || k0 <= wrow0 + 63)) {
        const uint32_t k_tile = base + L::k_off + s * L::KV;
        const uint32_t v_tile = base + L::v_off + s * L::KV;
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n64(sc, desc_k(q_tile, kk), desc_k(k_tile, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        pin(sc);

        const bool diag = causal && k0 + kBK - 1 > wrow0;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int half = (i >> 1) & 1;
          float x = sc[i] * scale_log2;
          if (diag && k0 + 8 * (i >> 2) + cq + (i & 1) > wrow0 + ra + 8 * half)
            x = kNegInf;
          sc[i] = x;
          mx[half] = fmaxf(mx[half], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int half = (i >> 1) & 1;
          sc[i] = exp2f(sc[i] - m[half]);
          l[half] += sc[i];
        }
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        uint32_t p_hi[16], p_lo[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          split_bf16(sc[2 * i], sc[2 * i + 1], p_hi[i], p_lo[i]);

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          if constexpr (HD == 128) {
            wgmma_rs_n128(acc, p_hi + 4 * kk, desc_mn(v_tile, kk));
            wgmma_rs_n128(acc, p_lo + 4 * kk, desc_mn(v_tile, kk));
          } else {
            wgmma_rs_n64(acc, p_hi + 4 * kk, desc_mn(v_tile, kk));
            wgmma_rs_n64(acc, p_lo + 4 * kk, desc_mn(v_tile, kk));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        pin(p_hi);
        pin(p_lo);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
      }
      const size_t grow = (size_t)(b * hq + h) * seq + wrow0 + ra;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store_bf16x2(out + (grow + 8 * r) * HD + 8 * j + cq,
                       acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
      }
      if ((lane & 3) == 0) {
        lse[grow] = m[0] * kLn2 + logf(l[0]);
        lse[grow + 8] = m[1] * kLn2 + logf(l[1]);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int hq, int hkv, int seq, int causal, float sm_scale,
           cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_map(&tm_q, q, (uint64_t)b * hq * seq, HD);
  if (!err) err = make_map(&tm_k, k, (uint64_t)b * hkv * seq, HD);
  if (!err) err = make_map(&tm_v, v, (uint64_t)b * hkv * seq, HD);
  if (err) return err;
  const size_t smem = Smem<HD>::total;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid((seq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), hq, hkv, seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int b, int hq, int hkv,
                              int seq, int head_dim, int causal,
                              float sm_scale, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || seq < kBK || seq % kBK || b > 65535 ||
      hq > 65535 || (long long)b * hq * seq >= (1ll << 31))
    return -1;
  const int group = hq / hkv;
  if (group != 1 && group != 2 && group != 4 && group != 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, out, lse, b, hq, hkv, seq, causal, sm_scale, s);
    case 128:
      return launch<128>(q, k, v, out, lse, b, hq, hkv, seq, causal, sm_scale, s);
    default:
      return -1;
  }
}
