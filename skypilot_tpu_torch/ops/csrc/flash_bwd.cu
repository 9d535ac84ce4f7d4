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
// outputs: floors of about 0.12 and 0.16 ms at 989 TFLOP/s (bf16 tensor
// cores), above the 0.06-0.07 ms the bytes take.
//
// What the design does about it:
// - dQ: one block owns one (b, q-head, 64-row q tile), holds q, dO, lse
//   and delta for its rows, and loops over 64-key K/V tiles up to the
//   causal bound (later tiles are fully masked: P = 0 there exactly).
//   Per tile it forms S = q k^T * sm_scale (the product is scaled, not
//   q, as the reference's backward does) and dP = dO v^T in one pass
//   over d, then dS in shared memory, then dQ += dS K in registers.
// - dK/dV: the reference grids over q-heads and group-sums a
//   [b, hq, s, d] transient in XLA. Here one block owns one (b, KV head,
//   64-key tile), holds its K and V, and loops over the group's q-heads
//   and over the q tiles from the causal lower bound (the first tile
//   whose rows can see these keys). It writes dK and dV once per KV
//   head: no atomics (the gradients are the same from run to run) and
//   no per-q-head transient.
// Every tile is staged in shared memory once for all threads with
// 16-byte loads; each thread owns a 4 x 4 tile of S/dP and a 4 x (d/16)
// tile of its gradient in registers. Masked logits are -1e30 before the
// exp, as in the reference. The products run on the CUDA cores in fp32
// (the reference's arithmetic), far from the tensor-core bound;
// mma.sync/wgmma tiles and TMA are later work.
//
// Interface: plain C functions bound with ctypes; they launch on the
// given stream, allocate nothing, and return cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, seq a positive multiple of 64 -- the shapes chip_smoke.py
// checks). Layouts: q/dO/dQ [b, hq, s, d], k/v/dK/dV [b, hkv, s, d]
// bf16, lse/delta [b, hq, 1, s] fp32, all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  // dK/dV: K, V, q, dO tiles + P + dS + lse, delta.
  static constexpr size_t dkv_total =
      4 * tile_bytes + 2 * s_bytes + 2 * kBQ * 4;
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int hq, int hkv, int seq,
                     int causal, float sm_scale) {
  using L = Layout<HD>;
  constexpr int NC4 = HD / 64;
  const int kt = blockIdx.x;  // low key tiles see the most rows: first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int k0 = kt * kBK;
  const int group = hq / hkv;
  const size_t kv_base = ((size_t)b * hkv + kvh) * seq;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + 64 * L::KS;
  __nv_bfloat16* q_s = v_s + 64 * L::KS;
  __nv_bfloat16* do_s = q_s + 64 * L::KS;
  float* p_s = reinterpret_cast<float*>(smem + 4 * L::tile_bytes);
  float* ds_s = p_s + kBQ * L::SS;
  float* lse_s = ds_s + kBQ * L::SS;
  float* delta_s = lse_s + kBQ;

  stage<HD>(k_s, k + (kv_base + k0) * HD, tid);
  stage<HD>(v_s, v + (kv_base + k0) * HD, tid);

  const int cl = tid & 15;
  const int rl = tid >> 4;  // in the gradient products: keys rl + 16i
  float4 acc_k[4][NC4], acc_v[4][NC4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      acc_k[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_v[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  const int first = causal ? k0 / kBQ : 0;  // first q tile that sees k0
  for (int g = 0; g < group; ++g) {
    const size_t q_base = ((size_t)b * hq + kvh * group + g) * seq;
    for (int qt = first; qt < seq / kBQ; ++qt) {
      const int row0 = qt * kBQ;
      __syncthreads();
      stage<HD>(q_s, q + (q_base + row0) * HD, tid);
      stage<HD>(do_s, dout + (q_base + row0) * HD, tid);
      if (tid < kBQ) {
        lse_s[tid] = lse[q_base + row0 + tid];
        delta_s[tid] = delta[q_base + row0 + tid];
      }
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
          p_s[r * L::SS + j] = p;
          ds_s[r * L::SS + j] = p * (dp[i][c] - delta_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T @ dO, dK += dS^T @ q, for keys rl + 16i.
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = p_s[r * L::SS + rl + 16 * i];
          ds[i] = ds_s[r * L::SS + rl + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC4; ++c) {
          const float4 dov = bf16x4(do_s + r * L::KS + 4 * (cl + 16 * c));
          const float4 qv = bf16x4(q_s + r * L::KS + 4 * (cl + 16 * c));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fma4(acc_v[i][c], p[i], dov);
            fma4(acc_k[i][c], ds[i], qv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = (kv_base + k0 + rl + 16 * i) * HD;
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      const float4 a = acc_k[i][c];
      store_bf16x4(dk + row + 4 * (cl + 16 * c),
                   make_float4(a.x * sm_scale, a.y * sm_scale, a.z * sm_scale,
                               a.w * sm_scale));
      store_bf16x4(dv + row + 4 * (cl + 16 * c), acc_v[i][c]);
    }
  }
}

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
  const size_t smem = Layout<HD>::dkv_total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(seq / kBK, hkv, b);
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
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
  if (!takes(b, hq, hkv, seq) || hkv > 65535) return -1;
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
