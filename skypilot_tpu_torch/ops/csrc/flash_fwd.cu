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
// floor is those FLOPs over 989 TFLOP/s (bf16 tensor cores), about
// 0.078 ms, three times the time the bytes take.
//
// What the design does about it: the TPU kernel grids (b, q-head,
// q-block), keeps the mapped KV head's whole K/V resident in VMEM and
// walks KV blocks up to the causal bound in a fori_loop. Here one CUDA
// block owns one (b, q-head, 64-row q tile), keeps its q tile in shared
// memory scaled by sm_scale in fp32 (the reference scales q before the
// product), and loops over 64-key K/V tiles itself up to the last tile
// any of its rows can see (the causal block skip: later tiles are
// fully masked, an exact no-op of the online softmax). Each K/V tile is
// staged in shared memory once for all 64 rows with 16-byte loads; the
// KV head is indexed as h / group, so K/V are never replicated. Every
// thread computes a 4 x 4 tile of scores and a 4 x (d/16) tile of the
// output in registers from 8-byte shared-memory loads, so each load
// feeds several FMAs. Masked scores are -1e30, the final l is clamped at
// 1e-30, out = acc / l and lse = m + log(l), as in the reference. Tiles
// are launched heaviest first (causal tiles near the end of the
// sequence see the most keys). This first version runs the products on
// the CUDA cores in fp32 (the reference's own arithmetic: q scaled in
// fp32, P kept in fp32), far from the tensor-core bound; mma.sync /
// wgmma tiles, TMA and a pipelined K/V ring are later work.
//
// Interface: a plain C function bound with ctypes; it launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, seq a positive multiple of 64 -- the shapes chip_smoke.py
// checks). Layouts: q/out [b, hq, s, d], k/v [b, hkv, s, d], lse
// [b, hq, 1, s] fp32, all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per K/V tile
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int QS = HD + 4;   // fp32 query row stride (padded)
  static constexpr int KS = HD + 4;   // bf16 key row stride (padded)
  static constexpr int SS = kBK + 1;  // fp32 score row stride (padded)
  static constexpr size_t q_bytes = (size_t)kBQ * QS * sizeof(float);
  static constexpr size_t k_bytes = (size_t)kBK * KS * sizeof(__nv_bfloat16);
  static constexpr size_t v_bytes = (size_t)kBK * HD * sizeof(__nv_bfloat16);
  static constexpr size_t s_bytes = (size_t)kBQ * SS * sizeof(float);
  static constexpr size_t total =
      q_bytes + k_bytes + v_bytes + s_bytes + 3 * kBQ * sizeof(float);
};

__device__ __forceinline__ float4 bf16x4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int hq, int hkv, int seq, int causal, float sm_scale) {
  using L = Layout<HD>;
  constexpr int VPR = HD / 8;   // 16-byte vectors per row
  constexpr int NC4 = HD / 64;  // 4-column output groups per thread
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row0 = tile * kBQ;
  const int group = hq / hkv;
  const size_t q_base = ((size_t)b * hq + h) * seq;
  const size_t kv_base = ((size_t)b * hkv + h / group) * seq;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q_bytes);
  __nv_bfloat16* v_s =
      reinterpret_cast<__nv_bfloat16*>(smem + L::q_bytes + L::k_bytes);
  float* s_s = reinterpret_cast<float*>(smem + L::q_bytes + L::k_bytes +
                                        L::v_bytes);
  float* m_s = s_s + kBQ * L::SS;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  // q tile, scaled in fp32 before any product (as the reference does).
  {
    const uint4* src = reinterpret_cast<const uint4*>(q + (q_base + row0) * HD);
    for (int i = tid; i < kBQ * VPR; i += kThreads) {
      const int r = i / VPR;
      const int col = (i - r * VPR) * 8;
      const uint4 raw = src[i];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float* dst = q_s + r * L::QS + col;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        dst[2 * e] = f.x * sm_scale;
        dst[2 * e + 1] = f.y * sm_scale;
      }
    }
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int n_tiles = causal ? tile + 1 : seq / kBK;
  const int cl = tid & 15;  // column lane: keys cl + 16c / cols 4(cl + 16c)
  const int rl = tid >> 4;  // row lane: rows rl + 16i
  float4 acc[4][NC4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    {
      const uint4* ksrc = reinterpret_cast<const uint4*>(k + (kv_base + k0) * HD);
      const uint4* vsrc = reinterpret_cast<const uint4*>(v + (kv_base + k0) * HD);
      for (int i = tid; i < kBK * VPR; i += kThreads) {
        const int j = i / VPR;
        const int col = (i - j * VPR) * 8;
        const uint4 kv = ksrc[i];
        uint2* kd = reinterpret_cast<uint2*>(k_s + j * L::KS + col);
        kd[0] = make_uint2(kv.x, kv.y);
        kd[1] = make_uint2(kv.z, kv.w);
        reinterpret_cast<uint4*>(v_s)[i] = vsrc[i];
      }
    }
    __syncthreads();

    // Scores: rows rl + 16i x keys cl + 16c.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (rl + 16 * i) * L::QS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = bf16x4(k_s + (cl + 16 * c) * L::KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sc[i][c] = fmaf(qv[i].w, kv[c].w,
                          fmaf(qv[i].z, kv[c].z,
                               fmaf(qv[i].y, kv[c].y,
                                    fmaf(qv[i].x, kv[c].x, sc[i][c]))));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rl + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = cl + 16 * c;
        s_s[r * L::SS + j] =
            (!causal || row0 + r >= k0 + j) ? sc[i][c] : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: four neighbouring lanes per row.
    {
      const int r = tid >> 2;
      const int sub = tid & 3;
      float* srow = s_s + r * L::SS;
      float mx = kNegInf;
#pragma unroll
      for (int j = sub; j < kBK; j += 4) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = sub; j < kBK; j += 4) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (sub == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[rl + 16 * i];
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        acc[i][c].x *= a;
        acc[i][c].y *= a;
        acc[i][c].z *= a;
        acc[i][c].w *= a;
      }
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(rl + 16 * i) * L::SS + j];
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        const float4 vv = bf16x4(v_s + j * HD + 4 * (cl + 16 * c));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c].x = fmaf(p[i], vv.x, acc[i][c].x);
          acc[i][c].y = fmaf(p[i], vv.y, acc[i][c].y);
          acc[i][c].z = fmaf(p[i], vv.z, acc[i][c].z);
          acc[i][c].w = fmaf(p[i], vv.w, acc[i][c].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rl + 16 * i;
    const float l = fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* orow = out + (q_base + row0 + r) * HD;
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][c].x / l, acc[i][c].y / l);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][c].z / l, acc[i][c].w / l);
      uint2 raw;
      raw.x = *reinterpret_cast<uint32_t*>(&lo);
      raw.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(orow + 4 * (cl + 16 * c)) = raw;
    }
  }
  if (tid < kBQ)
    lse[q_base + row0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int hq, int hkv, int seq, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Layout<HD>::total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(seq / kBQ, hq, b);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), hq, hkv, seq, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, void* lse, int b, int hq, int hkv,
                              int seq, int head_dim, int causal,
                              float sm_scale, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || seq < kBQ || seq % kBQ || b > 65535 ||
      hq > 65535)
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
