// Paged decode attention for Hopper (sm_90a): one query token per slot
// over the slot's block table of K/V pages.
//
// Replaces: skypilot_tpu/ops/paged_attention.py, _decode_kernel (entry
// paged_decode_attention), bf16 flavor.
//
// What bounds it on the H100: device-memory bytes. Each step reads every
// owned K/V row once (sum over slots of len_i * hkv * hd * 2 (K and V)
// * 2 B) and does 4 FLOPs per byte pair, far below the ~295 FLOP/byte the
// tensor cores need to matter. The floor is those bytes over 3.35 TB/s.
//
// What the design does about it: the TPU kernel walks a sequential page
// grid with the block table in scalar prefetch and VMEM accumulators
// carried across grid steps. Here one CUDA block owns one (slot, kv_head)
// pair and loops over that slot's pages itself: it reads lengths[b] and
// the table row directly, loops only over ceil(len / page) owned pages
// (dead pages cost no loads), and stages each K/V page in shared memory
// with 16-byte loads so every page row is read from device memory once
// for all `group` query heads of the KV head (GQA is native, K/V are
// never replicated). Scores are one warp per key row (lanes split the
// head dim, the group's queries live in registers); the online softmax
// keeps fp32 running max / sum / accumulator per query head, mask value
// -1e30 and a final l = max(l, 1e-30), as the reference does. Output is
// fp32. Known limit of this first version: slots * hkv blocks (64 at the
// 8B shapes) do not fill 132 SMs; split-K over pages is later work.
//
// Interface: a plain C function bound with ctypes; it launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, page 16, 32 or 64 -- the shapes chip_smoke.py checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    float* __restrict__ out, int hkv, int group,
                    int n_pages, int page, int max_pages, float sm_scale) {
  constexpr int E = HD / 32;                       // head-dim values per lane
  constexpr int NACC = kMaxGroup * HD / kThreads;  // outputs per thread
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [page][HD]
  __nv_bfloat16* v_s = k_s + page * HD;                          // [page][HD]
  float* s_s = reinterpret_cast<float*>(v_s + page * HD);        // [group][page]
  float* m_s = s_s + kMaxGroup * page;
  float* l_s = m_s + kMaxGroup;
  float* a_s = l_s + kMaxGroup;

  const int length = lengths[b];
  const int n_own = (length + page - 1) / page;
  const size_t q_base = ((size_t)b * hkv + h) * group * HD;

  // The group's scaled queries, lane-split over the head dim.
  float qr[kMaxGroup][E];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[g][e] = g < group
          ? __bfloat162float(q[q_base + g * HD + lane * E + e]) * sm_scale
          : 0.f;
    }
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  __syncthreads();

  const int nvec = page * HD / 8;
  for (int p = 0; p < n_own; ++p) {
    const int pid = tables[(size_t)b * max_pages + p];
    const size_t base = ((size_t)h * n_pages + pid) * page * HD;
    const uint4* ksrc = reinterpret_cast<const uint4*>(k_pages + base);
    const uint4* vsrc = reinterpret_cast<const uint4*>(v_pages + base);
    uint4* kdst = reinterpret_cast<uint4*>(k_s);
    uint4* vdst = reinterpret_cast<uint4*>(v_s);
    for (int i = tid; i < nvec; i += kThreads) {
      kdst[i] = ksrc[i];
      vdst[i] = vsrc[i];
    }
    __syncthreads();
    const int valid = min(page, length - p * page);

    // Scores: one warp per key row, all group queries at once.
    for (int j = warp; j < page; j += kWarps) {
      float kr[E];
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        const float2 kv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                k_s + j * HD + lane * E + e));
        kr[e] = kv.x;
        kr[e + 1] = kv.y;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) sum = fmaf(qr[g][e], kr[e], sum);
          sum = warp_sum(sum);
          if (lane == 0) s_s[g * page + j] = j < valid ? sum : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax update: one warp per query head.
    for (int g = warp; g < group; g += kWarps) {
      float* srow = s_s + g * page;
      float mx = kNegInf;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, srow[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float pr = expf(srow[j] - m_new);
        srow[j] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V over the page's live rows (masked rows
    // carry p == 0 exactly, so stopping at `valid` changes nothing).
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < group * HD) {
        const int g = idx / HD;
        const int d = idx - g * HD;
        const float* prow = s_s + g * page;
        float a = acc[k] * a_s[g];
        for (int j = 0; j < valid; ++j)
          a = fmaf(prow[j], __bfloat162float(v_s[j * HD + d]), a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < group * HD) {
      const int g = idx / HD;
      out[q_base + idx] = acc[k] / fmaxf(l_s[g], 1e-30f);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lengths, void* out, int slots,
           int hkv, int group, int n_pages, int page, int max_pages,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)page * HD * sizeof(__nv_bfloat16) +
                      (kMaxGroup * (size_t)page + 3 * kMaxGroup) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(hkv, slots);
  paged_decode_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(out), hkv, group, n_pages, page, max_pages,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int slots, int hkv,
    int group, int head_dim, int n_pages, int page, int max_pages,
    float sm_scale, void* stream) {
  if ((group != 1 && group != 2 && group != 4 && group != 8) ||
      (page != 16 && page != 32 && page != 64) || slots < 1 || hkv < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k_pages, v_pages, tables, lengths, out, slots, hkv,
                        group, n_pages, page, max_pages, sm_scale, s);
    case 128:
      return launch<128>(q, k_pages, v_pages, tables, lengths, out, slots, hkv,
                         group, n_pages, page, max_pages, sm_scale, s);
    default:
      return -1;
  }
}
