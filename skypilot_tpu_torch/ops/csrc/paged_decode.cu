// Paged decode and speculative-verify attention for Hopper (sm_90a):
// R query tokens per slot (decode: R = 1) over the slot's block table of
// K/V pages, bf16 pages or int8 pages with fp32 row scales.
//
// Replaces: skypilot_tpu/ops/paged_attention.py, _decode_kernel (entry
// paged_decode_attention) and _verify_kernel (entry
// paged_verify_attention), each in its bf16 and its int8 flavor
// (quantized=True).
//
// What bounds it on the H100: device-memory bytes. A step reads every
// owned K/V row once (sum over slots of len_i * hkv * hd * 2 (K and V)
// * 2 B for bf16, (hd + 4) B a row for int8 with its scale) and does
// 4 * R * group FLOPs per row element, far below the ~295 FLOP/byte the
// tensor cores need to matter. The floor is those bytes over 3.35 TB/s.
//
// What the design does about it: the TPU kernels walk a sequential page
// grid with the block table in scalar prefetch and VMEM accumulators
// carried across grid steps. Here one CUDA block owns one (slot,
// kv_head) pair and loops over that slot's pages itself: it reads
// lengths[b] and the table row directly, loops only over the pages any
// of its queries can see (dead pages cost no loads), and stages each K/V
// page in shared memory with 16-byte loads (8 bf16 or 16 int8 values
// each), so every page row is read from device memory once for all R x
// group query rows of the KV head (GQA is native, K/V never replicated;
// verify reads a page once for all R queries). int8 rows are
// dequantized while staged, float(value) * scale in fp32, the scale read
// at the same page id as the values, so the products see exactly the
// reference's dequantized rows. Scores are one warp per key row (lanes
// split the head dim, the block's scaled queries sit in shared memory in
// fp32); the online softmax keeps fp32 running max / sum / accumulator
// per query row, mask value -1e30 and a final l = max(l, 1e-30), as the
// reference does. Rows are queries x group, group fastest (row r is
// query r / group); row r sees positions < lengths[b] + off + r / group
// (off 0 for decode, whose callers pass the bumped length; 1 for
// verify, whose lengths are those before the run), a horizon computed
// once per row. Decode keeps its few scaled query rows in registers;
// verify's up to 64 rows sit in shared memory, read as vectors.
//
// Decode and verify are one template, decode its R = 1 instance. Every
// row's arithmetic is independent of how many rows the block holds: the
// same lane split of the head dim, the same page-row order, and a page
// fully masked for a row is an exact no-op for it (its p are exactly 0,
// alpha exactly 1, its p @ V loop runs no step). So verify's query-0
// rows are bitwise the decode kernel's output at lengths + 1, which the
// exact-greedy acceptance rule rests on; chip_smoke.py checks it.
//
// Known limits of this first version: slots * hkv blocks (64 at the 8B
// shapes) do not fill 132 SMs, and a page's load is not overlapped with
// the previous page's arithmetic; split-K over pages and a cp.async ring
// are later work.
//
// Interface: plain C functions bound with ctypes; each launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, page 16, 32 or 64; verify: 2..8 queries per slot with queries
// x group <= 64 -- the shapes chip_smoke.py checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxGroup = 8;
constexpr int kMaxVerifyRows = 64;

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

// Page element type in device memory -> its staged type in shared
// memory: bf16 rows are staged as they are, int8 rows dequantized to
// fp32.
template <typename T>
struct Staged;
template <>
struct Staged<__nv_bfloat16> {
  using type = __nv_bfloat16;
};
template <>
struct Staged<int8_t> {
  using type = float;
};

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }

// The E head-dim values lane `lane` owns of one fp32 query row.
template <int E>
__device__ __forceinline__ void load_q(const float* row, float* out) {
  if constexpr (E == 4) {
    const float4 v = *reinterpret_cast<const float4*>(row);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(row);
    out[0] = v.x;
    out[1] = v.y;
  }
}

// Stage one [page][HD] page into shared memory, 16-byte loads.
template <int HD, int THREADS>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src,
                                      const float* __restrict__ scales,
                                      __nv_bfloat16* dst, int page, int tid) {
  (void)scales;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = tid; i < page * HD / 8; i += THREADS) d[i] = s[i];
}

template <int HD, int THREADS>
__device__ __forceinline__ void stage(const int8_t* __restrict__ src,
                                      const float* __restrict__ scales,
                                      float* dst, int page, int tid) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = tid; i < page * HD / 16; i += THREADS) {
    const uint4 raw = s[i];
    const float sc = scales[(i * 16) / HD];  // one row holds HD/16 vectors
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    float4* d = reinterpret_cast<float4*>(dst + i * 16);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      d[c] = make_float4((float)v[4 * c] * sc, (float)v[4 * c + 1] * sc,
                         (float)v[4 * c + 2] * sc, (float)v[4 * c + 3] * sc);
  }
}

// ROWS: the most query rows (R x group) a block holds; THREADS its
// threads. q/out: [slots, R, hkv, group, HD] (decode: R = 1).
template <int HD, int ROWS, int THREADS, typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, int r_queries, int hkv,
                       int group, int n_pages, int page, int max_pages,
                       int horizon_offset, float sm_scale) {
  using S = typename Staged<T>::type;
  constexpr int WARPS = THREADS / 32;
  constexpr int E = HD / 32;                  // head-dim values per lane
  constexpr int NACC = ROWS * HD / THREADS;   // outputs per thread
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_rows = r_queries * group;

  extern __shared__ __align__(16) unsigned char smem[];
  S* k_s = reinterpret_cast<S*>(smem);                     // [page][HD]
  S* v_s = k_s + page * HD;                                // [page][HD]
  float* q_s = reinterpret_cast<float*>(v_s + page * HD);  // [ROWS][HD]
  float* s_s = q_s + ROWS * HD;                            // [ROWS][page]
  float* m_s = s_s + ROWS * page;
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  int* hz_s = reinterpret_cast<int*>(a_s + ROWS);          // [ROWS]

  // Positions < hz_s[r] = hz0 + r / group are visible to row r.
  const int hz0 = lengths[b] + horizon_offset;
  const int n_live =
      min((hz0 + r_queries - 1 + page - 1) / page, max_pages);

  // The block's scaled queries, fp32. Row r = query r / group, head
  // r % group: q[((b * R + r / group) * hkv + h) * group + r % group].
  for (int idx = tid; idx < n_rows * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int i = r / group;
    const size_t src =
        (((size_t)b * r_queries + i) * hkv + h) * group + (r - i * group);
    q_s[idx] = __bfloat162float(q[src * HD + d]) * sm_scale;
  }
  if (tid < ROWS) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    hz_s[tid] = hz0 + tid / group;
  }
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  __syncthreads();
  // Decode's rows (at most kMaxGroup) live in registers.
  constexpr bool kQRegs = ROWS <= kMaxGroup;
  float qreg[kQRegs ? ROWS : 1][E];
  if constexpr (kQRegs) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) load_q<E>(q_s + r * HD + lane * E, qreg[r]);
  }

  for (int p = 0; p < n_live; ++p) {
    const int pid = tables[(size_t)b * max_pages + p];
    const size_t first = ((size_t)h * n_pages + pid) * page;  // page's row 0
    stage<HD, THREADS>(k_pages + first * HD, k_scales + first, k_s, page, tid);
    stage<HD, THREADS>(v_pages + first * HD, v_scales + first, v_s, page, tid);
    __syncthreads();
    const int base = p * page;

    // Scores: one warp per key row, every query row of the block.
    for (int j = warp; j < page; j += WARPS) {
      float kr[E];
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        const float2 kv = ld2(k_s + j * HD + lane * E + e);
        kr[e] = kv.x;
        kr[e + 1] = kv.y;
      }
      if constexpr (kQRegs) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < n_rows) {
            float sum = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) sum = fmaf(qreg[r][e], kr[e], sum);
            sum = warp_sum(sum);
            if (lane == 0)
              s_s[r * page + j] = base + j < hz_s[r] ? sum : kNegInf;
          }
        }
      } else {
        for (int r = 0; r < n_rows; ++r) {
          float qr[E];
          load_q<E>(q_s + r * HD + lane * E, qr);
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) sum = fmaf(qr[e], kr[e], sum);
          sum = warp_sum(sum);
          if (lane == 0)
            s_s[r * page + j] = base + j < hz_s[r] ? sum : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax update: one warp per query row.
    for (int r = warp; r < n_rows; r += WARPS) {
      float* srow = s_s + r * page;
      float mx = kNegInf;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, srow[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
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
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V over the page rows the query row sees
    // (its masked rows carry p == 0 exactly, so stopping there changes
    // nothing).
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      const int idx = tid + k * THREADS;
      if (idx < n_rows * HD) {
        const int r = idx / HD;
        const int d = idx - r * HD;
        const int valid = min(page, hz_s[r] - base);
        const float* prow = s_s + r * page;
        float a = acc[k] * a_s[r];
        for (int j = 0; j < valid; ++j)
          a = fmaf(prow[j], ld1(v_s + j * HD + d), a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int idx = tid + k * THREADS;
    if (idx < n_rows * HD) {
      const int r = idx / HD;
      const int d = idx - r * HD;
      const int i = r / group;
      const size_t dst =
          (((size_t)b * r_queries + i) * hkv + h) * group + (r - i * group);
      out[dst * HD + d] = acc[k] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <int HD, int ROWS, int THREADS, typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* tables,
           const void* lengths, void* out, int slots, int r_queries,
           int hkv, int group, int n_pages, int page, int max_pages,
           int horizon_offset, float sm_scale, cudaStream_t stream) {
  using S = typename Staged<T>::type;
  const size_t smem = 2 * (size_t)page * HD * sizeof(S) +
                      ((size_t)ROWS * HD + (size_t)ROWS * page + 4 * ROWS) *
                          sizeof(float);
  auto kernel = paged_attention_kernel<HD, ROWS, THREADS, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(hkv, slots);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), r_queries,
      hkv, group, n_pages, page, max_pages, horizon_offset, sm_scale);
  return (int)cudaGetLastError();
}

// Decode blocks hold up to kMaxGroup rows on 128 threads; verify blocks
// up to kMaxVerifyRows on 256.
template <typename T>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales, const void* tables,
             const void* lengths, void* out, int slots, int r_queries,
             int hkv, int group, int head_dim, int n_pages, int page,
             int max_pages, float sm_scale, void* stream) {
  const bool verify = r_queries > 1;
  if ((group != 1 && group != 2 && group != 4 && group != 8) ||
      (page != 16 && page != 32 && page != 64) || slots < 1 || hkv < 1 ||
      r_queries < 1 || r_queries > 8 ||
      r_queries * group > (verify ? kMaxVerifyRows : kMaxGroup))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int off = verify ? 1 : 0;
#define PAGED_LAUNCH(HD, ROWS, THREADS)                                    \
  launch<HD, ROWS, THREADS, T>(q, k_pages, v_pages, k_scales, v_scales,    \
                               tables, lengths, out, slots, r_queries, hkv, \
                               group, n_pages, page, max_pages, off,       \
                               sm_scale, s)
  switch (head_dim) {
    case 64:
      return verify ? PAGED_LAUNCH(64, kMaxVerifyRows, 256)
                    : PAGED_LAUNCH(64, kMaxGroup, 128);
    case 128:
      return verify ? PAGED_LAUNCH(128, kMaxVerifyRows, 256)
                    : PAGED_LAUNCH(128, kMaxGroup, 128);
    default:
      return -1;
  }
#undef PAGED_LAUNCH
}

}  // namespace

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int slots, int hkv,
    int group, int head_dim, int n_pages, int page, int max_pages,
    float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                 tables, lengths, out, slots, 1, hkv, group,
                                 head_dim, n_pages, page, max_pages, sm_scale,
                                 stream);
}

extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, int slots, int hkv, int group,
    int head_dim, int n_pages, int page, int max_pages, float sm_scale,
    void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, out, slots, 1, hkv, group, head_dim,
                          n_pages, page, max_pages, sm_scale, stream);
}

extern "C" int paged_verify_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int slots,
    int r_queries, int hkv, int group, int head_dim, int n_pages, int page,
    int max_pages, float sm_scale, void* stream) {
  if (r_queries < 2) return -1;
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                 tables, lengths, out, slots, r_queries, hkv,
                                 group, head_dim, n_pages, page, max_pages,
                                 sm_scale, stream);
}

extern "C" int paged_verify_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, int slots, int r_queries, int hkv,
    int group, int head_dim, int n_pages, int page, int max_pages,
    float sm_scale, void* stream) {
  if (r_queries < 2) return -1;
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, out, slots, r_queries, hkv, group,
                          head_dim, n_pages, page, max_pages, sm_scale,
                          stream);
}
