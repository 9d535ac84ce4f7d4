// Paged prefill attention for Hopper (sm_90a): a C-token chunk of ONE
// slot attends causally, in global positions offset..offset+C-1, over
// the slot's paged prefix plus the chunk itself.
//
// Replaces: skypilot_tpu/ops/paged_attention.py, _prefill_kernel (entry
// paged_prefill_attention), bf16 flavor.
//
// What bounds it on the H100: arithmetic for long prefixes. The chunk
// does about 4 * C * hq * hd * (offset + C) FLOPs per layer against
// (offset + C) * hkv * hd * 4 bytes of K/V, i.e. hundreds of FLOPs per
// byte; the floor is those FLOPs over 989 TFLOP/s (bf16 tensor cores).
//
// What the design does about it: the TPU kernel flattens queries x group
// into rows (group fastest: row r is query r // group), walks a
// sequential grid of pages with VMEM accumulators carried across steps,
// and fans several pages into each step. Here one CUDA block owns one
// (kv_head, tile of 64 rows) pair, keeps its scaled query tile in shared
// memory in fp32, and loops over the slot's pages itself, reading the
// table row directly. Each K/V page is staged once in shared memory for
// all 64 rows (padded rows keep the reads free of bank conflicts), and
// every thread computes a 4 x (page/16) tile of scores and a 4 x (hd/16)
// tile of the output in registers, so each shared-memory load feeds
// several FMAs. Causality is masked in global positions (kpos <= offset +
// r // group) and the page loop stops at the last page any row of the
// tile can see -- pages past it are fully masked, an exact no-op in the
// online softmax -- so a tile never loads what it cannot attend to. fp32
// online softmax (mask -1e30, final l = max(l, 1e-30)) and fp32 output
// [C, hkv, group, hd]; rows past true_len are garbage the caller drops.
// This first version runs the products on the CUDA cores in fp32, far
// from the tensor-core bound; mma.sync/wgmma, TMA and split-K over pages
// are later work.
//
// Interface: a plain C function bound with ctypes; it launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, page 16, 32 or 64 -- the shapes chip_smoke.py checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // query rows (queries x group) per block
constexpr float kNegInf = -1e30f;

template <int HD, int PAGE>
struct Layout {
  static constexpr int QS = HD + 2;    // fp32 query row stride (padded)
  static constexpr int KS = HD + 2;    // bf16 key row stride (padded)
  static constexpr int SS = PAGE + 1;  // fp32 score row stride (padded)
  static constexpr size_t q_bytes = (size_t)kRows * QS * sizeof(float);
  static constexpr size_t k_bytes = (size_t)PAGE * KS * sizeof(__nv_bfloat16);
  static constexpr size_t v_bytes = (size_t)PAGE * HD * sizeof(__nv_bfloat16);
  static constexpr size_t s_bytes = (size_t)kRows * SS * sizeof(float);
  static constexpr size_t total =
      q_bytes + v_bytes + k_bytes + s_bytes + 3 * kRows * sizeof(float);
};

template <int HD, int PAGE>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_pages,
                     const __nv_bfloat16* __restrict__ v_pages,
                     const int* __restrict__ table_row,
                     float* __restrict__ out, int chunk, int hkv, int group,
                     int n_pages, int offset, int true_len, float sm_scale) {
  using L = Layout<HD, PAGE>;
  constexpr int NC = PAGE / 16;  // key columns per thread
  constexpr int ND = HD / 32;    // output column pairs per thread
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_rows = chunk * group;
  const int row0 = tile * kRows;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                      // [kRows][QS]
  __nv_bfloat16* v_s =
      reinterpret_cast<__nv_bfloat16*>(smem + L::q_bytes);          // [PAGE][HD]
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(
      smem + L::q_bytes + L::v_bytes);                              // [PAGE][KS]
  float* s_s = reinterpret_cast<float*>(
      smem + L::q_bytes + L::v_bytes + L::k_bytes);                 // [kRows][SS]
  float* m_s = s_s + kRows * L::SS;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;

  // Scaled query tile, fp32. Row r of the tile is global row row0 + r =
  // query (row0 + r) / group, head (row0 + r) % group.
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int rg = row0 + r;
    float v = 0.f;
    if (rg < n_rows) {
      const int c = rg / group;
      const int g = rg - c * group;
      v = __bfloat162float(q[(((size_t)c * hkv + h) * group + g) * HD + d]) *
          sm_scale;
    }
    q_s[r * L::QS + d] = v;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // Pages any row of this tile can see: up to its last query position.
  const int total = offset + true_len;
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int max_qpos = offset + last_row / group;
  const int n_live = min((total + PAGE - 1) / PAGE, max_qpos / PAGE + 1);

  const int cl = tid & 15;  // column lane: keys cl + 16c / pairs cl + 16c
  const int rl = tid >> 4;  // row lane: rows rl + 16i
  float2 acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = make_float2(0.f, 0.f);
  __syncthreads();

  constexpr int VEC_PER_ROW = HD / 8;
  for (int p = 0; p < n_live; ++p) {
    const int pid = table_row[p];
    const size_t base = ((size_t)h * n_pages + pid) * PAGE * HD;
    const uint4* ksrc = reinterpret_cast<const uint4*>(k_pages + base);
    const uint4* vsrc = reinterpret_cast<const uint4*>(v_pages + base);
    for (int i = tid; i < PAGE * VEC_PER_ROW; i += kThreads) {
      const int j = i / VEC_PER_ROW;
      const int col = (i - j * VEC_PER_ROW) * 8;
      const uint4 kv = ksrc[i];
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + j * L::KS + col);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      reinterpret_cast<uint4*>(v_s)[i] = vsrc[i];
    }
    __syncthreads();

    // Scores: rows rl + 16i x keys cl + 16c, causal in global positions.
    float sc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 qv[4];
      float2 kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float2*>(q_s + (rl + 16 * i) * L::QS + d);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kv[c] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            k_s + (cl + 16 * c) * L::KS + d));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          sc[i][c] = fmaf(qv[i].y, kv[c].y, fmaf(qv[i].x, kv[c].x, sc[i][c]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rl + 16 * i;
      const int qpos = offset + (row0 + r) / group;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = cl + 16 * c;
        s_s[r * L::SS + j] = (p * PAGE + j <= qpos) ? sc[i][c] : kNegInf;
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
      for (int j = sub; j < PAGE; j += 4) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = sub; j < PAGE; j += 4) {
        const float pr = expf(srow[j] - m_new);
        srow[j] = pr;
        sum += pr;
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

    // acc = acc * alpha + p @ V over the page's rows below the frontier
    // (rows at or past it are masked for every row that matters).
    const int jmax = min(PAGE, total - p * PAGE);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[rl + 16 * i];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        acc[i][c].x *= a;
        acc[i][c].y *= a;
      }
    }
    for (int j = 0; j < jmax; ++j) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = s_s[(rl + 16 * i) * L::SS + j];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                v_s + j * HD + 2 * (cl + 16 * c)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c].x = fmaf(pr[i], vv.x, acc[i][c].x);
          acc[i][c].y = fmaf(pr[i], vv.y, acc[i][c].y);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rl + 16 * i;
    const int rg = row0 + r;
    if (rg < n_rows) {
      const int c0 = rg / group;
      const int g = rg - c0 * group;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      float* orow = out + (((size_t)c0 * hkv + h) * group + g) * HD;
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = 2 * (cl + 16 * c);
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[i][c].x * inv, acc[i][c].y * inv);
      }
    }
  }
}

template <int HD, int PAGE>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table_row, void* out, int chunk, int hkv, int group,
           int n_pages, int offset, int true_len, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Layout<HD, PAGE>::total;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<HD, PAGE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = chunk * group;
  dim3 grid((n_rows + kRows - 1) / kRows, hkv);
  paged_prefill_kernel<HD, PAGE><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(table_row), static_cast<float*>(out), chunk, hkv,
      group, n_pages, offset, true_len, sm_scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* k_pages, const void* v_pages,
              const void* table_row, void* out, int chunk, int hkv, int group,
              int n_pages, int page, int offset, int true_len,
              float sm_scale, cudaStream_t s) {
  switch (page) {
    case 16:
      return launch<HD, 16>(q, k_pages, v_pages, table_row, out, chunk, hkv,
                            group, n_pages, offset, true_len, sm_scale, s);
    case 32:
      return launch<HD, 32>(q, k_pages, v_pages, table_row, out, chunk, hkv,
                            group, n_pages, offset, true_len, sm_scale, s);
    case 64:
      return launch<HD, 64>(q, k_pages, v_pages, table_row, out, chunk, hkv,
                            group, n_pages, offset, true_len, sm_scale, s);
    default:
      return -1;
  }
}

}  // namespace

extern "C" int paged_prefill_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table_row, void* out, int chunk, int hkv, int group,
    int head_dim, int n_pages, int page, int offset, int true_len,
    float sm_scale, void* stream) {
  if (chunk < 1 || hkv < 1 || true_len < 1 || offset < 0 ||
      (group != 1 && group != 2 && group != 4 && group != 8))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_hd<64>(q, k_pages, v_pages, table_row, out, chunk, hkv,
                           group, n_pages, page, offset, true_len, sm_scale, s);
    case 128:
      return launch_hd<128>(q, k_pages, v_pages, table_row, out, chunk, hkv,
                            group, n_pages, page, offset, true_len, sm_scale,
                            s);
    default:
      return -1;
  }
}
