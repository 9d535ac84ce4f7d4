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
// live K/V row once (sum over slots of len_i * hkv * hd * 2 (K and V)
// * 2 B for bf16, (hd + 4) B a row for int8 with its scale) and does
// 4 * R * group FLOPs per row element, far below the ~295 FLOP/byte the
// tensor cores need to matter. The floor is those bytes over 3.35 TB/s.
//
// What the design does about it:
//
// - Pages split across blocks (split-KV). A slot's pages fall into
//   splits of kPagesPerSplit = 4 consecutive pages by page index alone;
//   the grid is (hkv, slots, ceil(max_pages / 4)) and a block past its
//   slot's live pages exits at once (split 0 always runs, so a slot with
//   no live key still writes its zero output). lengths stays on the
//   device: no host readback. At the 8B timing case (decode lengths 1,
//   64, 65, 2000, 512, 1023, 777, 130; pages of 64; 8 KV heads) 22
//   splits are live, 176 blocks on 132 SMs (verify, R = 5 over lengths
//   ending 2044: 31 splits, 248 blocks); the old one-block-per-(slot,
//   head) grid had 64 and the 2000-token slot walked its 32 pages alone.
//   Two pages a split (320 and 448 blocks) measured 1.07x (decode) and
//   1.5x (verify) slower in one call on the H100: every block pays a
//   fixed start, merge and atomic, and the ring below never cycled.
// - Page loads overlapped with compute: each split's pages stream
//   through a ring of kStages = 2 shared-memory stages filled by 16-byte
//   cp.async copies, so page i + 1 lands while page i is multiplied and
//   page i + 2 is requested as soon as page i's stage is free. int8
//   pages are staged as int8 (half the bytes) with their scales beside
//   them and turned into bf16 fragments where the products read them.
// - Tensor-core scores and P @ V, no butterflies. Query rows (R x
//   group, group fastest: row r is query r / group, head r % group) sit
//   in M-tiles of 16, one warp per (M-tile, key group); a block has 4 key
//   groups, and the split's 16-key chunks go to key group chunk % 4. A
//   warp runs S = q k^T for its chunk as mma.sync m16n8k16 (q unscaled
//   bf16, k bf16 -- int8 values are exact in bf16 -- fp32 sums), then
//   scales S in fp32 (the int8 K row scale first, then sm_scale), masks,
//   and keeps its rows' running max, sum and fp32 accumulator over its
//   chunks (row max and row sum take 2 quad shuffles each). The S
//   fragments become the A fragments of P @ V in registers (the FA2
//   trick); P (times the V row scale for int8) goes in as hi = bf16(P)
//   and lo = bf16(P - hi), two products into one fp32 accumulator. A
//   masked key gets p = 0 exactly, so a chunk, page or split fully
//   masked for a row leaves it m = -1e30, l = 0, acc = 0.
// - Deterministic combine in the same launch. The block merges its 4
//   key groups' partials (m, l, acc) in key-group order through shared
//   memory and writes one partial per split to a workspace the wrapper
//   allocates; the last block of each (slot, KV head) to finish, found
//   by an atomic counter it returns to zero, merges the splits in
//   split-index order and writes acc / max(l, 1e-30). One merge path for
//   one split and for many: a split's weight is exp(m_s - M), exactly 1
//   for the largest and exactly 0 for a split fully masked for the row.
//   A thread merges one output element at a time; holding HD / 8
//   elements a thread, each split's reads in flight together, measured
//   up to 1.24x slower in one call (158-164 registers, not 125-128).
//
// Decode and verify are one template, decode its R = 1 instance. Row
// r sees positions < lengths[b] + off + r / group (off 0 for decode,
// whose callers pass the bumped length; 1 for verify). Every row's
// arithmetic is independent of how many rows or M-tiles the block
// holds: the same chunk-to-key-group map, the same page, k-step and
// hi/lo order, and work past a row's horizon (verify's extra pages and
// splits) is an exact no-op for it. So verify's query-0 rows are bitwise
// the decode kernel's output at lengths + 1, which the exact-greedy
// acceptance rule rests on; chip_smoke.py checks it.
//
// Interface: plain C functions bound with ctypes; each launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, page 16, 32 or 64; verify: 2..8 queries per slot with queries
// x group <= 64 -- the shapes chip_smoke.py checks). The workspace holds
// slots * hkv * ceil(max_pages / kPagesPerSplit) partials of rows * (hd +
// 2) fp32 (rows = R * group); counters is slots * hkv int32, zero before
// the launch and zero after it, so launches that share it must be
// ordered (one stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::pack_bf16;
using hopper::smem_u32;
using hopper::split_bf16;

constexpr float kNegInf = -1e30f;
constexpr int kPagesPerSplit = 4;
constexpr int kStages = 2;
constexpr int kKeyGroups = 4;  // warps that share an M-tile's keys
constexpr int kChunk = 16;     // keys per chunk: one k step of P @ V
constexpr int kMaxRows = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16 x 16, row) @ b (16 x 8, col): bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring values of one staged row, as packed bf16.
__device__ __forceinline__ uint32_t row_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t row_pair(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return pack_bf16((float)v.x, (float)v.y);
}
// One column's values in two neighbouring staged rows, as packed bf16.
__device__ __forceinline__ uint32_t col_pair(const __nv_bfloat16* p,
                                             int stride) {
  __nv_bfloat162 h;
  h.x = p[0];
  h.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t col_pair(const int8_t* p, int stride) {
  return pack_bf16((float)p[0], (float)p[stride]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Merge n partials of one output element (row r, column d) in index
// order. A partial is [m: rows][l: rows][acc: rows x HD] fp32; partial i
// starts at p + i * stride. Global partials are read from L2 (__ldcg):
// other blocks wrote them.
template <int HD, bool kGlobal>
__device__ __forceinline__ void merge(const float* p, int n, size_t stride,
                                      int rows, int r, int d, float& M,
                                      float& L, float& A) {
  auto ld = [](const float* x) {
    if constexpr (kGlobal)
      return __ldcg(x);
    else
      return *x;
  };
  M = kNegInf;
  for (int i = 0; i < n; ++i) M = fmaxf(M, ld(p + i * stride + r));
  L = 0.f;
  A = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* q = p + i * stride;
    const float w = expf(ld(q + r) - M);
    L = fmaf(ld(q + rows + r), w, L);
    A = fmaf(ld(q + 2 * rows + (size_t)r * HD + d), w, A);
  }
}

template <int HD, typename T>
struct Layout {
  static constexpr int kRow = HD * (int)sizeof(T) + 16;  // staged row bytes
  static constexpr int kRowElems = kRow / (int)sizeof(T);
  static constexpr int kQRow = HD + 8;                   // q row, bf16
  static constexpr bool kInt8 = sizeof(T) == 1;
  // One stage: K page, V page, then (int8) the K and V row scales.
  __host__ __device__ static size_t stage(int page) {
    return 2 * (size_t)page * kRow + (kInt8 ? 2 * (size_t)page * 4 : 0);
  }
  // The ring, or after it the key groups' partials, then q and a flag.
  __host__ __device__ static size_t region(int page, int tiles) {
    const size_t ring = kStages * stage(page);
    const size_t parts =
        (size_t)kKeyGroups * 16 * tiles * (HD + 2) * sizeof(float);
    return ring > parts ? ring : parts;
  }
  __host__ __device__ static size_t smem(int page, int tiles) {
    return region(page, tiles) + (size_t)16 * tiles * kQRow * 2 + 16;
  }
};

// TILES: the M-tiles of 16 query rows a block holds (128 threads each).
// q/out: [slots, R, hkv, group, HD] (decode: R = 1).
template <int HD, int TILES, typename T>
__global__ void __launch_bounds__(128 * TILES)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, float* __restrict__ ws,
                       int* __restrict__ counters, int r_queries, int hkv,
                       int group, int n_pages, int page, int max_pages,
                       int horizon_offset, float sm_scale) {
  using Lay = Layout<HD, T>;
  constexpr int THREADS = 128 * TILES;
  constexpr int ROWS = 16 * TILES;  // rows the block's tiles hold
  constexpr int SR = Lay::kRowElems;
  constexpr int QR = Lay::kQRow;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kg = warp % kKeyGroups;  // key group
  const int mt = warp / kKeyGroups;  // M-tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_rows = r_queries * group;

  // Positions < hz0 + r / group are visible to row r.
  const int hz0 = lengths[b] + horizon_offset;
  const int n_live =
      min((hz0 + r_queries - 1 + page - 1) / page, max_pages);
  const int n_splits =
      max(1, (n_live + kPagesPerSplit - 1) / kPagesPerSplit);
  if (split >= n_splits) return;
  const int p0 = split * kPagesPerSplit;
  const int n = max(0, min(kPagesPerSplit, n_live - p0));

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t stage_bytes = Lay::stage(page);
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(smem + Lay::region(page, TILES));
  int* flag = reinterpret_cast<int*>(q_s + ROWS * QR);

  // Stage page i of the split: K rows, V rows (and their scales).
  auto load_page = [&](int i) {
    unsigned char* st = smem + (i % kStages) * stage_bytes;
    const int pid = tables[(size_t)b * max_pages + p0 + i];
    const size_t first = ((size_t)h * n_pages + pid) * page;  // row 0
    const unsigned char* k_src =
        reinterpret_cast<const unsigned char*>(k_pages + first * HD);
    const unsigned char* v_src =
        reinterpret_cast<const unsigned char*>(v_pages + first * HD);
    constexpr int kVecs = HD * (int)sizeof(T) / 16;  // per row
    for (int c = tid; c < page * kVecs; c += THREADS) {
      const int row = c / kVecs;
      const int off = (c - row * kVecs) * 16;
      cp_async16(st + row * Lay::kRow + off, k_src + (size_t)c * 16);
      cp_async16(st + (page + row) * Lay::kRow + off,
                 v_src + (size_t)c * 16);
    }
    if constexpr (Lay::kInt8) {
      unsigned char* sc = st + 2 * page * Lay::kRow;
      for (int c = tid; c < page / 4; c += THREADS) {
        cp_async16(sc + c * 16, k_scales + first + 4 * c);
        cp_async16(sc + page * 4 + c * 16, v_scales + first + 4 * c);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n) load_page(i);
    cp_async_commit();
  }

  // The block's query rows, unscaled bf16, zero past n_rows. Row r:
  // q[((b * R + r / group) * hkv + h) * group + r % group].
  for (int idx = tid; idx < ROWS * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (r < n_rows) {
      const int i = r / group;
      const size_t src =
          (((size_t)b * r_queries + i) * hkv + h) * group + (r - i * group);
      v = q[src * HD + d];
    }
    q_s[r * QR + d] = v;
  }

  // This thread's rows of the warp's M-tile: ra (fragment entries 0, 1)
  // and rb = ra + 8 (entries 2, 3).
  const int ra = mt * 16 + g;
  const int rb = ra + 8;
  const int hz_a = hz0 + ra / group;
  const int hz_b = hz0 + rb / group;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int chunks = page / kChunk;  // per page
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* st = smem + (i % kStages) * stage_bytes;
    const T* k_s = reinterpret_cast<const T*>(st);
    const T* v_s = reinterpret_cast<const T*>(st + page * Lay::kRow);
    const float* ks_s =
        reinterpret_cast<const float*>(st + 2 * page * Lay::kRow);
    const float* vs_s = ks_s + page;
    for (int j = 0; j < chunks; ++j) {
      if ((i * chunks + j) % kKeyGroups != kg) continue;
      const int key0 = j * kChunk;                  // in the page
      const int pos0 = (p0 + i) * page + key0;      // in the slot
      // S = q k^T over this chunk: 2 n-tiles of 8 keys.
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* qa = q_s + ra * QR + kk * 16 + 2 * t;
        const uint32_t a[4] = {row_pair(qa), row_pair(qa + 8 * QR),
                               row_pair(qa + 8), row_pair(qa + 8 * QR + 8)};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const T* kr = k_s + (key0 + nt * 8 + g) * SR + kk * 16 + 2 * t;
          mma_bf16(s[nt], a, row_pair(kr), row_pair(kr + 8));
        }
      }
      // Scale in fp32 (int8: the K row scale, then sm_scale), mask.
      bool live[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = nt * 8 + 2 * t + (e & 1);
          float v = s[nt][e];
          if constexpr (Lay::kInt8) v *= ks_s[key0 + key];
          v *= sm_scale;
          live[nt][e] = pos0 + key < (e < 2 ? hz_a : hz_b);
          s[nt][e] = live[nt][e] ? v : kNegInf;
        }
      const float mn_a = fmaxf(
          m_a, quad_max(fmaxf(fmaxf(s[0][0], s[0][1]),
                              fmaxf(s[1][0], s[1][1]))));
      const float mn_b = fmaxf(
          m_b, quad_max(fmaxf(fmaxf(s[0][2], s[0][3]),
                              fmaxf(s[1][2], s[1][3]))));
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              live[nt][e] ? expf(s[nt][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
          if (e < 2)
            sum_a += p;
          else
            sum_b += p;
          // P @ V's operand: int8 folds the V row scale into P.
          if constexpr (Lay::kInt8)
            s[nt][e] = p * vs_s[key0 + nt * 8 + 2 * t + (e & 1)];
          else
            s[nt][e] = p;
        }
      const float alpha_a = expf(m_a - mn_a);
      const float alpha_b = expf(m_b - mn_b);
      l_a = fmaf(l_a, alpha_a, quad_sum(sum_a));
      l_b = fmaf(l_b, alpha_b, quad_sum(sum_b));
      m_a = mn_a;
      m_b = mn_b;
      // The S fragments as the A fragments of P @ V, hi and lo.
      uint32_t hi[4], lo[4];
      split_bf16(s[0][0], s[0][1], hi[0], lo[0]);
      split_bf16(s[0][2], s[0][3], hi[1], lo[1]);
      split_bf16(s[1][0], s[1][1], hi[2], lo[2]);
      split_bf16(s[1][2], s[1][3], hi[3], lo[3]);
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        acc[dn][0] *= alpha_a;
        acc[dn][1] *= alpha_a;
        acc[dn][2] *= alpha_b;
        acc[dn][3] *= alpha_b;
        const T* vc = v_s + (key0 + 2 * t) * SR + dn * 8 + g;
        const uint32_t b0 = col_pair(vc, SR);
        const uint32_t b1 = col_pair(vc + 8 * SR, SR);
        mma_bf16(acc[dn], hi, b0, b1);
        mma_bf16(acc[dn], lo, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (i + kStages < n) load_page(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // The key groups' partials, in the ring's place: [m][l][acc] each.
  constexpr size_t kPart = (size_t)ROWS * (HD + 2);
  float* part = reinterpret_cast<float*>(smem);
  float* mine = part + kg * kPart;
  if (t == 0) {
    mine[ra] = m_a;
    mine[rb] = m_b;
    mine[ROWS + ra] = l_a;
    mine[ROWS + rb] = l_b;
  }
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    float* o = mine + 2 * ROWS + dn * 8 + 2 * t;
    *reinterpret_cast<float2*>(o + ra * HD) =
        make_float2(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<float2*>(o + rb * HD) =
        make_float2(acc[dn][2], acc[dn][3]);
  }
  __syncthreads();

  // This split's partial: the key groups merged in order.
  const size_t split_part = (size_t)n_rows * (HD + 2);
  float* slot_parts = ws + ((size_t)b * hkv + h) * gridDim.z * split_part;
  float* dst = slot_parts + split * split_part;
  for (int idx = tid; idx < n_rows * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    float M, L, A;
    merge<HD, false>(part, kKeyGroups, kPart, ROWS, r, d, M, L, A);
    dst[2 * n_rows + idx] = A;
    if (d == 0) {
      dst[r] = M;
      dst[n_rows + r] = L;
    }
  }

  // The last of the slot's splits to finish merges them all in order.
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)b * hkv + h;
  if (tid == 0) *flag = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int idx = tid; idx < n_rows * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    float M, L, A;
    merge<HD, true>(slot_parts, n_splits, split_part, n_rows, r, d, M, L,
                    A);
    const int i = r / group;
    const size_t o =
        (((size_t)b * r_queries + i) * hkv + h) * group + (r - i * group);
    out[o * HD + d] = A / fmaxf(L, 1e-30f);
  }
  if (tid == 0) *counter = 0;
}

template <int HD, int TILES, typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* tables,
           const void* lengths, void* out, void* ws, void* counters,
           int slots, int r_queries, int hkv, int group, int n_pages,
           int page, int max_pages, int horizon_offset, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Layout<HD, T>::smem(page, TILES);
  auto kernel = paged_attention_kernel<HD, TILES, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(hkv, slots, (max_pages + kPagesPerSplit - 1) / kPagesPerSplit);
  kernel<<<grid, 128 * TILES, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), r_queries, hkv,
      group, n_pages, page, max_pages, horizon_offset, sm_scale);
  return (int)cudaGetLastError();
}

// Blocks hold as many M-tiles of 16 rows as R x group needs.
template <typename T>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales, const void* tables,
             const void* lengths, void* out, void* ws, void* counters,
             int slots, int r_queries, int hkv, int group, int head_dim,
             int n_pages, int page, int max_pages, float sm_scale,
             void* stream) {
  const int rows = r_queries * group;
  if ((group != 1 && group != 2 && group != 4 && group != 8) ||
      (page != 16 && page != 32 && page != 64) || slots < 1 || hkv < 1 ||
      max_pages < 1 || r_queries < 1 || r_queries > 8 || rows > kMaxRows)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int off = r_queries > 1 ? 1 : 0;
#define PAGED_LAUNCH(HD, TILES)                                              \
  launch<HD, TILES, T>(q, k_pages, v_pages, k_scales, v_scales, tables,      \
                       lengths, out, ws, counters, slots, r_queries, hkv,    \
                       group, n_pages, page, max_pages, off, sm_scale, s)
#define PAGED_TILES(HD)                        \
  switch ((rows + 15) / 16) {                  \
    case 1:                                    \
      return PAGED_LAUNCH(HD, 1);              \
    case 2:                                    \
      return PAGED_LAUNCH(HD, 2);              \
    case 3:                                    \
      return PAGED_LAUNCH(HD, 3);              \
    default:                                   \
      return PAGED_LAUNCH(HD, 4);              \
  }
  switch (head_dim) {
    case 64:
      PAGED_TILES(64)
    case 128:
      PAGED_TILES(128)
    default:
      return -1;
  }
#undef PAGED_TILES
#undef PAGED_LAUNCH
}

}  // namespace

extern "C" int paged_pages_per_split() { return kPagesPerSplit; }

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* ws,
    void* counters, int slots, int hkv, int group, int head_dim, int n_pages,
    int page, int max_pages, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                 tables, lengths, out, ws, counters, slots, 1,
                                 hkv, group, head_dim, n_pages, page,
                                 max_pages, sm_scale, stream);
}

extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, void* ws, void* counters, int slots,
    int hkv, int group, int head_dim, int n_pages, int page, int max_pages,
    float sm_scale, void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, out, ws, counters, slots, 1, hkv, group,
                          head_dim, n_pages, page, max_pages, sm_scale,
                          stream);
}

extern "C" int paged_verify_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* ws,
    void* counters, int slots, int r_queries, int hkv, int group,
    int head_dim, int n_pages, int page, int max_pages, float sm_scale,
    void* stream) {
  if (r_queries < 2) return -1;
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                 tables, lengths, out, ws, counters, slots,
                                 r_queries, hkv, group, head_dim, n_pages,
                                 page, max_pages, sm_scale, stream);
}

extern "C" int paged_verify_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, void* ws, void* counters, int slots,
    int r_queries, int hkv, int group, int head_dim, int n_pages, int page,
    int max_pages, float sm_scale, void* stream) {
  if (r_queries < 2) return -1;
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, out, ws, counters, slots, r_queries, hkv,
                          group, head_dim, n_pages, page, max_pages, sm_scale,
                          stream);
}
