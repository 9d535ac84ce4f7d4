// Paged prefill attention for Hopper (sm_90a): a C-token chunk of ONE
// slot attends causally, in global positions offset..offset+C-1, over
// the slot's paged prefix plus the chunk itself; bf16 pages or int8
// pages with fp32 row scales.
//
// Replaces: skypilot_tpu/ops/paged_attention.py, _prefill_kernel (entry
// paged_prefill_attention), its bf16 flavor and its int8 flavor
// (quantized=True: int8 pages with one fp32 scale per row).
//
// What bounds it on the H100: arithmetic for long prefixes. The chunk
// does about 4 * hq * hd * sum over its rows of the positions each sees
// (8.1e9 FLOPs for the last 256-token chunk of a 2048-token prompt at
// the 8B shapes) against (offset + C) * hkv * hd * 4 bytes of K/V:
// hundreds of FLOPs per byte, so the floor is those FLOPs over 989
// TFLOP/s (bf16 tensor cores). int8 pages halve the bytes and leave the
// FLOPs as they are.
//
// What the design does about it:
//
// - Rows and warps (FA2). Query rows are queries x group, group fastest
//   (row r is query r / group, head r % group), as in the TPU kernel. A
//   block holds kWarps M-tiles of 16 rows, one warp each, and every warp
//   walks every key of the block's pages itself: prefill has enough rows
//   that no key-group merge inside a block is needed. The grid is (row
//   tiles, hkv, splits).
// - Tensor cores. A warp keeps its 16 rows of q, unscaled bf16, in
//   registers as the A fragments of S = q k^T (loaded once), and runs S
//   over a whole page as mma.sync m16n8k16 with fp32 sums, its K
//   fragments by ldmatrix. It scales S in fp32 (the int8 K row scale
//   first, then sm_scale, into the log2 domain: exp2f is one instruction
//   where expf is several), masks per row (kpos <= offset + r / group:
//   with group 4 an M-tile spans 4 queries with 4 horizons; a page every
//   row of the M-tile sees whole skips the compares), and keeps an
//   online softmax per row (row max and sum by quad shuffles). The S
//   fragments become the A fragments of P @ V in registers; P (times the
//   V row scale for int8) goes in as hi = bf16(P) and lo = bf16(P - hi),
//   two products into one fp32 accumulator, V's fragments by
//   ldmatrix.trans. A masked key gets p = 0 exactly.
// - A page ring. A block's pages stream through kStages shared-memory
//   stages filled by 16-byte cp.async copies. One barrier a page: once
//   page i has landed and every warp has passed the barrier (so is done
//   with page i - 1), page i + kStages - 1 is requested into page i - 1's
//   stage, and lands while page i is multiplied. int8 pages are staged
//   as int8 (a quarter of the old fp32 staging) with their scales beside
//   them; after the barrier the block converts the page once into bf16
//   rows (exact, by integer and add instructions rather than the slower
//   conversion unit), a second barrier, and every warp reads those with
//   the bf16 path. Converting pair by pair where each warp's products
//   read them (each warp converting the whole page, without ldmatrix)
//   measured slower at both timing cases (PERF.md).
// - Causality. A block stops at the last page any of its rows can see,
//   and a warp skips pages past its own rows' horizon (an exact no-op);
//   pages past the block's last are never loaded.
// - Split-KV over pages. A tile's pages fall into splits of
//   kPagesPerSplit consecutive pages by page index alone, one block
//   each, so a long prefix fills the card. A tile with one split writes
//   acc / max(l, 1e-30) itself. Otherwise each split writes its partial
//   (m, l, acc) to a workspace the wrapper allocates, and the last block
//   of the (KV head, row tile) to finish, found by an atomic counter it
//   returns to zero, merges the splits in split order and writes the
//   output: deterministic, in one launch. It takes each row's max and
//   weighted sum over the splits once, then the row's columns four at a
//   time (element by element, 64 elements a thread, the merge cost more
//   than the split saved). Split 0 always runs, so every row is
//   written.
// - Pad rows. Rows past true_len are pad whose values the caller drops,
//   but they must be finite: the model writes them back into the pages
//   past the slot's frontier, where a later chunk's rows read them as
//   masked keys, and p = 0 times a non-finite V row is NaN in a
//   tensor-core product. So K/V rows past the frontier are staged as
//   zeros (and the int8 V scale is folded into P only for live keys),
//   a row sees keys below the frontier only, and a tile whose rows are
//   all pad writes zeros without reading a page.
//
// kWarps 4 (64 rows a block), kPagesPerSplit 16 and kStages 2 were chosen
// by tune_prefill.py on the H100 at chip_smoke.py's two timing cases,
// bf16 and int8 (PERF.md): 8 warps, 4 pages a split and a third stage
// were slower at all four, 8 and 32 pages a split at the long prefix.
//
// Two entries, one kernel. The host-scalar entry takes offset and
// true_len as integers and sizes its grid to the live pages. The
// device-scalar entry reads them from two device int32 scalars, as the
// TPU kernel reads its scalar-prefetched meta = [offset, true_len]: its
// grid covers the table row's max_pages (ceil(max_pages /
// kPagesPerSplit) splits), every block reads the pair itself, and splits
// past the frontier exit at once, so one launch, and one captured CUDA
// graph, serves every offset and length of a chunk bucket. Everything the
// kernel derives from the pair (the pad-tile exit, the live pages, the
// split count the merge waits for, the row horizons) is computed in the
// block from the values it read, so the device-scalar entry gives the
// host-scalar entry's bits.
//
// Interface: plain C functions bound with ctypes; each launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: head_dim 64 or 128, group 1, 2,
// 4 or 8, page 16, 32 or 64 -- the shapes chip_smoke.py checks). The
// workspace holds hkv * (grid splits) partials of C * group * (hd + 2)
// fp32, the grid's splits being ceil(ceil((offset + true_len) / page) /
// kPagesPerSplit) for the host-scalar entry and ceil(max_pages /
// kPagesPerSplit) for the device-scalar one; counters is hkv * C * group
// / 16 int32, zero before the launch and zero after it, so launches that
// share it must be ordered (one stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "paged.cuh"

namespace {

using namespace paged;
using hopper::split_bf16;

constexpr int kPagesPerSplit = 16;
constexpr int kWarps = 4;  // M-tiles of 16 rows a block
constexpr int kRows = 16 * kWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Four 8 x 8 bf16 matrices from shared memory, lane i giving the address
// of row i % 8 of matrix i / 8: with .trans each thread gets the column
// pairs an mma.sync B fragment takes from row-major rows.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Four int8 values (a 32-bit word, lowest byte first) as two pairs of
// packed bf16, exactly, without the conversion unit (I2F and F2F run at a
// quarter of the integer rate): each value, sign-extended, is added to
// the bits of 2^23 + 128, whose float minus 2^23 + 128 is the value, and
// a float of at most 8 significant bits has its bf16 in its high half.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  constexpr uint32_t kBits = 0x4B000080u;  // 2^23 + 128
  constexpr float kBias = 8388736.f;
  uint32_t f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __float_as_uint(
        __uint_as_float(kBits + (int)(int8_t)(w >> (8 * e))) - kBias);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

template <int HD, int PAGE, typename T>
struct Layout {
  static constexpr int kRow = HD * (int)sizeof(T) + 16;  // staged row bytes
  static constexpr bool kInt8 = sizeof(T) == 1;
  // One stage: K page, V page, then (int8) the K and V row scales.
  static constexpr int stage = 2 * PAGE * kRow + (kInt8 ? 2 * PAGE * 4 : 0);
  // The bf16 rows the products read (padded): the stage's own, or (int8)
  // the stage's converted once into a buffer after the ring.
  static constexpr int kBfRow = HD + 8;
  static constexpr int conv = kInt8 ? 2 * PAGE * kBfRow * 2 : 0;
  static constexpr size_t total =
      (size_t)kStages * stage + conv + 16;  // + a flag
};

// q/out: [C, hkv, group, HD]; pages [hkv, n_pages, PAGE, HD].
template <int HD, int PAGE, typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ table_row,
                     const int* __restrict__ offset_dev,
                     const int* __restrict__ true_len_dev,
                     float* __restrict__ out, float* __restrict__ ws,
                     int* __restrict__ counters, int chunk, int hkv,
                     int group, int n_pages, int offset, int true_len,
                     float sm_scale) {
  using Lay = Layout<HD, PAGE, T>;
  if (offset_dev != nullptr) {  // the device-scalar entry
    offset = *offset_dev;
    true_len = *true_len_dev;
  }
  constexpr int SR = Lay::kBfRow;
  constexpr int NT = PAGE / 8;  // n-tiles of 8 keys a page
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_rows = chunk * group;
  const int row0 = tile * kRows;
  const int tile_rows = min(kRows, n_rows - row0);
  const int total = offset + true_len;  // the slot's frontier
  // Row r of q and out: query r / group, head r % group.
  auto at = [&](int r) {
    const int i = r / group;
    return (((size_t)i * hkv + h) * group + (r - i * group)) * HD;
  };

  if (row0 / group >= true_len) {  // every row is pad
    if (split == 0)
      for (int idx = tid; idx < tile_rows * HD; idx += kThreads)
        out[at(row0 + idx / HD) + idx % HD] = 0.f;
    return;
  }
  // Pages any row of this tile can see, and this block's split of them.
  const int n_live =
      min((total + PAGE - 1) / PAGE,
          (offset + (row0 + tile_rows - 1) / group) / PAGE + 1);
  const int n_splits = (n_live + kPagesPerSplit - 1) / kPagesPerSplit;
  if (split >= n_splits) return;
  const int p0 = split * kPagesPerSplit;
  const int n = min(kPagesPerSplit, n_live - p0);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* conv = smem + kStages * Lay::stage;
  int* flag = reinterpret_cast<int*>(conv + Lay::conv);

  // Stage page p0 + i: K rows, V rows (and their scales); rows past the
  // frontier as zeros.
  auto load_page = [&](int i) {
    unsigned char* st = smem + (i % kStages) * Lay::stage;
    const int p = p0 + i;
    const size_t first = ((size_t)h * n_pages + table_row[p]) * PAGE;
    const unsigned char* k_src =
        reinterpret_cast<const unsigned char*>(k_pages + first * HD);
    const unsigned char* v_src =
        reinterpret_cast<const unsigned char*>(v_pages + first * HD);
    const int live_rows = total - p * PAGE;
    constexpr int kVecs = HD * (int)sizeof(T) / 16;  // per row
    for (int c = tid; c < PAGE * kVecs; c += kThreads) {
      const int row = c / kVecs;
      const int off = (c - row * kVecs) * 16;
      unsigned char* kd = st + row * Lay::kRow + off;
      unsigned char* vd = st + (PAGE + row) * Lay::kRow + off;
      if (row < live_rows) {
        cp_async16(kd, k_src + (size_t)c * 16);
        cp_async16(vd, v_src + (size_t)c * 16);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
    if constexpr (Lay::kInt8) {
      unsigned char* sc = st + 2 * PAGE * Lay::kRow;
      for (int c = tid; c < PAGE / 4; c += kThreads) {
        cp_async16(sc + c * 16, k_scales + first + 4 * c);
        cp_async16(sc + PAGE * 4 + c * 16, v_scales + first + 4 * c);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load_page(i);
    cp_async_commit();
  }

  // This warp's M-tile: rows ra (fragment entries 0, 1) and rb = ra + 8
  // (entries 2, 3). A row sees positions below its horizon.
  const int wrow0 = row0 + 16 * warp;
  const bool active = wrow0 < n_rows;
  const int ra = wrow0 + g;
  const int rb = ra + 8;
  const int hz_a = min(offset + ra / group + 1, total);
  const int hz_b = min(offset + rb / group + 1, total);
  // Every row of the M-tile sees every key below this.
  const int hz_all = min(offset + wrow0 / group + 1, total);
  const float scale_log2 = sm_scale * kLog2e;
  const int w_live = min(n_live, (offset + (wrow0 + 15) / group) / PAGE + 1);
  uint32_t qf[HD / 16][4];
  if (active) {
    const __nv_bfloat16* qa = q + at(ra) + 2 * t;
    const __nv_bfloat16* qb = q + at(rb) + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qf[kk][0] = row_pair(qa + kk * 16);
      qf[kk][1] = row_pair(qb + kk * 16);
      qf[kk][2] = row_pair(qa + kk * 16 + 8);
      qf[kk][3] = row_pair(qb + kk * 16 + 8);
    }
  }
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    // Page i has landed and every warp is done with page i - 1, whose
    // stage takes page i + kStages - 1.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n) load_page(i + kStages - 1);
    cp_async_commit();
    const int pos0 = (p0 + i) * PAGE;  // in the slot
    const unsigned char* st = smem + (i % kStages) * Lay::stage;
    if constexpr (Lay::kInt8) {
      // The stage's int8 K and V rows as bf16 rows (exact).
      constexpr int kVecs = HD / 16;  // 16-byte loads a row
      for (int c = tid; c < 2 * PAGE * kVecs; c += kThreads) {
        const int row = c / kVecs;
        const int col = (c - row * kVecs) * 16;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(st + row * Lay::kRow + col);
        uint32_t o[8];
        int8x4_to_bf16(raw.x, o[0], o[1]);
        int8x4_to_bf16(raw.y, o[2], o[3]);
        int8x4_to_bf16(raw.z, o[4], o[5]);
        int8x4_to_bf16(raw.w, o[6], o[7]);
        uint4* d = reinterpret_cast<uint4*>(conv + row * SR * 2 + col * 2);
        d[0] = make_uint4(o[0], o[1], o[2], o[3]);
        d[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncthreads();
    }
    if (active && p0 + i < w_live) {
      const __nv_bfloat16* k_s = reinterpret_cast<const __nv_bfloat16*>(
          Lay::kInt8 ? conv : st);
      const __nv_bfloat16* v_s = k_s + PAGE * SR;
      const float* ks_s =
          reinterpret_cast<const float*>(st + 2 * PAGE * Lay::kRow);
      const float* vs_s = ks_s + PAGE;
      // S = q k^T over the page.
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          // Keys nt * 8.. (two n-tiles) x this k step's 16 columns.
          uint32_t b[4];
          ldsm_x4(b, k_s + ((nt + (lane >> 4)) * 8 + (lane & 7)) * SR +
                         kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[nt], qf[kk], b[0], b[1]);
          mma_bf16(s[nt + 1], qf[kk], b[2], b[3]);
        }
      // Scale in fp32 (int8: the K row scale, then sm_scale, into the
      // log2 domain), mask.
      const bool open = pos0 + PAGE <= hz_all;
      auto live = [&](int nt, int e) {
        return open ||
               pos0 + nt * 8 + 2 * t + (e & 1) < (e < 2 ? hz_a : hz_b);
      };
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[nt][e];
          if constexpr (Lay::kInt8) v *= ks_s[nt * 8 + 2 * t + (e & 1)];
          v = live(nt, e) ? v * scale_log2 : kNegInf;
          s[nt][e] = v;
          if (e < 2)
            mx_a = fmaxf(mx_a, v);
          else
            mx_b = fmaxf(mx_b, v);
        }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = live(nt, e);
          const float p = ok ? exp2f(s[nt][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
          if (e < 2)
            sum_a += p;
          else
            sum_b += p;
          // P @ V's operand: int8 folds the V row scale into P.
          if constexpr (Lay::kInt8)
            s[nt][e] = ok ? p * vs_s[nt * 8 + 2 * t + (e & 1)] : 0.f;
          else
            s[nt][e] = p;
        }
      const float alpha_a = exp2f(m_a - mn_a);
      const float alpha_b = exp2f(m_b - mn_b);
      l_a = fmaf(l_a, alpha_a, quad_sum(sum_a));
      l_b = fmaf(l_b, alpha_b, quad_sum(sum_b));
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        acc[dn][0] *= alpha_a;
        acc[dn][1] *= alpha_a;
        acc[dn][2] *= alpha_b;
        acc[dn][3] *= alpha_b;
      }
      // P @ V, one k step of 16 keys at a time: the S fragments of two
      // n-tiles as the A fragment, hi and lo.
#pragma unroll
      for (int j = 0; j < PAGE / 16; ++j) {
        uint32_t hi[4], lo[4];
        split_bf16(s[2 * j][0], s[2 * j][1], hi[0], lo[0]);
        split_bf16(s[2 * j][2], s[2 * j][3], hi[1], lo[1]);
        split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dn = 0; dn < HD / 8; dn += 2) {
          // Keys 16 j.. x columns dn * 8.. (two n-tiles), transposed.
          uint32_t b[4];
          ldsm_x4_trans(b, v_s + (16 * j + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * SR +
                               (dn + (lane >> 4)) * 8);
          mma_bf16(acc[dn], hi, b[0], b[1]);
          mma_bf16(acc[dn], lo, b[0], b[1]);
          mma_bf16(acc[dn + 1], hi, b[2], b[3]);
          mma_bf16(acc[dn + 1], lo, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (n_splits == 1) {
    if (active) {
      const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        const int d = dn * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + at(ra) + d) =
            make_float2(acc[dn][0] / la, acc[dn][1] / la);
        *reinterpret_cast<float2*>(out + at(rb) + d) =
            make_float2(acc[dn][2] / lb, acc[dn][3] / lb);
      }
    }
    return;
  }

  // This split's partial: [m: n_rows][l: n_rows][acc: n_rows x HD] per
  // (KV head, split), rows by their index in the chunk.
  const size_t split_part = (size_t)n_rows * (HD + 2);
  float* parts = ws + (size_t)h * gridDim.z * split_part;
  if (active) {
    float* dst = parts + split * split_part;
    if (t == 0) {
      dst[ra] = m_a;
      dst[rb] = m_b;
      dst[n_rows + ra] = l_a;
      dst[n_rows + rb] = l_b;
    }
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      float* o = dst + 2 * n_rows + dn * 8 + 2 * t;
      *reinterpret_cast<float2*>(o + (size_t)ra * HD) =
          make_float2(acc[dn][0], acc[dn][1]);
      *reinterpret_cast<float2*>(o + (size_t)rb * HD) =
          make_float2(acc[dn][2], acc[dn][3]);
    }
  }

  // The last of the tile's splits to finish merges them all in order.
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)h * gridDim.x + tile;
  if (tid == 0) *flag = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // Each row's max and weighted sum over the splits once (in the ring's
  // place), then its columns four at a time; the order and arithmetic
  // of the decode kernel's merge. Partials are read from L2 (__ldcg):
  // other blocks wrote them.
  float* row_m = reinterpret_cast<float*>(smem);
  float* row_l = row_m + kRows;
  if (tid < tile_rows) {
    const float* m = parts + row0 + tid;
    float M = kNegInf, L = 0.f;
    for (int i = 0; i < n_splits; ++i) M = fmaxf(M, __ldcg(m + i * split_part));
    for (int i = 0; i < n_splits; ++i)
      L = fmaf(__ldcg(m + i * split_part + n_rows),
               exp2f(__ldcg(m + i * split_part) - M), L);
    row_m[tid] = M;
    row_l[tid] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int idx = tid; idx < tile_rows * HD / 4; idx += kThreads) {
    const int rr = idx / (HD / 4);
    const int d = (idx - rr * (HD / 4)) * 4;
    const int r = row0 + rr;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < n_splits; ++i) {
      const float* p = parts + i * split_part;
      const float w = exp2f(__ldcg(p + r) - row_m[rr]);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          p + 2 * n_rows + (size_t)r * HD + d));
      A = make_float4(fmaf(a.x, w, A.x), fmaf(a.y, w, A.y), fmaf(a.z, w, A.z),
                      fmaf(a.w, w, A.w));
    }
    const float L = row_l[rr];
    *reinterpret_cast<float4*>(out + at(r) + d) =
        make_float4(A.x / L, A.y / L, A.z / L, A.w / L);
  }
  if (tid == 0) *counter = 0;
}

// grid_pages: the pages the grid's splits cover (the live pages for the
// host-scalar entry, the table row's max_pages for the device-scalar
// one, whose offset_dev / true_len_dev are then non-null).
template <int HD, int PAGE, typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* table_row,
           const void* offset_dev, const void* true_len_dev, void* out,
           void* ws, void* counters, int chunk, int hkv, int group,
           int n_pages, int offset, int true_len, int grid_pages,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = Layout<HD, PAGE, T>::total;
  auto kernel = paged_prefill_kernel<HD, PAGE, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((chunk * group + kRows - 1) / kRows, hkv,
            (grid_pages + kPagesPerSplit - 1) / kPagesPerSplit);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(table_row),
      static_cast<const int*>(offset_dev),
      static_cast<const int*>(true_len_dev), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), chunk, hkv, group,
      n_pages, offset, true_len, sm_scale);
  return (int)cudaGetLastError();
}

// max_pages > 0 selects the device-scalar entry (offset and true_len
// then come from offset_dev / true_len_dev and are not checked here).
template <typename T>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales,
             const void* table_row, const void* offset_dev,
             const void* true_len_dev, void* out, void* ws, void* counters,
             int chunk, int hkv, int group, int head_dim, int n_pages,
             int page, int offset, int true_len, int max_pages,
             float sm_scale, void* stream) {
  const bool dev = max_pages > 0;
  if (chunk < 1 || hkv < 1 || hkv > 65535 || (chunk * group) % 16 ||
      (group != 1 && group != 2 && group != 4 && group != 8))
    return -1;
  if (dev ? (offset_dev == nullptr || true_len_dev == nullptr)
          : (true_len < 1 || true_len > chunk || offset < 0))
    return -1;
  const int grid_pages =
      dev ? max_pages : (offset + true_len + page - 1) / page;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PREFILL_LAUNCH(HD, PAGE)                                            \
  launch<HD, PAGE, T>(q, k_pages, v_pages, k_scales, v_scales, table_row,   \
                      offset_dev, true_len_dev, out, ws, counters, chunk,   \
                      hkv, group, n_pages, offset, true_len, grid_pages,    \
                      sm_scale, s)
  if (head_dim != 64 && head_dim != 128) return -1;
  switch (page) {
    case 16:
      return head_dim == 64 ? PREFILL_LAUNCH(64, 16) : PREFILL_LAUNCH(128, 16);
    case 32:
      return head_dim == 64 ? PREFILL_LAUNCH(64, 32) : PREFILL_LAUNCH(128, 32);
    case 64:
      return head_dim == 64 ? PREFILL_LAUNCH(64, 64) : PREFILL_LAUNCH(128, 64);
    default:
      return -1;
  }
#undef PREFILL_LAUNCH
}

}  // namespace

extern "C" int paged_prefill_pages_per_split() { return kPagesPerSplit; }

extern "C" int paged_prefill_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table_row, void* out, void* ws, void* counters, int chunk,
    int hkv, int group, int head_dim, int n_pages, int page, int offset,
    int true_len, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                 table_row, nullptr, nullptr, out, ws,
                                 counters, chunk, hkv, group, head_dim,
                                 n_pages, page, offset, true_len, 0,
                                 sm_scale, stream);
}

extern "C" int paged_prefill_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* table_row,
    void* out, void* ws, void* counters, int chunk, int hkv, int group,
    int head_dim, int n_pages, int page, int offset, int true_len,
    float sm_scale, void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, table_row,
                          nullptr, nullptr, out, ws, counters, chunk, hkv,
                          group, head_dim, n_pages, page, offset, true_len, 0,
                          sm_scale, stream);
}

// The device-scalar entries: offset and true_len read on the device from
// offset_dev and true_len_dev (int32 scalars), the grid sized for
// max_pages (the table row's length).
extern "C" int paged_prefill_attention_dev_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* table_row, const void* offset_dev, const void* true_len_dev,
    void* out, void* ws, void* counters, int chunk, int hkv, int group,
    int head_dim, int n_pages, int page, int max_pages, float sm_scale,
    void* stream) {
  if (max_pages < 1) return -1;
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr,
                                 table_row, offset_dev, true_len_dev, out, ws,
                                 counters, chunk, hkv, group, head_dim,
                                 n_pages, page, 0, 0, max_pages, sm_scale,
                                 stream);
}

extern "C" int paged_prefill_attention_dev_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* table_row,
    const void* offset_dev, const void* true_len_dev, void* out, void* ws,
    void* counters, int chunk, int hkv, int group, int head_dim, int n_pages,
    int page, int max_pages, float sm_scale, void* stream) {
  if (max_pages < 1) return -1;
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, table_row,
                          offset_dev, true_len_dev, out, ws, counters, chunk,
                          hkv, group, head_dim, n_pages, page, 0, 0,
                          max_pages, sm_scale, stream);
}
