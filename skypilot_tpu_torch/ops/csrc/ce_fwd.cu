// Fused cross-entropy forward for Hopper (sm_90a): per-token NLL of
// softmax(x @ w) at the targets, without ever writing the [T, V] logits.
//
// Replaces: skypilot_tpu/ops/cross_entropy.py, _ce_fwd_kernel (entry
// _fused_fwd).
//
// What bounds it on the H100: arithmetic. The logits product takes
// 2 * T * d * V FLOPs (1.24e12 at T 12288, d 1536, V 32768) against the
// 138 MB of x and w it must read: about 1.25 ms at 989 TFLOP/s (bf16
// tensor cores), thirty times the time the bytes take.
//
// What the design does about it: the TPU kernel carries the running max,
// sum and target logit across the vocab axis of a sequential grid in
// VMEM scratch. Blocks on Hopper run in no order and carry nothing, so
// here one block owns a 64-row tile of T and loops over every 128-column
// vocab tile itself, keeping the running max (from -1e30), sum and
// target logit of its rows in registers. The tile product x_tile @
// w_tile is this kernel's own and runs on the tensor cores: eight warps
// (2 x 4) each own a 32 x 32 piece of the [64, 128] logits tile and
// issue mma.sync m16n8k16 (bf16 in, fp32 accumulate: the products of
// bf16 values are exact and summed in fp32, as the reference's
// preferred_element_type=float32 product is), fed by ldmatrix from
// 64-deep bf16 slices of x and w in shared memory (rows padded so the
// ldmatrix rows fall on distinct banks; w's slice is read transposed by
// ldmatrix.trans). The next slice's device-memory loads are issued into
// registers before the current slice is multiplied, so their latency
// hides behind the tensor-core work. A finished logits tile goes
// through shared memory once, where four lanes per row fold it into the
// row's running statistics and pick the target's logit; it is never
// written to device memory. A target outside every tile (negative, or
// >= V) picks nothing and its NLL is the logsumexp, as in the reference.
// A vocabulary that is not a multiple of 128 masks its last tile's
// columns; rows past T are computed and dropped. Known limits of this
// version: 192 blocks at T 12288 fill 132 SMs unevenly, the loads are
// plain 16-byte loads rather than TMA, and wgmma would double the
// tensor-core rate; splitting V across blocks with a merge pass is later
// work.
//
// Interface: a plain C function bound with ctypes; it launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a shape this build does not take: d a positive multiple of 64, V a
// positive multiple of 8). Layouts: x [T, d] and w [d, V] bf16, targets
// [T] int32, nll [T] and lse [T, 1] fp32, all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 64;        // rows of T per block
constexpr int kBV = 128;       // vocab columns per tile
constexpr int kBD = 64;        // depth of one staged slice of d
constexpr int XS = kBD + 8;    // bf16 row stride of the x slice
constexpr int WS = kBV + 8;    // bf16 row stride of the w slice
constexpr int SS = kBV + 8;    // fp32 row stride of the logits tile
constexpr float kNegInf = -1e30f;

constexpr size_t kXBytes = (size_t)kBT * XS * 2;
constexpr size_t kWBytes = (size_t)kBD * WS * 2;
constexpr size_t kSBytes = (size_t)kBT * SS * 4;
constexpr size_t kSmem = kXBytes + kWBytes + kSBytes;

struct Slice {  // one thread's share of a slice of x and w, in flight
  uint4 x[2];
  uint4 w[4];
};

__device__ __forceinline__ void load_slice(Slice& s,
                                           const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ w,
                                           int T, int d, int V, int row0,
                                           int v0, int d0, int tid) {
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    const int i = tid + kThreads * rep;
    const int row = row0 + (i >> 3);
    s.x[rep] = row < T ? *reinterpret_cast<const uint4*>(
                             x + (size_t)row * d + d0 + (i & 7) * 8)
                       : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int rep = 0; rep < 4; ++rep) {
    const int i = tid + kThreads * rep;
    const int col = v0 + (i & 15) * 8;
    s.w[rep] = col < V ? *reinterpret_cast<const uint4*>(
                             w + (size_t)(d0 + (i >> 4)) * V + col)
                       : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_slice(const Slice& s,
                                            __nv_bfloat16* xs,
                                            __nv_bfloat16* ws, int tid) {
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    const int i = tid + kThreads * rep;
    *reinterpret_cast<uint4*>(xs + (i >> 3) * XS + (i & 7) * 8) = s.x[rep];
  }
#pragma unroll
  for (int rep = 0; rep < 4; ++rep) {
    const int i = tid + kThreads * rep;
    *reinterpret_cast<uint4*>(ws + (i >> 4) * WS + (i & 15) * 8) = s.w[rep];
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              const int* __restrict__ targets, float* __restrict__ nll,
              float* __restrict__ lse_out, int T, int d, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + kXBytes);
  float* s_tile = reinterpret_cast<float*>(smem + kXBytes + kWBytes);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBT;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp >> 2) * 32;  // the warp's rows of the tile
  const int wn = (warp & 3) * 32;   // the warp's columns of the tile
  // ldmatrix row/column offsets of this lane within a 16 x 16 piece.
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lc = 8 * (lane >> 4);

  // Row statistics: four neighbouring lanes per row.
  const int sr = tid >> 2;
  const int sub = tid & 3;
  const int tgt = row0 + sr < T ? targets[row0 + sr] : -1;
  float m = kNegInf, l = 0.f, tl = 0.f;

  const int n_d = d / kBD;
  const int n_v = (V + kBV - 1) / kBV;
  const int n_slices = n_d * n_v;
  float acc[2][4][4];
  Slice next;
  load_slice(next, x, w, T, d, V, row0, 0, 0, tid);
  store_slice(next, xs, ws, tid);
  __syncthreads();

  for (int it = 0; it < n_slices; ++it) {
    const int vt = it / n_d;
    const int dt = it - vt * n_d;
    if (dt == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    const bool more = it + 1 < n_slices;
    if (more) {
      const int nv = (it + 1) / n_d;
      load_slice(next, x, w, T, d, V, row0, nv * kBV, (it + 1 - nv * n_d) * kBD,
                 tid);
    }
#pragma unroll
    for (int kk = 0; kk < kBD; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], xs + (wm + 16 * mi + lr) * XS + kk + lc);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(b[nj], ws + (kk + lr) * WS + wn + 16 * nj + lc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)],
                   b[ni >> 1][2 * (ni & 1) + 1]);
    }
    __syncthreads();  // every warp is done with this slice
    if (more) store_slice(next, xs, ws, tid);

    if (dt == n_d - 1) {
      // The finished [64, 128] logits tile, through shared memory.
      const int g = lane >> 2;
      const int t2 = 2 * (lane & 3);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float* p = s_tile + (wm + 16 * mi + g) * SS + wn + 8 * ni + t2;
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<float2*>(p + 8 * SS) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
        }
      __syncthreads();
      const int v0 = vt * kBV;
      const int n_valid = min(kBV, V - v0);
      const float* srow = s_tile + sr * SS;
      float mx = kNegInf;
      for (int j = sub; j < n_valid; j += 4) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      float sum = 0.f;
      for (int j = sub; j < n_valid; j += 4) sum += expf(srow[j] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l = l * expf(m - m_new) + sum;
      m = m_new;
      const int tj = tgt - v0;
      if (tj >= 0 && tj < n_valid && (tj & 3) == sub) tl += srow[tj];
    }
    __syncthreads();  // the next slice (and the tile's readers) are done
  }

  tl += __shfl_xor_sync(0xffffffffu, tl, 1);  // one lane holds the pick
  tl += __shfl_xor_sync(0xffffffffu, tl, 2);
  if (sub == 0 && row0 + sr < T) {
    const float lse = m + logf(fmaxf(l, 1e-30f));
    nll[row0 + sr] = lse - tl;
    lse_out[row0 + sr] = lse;
  }
}

}  // namespace

extern "C" int ce_fwd_bf16(const void* x, const void* w, const void* targets,
                           void* nll, void* lse, int T, int d, int V,
                           void* stream) {
  if (T < 1 || d < kBD || d % kBD || V < 8 || V % 8) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (T + kBT - 1) / kBT;
  ce_fwd_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(targets), static_cast<float*>(nll),
      static_cast<float*>(lse), T, d, V);
  return (int)cudaGetLastError();
}
