// Pieces shared by the paged attention kernels (paged_decode.cu,
// paged_prefill.cu): 16-byte cp.async copies into shared memory,
// mma.sync m16n8k16 bf16 products, bf16 fragments read from staged bf16
// or int8 rows (int8 values are exact in bf16), and quad reductions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace paged {

using hopper::pack_bf16;
using hopper::smem_u32;

constexpr float kNegInf = -1e30f;

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

}  // namespace paged
