// AdamW's update of one leaf in one pass, for Hopper (sm_90a): optax's
// clip_by_global_norm then adamw, as trainer.AdamW.update computes it,
// with the same bits as PyTorch's eager chain of that update
// (ops/adamw.py's adamw_update_reference) on the card.
//
// Replaces no Pallas kernel: the reference's update is optax under XLA,
// which fuses the chain itself. Eagerly the chain is some 21 elementwise
// kernels a leaf, each reading and writing whole leaves: about 94 bytes
// an element in bf16.
//
// What bounds it on the H100: bytes. It reads g, mu, nu and p once and
// writes mu, nu and p once, in place: 14 bytes an element in bf16 (28 in
// fp32). At 3.35 TB/s the 3.76e9 elements of a 16-layer Mistral-7B stage
// take 15.7 ms, the largest leaf (w_gate [16, 4096, 14336]) 3.9 ms. Its
// arithmetic comes close to that bound too: keeping the chain's bits
// takes some 18 roundings to bf16 an element, and a conversion runs at
// a quarter of the fp32 rate or less.
//
// The design. Memory: each thread loads 16 bytes an array at a time (8
// bf16 or 4 fp32 values; an fp32 first moment beside bf16 params takes
// two 16-byte loads, a bf16 one beside fp32 params one 8-byte load), and
// holds two such vectors: the next one's loads are in flight while this
// one's arithmetic runs. Stores are streaming (st.global.cs, evict first:
// every byte is touched once); loads are plain, which measured faster
// than ld.global.cs. The grid is as many blocks as fit on the SMs at
// once, striding over the leaf; a scalar loop takes the elements past the
// last whole vector, or the whole leaf when a pointer is not 16-byte
// aligned. Arithmetic: two elements at a time, so that one
// cvt.rn.bf16x2.f32 rounds both.
//
// The same bits as the chain: every intermediate is computed in fp32 and
// rounded to the dtype the eager op produces (bf16 ops compute in fp32
// and round once on store), in the eager order, with the IEEE-rounded
// intrinsics (__fmul_rn and the rest) so that nvcc contracts nothing into
// an FMA. Types: g and nu take the params' dtype P; mu takes M; mu_new,
// mu_hat and the update u take the promotion of P and M. Scalars from
// Python floats enter as fp32. A division by a CPU scalar tensor (bc1,
// bc2) is a multiply by its fp32 reciprocal, as PyTorch's CUDA division
// computes it; the step size multiplies as it is; the clip divides by
// g_norm truly, read through a device pointer (no copy, no sync).
//
// Interface: a plain C function bound with ctypes; it launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or -1
// for a dtype code this build does not take: 0 fp32, 1 bf16). g, mu, nu
// and p hold n contiguous elements; g_norm is one element of dtype P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

// A value already held at T's precision, as a T: no rounding, so a bf16
// takes the fp32 value's top half.
template <typename T> __device__ __forceinline__ T exact(float x);
template <> __device__ __forceinline__ float exact<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 exact<bf16>(float x) {
  return __ushort_as_bfloat16((unsigned short)(__float_as_uint(x) >> 16));
}

// Two elements at a time: the kernel's arithmetic is bound by rounding
// to bf16, and one cvt.rn.bf16x2.f32 rounds two values.
struct F2 {
  float x, y;
};

// Both values rounded to T, as fp32 values: what an eager op of dtype T
// stores (round to nearest even, the instruction PyTorch's bf16 uses).
template <typename T> __device__ __forceinline__ F2 rnd(F2 a);
template <> __device__ __forceinline__ F2 rnd<float>(F2 a) { return a; }
template <> __device__ __forceinline__ F2 rnd<bf16>(F2 a) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a.x, a.y);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  return {__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u)};
}

// IEEE-rounded fp32 ops (never contracted into an FMA), on both values.
__device__ __forceinline__ F2 mul(float s, F2 a) {
  return {__fmul_rn(s, a.x), __fmul_rn(s, a.y)};
}
__device__ __forceinline__ F2 mul(F2 a, F2 b) {
  return {__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)};
}
__device__ __forceinline__ F2 add(F2 a, F2 b) {
  return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y)};
}
__device__ __forceinline__ F2 add(F2 a, float s) {
  return {__fadd_rn(a.x, s), __fadd_rn(a.y, s)};
}

// Quotients and square roots, correctly rounded in fp32 as PyTorch's
// CUDA division and torch.sqrt compute them, then rounded to the
// chain's dtype by the caller.
__device__ __forceinline__ F2 quotient(F2 a, F2 b) {
  return {__fdiv_rn(a.x, b.x), __fdiv_rn(a.y, b.y)};
}

__device__ __forceinline__ F2 quotient(F2 a, float b) {
  return {__fdiv_rn(a.x, b), __fdiv_rn(a.y, b)};
}

__device__ __forceinline__ F2 root(F2 a) {
  return {__fsqrt_rn(a.x), __fsqrt_rn(a.y)};
}

// PyTorch's result dtype of an op between a T and a U tensor.
template <typename T, typename U> struct Promote { using type = float; };
template <> struct Promote<bf16, bf16> { using type = bf16; };

struct Scalars {
  int clip;
  float grad_clip, one_minus_b1, b1, one_minus_b2, b2;
  float inv_bc1, inv_bc2, eps, weight_decay, step_size;
};

// Two elements: the chain of trainer.AdamW.update's loop, op by op; mu
// comes back at mu_new's precision (U), nu at P's, p at U's.
template <typename P, typename M>
__device__ __forceinline__ void update(F2 g, F2& mu, F2& nu, F2& p,
                                       float g_norm, const Scalars& s) {
  using U = typename Promote<P, M>::type;
  if (s.clip) {
    // g = (g / g_norm.to(g.dtype)) * grad_clip; times 1 changes nothing.
    g = rnd<P>(quotient(g, g_norm));
    if (s.grad_clip != 1.0f) g = rnd<P>(mul(s.grad_clip, g));
  }
  // mu_new = (1 - b1) * g + b1 * mu
  const F2 mu_new = rnd<U>(add(rnd<P>(mul(s.one_minus_b1, g)),
                               rnd<M>(mul(s.b1, mu))));
  // nu.copy_((1 - b2) * g ** 2 + b2 * nu)
  nu = rnd<P>(add(rnd<P>(mul(s.one_minus_b2, rnd<P>(mul(g, g)))),
                  rnd<P>(mul(s.b2, nu))));
  // mu_hat = mu_new / bc1.to(mu_new.dtype); nu_hat = nu / bc2.to(nu.dtype)
  const F2 mu_hat = rnd<U>(mul(s.inv_bc1, mu_new));
  const F2 nu_hat = rnd<P>(mul(s.inv_bc2, nu));
  // u = mu_hat / (torch.sqrt(nu_hat) + eps)
  const F2 den = rnd<P>(add(rnd<P>(root(nu_hat)), s.eps));
  F2 u = rnd<U>(quotient(mu_hat, den));
  // u = u + weight_decay * p
  u = rnd<U>(add(u, rnd<P>(mul(s.weight_decay, p))));
  // u = step_size.to(u.dtype) * u
  u = rnd<U>(mul(s.step_size, u));
  // mu.copy_(mu_new); p.copy_(p + u)
  mu = mu_new;
  p = rnd<U>(add(p, u));
}

// A value at U's precision stored as T: exact where T is U, else rounded
// (mu.copy_ and p.copy_ of an fp32 mu_new or update into bf16).
template <typename T, typename U>
__device__ __forceinline__ F2 to_store(F2 a) {
  if constexpr (std::is_same<T, U>::value) {
    return a;
  } else {
    return rnd<T>(a);
  }
}

// N values of T in registers, loaded or stored as 8- or 16-byte pieces.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

// Loads are plain ld.global and stores st.global.cs (evict first), in
// inline PTX so that they stay where they are written. On the H100 the
// streaming hint on the loads cost about 1% of the bandwidth (w_gate:
// 84.3% of 3.35 TB/s with ld.global.cs, 85.5% with ld.global).
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 r;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ uint2 ld8(const void* p) {
  uint2 r;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void st16(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st8(void* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(v.x),
               "r"(v.y)
               : "memory");
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* ptr) {
  Pack<T, N> out;
  constexpr int kBytes = sizeof(T) * N;
  if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(&out) = ld8(ptr);
  } else {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k)
      reinterpret_cast<uint4*>(&out)[k] =
          ld16(reinterpret_cast<const uint4*>(ptr) + k);
  }
  return out;
}

template <typename T, int N>
__device__ __forceinline__ void store(T* ptr, const Pack<T, N>& in) {
  constexpr int kBytes = sizeof(T) * N;
  if constexpr (kBytes == 8) {
    st8(ptr, *reinterpret_cast<const uint2*>(&in));
  } else {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k)
      st16(reinterpret_cast<uint4*>(ptr) + k,
           reinterpret_cast<const uint4*>(&in)[k]);
  }
}

// Elements a vector: 16 bytes of the params' dtype.
template <typename P> constexpr int kVec = 16 / sizeof(P);

// One vector of each array: g, mu, nu and p at the same elements.
template <typename P, typename M> struct Leaf {
  Pack<P, kVec<P>> g, nu, p;
  Pack<M, kVec<P>> mu;
};

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads) adamw_kernel(
    const P* __restrict__ g, M* __restrict__ mu, P* __restrict__ nu,
    P* __restrict__ p, const P* __restrict__ g_norm, long long n,
    long long n_vec, Scalars s) {
  using U = typename Promote<P, M>::type;
  constexpr int V = kVec<P>;
  const float gn = s.clip ? to_f<P>(*g_norm) : 1.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  auto fetch = [&](long long i) {
    Leaf<P, M> x;
    x.g = load<P, V>(g + i * V);
    x.mu = load<M, V>(mu + i * V);
    x.nu = load<P, V>(nu + i * V);
    x.p = load<P, V>(p + i * V);
    return x;
  };
  // Vectors tid, tid + stride, ...: neighbouring threads read neighbouring
  // 16 bytes, and the next vector's loads are in flight while this one's
  // arithmetic runs (two vectors in registers).
  Leaf<P, M> cur, next;
  if (tid < n_vec) cur = fetch(tid);
  for (long long i = tid; i < n_vec; i += stride) {
    if (i + stride < n_vec) next = fetch(i + stride);
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      F2 m{to_f<M>(cur.mu.v[j]), to_f<M>(cur.mu.v[j + 1])};
      F2 v{to_f<P>(cur.nu.v[j]), to_f<P>(cur.nu.v[j + 1])};
      F2 w{to_f<P>(cur.p.v[j]), to_f<P>(cur.p.v[j + 1])};
      update<P, M>({to_f<P>(cur.g.v[j]), to_f<P>(cur.g.v[j + 1])}, m, v, w,
                   gn, s);
      m = to_store<M, U>(m);
      w = to_store<P, U>(w);
      cur.mu.v[j] = exact<M>(m.x);
      cur.mu.v[j + 1] = exact<M>(m.y);
      cur.nu.v[j] = exact<P>(v.x);
      cur.nu.v[j + 1] = exact<P>(v.y);
      cur.p.v[j] = exact<P>(w.x);
      cur.p.v[j + 1] = exact<P>(w.y);
    }
    store<M, V>(mu + i * V, cur.mu);
    store<P, V>(nu + i * V, cur.nu);
    store<P, V>(p + i * V, cur.p);
    cur = next;
  }
  // The elements past the last whole vector (all of them where a
  // pointer is not 16-byte aligned), one a thread, the pair's second
  // value a copy of the first.
  for (long long i = n_vec * V + tid; i < n; i += stride) {
    const float m0 = to_f<M>(mu[i]), v0 = to_f<P>(nu[i]), w0 = to_f<P>(p[i]),
                g0 = to_f<P>(g[i]);
    F2 m{m0, m0}, v{v0, v0}, w{w0, w0};
    update<P, M>({g0, g0}, m, v, w, gn, s);
    mu[i] = exact<M>(to_store<M, U>(m).x);
    nu[i] = exact<P>(v.x);
    p[i] = exact<P>(to_store<P, U>(w).x);
  }
}

template <typename P, typename M>
int launch(const void* g, void* mu, void* nu, void* p, const void* g_norm,
           long long n, const Scalars& s, cudaStream_t stream) {
  auto kernel = adamw_kernel<P, M>;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  constexpr int V = kVec<P>;
  const bool aligned = ((reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(mu) |
                         reinterpret_cast<uintptr_t>(nu) |
                         reinterpret_cast<uintptr_t>(p)) & 15) == 0;
  const long long n_vec = aligned ? n / V : 0;
  // Enough threads for the work, at most what the SMs hold at once.
  const long long units = n_vec ? n_vec : n;
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const P*>(g), static_cast<M*>(mu), static_cast<P*>(nu),
      static_cast<P*>(p), static_cast<const P*>(g_norm), n, n_vec, s);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 fp32, 1 bf16. bc1 and bc2 are the bias corrections
// already cast to mu_new's and nu's dtypes, step_size to the update's.
extern "C" int adamw_update(int p_dtype, int mu_dtype, const void* g,
                            void* mu, void* nu, void* p, const void* g_norm,
                            long long n, int clip, float grad_clip,
                            float one_minus_b1, float b1, float one_minus_b2,
                            float b2, float bc1, float bc2, float eps,
                            float weight_decay, float step_size,
                            void* stream) {
  if (n < 1 || p_dtype < 0 || p_dtype > 1 || mu_dtype < 0 || mu_dtype > 1)
    return -1;
  // PyTorch divides by a CPU scalar as a multiply by its fp32
  // reciprocal, computed on the host in IEEE single precision.
  volatile float one = 1.0f;
  const Scalars s{clip, grad_clip, one_minus_b1, b1, one_minus_b2, b2,
                  one / bc1, one / bc2, eps, weight_decay, step_size};
  auto st = static_cast<cudaStream_t>(stream);
  if (p_dtype == 1 && mu_dtype == 1)
    return launch<bf16, bf16>(g, mu, nu, p, g_norm, n, s, st);
  if (p_dtype == 1)
    return launch<bf16, float>(g, mu, nu, p, g_norm, n, s, st);
  if (mu_dtype == 1)
    return launch<float, bf16>(g, mu, nu, p, g_norm, n, s, st);
  return launch<float, float>(g, mu, nu, p, g_norm, n, s, st);
}
