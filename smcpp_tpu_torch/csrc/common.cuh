// Helpers shared by the window kernels (window_kernels.cu, dsc_kernels.cu,
// viterbi_kernels.cu, boundary_kernels.cu).  Each source is compiled by its
// own nvcc into its own shared library with a plain C interface
// (smcpp_tpu_torch/ops/_cuda.py).
//
// Emission tables: every kernel keeps its emission table in shared memory
// when the table fits one block (SMEM_MAX), and otherwise reads rows from
// global memory through the read-only cache (__ldg).  A table is at most a
// few hundred KB, so it stays resident in the 50 MB L2 either way.  The
// choice is a template flag (SMEM_E) made once per launch on the host, so
// the shared-memory instantiation is the same code as before the global one
// existed.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace smcpp {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RESCALE_EVERY = 8;
constexpr float FLOOR = 1e-35f;
constexpr float TINY = 1.17549435e-38f;  // FLT_MIN == finfo(float32).tiny
constexpr float MP_NEG = -1e30f;         // max-plus "impossible" (window_kernel.py:_mp_neg)
constexpr size_t SMEM_MAX = 232448;      // 227 KB: the most one block can have on sm_90
constexpr int WARPS_PER_BLOCK = 4;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <bool BF16>
struct Carry;
template <>
struct Carry<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T store(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float load(T x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float round(float x) { return round_bf16(x); }
};
template <>
struct Carry<false> {
  using T = float;
  static __device__ __forceinline__ T store(float x) { return x; }
  static __device__ __forceinline__ float load(T x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// Butterfly sum: a + b and b + a are the same IEEE value, so every lane ends
// with the identical total.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmax(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// One entry of an emission table: shared memory (SMEM_E) or global memory
// through the read-only cache.
template <bool SMEM_E>
__device__ __forceinline__ float table(const float* t, int idx) {
  if constexpr (SMEM_E) {
    return t[idx];
  } else {
    return __ldg(t + idx);
  }
}

// Asynchronous copies from global to shared memory (cp.async): 16, 8 or 4
// bytes per lane and instruction, grouped by commit and awaited by group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

inline int padded(int M) { return ((M + 3) / 4) * 4; }

// The emission table's route and the dynamic shared bytes of the library's
// last launch of a kernel with a table: glob 1 where it read the table from
// global memory (k_glob).  Written by launch_e and by the launchers that
// plan their own (K1, K8); read through the entry point SMCPP_LAST_LAUNCH
// defines, once per library.
struct LaunchRecord {
  long long glob, smem;
};
inline LaunchRecord last_launch{0, 0};

inline void record_launch(bool glob, size_t smem) { last_launch = {glob ? 1 : 0, (long long)smem}; }

}  // namespace smcpp

// The library's entry point smcpp_<LIB>_last_launch(out): out[0] = glob,
// out[1] = dynamic shared bytes of the last recorded launch.
#define SMCPP_LAST_LAUNCH(LIB)                                   \
  extern "C" int smcpp_##LIB##_last_launch(long long* out) {     \
    out[0] = smcpp::last_launch.glob;                            \
    out[1] = smcpp::last_launch.smem;                            \
    return 0;                                                    \
  }

// Dispatch a runtime padded width MB onto the template instantiations.
#define SMCPP_CASE(V, ...) \
  case V: {                \
    constexpr int MB_ = V; \
    __VA_ARGS__;           \
  } break;
#define SMCPP_DISPATCH(MBV, ...)         \
  switch (MBV) {                         \
    SMCPP_CASE(4, __VA_ARGS__)           \
    SMCPP_CASE(8, __VA_ARGS__)           \
    SMCPP_CASE(12, __VA_ARGS__)          \
    SMCPP_CASE(16, __VA_ARGS__)          \
    SMCPP_CASE(20, __VA_ARGS__)          \
    SMCPP_CASE(24, __VA_ARGS__)          \
    SMCPP_CASE(28, __VA_ARGS__)          \
    SMCPP_CASE(32, __VA_ARGS__)          \
    default:                             \
      return (int)cudaErrorInvalidValue; \
  }

// Launch one of a kernel's two table instantiations: k_smem (the table in
// `smem` bytes of shared memory) when that fits SMEM_MAX, else k_glob (the
// table in global memory, `smem_g` bytes of shared memory).
template <typename K, typename... Args>
int launch_e(K k_smem, K k_glob, size_t smem, size_t smem_g, dim3 grid,
             dim3 block, cudaStream_t st, Args... args) {
  const bool fits = smem <= smcpp::SMEM_MAX;
  K k = fits ? k_smem : k_glob;
  const size_t bytes = fits ? smem : smem_g;
  int e = smcpp::prepare(k, bytes);
  if (e) return e;
  k<<<grid, block, bytes, st>>>(args...);
  smcpp::record_launch(!fits, bytes);
  return 0;
}
