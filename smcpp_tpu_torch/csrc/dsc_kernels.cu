// The descending sweep of the window E-step and decode, for NVIDIA Hopper
// (sm_90a), bound through a plain C interface (ctypes; see
// smcpp_tpu_torch/ops/_cuda.py).
//
//   K2  dsc_sweep        replaces smcpp_tpu/ops/pallas_sweeps.py:_dsc_kernel
//                        (the descending beta sweep that accumulates xisum
//                        and the per-key posterior masses)
//   K2g dsc_sweep_gamma  replaces the emit_gamma output of
//                        smcpp_tpu/ops/window_kernel.py:stats_pass (:515,
//                        :536-538): K2, plus each window's posterior
//                        gamma = alpha * q / Z * valid, stored per window
//
// Both are one kernel body with a template flag (GAMMA), so the E-step's K2
// keeps its code.  What bounds them: serial depth (L windows per segment)
// and the f64 accumulation of M^2 xisum terms per window; K2g also writes
// the (S, L, M) f32 gamma stream (12.8 GB at 1e8 windows and M = 32), one
// contiguous M-vector per window (one 128-byte store per warp at M = 32).
//
// Design: one warp per block, walking segments blockIdx, blockIdx + G, ...
// Lane j owns q[j], u[j], row j of T and row j of the f64 xisum accumulator
// in registers, gets u by warp shuffle, and adds its column of the per-key
// masses into the block's f64 gsum table, where lane j only ever touches
// column j (no atomics).  The gsum table is in shared memory when it and the
// emission table fit a block (12 B x n_keys x M <= 227 KB); otherwise it is
// this block's own slice of gsum_part in global memory and the emission
// table is read through the read-only cache (common.cuh).  Each block writes
// its partials; the caller reduces them with one torch.sum in f64, so the
// summation order is fixed and results are deterministic.

#include "common.cuh"

using namespace smcpp;

namespace {

template <int MB, bool BF16, bool GAMMA, bool SMEM_E>
__global__ void __launch_bounds__(32) dsc_sweep_kernel(
    const float* __restrict__ T, const float* __restrict__ E,
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    const typename Carry<BF16>::T* __restrict__ alphas,
    const float* __restrict__ Q_end, int S, int L, int M, int n_keys,
    float* __restrict__ u_start, double* __restrict__ xo_part,
    double* __restrict__ gsum_part, float* __restrict__ gam) {
  using C = Carry<BF16>;
  const int lane = threadIdx.x;
  double* gp = gsum_part + (size_t)blockIdx.x * n_keys * M;  // this block's slice
  double* G = gp;       // (n_keys, M) f64 per-key masses
  const float* tE = E;  // (n_keys, M)
  if constexpr (SMEM_E) {
    extern __shared__ double dsmem[];
    double* sG = dsmem;
    float* sE = reinterpret_cast<float*>(sG + n_keys * M);
    for (int idx = lane; idx < n_keys * M; idx += 32) {
      sG[idx] = 0.0;
      sE[idx] = E[idx];
    }
    G = sG;
    tE = sE;
  } else {
    for (int idx = lane; idx < n_keys * M; idx += 32) gp[idx] = 0.0;
  }
  __syncwarp();

  const bool live = lane < M;
  float Trow[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) Trow[i] = (live && i < M) ? T[lane * M + i] : 0.f;
  double xo[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) xo[i] = 0.0;

  for (int s = blockIdx.x; s < S; s += gridDim.x) {
    float q = live ? Q_end[(size_t)s * M + lane] : 0.f;
    float u = 0.f;
    const int32_t* kr = keys + (size_t)s * L;
    const uint8_t* vr = valid + (size_t)s * L;
    const typename C::T* al = alphas + (size_t)s * L * M;
    float* gr = GAMMA ? gam + (size_t)s * L * M : nullptr;
    for (int l0 = ((L - 1) / 32) * 32; l0 >= 0; l0 -= 32) {
      const int nstep = min(32, L - l0);
      int my_key = 0, my_v = 0, my_vn = 0;
      if (lane < nstep) {
        my_key = kr[l0 + lane];
        my_v = vr[l0 + lane];
        if (l0 + lane + 1 < L) my_vn = vr[l0 + lane + 1];
      }
      for (int t = nstep - 1; t >= 0; --t) {
        const int key = __shfl_sync(FULL, my_key, t);
        const int v = __shfl_sync(FULL, my_v, t);
        const int vn = __shfl_sync(FULL, my_vn, t);
        const float a = live ? C::load(al[(size_t)(l0 + t) * M + lane]) : 0.f;
        float uu[MB];
#pragma unroll
        for (int i = 0; i < MB; ++i) uu[i] = __shfl_sync(FULL, u, i);
        float tv = 0.f;
#pragma unroll
        for (int i = 0; i < MB; ++i) tv = fmaf(Trow[i], uu[i], tv);
        const float qun = vn ? tv : q;
        const float Z = fmaxf(warp_sum(a * qun), TINY);
        const float g = a * qun / Z;
        if constexpr (GAMMA) {
          if (live) gr[(size_t)(l0 + t) * M + lane] = v ? g : 0.f;
        }
        if (v) {
          if (live) G[key * M + lane] += (double)g;
          if (vn) {
            const float as = a / Z;
#pragma unroll
            for (int i = 0; i < MB; ++i) xo[i] += (double)(as * uu[i]);
          }
          q = qun / fmaxf(warp_max(qun), TINY);
          u = live ? table<SMEM_E>(tE, key * M + lane) * q : 0.f;
        }
      }
    }
    if (live) u_start[(size_t)s * M + lane] = u;
  }
  if (live) {
    double* xp = xo_part + ((size_t)blockIdx.x * M + lane) * M;
#pragma unroll
    for (int i = 0; i < MB; ++i)
      if (i < M) xp[i] = xo[i];
  }
  if constexpr (SMEM_E) {
    __syncwarp();
    for (int idx = lane; idx < n_keys * M; idx += 32) gp[idx] = G[idx];
  }
}

template <int MB, bool BF16, bool GAMMA>
int launch(const float* T, const float* E, const int32_t* keys,
           const uint8_t* valid, const void* alphas, const float* Q_end,
           int S, int L, int M, int n_keys, int n_blocks, float* u_start,
           double* xo_part, double* gsum_part, float* gam, cudaStream_t st) {
  using A = const typename Carry<BF16>::T*;
  const size_t smem = (sizeof(double) + sizeof(float)) * (size_t)n_keys * M;
  return launch_e(dsc_sweep_kernel<MB, BF16, GAMMA, true>,
                  dsc_sweep_kernel<MB, BF16, GAMMA, false>, smem, (size_t)0,
                  dim3(n_blocks), dim3(32), st, T, E, keys, valid, (A)alphas,
                  Q_end, S, L, M, n_keys, u_start, xo_part, gsum_part, gam);
}

}  // namespace

extern "C" {

// u_start (S, M) f32; xo_part (G, M, M) f64 and gsum_part (G, n_keys, M) f64
// per-block partials, G = n_blocks; gam (S, L, M) f32 when non-null (K2g),
// else K2.  alphas (S, L, M) in bf16 (bf16 != 0) or f32.
int smcpp_dsc_sweep(const float* T, const float* E, const int32_t* keys,
                    const uint8_t* valid, const void* alphas,
                    const float* Q_end, int S, int L, int M, int n_keys,
                    int bf16, int n_blocks, float* u_start, double* xo_part,
                    double* gsum_part, float* gam, void* stream) {
  if (M < 2 || M > 32 || S <= 0 || L <= 0 || n_keys <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  cudaStream_t st = (cudaStream_t)stream;
  int e = 0;
  SMCPP_DISPATCH(MBV, {
    if (gam != nullptr) {
      e = bf16 ? launch<MB_, true, true>(T, E, keys, valid, alphas, Q_end, S, L, M, n_keys,
                                         n_blocks, u_start, xo_part, gsum_part, gam, st)
               : launch<MB_, false, true>(T, E, keys, valid, alphas, Q_end, S, L, M, n_keys,
                                          n_blocks, u_start, xo_part, gsum_part, gam, st);
    } else {
      e = bf16 ? launch<MB_, true, false>(T, E, keys, valid, alphas, Q_end, S, L, M, n_keys,
                                          n_blocks, u_start, xo_part, gsum_part, gam, st)
               : launch<MB_, false, false>(T, E, keys, valid, alphas, Q_end, S, L, M, n_keys,
                                           n_blocks, u_start, xo_part, gsum_part, gam, st);
    }
  });
  if (e) return e;
  return (int)cudaGetLastError();
}

}  // extern "C"
