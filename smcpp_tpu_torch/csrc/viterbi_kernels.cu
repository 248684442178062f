// Window Viterbi (MAP decode) kernels for NVIDIA Hopper (sm_90a), bound
// through a plain C interface (ctypes; see smcpp_tpu_torch/ops/_cuda.py).
//
//   K4 viterbi_ops    replaces the lax.scan of
//                     smcpp_tpu/ops/window_kernel.py:viterbi_segment_ops
//                     (phase A: per-segment max-plus transfer operators)
//   K5 viterbi_paths  replaces the forward sweep and the reverse backtrace
//                     of smcpp_tpu/ops/window_kernel.py:viterbi_segment_paths
//                     (phase C, full backpointer stream)
//
// What bounds them: serial depth along the L windows of a segment, as for
// the E-step kernels, and for K4 the M^2 max-adds per lane per window (M^3
// per segment per window).  The design is K3's in max-plus: one warp per
// segment, the carry in registers, no block barrier in the window loop.
//
// Both are exact: every step is f32 adds and maxima, which round the same
// way in any order, so the kernels reproduce their plain versions bit for
// bit, and K5's backpointer is the lowest maximizing index, as jnp.argmax
// gives.  Padded rows and columns (M < MB) hold -inf in log T and log E and
// are masked out of every maximum; "impossible" entries carry -1e30 as in
// the reference (_mp_neg).

#include "common.cuh"

using namespace smcpp;

namespace {

// Load the (n_keys, M) log-emission table into shared memory padded to MB
// columns with -inf, when it fits; returns the table to read and its row
// stride.
template <int MB, bool SMEM_E>
__device__ __forceinline__ const float* log_table(float* sE, const float* logE,
                                                  int M, int n_keys, int& ES) {
  if constexpr (SMEM_E) {
    for (int idx = threadIdx.x; idx < n_keys * MB; idx += blockDim.x) {
      int r = idx / MB, i = idx % MB;
      sE[idx] = (i < M) ? logE[r * M + i] : -INFINITY;
    }
    ES = MB;
    return sE;
  } else {
    ES = M;
    return logE;
  }
}

// ---------------------------------------------------------------------------
// K4: lane k owns column k of the segment's max-plus operator W (W[i][k] =
// best log score from entry state k to state i).  A valid window does
// W[i][k] <- max_j(logT[j][i] + W[j][k]) + logE[key][i], then subtracts the
// maximum over (i, k); an invalid one keeps W.  log T^T sits in shared
// memory (row i contiguous, read as float4 broadcasts).
// ---------------------------------------------------------------------------
template <int MB, bool SMEM_E>
__global__ void __launch_bounds__(128) viterbi_ops_kernel(
    const float* __restrict__ logT, const float* __restrict__ logE,
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    int S, int L, int M, int n_keys, float* __restrict__ ops) {
  extern __shared__ float4 smem4[];
  float* sLT = reinterpret_cast<float*>(smem4);  // (MB, MB): sLT[i][j] = logT[j][i]
  for (int idx = threadIdx.x; idx < MB * MB; idx += blockDim.x) {
    int i = idx / MB, j = idx % MB;
    sLT[idx] = (i < M && j < M) ? logT[j * M + i] : -INFINITY;
  }
  int ES;
  const float* tE = log_table<MB, SMEM_E>(sLT + MB * MB, logE, M, n_keys, ES);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= S) return;
  const bool live = lane < M;
  float W[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) W[i] = (i == lane) ? 0.f : MP_NEG;
  const int32_t* kr = keys + (size_t)s * L;
  const uint8_t* vr = valid + (size_t)s * L;

  for (int l0 = 0; l0 < L; l0 += 32) {
    const int nstep = min(32, L - l0);
    int my_key = 0, my_v = 0;
    if (lane < nstep) {
      my_key = kr[l0 + lane];
      my_v = vr[l0 + lane];
    }
    for (int t = 0; t < nstep; ++t) {
      const int key = __shfl_sync(FULL, my_key, t);
      const int v = __shfl_sync(FULL, my_v, t);
      if (v) {  // warp-uniform
        const float* er = tE + key * ES;
        float W2[MB];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          const float4* tr = reinterpret_cast<const float4*>(sLT + i * MB);
          float best = -INFINITY;
#pragma unroll
          for (int j4 = 0; j4 < MB / 4; ++j4) {
            const float4 t4 = tr[j4];
            best = fmaxf(best, t4.x + W[4 * j4]);
            best = fmaxf(best, t4.y + W[4 * j4 + 1]);
            best = fmaxf(best, t4.z + W[4 * j4 + 2]);
            best = fmaxf(best, t4.w + W[4 * j4 + 3]);
          }
          const float e = (SMEM_E || i < M) ? table<SMEM_E>(er, i) : -INFINITY;
          W2[i] = best + e;
          if (i < M) mx = fmaxf(mx, W2[i]);
        }
        mx = warp_max(live ? mx : -INFINITY);
#pragma unroll
        for (int i = 0; i < MB; ++i) W[i] = W2[i] - mx;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < MB; ++i)
      if (i < M) ops[((size_t)s * M + i) * M + lane] = W[i];
  }
}

// ---------------------------------------------------------------------------
// K5: lane i owns V[i] and column i of log T (registers).  A valid window
// does V2[i] = max_j(logT[j][i] + V[j]) + logE[key][i] with the lowest
// maximizing j as its int8 backpointer, then subtracts max_i V2; an invalid
// window keeps V and stores the identity backpointer.  The backpointers
// (S, L, M) are one 32-byte row per window.  Then lane 0 walks them back
// from the segment's exit state, writing the state after each window.
// ---------------------------------------------------------------------------
template <int MB, bool SMEM_E>
__global__ void __launch_bounds__(128) viterbi_paths_kernel(
    const float* __restrict__ logT, const float* __restrict__ logE,
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ seg_entry, const int32_t* __restrict__ seg_exit,
    int S, int L, int M, int n_keys, int8_t* bp, int32_t* __restrict__ path) {
  extern __shared__ float smem[];
  int ES;
  const float* tE = log_table<MB, SMEM_E>(smem, logE, M, n_keys, ES);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= S) return;
  const bool live = lane < M;
  float LTcol[MB];
#pragma unroll
  for (int j = 0; j < MB; ++j) LTcol[j] = (live && j < M) ? logT[j * M + lane] : -INFINITY;
  float V = (lane == seg_entry[s]) ? 0.f : MP_NEG;
  const int32_t* kr = keys + (size_t)s * L;
  const uint8_t* vr = valid + (size_t)s * L;
  int8_t* bs = bp + (size_t)s * L * M;

  for (int l0 = 0; l0 < L; l0 += 32) {
    const int nstep = min(32, L - l0);
    int my_key = 0, my_v = 0;
    if (lane < nstep) {
      my_key = kr[l0 + lane];
      my_v = vr[l0 + lane];
    }
    for (int t = 0; t < nstep; ++t) {
      const int key = __shfl_sync(FULL, my_key, t);
      const int v = __shfl_sync(FULL, my_v, t);
      int arg = lane;
      if (v) {  // warp-uniform
        float best = LTcol[0] + __shfl_sync(FULL, V, 0);
        arg = 0;
#pragma unroll
        for (int j = 1; j < MB; ++j) {
          const float x = LTcol[j] + __shfl_sync(FULL, V, j);
          if (x > best) {  // strict: ties keep the lowest j
            best = x;
            arg = j;
          }
        }
        const float V2 = live ? best + table<SMEM_E>(tE, key * ES + lane) : -INFINITY;
        V = V2 - warp_max(V2);
      }
      if (live) bs[(size_t)(l0 + t) * M + lane] = (int8_t)arg;
    }
  }
  __syncwarp();  // the backpointers written by every lane are visible to lane 0
  if (lane == 0) {
    int state = seg_exit[s];
    int32_t* ps = path + (size_t)s * L;
    for (int l = L - 1; l >= 0; --l) {
      ps[l] = state;
      state = bs[(size_t)l * M + state];
    }
  }
}

}  // namespace

extern "C" {

// ops (S, M, M) f32 from logT (M, M), logE (n_keys, M) f32.
int smcpp_viterbi_ops(const float* logT, const float* logE, const int32_t* keys,
                      const uint8_t* valid, int S, int L, int M, int n_keys,
                      float* ops, void* stream) {
  if (M < 2 || M > 32 || S <= 0 || L <= 0 || n_keys <= 0) return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  const size_t smem_t = sizeof(float) * (size_t)MBV * MBV;
  const size_t smem = smem_t + sizeof(float) * (size_t)n_keys * MBV;
  const dim3 grid((S + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK), block(32 * WARPS_PER_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  int e = 0;
  SMCPP_DISPATCH(MBV, {
    e = launch_e(viterbi_ops_kernel<MB_, true>, viterbi_ops_kernel<MB_, false>, smem,
                 smem_t, grid, block, st, logT, logE, keys, valid, S, L, M, n_keys, ops);
  });
  if (e) return e;
  return (int)cudaGetLastError();
}

// bp (S, L, M) int8 scratch, path (S, L) int32; seg_entry, seg_exit (S,) int32.
int smcpp_viterbi_paths(const float* logT, const float* logE, const int32_t* keys,
                        const uint8_t* valid, const int32_t* seg_entry,
                        const int32_t* seg_exit, int S, int L, int M, int n_keys,
                        int8_t* bp, int32_t* path, void* stream) {
  if (M < 2 || M > 32 || S <= 0 || L <= 0 || n_keys <= 0) return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  const size_t smem = sizeof(float) * (size_t)n_keys * MBV;
  const dim3 grid((S + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK), block(32 * WARPS_PER_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  int e = 0;
  SMCPP_DISPATCH(MBV, {
    e = launch_e(viterbi_paths_kernel<MB_, true>, viterbi_paths_kernel<MB_, false>, smem,
                 (size_t)0, grid, block, st, logT, logE, keys, valid, seg_entry, seg_exit,
                 S, L, M, n_keys, bp, path);
  });
  if (e) return e;
  return (int)cudaGetLastError();
}

}  // extern "C"
