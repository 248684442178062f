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
// Both are one kernel body with a template flag (GAMMA).
//
// What bounds them: per window 2 M^2 f32 FMAs (T u, and the xisum outer
// product) and M^2 f64 adds of xisum, and the alpha stream read once; K2g
// also writes the (S, L, M) f32 gamma stream (12.8 GB at 1e8 windows and
// M = 32).  On the H100 that is 0.84 ms at the C3 shape (6732 x 8192
// windows, M = 16) and 7.8 ms (bytes) for K2g at the posterior's 6104 x
// 16384 windows, M = 32.  But each segment is a chain of L dependent steps,
// each behind two warp reductions, so a warp is latency-bound: the design
// keeps as many warps resident as registers allow, takes every load off the
// step's chain, and takes the f32->f64 conversions out of the step.
//
// Design:
// - One warp per segment, DSC_MAX_WARPS = 8 warps per block (the wrapper's
//   DSC_WARPS).  Warp w of block b owns segments (b R + r) W + w, r < R;
//   R (segments per warp) is 1 unless the gsum partials' budget binds.  The
//   partition is a function of (S, n_keys, M) only
//   (window_kernel.dsc_plan), never of the card.
// - Lane j owns q[j], u[j], row j of T and row j of the xisum accumulator.
//   u is broadcast through two per-warp vectors in shared memory (the next
//   u is written to the other one, so the step that reads the old u needs
//   one __syncwarp), read as float4 broadcasts.  Z = sum(alpha q) and
//   max(q) share one butterfly over the MB lanes that hold states.
// - The alpha stream is read a 32-window chunk at a time: in the (S, L, M)
//   layout a chunk is one contiguous run of 32 M elements, copied with
//   cp.async (16 B per lane) into a per-warp double buffer in shared memory
//   while the chunk before it runs.  The next chunk's keys and valid flags
//   are loaded into registers a chunk ahead, one window per lane, and
//   broadcast per step with one shuffle.  A stream whose chunks are not
//   16-B aligned (L M elt not a multiple of 16) is copied with plain loads
//   at the chunk's start instead.
// - xisum terms are summed in f32 registers over each chunk (at most 32
//   terms) and added to the f64 accumulator once per chunk: the f32->f64
//   conversions, 16 per clock per SM, fall 32-fold.
// - The per-key masses go into one table per block in 64-bit fixed point:
//   each valid window adds llrint(g 2^40) with an integer atomicAdd, lane j
//   into column j of the window's key.  Integer addition does not depend on
//   order, so gsum is bit for bit the same on every run and every card
//   while the block's warps add concurrently; a term's rounding error is at
//   most 2^-41.  An entry stays below (segments per block) L 2^40, which the
//   wrapper holds under 2^62.  The table and the f32 emission table sit in
//   shared memory when both fit a block with the per-warp buffers (227 KB);
//   otherwise the fixed-point table is the block's own slice of gsum_part in
//   global memory (native 64-bit global atomics) and the emission table is
//   read through the read-only cache (common.cuh).  At the end the block
//   converts its table to f64 in place.  (A 64-bit shared-memory atomicAdd
//   compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64; a 32-bit split
//   with carries measured no faster.)
// - At the end the W warps' xisum rows are added in warp order through
//   shared memory into the block's slice of xo_part: a fixed order.  The
//   wrapper reduces the per-block partials with one torch.sum in f64.
//
// Registers and residency (nvcc -Xptxas -v, sm_90a, the smem-table
// instantiations): MB = 16 uses 64 registers (__launch_bounds__ asks for 4
// blocks of 8 warps; the f64 accumulator, touched once per chunk, spills
// about 250 B to L1) and 4 blocks fit shared memory at C3 (41 KB each):
// 32 warps per SM, so 6732 segments take 2 waves.  MB = 32 uses 128
// registers (2 blocks; about 540 B of spills, again mostly the f64
// accumulator) and 90 KB of shared memory per block at the posterior shape:
// 16 warps per SM, 3 waves of 6104 segments.  The measured times are in
// PERF.md.

#include "common.cuh"

using namespace smcpp;

namespace {

constexpr int DSC_MAX_WARPS = 8;               // warps of the largest block
// 2^40: gsum's fixed point (window_kernel.GSUM_FRAC_BITS, whose headroom
// check in dsc_plan depends on it)
constexpr float FIX_SCALE = 1099511627776.0f;
constexpr double FIX_INV = 1.0 / 1099511627776.0;

// Blocks of DSC_MAX_WARPS warps that the register budget keeps resident.
template <int MB>
constexpr int dsc_min_blocks() {
  return MB <= 16 ? 4 : 2;
}

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// Byte offsets of a block's dynamic shared memory: the fixed-point gsum
// table (tables in shared memory only), the per-warp alpha double buffers
// (reused for the end-of-block xisum sum), the per-warp u vectors and the
// f32 emission table (tables in shared memory only).
struct Layout {
  size_t chunk, a, u, e, total;
  __host__ __device__ Layout(int W, int M, int MB, int KM, int elt, bool tables) {
    chunk = round16((size_t)32 * M * elt);
    size_t abytes = (size_t)W * 2 * chunk;
    if (abytes < (size_t)8 * M * M) abytes = (size_t)8 * M * M;
    a = tables ? round16((size_t)8 * KM) : 0;
    u = a + round16(abytes);
    e = u + (size_t)W * 8 * MB;
    total = e + (tables ? (size_t)4 * KM : 0);
  }
};

// Start copying n elements of the alpha stream into a warp's buffer, as one
// cp.async group (16 B per lane and instruction), or with plain loads when
// the stream's chunks are not 16-B aligned.
template <typename CT>
__device__ __forceinline__ void fetch_chunk(CT* dst, const CT* src, int n,
                                            bool aligned, int lane) {
  if (aligned) {
    const int n16 = (int)(n * sizeof(CT) / 16);
    char* d = reinterpret_cast<char*>(dst);
    const char* s = reinterpret_cast<const char*>(src);
    for (int i = lane; i < n16; i += 32) cp_async16(d + 16 * i, s + 16 * i);
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
  }
  cp_async_commit();
}

// Window l's key and valid flag, issued now and used a chunk later.
__device__ __forceinline__ void fetch_kv(const int32_t* kr, const uint8_t* vr,
                                         int l, int L, int& k, int& v) {
  k = 0;
  v = 0;
  if (l < L) {
    k = __ldg(kr + l);
    v = __ldg(vr + l);
  }
}

template <int MB, bool BF16, bool GAMMA, bool SMEM_T>
__global__ void __launch_bounds__(32 * DSC_MAX_WARPS, dsc_min_blocks<MB>())
    dsc_sweep_kernel(const float* __restrict__ T, const float* __restrict__ E,
                     const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
                     const typename Carry<BF16>::T* __restrict__ alphas,
                     const float* __restrict__ Q_end, int S, int L, int M, int n_keys,
                     int seg_per_warp, float* __restrict__ u_start,
                     double* __restrict__ xo_part, double* gsum_part,
                     float* __restrict__ gam) {
  using C = Carry<BF16>;
  using CT = typename C::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KM = n_keys * M;
  const Layout lay(W, M, MB, KM, (int)sizeof(CT), SMEM_T);

  // the block's fixed-point gsum table and the emission table it reads
  double* gp = gsum_part + (size_t)blockIdx.x * KM;
  unsigned long long* G = reinterpret_cast<unsigned long long*>(SMEM_T ? (void*)smem : (void*)gp);
  const float* tE = E;
  if constexpr (SMEM_T) {
    float* sE = reinterpret_cast<float*>(smem + lay.e);
    for (int idx = threadIdx.x; idx < KM; idx += blockDim.x) sE[idx] = E[idx];
    tE = sE;
  }
  for (int idx = threadIdx.x; idx < KM; idx += blockDim.x) G[idx] = 0ull;
  __syncthreads();

  CT* const buf0 = reinterpret_cast<CT*>(smem + lay.a + (size_t)(2 * warp) * lay.chunk);
  CT* const buf1 = reinterpret_cast<CT*>(smem + lay.a + (size_t)(2 * warp + 1) * lay.chunk);
  float* sU = reinterpret_cast<float*>(smem + lay.u) + warp * 2 * MB;
  const bool aligned = reinterpret_cast<uintptr_t>(alphas) % 16 == 0 &&
                       (size_t)L * M * sizeof(CT) % 16 == 0;

  constexpr int RED = MB <= 4 ? 4 : MB <= 8 ? 8 : MB <= 16 ? 16 : 32;  // lanes reduced
  // the xisum update reuses u from registers where the budget has room for
  // it (128 registers at MB > 16), else it reads u again (64 at MB <= 16)
  constexpr bool U_REG = MB > 16;
  const bool live = lane < M;
  float Trow[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) Trow[i] = (live && i < M) ? T[lane * M + i] : 0.f;
  double xo[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) xo[i] = 0.0;

  const int nch = (L + 31) / 32, top = (nch - 1) * 32;
  for (int r = 0; r < seg_per_warp; ++r) {
    const int s = (blockIdx.x * seg_per_warp + r) * W + warp;
    if (s >= S) break;
    const int32_t* kr = keys + (size_t)s * L;
    const uint8_t* vr = valid + (size_t)s * L;
    const CT* al = alphas + (size_t)s * L * M;
    float* gr = GAMMA ? gam + (size_t)s * L * M : nullptr;
    float q = live ? Q_end[(size_t)s * M + lane] : 0.f;
    float u = 0.f;
    int p = 0;  // which of the warp's two u vectors holds u
    if (lane < MB) sU[lane] = 0.f;
    int vprev = 0;  // valid flag of window l + 1
    fetch_chunk(buf0, al + (size_t)top * M, (L - top) * M, aligned, lane);
    int nk, nv;
    fetch_kv(kr, vr, top + lane, L, nk, nv);
    for (int c = 0; c < nch; ++c) {
      const int l0 = top - 32 * c;
      const int nstep = min(32, L - l0);
      const int my_kv = nv ? nk : -1;  // this lane's window: its key, or -1 if invalid
      const CT* cur = (c & 1) ? buf1 : buf0;
      if (c + 1 < nch) {
        fetch_chunk((c & 1) ? buf0 : buf1, al + (size_t)(l0 - 32) * M, 32 * M, aligned, lane);
        fetch_kv(kr, vr, l0 - 32 + lane, L, nk, nv);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      float xc[MB];  // this chunk's xisum terms, in f32
#pragma unroll
      for (int i = 0; i < MB; ++i) xc[i] = 0.f;
      for (int t = nstep - 1; t >= 0; --t) {
        const int kv = __shfl_sync(FULL, my_kv, t);
        const float a = live ? C::load(cur[t * M + lane]) : 0.f;
        const float e = live ? table<SMEM_T>(tE, max(kv, 0) * M + lane) : 0.f;
        const float4* u4 = reinterpret_cast<const float4*>(sU + p * MB);
        // T u as one FMA chain in state order
        float tv = 0.f;
        float4 uv[MB / 4];
#pragma unroll
        for (int i = 0; i < MB / 4; ++i) {
          const float4 ui = uv[i] = u4[i];
          tv = fmaf(Trow[4 * i], ui.x, tv);
          tv = fmaf(Trow[4 * i + 1], ui.y, tv);
          tv = fmaf(Trow[4 * i + 2], ui.z, tv);
          tv = fmaf(Trow[4 * i + 3], ui.w, tv);
        }
        const float qun = vprev ? tv : q;
        // Z = sum(alpha q) and max(q) in one butterfly over the MB lanes that
        // hold states (the others hold zeros)
        float z = a * qun, mx = qun;
#pragma unroll
        for (int o = RED / 2; o > 0; o >>= 1) {
          z += __shfl_xor_sync(FULL, z, o);
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        }
        const float Z = fmaxf(z, TINY);
        const float g = a * qun / Z;
        if constexpr (GAMMA) {
          if (live) gr[(size_t)(l0 + t) * M + lane] = kv >= 0 ? g : 0.f;
        }
        if (kv >= 0) {
          // the chain first: the next u, into the other u vector
          q = qun / fmaxf(mx, TINY);
          u = e * q;
          if (lane < MB) sU[(p ^ 1) * MB + lane] = u;
          if (live)
            atomicAdd(G + kv * M + lane, (unsigned long long)__float2ll_rn(g * FIX_SCALE));
          if (vprev) {
            const float as = a / Z;
#pragma unroll
            for (int i = 0; i < MB / 4; ++i) {
              const float4 ui = U_REG ? uv[i] : u4[i];
              xc[4 * i] = fmaf(as, ui.x, xc[4 * i]);
              xc[4 * i + 1] = fmaf(as, ui.y, xc[4 * i + 1]);
              xc[4 * i + 2] = fmaf(as, ui.z, xc[4 * i + 2]);
              xc[4 * i + 3] = fmaf(as, ui.w, xc[4 * i + 3]);
            }
          }
          p ^= 1;
          __syncwarp();
        }
        vprev = kv >= 0;
      }
#pragma unroll
      for (int i = 0; i < MB; ++i) xo[i] += (double)xc[i];
      __syncwarp();  // every lane is done with `cur` before it is refilled
    }
    if (live) u_start[(size_t)s * M + lane] = u;
  }

  __syncthreads();
  // (the global table is read past L1, where the atomics did not go)
  for (int idx = threadIdx.x; idx < KM; idx += blockDim.x)
    gp[idx] = (double)(SMEM_T ? G[idx] : __ldcg(G + idx)) * FIX_INV;
  // xisum: the warps' rows added in warp order, in the (now free) buffers
  double* sX = reinterpret_cast<double*>(smem + lay.a);
  for (int w = 0; w < W; ++w) {
    if (warp == w && live) {
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        if (i < M) {
          double* p = sX + lane * M + i;
          *p = (w == 0 ? 0.0 : *p) + xo[i];
        }
      }
    }
    __syncthreads();
  }
  double* xp = xo_part + (size_t)blockIdx.x * M * M;
  for (int idx = threadIdx.x; idx < M * M; idx += blockDim.x) xp[idx] = sX[idx];
}

template <int MB, bool BF16, bool GAMMA>
int launch(const float* T, const float* E, const int32_t* keys,
           const uint8_t* valid, const void* alphas, const float* Q_end,
           int S, int L, int M, int n_keys, int W, int seg_per_warp, int n_blocks,
           float* u_start, double* xo_part, double* gsum_part, float* gam,
           cudaStream_t st) {
  using A = const typename Carry<BF16>::T*;
  const int elt = BF16 ? 2 : 4, KM = n_keys * M;
  return launch_e(dsc_sweep_kernel<MB, BF16, GAMMA, true>,
                  dsc_sweep_kernel<MB, BF16, GAMMA, false>,
                  Layout(W, M, MB, KM, elt, true).total,
                  Layout(W, M, MB, KM, elt, false).total, dim3(n_blocks),
                  dim3(32 * W), st, T, E, keys, valid, (A)alphas, Q_end, S, L, M,
                  n_keys, seg_per_warp, u_start, xo_part, gsum_part, gam);
}

}  // namespace

extern "C" {

// u_start (S, M) f32; xo_part (G, M, M) f64 and gsum_part (G, n_keys, M)
// f64 per-block partials, G = n_blocks blocks of n_warps warps, each warp
// walking seg_per_warp segments (window_kernel.dsc_plan); gam (S, L, M) f32
// when non-null (K2g), else K2.  alphas (S, L, M) in bf16 (bf16 != 0) or f32.
int smcpp_dsc_sweep(const float* T, const float* E, const int32_t* keys,
                    const uint8_t* valid, const void* alphas,
                    const float* Q_end, int S, int L, int M, int n_keys,
                    int bf16, int n_warps, int seg_per_warp, int n_blocks,
                    float* u_start, double* xo_part, double* gsum_part,
                    float* gam, void* stream) {
  if (M < 2 || M > 32 || S <= 0 || L <= 0 || n_keys <= 0 || n_warps < 1 ||
      n_warps > DSC_MAX_WARPS || seg_per_warp < 1 || n_blocks < 1 ||
      (long long)n_blocks * n_warps * seg_per_warp < S)
    return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  cudaStream_t st = (cudaStream_t)stream;
  int e = 0;
  SMCPP_DISPATCH(MBV, {
    if (gam != nullptr) {
      e = bf16 ? launch<MB_, true, true>(T, E, keys, valid, alphas, Q_end, S, L, M, n_keys,
                                         n_warps, seg_per_warp, n_blocks, u_start,
                                         xo_part, gsum_part, gam, st)
               : launch<MB_, false, true>(T, E, keys, valid, alphas, Q_end, S, L, M, n_keys,
                                          n_warps, seg_per_warp, n_blocks, u_start,
                                          xo_part, gsum_part, gam, st);
    } else {
      e = bf16 ? launch<MB_, true, false>(T, E, keys, valid, alphas, Q_end, S, L, M, n_keys,
                                          n_warps, seg_per_warp, n_blocks, u_start,
                                          xo_part, gsum_part, gam, st)
               : launch<MB_, false, false>(T, E, keys, valid, alphas, Q_end, S, L, M, n_keys,
                                           n_warps, seg_per_warp, n_blocks, u_start,
                                           xo_part, gsum_part, gam, st);
    }
  });
  if (e) return e;
  return (int)cudaGetLastError();
}

}  // extern "C"

SMCPP_LAST_LAUNCH(dsc_kernels)
