// Window Viterbi (MAP decode) kernels for NVIDIA Hopper (sm_90a), bound
// through a plain C interface (ctypes; see smcpp_tpu_torch/ops/_cuda.py).
//
//   K4 viterbi_ops    replaces the lax.scan of
//                     smcpp_tpu/ops/window_kernel.py:viterbi_segment_ops
//                     (phase A: per-segment max-plus transfer operators)
//   K5 viterbi_paths  replaces the forward sweep and the reverse backtrace
//                     of smcpp_tpu/ops/window_kernel.py:871
//                     (viterbi_segment_paths: phase C, full backpointer
//                     stream), as two launches, viterbi_fwd and viterbi_back
//
// What bounds them: serial depth along the L windows of a segment, at one
// warp per segment.  K4 carries its operator in registers as K3 does and is
// bound by the M^2 max-adds per lane per operator product; it runs one
// product a window on short runs of equal keys and bitlen(r) - 1 +
// popcount(r) on a run of r >= RUN_MIN windows (binary powers of the run's
// operator).  K5's forward reads V from
// shared memory (no shuffles in the max), so what is left is its compare and
// select instructions, three per candidate j per lane, which run at half
// the rate of f32 adds on sm_90; its backtrace copies the backpointers into
// shared memory 32 windows at a time, ahead of a walk of one shared-memory
// load per window, and is bound by the stream's bytes.
//
// Both are exact: every step is f32 adds and maxima, each rounded once, so
// the kernels reproduce their plain versions bit for bit: K5 its walk
// (viterbi_paths_plain), with the lowest maximizing index as its
// backpointer, as jnp.argmax gives; K4 its plain twin of the same run plan
// and product order (viterbi_ops_runs_plain), which groups each path's sums
// differently from the window walk (viterbi_ops_plain) on runs of RUN_MIN
// or more.  Padded rows and columns (M < MB) hold -inf in log T and log E and
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

// K5's backpointer scratch holds bp_windows(L) windows a segment: L rounded
// up to a multiple of 4, so that every segment and every block of 32 windows
// starts on a 4-byte boundary (at most 3 windows of padding a segment).
__host__ __device__ __forceinline__ int bp_windows(int L) { return (L + 3) & ~3; }

// K5's backtrace ring: blocks of 32 windows in shared memory per warp, and
// one warp's shared bytes (the ring, then a row of 32 int32 states).
constexpr int BACK_RING = 4;
__host__ __device__ __forceinline__ int back_warp_bytes(int M) {
  return BACK_RING * 32 * M + 32 * (int)sizeof(int32_t);
}

// ---------------------------------------------------------------------------
// K4: lane k owns column k of the segment's max-plus operator W (W[i][k] =
// best log score from entry state k to state i).  The window of key q applies
// A_q, A_q[i][j] = logT[j][i] + logE[q][i], and W is renormalised to a
// maximum of 0 over (i, k); an invalid window is the identity.
//
// The warp finds the segment's runs of equal keys, 32 windows at a time (a
// ballot of the windows that end the open run: an invalid window, or one
// whose key or validity differs from the window before), and applies each
// run whole once it ends.  A run of r < RUN_MIN windows is walked a window at
// a time, W[i][k] <- max_j(logT[j][i] + W[j][k]) + logE[q][i], the arithmetic
// of viterbi_ops_plain.  A longer run applies A_q^r by binary powers: B = A_q
// in a per-warp (MB, MB) tile of shared memory; for each bit of r from the
// lowest, W <- B (x) W if the bit is set, then B <- B (x) B; every product is
// renormalised to a maximum of 0 and its "impossible" entries clamped at
// MP_NEG, so repeated squaring cannot overflow.  That is bitlen(r) - 1 +
// popcount(r) products of M^3 candidates in place of r; the plain twin of
// this order is viterbi_ops_runs_plain.  Rows of log T^T and of B sit in
// shared memory (row i contiguous, read as float4 broadcasts); lane k keeps
// its column of W, and of B while squaring, in registers.
//
// counts (two uint64, optional): each warp adds the operator products it ran
// and the valid windows it covered (one atomicAdd each).
// ---------------------------------------------------------------------------
constexpr int RUN_MIN = 8;  // the shortest run applied as a power

// Y[i] = max_j(R[i][j] + X[j]): rows R (MB, MB) in shared memory, X lane k's
// column.
template <int MB>
__device__ __forceinline__ void mp_rows(const float* R, const float (&X)[MB],
                                        float (&Y)[MB]) {
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const float4* tr = reinterpret_cast<const float4*>(R + i * MB);
    float best = -INFINITY;
#pragma unroll
    for (int j4 = 0; j4 < MB / 4; ++j4) {
      const float4 t4 = tr[j4];
      best = fmaxf(best, t4.x + X[4 * j4]);
      best = fmaxf(best, t4.y + X[4 * j4 + 1]);
      best = fmaxf(best, t4.z + X[4 * j4 + 2]);
      best = fmaxf(best, t4.w + X[4 * j4 + 3]);
    }
    Y[i] = best;
  }
}

// One window: W <- A_key (x) W, renormalised (the walk).
template <int MB, bool SMEM_E>
__device__ __forceinline__ void mp_walk(float (&W)[MB], const float* sLT, const float* er,
                                        int M, bool live) {
  float W2[MB];
  mp_rows<MB>(sLT, W, W2);
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const float e = (SMEM_E || i < M) ? table<SMEM_E>(er, i) : -INFINITY;
    W2[i] = W2[i] + e;
    if (i < M) mx = fmaxf(mx, W2[i]);
  }
  mx = warp_max(live ? mx : -INFINITY);
#pragma unroll
  for (int i = 0; i < MB; ++i) W[i] = W2[i] - mx;
}

// A power's product, renormalised: Y <- max(Y - max over the live (i, k),
// MP_NEG); padded rows and columns -inf.
template <int MB>
__device__ __forceinline__ void mp_renorm(float (&Y)[MB], int M, bool live) {
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < MB; ++i)
    if (i < M) mx = fmaxf(mx, Y[i]);
  mx = warp_max(live ? mx : -INFINITY);
#pragma unroll
  for (int i = 0; i < MB; ++i) Y[i] = (live && i < M) ? fmaxf(Y[i] - mx, MP_NEG) : -INFINITY;
}

// A run of r >= 1 windows of one key: W <- A_key^r (x) W by binary powers,
// B in the warp's tile sB.
template <int MB, bool SMEM_E>
__device__ __forceinline__ void mp_power(float (&W)[MB], float* sB, const float* sLT,
                                         const float* er, int r, int M, int lane,
                                         bool live) {
  __syncwarp();  // every lane is done reading the last run's B
  if (lane < MB) {
#pragma unroll
    for (int i = 0; i < MB; ++i)
      sB[i * MB + lane] =
          sLT[i * MB + lane] + ((SMEM_E || i < M) ? table<SMEM_E>(er, i) : -INFINITY);
  }
  __syncwarp();
  for (;;) {
    if (r & 1) {
      float Y[MB];
      mp_rows<MB>(sB, W, Y);
      mp_renorm<MB>(Y, M, live);
#pragma unroll
      for (int i = 0; i < MB; ++i) W[i] = Y[i];
    }
    r >>= 1;
    if (r == 0) break;
    float Bc[MB], C[MB];
#pragma unroll
    for (int j = 0; j < MB; ++j) Bc[j] = lane < MB ? sB[j * MB + lane] : -INFINITY;
    mp_rows<MB>(sB, Bc, C);
    mp_renorm<MB>(C, M, live);
    __syncwarp();  // every lane has read B
    if (lane < MB) {
#pragma unroll
      for (int i = 0; i < MB; ++i) sB[i * MB + lane] = C[i];
    }
    __syncwarp();  // B's new entries are visible to every lane
  }
}

template <int MB, bool SMEM_E>
__global__ void __launch_bounds__(128) viterbi_ops_kernel(
    const float* __restrict__ logT, const float* __restrict__ logE,
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    int S, int L, int M, int n_keys, float* __restrict__ ops,
    unsigned long long* __restrict__ counts) {
  extern __shared__ float4 smem4[];
  float* sLT = reinterpret_cast<float*>(smem4);  // (MB, MB): sLT[i][j] = logT[j][i]
  for (int idx = threadIdx.x; idx < MB * MB; idx += blockDim.x) {
    int i = idx / MB, j = idx % MB;
    sLT[idx] = (i < M && j < M) ? logT[j * M + i] : -INFINITY;
  }
  float* tiles = sLT + MB * MB;  // one (MB, MB) tile of B a warp
  int ES;
  const float* tE =
      log_table<MB, SMEM_E>(tiles + WARPS_PER_BLOCK * MB * MB, logE, M, n_keys, ES);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= S) return;
  float* sB = tiles + warp * MB * MB;
  const bool live = lane < M;
  float W[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) W[i] = (i == lane) ? 0.f : MP_NEG;
  const int32_t* kr = keys + (size_t)s * L;
  const uint8_t* vr = valid + (size_t)s * L;

  int products = 0, windows = 0;  // warp-uniform
  int run_key = 0, run_len = 0;   // the open run (warp-uniform)
  int next_key = 0, next_v = 0;   // this lane's window of the next chunk
  if (lane < L) {
    next_key = kr[lane];
    next_v = vr[lane] != 0;
  }
  // Chunks of 32 windows; the window after the last (in the last chunk, or
  // in a chunk of its own when 32 divides L) ends the last run.
  for (int l0 = 0; l0 <= L; l0 += 32) {
    const int nstep = min(32, L - l0);
    const int my_key = next_key, my_v = next_v;
    next_key = next_v = 0;
    if (l0 + 32 + lane < L) {
      next_key = kr[l0 + 32 + lane];
      next_v = vr[l0 + 32 + lane] != 0;
    }
    int prev_key = __shfl_up_sync(FULL, my_key, 1);
    int prev_v = __shfl_up_sync(FULL, my_v, 1);
    if (lane == 0) {
      prev_key = run_key;
      prev_v = run_len > 0;
    }
    unsigned ends = __ballot_sync(
        FULL, lane < nstep ? (!my_v || !prev_v || my_key != prev_key) : lane == nstep);
    windows += __popc(__ballot_sync(FULL, lane < nstep && my_v));
    int t = 0;  // windows [t, the next end) extend the open run
    while (ends) {
      const int b = __ffs(ends) - 1;
      ends &= ends - 1;
      // the run that ends before window b, applied whole
      const int r = run_len + b - t;
      const float* er = tE + run_key * ES;
      if (r >= RUN_MIN) {
        mp_power<MB, SMEM_E>(W, sB, sLT, er, r, M, lane, live);
        products += (31 - __clz(r)) + __popc(r);
      } else {
        for (int k = 0; k < r; ++k) mp_walk<MB, SMEM_E>(W, sLT, er, M, live);
        products += r;
      }
      run_key = __shfl_sync(FULL, my_key, b);
      run_len = __shfl_sync(FULL, my_v, b);
      t = b + 1;
    }
    run_len += max(nstep - t, 0);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < MB; ++i)
      if (i < M) ops[((size_t)s * M + i) * M + lane] = W[i];
  }
  if (lane == 0 && counts != nullptr) {
    atomicAdd(counts, (unsigned long long)products);
    atomicAdd(counts + 1, (unsigned long long)windows);
  }
}

// ---------------------------------------------------------------------------
// K5, launch 1 (viterbi_fwd): lane i owns V[i] and column i of log T
// (registers).  A valid window does V2[i] = max_j(logT[j][i] + V[j]) +
// logE[key][i] with the lowest maximizing j as its backpointer, then
// subtracts max_i V2; an invalid window keeps V and stores the identity
// backpointer.  Every lane reads the whole of V from a per-warp row in shared
// memory (float4 broadcasts; two rows used in turn, so one __syncwarp a window
// orders each write before its reads and after the reads of the window before
// last).  The maximum over j runs as four strict-'>' chains over four
// contiguous runs of j, merged in run order with a strict '>': the first
// maximum of each run, then the lowest run holding the maximum, which is the
// lowest maximizing j, as one chain over all j gives.  Each lane packs four
// windows' backpointers into one 32-bit word and stores it every fourth
// window (a warp's 128-byte row of the scratch).
//
// Blocked (replaces the block != None branch of
// smcpp_tpu/ops/window_kernel.py:viterbi_segment_paths, :923-935): a launch
// walks windows [lb, le) in blocks of blk (a multiple of 4), from V_in (S, M)
// f32 or, without it, from seg_entry.  Each output is optional: the
// backpointers of the range (bp, as above with le - lb windows a segment),
// and the V entering each block, block-major ((le - lb) / blk, S, M) f32.
// The blocked Viterbi is one launch over [0, L) writing only the snapshots,
// then one per block from its snapshot writing only its backpointers.  Chunks
// never cross a block, so a snapshot is taken between two chunks; V is f32
// and stored unrounded, and the step is unchanged, so every block's
// backpointers are the whole sweep's, bit for bit.
// ---------------------------------------------------------------------------
template <int MB, bool SMEM_E>
__global__ void __launch_bounds__(128) viterbi_fwd_kernel(
    const float* __restrict__ logT, const float* __restrict__ logE,
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ seg_entry, const float* __restrict__ V_in, int S, int L,
    int M, int n_keys, int lb, int le, int blk, uint8_t* __restrict__ bp,
    float* __restrict__ snaps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int ES;
  const float* tE = log_table<MB, SMEM_E>(smem, logE, M, n_keys, ES);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sV = smem + (SMEM_E ? n_keys * MB : 0) + warp * 2 * MB;  // two rows of MB
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= S) return;
  const bool live = lane < M;
  float LTcol[MB];
#pragma unroll
  for (int j = 0; j < MB; ++j) LTcol[j] = (live && j < M) ? logT[j * M + lane] : -INFINITY;
  float V = V_in != nullptr ? (live ? V_in[(size_t)s * M + lane] : 0.f)
                            : ((lane == seg_entry[s]) ? 0.f : MP_NEG);
  const int32_t* kr = keys + (size_t)s * L;
  const uint8_t* vr = valid + (size_t)s * L;
  const int LS = le - lb;
  uint32_t* bs = bp == nullptr ? nullptr
                               : reinterpret_cast<uint32_t*>(bp + (size_t)s * bp_windows(LS) * M);
  constexpr int Q = MB / 4;  // length of each of the four runs of j
  int row = 0;
  uint32_t word = 0;  // four windows' backpointers, window l in byte (l - lb) % 4

  for (int l0 = lb; l0 < le;) {
    // to the end of l0's block, 32 windows at most
    const int nstep = min(32, lb + ((l0 - lb) / blk + 1) * blk - l0);
    if (snaps != nullptr && (l0 - lb) % blk == 0 && live)
      snaps[((size_t)((l0 - lb) / blk) * S + s) * M + lane] = V;
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
        float* r = sV + row * MB;
        if (lane < MB) r[lane] = live ? V : -INFINITY;
        __syncwarp();
        float Vj[MB];
#pragma unroll
        for (int j4 = 0; j4 < MB / 4; ++j4) {
          const float4 x = reinterpret_cast<const float4*>(r)[j4];
          Vj[4 * j4] = x.x;
          Vj[4 * j4 + 1] = x.y;
          Vj[4 * j4 + 2] = x.z;
          Vj[4 * j4 + 3] = x.w;
        }
        float rb[4];
        int ra[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          rb[q] = LTcol[q * Q] + Vj[q * Q];
          ra[q] = q * Q;
        }
#pragma unroll
        for (int k = 1; k < Q; ++k) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float x = LTcol[q * Q + k] + Vj[q * Q + k];
            if (x > rb[q]) {  // strict: ties keep the run's lowest j
              rb[q] = x;
              ra[q] = q * Q + k;
            }
          }
        }
        float best = rb[0];
        arg = ra[0];
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          if (rb[q] > best) {  // strict: a tie keeps the lower run
            best = rb[q];
            arg = ra[q];
          }
        }
        const float V2 = live ? best + table<SMEM_E>(tE, key * ES + lane) : -INFINITY;
        V = V2 - warp_max(V2);
        row ^= 1;
      }
      word |= (uint32_t)arg << (8 * (t & 3));
      if ((t & 3) == 3 || t == nstep - 1) {
        if (live && bs != nullptr) bs[((l0 - lb + t) >> 2) * M + lane] = word;
        word = 0;
      }
    }
    l0 += nstep;
  }
}

// ---------------------------------------------------------------------------
// K5, launch 2 (viterbi_back): one warp per segment walks its backpointers
// back from the segment's exit state.  The stream is read in blocks of 32
// windows (32 M contiguous bytes), last block first, with
// cp.async into a per-warp ring of BACK_RING blocks in shared memory,
// BACK_RING - 1 blocks ahead of the walk.  Lane 0 walks a block in shared
// memory (one dependent shared load a window) and writes each window's state
// into a per-warp row; the warp then stores the row as one coalesced store.
// Blocked: the walk covers windows [lb, le) from the backpointers of that
// range, starting from seg_exit as the state after window le - 1, and, when
// state_out is given, leaves there the state entering window lb (the state
// after the block before).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128) viterbi_back_kernel(
    const int32_t* __restrict__ seg_exit, int S, int L, int M, int lb, int le,
    const uint8_t* __restrict__ bp, int32_t* __restrict__ path,
    int32_t* __restrict__ state_out) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = 32 * M;  // bytes of one block of 32 windows
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4) + warp * back_warp_bytes(M);
  int32_t* sPath = reinterpret_cast<int32_t*>(ring + BACK_RING * blk);
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= S) return;
  const int LS = le - lb;
  const uint8_t* bs = bp + (size_t)s * bp_windows(LS) * M;
  const bool vec = (bp_windows(LS) * M) % 16 == 0;  // every segment starts on 16 bytes
  const int nblk = (LS + 31) / 32;

  auto fetch = [&](int b) {  // block b's bytes into its ring slot; one group
    if (b >= 0) {
      const int bytes = bp_windows(min(32, LS - 32 * b)) * M;  // a multiple of 4
      const uint8_t* src = bs + (size_t)b * blk;
      uint8_t* dst = ring + (b % BACK_RING) * blk;
      int done = 0;
      if (vec) {
        for (int i = lane; i < bytes / 16; i += 32) cp_async16(dst + 16 * i, src + 16 * i);
        done = bytes / 16 * 16;
      }
      for (int i = done / 4 + lane; i < bytes / 4; i += 32) cp_async4(dst + 4 * i, src + 4 * i);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < BACK_RING - 1; ++k) fetch(nblk - 1 - k);

  int state = seg_exit[s];  // lane 0's walk
  int32_t* ps = path + (size_t)s * L + lb;
  for (int b = nblk - 1; b >= 0; --b) {
    fetch(b - (BACK_RING - 1));
    cp_async_wait<BACK_RING - 1>();
    __syncwarp();  // block b's bytes, copied by every lane, are visible to lane 0
    const int nt = min(32, LS - 32 * b);
    const uint8_t* sb = ring + (b % BACK_RING) * blk;
    if (lane == 0) {
      for (int t = nt - 1; t >= 0; --t) {
        sPath[t] = state;
        state = sb[(t >> 2) * 4 * M + state * 4 + (t & 3)];
      }
    }
    __syncwarp();  // the row is written; slot b is free for the next fetch
    if (lane < nt) ps[32 * b + lane] = sPath[lane];
  }
  if (lane == 0 && state_out != nullptr) state_out[s] = state;
}

}  // namespace

extern "C" {

// ops (S, M, M) f32 from logT (M, M), logE (n_keys, M) f32; counts, when
// non-null, two uint64 to which the launch adds its operator products and
// its valid windows.
int smcpp_viterbi_ops(const float* logT, const float* logE, const int32_t* keys,
                      const uint8_t* valid, int S, int L, int M, int n_keys,
                      float* ops, unsigned long long* counts, void* stream) {
  if (M < 2 || M > 32 || S <= 0 || L <= 0 || n_keys <= 0) return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  // log T^T and one tile of B a warp
  const size_t smem_t = sizeof(float) * (size_t)MBV * MBV * (1 + WARPS_PER_BLOCK);
  const size_t smem = smem_t + sizeof(float) * (size_t)n_keys * MBV;
  const dim3 grid((S + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK), block(32 * WARPS_PER_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  int e = 0;
  SMCPP_DISPATCH(MBV, {
    e = launch_e(viterbi_ops_kernel<MB_, true>, viterbi_ops_kernel<MB_, false>, smem,
                 smem_t, grid, block, st, logT, logE, keys, valid, S, L, M, n_keys, ops,
                 counts);
  });
  if (e) return e;
  return (int)cudaGetLastError();
}

// K5 launch 1: the forward over windows [lb, le) of keys and valid (S, L),
// in blocks of blk windows (blk a multiple of 4 dividing le - lb), from V_in
// (S, M) f32 or, when it is null, from seg_entry (S,) int32.  Outputs, each
// optional (null): bp, the backpointer scratch, (S, bp_windows(le - lb) / 4,
// M) uint32 words, byte (l - lb) % 4 of word ((l - lb) / 4, i) window l's
// backpointer of state i; snaps ((le - lb) / blk, S, M) f32, the V entering
// each block.  The whole sweep is lb = 0, le = blk = L, snaps null.
// shared_table is the plan's table route (window_kernel.viterbi_paths_plan);
// a plan that disagrees with this launch's is refused.
int smcpp_viterbi_paths_fwd(const float* logT, const float* logE, const int32_t* keys,
                            const uint8_t* valid, const int32_t* seg_entry,
                            const float* V_in, int S, int L, int M, int n_keys, int lb,
                            int le, int blk, int shared_table, uint8_t* bp, float* snaps,
                            void* stream) {
  if (M < 2 || M > 32 || S <= 0 || L <= 0 || n_keys <= 0 || lb < 0 || le > L ||
      le <= lb || blk <= 0 || (le - lb) % blk || (blk % 4 && blk != le - lb) ||
      (seg_entry == nullptr && V_in == nullptr))
    return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  const size_t smem_v = sizeof(float) * 2 * MBV * WARPS_PER_BLOCK;
  const size_t smem = sizeof(float) * (size_t)n_keys * MBV + smem_v;
  if ((smem <= SMEM_MAX) != (shared_table != 0)) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK), block(32 * WARPS_PER_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  int e = 0;
  SMCPP_DISPATCH(MBV, {
    e = launch_e(viterbi_fwd_kernel<MB_, true>, viterbi_fwd_kernel<MB_, false>, smem, smem_v,
                 grid, block, st, logT, logE, keys, valid, seg_entry, V_in, S, L, M, n_keys,
                 lb, le, blk, bp, snaps);
  });
  if (e) return e;
  return (int)cudaGetLastError();
}

// K5 launch 2: windows [lb, le) of path (S, L) int32 from the scratch of
// launch 1 over the same range; seg_exit (S,) int32, the state after window
// le - 1; state_out (S,) int32, when non-null, the state entering window lb.
int smcpp_viterbi_paths_back(const int32_t* seg_exit, int S, int L, int M, int lb,
                             int le, const uint8_t* bp, int32_t* path,
                             int32_t* state_out, void* stream) {
  if (M < 2 || M > 32 || S <= 0 || L <= 0 || lb < 0 || le > L || le <= lb)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)back_warp_bytes(M) * WARPS_PER_BLOCK;
  const dim3 grid((S + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK), block(32 * WARPS_PER_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  viterbi_back_kernel<<<grid, block, smem, st>>>(seg_exit, S, L, M, lb, le, bp, path,
                                                  state_out);
  return (int)cudaGetLastError();
}

}  // extern "C"

SMCPP_LAST_LAUNCH(viterbi_kernels)
