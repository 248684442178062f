// Per-contig boundary scans for NVIDIA Hopper (sm_90a), bound through a
// plain C interface (ctypes; see smcpp_tpu_torch/ops/_cuda.py).
//
//   K6 boundary_scan     replaces smcpp_tpu/ops/window_kernel.py:
//                        contig_boundaries (the forward scan over the segment
//                        operators, which is also contig_scan, and the
//                        backward scan over their transposes)
//   K7 viterbi_boundary  replaces smcpp_tpu/ops/window_kernel.py:
//                        viterbi_boundary_states (the max-plus forward scan
//                        and its backtrace)
//
// What bounds them: serial depth.  A contig's NS segments are walked in
// order, each step an M x M matvec (K6) or max-plus matvec (K7) behind one
// warp reduction, so a launch takes NS dependent steps on any card; the
// arithmetic (2 S M^2 operations) and the bytes (one read of the (S, M, M)
// operators) are tiny beside that.
//
// Design: one warp per (contig, direction) for K6, the forward and the
// backward scan of a contig in the two warps of one block, at once; one
// warp per contig for K7.  Lane i owns state i.  The next segment's operator
// is copied with cp.async (4 B per lane and instruction, one row across the
// lanes) into the warp's double buffer in shared memory while the current
// step runs.  A buffer holds 32 rows at the odd row stride SP = MB + 1, so
// lane i reading row i (K6's forward v_i = sum_j op[i][j] a_j, K7's max over
// k) touches 32 different banks, and lane j reading column j (K6's backward
// qn_j = sum_i op[i][j] q_i) reads consecutive words.  Rows and columns past
// M stay zero.  The scanned vector is broadcast by __shfl_sync in the inner
// loop; sums and maxima are butterflies.
//
// Padded slots (seg_of_contig < 0, at a contig's tail) are the identity
// (K7: the max-plus identity) with log scale 0, as in the plain versions.
// Segments that no contig lists are not written: the wrappers zero the
// outputs.
//
// K7 is exact: f32 adds and maxima, as in the plain version, and the
// backpointer is the first maximizing entry state (torch.max's tie rule), so
// it reproduces viterbi_boundary_states_plain bit for bit.  Its backtrace
// reads the (C, NS, M) int8 backpointers eight rows at a time, one byte per
// lane, and follows the state with a shuffle, so the dependent chain is a
// shuffle and not a load.

#include "common.cuh"

using namespace smcpp;

namespace {

constexpr int ROWS = 32;     // rows of a staged operator: one per lane
constexpr int TRACE_ROWS = 8;  // backpointer rows loaded at once by K7's backtrace

// Start copying segment s's (M, M) operator into a buffer of ROWS x SP
// floats, as one cp.async group.  A padded slot (s < 0) copies nothing and
// commits an empty group, so there is one group per step.
template <int SP>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ ops,
                                      int s, int M, int lane) {
  if (s >= 0 && lane < M) {
    const float* src = ops + (size_t)s * M * M + lane;
    for (int i = 0; i < M; ++i) cp_async4(buf + i * SP + lane, src + (size_t)i * M);
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// K6: warp 0 of block c runs contig c's forward scan, warp 1 its backward
// scan.  Forward, per slot: record A_in[s] = a, then v = op[s] a, csum =
// sum v, ll += f64(log csum + logs[s]) (f32 add, then widened), a = v /
// csum; a starts at pi.  Backward, in reverse: record Q_end[s] = q, then
// qn = op[s]^T q, q = qn / max(max qn, FLT_MIN); q starts at ones.
// ---------------------------------------------------------------------------
template <int MB>
__global__ void __launch_bounds__(64) boundary_scan_kernel(
    const float* __restrict__ ops, const float* __restrict__ logs,
    const float* __restrict__ pi, const int32_t* __restrict__ soc,
    const uint8_t* __restrict__ cvalid, int NS, int M, double* __restrict__ ll,
    float* __restrict__ A_in, float* __restrict__ Q_end) {
  constexpr int SP = MB + 1;
  constexpr int BUF = ROWS * SP;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool fwd = warp == 0;
  const int c = blockIdx.x;
  float* buf = smem + warp * 2 * BUF;
  for (int idx = lane; idx < 2 * BUF; idx += 32) buf[idx] = 0.f;
  __syncwarp();

  const int32_t* sc = soc + (size_t)c * NS;
  const bool live = lane < M;
  const bool cv = cvalid[c] != 0;
  float* out = fwd ? A_in : Q_end;
  // the slot of step n: forward n, backward NS - 1 - n
  auto slot = [&](int n) { return fwd ? n : NS - 1 - n; };
  float x = live ? (fwd ? pi[lane] : 1.f) : 0.f;  // a (forward) or q (backward)
  double llc = 0.0;
  int s = sc[slot(0)];
  int s_next = NS > 1 ? sc[slot(1)] : -1;
  float lg = (fwd && s >= 0) ? logs[s] : 0.f;
  stage<SP>(buf, ops, s, M, lane);
  for (int n = 0; n < NS; ++n) {
    const float* cur = buf + (n & 1) * BUF;
    // the next step's slot id and log scale, and the operator after it,
    // are fetched a step ahead
    const int s_after = n + 2 < NS ? sc[slot(n + 2)] : -1;
    const float lg_next = (fwd && s_next >= 0) ? logs[s_next] : 0.f;
    stage<SP>(buf + ((n + 1) & 1) * BUF, ops, s_next, M, lane);
    cp_async_wait<1>();
    __syncwarp();
    if (s >= 0 && live) out[(size_t)s * M + lane] = x;
    float y = x;  // a padded slot is the identity
    if (s >= 0) {
      float acc = 0.f;
      if (fwd) {
#pragma unroll
        for (int j = 0; j < MB; ++j)
          acc = fmaf(cur[lane * SP + j], __shfl_sync(FULL, x, j), acc);
      } else {
#pragma unroll
        for (int i = 0; i < MB; ++i)
          acc = fmaf(cur[i * SP + lane], __shfl_sync(FULL, x, i), acc);
      }
      y = live ? acc : 0.f;
    }
    if (fwd) {
      const float csum = warp_sum(y);
      if (cv) llc += (double)(logf(csum) + lg);
      x = y / csum;
    } else {
      x = y / fmaxf(warp_max(y), TINY);
    }
    __syncwarp();  // every lane is done with `cur` before it is refilled
    s = s_next;
    s_next = s_after;
    lg = lg_next;
  }
  if (fwd && lane == 0) ll[c] = llc;
}

// ---------------------------------------------------------------------------
// K7: one warp per contig.  Per slot: V2_i = max_k (W[s][i][k] + V_k) with
// the first maximizing k as backpointer bp_i, then V = V2 - max_i V2; V
// starts at log pi.  Then the exit state is the first argmax of the final
// V, and walking back, exit[t] = state, state = bp[t][state], entry[t] =
// state.
// ---------------------------------------------------------------------------
template <int MB>
__global__ void __launch_bounds__(32) viterbi_boundary_kernel(
    const float* __restrict__ W, const float* __restrict__ logpi,
    const int32_t* __restrict__ soc, int NS, int M, int8_t* bp,
    int32_t* __restrict__ seg_entry, int32_t* __restrict__ seg_exit) {
  constexpr int SP = MB + 1;
  constexpr int BUF = ROWS * SP;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x;
  for (int idx = lane; idx < 2 * BUF; idx += 32) smem[idx] = 0.f;
  __syncwarp();

  const int32_t* sc = soc + (size_t)c * NS;
  int8_t* bc = bp + (size_t)c * NS * M;
  const bool live = lane < M;
  float V = live ? logpi[lane] : -INFINITY;
  int s = sc[0];
  int s_next = NS > 1 ? sc[1] : -1;
  stage<SP>(smem, W, s, M, lane);
  for (int n = 0; n < NS; ++n) {
    const float* cur = smem + (n & 1) * BUF;
    const int s_after = n + 2 < NS ? sc[n + 2] : -1;
    stage<SP>(smem + ((n + 1) & 1) * BUF, W, s_next, M, lane);
    cp_async_wait<1>();
    __syncwarp();
    // a padded slot's operator is the max-plus identity
    float best = (s >= 0 ? cur[lane * SP] : (lane == 0 ? 0.f : MP_NEG)) +
                 __shfl_sync(FULL, V, 0);
    int arg = 0;
#pragma unroll
    for (int k = 1; k < MB; ++k) {
      const float vk = __shfl_sync(FULL, V, k);
      if (k < M) {
        const float w = s >= 0 ? cur[lane * SP + k] : (lane == k ? 0.f : MP_NEG);
        const float x = w + vk;
        if (x > best) {  // strict: ties keep the first k
          best = x;
          arg = k;
        }
      }
    }
    const float V2 = live ? best : -INFINITY;
    const float mx = warp_max(V2);  // every lane takes part in the butterfly
    V = live ? V2 - mx : -INFINITY;
    if (live) bc[(size_t)n * M + lane] = (int8_t)arg;
    __syncwarp();  // every lane is done with `cur` before it is refilled
    s = s_next;
    s_next = s_after;
  }

  // the exit state of the last slot: the first maximal entry of V
  const float vmax = warp_max(V);
  const unsigned hit = __ballot_sync(FULL, live && V == vmax);
  int state = hit ? __ffs(hit) - 1 : 0;  // warp-uniform
  __syncwarp();  // the backpointers of every lane are visible to all
  for (int t0 = NS - 1; t0 >= 0; t0 -= TRACE_ROWS) {
    int row[TRACE_ROWS];
#pragma unroll
    for (int d = 0; d < TRACE_ROWS; ++d) {
      const int t = t0 - d;
      row[d] = (t >= 0 && live) ? bc[(size_t)t * M + lane] : 0;
    }
#pragma unroll
    for (int d = 0; d < TRACE_ROWS; ++d) {
      const int t = t0 - d;
      if (t >= 0) {
        const int st = sc[t];
        if (lane == 0 && st >= 0) seg_exit[st] = state;
        state = __shfl_sync(FULL, row[d], state);
        if (lane == 0 && st >= 0) seg_entry[st] = state;
      }
    }
  }
}

}  // namespace

extern "C" {

// ops (S, M, M), logs (S,), pi (M,) f32; soc (C, NS) int32; cvalid (C,)
// uint8.  Writes ll (C,) f64 and the listed rows of A_in, Q_end (S, M) f32.
int smcpp_boundary_scan(const float* ops, const float* logs, const float* pi,
                        const int32_t* soc, const uint8_t* cvalid, int C, int NS,
                        int M, double* ll, float* A_in, float* Q_end, void* stream) {
  if (M < 2 || M > 32 || C <= 0 || NS <= 0) return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  const size_t smem = sizeof(float) * 2 * 2 * ROWS * (size_t)(MBV + 1);
  cudaStream_t st = (cudaStream_t)stream;
  SMCPP_DISPATCH(MBV, {
    boundary_scan_kernel<MB_><<<C, 64, smem, st>>>(ops, logs, pi, soc, cvalid, NS, M, ll,
                                                   A_in, Q_end);
  });
  return (int)cudaGetLastError();
}

// W (S, M, M), logpi (M,) f32; soc (C, NS) int32; bp (C, NS, M) int8
// scratch.  Writes the listed entries of seg_entry, seg_exit (S,) int32.
int smcpp_viterbi_boundary(const float* W, const float* logpi, const int32_t* soc,
                           int C, int NS, int M, int8_t* bp, int32_t* seg_entry,
                           int32_t* seg_exit, void* stream) {
  if (M < 2 || M > 32 || C <= 0 || NS <= 0) return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  const size_t smem = sizeof(float) * 2 * ROWS * (size_t)(MBV + 1);
  cudaStream_t st = (cudaStream_t)stream;
  SMCPP_DISPATCH(MBV, {
    viterbi_boundary_kernel<MB_><<<C, 32, smem, st>>>(W, logpi, soc, NS, M, bp, seg_entry,
                                                      seg_exit);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
