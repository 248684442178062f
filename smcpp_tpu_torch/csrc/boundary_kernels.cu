// Per-contig boundary scans for NVIDIA Hopper (sm_90a), bound through a
// plain C interface (ctypes; see smcpp_tpu_torch/ops/_cuda.py).
//
//   K6 boundary_scan     replaces smcpp_tpu/ops/window_kernel.py:358
//                        contig_boundaries (the forward scan over the segment
//                        operators, which is also contig_scan, and the
//                        backward scan over their transposes)
//   K7 viterbi_boundary  replaces smcpp_tpu/ops/window_kernel.py:
//                        viterbi_boundary_states (the max-plus forward scan
//                        and its backtrace)
//
// What bounds them: serial depth.  The arithmetic (2 S M^2 operations) and
// the bytes (one read of the (S, M, M) operators) are tiny beside the chain
// of dependent steps, each an M x M matvec (K6) or max-plus matvec (K7)
// behind a warp reduction: a sequential scan walks a contig's NS segments
// in order, NS dependent steps on any card (and K7's backtrace NS more).
//
// Both are chunked scans.  K6 is three launches
// (ops/window_kernel.py:BoundaryScan):
// each contig's NS slots are cut into n_chunks chunk rows of c slots
// (boundary_plan: c a power of two near sqrt(NS)), so the depth is c +
// n_chunks + c steps in place of NS, and the grid is every chunk row in
// place of one block per contig.  The recursion normalizes at every step
// and every normalizer cancels, so a run of operators can be multiplied
// first (smcpp_tpu/ops/hmm.py:_tree_reduce and _scan_chunks do the same for
// the span kernel).
//
//   1 chunk_products   one block per chunk row, four warps (MB / 4 past MB
//                      = 16): the row's operators multiplied in genomic
//                      order, Pi <- P_t Pi from Pi = I, in f64 (M^3 FMA a
//                      step on the f64 CUDA cores; lane j of warp w owns
//                      column j of Pi in at most four of its rows, so a
//                      step reads Pi[k][j] once per k and a transposed f64
//                      copy of the operator, converted once a step, as
//                      double2 broadcasts), Pi in shared memory, scaled
//                      after each step by the power of two that puts its
//                      largest entry in [1, 2) (exact; the scale cancels
//                      in phase 2); the f32 operators come through a
//                      cp.async ring of P1_RING slots, the row's segment
//                      ids are loaded up front.  Padded slots are skipped.
//                      Writes Pi (rows, M, M) f64.
//   2 chunk_scan       one warp per (contig, direction) over the contig's
//                      n_chunks products, in f64: forward, record a as the
//                      chunk's entry vector, a <- Pi a / sum; backward, in
//                      reverse, record q as its exit vector, q <- Pi^T q /
//                      max(max, DBL_MIN).  Products are staged P2_RING - 1
//                      chunks ahead with cp.async (8 B a lane), the vector is
//                      broadcast through shared memory.  Writes the start
//                      vectors rounded to f32, (rows, M) each.
//   3 finish           the sequential scan, per chunk row: warp 0 of block r
//                      runs row r forward from its entry vector, warp 1
//                      backward from its exit vector, in f32 as the plain
//                      loop does.  Forward, per slot: record A_in[s] = a,
//                      then v = op[s] a, csum = sum v, ll += f64(log csum +
//                      logs[s]) (f32 add, then widened), a = v / csum.
//                      Backward: record Q_end[s] = q, then qn = op[s]^T q, q
//                      = qn / max(max qn, FLT_MIN).  Lane i owns state i; the
//                      next slot's operator is copied with cp.async (4 B a
//                      lane and instruction, one row across the lanes) into
//                      the warp's double buffer while the current step runs;
//                      a buffer holds 32 rows at the odd stride SP = MB + 1,
//                      so the forward's row reads and the backward's column
//                      reads are free of bank conflicts.  Each row's ll
//                      partial (masked by its contig's cvalid) goes to its
//                      own f64 slot; the wrapper sums them with one
//                      torch.sum.  With n_chunks == 1 phases 1-2 are skipped
//                      and phase 3 starts from pi and ones: the sequential
//                      scan of one warp per (contig, direction).
//
// Padded slots (segment id < 0, at a contig's tail or past it in its last
// chunk row) are the identity (K7: the max-plus identity) with log scale 0,
// as in the plain versions.  Segments that no contig lists are not written:
// the wrappers zero the outputs.  No atomics: two launches are
// bit-identical.
//
// K7 is the same chunked scan in max-plus, four launches
// (ops/window_kernel.py:ViterbiBoundary), on the chunk rows of
// boundary_plan:
//
//   1 vb_products      chunk_products_kernel<MB, true>: the row's max-plus
//                      product Pi'[i][j] = max_k (W_t[i][k] + Pi[k][j]) in
//                      genomic order from the max-plus identity (0 on the
//                      diagonal, -inf off it), in f64; no scaling (f64 holds
//                      a chunk's sums, sentinels included).  A max-plus
//                      product rounds only in its adds, so its value does
//                      not depend on the order of the maxima.
//   2 vb_chunk_scan    chunk_scan_kernel<MB, true>: one warp per contig,
//                      from log pi: record x as the chunk's entry vector,
//                      then x <- Pi (x) x, x <- x - max x, in f64.  Writes the
//                      entry vectors rounded to f32, (rows, M).
//   3 vb_forward       one warp per chunk row, from its entry vector: the
//                      sequential f32 step below over the row's c slots,
//                      writing the (rows c, M) int8 backpointers; lane i
//                      also follows its state back to the row's start
//                      (m_i <- m[bp_i], a shuffle beside the step), which
//                      gives the row's exit -> entry map exactly.  The
//                      contig's last row writes the first argmax of its
//                      final V, the contig's exit state.
//   4 vb_trace         one warp per chunk row: from the contig's exit state
//                      back through the later rows' maps (eight at once,
//                      one byte a lane, followed by shuffle) to this row's
//                      exit state, then the backtrace of its c slots, and
//                      each listed segment's entry and exit state.
//
// The step (phase 3): V2_i = max_k (W[s][i][k] + V_k) with the first
// maximizing k as backpointer, then V = V2 - max_i V2: f32 adds and maxima,
// as in viterbi_boundary_states_plain, and the first maximizing entry state
// on ties (torch.max's rule).  Only the entry vectors differ from the
// sequential loop (one f32 rounding of an f64 scan), so K7 equals its
// chunked twin viterbi_boundary_states_chunked_plain bit for bit; with
// n_chunks == 1 phases 1-2 are skipped, the entry is log pi and K7 is the
// sequential loop.

#include "common.cuh"

#include <float.h>

using namespace smcpp;

namespace {

constexpr int ROWS = 32;     // rows of a staged operator: one per lane
constexpr int TRACE_ROWS = 8;  // backpointer rows loaded at once by K7's backtrace
// phase 1: warps per chunk row, each owning MB / warps rows of Pi (at most 4)
__host__ __device__ constexpr int p1_warps(int MB) { return MB > 16 ? MB / 4 : 4; }
constexpr int P1_RING = 4;       // phase 1: operator slots in flight
constexpr int P2_RING = 4;       // phase 2: chunk products in flight

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
// K6 phase 1: block r forms chunk row r's product Pi = P_{c-1} ... P_0 in
// f64, rescaled by a power of two after every step (MAXPLUS, K7 phase 1:
// the max-plus product, from the max-plus identity, unscaled).  Each staged f32
// operator is converted once into an f64 copy laid out [k][i] (transposed)
// at row stride OS = MB + 2 (16-byte rows, and the conversion's column
// stores 2-way rather than 32-way bank conflicts); then lane j of warp w
// owns column j of Pi in rows w RPW .. w RPW + RPW - 1, so a step reads
// Pi[k][j] once per k and the copy's column k of those rows as double2
// broadcasts.  Rows and columns past M stay zero in the copy, and in Pi
// (-inf in max-plus, so that they never win a maximum).
// ---------------------------------------------------------------------------
template <int MB, bool MAXPLUS>
__global__ void __launch_bounds__(32 * p1_warps(MB)) chunk_products_kernel(
    const float* __restrict__ ops, const int32_t* __restrict__ rows, int c, int M,
    double* __restrict__ prod) {
  constexpr int NW = p1_warps(MB);
  constexpr int RPW = MB / NW;  // rows of Pi per warp: 1 .. 4
  constexpr int NT = 32 * NW;
  constexpr int NE = (MB * MB + NT - 1) / NT;  // operator entries per thread
  constexpr int OS = MB + 2;                   // row stride of the f64 copy
  extern __shared__ double smem_d[];
  double* P = smem_d;                           // Pi, MB x MB, row stride MB
  double* opT = P + MB * MB;                    // the step's operator, f64, [k][i]
  float* ring = (float*)(opT + MB * OS);        // P1_RING operators, f32, as stored
  int* ids = (int*)(ring + P1_RING * MB * MB);  // the row's c segment ids
  __shared__ double wmax[NW];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int MM = M * M;
  const int j = lane < MB ? lane : MB - 1;  // lanes past MB repeat a column, unused
  const int i0 = warp * RPW;
  // the thread's operator entries e = tid + NT q and their places in opT
  int tr[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int e = tid + NT * q, i = e / M;
    tr[q] = e < MM ? (e - i * M) * OS + i : -1;
  }
  const int32_t* rs = rows + (size_t)blockIdx.x * c;
  for (int t = tid; t < c; t += NT) ids[t] = rs[t];
  const double ONE = MAXPLUS ? 0.0 : 1.0, ZERO = MAXPLUS ? -INFINITY : 0.0;
  for (int e = tid; e < MB * MB; e += NT) {
    const int i = e / MB;
    P[e] = (i == e - i * MB && i < M) ? ONE : ZERO;
  }
  for (int e = tid; e < MB * OS; e += NT) opT[e] = 0.0;
  __syncthreads();

  auto stage1 = [&](int t) {
    if (t < c && ids[t] >= 0) {
      const float* src = ops + (size_t)ids[t] * MM;
      float* dst = ring + (t % P1_RING) * MB * MB;
#pragma unroll
      for (int q = 0; q < NE; ++q)
        if (tr[q] >= 0) cp_async4(dst + tid + NT * q, src + tid + NT * q);
    }
    cp_async_commit();
  };
  for (int t = 0; t < P1_RING - 1; ++t) stage1(t);
  for (int t = 0; t < c; ++t) {
    stage1(t + P1_RING - 1);
    cp_async_wait<P1_RING - 1>();
    if (ids[t] >= 0) {  // block-uniform
      const float* op = ring + (t % P1_RING) * MB * MB;
#pragma unroll
      for (int q = 0; q < NE; ++q)
        if (tr[q] >= 0) opT[tr[q]] = (double)op[tid + NT * q];  // this thread's own copies
      __syncthreads();  // opT is whole
      // acc[r] <- acc[r] + o pk, or max(acc[r], o + pk) in max-plus
      auto step = [](double o, double pk, double acc) {
        return MAXPLUS ? fmax(acc, o + pk) : fma(o, pk, acc);
      };
      double acc[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) acc[r] = ZERO;
#pragma unroll
      for (int k = 0; k < MB; ++k) {
        const double pk = P[k * MB + j];
        const double* o = opT + k * OS + i0;
        if constexpr (RPW % 2 == 0) {
#pragma unroll
          for (int r = 0; r < RPW; r += 2) {
            const double2 v = *reinterpret_cast<const double2*>(o + r);
            acc[r] = step(v.x, pk, acc[r]);
            acc[r + 1] = step(v.y, pk, acc[r + 1]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < RPW; ++r) acc[r] = step(o[r], pk, acc[r]);
        }
      }
      double scale = 1.0;
      if constexpr (MAXPLUS) {
        __syncthreads();  // every thread has read Pi and opT
      } else {
        double mx = 0.0;
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          if (lane < M && i0 + r < M) mx = fmax(mx, fabs(acc[r]));
        mx = warp_max(mx);
        if (lane == 0) wmax[warp] = mx;
        __syncthreads();  // every thread has read Pi and opT and posted its maximum
#pragma unroll
        for (int w = 0; w < NW; ++w) mx = fmax(mx, wmax[w]);
        int ex;
        frexp(mx, &ex);  // mx = f 2^ex, f in [0.5, 1): scaled, it lies in [1, 2)
        scale = ldexp(1.0, 1 - ex);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        if (lane < M && i0 + r < M)
          P[(i0 + r) * MB + lane] = MAXPLUS ? acc[r] : acc[r] * scale;
    }
    __syncthreads();  // Pi is written and slot t is free before it is refilled
  }
  double* out = prod + (size_t)blockIdx.x * MM;
  for (int e = tid; e < MM; e += NT) {
    const int i = e / M;
    out[e] = P[i * MB + e - i * M];
  }
}

// ---------------------------------------------------------------------------
// K6 phase 2: block (contig, direction) of one warp scans the contig's
// n_chunks products in f64 and writes each chunk's start vector in f32.
// MAXPLUS (K7 phase 2): forward only, from log pi (``pi``), x <- Pi (x) x
// then x <- x - max x; lanes past M hold -inf.
// ---------------------------------------------------------------------------
template <int MB, bool MAXPLUS>
__global__ void __launch_bounds__(32) chunk_scan_kernel(
    const double* __restrict__ prod, const float* __restrict__ pi, int n_chunks, int M,
    float* __restrict__ start_a, float* __restrict__ start_q) {
  constexpr int SP = MB + 1;  // odd row stride: row reads are free of bank conflicts
  constexpr int BUF = ROWS * SP;  // every lane reads a row; rows past M stay zero
  extern __shared__ double smem_d[];
  double* ring = smem_d;             // P2_RING products
  double* xs = ring + P2_RING * BUF;  // the scanned vector, for broadcast
  const int lane = threadIdx.x;
  const bool fwd = blockIdx.y == 0;
  const bool live = lane < M;
  for (int idx = lane; idx < P2_RING * BUF; idx += 32) ring[idx] = 0.0;
  __syncwarp();

  const size_t base = (size_t)blockIdx.x * n_chunks;
  float* out = fwd ? start_a : start_q;
  auto chunk = [&](int n) { return base + (fwd ? n : n_chunks - 1 - n); };
  auto stage2 = [&](int n) {
    if (n < n_chunks && live) {
      const double* src = prod + chunk(n) * M * M + lane;
      double* dst = ring + (n % P2_RING) * BUF + lane;
      for (int i = 0; i < M; ++i) cp_async8(dst + i * SP, src + (size_t)i * M);
    }
    cp_async_commit();
  };
  double x = live ? (fwd ? (double)pi[lane] : 1.0) : (MAXPLUS ? -INFINITY : 0.0);
  for (int n = 0; n < P2_RING - 1; ++n) stage2(n);
  for (int n = 0; n < n_chunks; ++n) {
    stage2(n + P2_RING - 1);
    cp_async_wait<P2_RING - 1>();
    if (live) out[chunk(n) * M + lane] = (float)x;
    xs[lane] = x;
    __syncwarp();
    const double* p = ring + (n % P2_RING) * BUF;
    double acc0 = MAXPLUS ? -INFINITY : 0.0, acc1 = acc0;  // two dependent chains
    if constexpr (MAXPLUS) {
#pragma unroll
      for (int j = 0; j < MB; j += 2) {
        acc0 = fmax(acc0, p[lane * SP + j] + xs[j]);
        acc1 = fmax(acc1, p[lane * SP + j + 1] + xs[j + 1]);
      }
    } else if (fwd) {
#pragma unroll
      for (int j = 0; j < MB; j += 2) {
        acc0 = fma(p[lane * SP + j], xs[j], acc0);
        acc1 = fma(p[lane * SP + j + 1], xs[j + 1], acc1);
      }
    } else {
#pragma unroll
      for (int i = 0; i < MB; i += 2) {
        acc0 = fma(p[i * SP + lane], xs[i], acc0);
        acc1 = fma(p[(i + 1) * SP + lane], xs[i + 1], acc1);
      }
    }
    if constexpr (MAXPLUS) {
      const double y = live ? fmax(acc0, acc1) : -INFINITY;
      x = y - warp_max(y);
    } else {
      const double y = live ? acc0 + acc1 : 0.0;
      x = fwd ? y / warp_sum(y) : y / fmax(warp_max(y), DBL_MIN);
    }
    __syncwarp();  // every lane is done with the product and xs before refills
  }
}

// ---------------------------------------------------------------------------
// K6 phase 3: warp 0 of block r runs chunk row r forward from start_a[r],
// warp 1 backward from start_q[r] (the header's step), and the forward
// writes the row's ll partial, masked by cvalid of contig r / n_chunks.
// ---------------------------------------------------------------------------
template <int MB>
__global__ void __launch_bounds__(64) boundary_finish_kernel(
    const float* __restrict__ ops, const float* __restrict__ logs,
    const int32_t* __restrict__ rows, const uint8_t* __restrict__ cvalid,
    const float* __restrict__ start_a, const float* __restrict__ start_q, int c,
    int n_chunks, int M, double* __restrict__ ll, float* __restrict__ A_in,
    float* __restrict__ Q_end) {
  constexpr int SP = MB + 1;
  constexpr int BUF = ROWS * SP;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool fwd = warp == 0;
  const int r = blockIdx.x;
  float* buf = smem + warp * 2 * BUF;
  for (int idx = lane; idx < 2 * BUF; idx += 32) buf[idx] = 0.f;
  __syncwarp();

  const int32_t* sc = rows + (size_t)r * c;
  const bool live = lane < M;
  const bool cv = cvalid[r / n_chunks] != 0;
  float* out = fwd ? A_in : Q_end;
  // the slot of step n: forward n, backward c - 1 - n
  auto slot = [&](int n) { return fwd ? n : c - 1 - n; };
  float x = live ? (fwd ? start_a : start_q)[(size_t)r * M + lane] : 0.f;  // a or q
  double llc = 0.0;
  int s = sc[slot(0)];
  int s_next = c > 1 ? sc[slot(1)] : -1;
  float lg = (fwd && s >= 0) ? logs[s] : 0.f;
  stage<SP>(buf, ops, s, M, lane);
  for (int n = 0; n < c; ++n) {
    const float* cur = buf + (n & 1) * BUF;
    // the next step's slot id and log scale, and the operator after it,
    // are fetched a step ahead
    const int s_after = n + 2 < c ? sc[slot(n + 2)] : -1;
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
  if (fwd && lane == 0) ll[r] = llc;
}

// ---------------------------------------------------------------------------
// K7 phase 3: warp r runs chunk row r from its entry vector.  Per slot:
// V2_i = max_k (W[s][i][k] + V_k) with the first maximizing k as backpointer
// bp_i, then V = V2 - max_i V2, and m_i = m[bp_i] (m starts as the
// identity, so it ends as the row's exit -> entry map).  The contig's last
// row writes the first argmax of its final V: the contig's exit state.
// ---------------------------------------------------------------------------
template <int MB>
__global__ void __launch_bounds__(32) vb_forward_kernel(
    const float* __restrict__ W, const float* __restrict__ entry,
    const int32_t* __restrict__ rows, int c, int n_chunks, int M,
    int8_t* __restrict__ bp, int8_t* __restrict__ maps, int32_t* __restrict__ cexit) {
  constexpr int SP = MB + 1;
  constexpr int BUF = ROWS * SP;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  for (int idx = lane; idx < 2 * BUF; idx += 32) smem[idx] = 0.f;
  __syncwarp();

  const int32_t* sc = rows + (size_t)r * c;
  int8_t* br = bp + (size_t)r * c * M;
  const bool live = lane < M;
  float V = live ? entry[(size_t)r * M + lane] : -INFINITY;
  int m = lane;  // the state at the row's start that state `lane` came from
  int s = sc[0];
  int s_next = c > 1 ? sc[1] : -1;
  stage<SP>(smem, W, s, M, lane);
  for (int n = 0; n < c; ++n) {
    const float* cur = smem + (n & 1) * BUF;
    const int s_after = n + 2 < c ? sc[n + 2] : -1;
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
    m = __shfl_sync(FULL, m, arg);  // arg < M on every lane
    if (live) br[(size_t)n * M + lane] = (int8_t)arg;
    __syncwarp();  // every lane is done with `cur` before it is refilled
    s = s_next;
    s_next = s_after;
  }
  if (live) maps[(size_t)r * M + lane] = (int8_t)m;
  if (r % n_chunks == n_chunks - 1) {  // the contig's last row (warp-uniform)
    const float vmax = warp_max(V);
    const unsigned hit = __ballot_sync(FULL, live && V == vmax);
    if (lane == 0) cexit[r / n_chunks] = hit ? __ffs(hit) - 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K7 phase 4: warp r walks from its contig's exit state back through the
// maps of the contig's later rows to row r's exit state, then back through
// the row's c backpointer rows: exit[t] = state, state = bp[t][state],
// entry[t] = state.  Both walks load TRACE_ROWS rows at once, one byte a
// lane, and follow the state with a shuffle, so the dependent chain is a
// shuffle and not a load.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32) vb_trace_kernel(
    const int32_t* __restrict__ rows, const int8_t* __restrict__ bp,
    const int8_t* __restrict__ maps, const int32_t* __restrict__ cexit, int c,
    int n_chunks, int M, int32_t* __restrict__ seg_entry,
    int32_t* __restrict__ seg_exit) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  const int k = r % n_chunks;
  const bool live = lane < M;
  const int8_t* mc = maps + (size_t)(r - k) * M;  // the contig's first row's map
  int state = cexit[r / n_chunks];  // warp-uniform
  for (int n0 = n_chunks - 1; n0 > k; n0 -= TRACE_ROWS) {
    int row[TRACE_ROWS];
#pragma unroll
    for (int d = 0; d < TRACE_ROWS; ++d) {
      const int n = n0 - d;
      row[d] = (n > k && live) ? mc[(size_t)n * M + lane] : 0;
    }
#pragma unroll
    for (int d = 0; d < TRACE_ROWS; ++d)
      if (n0 - d > k) state = __shfl_sync(FULL, row[d], state);
  }
  const int32_t* sc = rows + (size_t)r * c;
  const int8_t* br = bp + (size_t)r * c * M;
  for (int t0 = c - 1; t0 >= 0; t0 -= TRACE_ROWS) {
    int row[TRACE_ROWS];
#pragma unroll
    for (int d = 0; d < TRACE_ROWS; ++d) {
      const int t = t0 - d;
      row[d] = (t >= 0 && live) ? br[(size_t)t * M + lane] : 0;
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

// K6 phase 1, and K7 phase 1 (maxplus != 0).  ops (S, M, M) f32; rows (R,
// c) int32 segment ids (-1: padded).  Writes prod (R, M, M) f64.
int smcpp_boundary_products(const float* ops, const int32_t* rows, int R, int c, int M,
                            int maxplus, double* prod, void* stream) {
  if (M < 2 || M > 32 || R <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  cudaStream_t st = (cudaStream_t)stream;
  SMCPP_DISPATCH(MBV, {
    const size_t smem = sizeof(double) * MB_ * (2 * MB_ + 2) +
                        sizeof(float) * P1_RING * MB_ * MB_ + sizeof(int) * (size_t)c;
    auto k = maxplus ? chunk_products_kernel<MB_, true> : chunk_products_kernel<MB_, false>;
    const int e = prepare(k, smem);  // a long forced chunk
    if (e) return e;
    k<<<R, 32 * p1_warps(MB_), smem, st>>>(ops, rows, c, M, prod);
  });
  return (int)cudaGetLastError();
}

// K6 phase 2.  prod (C n_chunks, M, M) f64; pi (M,) f32.  Writes start_a,
// start_q (C n_chunks, M) f32.  K7 phase 2 (maxplus != 0): pi is log pi,
// and only start_a (the entry vectors) is written.
int smcpp_boundary_chunk_scan(const double* prod, const float* pi, int C, int n_chunks,
                              int M, int maxplus, float* start_a, float* start_q,
                              void* stream) {
  if (M < 2 || M > 32 || C <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  cudaStream_t st = (cudaStream_t)stream;
  SMCPP_DISPATCH(MBV, {
    const size_t smem = sizeof(double) * (P2_RING * ROWS * (MB_ + 1) + 32);
    if (maxplus)
      chunk_scan_kernel<MB_, true><<<dim3(C, 1), 32, smem, st>>>(prod, pi, n_chunks, M,
                                                                start_a, start_q);
    else
      chunk_scan_kernel<MB_, false><<<dim3(C, 2), 32, smem, st>>>(prod, pi, n_chunks, M,
                                                                 start_a, start_q);
  });
  return (int)cudaGetLastError();
}

// K6 phase 3.  ops (S, M, M), logs (S,) f32; rows (R, c) int32; cvalid
// (R / n_chunks,) uint8; start_a, start_q (R, M) f32.  Writes ll (R,) f64
// and the listed rows of A_in, Q_end (S, M) f32.
int smcpp_boundary_finish(const float* ops, const float* logs, const int32_t* rows,
                          const uint8_t* cvalid, const float* start_a,
                          const float* start_q, int R, int c, int n_chunks, int M,
                          double* ll, float* A_in, float* Q_end, void* stream) {
  if (M < 2 || M > 32 || R <= 0 || c <= 0 || n_chunks <= 0 || R % n_chunks)
    return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  const size_t smem = sizeof(float) * 2 * 2 * ROWS * (size_t)(MBV + 1);
  cudaStream_t st = (cudaStream_t)stream;
  SMCPP_DISPATCH(MBV, {
    boundary_finish_kernel<MB_><<<R, 64, smem, st>>>(ops, logs, rows, cvalid, start_a,
                                                     start_q, c, n_chunks, M, ll, A_in,
                                                     Q_end);
  });
  return (int)cudaGetLastError();
}

// K7 phase 3.  W (S, M, M) f32; entry (R, M) f32; rows (R, c) int32.
// Writes bp (R c, M) int8, maps (R, M) int8 and cexit (R / n_chunks,) int32.
int smcpp_viterbi_boundary_forward(const float* W, const float* entry,
                                   const int32_t* rows, int R, int c, int n_chunks,
                                   int M, int8_t* bp, int8_t* maps, int32_t* cexit,
                                   void* stream) {
  if (M < 2 || M > 32 || R <= 0 || c <= 0 || n_chunks <= 0 || R % n_chunks)
    return (int)cudaErrorInvalidValue;
  const int MBV = padded(M);
  const size_t smem = sizeof(float) * 2 * ROWS * (size_t)(MBV + 1);
  cudaStream_t st = (cudaStream_t)stream;
  SMCPP_DISPATCH(MBV, {
    vb_forward_kernel<MB_><<<R, 32, smem, st>>>(W, entry, rows, c, n_chunks, M, bp, maps,
                                                cexit);
  });
  return (int)cudaGetLastError();
}

// K7 phase 4.  rows (R, c) int32; bp (R c, M), maps (R, M) int8; cexit (R /
// n_chunks,) int32.  Writes the listed entries of seg_entry, seg_exit (S,)
// int32.
int smcpp_viterbi_boundary_trace(const int32_t* rows, const int8_t* bp,
                                 const int8_t* maps, const int32_t* cexit, int R, int c,
                                 int n_chunks, int M, int32_t* seg_entry,
                                 int32_t* seg_exit, void* stream) {
  if (M < 2 || M > 32 || R <= 0 || c <= 0 || n_chunks <= 0 || R % n_chunks)
    return (int)cudaErrorInvalidValue;
  vb_trace_kernel<<<R, 32, 0, (cudaStream_t)stream>>>(rows, bp, maps, cexit, c, n_chunks,
                                                       M, seg_entry, seg_exit);
  return (int)cudaGetLastError();
}

}  // extern "C"
