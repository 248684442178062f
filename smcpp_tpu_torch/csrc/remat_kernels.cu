// Alpha remat's descending half for NVIDIA Hopper (sm_90a), bound through a
// plain C interface (ctypes; see smcpp_tpu_torch/ops/_cuda.py).
//
//   K8 remat_sweep  replaces the descending half of the alpha_remat branch of
//                   smcpp_tpu/ops/window_kernel.py:stats_pass (:585-613):
//                   for each block of windows, from the last, the block's
//                   alphas recomputed from its snapshot (the carry entering
//                   it, rounded to the carry dtype) and the descending beta
//                   steps over them, accumulating xisum and the per-key
//                   posterior masses
//
// K1's snapshot launch (window_kernels.cu) writes the snapshots; K8 then does
// the rest of the pass in one launch.  It computes what
// window_kernel.stats_pass_remat_plain computes after the snapshot sweep.
//
// What bounds it: per valid window, the recompute's M^2 FMA (K1's, on the f64
// tensor cores) and the descent's 2 M^2 (T u and the xisum outer product) and
// M^2 f64 adds; the bytes (keys, flags, snapshots) are few.  Every segment is
// a chain of L dependent steps in each direction.  On the H100 the f64
// tensor cores bind it: a window of a tile takes 1.94 sweeps of K1's 8
// m16n8k16 f64 tiles (M = 32) and 8 more for T u, about 120 cycles of a
// sub-partition each (PERF.md).
//
// Design: one block of two warps per tile of 16 segments, persistent over
// the L / blk blocks of windows, the last first.
// - One warp, the producer, recomputes the tile's alphas with K1's step
//   (asc_step.cuh: the 16 segments as the rows of an m16n8k16 f64 tile, f32
//   carry, asc_div quotients, each stream entry rounded to the carry dtype),
//   so every recomputed entry has K1's bits.  A block is cut into chunks of
//   REMAT_CW windows.  The step renormalises every window, so a chunk
//   restarted from its f32 entry carry gives the block sweep's bits: for each
//   block the producer walks chunks 0 ... nc - 2 from the snapshot, keeping
//   each chunk's entry carry (lane-private f32, in a per-tile scratch of
//   global memory that stays in L2: 2 KB a chunk at M = 32, two blocks'
//   worth), then recomputes the chunks from the last, each from its carry,
//   into a ring of two slots in shared memory.  The carry walks of block b -
//   1 are interleaved with the ring walks of block b, one after each ring
//   chunk (Walk), so the consumer does not wait while the next block's
//   carries are swept.  In the ring each lane writes its own 4 NN entries a
//   window (16-byte pieces, lane-major), and the window's 16 keys, or -1 for
//   an invalid window.  So the block's stream never reaches device memory,
//   and the recompute costs 1 + (nc - 1) / nc sweeps (1.9375 at blk = 128).
//   Slots of 8 windows keep a block's shared memory at 37 KB (bf16) and 52
//   KB (f32) at M = 32 and 63 keys, so four blocks (eight warps, 254
//   registers a thread) are resident on an SM.
// - The other, the consumer, descends the ring's chunks in the same tile
//   layout: lane (g, t) owns rows g and g + 8 and columns 8n + 2t + c, the
//   layout in which the producer wrote them.  T u for the 16 segments is one
//   product U T^T on the f64 tensor cores with K1's permuted contraction
//   index (the step's u is the next step's A operand, no shuffle; T^T's
//   fragments in registers); Z = sum(alpha q) and max(q) are the lane's
//   entries, then two shuffles, for all 16 segments; q's quotients are
//   asc_div's, gamma and a / Z the products with the row's reciprocal.
// - The handover is a named barrier per slot and chunk, never per step:
//   FULL (producer arrives, consumer waits) and EMPTY (consumer arrives,
//   producer waits before refilling), 64 threads each.
// - xisum and gsum are off the step's chain.  Each step writes its gamma, a /
//   Z (zero where the window or its successor is invalid) and the old u of
//   the 16 rows into shared memory and issues the next window's T u; while
//   the tensor cores run it, xisum's step term, sum over the 16 segments of
//   (a/Z)^T u, is formed on the CUDA cores, each lane an RJ x CI block of
//   it in f32 over a chunk, then added in f64 into the block's partial in
//   global memory (as K2 sums 32 windows in f32, then adds in f64); gsum's
//   lane j walks the 16 rows, sums each run of rows with equal keys in f32
//   in row order, and adds llrint(run 2^40) into the block's slice of the
//   64-bit fixed-point partials (K2's fixed point; a native integer
//   reduction in global memory, so the sum does not depend on the order in
//   which blocks add).  Per step the tensor cores then carry T u alone,
//   where xisum's product on them had doubled the consumer's share, and gsum
//   converts a run where K2 converts each row's term: each of the two cost a
//   fifth to a third of K8's time (tools/k8_ablation.py, PERF.md).  The
//   emission table sits in shared memory when it fits beside the ring (227
//   KB), else in global memory (common.cuh).
// - The emission table is staged once and the beta carries (q, u) stay in
//   registers across the blocks of windows; the xisum partials and the gsum
//   slices are zeroed by the wrapper, which sums and converts them.
//
// Arithmetic against K2 and the plain pass: T u is summed in f64 from exact
// products and rounded once, where K2's FMA chain sums in f32 in state
// order; xisum sums a chunk of windows over the tile's 16 segments in f32
// (128 terms), where K2 sums 32 windows of one segment; gsum rounds the f32
// sum of a run of the tile's rows, where K2 rounds each row's term; Z is the
// lane's four (eight) products, then a butterfly.  So K8 agrees with
// stats_pass_remat_plain (and K2) within K2's tolerances, not bit for bit;
// xisum and gsum are summed in an order fixed by (S, L, M), so two launches
// are bit-identical.

#include "asc_step.cuh"

using namespace smcpp;

namespace {

constexpr int REMAT_CW = 8;  // windows a ring slot holds (window_kernel.REMAT_CHUNK)
// 2^40: gsum's fixed point (window_kernel.GSUM_FRAC_BITS, K2's FIX_SCALE)
constexpr float FIX_SCALE = 1099511627776.0f;

// The producer's double buffer of staged keys and valid flags for the 16
// rows of a chunk (2048 bytes).  Rows g = 0..7 start at words 12g mod 32
// (keys) and 4g (flags): 8 distinct banks.
struct RematStage {
  int32_t key[2][ASC_ROWS][12];
  uint8_t v[2][ASC_ROWS][16];
};

// Byte offsets of a block's dynamic shared memory: the producer's staged
// keys and flags, the ring's two slots (each REMAT_CW windows of 32 lanes'
// entries, then REMAT_CW x 16 keys), the consumer's three 16-row f32
// buffers (gamma, a / Z, the old u; rows of MB + 8), then, with `table`,
// the padded emission table.
struct RematLayout {
  size_t lane_bytes, slot_stream, slot, ring, trans, etab, total;
  __host__ __device__ RematLayout(int MB, int n_keys, int elt, bool table) {
    lane_bytes = (size_t)(MB / 2) * elt;  // 4 NN entries
    slot_stream = (size_t)REMAT_CW * 32 * lane_bytes;
    slot = slot_stream + (size_t)REMAT_CW * ASC_ROWS * 4;
    ring = sizeof(RematStage);
    trans = ring + 2 * slot;
    etab = trans + (size_t)3 * ASC_ROWS * (MB + 8) * 4;
    total = etab + (table ? (size_t)n_keys * (MB + ASC_EPAD) * 4 : 0);
  }
};

// Stage windows [l0, l0 + n), n <= REMAT_CW, of rows s0 ... into buffer b
// as one cp.async group: keys 4 bytes a copy, flags 4 windows a copy where
// vec (L a multiple of 4, every chunk REMAT_CW windows from a multiple of
// REMAT_CW), else plain loads.  Rows past S are never staged.
__device__ __forceinline__ void remat_stage(RematStage& st, int b,
                                            const int32_t* __restrict__ keys,
                                            const uint8_t* __restrict__ valid, int s0, int S,
                                            int L, int l0, int n, bool vec, int lane) {
  const int rows = min(ASC_ROWS, S - s0);
  for (int idx = lane; idx < rows * REMAT_CW; idx += 32) {
    const int r = idx / REMAT_CW, c = idx % REMAT_CW;
    if (c < n) cp_async4(&st.key[b][r][c], keys + (size_t)(s0 + r) * L + l0 + c);
  }
  if (vec) {
    for (int idx = lane; idx < rows * (REMAT_CW / 4); idx += 32) {
      const int r = idx / (REMAT_CW / 4), p = idx % (REMAT_CW / 4);
      cp_async4(&st.v[b][r][4 * p], valid + (size_t)(s0 + r) * L + l0 + 4 * p);
    }
  } else {
    for (int idx = lane; idx < rows * REMAT_CW; idx += 32) {
      const int r = idx / REMAT_CW, c = idx % REMAT_CW;
      if (c < n) st.v[b][r][c] = valid[(size_t)(s0 + r) * L + l0 + c];
    }
  }
  cp_async_commit();
}

// The ring's named barriers (ids 1-4, 64 threads: both warps), by slot.
__device__ __forceinline__ void full_sync(int slot) {
  if (slot == 0) asm volatile("bar.sync 1, 64;\n" ::: "memory");
  else asm volatile("bar.sync 2, 64;\n" ::: "memory");
}
__device__ __forceinline__ void full_arrive(int slot) {
  if (slot == 0) asm volatile("bar.arrive 1, 64;\n" ::: "memory");
  else asm volatile("bar.arrive 2, 64;\n" ::: "memory");
}
__device__ __forceinline__ void empty_sync(int slot) {
  if (slot == 0) asm volatile("bar.sync 3, 64;\n" ::: "memory");
  else asm volatile("bar.sync 4, 64;\n" ::: "memory");
}
__device__ __forceinline__ void empty_arrive(int slot) {
  if (slot == 0) asm volatile("bar.arrive 3, 64;\n" ::: "memory");
  else asm volatile("bar.arrive 4, 64;\n" ::: "memory");
}

// A lane's 4 NN entries of a window in the ring: 32-bit words (bf16 pairs or
// floats) in 16-byte pieces, piece p of window w at ((w P + p) 32 + lane) 16.
template <int NN, bool BF16>
struct Ring {
  static constexpr int WORDS = BF16 ? 2 * NN : 4 * NN;
  static constexpr int P = WORDS / 4;

  static __device__ __forceinline__ void put(unsigned char* slot, int w, int lane,
                                             const float (&x)[2][NN][2]) {
    uint32_t wd[WORDS];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        if constexpr (BF16) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(x[m][n][0], x[m][n][1]);
          wd[m * NN + n] = *reinterpret_cast<const uint32_t*>(&v);
        } else {
          wd[2 * (m * NN + n)] = __float_as_uint(x[m][n][0]);
          wd[2 * (m * NN + n) + 1] = __float_as_uint(x[m][n][1]);
        }
      }
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint4*>(slot + ((size_t)(w * P + p) * 32 + lane) * 16) =
          make_uint4(wd[4 * p], wd[4 * p + 1], wd[4 * p + 2], wd[4 * p + 3]);
  }

  static __device__ __forceinline__ void get(const unsigned char* slot, int w, int lane,
                                             float (&x)[2][NN][2]) {
    uint32_t wd[WORDS];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(slot + ((size_t)(w * P + p) * 32 + lane) * 16);
      wd[4 * p] = v.x;
      wd[4 * p + 1] = v.y;
      wd[4 * p + 2] = v.z;
      wd[4 * p + 3] = v.w;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        if constexpr (BF16) {
          const uint32_t u = wd[m * NN + n];
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
          x[m][n][0] = __low2float(v);
          x[m][n][1] = __high2float(v);
        } else {
          x[m][n][0] = __uint_as_float(wd[2 * (m * NN + n)]);
          x[m][n][1] = __uint_as_float(wd[2 * (m * NN + n) + 1]);
        }
      }
  }
};

// A lane's f32 carry entries to or from the chunk-entry scratch (lane-private,
// 4 NN floats as NN float4).
template <int NN>
__device__ __forceinline__ void carry_put(float* p, const float (&X)[2][NN][2]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < NN / 2; ++h)
      reinterpret_cast<float4*>(p)[m * (NN / 2) + h] =
          make_float4(X[m][2 * h][0], X[m][2 * h][1], X[m][2 * h + 1][0], X[m][2 * h + 1][1]);
}

template <int NN>
__device__ __forceinline__ void carry_get(const float* p, float (&X)[2][NN][2]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < NN / 2; ++h) {
      const float4 v = reinterpret_cast<const float4*>(p)[m * (NN / 2) + h];
      X[m][2 * h][0] = v.x;
      X[m][2 * h][1] = v.y;
      X[m][2 * h + 1][0] = v.z;
      X[m][2 * h + 1][1] = v.w;
    }
}

// The producer's w-th walk over one chunk of REMAT_CW windows: first the
// carry walks of the last block (its chunks 0 ... nc - 2), then for each
// block from the last its ring walks (chunks nc - 1 ... 0), each but the last
// followed by one carry walk of the block before it, so that the next
// block's carries are swept while this block's chunks are descended.
struct Walk {
  int bi, k, l0, n;
  bool ring;
  __device__ __forceinline__ Walk(int w, int NB, int nc, int blk) {
    const int per = 2 * nc - 1;
    if (w < nc - 1) {
      bi = NB - 1;
      k = w;
      ring = false;
    } else {
      const int v = w - (nc - 1), q = v / per, rr = v % per;
      bi = NB - 1 - q;
      ring = q == NB - 1 || rr % 2 == 0;
      if (q == NB - 1) {
        k = nc - 1 - rr;
      } else if (ring) {
        k = nc - 1 - rr / 2;
      } else {
        bi -= 1;
        k = (rr - 1) / 2;
      }
    }
    l0 = bi * blk + k * REMAT_CW;
    n = min(REMAT_CW, blk - k * REMAT_CW);
  }
};

// The producer: K1's step over the tile's chunks (window_kernels.cu's
// asc_sweep_kernel, the same arithmetic line for line).
template <int MB, bool BF16, bool SMEM_E>
__device__ __forceinline__ void remat_produce(
    const float* __restrict__ T, const int32_t* __restrict__ keys,
    const uint8_t* __restrict__ valid, const typename Carry<BF16>::T* __restrict__ snaps,
    int S, int L, int M, int blk, bool vec, const float* tE, int ES, RematStage& st,
    unsigned char* ring, size_t slot_bytes, size_t kv_off, float* __restrict__ carries) {
  constexpr int NN = MB / 8, NQ = MB / 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.x * ASC_ROWS, rows = min(ASC_ROWS, S - s0);
  const int NB = L / blk, nc = (blk + REMAT_CW - 1) / REMAT_CW;
  const int n_walks = NB * (2 * nc - 1);
  // the entry carry of chunk k of a block of parity p: 2 nc slots a tile
  auto carry_at = [&](int p, int k) {
    return carries + (((size_t)blockIdx.x * 2 + p) * nc + k) * 32 * 4 * NN + lane * 4 * NN;
  };

  double B[NQ][NN];  // B[q][n] = T[j(q)][8n + g], j(q) = 8 (q >> 1) + 2t + (q & 1)
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int j = 8 * (q >> 1) + 2 * t + (q & 1), i = 8 * n + g;
      B[q][n] = (j < M && i < M) ? (double)T[j * M + i] : 0.0;
    }
  for (int r = rows; r < ASC_ROWS; ++r)  // rows past S: key 0, invalid, never staged
    for (int idx = lane; idx < 2 * REMAT_CW; idx += 32) {
      st.key[idx / REMAT_CW][r][idx % REMAT_CW] = 0;
      st.v[idx / REMAT_CW][r][idx % REMAT_CW] = 0;
    }
  Walk cur(0, NB, nc, blk);
  remat_stage(st, 0, keys, valid, s0, S, L, cur.l0, cur.n, vec, lane);
  float X[2][NN][2];  // X[m][n][c] = alpha[s0 + g + 8m][8n + 2t + c]
  float e[2][NN][2];  // the emission entries of the next step
  cp_async_wait<0>();
  __syncwarp();
  asc_emission<NN, SMEM_E>(e, st, 0, 0, tE, ES, M, g, t);
  int b = 0, ring_n = 0;
  for (int w = 0; w < n_walks; ++w, b ^= 1) {
    const bool more = w + 1 < n_walks;
    const Walk nxt(more ? w + 1 : w, NB, nc, blk);
    // every lane passed the __syncwarp after its last read of buffer b ^ 1
    if (more) remat_stage(st, b ^ 1, keys, valid, s0, S, L, nxt.l0, nxt.n, vec, lane);
    const bool to_ring = cur.ring;
    if (cur.k == 0 && (!to_ring || nc == 1)) {  // the block's snapshot, in f32
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int s = s0 + g + 8 * m;
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 8 * n + 2 * t + c;
            X[m][n][c] = (s < S && i < M)
                             ? Carry<BF16>::load(snaps[((size_t)cur.bi * S + s) * M + i])
                             : 0.f;
          }
      }
      if (nc > 1) carry_put<NN>(carry_at(cur.bi & 1, 0), X);
    } else {  // the chunk's entry carry, kept by the carry walk before it
      carry_get<NN>(carry_at(cur.bi & 1, cur.k), X);
    }
    unsigned char* slot = ring + (size_t)(ring_n & 1) * slot_bytes;
    int32_t* kv = reinterpret_cast<int32_t*>(slot + kv_off);
    if (to_ring && ring_n >= 2) empty_sync(ring_n & 1);
    for (int tt = 0; tt < cur.n; ++tt) {
      float en[2][NN][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          en[m][n][0] = e[m][n][0];
          en[m][n][1] = e[m][n][1];
        }
      const bool vm[2] = {st.v[b][g][tt] != 0, st.v[b][g + 8][tt] != 0};
      if (to_ring && t == 0) {
        kv[tt * ASC_ROWS + g] = vm[0] ? st.key[b][g][tt] : -1;
        kv[tt * ASC_ROWS + g + 8] = vm[1] ? st.key[b][g + 8][tt] : -1;
      }
      if (tt + 1 < cur.n) asc_emission<NN, SMEM_E>(e, st, b, tt + 1, tE, ES, M, g, t);
      double acc[NN][4];  // acc[n][2m + c] = Y[g + 8m][8n + 2t + c]
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;
#pragma unroll
        for (int Q = 0; Q < NQ / 4; ++Q) {
          const double a[8] = {
              (double)X[0][2 * Q][0],     (double)X[1][2 * Q][0],
              (double)X[0][2 * Q][1],     (double)X[1][2 * Q][1],
              (double)X[0][2 * Q + 1][0], (double)X[1][2 * Q + 1][0],
              (double)X[0][2 * Q + 1][1], (double)X[1][2 * Q + 1][1]};
          const double bb[4] = {B[4 * Q][n], B[4 * Q + 1][n], B[4 * Q + 2][n], B[4 * Q + 3][n]};
          mma_f64(acc[n], a, bb);
        }
      }
      float an[2][NN][2], mx[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            an[m][n][c] = en[m][n][c] * __double2float_rn(acc[n][2 * m + c]);
            mx[m] = fmaxf(mx[m], an[m][n][c]);
          }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mx[m] = fmaxf(mx[m], __shfl_xor_sync(FULL, mx[m], 1));
        mx[m] = fmaxf(mx[m], __shfl_xor_sync(FULL, mx[m], 2));
        mx[m] = fmaxf(mx[m], TINY);
      }
      float qt[2][NN][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float sc = mx[m] > 0x1p100f ? 0x1p-64f : 1.f;
        const float bm = mx[m] * sc, y = asc_rcp(bm);
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) qt[m][n][c] = asc_div(an[m][n][c] * sc, bm, y);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (vm[m]) X[m][n][c] = qt[m][n][c];
      if (to_ring) Ring<NN, BF16>::put(slot, tt, lane, X);
    }
    if (!to_ring)  // the entry carry of chunk k + 1
      carry_put<NN>(carry_at(cur.bi & 1, cur.k + 1), X);
    if (to_ring) full_arrive(ring_n++ & 1);
    if (more) {  // also orders this chunk's reads of buffer b before its restaging
      cp_async_wait<0>();
      __syncwarp();
      asc_emission<NN, SMEM_E>(e, st, b ^ 1, 0, tE, ES, M, g, t);
    }
    cur = nxt;
  }
}

// gsum's add of a run into the block's slice of the partials: a 64-bit
// integer reduction in global memory (native, no returned value).
__device__ __forceinline__ void gsum_add(unsigned long long* G, int idx, float x) {
  atomicAdd(G + idx, (unsigned long long)__float2ll_rn(x * FIX_SCALE));
}

// n consecutive floats from shared memory, 16 (or 8) bytes a load: p is
// aligned to n floats.
template <int N>
__device__ __forceinline__ void load_floats(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      v[i] = x.x;
      v[i + 1] = x.y;
    }
  }
}

// T u for the tile: acc[n][2m + c] = sum_i U[g + 8m][i] T[8n + 2t + c][i],
// with K1's permuted contraction index (U in the accumulator layout is the A
// operand) and Bt[q][n] = T[8n + g][j(q)].
template <int NN, int NQ>
__device__ __forceinline__ void tu_product(double (&acc)[NN][4], const float (&U)[2][NN][2],
                                           const double (&Bt)[NQ][NN]) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;
#pragma unroll
    for (int Qk = 0; Qk < NQ / 4; ++Qk) {
      const double a[8] = {
          (double)U[0][2 * Qk][0],     (double)U[1][2 * Qk][0],
          (double)U[0][2 * Qk][1],     (double)U[1][2 * Qk][1],
          (double)U[0][2 * Qk + 1][0], (double)U[1][2 * Qk + 1][0],
          (double)U[0][2 * Qk + 1][1], (double)U[1][2 * Qk + 1][1]};
      const double bb[4] = {Bt[4 * Qk][n], Bt[4 * Qk + 1][n], Bt[4 * Qk + 2][n],
                            Bt[4 * Qk + 3][n]};
      mma_f64(acc[n], a, bb);
    }
  }
}

// The consumer: the descending steps over the ring's chunks.  A step's T u
// is issued as soon as its u is known, before the statistics of the window
// after it (xisum's product, gsum's runs), which then run in its shadow.
template <int MB, bool BF16, bool SMEM_E>
__device__ __forceinline__ void remat_consume(
    const float* __restrict__ T, const float* __restrict__ Q_end, int S, int L, int M,
    int blk, const float* tE, int ES, const unsigned char* ring, size_t slot_bytes,
    size_t kv_off, unsigned char* trans, unsigned long long* G, float* __restrict__ u_start,
    double* __restrict__ xo_part) {
  constexpr int NN = MB / 8, NQ = MB / 4, XS = MB + 8;
  constexpr int RJ = MB / 8, CI = MB / 4;  // a lane's block of xisum: RJ rows, CI columns
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.x * ASC_ROWS;
  const int NB = L / blk, nc = (blk + REMAT_CW - 1) / REMAT_CW, n_chunks = NB * nc;
  // the 16 rows' gamma, a / Z and old u (row stride XS)
  float* sG = reinterpret_cast<float*>(trans);
  float* sA = sG + ASC_ROWS * XS;
  float* sU = sA + ASC_ROWS * XS;
  // xisum rows RJ a ... and columns CI b ... of the block's f64 partial
  const int xa = lane >> 2, xb = lane & 3;
  double* xp = xo_part + (size_t)blockIdx.x * MB * MB + xa * RJ * MB + xb * CI;

  double Bt[NQ][NN];  // Bt[q][n] = T[8n + g][j(q)]
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int j = 8 * (q >> 1) + 2 * t + (q & 1), i = 8 * n + g;
      Bt[q][n] = (j < M && i < M) ? (double)T[i * M + j] : 0.0;
    }
  float U[2][NN][2], Q[2][NN][2];  // u and q of rows g + 8m, columns 8n + 2t + c
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int s = s0 + g + 8 * m;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 8 * n + 2 * t + c;
        U[m][n][c] = 0.f;
        Q[m][n][c] = (s < S && i < M) ? Q_end[(size_t)s * M + i] : 0.f;
      }
  }
  bool vp[2] = {false, false};  // the valid flag of the window after
  float xc[RJ][CI];  // this chunk's xisum terms of the lane's block, in f32
#pragma unroll
  for (int r = 0; r < RJ; ++r)
#pragma unroll
    for (int c = 0; c < CI; ++c) xc[r][c] = 0.f;
  double acc[NN][4];  // T u of the window to come
  tu_product<NN, NQ>(acc, U, Bt);

  for (int cn = 0; cn < n_chunks; ++cn) {
    const int k = nc - 1 - cn % nc;
    const int n_win = min(REMAT_CW, blk - k * REMAT_CW);
    const unsigned char* slot = ring + (size_t)(cn & 1) * slot_bytes;
    const int32_t* kv = reinterpret_cast<const int32_t*>(slot + kv_off);
    full_sync(cn & 1);
    for (int w = n_win - 1; w >= 0; --w) {
      const int kvm[2] = {kv[w * ASC_ROWS + g], kv[w * ASC_ROWS + g + 8]};
      float al[2][NN][2], e[2][NN][2];
      Ring<NN, BF16>::get(slot, w, lane, al);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* er = tE + max(kvm[m], 0) * ES;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int i = 8 * n + 2 * t;
          if constexpr (SMEM_E) {  // the shared table is padded with columns of zeros
            const float2 e2 = *reinterpret_cast<const float2*>(er + i);
            e[m][n][0] = e2.x;
            e[m][n][1] = e2.y;
          } else {
            e[m][n][0] = i < M ? table<false>(er, i) : 0.f;
            e[m][n][1] = i + 1 < M ? table<false>(er, i + 1) : 0.f;
          }
        }
      }
      float qun[2][NN][2], z[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float tv = __double2float_rn(acc[n][2 * m + c]);
            qun[m][n][c] = vp[m] ? tv : Q[m][n][c];
            z[m] = __fmaf_rn(al[m][n][c], qun[m][n][c], z[m]);
            mx[m] = fmaxf(mx[m], qun[m][n][c]);
          }
      // the four t-lanes of a row; on every lane, before any select
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        z[m] += __shfl_xor_sync(FULL, z[m], 1);
        mx[m] = fmaxf(mx[m], __shfl_xor_sync(FULL, mx[m], 1));
        z[m] += __shfl_xor_sync(FULL, z[m], 2);
        mx[m] = fmaxf(mx[m], __shfl_xor_sync(FULL, mx[m], 2));
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float Z = fmaxf(z[m], TINY), mq = fmaxf(mx[m], TINY);
        const float yz = asc_rcp(Z), yq = asc_rcp(mq);
        const bool v = kvm[m] >= 0, both = v && vp[m];
        float* gr = sG + (g + 8 * m) * XS + 2 * t;
        float* ar = sA + (g + 8 * m) * XS + 2 * t;
        float* ur = sU + (g + 8 * m) * XS + 2 * t;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          // gamma and a / Z leave the chain: the row's reciprocal, one product
          const float a0 = al[m][n][0], a1 = al[m][n][1];
          *reinterpret_cast<float2*>(gr + 8 * n) =
              make_float2(a0 * qun[m][n][0] * yz, a1 * qun[m][n][1] * yz);
          *reinterpret_cast<float2*>(ar + 8 * n) =
              both ? make_float2(a0 * yz, a1 * yz) : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(ur + 8 * n) = make_float2(U[m][n][0], U[m][n][1]);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (v) {  // the chain: q by its row maximum, correctly rounded (asc_div)
              Q[m][n][c] = asc_div(qun[m][n][c], mq, yq);
              U[m][n][c] = e[m][n][c] * Q[m][n][c];
            }
          }
        }
        vp[m] = v;
      }
      __syncwarp();
      tu_product<NN, NQ>(acc, U, Bt);  // the next window's T u
      // xisum += (a / Z)^T u_old over the 16 rows, on the CUDA cores while T u
      // runs on the tensor cores: the lane's RJ x CI block, in row order
#pragma unroll
      for (int r = 0; r < ASC_ROWS; ++r) {
        float av[RJ], uv[CI];
        load_floats(av, sA + r * XS + xa * RJ);
        load_floats(uv, sU + r * XS + xb * CI);
#pragma unroll
        for (int q = 0; q < RJ; ++q)
#pragma unroll
          for (int c = 0; c < CI; ++c) xc[q][c] = __fmaf_rn(av[q], uv[c], xc[q][c]);
      }
      // gsum: lane j sums each run of equal keys over the 16 rows in f32, in
      // row order, and adds the run's fixed-point integer; the keys and the
      // gammas are loaded first, so only a change of key branches
      {
        int kr[ASC_ROWS];
        float x[ASC_ROWS];
#pragma unroll
        for (int r = 0; r < ASC_ROWS; r += 4) {
          const int4 k4 = *reinterpret_cast<const int4*>(kv + w * ASC_ROWS + r);
          kr[r] = k4.x;
          kr[r + 1] = k4.y;
          kr[r + 2] = k4.z;
          kr[r + 3] = k4.w;
        }
#pragma unroll
        for (int r = 0; r < ASC_ROWS; ++r) x[r] = lane < MB ? sG[r * XS + lane] : 0.f;
        float run = 0.f;
        int cur = -1;
#pragma unroll
        for (int r = 0; r < ASC_ROWS; ++r) {
          if (kr[r] >= 0 && kr[r] != cur) {
            if (cur >= 0 && lane < M) gsum_add(G, cur * M + lane, run);
            cur = kr[r];
            run = 0.f;
          }
          if (kr[r] >= 0) run += x[r];
        }
        if (cur >= 0 && lane < M) gsum_add(G, cur * M + lane, run);
      }
      __syncwarp();  // the buffers are rewritten by the next step
    }
    if (cn + 2 < n_chunks) empty_arrive(cn & 1);
    // the chunk's f32 terms (REMAT_CW windows x 16 rows) into the block's
    // f64 partial, which only this warp writes
#pragma unroll
    for (int r = 0; r < RJ; ++r)
#pragma unroll
      for (int c = 0; c < CI; c += 2) {
        double2* p = reinterpret_cast<double2*>(xp + r * MB + c);
        const double2 o = *p;
        *p = make_double2(o.x + (double)xc[r][c], o.y + (double)xc[r][c + 1]);
        xc[r][c] = xc[r][c + 1] = 0.f;
      }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int s = s0 + g + 8 * m;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 8 * n + 2 * t + c;
        if (s < S && i < M) u_start[(size_t)s * M + i] = U[m][n][c];
      }
  }
}

template <int MB, bool BF16, bool SMEM_E>
__global__ void __launch_bounds__(64) remat_sweep_kernel(
    const float* __restrict__ T, const float* __restrict__ E,
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    const void* __restrict__ snaps, const float* __restrict__ Q_end,
    int S, int L, int M, int n_keys, int blk, bool vec, int gsum_group,
    float* __restrict__ carries, float* __restrict__ u_start, double* __restrict__ xo_part,
    unsigned long long* __restrict__ gsum_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RematLayout lay(MB, n_keys, (int)sizeof(typename Carry<BF16>::T), SMEM_E);
  const float* tE = E;  // emission rows, row stride ES
  int ES = M;
  if constexpr (SMEM_E) {
    constexpr int ESB = MB + ASC_EPAD;
    float* sE = reinterpret_cast<float*>(smem + lay.etab);
    for (int idx = threadIdx.x; idx < n_keys * ESB; idx += blockDim.x) {
      const int r = idx / ESB, i = idx % ESB;
      sE[idx] = i < M ? E[r * M + i] : 0.f;
    }
    tE = sE;
    ES = ESB;
  }
  // Roles: a block's two warps sit on neighbouring warp slots of the SM,
  // and slot w is scheduled by sub-partition w mod 4; a block whose first
  // warp holds a slot 4 to 7 modulo 8 swaps roles, so that each
  // sub-partition holds a producer and a consumer and shares their
  // tensor-core work evenly.  A placement hint only: any slot gives a
  // correct result.
  __shared__ int s_swap;
  if (threadIdx.x == 0) {
    unsigned slot;
    asm volatile("mov.u32 %0, %%warpid;\n" : "=r"(slot));
    s_swap = (slot >> 2) & 1;
  }
  __syncthreads();
  unsigned char* ring = smem + lay.ring;
  const size_t kv_off = lay.slot_stream;
  if ((threadIdx.x >> 5) == s_swap) {
    remat_produce<MB, BF16, SMEM_E>(T, keys, valid,
                                    static_cast<const typename Carry<BF16>::T*>(snaps),
                                    S, L, M, blk, vec, tE, ES,
                                    *reinterpret_cast<RematStage*>(smem), ring, lay.slot,
                                    kv_off, carries);
  } else {
    unsigned long long* G = gsum_part + (size_t)(blockIdx.x / gsum_group) * n_keys * M;
    remat_consume<MB, BF16, SMEM_E>(T, Q_end, S, L, M, blk, tE, ES, ring, lay.slot, kv_off,
                                    smem + lay.trans, G, u_start, xo_part);
  }
}

// K8's launch: (kernel, dynamic shared bytes, table route) for these inputs.
using RematKernel = decltype(&remat_sweep_kernel<16, false, true>);
struct RematPlan {
  RematKernel kernel;
  size_t smem;
  bool smem_table;
};

template <int MB, bool BF16>
RematPlan remat_plan_for(int n_keys) {
  const size_t with = RematLayout(MB, n_keys, BF16 ? 2 : 4, true).total;
  const size_t without = RematLayout(MB, n_keys, BF16 ? 2 : 4, false).total;
  const bool fits = with <= SMEM_MAX;
  return {fits ? remat_sweep_kernel<MB, BF16, true> : remat_sweep_kernel<MB, BF16, false>,
          fits ? with : without, fits};
}

RematPlan remat_plan(int M, int n_keys, int bf16) {
  if (M <= 16) return bf16 ? remat_plan_for<16, true>(n_keys) : remat_plan_for<16, false>(n_keys);
  return bf16 ? remat_plan_for<32, true>(n_keys) : remat_plan_for<32, false>(n_keys);
}

}  // namespace

extern "C" {

// The remat pass after K1's snapshot launch, over the windows of keys and
// valid (S, L) in blocks of blk (blk divides L): snaps (L / blk, S, M), in
// bf16 (bf16 != 0) or f32, the carry entering each block; Q_end (S, M) f32
// the beta carry q entering window L - 1.  Outputs: u_start (S, M) f32;
// xo_part (ceil(S / 16), MB, MB) f64, zeroed by the caller, one xisum
// partial a block of the grid (MB = 16 for M <= 16, else 32; rows and
// columns past M stay 0);
// gsum_part (ceil(ceil(S / 16) / gsum_group), n_keys, M) 64-bit fixed-point
// integers (2^-40), zeroed by the caller, gsum_group blocks of the grid to a
// slice.  carries: (ceil(S / 16), 2, ceil(blk / 8), 32, 4 NN) f32 scratch.
int smcpp_remat_sweep(const float* T, const float* E, const int32_t* keys,
                      const uint8_t* valid, const void* snaps, const float* Q_end, int S,
                      int L, int M, int n_keys, int bf16, int blk, int gsum_group,
                      float* carries, float* u_start, double* xo_part,
                      unsigned long long* gsum_part, void* stream) {
  if (M < 2 || M > 32 || S <= 0 || L <= 0 || n_keys <= 0 || blk <= 0 || L % blk ||
      gsum_group < 1)
    return (int)cudaErrorInvalidValue;
  const RematPlan p = remat_plan(M, n_keys, bf16);
  int e = prepare(p.kernel, p.smem);
  if (e) return e;
  // 4-byte copies of the flags: rows and chunks on 4-byte boundaries
  const bool vec = L % 4 == 0 && blk % REMAT_CW == 0 && (uintptr_t)valid % 4 == 0;
  const dim3 grid((S + ASC_ROWS - 1) / ASC_ROWS);
  p.kernel<<<grid, 64, p.smem, (cudaStream_t)stream>>>(T, E, keys, valid, snaps, Q_end, S, L,
                                                        M, n_keys, blk, vec, gsum_group,
                                                        carries, u_start, xo_part, gsum_part);
  record_launch(!p.smem_table, p.smem);
  return (int)cudaGetLastError();
}

// K8's launch plan, as 8 ints: warps per block, blocks, registers per
// thread, dynamic shared bytes, 1 if the emission table is in shared memory
// (else global), local (spill) bytes per thread, windows a ring slot holds, and
// the blocks resident on one SM.
int smcpp_remat_sweep_plan(int S, int M, int n_keys, int bf16, int* out) {
  if (M < 2 || M > 32 || S <= 0 || n_keys <= 0) return (int)cudaErrorInvalidValue;
  const RematPlan p = remat_plan(M, n_keys, bf16);
  int e = prepare(p.kernel, p.smem);
  if (e) return e;
  cudaFuncAttributes a;
  cudaError_t r = cudaFuncGetAttributes(&a, p.kernel);
  if (r != cudaSuccess) return (int)r;
  int resident = 0;
  r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, p.kernel, 64, p.smem);
  if (r != cudaSuccess) return (int)r;
  out[0] = 2;
  out[1] = (S + ASC_ROWS - 1) / ASC_ROWS;
  out[2] = a.numRegs;
  out[3] = (int)p.smem;
  out[4] = p.smem_table;
  out[5] = (int)a.localSizeBytes;
  out[6] = REMAT_CW;
  out[7] = resident;
  return 0;
}

}  // extern "C"

SMCPP_LAST_LAUNCH(remat_kernels)
