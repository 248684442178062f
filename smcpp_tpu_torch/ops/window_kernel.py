"""Window-resolution E-step, posterior decode and MAP decode, in torch, with
hand-written CUDA kernels.

Port of smcpp_tpu/ops/window_kernel.py: the direct Baum-Welch E-step
(``estep_direct``), the window gamma decode (``decode_gammas_windows``) and
the window Viterbi (``viterbi_windows``).  The observation stream is
decompressed to unit windows and cut into S segments of L windows
(``pack_windows``); then

  pass 1   ``segment_operators``: per-segment transfer operators, one
           X <- diag(e) T^T X step per window (kernel K3);
           ``contig_boundaries``: per-contig forward and backward scans
           over the (S, M, M) operators give each segment's boundary alpha
           / beta vectors (K6, which replaces the JAX package's
           window_kernel.py:358);
  pass 2   ``stats_pass``: an ascending alpha sweep storing the per-window
           alpha stream (K1), then a descending beta sweep reading it and
           accumulating xisum and the per-key posterior masses (K2), or,
           for the decode, also storing each window's posterior (K2g);
           over the memory budget (alpha remat) K1 keeps only the carry
           entering each block of windows and K8 recomputes each block in
           shared memory as it descends (``AlphaRemat``);
  finally  ``boundary_stats``: the transitions that cross segment and
           contig boundaries.

The Viterbi is the same two-level scheme in max-plus: per-segment max-plus
operators (K4, which applies each run of equal keys whole: a window at a
time below ``VITERBI_RUN_MIN`` windows, else as a binary power of the run's
operator; its plain twin is ``viterbi_ops_runs_plain``), a per-contig scan
over them for the boundary states and its
backtrace (K7), then each segment's interior path from its entry state
(K5).

Each of K1-K5 is a serial loop over the windows of a segment.  K6 is a
chunked scan in three launches (``BoundaryScan``): each contig's segments
are cut into chunks of c (``boundary_plan``), every chunk's operator
product is formed at once in f64 (phase 1), a short f64 scan over each
contig's chunk products gives every chunk's entry and exit vectors (phase
2), and every chunk is then walked at once in f32 from those vectors (phase
3), so its depth is c + n_chunks + c steps in place of the contig's length;
its plain twin is ``contig_boundaries_chunked_plain``.  K7 is the same scan
in max-plus in four launches (``ViterbiBoundary``), the fourth a backtrace
of every chunk at once from its exit state, found through each chunk's
exit -> entry map; its plain twin is
``viterbi_boundary_states_chunked_plain``.  On a CUDA tensor they run as
the hand-written kernels in csrc/*.cu; on a CPU tensor they run as the
plain PyTorch loops in this module (the same arithmetic, f32 or f64).  A
CUDA tensor never falls back to the plain version: the wrapper launches its
kernel or raises.  The plain versions are also what
the kernels are held against on the card.

Numerics (the reference's): f32 arithmetic with exact f32 products at every
precision rung; at 'default' the K3 carry is stored in bf16 after every step
and every block rescale, and the alpha stream is stored in bf16
(``carry_dtype``); at 'tensorfloat32' and 'highest' both are f32.  Every
normalizer is window-local, so scale factors cancel exactly.  K3 and K1 on
the card sum each step's products in f64 before rounding them to f32, where
the plain loops (and the reference) sum in f32 (``segment_ops_plain``,
``asc_sweep_plain``; their ``sum_dtype=torch.float64`` is the kernels').

Environment (read once, at import, as the reference reads them):
SMCPP_TPU_MATMUL_PRECISION sets the default rung (``MATMUL_PRECISION``,
'default'); SMCPP_TPU_CARRY pins the carry storage (``CARRY``: 'auto' ties
it to the rung, 'float32' or 'bfloat16' pins it).
"""

import ctypes
import os

import numpy as np
import torch

from ..parallel import mesh as mesh_mod
from . import _cuda

RESCALE_EVERY = 8
FLOOR = 1e-35
MATMUL_PRECISION = os.environ.get("SMCPP_TPU_MATMUL_PRECISION", "default")
CARRY = os.environ.get("SMCPP_TPU_CARRY", "auto")
_CARRY_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The descending sweep (K2, K2g): warps per block, one segment each.  The
# partition of segments into blocks, and so the order in which the f64
# partials are formed, depends on (S, n_keys, M) only (dsc_plan), never on
# the card.
DSC_WARPS = 8
# Budget of K2's per-block f64 gsum partials, G x n_keys x M x 8 bytes: where
# it binds, each warp walks more segments (G falls).
GSUM_PART_BYTES = 256 << 20
# K2 adds each window's per-key masses in 64-bit fixed point with this many
# fractional bits (FIX_SCALE in csrc/dsc_kernels.cu); an entry of a block's
# table stays below (segments per block) x L x 2^GSUM_FRAC_BITS, which must
# stay under 2^62.
GSUM_FRAC_BITS = 40


def carry_dtype(precision, base_dtype):
    """Storage dtype of the K3 carry and of the alpha stream
    (window_kernel.py:_carry_dtype): for f32 E-steps, ``CARRY`` when it pins
    one, else bf16 at the 'default'/'bfloat16' rung and f32 above it; the
    compute dtype for f64 E-steps.  The kernels store f32 or bf16 only."""
    if base_dtype != torch.float32:
        return base_dtype
    if CARRY == "auto":
        return torch.bfloat16 if precision in ("default", "bfloat16") else base_dtype
    if CARRY not in _CARRY_DTYPES:
        raise ValueError(
            f"SMCPP_TPU_CARRY must be 'auto', 'float32' or 'bfloat16' (got {CARRY!r})"
        )
    return _CARRY_DTYPES[CARRY]


def _precision(precision):
    return MATMUL_PRECISION if precision is None else precision


def from_numpy(pi, T, E, device, dtype=torch.float32):
    "Place the E-step tensors (pi, T, E) on ``device`` in ``dtype``."
    return tuple(
        torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        for x in (pi, T, E)
    )


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

class _Kernel:
    """A CUDA kernel's Python face: its name, the TPU-side function it
    replaces, and its counters, changed where the kernel is launched and
    nowhere else: ``launches``, the number of times this process launched
    it; and for a kernel with an emission table, from the launcher's own
    choice (csrc/common.cuh:launch_e, or K1's and K8's plans), ``glob``, the
    launches that read the table from global memory (its k_glob
    instantiation), and ``smem_bytes``, the dynamic shared memory of its
    last launch (None before the first, and for a kernel with no table)."""

    def __init__(self, name, source, replaces):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.glob = 0
        self.smem_bytes = None

    def took(self):
        "Count the table route and shared bytes of the launch just made."
        stem = os.path.splitext(os.path.basename(self.source))[0]
        out = (ctypes.c_longlong * 2)()
        _cuda.check(getattr(_cuda.lib(), f"smcpp_{stem}_last_launch")(out), self.name)
        self.glob += int(out[0])
        self.smem_bytes = int(out[1])


SEGMENT_OPS = _Kernel(
    "segment_ops", "smcpp_tpu_torch/csrc/window_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:151",
)
ASC_SWEEP = _Kernel(
    "asc_sweep", "smcpp_tpu_torch/csrc/window_kernels.cu",
    "smcpp_tpu/ops/pallas_sweeps.py:215",
)
DSC_SWEEP = _Kernel(
    "dsc_sweep", "smcpp_tpu_torch/csrc/dsc_kernels.cu",
    "smcpp_tpu/ops/pallas_sweeps.py:255",
)
DSC_SWEEP_GAMMA = _Kernel(
    "dsc_sweep_gamma", "smcpp_tpu_torch/csrc/dsc_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:536",
)
class _RunKernel(_Kernel):
    """K4's face: a ``_Kernel`` with two counters that its launches add to on
    the device, read only on request (each read synchronises): ``products``,
    the max-plus operator products the kernel ran, and ``windows``, the valid
    windows it covered (one product a window is the walk)."""

    def __init__(self, *a):
        super().__init__(*a)
        self._counts = {}  # device -> (2,) int64: products, windows

    def counts(self, device):
        "The device's counter tensor, which the launch adds to."
        if device not in self._counts:
            self._counts[device] = torch.zeros(2, dtype=torch.int64, device=device)
        return self._counts[device]

    @property
    def products(self):
        return sum(int(c[0]) for c in self._counts.values())

    @property
    def windows(self):
        return sum(int(c[1]) for c in self._counts.values())


VITERBI_OPS = _RunKernel(
    "viterbi_ops", "smcpp_tpu_torch/csrc/viterbi_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:787",
)
VITERBI_PATHS = _Kernel(
    "viterbi_paths", "smcpp_tpu_torch/csrc/viterbi_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:871",
)
BOUNDARY_SCAN = _Kernel(
    "boundary_scan", "smcpp_tpu_torch/csrc/boundary_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:358",
)
VITERBI_BOUNDARY = _Kernel(
    "viterbi_boundary", "smcpp_tpu_torch/csrc/boundary_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:815",
)
# the over-budget routes: alpha remat in the E-step, the blocked Viterbi
ASC_SWEEP_REMAT = _Kernel(
    "asc_sweep_remat", "smcpp_tpu_torch/csrc/window_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:577",
)
REMAT_SWEEP = _Kernel(
    "remat_sweep", "smcpp_tpu_torch/csrc/remat_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:585",
)
VITERBI_FWD_BLOCKED = _Kernel(
    "viterbi_fwd_blocked", "smcpp_tpu_torch/csrc/viterbi_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:928",
)
VITERBI_BACK_BLOCKED = _Kernel(
    "viterbi_back_blocked", "smcpp_tpu_torch/csrc/viterbi_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:937",
)
ESTEP_KERNELS = (SEGMENT_OPS, ASC_SWEEP, DSC_SWEEP, BOUNDARY_SCAN)
REMAT_KERNELS = (ASC_SWEEP_REMAT, REMAT_SWEEP, VITERBI_FWD_BLOCKED,
                 VITERBI_BACK_BLOCKED)
KERNELS = ESTEP_KERNELS + (
    DSC_SWEEP_GAMMA, VITERBI_OPS, VITERBI_PATHS, VITERBI_BOUNDARY,
) + REMAT_KERNELS


def check_key_range(keys, n_keys):
    """Raise unless every key indexes a row of the emission table.  The
    kernels do not check this per launch (that would be two reductions over
    the (S, L) keys and two host syncs each time): callers check once, where
    the keys are made, as the manager does for its packed windows."""
    keys = np.asarray(keys)
    if keys.size and (int(keys.min()) < 0 or int(keys.max()) >= n_keys):
        raise ValueError(
            f"window keys span [{int(keys.min())}, {int(keys.max())}], out of "
            f"range of the {n_keys}-row emission table"
        )


def _check_inputs(T, E, keys, valid, *rows):
    """Validate the dtype, shape, device and layout the kernels take; raise
    on anything else.  The key range is the caller's (check_key_range)."""
    dev = T.device
    M = T.shape[0]
    if T.dtype != torch.float32 or E.dtype != torch.float32:
        raise TypeError(
            f"the CUDA kernels take float32 T and E (got {T.dtype}, {E.dtype})"
        )
    if T.dim() != 2 or T.shape != (M, M) or not 2 <= M <= 32:
        raise ValueError(f"T must be (M, M) with 2 <= M <= 32, got {tuple(T.shape)}")
    if E.dim() != 2 or E.shape[1] != M or E.shape[0] < 1:
        raise ValueError(f"E must be (n_keys, {M}), got {tuple(E.shape)}")
    if keys.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("keys must be int32 and valid bool")
    if keys.dim() != 2 or keys.shape != valid.shape:
        raise ValueError("keys and valid must be (S, L) of one shape")
    S = keys.shape[0]
    for r in rows:
        if r.dtype != torch.float32 or tuple(r.shape) != (S, M):
            raise ValueError(f"boundary vectors must be float32 (S, M) = {(S, M)}")
    for x in (T, E, keys, valid) + rows:
        if x.device != dev:
            raise ValueError("all kernel inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _stream(device):
    "The current CUDA stream of ``device`` as a C pointer value."
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(x):
    "A tensor's device pointer, or None (a null pointer) for no tensor."
    return None if x is None else x.data_ptr()


def segment_ops_cuda(T, E, keys, valid, precision):
    """K3 (replaces window_kernel.py:_steps_block / segment_operators).

    What bounds it: its products.  Each valid window is an (M, M) by (M, M)
    product per segment, M^3 FMAs on the f64 tensor cores (67 TFLOP/s dense
    on the H100 SXM, the CUDA cores' f32 rate), each step depending on the
    one before; beside them, two f32/f64 conversions per carry entry.  Design
    (csrc/window_kernels.cu): a step computes the transpose, Y^T = X^T T,
    with mma.sync m16n8k16 f64 tiles, with the contraction index permuted so
    that one step's accumulator is, entry for entry, the next step's A
    operand (no shuffles); T's fragments stay in registers.  Each entry's
    products are exact and summed in f64, then rounded once to f32, so the
    kernel agrees bit for bit, but for rare last-bit differences, with
    ``segment_ops_plain(..., sum_dtype=torch.float64)``.  One warp per
    segment at M <= 16, two (16 columns of X each, the block rescale's
    maximum exchanged under a named barrier) at 17 <= M <= 32; the
    normalized emission table in shared memory, or global memory past a
    block's.  Returns (ops (S, M, M), logs (S,))."""
    _check_inputs(T, E, keys, valid)
    S, L = keys.shape
    M = T.shape[0]
    if L % RESCALE_EVERY:
        raise ValueError(f"L must be a multiple of {RESCALE_EVERY}")
    tiny = torch.finfo(torch.float32).tiny
    em = torch.clamp(torch.amax(E, 1), min=tiny)
    En = (E / em[:, None]).contiguous()
    logem = torch.log(em).contiguous()
    ops = torch.empty((S, M, M), dtype=torch.float32, device=T.device)
    logs = torch.empty((S,), dtype=torch.float32, device=T.device)
    bf16 = carry_dtype(precision, torch.float32) == torch.bfloat16
    lib = _cuda.lib()
    SEGMENT_OPS.launches += 1
    _cuda.check(
        lib.smcpp_segment_ops(
            T.data_ptr(), En.data_ptr(), logem.data_ptr(), keys.data_ptr(),
            valid.data_ptr(), S, L, M, E.shape[0], int(bf16),
            ops.data_ptr(), logs.data_ptr(), _stream(T.device),
        ),
        SEGMENT_OPS.name,
    )
    SEGMENT_OPS.took()
    return ops, logs


def asc_sweep_cuda(T, E, keys, valid, A_in, precision):
    """K1 (replaces pallas_sweeps.py:_asc_kernel).

    What bounds it: serial depth.  Each segment walks L dependent windows,
    each M^2 FMAs (on the f64 tensor cores, whose rate is the f32 CUDA
    cores', so the bound is unchanged), a row maximum and M quotients, and a
    real E-step has only a few hundred warps' worth of segments, about one
    per SM sub-partition; the alpha stream it writes sets the byte bound.
    Design (csrc/window_kernels.cu): one warp walks 16 segments, and a
    window's step is the product of their (16, M) carry by T with mma.sync
    m16n8k16 f64 tiles, the segments as the tile's rows, K3's permuted
    contraction index reusing the accumulator as the next operand, T's
    fragments in registers; the row maximum is two shuffles for all 16
    segments; each row's quotients come from one reciprocal and one
    corrected product per entry; keys and valid flags are staged per
    32-window chunk in shared memory, a chunk ahead; one block per warp.
    Each entry's products are exact and summed in f64, then rounded once to
    f32, and each quotient is correctly rounded down to 2^-90 of its row's
    maximum, so the kernel agrees bit for bit, but for rare last-bit
    differences, with its plain version ``asc_sweep_plain(...,
    sum_dtype=torch.float64)``; the stream is laid out (S, L, M), one
    contiguous M-vector per segment and window.  ``asc_sweep_plan`` gives
    the grid and registers.  Returns (alphas (S, L, M) in the carry dtype,
    alpha_end (S, M) f32)."""
    _check_inputs(T, E, keys, valid, A_in)
    S, L = keys.shape
    M = T.shape[0]
    cdt = carry_dtype(precision, torch.float32)
    alphas = torch.empty((S, L, M), dtype=cdt, device=T.device)
    alpha_end = torch.empty((S, M), dtype=torch.float32, device=T.device)
    ASC_SWEEP.launches += 1
    _asc_launch(T, E, keys, valid, A_in, cdt, L, alphas, None, alpha_end, ASC_SWEEP)
    return alphas, alpha_end


def _asc_launch(T, E, keys, valid, A_in, cdt, blk, alphas, snaps, alpha_end, kernel):
    """One launch of K1's kernel (smcpp_asc_sweep), counted as ``kernel``'s:
    the whole stream (``alphas``), or the snapshot mode (``snaps``, every
    ``blk`` windows)."""
    S, L = keys.shape
    _cuda.check(
        _cuda.lib().smcpp_asc_sweep(
            T.data_ptr(), E.data_ptr(), keys.data_ptr(), valid.data_ptr(),
            A_in.data_ptr(), S, L, T.shape[0], E.shape[0],
            int(cdt == torch.bfloat16), blk, _ptr(alphas), _ptr(snaps),
            alpha_end.data_ptr(), _stream(T.device),
        ),
        kernel.name,
    )
    kernel.took()


def asc_sweep_plan(S, M, n_keys, bf16):
    """K1's launch on the card for these sizes: {warps per block, blocks,
    registers per thread, shared bytes per block, whether the emission
    table is in shared memory, spill bytes per thread}."""
    out = (ctypes.c_int * 6)()
    _cuda.check(_cuda.lib().smcpp_asc_sweep_plan(S, M, n_keys, int(bf16), out),
                ASC_SWEEP.name)
    keys = ("warps_per_block", "blocks", "registers", "shared_bytes",
            "shared_table", "spill_bytes")
    return dict(zip(keys, list(out)))


def asc_div_check(a, b):
    """K1's quotients, formed from one reciprocal per row, against IEEE
    division on the pairs (a, b) (f32 CUDA tensors of one shape): returns
    (the number of pairs in the range where K1's quotient is the correctly
    rounded one, the number of those whose quotients differ in any bit).  A
    check of the kernel's arithmetic; no launch of K1."""
    if a.dtype != torch.float32 or b.shape != a.shape or b.dtype != a.dtype:
        raise ValueError("asc_div_check takes two float32 tensors of one shape")
    a, b = a.contiguous(), b.contiguous()
    counts = torch.zeros(2, dtype=torch.int64, device=a.device)
    _cuda.check(_cuda.lib().smcpp_asc_div_check(
        a.data_ptr(), b.data_ptr(), a.numel(), counts.data_ptr(), _stream(a.device)),
        ASC_SWEEP.name)
    return tuple(counts.tolist())


def dsc_plan(S, L, n_keys, M):
    """The grid of K2 / K2g: (warps per block, segments per warp, blocks).

    Warp w of block b walks segments (b R + r) W + w, r < R.  R is 1 unless
    the f64 gsum partials (one n_keys x M table per block) would pass
    GSUM_PART_BYTES; then R grows until they fit.  A function of (S, n_keys,
    M) only.  Raises when a block's 64-bit fixed-point gsum table could
    overflow: (segments per block) x L x 2^GSUM_FRAC_BITS must stay under
    2^62."""
    warps = DSC_WARPS
    max_blocks = max(1, GSUM_PART_BYTES // (8 * n_keys * M))
    seg_per_warp = max(1, -(-S // (warps * max_blocks)))
    n_blocks = -(-S // (warps * seg_per_warp))
    if warps * seg_per_warp * L << GSUM_FRAC_BITS >= 1 << 62:
        raise ValueError(
            f"dsc_sweep: {warps * seg_per_warp} segments of {L} windows per "
            f"block overflow the 64-bit fixed-point gsum table "
            f"({n_keys} keys, M = {M})"
        )
    return warps, seg_per_warp, n_blocks


def _dsc_launch(kernel, T, E, keys, valid, alphas, Q_end, gam):
    "Launch K2 (gam None) or K2g (gam the (S, L, M) f32 output)."
    _check_inputs(T, E, keys, valid, Q_end)
    S, L = keys.shape
    M = T.shape[0]
    n_keys = E.shape[0]
    if alphas.shape != (S, L, M) or alphas.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("alphas must be the (S, L, M) stream of asc_sweep_cuda")
    if alphas.device != T.device or not alphas.is_contiguous():
        raise ValueError("alphas must be a contiguous tensor on T's device")
    warps, seg_per_warp, G = dsc_plan(S, L, n_keys, M)
    u_start = torch.empty((S, M), dtype=torch.float32, device=T.device)
    xo_part = torch.empty((G, M, M), dtype=torch.float64, device=T.device)
    gsum_part = torch.empty((G, n_keys, M), dtype=torch.float64, device=T.device)
    lib = _cuda.lib()
    kernel.launches += 1
    _cuda.check(
        lib.smcpp_dsc_sweep(
            T.data_ptr(), E.data_ptr(), keys.data_ptr(), valid.data_ptr(),
            alphas.data_ptr(), Q_end.data_ptr(), S, L, M, n_keys,
            int(alphas.dtype == torch.bfloat16), warps, seg_per_warp, G,
            u_start.data_ptr(), xo_part.data_ptr(), gsum_part.data_ptr(),
            _ptr(gam), _stream(T.device),
        ),
        kernel.name,
    )
    kernel.took()
    return u_start, xo_part.sum(0), gsum_part.sum(0)


def dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end):
    """K2 (replaces pallas_sweeps.py:_dsc_kernel).

    What bounds it: serial depth (L dependent window steps per segment, each
    behind two warp reductions) and 2 M^2 f32 FMAs and M^2 f64 adds per
    window.  Design (csrc/dsc_kernels.cu): one warp per segment, DSC_WARPS
    warps per block (dsc_plan); lane j owns q[j], u[j], row j of T and row
    j of the xisum accumulator in registers; u is broadcast through shared
    memory; each 32-window chunk of the alpha stream is copied with
    cp.async into a per-warp double buffer while the chunk before it runs;
    xisum terms are summed in f32 over a chunk, then added in f64.  The
    per-key masses go into one 64-bit fixed-point table per block (integer
    atomics, so the sum does not depend on the order of the block's warps),
    in shared memory when it fits, else in the block's slice of the
    partials in global memory.  The per-block partials are summed here with
    one torch.sum in f64.  Returns (u_start (S, M) f32, xo (M, M) f64, gsum
    (n_keys, M) f64)."""
    return _dsc_launch(DSC_SWEEP, T, E, keys, valid, alphas, Q_end, None)


def dsc_sweep_gamma_cuda(T, E, keys, valid, alphas, Q_end):
    """K2g (replaces the emit_gamma output of window_kernel.py:stats_pass,
    :515 and :536-538; the Pallas _dsc_kernel has no such mode).

    K2's kernel body with its gamma flag set: each window also stores
    gamma = alpha * q / Z * valid as one contiguous f32 M-vector (the
    stream is written once, 4 B x M per window; invalid windows store 0).
    Returns K2's outputs plus gamma (S, L, M) f32."""
    S, L = keys.shape
    gam = torch.empty((S, L, T.shape[0]), dtype=torch.float32, device=T.device)
    u_start, xo, gsum = _dsc_launch(
        DSC_SWEEP_GAMMA, T, E, keys, valid, alphas, Q_end, gam
    )
    return u_start, xo, gsum, gam


# K8 (csrc/remat_kernels.cu): windows a ring slot holds (REMAT_CW there) and
# the shared bytes of the producer's staged keys and flags (RematStage)
REMAT_CHUNK = 8
_REMAT_STAGE_BYTES = 2048


def remat_plan(S, L, M, n_keys, bf16, block):
    """K8's launch for these sizes, a pure function of them (the kernel's
    RematLayout): {"blocks": one block of two warps per 16 segments,
    "chunk": windows a ring slot holds, "chunks_per_block": ring chunks a
    block of ``block`` windows, "shared_bytes", "shared_table": whether the
    emission table is in shared memory (else global), "gsum_group": blocks
    of the grid adding into one slice of the gsum partials, "gsum_parts":
    slices, "carry_floats": the chunk-entry carry scratch, two blocks' worth
    a tile}.  The slices hold 64-bit fixed-point integers: gsum_group x 16 x
    L x 2^GSUM_FRAC_BITS must stay under 2^62, and the slices under
    GSUM_PART_BYTES; raises when both cannot hold."""
    if block <= 0 or L % block:
        raise ValueError(f"block {block} must divide L = {L}")
    MB = 16 if M <= 16 else 32
    elt = 2 if bf16 else 4
    slot = REMAT_CHUNK * 32 * (MB // 2) * elt + REMAT_CHUNK * 16 * 4
    base = _REMAT_STAGE_BYTES + 2 * slot + 3 * 16 * (MB + 8) * 4
    table = n_keys * (MB + 8) * 4
    shared_table = base + table <= SMEM_MAX
    blocks = -(-S // 16)
    group = max(1, -(-blocks * n_keys * M * 8 // GSUM_PART_BYTES))
    if group * 16 * L << GSUM_FRAC_BITS >= 1 << 62:
        raise ValueError(
            f"remat_sweep: {group} x 16 segments of {L} windows per gsum slice "
            f"overflow the 64-bit fixed-point table ({n_keys} keys, M = {M})"
        )
    n_chunks = -(-block // REMAT_CHUNK)
    return {
        "blocks": blocks, "chunk": REMAT_CHUNK, "chunks_per_block": n_chunks,
        "shared_bytes": base + (table if shared_table else 0),
        "shared_table": shared_table, "gsum_group": group,
        "gsum_parts": -(-blocks // group),
        "carry_floats": blocks * 2 * n_chunks * 32 * (MB // 2),
    }


def remat_sweep_plan(S, M, n_keys, bf16):
    """K8's launch on the card: {warps per block, blocks, registers per
    thread, shared bytes per block, whether the emission table is in shared
    memory, spill bytes per thread, windows a ring slot holds, blocks
    resident on an SM}."""
    out = (ctypes.c_int * 8)()
    _cuda.check(_cuda.lib().smcpp_remat_sweep_plan(S, M, n_keys, int(bf16), out),
                REMAT_SWEEP.name)
    keys = ("warps_per_block", "blocks", "registers", "shared_bytes", "shared_table",
            "spill_bytes", "chunk", "resident_blocks")
    return dict(zip(keys, list(out)))


class AlphaRemat:
    """Alpha remat on the card (replaces the alpha_remat branch of the JAX
    package's window_kernel.py:stats_pass, :567-613): two launches.
    Construct it, then call ``snap()``, then ``sweep()``, then ``finish()``,
    on the current stream (``stats_pass_remat_cuda`` does; they are separate
    so that each can be timed).

      snap()     K1 over all L windows, writing no stream: the carry entering
                 each block of ``block`` windows, rounded to the carry dtype,
                 (L / block, S, M), and alpha_end;
      sweep()    K8 (``remat_sweep``): for each block from the last, its
                 alphas recomputed from its snapshot with K1's step and the
                 descending steps over them, in one launch;
      finish()   (alpha_end (S, M), u_start (S, M), xo (M, M) f64, gsum
                 (n_keys, M) f64): K8's partials summed.

    What bounds it: K1's snapshot sweep, then K8's recompute (1 + (nc - 1) /
    nc sweeps of K1's step, nc chunks of REMAT_CHUNK windows a block) beside
    its descent (``remat_plan``).  The snapshots are rounded to the carry
    dtype (bf16 at 'default') as the reference's are, so a recomputed
    block's stream starts from that rounding; alpha_end is the unrounded
    sweep's.  The recomputed stream is K1's, entry for entry; the descent
    sums T u in f64 and xisum and gsum in f32 over a chunk or a run of
    rows before their f64 or fixed-point sums (csrc/remat_kernels.cu), so
    u_start, xo and gsum agree with the plain pass within K2's tolerances;
    every sum is formed in an order fixed by (S, L, M), so two passes are
    bit-identical."""

    def __init__(self, T, E, keys, valid, A_in, Q_end, precision, block):
        _check_inputs(T, E, keys, valid, A_in, Q_end)
        S, L = keys.shape
        M, n_keys = T.shape[0], E.shape[0]
        dev = T.device
        self.cdt = carry_dtype(precision, torch.float32)
        self.plan = remat_plan(S, L, M, n_keys, self.cdt == torch.bfloat16, block)
        self.T, self.E, self.keys, self.valid = T, E, keys, valid
        self.A_in, self.Q_end = A_in, Q_end
        self.block, self.n_blocks = block, L // block
        self.snaps = torch.empty((self.n_blocks, S, M), dtype=self.cdt, device=dev)
        self.alpha_end = torch.empty((S, M), dtype=torch.float32, device=dev)
        self.u_start = torch.empty((S, M), dtype=torch.float32, device=dev)
        MB = 16 if M <= 16 else 32  # K8's padded width
        self.xo_part = torch.zeros((self.plan["blocks"], MB, MB), dtype=torch.float64,
                                   device=dev)
        self.gsum_part = torch.zeros((self.plan["gsum_parts"], n_keys, M),
                                     dtype=torch.int64, device=dev)
        self.carries = torch.empty((max(1, self.plan["carry_floats"]),),
                                   dtype=torch.float32, device=dev)

    def snap(self):
        "K1 over every window: the snapshots and alpha_end."
        ASC_SWEEP_REMAT.launches += 1
        _asc_launch(self.T, self.E, self.keys, self.valid, self.A_in, self.cdt,
                    self.block, None, self.snaps, self.alpha_end, ASC_SWEEP_REMAT)

    def sweep(self):
        "K8 over every block, the last first: u_start and the partials."
        S, L = self.keys.shape
        M, n_keys = self.T.shape[0], self.E.shape[0]
        REMAT_SWEEP.launches += 1
        _cuda.check(
            _cuda.lib().smcpp_remat_sweep(
                self.T.data_ptr(), self.E.data_ptr(), self.keys.data_ptr(),
                self.valid.data_ptr(), self.snaps.data_ptr(), self.Q_end.data_ptr(),
                S, L, M, n_keys, int(self.cdt == torch.bfloat16), self.block,
                self.plan["gsum_group"], self.carries.data_ptr(),
                self.u_start.data_ptr(), self.xo_part.data_ptr(),
                self.gsum_part.data_ptr(), _stream(self.T.device),
            ),
            REMAT_SWEEP.name,
        )
        REMAT_SWEEP.took()

    def finish(self):
        """(alpha_end (S, M), u_start (S, M), xo (M, M) f64, gsum (n_keys, M)
        f64): the partials summed in f64, gsum's integers scaled by
        2^-GSUM_FRAC_BITS first (K2's conversion)."""
        M = self.T.shape[0]
        gsum = (self.gsum_part.double() * 2.0**-GSUM_FRAC_BITS).sum(0)
        return self.alpha_end, self.u_start, self.xo_part.sum(0)[:M, :M], gsum


def stats_pass_remat_cuda(T, E, keys, valid, A_in, Q_end, precision, block):
    """stats_pass(alpha_remat=block) on the card: ``AlphaRemat``'s two
    launches, K1's snapshot sweep (``asc_sweep_remat``) and K8
    (``remat_sweep``).  Returns (alpha_end, u_start, xo, gsum)."""
    r = AlphaRemat(T, E, keys, valid, A_in, Q_end, precision, block)
    r.snap()
    r.sweep()
    return r.finish()


def _check_states(states, S, M, dev):
    "Boundary states index rows of the backpointers: int32 (S,) in [0, M)."
    if states.dtype != torch.int32 or tuple(states.shape) != (S,):
        raise ValueError(f"boundary states must be int32 ({S},)")
    if states.device != dev or not states.is_contiguous():
        raise ValueError("boundary states must be contiguous on T's device")
    if int(states.min()) < 0 or int(states.max()) >= M:
        raise ValueError(f"boundary states must lie in [0, {M})")


def viterbi_ops_cuda(T, E, keys, valid):
    """K4 (replaces the lax.scan of window_kernel.py:viterbi_segment_ops).

    What bounds it: serial depth along L and M^2 max-adds per lane per
    operator product.  Design: K3's in max-plus; one warp per segment, lane k
    owns column k of the (M, M) operator in registers, log T^T sits in shared
    memory and is read as float4 broadcasts.  The warp applies each run of
    equal keys whole: a run shorter than ``VITERBI_RUN_MIN`` windows one
    window at a time (viterbi_ops_plain's step), a longer one as a power of
    its operator, bitlen(r) - 1 + popcount(r) products in place of r.  Exact:
    adds and maxima only; equal to ``viterbi_ops_runs_plain`` bit for bit.
    Adds its products and valid windows to ``VITERBI_OPS``'s counters.
    Returns Wops (S, M, M) f32, laid out (S, i, k)."""
    _check_inputs(T, E, keys, valid)
    S, L = keys.shape
    M = T.shape[0]
    logT = torch.log(T).contiguous()
    logE = torch.log(E).contiguous()
    ops = torch.empty((S, M, M), dtype=torch.float32, device=T.device)
    lib = _cuda.lib()
    VITERBI_OPS.launches += 1
    _cuda.check(
        lib.smcpp_viterbi_ops(
            logT.data_ptr(), logE.data_ptr(), keys.data_ptr(), valid.data_ptr(),
            S, L, M, E.shape[0], ops.data_ptr(),
            VITERBI_OPS.counts(T.device).data_ptr(), _stream(T.device),
        ),
        VITERBI_OPS.name,
    )
    VITERBI_OPS.took()
    return ops


# mirrors of csrc/common.cuh and csrc/viterbi_kernels.cu for K5's plan
WARPS_PER_BLOCK = 4
SMEM_MAX = 232448  # 227 KB, the most one block can have on sm_90
VITERBI_BACK_RING = 4


def viterbi_paths_plan(S, L, M, n_keys):
    """K5's two launches for these sizes: {grid (blocks), block (threads),
    the forward's shared bytes a block, whether its emission table is in
    shared memory ('shared_table'; else it is read from global memory), the
    backtrace's shared bytes a block, and the backpointer scratch's shape,
    dtype and bytes}.  Both launches run one warp per segment, four to a
    block.  The scratch holds L rounded up to a multiple of 4 windows a
    segment, M bytes a window, as (S, L4 / 4, M) int32 words: byte l % 4
    of word (l / 4, i) is window l's backpointer of state i."""
    MB = -(-M // 4) * 4
    rows = 4 * 2 * MB * WARPS_PER_BLOCK  # two rows of V per warp
    table = 4 * n_keys * MB
    shared_table = table + rows <= SMEM_MAX
    L4 = -(-L // 4) * 4
    return {
        "grid": -(-S // WARPS_PER_BLOCK),
        "block": 32 * WARPS_PER_BLOCK,
        "fwd_shared_bytes": (table if shared_table else 0) + rows,
        "shared_table": shared_table,
        "back_shared_bytes": WARPS_PER_BLOCK * (VITERBI_BACK_RING * 32 * M + 4 * 32),
        "scratch_shape": (S, L4 // 4, M),
        "scratch_dtype": torch.int32,
        "scratch_bytes": S * L4 * M,
    }


class ViterbiPaths:
    """K5's two launches, one at a time: construct it, then call ``fwd()``
    and ``back()`` in order on the current stream (``viterbi_paths_cuda``
    does; they are separate so that each can be timed).  The scratch is
    ``viterbi_paths_plan``'s (for ``scratch_windows`` windows a segment,
    L unless given); every launch checks its return and raises on failure."""

    def __init__(self, T, E, keys, valid, seg_entry, seg_exit, scratch_windows=None):
        _check_inputs(T, E, keys, valid)
        S, L = keys.shape
        M = T.shape[0]
        _check_states(seg_entry, S, M, T.device)
        _check_states(seg_exit, S, M, T.device)
        self.plan = viterbi_paths_plan(S, scratch_windows or L, M, E.shape[0])
        self.S, self.L, self.M, self.n_keys = S, L, M, E.shape[0]
        self.keys, self.valid = keys, valid
        self.seg_entry, self.seg_exit = seg_entry, seg_exit
        self.logT = torch.log(T).contiguous()
        self.logE = torch.log(E).contiguous()
        self.bp = torch.empty(self.plan["scratch_shape"], dtype=self.plan["scratch_dtype"],
                              device=T.device)
        self.path = torch.empty((S, L), dtype=torch.int32, device=T.device)
        self._stream = _stream(T.device)
        self._lib = _cuda.lib()

    def fwd(self):
        "Launch 1: the forward sweep, writing the backpointer scratch."
        self._fwd(None, 0, self.L, self.L, self.bp, None, VITERBI_PATHS)

    def back(self):
        "Launch 2: the backtrace; returns path (S, L) int32."
        self._back(self.seg_exit, 0, self.L, None, VITERBI_PATHS.name)
        return self.path

    def _fwd(self, V_in, lb, le, blk, bp, snaps, kernel):
        """The forward kernel over windows [lb, le) (smcpp_viterbi_paths_fwd),
        counted as ``kernel``'s."""
        _cuda.check(self._lib.smcpp_viterbi_paths_fwd(
            self.logT.data_ptr(), self.logE.data_ptr(), self.keys.data_ptr(),
            self.valid.data_ptr(), self.seg_entry.data_ptr(), _ptr(V_in), self.S,
            self.L, self.M, self.n_keys, lb, le, blk, int(self.plan["shared_table"]),
            _ptr(bp), _ptr(snaps), self._stream,
        ), kernel.name)
        kernel.took()

    def _back(self, state_in, lb, le, state_out, name):
        "The backtrace kernel over windows [lb, le) (smcpp_viterbi_paths_back)."
        _cuda.check(self._lib.smcpp_viterbi_paths_back(
            state_in.data_ptr(), self.S, self.L, self.M, lb, le, self.bp.data_ptr(),
            self.path.data_ptr(), _ptr(state_out), self._stream,
        ), name)


def viterbi_paths_cuda(T, E, keys, valid, seg_entry, seg_exit):
    """K5 (replaces the JAX package's window_kernel.py:871,
    viterbi_segment_paths with block=None): the two launches of
    ``ViterbiPaths``, counted as one.

    What bounds it: serial depth, L dependent max-plus steps forward and L
    dependent backpointer reads back, one warp per segment.  The forward
    (``fwd()``, csrc/viterbi_kernels.cu:viterbi_fwd_kernel): lane i owns
    V[i] and column i of log T in registers and reads V from a per-warp row
    of shared memory (float4 broadcasts, no shuffles); the maximum over j
    runs as four contiguous runs merged in order, so the backpointer is the
    lowest maximizing j (jnp.argmax's and torch.max's tie rule); four
    windows' backpointers go to the scratch as one word a lane.  What is
    left bounding it is its compare and select instructions, three per
    candidate j, which run at half the f32 add rate.  The backtrace
    (``back()``, viterbi_back_kernel): each warp copies its segment's
    backpointers into a shared-memory ring 32 windows at a time (cp.async,
    three blocks ahead), lane 0 walks each block back from the segment's
    exit state in shared memory, and the warp stores 32 states of the path
    at once; it is bound by the scratch's bytes.  Exact: adds and maxima
    only, each the plain version's f32 operation, so it equals
    ``viterbi_paths_plain`` bit for bit.  Returns path (S, L) int32, the
    state after each window (segment-major)."""
    k5 = ViterbiPaths(T, E, keys, valid, seg_entry, seg_exit)
    VITERBI_PATHS.launches += 1
    k5.fwd()
    return k5.back()


class ViterbiPathsBlocked(ViterbiPaths):
    """K5 blocked (replaces the block != None branch of the JAX package's
    window_kernel.py:viterbi_segment_paths, :923-946): K5's two kernels in
    their range modes, so that the (S, L, M) backpointer stream is never
    held whole.  Construct it, then call ``fwd_snap()``, then for each block
    b from the last to the first ``fwd_block(b)`` and ``back_block(b)``, on
    the current stream (``viterbi_paths_blocked_cuda`` does; they are
    separate so that each can be timed).

      fwd_snap()     K5's forward over all L windows from the entry states,
                     writing no backpointers, only the V entering each block
                     of ``block`` windows, (L / block, S, M) f32;
      fwd_block(b)   the forward over block b from its snapshot, writing its
                     backpointers into a one-block scratch (S, block, M)
                     bytes (``viterbi_paths_plan(S, block, ...)``);
      back_block(b)  the backtrace over block b from each segment's state
                     after the block (its exit state for the last), leaving
                     the state entering it for the block before.

    What bounds it: K5's, plus one more forward: 2 L serial max-plus steps
    and L backpointer reads per segment.  The snapshots are f32 and
    unrounded and every step is K5's, so the path equals K5's
    (``viterbi_paths_cuda``) and ``viterbi_paths_plain`` bit for bit, ties
    included.  ``block`` must divide L and be a multiple of 4 (four windows'
    backpointers share a word)."""

    def __init__(self, T, E, keys, valid, seg_entry, seg_exit, block):
        S, L = keys.shape
        if block <= 0 or L % block or block % 4:
            raise ValueError(f"block {block} must be a multiple of 4 dividing L = {L}")
        self.block, self.n_blocks = block, L // block
        super().__init__(T, E, keys, valid, seg_entry, seg_exit, scratch_windows=block)
        self.snaps = torch.empty((self.n_blocks, S, self.M), dtype=torch.float32,
                                 device=T.device)
        self.state = [seg_exit.clone(), torch.empty_like(seg_exit)]

    def fwd_snap(self):
        "The forward over every window, writing the V entering each block."
        VITERBI_FWD_BLOCKED.launches += 1
        self._fwd(None, 0, self.L, self.block, None, self.snaps, VITERBI_FWD_BLOCKED)

    def fwd_block(self, b):
        "The forward over block b from its snapshot, writing its backpointers."
        lb = b * self.block
        VITERBI_FWD_BLOCKED.launches += 1
        self._fwd(self.snaps[b], lb, lb + self.block, self.block, self.bp, None,
                  VITERBI_FWD_BLOCKED)

    def back_block(self, b):
        "The backtrace over block b; returns path (S, L) int32."
        lb = b * self.block
        VITERBI_BACK_BLOCKED.launches += 1
        self._back(self.state[0], lb, lb + self.block, self.state[1],
                   VITERBI_BACK_BLOCKED.name)
        self.state.reverse()
        return self.path


def viterbi_paths_blocked_cuda(T, E, keys, valid, seg_entry, seg_exit, block):
    """K5 blocked: ``ViterbiPathsBlocked``'s launches, 1 + L / block of the
    forward kernel and L / block of the backtrace.  Returns path (S, L)
    int32, equal to ``viterbi_paths_cuda``'s."""
    k5 = ViterbiPathsBlocked(T, E, keys, valid, seg_entry, seg_exit, block)
    k5.fwd_snap()
    for b in range(k5.n_blocks - 1, -1, -1):
        k5.fwd_block(b)
        k5.back_block(b)
    return k5.path


def _check_boundary_inputs(ops, seg_of_contig):
    """Validate the segment operators and the contig table the per-contig
    scans (K6, K7) take; returns (the table as int32 (C, NS) numpy, M)."""
    if ops.dtype != torch.float32:
        raise TypeError(f"the boundary kernels take float32 operators (got {ops.dtype})")
    S, M = ops.shape[0], ops.shape[-1]
    if ops.dim() != 3 or ops.shape != (S, M, M) or not 2 <= M <= 32:
        raise ValueError(
            f"operators must be (S, M, M) with 2 <= M <= 32, got {tuple(ops.shape)}"
        )
    if not ops.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    socn = np.asarray(seg_of_contig)
    if socn.ndim != 2 or socn.size == 0 or int(socn.max()) >= S:
        raise ValueError(f"seg_of_contig must be (C, NS) segment ids below {S}")
    return socn.astype(np.int32), M


# K6's chunk length: a power of two near sqrt(NS), within these bounds.
BOUNDARY_CHUNK_MIN, BOUNDARY_CHUNK_MAX = 8, 128


def boundary_plan(NS):
    """K6's chunking of a contig table with NS slots a contig: (c,
    n_chunks), c a power of two near sqrt(NS) (the nearer of the two
    around it in log scale), clamped to [BOUNDARY_CHUNK_MIN,
    BOUNDARY_CHUNK_MAX], and n_chunks = ceil(NS / c).  The dependent depth
    of a launch is c + n_chunks + c steps; with n_chunks == 1 it is NS."""
    c = 1 << max(0, int(np.floor(0.5 * np.log2(max(NS, 1)) + 0.5)))
    c = min(max(c, BOUNDARY_CHUNK_MIN), BOUNDARY_CHUNK_MAX)
    return c, -(-NS // c)


def _plan_chunk(NS, chunk):
    "The chunk length: ``chunk`` (forced, for tests) or boundary_plan's."
    if chunk is None:
        return boundary_plan(NS)[0]
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    return chunk


def _chunk_rows(socn, chunk):
    """The contig table (C, NS) padded with -1 to (C, n_chunks chunk) and
    viewed as (C n_chunks, chunk) chunk rows, in the table's dtype; returns
    (rows, n_chunks)."""
    C, NS = socn.shape
    n_chunks = -(-NS // chunk)
    rows = np.full((C, n_chunks * chunk), -1, socn.dtype)
    rows[:, :NS] = socn
    return rows.reshape(C * n_chunks, chunk), n_chunks


class BoundaryScan:
    """One launch of K6 (replaces the JAX package's window_kernel.py:358,
    contig_boundaries), phase by phase: construct it, then call
    ``products()``, ``chunk_scan()`` and ``finish()`` in order on the
    current stream (``boundary_scan_cuda`` does; the phases are separate so
    that each can be timed).

    What bounds it: serial depth.  The work (2 S M^2 FMAs, one read of the
    operators) is tiny; a sequential scan takes NS dependent steps per
    contig, each an M x M matvec behind a warp reduction.  Design
    (csrc/boundary_kernels.cu): the contig table is cut into chunk rows of c
    slots (``boundary_plan``, or ``chunk``), so the depth is c + n_chunks +
    c steps and every phase runs all chunk rows at once:

      products()    phase 1, one block per chunk row: the row's operator
                    product in f64, rescaled by a power of two after every
                    step;
      chunk_scan()  phase 2, one warp per (contig, direction): the f64 scan
                    over the contig's chunk products, writing every chunk's
                    entry (forward) and exit (backward) vector in f32;
      finish()      phase 3, two warps per chunk row: the sequential f32
                    scan of each row from its start vectors, writing A_in,
                    Q_end and each row's f64 log-likelihood partial, summed
                    here with one torch.sum (a fixed order: two launches
                    are bit-identical).

    With n_chunks == 1 phases 1-2 do nothing and phase 3 starts from pi and
    ones: the sequential scan.  The device copy of the chunk rows is made
    from pinned memory without a host sync; cvalid is computed with torch
    ops.  Every phase checks its launch and raises on failure."""

    def __init__(self, pi, ops, logs, seg_of_contig, seg_has, chunk=None):
        socn, M = _check_boundary_inputs(ops, seg_of_contig)
        C, NS = socn.shape
        S = ops.shape[0]
        dev = ops.device
        if logs.dtype != torch.float32 or tuple(logs.shape) != (S,):
            raise ValueError(f"logs must be float32 ({S},)")
        chunk = _plan_chunk(NS, chunk)
        rows, n_chunks = _chunk_rows(socn, chunk)
        self.chunk, self.n_chunks, self.M, self.C = chunk, n_chunks, M, C
        self.ops, self.logs = ops, logs.contiguous()
        self.rows = torch.from_numpy(rows).pin_memory().to(dev, non_blocking=True)
        soc = self.rows.view(C, -1)
        self.cvalid = torch.any(seg_has[soc.clamp(min=0).long()] & (soc >= 0), 1)
        self.pi = pi.to(device=dev, dtype=torch.float32).contiguous()
        R = C * n_chunks
        self.ll = torch.empty((R,), dtype=torch.float64, device=dev)
        self.A_in = torch.zeros((S, M), dtype=torch.float32, device=dev)
        self.Q_end = torch.zeros((S, M), dtype=torch.float32, device=dev)
        if n_chunks > 1:
            self.prod = torch.empty((R, M, M), dtype=torch.float64, device=dev)
            self.start_a = torch.empty((R, M), dtype=torch.float32, device=dev)
            self.start_q = torch.empty((R, M), dtype=torch.float32, device=dev)
        else:
            self.start_a = self.pi.expand(C, M).contiguous()
            self.start_q = torch.ones((C, M), dtype=torch.float32, device=dev)
        self._stream = _stream(dev)
        self._lib = _cuda.lib()

    def products(self):
        "Phase 1 (skipped with one chunk a contig)."
        if self.n_chunks > 1:
            _cuda.check(self._lib.smcpp_boundary_products(
                self.ops.data_ptr(), self.rows.data_ptr(), self.rows.shape[0],
                self.chunk, self.M, 0, self.prod.data_ptr(), self._stream,
            ), BOUNDARY_SCAN.name)

    def chunk_scan(self):
        "Phase 2 (skipped with one chunk a contig)."
        if self.n_chunks > 1:
            _cuda.check(self._lib.smcpp_boundary_chunk_scan(
                self.prod.data_ptr(), self.pi.data_ptr(), self.C, self.n_chunks,
                self.M, 0, self.start_a.data_ptr(), self.start_q.data_ptr(),
                self._stream,
            ), BOUNDARY_SCAN.name)

    def finish(self):
        """Phase 3; returns (ll f64 scalar, A_in (S, M), Q_end (S, M),
        cvalid (C,))."""
        _cuda.check(self._lib.smcpp_boundary_finish(
            self.ops.data_ptr(), self.logs.data_ptr(), self.rows.data_ptr(),
            self.cvalid.data_ptr(), self.start_a.data_ptr(),
            self.start_q.data_ptr(), self.rows.shape[0], self.chunk,
            self.n_chunks, self.M, self.ll.data_ptr(), self.A_in.data_ptr(),
            self.Q_end.data_ptr(), self._stream,
        ), BOUNDARY_SCAN.name)
        return torch.sum(self.ll), self.A_in, self.Q_end, self.cvalid


def boundary_scan_cuda(pi, ops, logs, seg_of_contig, seg_has, chunk=None):
    """K6: the three launches of ``BoundaryScan``, counted as one.
    ``chunk`` forces the chunk length (for tests; None takes
    ``boundary_plan``'s).  Returns the plain version's (ll f64 scalar, A_in
    (S, M), Q_end (S, M), cvalid (C,))."""
    k6 = BoundaryScan(pi, ops, logs, seg_of_contig, seg_has, chunk)
    BOUNDARY_SCAN.launches += 1
    k6.products()
    k6.chunk_scan()
    return k6.finish()


class ViterbiBoundary:
    """One launch of K7 (replaces the JAX package's window_kernel.py:815,
    viterbi_boundary_states), phase by phase: construct it, then call
    ``products()``, ``chunk_scan()``, ``forward()`` and ``trace()`` in
    order on the current stream (``viterbi_boundary_cuda`` does; the phases
    are separate so that each can be timed).

    What bounds it: serial depth.  The work (n M^2 adds and maxima over n
    listed segments, one read of the operators) is tiny; a sequential scan
    takes NS dependent max-plus steps per contig and its backtrace NS more.
    Design (csrc/boundary_kernels.cu): K6's chunked scan in max-plus, on the
    same chunk rows of c slots (``boundary_plan``, or ``chunk``), so the
    depth is about c + n_chunks + c + (n_chunks + c) steps:

      products()    phase 1, one block per chunk row: the row's max-plus
                    product in f64, from the max-plus identity;
      chunk_scan()  phase 2, one warp per contig: the f64 max-plus scan over
                    its chunk products from log pi, normalised to a maximum
                    of 0 after each, writing every chunk's entry vector in
                    f32;
      forward()     phase 3, one warp per chunk row: the sequential f32 step
                    of the plain version from the row's entry vector,
                    writing int8 backpointers (rows c, M), the row's exit ->
                    entry map (rows, M) and each contig's exit state (the
                    first argmax of its last row's final V);
      trace()       phase 4, one warp per chunk row: the contig's exit state
                    back through the later rows' maps to the row's exit
                    state, then the backtrace of its c slots; returns
                    (seg_entry (S,), seg_exit (S,)) int32, 0 at unlisted
                    segments.

    Max-plus rounds only in its adds, so only the entry vectors differ from
    the sequential loop (one f32 rounding of an f64 scan), and K7 equals its
    chunked twin ``viterbi_boundary_states_chunked_plain`` bit for bit.
    With n_chunks == 1 phases 1-2 do nothing and phase 3 starts from log pi:
    the sequential scan, equal to ``viterbi_boundary_states_plain``.  The
    device copy of the chunk rows is made from pinned memory without a host
    sync; no atomics (two launches are bit-identical); every phase checks
    its launch and raises on failure."""

    def __init__(self, pi, Wops, seg_of_contig, chunk=None):
        socn, M = _check_boundary_inputs(Wops, seg_of_contig)
        C, NS = socn.shape
        S = Wops.shape[0]
        dev = Wops.device
        chunk = _plan_chunk(NS, chunk)
        rows, n_chunks = _chunk_rows(socn, chunk)
        R = rows.shape[0]
        self.chunk, self.n_chunks, self.M, self.C = chunk, n_chunks, M, C
        self.W = Wops
        self.rows = torch.from_numpy(rows).pin_memory().to(dev, non_blocking=True)
        self.logpi = _log_pi(pi.to(dev), torch.float32).contiguous()
        self.bp = torch.empty((R * chunk, M), dtype=torch.int8, device=dev)
        self.maps = torch.empty((R, M), dtype=torch.int8, device=dev)
        self.cexit = torch.empty((C,), dtype=torch.int32, device=dev)
        self.seg_entry = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.seg_exit = torch.zeros((S,), dtype=torch.int32, device=dev)
        if n_chunks > 1:
            self.prod = torch.empty((R, M, M), dtype=torch.float64, device=dev)
            self.entry = torch.empty((R, M), dtype=torch.float32, device=dev)
        else:
            self.entry = self.logpi.expand(C, M).contiguous()
        self._stream = _stream(dev)
        self._lib = _cuda.lib()

    def products(self):
        "Phase 1 (skipped with one chunk a contig)."
        if self.n_chunks > 1:
            _cuda.check(self._lib.smcpp_boundary_products(
                self.W.data_ptr(), self.rows.data_ptr(), self.rows.shape[0],
                self.chunk, self.M, 1, self.prod.data_ptr(), self._stream,
            ), VITERBI_BOUNDARY.name)

    def chunk_scan(self):
        "Phase 2 (skipped with one chunk a contig)."
        if self.n_chunks > 1:
            _cuda.check(self._lib.smcpp_boundary_chunk_scan(
                self.prod.data_ptr(), self.logpi.data_ptr(), self.C, self.n_chunks,
                self.M, 1, self.entry.data_ptr(), 0, self._stream,
            ), VITERBI_BOUNDARY.name)

    def forward(self):
        "Phase 3."
        _cuda.check(self._lib.smcpp_viterbi_boundary_forward(
            self.W.data_ptr(), self.entry.data_ptr(), self.rows.data_ptr(),
            self.rows.shape[0], self.chunk, self.n_chunks, self.M,
            self.bp.data_ptr(), self.maps.data_ptr(), self.cexit.data_ptr(),
            self._stream,
        ), VITERBI_BOUNDARY.name)

    def trace(self):
        "Phase 4; returns (seg_entry (S,), seg_exit (S,)) int32."
        _cuda.check(self._lib.smcpp_viterbi_boundary_trace(
            self.rows.data_ptr(), self.bp.data_ptr(), self.maps.data_ptr(),
            self.cexit.data_ptr(), self.rows.shape[0], self.chunk, self.n_chunks,
            self.M, self.seg_entry.data_ptr(), self.seg_exit.data_ptr(),
            self._stream,
        ), VITERBI_BOUNDARY.name)
        return self.seg_entry, self.seg_exit


def viterbi_boundary_cuda(pi, Wops, seg_of_contig, chunk=None):
    """K7: the four launches of ``ViterbiBoundary``, counted as one.
    ``chunk`` forces the chunk length (for tests; None takes
    ``boundary_plan``'s).  Returns (seg_entry (S,), seg_exit (S,)) int32."""
    k7 = ViterbiBoundary(pi, Wops, seg_of_contig, chunk)
    VITERBI_BOUNDARY.launches += 1
    k7.products()
    k7.chunk_scan()
    k7.forward()
    return k7.trace()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def segment_ops_plain(T, E, keys, valid, precision, sum_dtype=None):
    """Python loop over windows: the arithmetic of _steps_block, with the
    carry laid out (S, i, k).  Returns (ops (S, M, M), logs (S,)).

    ``sum_dtype`` is the dtype in which each step's products are summed
    before the sum is rounded to the compute dtype: None sums in the compute
    dtype, as the reference does (the CPU path); torch.float64 is K3's
    summation on the card (exact products, f64 sums, one rounding), the
    plain version the kernel is held to."""
    S, L = keys.shape
    M = T.shape[0]
    dt = E.dtype
    cdt = carry_dtype(precision, T.dtype)
    tiny = torch.finfo(dt).tiny
    sdt = dt if sum_dtype is None else sum_dtype
    Tt = T.T.to(sdt)
    X = torch.eye(M, dtype=cdt, device=T.device).expand(S, M, M)
    logs = torch.zeros(S, dtype=T.dtype, device=T.device)
    for l in range(L):
        k, v = keys[:, l], valid[:, l]
        eT = E[k]  # (S, M)
        em = torch.clamp(torch.amax(eT, 1), min=tiny)
        eT = eT / em[:, None]
        Y = torch.matmul(Tt, X.to(sdt)).to(dt) * eT[:, :, None]
        Y = torch.clamp(Y, min=FLOOR)
        X = torch.where(v[:, None, None], Y, X.to(dt)).to(cdt)
        logs = logs + torch.where(v, torch.log(em), 0.0)
        if (l + 1) % RESCALE_EVERY == 0:
            Xf = X.to(dt)
            m = torch.clamp(torch.amax(torch.abs(Xf), (1, 2)), min=tiny)
            X = (Xf / m[:, None, None]).to(cdt)
            logs = logs + torch.log(m)
    return X.to(T.dtype), logs


def asc_sweep_plain(T, E, keys, valid, A_in, precision, sum_dtype=None):
    """The ascending alpha sweep of stats_pass.  Returns (alphas (S, L, M)
    in the carry dtype, alpha_end (S, M)).

    ``sum_dtype`` is the dtype in which each window's products a T are
    summed before the sum is rounded to the compute dtype, as in
    ``segment_ops_plain``: None sums in the compute dtype, as the reference
    does (the CPU path); torch.float64 is K1's summation on the card (exact
    products, f64 sums, one rounding; then the emission product and the
    division by the row maximum in the compute dtype), the plain version the
    kernel is held to."""
    S, L = keys.shape
    M = T.shape[0]
    dt = E.dtype
    cdt = carry_dtype(precision, dt)
    tiny = torch.finfo(dt).tiny
    sdt = dt if sum_dtype is None else sum_dtype
    Ts = T.to(sdt)
    a = A_in.to(dt)
    alphas = torch.empty((S, L, M), dtype=cdt, device=T.device)
    for l in range(L):
        # anew[s, i] = e[s, i] sum_j T[j, i] a[s, j]
        anew = E[keys[:, l]] * (a.to(sdt) @ Ts).to(dt)
        anew = anew / torch.clamp(torch.amax(anew, 1, keepdim=True), min=tiny)
        a = torch.where(valid[:, l, None], anew, a)
        alphas[:, l] = a.to(cdt)
    return alphas, a


def dsc_sweep_plain(T, E, keys, valid, alphas, Q_end, emit_gamma=False,
                    sum_dtype=None):
    """The descending beta sweep of stats_pass, accumulating like the XLA
    reference: each window's per-key masses and outer products are summed
    over segments in the compute dtype, then added to f64 accumulators.
    Returns (u_start (S, M), xo (M, M) f64, gsum (n_keys, M) f64), and with
    ``emit_gamma`` also each window's posterior (S, L, M) in the compute
    dtype (zero at invalid windows).

    ``sum_dtype`` is the dtype of each window's per-key sums g_k: None sums
    in the compute dtype, as the reference does (the CPU path);
    torch.float64 forms them in f64, the plain version K2's gsum (64-bit
    fixed point) is held to on the card, where the order of
    ``index_add_``'s atomics varies from run to run and an f32 sum moves
    with it."""
    S, L = keys.shape
    M = T.shape[0]
    n_keys = E.shape[0]
    dt = E.dtype
    xo = torch.zeros((M, M), dtype=torch.float64, device=T.device)
    gsum = torch.zeros((n_keys, M), dtype=torch.float64, device=T.device)
    gam = torch.empty((S, L, M), dtype=dt, device=T.device) if emit_gamma else None
    _, u = _dsc_steps(T, E, keys, valid, _vnext(valid), alphas, Q_end.to(dt),
                      torch.zeros((S, M), dtype=dt, device=T.device), xo, gsum,
                      gam, sum_dtype)
    if emit_gamma:
        return u, xo, gsum, gam
    return u, xo, gsum


def _vnext(valid):
    "The valid flag of each window's successor (False after the last)."
    return torch.cat([valid[:, 1:], torch.zeros_like(valid[:, :1])], 1)


def _dsc_steps(T, E, keys, valid, vnext, alphas, q, u, xo, gsum, gam=None,
               sum_dtype=None):
    """The descending steps of ``dsc_sweep_plain`` over the windows of keys,
    valid, vnext and alphas (S, n, ...), last first, from the beta carries
    (q, u); adds into xo and gsum in place, writes gam[:, l] when given.
    Returns the carries (q, u) after the first window."""
    n_keys, M = E.shape
    dt = E.dtype
    tiny = torch.finfo(dt).tiny
    for l in range(keys.shape[1] - 1, -1, -1):
        a = alphas[:, l].to(dt)
        k = keys[:, l]
        v, vn = valid[:, l, None], vnext[:, l, None]
        tv = u @ T.T  # tv[s, j] = sum_i T[j, i] u[s, i]
        qun = torch.where(vn, tv, q)
        Z = torch.clamp(torch.sum(a * qun, 1, keepdim=True), min=tiny)
        gamma = (a * qun / Z) * v
        if gam is not None:
            gam[:, l] = gamma
        ascale = (a / Z) * (v & vn)
        g_k = torch.zeros((n_keys, M), dtype=sum_dtype or dt, device=T.device)
        g_k.index_add_(0, k.long(), gamma.to(g_k.dtype))
        gsum += g_k.to(torch.float64)
        xo += (ascale.T @ u).to(torch.float64)
        qn = qun / torch.clamp(torch.amax(qun, 1, keepdim=True), min=tiny)
        q = torch.where(v, qn, q)
        u = torch.where(v, E[k] * q, u)
    return q, u


def stats_pass_remat_plain(T, E, keys, valid, A_in, Q_end, precision, block,
                           sum_dtype=None):
    """stats_pass(alpha_remat=block) as plain torch (window_kernel.py:567-613):
    the ascending sweep block by block, keeping only the carry entering each
    block rounded to the carry dtype; then, block by block from the last,
    that block's alphas recomputed from its snapshot (``asc_sweep_plain``)
    and the descending steps over them (``_dsc_steps``), the beta carries
    and the accumulators passed on.  ``sum_dtype`` is both sweeps' (the
    kernels' plain version at torch.float64).  Returns (alpha_end, u_start,
    xo, gsum)."""
    S, L = keys.shape
    n_keys, M = E.shape
    dt = E.dtype
    cdt = carry_dtype(precision, dt)
    if block <= 0 or L % block:
        raise ValueError(f"block {block} must divide L = {L}")
    blocks = [slice(l0, l0 + block) for l0 in range(0, L, block)]
    a, snaps = A_in.to(dt), []
    for b in blocks:
        snaps.append(a.to(cdt))
        _, a = asc_sweep_plain(T, E, keys[:, b], valid[:, b], a, precision, sum_dtype)
    vnext = _vnext(valid)
    q, u = Q_end.to(dt), torch.zeros((S, M), dtype=dt, device=T.device)
    xo = torch.zeros((M, M), dtype=torch.float64, device=T.device)
    gsum = torch.zeros((n_keys, M), dtype=torch.float64, device=T.device)
    for b, snap in zip(blocks[::-1], snaps[::-1]):
        alphas, _ = asc_sweep_plain(T, E, keys[:, b], valid[:, b], snap.to(dt),
                                    precision, sum_dtype)
        q, u = _dsc_steps(T, E, keys[:, b], valid[:, b], vnext[:, b], alphas, q, u,
                          xo, gsum, sum_dtype=sum_dtype)
    return a, u, xo, gsum


def remat_chunks_plain(T, E, keys, valid, snap, precision, chunk=REMAT_CHUNK,
                       sum_dtype=torch.float64):
    """K8's recompute of one block as plain torch: keys and valid (S, blk)
    are the block's, snap (S, M) its snapshot in the carry dtype.  The
    ascending sweep from the snapshot keeps the f32 carry entering each
    chunk of ``chunk`` windows, then each chunk is swept again from its
    carry, the last first (the order K8's producer hands them over).
    Returns the block's stream (S, blk, M) in the carry dtype, assembled
    from the chunks; it equals ``asc_sweep_plain`` over the whole block bit
    for bit, because the step renormalises every window and so depends only
    on the carry it starts from."""
    blk = keys.shape[1]
    starts = range(0, blk, chunk)
    carries, a = [], snap.to(E.dtype)
    for l0 in starts:
        carries.append(a)
        if l0 + chunk < blk:
            _, a = asc_sweep_plain(T, E, keys[:, l0:l0 + chunk], valid[:, l0:l0 + chunk],
                                   a, precision, sum_dtype)
    out = torch.empty((keys.shape[0], blk, T.shape[0]), dtype=snap.dtype, device=T.device)
    for l0, a in zip(list(starts)[::-1], carries[::-1]):
        sl = slice(l0, l0 + chunk)
        out[:, sl], _ = asc_sweep_plain(T, E, keys[:, sl], valid[:, sl], a, precision,
                                        sum_dtype)
    return out


def _mp_neg(dt, dev):
    "The max-plus 'impossible' score (window_kernel.py:_mp_neg)."
    return torch.tensor(-1e30, dtype=dt, device=dev)


def viterbi_ops_plain(T, E, keys, valid):
    """Phase A's loop over windows: the arithmetic of viterbi_segment_ops's
    step, with W laid out (S, i, k).  Returns Wops (S, M, M)."""
    S, L = keys.shape
    M = T.shape[0]
    dt, dev = E.dtype, T.device
    logT = torch.log(T)  # [j, i]
    logE = torch.log(E)
    eye = torch.eye(M, dtype=torch.bool, device=dev)
    W = torch.where(eye, 0.0, _mp_neg(dt, dev)).expand(S, M, M)
    for l in range(L):
        le = logE[keys[:, l]]  # (S, M_i)
        sc = logT[None, :, :, None] + W[:, :, None, :]  # (S, j, i, k)
        W2 = torch.amax(sc, 1) + le[:, :, None]
        W2 = W2 - torch.amax(W2, (1, 2), keepdim=True)
        W = torch.where(valid[:, l, None, None], W2, W)
    return W.contiguous()


# K4's cut-off (RUN_MIN in csrc/viterbi_kernels.cu): a run of equal keys
# shorter than this is walked a window at a time, a longer one applied as a
# power of its operator.
VITERBI_RUN_MIN = 8


def viterbi_runs(keys, valid):
    """Each segment's runs of equal keys, as K4 finds them: maximal stretches
    of valid windows of one key; an invalid window ends a run and belongs to
    none.  Returns (seg, key, length) int64 numpy arrays, the runs in segment
    order, then window order."""
    k = np.asarray(keys.cpu() if torch.is_tensor(keys) else keys)
    v = np.asarray(valid.cpu() if torch.is_tensor(valid) else valid).astype(bool)
    start = v.copy()
    start[:, 1:] &= ~v[:, :-1] | (k[:, 1:] != k[:, :-1])
    run = np.cumsum(start.reshape(-1)) - 1  # each window's run, among valid ones
    first = np.flatnonzero(start.reshape(-1))
    length = np.bincount(run[v.reshape(-1)], minlength=len(first))
    return first // k.shape[1], k.reshape(-1)[first].astype(np.int64), length


def run_products(r):
    """K4's max-plus operator products for runs of r >= 0 windows: r below
    ``VITERBI_RUN_MIN`` (the walk), else bitlen(r) - 1 squarings and
    popcount(r) products into the segment's operator."""
    r = np.asarray(r, np.int64)
    squarings = np.floor(np.log2(np.maximum(r, 1))).astype(np.int64)
    ones = sum((r >> b) & 1 for b in range(63))
    return np.where(r < VITERBI_RUN_MIN, r, squarings + ones)


def viterbi_ops_counts(keys, valid):
    """(products, windows): what one K4 launch on these windows adds to its
    counters, from the run plan (``viterbi_runs``, ``run_products``)."""
    _, _, length = viterbi_runs(keys, valid)
    return int(run_products(length).sum()), int(length.sum())


def viterbi_ops_runs_plain(T, E, keys, valid):
    """K4's algorithm as plain torch, its twin: each segment's runs
    (``viterbi_runs``) in order; a run of r < ``VITERBI_RUN_MIN`` windows of
    key q takes r of viterbi_ops_plain's steps, a longer one applies A^r, A
    = A_q (A[i][j] = log T[j, i] + log E[q, i]), by binary powers: B = A;
    for each bit of r from the lowest, W <- B (x) W where the bit is set,
    then B <- B (x) B (none after the highest bit); each power's product P
    is renormalised as max(P - max P, -1e30).  Every entry is one rounded
    add and maxima, in the kernel's order, so K4 equals it bit for bit on
    one device; it equals the walk (``viterbi_ops_plain``) up to the
    grouping of each path's sums.  Returns Wops (S, M, M), laid out (S, i,
    k)."""
    S, L = keys.shape
    M = T.shape[0]
    dt, dev = E.dtype, T.device
    logT = torch.log(T)  # [j, i]
    logE = torch.log(E)
    neg = _mp_neg(dt, dev)
    eye = torch.where(torch.eye(M, dtype=torch.bool, device=dev), 0.0, neg)

    def prod(R, X):  # (R (x) X)[i, k] = max_j R[i, j] + X[j, k]
        return torch.amax(R[:, :, None] + X[None, :, :], 1)

    def renorm(P):
        return torch.clamp_min(P - torch.amax(P), neg)

    out = torch.empty((S, M, M), dtype=dt, device=dev)
    seg, key, length = viterbi_runs(keys, valid)
    bounds = np.searchsorted(seg, np.arange(S + 1))
    for s in range(S):
        W = eye
        for q, r in zip(key[bounds[s]:bounds[s + 1]].tolist(),
                        length[bounds[s]:bounds[s + 1]].tolist()):
            le = logE[q]
            if r < VITERBI_RUN_MIN:
                for _ in range(r):
                    W2 = torch.amax(logT[:, :, None] + W[:, None, :], 0) + le[:, None]
                    W = W2 - torch.amax(W2)
                continue
            B = logT.T + le[:, None]
            while True:
                if r & 1:
                    W = renorm(prod(B, W))
                r >>= 1
                if r == 0:
                    break
                B = renorm(prod(B, B))
        out[s] = W
    return out


def _viterbi_forward(logT, logE, keys, valid, V, l0, l1, bp=None):
    """Phase C's forward steps over windows [l0, l1): V (S, M) -> V, storing
    each window's backpointers (lowest maximizing j; the identity at invalid
    windows) into bp[:, l - l0] when bp is given."""
    S, M = V.shape
    ident = torch.arange(M, device=V.device).expand(S, M)
    for l in range(l0, l1):
        sc = logT[None] + V[:, :, None]  # (S, j, i)
        best, arg = torch.max(sc, 1)  # ties: the first maximal index
        V2 = best + logE[keys[:, l]]
        V2 = V2 - torch.amax(V2, 1, keepdim=True)
        v = valid[:, l, None]
        V = torch.where(v, V2, V)
        if bp is not None:
            bp[:, l - l0] = torch.where(v, arg, ident).to(torch.int8)
    return V


def _viterbi_backtrace(bp, state, path, l0):
    """Walk backpointers bp (S, n, M) back from ``state`` (S,), writing the
    state after each window into path[:, l0:l0 + n]; returns the state
    entering window l0."""
    for t in range(bp.shape[1] - 1, -1, -1):
        path[:, l0 + t] = state
        state = torch.gather(bp[:, t], 1, state[:, None].long())[:, 0].to(state.dtype)
    return state


def viterbi_paths_plain(T, E, keys, valid, seg_entry, seg_exit, block=None):
    """Phase C: the forward sweep storing int8 backpointers, then the
    reverse backtrace.  With ``block`` (a divisor of L), only the V entering
    each block is stored, and the backtrace recomputes one block's
    backpointers at a time from it (window_kernel.py:923-948).  Returns path
    (S, L) int32."""
    S, L = keys.shape
    M = T.shape[0]
    dt, dev = E.dtype, T.device
    logT, logE = torch.log(T), torch.log(E)
    V = torch.where(
        torch.arange(M, device=dev)[None, :] == seg_entry[:, None].long(),
        0.0, _mp_neg(dt, dev),
    )
    path = torch.empty((S, L), dtype=torch.int32, device=dev)
    state = seg_exit.to(torch.int32)
    if block is None:
        bp = torch.empty((S, L, M), dtype=torch.int8, device=dev)
        _viterbi_forward(logT, logE, keys, valid, V, 0, L, bp)
        _viterbi_backtrace(bp, state, path, 0)
        return path
    if L % block:
        raise ValueError(f"block {block} must divide L = {L}")
    snaps = []
    for l0 in range(0, L, block):
        snaps.append(V)
        V = _viterbi_forward(logT, logE, keys, valid, V, l0, l0 + block)
    bp = torch.empty((S, block, M), dtype=torch.int8, device=dev)
    for b in range(L // block - 1, -1, -1):
        l0 = b * block
        _viterbi_forward(logT, logE, keys, valid, snaps[b], l0, l0 + block, bp)
        state = _viterbi_backtrace(bp, state, path, l0)
    return path


# ---------------------------------------------------------------------------
# Public E-step functions (JAX layouts at the boundary)
# ---------------------------------------------------------------------------

def segment_operators(T, E, keys, valid, precision=None):
    """Transfer operators for S segments of L windows each
    (window_kernel.py:segment_operators).  keys, valid: (S, L), L a multiple
    of RESCALE_EVERY.  Returns ops (S, M, M), applied as
    alpha_out = ops[s] @ alpha_in, and logs (S,)."""
    precision = _precision(precision)
    if keys.shape[1] % RESCALE_EVERY:
        raise ValueError(f"L must be a multiple of {RESCALE_EVERY}")
    if T.is_cuda:
        return segment_ops_cuda(T, E, keys, valid, precision)
    return segment_ops_plain(T, E, keys, valid, precision)


def contig_boundaries(pi, ops, logs, seg_of_contig, seg_has):
    """Total loglik + per-segment boundary vectors from segment operators
    (window_kernel.py:contig_boundaries).  Returns (ll (f64 scalar),
    A_in (S, M), Q_end (S, M), cvalid (C,)): A_in[s] is the normalized
    forward vector at the start of segment s (pi for a contig's first
    segment), Q_end[s] the normalized backward vector at its end (ones for a
    contig's last); segments no contig lists hold zeros.  K6 on CUDA
    tensors."""
    if ops.is_cuda:
        return boundary_scan_cuda(pi, ops, logs, seg_of_contig, seg_has)
    return contig_boundaries_plain(pi, ops, logs, seg_of_contig, seg_has)


def _contig_valid(socn, seg_has):
    "cvalid (C,): whether a contig lists a segment with a valid window."
    pad = torch.as_tensor(socn < 0, device=seg_has.device)
    idx = torch.as_tensor(np.maximum(socn, 0), device=seg_has.device)
    return torch.any(torch.where(pad, False, seg_has[idx]), 1)


def _fmaf(a, b, c):
    """CUDA's fmaf(a, b, c) on f32 tensors: the exact product (in f64) plus
    c, rounded to f32; the f64 sum's own rounding changes the result only
    when it lands on an f32 tie, about once in 2^28.  Other dtypes: a b +
    c."""
    if c.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def _kernel_matvec(P, x, transpose):
    """K6's step product in its order: v_i = sum_j P[r, i, j] x[r, j] (or
    with ``transpose`` v_j = sum_i P[r, i, j] x[r, i]), one fmaf chain in
    the summed index from 0 up, as each lane of the kernel forms it."""
    acc = torch.zeros_like(x)
    for k in range(x.shape[1]):
        acc = _fmaf(P[:, k, :] if transpose else P[:, :, k], x[:, k:k + 1], acc)
    return acc


def _warp_sum(v):
    """The kernels' warp_sum of each row of v (R, M), M <= 32: the xor
    butterfly over 32 lanes (zeros past M), in v's dtype."""
    lanes = torch.zeros((v.shape[0], 32), dtype=v.dtype, device=v.device)
    lanes[:, :v.shape[1]] = v
    idx = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    return lanes[:, 0]


def _scan_rows_plain(ops, logs, socn, alpha, q, cv, kernel_order=False):
    """The sequential boundary scans in the operators' dtype, batched over
    the rows of the table ``socn`` (R, n) (-1: a padded slot, the identity
    with log scale 0): forward from alpha (R, M), backward from q (R, M);
    cv (R,) masks each row's log-likelihood terms.  Returns (ll (R,) f64,
    A_in (S, M), Q_end (S, M)), each listed segment's vector before and
    after it, the rest zero.  ``kernel_order`` forms each step's products
    and sums as K6's finish does (``_kernel_matvec``, ``_warp_sum``) in
    place of einsum and torch.sum."""
    R, NS = socn.shape
    S, M = ops.shape[0], ops.shape[-1]
    dev, dt = ops.device, ops.dtype
    tiny = torch.finfo(dt).tiny
    pad = torch.as_tensor(socn < 0, device=dev)
    idx = torch.as_tensor(np.maximum(socn, 0), device=dev)
    eye = torch.eye(M, dtype=dt, device=dev)
    ops_c = torch.where(pad[:, :, None, None], eye, ops[idx])  # (R, NS, M, M)
    logs_c = torch.where(pad, 0.0, logs[idx])

    ll = torch.zeros(R, dtype=torch.float64, device=dev)
    a_pre = []
    for t in range(NS):
        a_pre.append(alpha)
        if kernel_order:
            v = _kernel_matvec(ops_c[:, t], alpha, False)
            c = _warp_sum(v)
        else:
            v = torch.einsum("cij,cj->ci", ops_c[:, t], alpha)
            c = torch.sum(v, 1)
        dll = (torch.log(c) + logs_c[:, t]).to(torch.float64)
        ll = ll + torch.where(cv, dll, 0.0)
        alpha = v / c[:, None]
    q_post = [None] * NS
    for t in range(NS - 1, -1, -1):
        q_post[t] = q
        if kernel_order:
            qn = _kernel_matvec(ops_c[:, t], q, True)
        else:
            qn = torch.einsum("cij,ci->cj", ops_c[:, t], q)
        q = qn / torch.clamp(torch.amax(qn, 1, keepdim=True), min=tiny)
    m = torch.as_tensor(socn >= 0, device=dev)
    rows = torch.as_tensor(socn[socn >= 0], device=dev)
    A_in = torch.zeros((S, M), dtype=dt, device=dev)
    Q_end = torch.zeros((S, M), dtype=dt, device=dev)
    A_in[rows] = torch.stack(a_pre, 1)[m]
    Q_end[rows] = torch.stack(q_post, 1)[m]
    return ll, A_in, Q_end


def contig_boundaries_plain(pi, ops, logs, seg_of_contig, seg_has):
    """contig_boundaries as plain torch: a loop over the segment axis of
    each contig, batched over contigs, forward then backward."""
    socn = np.asarray(seg_of_contig)
    C, M = socn.shape[0], ops.shape[-1]
    cvalid = _contig_valid(socn, seg_has)
    ll, A_in, Q_end = _scan_rows_plain(
        ops, logs, socn, pi.to(ops.dtype).expand(C, M),
        torch.ones((C, M), dtype=ops.dtype, device=ops.device), cvalid,
    )
    return torch.sum(ll), A_in, Q_end, cvalid


def chunk_products_plain(ops, rows):
    """K6's phase 1 as plain torch: for each row of ``rows`` (R, c) segment
    ids (-1: padded, skipped), the ordered product ops[rows[r, c-1]] ...
    ops[rows[r, 0]] in f64, from the identity, scaled after every step by
    the power of two that puts its largest entry in [1, 2).  Returns (R, M,
    M) f64."""
    rows = torch.as_tensor(np.asarray(rows), device=ops.device)
    R, c = rows.shape
    M = ops.shape[-1]
    P = torch.eye(M, dtype=torch.float64, device=ops.device).repeat(R, 1, 1)
    for t in range(c):
        s = rows[:, t]
        nxt = torch.matmul(ops[s.clamp(min=0)].to(torch.float64), P)
        _, ex = torch.frexp(torch.amax(torch.abs(nxt), (1, 2)))
        nxt = nxt * torch.exp2((1 - ex).to(torch.float64))[:, None, None]
        P = torch.where((s >= 0)[:, None, None], nxt, P)
    return P


def _chunk_scan_plain(pi, prod, C, n_chunks):
    """K6's phase 2 as plain torch, in f64: each contig's forward scan over
    its n_chunks products (prod (C n_chunks, M, M)) from pi, recording
    every chunk's entry vector, and its backward scan over their transposes
    from ones, recording every chunk's exit vector.  Returns (entry, exit)
    (C n_chunks, M) f64."""
    M = prod.shape[-1]
    P = prod.view(C, n_chunks, M, M)
    f64 = torch.float64
    a = pi.to(device=prod.device, dtype=f64).expand(C, M)
    q = torch.ones((C, M), dtype=f64, device=prod.device)
    entry = torch.empty((C, n_chunks, M), dtype=f64, device=prod.device)
    exit_ = torch.empty_like(entry)
    for k in range(n_chunks):
        entry[:, k] = a
        v = torch.einsum("cij,cj->ci", P[:, k], a)
        a = v / torch.sum(v, 1, keepdim=True)
    for k in range(n_chunks - 1, -1, -1):
        exit_[:, k] = q
        qn = torch.einsum("cij,ci->cj", P[:, k], q)
        q = qn / torch.clamp(torch.amax(qn, 1, keepdim=True), min=torch.finfo(f64).tiny)
    return entry.view(-1, M), exit_.view(-1, M)


def contig_boundaries_chunked_plain(pi, ops, logs, seg_of_contig, seg_has, chunk):
    """K6's chunked scan as plain torch, the twin the kernel is held to
    (neither the CPU path nor the main path calls it): the contig table cut
    into chunk rows of ``chunk`` slots (``_chunk_rows``); the chunk products
    in f64 (``chunk_products_plain``); the f64 scan over each contig's
    chunks for every row's start vectors (``_chunk_scan_plain``), rounded to
    the operators' dtype; then the sequential scan of every row at once from
    them in that dtype, each step's products and sums formed in the
    kernel's order (an fmaf chain, the warp butterfly), each row's f64
    log-likelihood partial masked by its contig's cvalid, the partials summed
    with one torch.sum.  With one chunk a contig, the rows start from pi and
    ones: K6's sequential scan.
    Returns (ll f64 scalar, A_in (S, M), Q_end (S, M), cvalid (C,))."""
    socn = np.asarray(seg_of_contig)
    C, M = socn.shape[0], ops.shape[-1]
    dt, dev = ops.dtype, ops.device
    rows, n_chunks = _chunk_rows(socn, chunk)
    cvalid = _contig_valid(socn, seg_has)
    if n_chunks > 1:
        entry, exit_ = _chunk_scan_plain(pi, chunk_products_plain(ops, rows), C, n_chunks)
        a0, q0 = entry.to(dt), exit_.to(dt)
    else:
        a0 = pi.to(device=dev, dtype=dt).expand(C, M)
        q0 = torch.ones((C, M), dtype=dt, device=dev)
    ll, A_in, Q_end = _scan_rows_plain(
        ops, logs, rows, a0, q0, cvalid.repeat_interleave(n_chunks),
        kernel_order=True)
    return torch.sum(ll), A_in, Q_end, cvalid


def stats_pass(T, E, keys, valid, A_in, Q_end, e_all=None, precision=None,
               alpha_remat=None, emit_gamma=False):
    """Lockstep alpha/beta sweeps accumulating within-segment statistics
    (window_kernel.py:stats_pass).  Returns (alpha_end (S, M), u_start
    (S, M), xo (M, M) f64, gsum (n_keys, M) f64), where xo is the raw
    outer-product accumulator (multiply by T for the xisum contribution).

    ``emit_gamma`` also returns the per-window posterior stream, laid out
    (S, L, M) (segment-major, i.e. genomic order; the reference's is
    (L, M, S)) in the compute dtype: each valid window's gamma sums to 1,
    invalid windows hold 0.

    ``alpha_remat`` (a block size dividing L, or None): keep only the carry
    entering each block and recompute each block's alphas during the
    descending sweep (``stats_pass_remat_cuda``, ``stats_pass_remat_plain``);
    it excludes ``emit_gamma``, as in the reference.

    On CUDA tensors: K1 then K2, or K1 then K2g with ``emit_gamma``, or
    alpha remat's K1 snapshot sweep then K8 (``AlphaRemat``).  The emission
    stream ``e_all`` is not ported and raises."""
    if e_all is not None:
        raise NotImplementedError(
            "stats_pass: the e_all emission stream is not ported; the sweeps "
            "gather emission rows instead"
        )
    precision = _precision(precision)
    if alpha_remat is not None:
        if emit_gamma:
            raise ValueError("emit_gamma requires alpha_remat=None")
        remat = stats_pass_remat_cuda if T.is_cuda else stats_pass_remat_plain
        return remat(T, E, keys, valid, A_in, Q_end, precision, int(alpha_remat))
    if T.is_cuda:
        alphas, alpha_end = asc_sweep_cuda(T, E, keys, valid, A_in, precision)
        dsc = dsc_sweep_gamma_cuda if emit_gamma else dsc_sweep_cuda
        return (alpha_end, *dsc(T, E, keys, valid, alphas, Q_end))
    alphas, alpha_end = asc_sweep_plain(T, E, keys, valid, A_in, precision)
    return (alpha_end,
            *dsc_sweep_plain(T, E, keys, valid, alphas, Q_end, emit_gamma))


def boundary_stats(pi, T, alpha_end, u_start, xo, seg_of_contig, cvalid):
    """Transitions crossing segment boundaries + each contig's initial
    transition out of pi (window_kernel.py:boundary_stats).  Returns
    (xo with boundary outer products added, pi_stat (M,))."""
    socn = np.asarray(seg_of_contig)
    dt, dev = alpha_end.dtype, alpha_end.device
    tiny = torch.finfo(dt).tiny
    a, b = socn[:, :-1], socn[:, 1:]
    m = (a >= 0) & (b >= 0)
    if m.any():
        ae = alpha_end[torch.as_tensor(a[m], device=dev)]
        us = u_start[torch.as_tensor(b[m], device=dev)]
        tv = us @ T.T
        Z = torch.clamp(torch.sum(ae * tv, 1), min=tiny)
        xo = xo + ((ae / Z[:, None]).T @ us).to(xo.dtype)
    first = socn[:, 0]
    has_first = torch.as_tensor(first >= 0, device=dev)
    uf = u_start[torch.as_tensor(np.maximum(first, 0), device=dev)]
    tvc = uf @ T.T
    piB = pi.to(dt).expand(uf.shape)
    Zc = torch.clamp(torch.sum(piB * tvc, 1), min=tiny)
    w = (has_first & cvalid).to(dt)[:, None]
    scale = piB / Zc[:, None] * w
    pi_stat = torch.sum(scale * tvc, 0)
    xo = xo + (scale.T @ uf).to(xo.dtype)
    return xo, pi_stat


def _boundaries(pi, T, E, keys, valid, seg_of_contig, precision, mesh):
    """K3 on the segments, then K6 over every segment (all ranks' under a
    ``mesh``, gathered in segment order, the scan replicated).  Returns
    (ll, A_in, Q_end, cvalid, lo): the boundary vectors of this rank's
    segments, which start at global segment ``lo``."""
    ops, logs = segment_operators(T, E, keys, valid, precision)
    has = torch.any(valid, 1).to(torch.uint8)
    ops, logs = mesh_mod.gather_rows(mesh, ops), mesh_mod.gather_rows(mesh, logs)
    seg_has = mesh_mod.gather_rows(mesh, has).bool()
    ll, A_in, Q_end, cvalid = contig_boundaries(
        pi, ops, logs, seg_of_contig, seg_has
    )
    S = keys.shape[0]
    lo = mesh_mod.block_start(mesh, S)
    return (ll, A_in[lo : lo + S].contiguous(), Q_end[lo : lo + S].contiguous(),
            cvalid, lo)


def estep_direct(pi, T, E, keys, valid, seg_of_contig, precision=None,
                 alpha_remat=None, mesh=None):
    """Direct Baum-Welch E-step (window_kernel.py:estep_direct).  Returns
    (ll, pi-stat, xisum, gamma_sums): ll and the statistics in f64.
    ``alpha_remat`` is stats_pass's (a block size, or None: the stored
    alpha stream).

    Under a ``mesh`` (parallel/mesh.py; mesh.py:make_sharded_direct_estep)
    keys and valid are this rank's block of the global segment rows and
    seg_of_contig the global table: K3 on the block, the operators gathered,
    K6 replicated, K1 and K2 on the block, xo and gsum summed over the ranks
    (f64), alpha_end and u_start gathered, ``boundary_stats`` replicated;
    every rank returns the global result."""
    precision = _precision(precision)
    ll, A_in, Q_end, cvalid, _ = _boundaries(
        pi, T, E, keys, valid, seg_of_contig, precision, mesh
    )
    alpha_end, u_start, xo, gsum = stats_pass(
        T, E, keys, valid, A_in, Q_end, precision=precision,
        alpha_remat=alpha_remat,
    )
    xo, gsum = mesh_mod.reduce_sum(mesh, xo), mesh_mod.reduce_sum(mesh, gsum)
    alpha_end = mesh_mod.gather_rows(mesh, alpha_end)
    u_start = mesh_mod.gather_rows(mesh, u_start)
    xo, pi_stat = boundary_stats(
        pi, T, alpha_end, u_start, xo, seg_of_contig, cvalid
    )
    return ll, pi_stat, xo * T.to(xo.dtype), gsum


# ---------------------------------------------------------------------------
# Posterior decode and MAP decode through the window kernels
# ---------------------------------------------------------------------------

# Rows of one block of the two-level prefix sum (decode_gammas_windows).
PREFIX_BLOCK = 1024


def rows_from_windows(gam, row_ends, base=0):
    """Per-row sums of a flat (W, M) per-window stream, as a prefix-sum
    difference at the rows' last windows (window_kernel.py:737-749): f32
    prefix sums within blocks of PREFIX_BLOCK windows, computed in place
    (``gam`` is overwritten), f64 across the block totals, gathered at
    ``row_ends`` and differenced, then clamped at 0.  Returns (n_rows, M)
    f32.

    ``base`` is the flat index of the stream's first window in a longer
    stream that ``row_ends`` index (one rank's block of segments,
    parallel/mesh.py): the prefix sum is 0 before the block and its total
    after it, so each row gets the part of its windows that lie in the
    block."""
    M = gam.shape[-1]
    flat = gam.reshape(-1, M)
    B = PREFIX_BLOCK
    while flat.shape[0] % B:
        B //= 2
    nb = flat.shape[0] // B
    within = flat.view(nb, B, M).cumsum_(1)  # f32, in place
    btot = within[:, -1, :].to(torch.float64)
    bbase = torch.cumsum(btot, 0) - btot  # exclusive block prefixes
    pos = (row_ends - base).clamp(-1, flat.shape[0] - 1)
    at = pos.clamp(min=0)
    picked = bbase[at // B] + flat[at].to(torch.float64)
    picked = torch.where((pos >= 0)[:, None], picked, 0.0)
    g = torch.diff(picked, dim=0, prepend=torch.zeros_like(picked[:1]))
    return torch.clamp(g, min=0.0).to(torch.float32)


def decode_gammas_windows(pi, T, E, keys, valid, seg_of_contig, row_ends,
                          precision=None, mesh=None):
    """Row-resolution posterior masses through the window kernels
    (window_kernel.py:decode_gammas_windows): K3, contig_boundaries, K1,
    K2g, then the two-level prefix sum (rows_from_windows).  Segment-major
    windows are genomic order (pack_windows numbers segments sequentially
    per contig, padding only at contig tails where gamma is 0), so each
    row's mass is a difference of one prefix sum at its last window.

    row_ends: (n_rows,) int64 flat (segment-major) index of each row's last
    window, strictly increasing (pack_window_row_ends).  Returns (ll,
    gammas (n_rows, M) f32): each row's gammas sum to its span in windows.

    Under a ``mesh`` (mesh.py:make_sharded_window_decode) keys and valid are
    this rank's block of segments and row_ends index the global stream:
    each rank sums the part of every row that lies in its block (a
    prefix-sum difference, deterministic, no atomics) and the parts are
    summed over the ranks, so a row that straddles two blocks adds its two
    parts.

    Default precision is 'tensorfloat32' (f32 carries), not the E-step's
    'default' (bf16 carries): bf16 operator carries put visible noise on the
    segment-boundary posteriors."""
    if precision is None:
        precision = "tensorfloat32"
    ll, A_in, Q_end, _, lo = _boundaries(
        pi, T, E, keys, valid, seg_of_contig, precision, mesh
    )
    *_, gam = stats_pass(
        T, E, keys, valid, A_in, Q_end, precision=precision, emit_gamma=True,
    )
    part = rows_from_windows(gam, row_ends, base=lo * keys.shape[1])
    del gam
    return ll, mesh_mod.reduce_sum(mesh, part)


def viterbi_segment_ops(T, E, keys, valid):
    """Phase A: per-segment max-plus transfer operators (S, i, k), the best
    log score from entry state k to state i, normalized per segment
    (window_kernel.py:viterbi_segment_ops).  K4 on CUDA tensors."""
    if T.is_cuda:
        return viterbi_ops_cuda(T, E, keys, valid)
    return viterbi_ops_plain(T, E, keys, valid)


def viterbi_boundary_states(pi, Wops, seg_of_contig):
    """Phase B: the MAP state at every segment boundary, by a per-contig
    max-plus scan over the segment operators and its backtrace
    (window_kernel.py:viterbi_boundary_states).  Returns (seg_entry (S,),
    seg_exit (S,)) int32 on Wops's device; segments no contig lists hold 0.
    K7 on CUDA tensors."""
    if Wops.is_cuda:
        return viterbi_boundary_cuda(pi, Wops, seg_of_contig)
    return viterbi_boundary_states_plain(pi, Wops, seg_of_contig)


def _log_pi(pi, dt):
    """log pi in ``dt``.  A pi == 0 state carries the max-plus 'impossible'
    score, not log(tiny): per-segment operator spreads exceed that.  The
    sentinel is a Python scalar (rounded to pi's dtype, as ``_mp_neg``), so
    a CUDA pi needs no copy from the host, which would wait for the work
    queued before it."""
    return torch.where(pi > 0, torch.log(torch.clamp(pi, min=1e-300)), -1e30).to(dt)


def _mp_rows_forward(Wops, rows, V):
    """The sequential max-plus forward over the rows of ``rows`` (R, n)
    segment ids (-1: a padded slot, the max-plus identity), batched over
    the rows, from V (R, M) in Wops's dtype: per slot V2_i = max_k (W[i][k]
    + V_k) with the first maximizing k as backpointer, then V = V2 - max
    V2.  Returns (bp (R, n, M) int64, the final V (R, M))."""
    rows = np.asarray(rows)
    M = Wops.shape[-1]
    dt, dev = Wops.dtype, Wops.device
    eyemp = torch.where(torch.eye(M, dtype=torch.bool, device=dev), 0.0,
                        _mp_neg(dt, dev))
    pad = torch.as_tensor(rows < 0, device=dev)
    idx = torch.as_tensor(np.maximum(rows, 0), device=dev)
    ops_c = torch.where(pad[:, :, None, None], eyemp, Wops[idx])  # (R, n, i, k)
    bps = []
    for t in range(rows.shape[1]):
        sc = ops_c[:, t] + V[:, None, :]  # (R, i, k)
        V2, bp = torch.max(sc, 2)  # ties: the first maximal entry state
        V = V2 - torch.amax(V2, 1, keepdim=True)
        bps.append(bp)
    return torch.stack(bps, 1), V


def _set_states(socn, entry_states, exit_states, S, dev):
    """seg_entry, seg_exit (S,) int32 on ``dev`` from per-slot states laid
    out like the table ``socn`` (0 at unlisted segments)."""
    m = socn >= 0
    seg_entry = np.zeros(S, np.int32)
    seg_exit = np.zeros(S, np.int32)
    seg_entry[socn[m]] = entry_states[m]
    seg_exit[socn[m]] = exit_states[m]
    return (torch.as_tensor(seg_entry, device=dev),
            torch.as_tensor(seg_exit, device=dev))


def viterbi_boundary_states_plain(pi, Wops, seg_of_contig):
    """viterbi_boundary_states as plain torch: a loop over the segments of
    each contig, batched over contigs; the backtrace runs on the host copy
    of the (C, NS, M) backpointers."""
    socn = np.asarray(seg_of_contig)
    C, NS = socn.shape
    S, M, _ = Wops.shape
    bps, V = _mp_rows_forward(Wops, socn, _log_pi(pi, Wops.dtype).expand(C, M))
    bps = bps.cpu().numpy()  # (C, NS, M)
    state = torch.argmax(V, 1).cpu().numpy()  # exit state of the last segment
    exit_states = np.empty((C, NS), np.int64)
    rows = np.arange(C)
    for t in range(NS - 1, -1, -1):
        exit_states[:, t] = state
        state = bps[rows, t, state]
    entry_states = np.concatenate([state[:, None], exit_states[:, :-1]], 1)
    return _set_states(socn, entry_states, exit_states, S, Wops.device)


def _mp_identity(M, R, dev):
    "R copies of the max-plus identity in f64: 0 on the diagonal, -inf off it."
    eye = torch.eye(M, dtype=torch.bool, device=dev)
    return torch.where(eye, 0.0, -torch.inf).to(torch.float64).repeat(R, 1, 1)


def mp_chunk_products_plain(Wops, rows):
    """K7's phase 1 as plain torch: for each row of ``rows`` (R, c) segment
    ids (-1: padded, skipped), the max-plus product W[rows[r, c-1]] (x) ...
    (x) W[rows[r, 0]] in f64, P'[i][j] = max_k (W_t[i][k] + P[k][j]), from
    the max-plus identity.  Returns (R, M, M) f64."""
    rows = torch.as_tensor(np.asarray(rows), device=Wops.device)
    R, c = rows.shape
    P = _mp_identity(Wops.shape[-1], R, Wops.device)
    for t in range(c):
        s = rows[:, t]
        Wt = Wops[s.clamp(min=0)].to(torch.float64)  # (R, i, k)
        nxt = torch.amax(Wt[:, :, :, None] + P[:, None, :, :], 2)
        P = torch.where((s >= 0)[:, None, None], nxt, P)
    return P


def mp_chunk_scan_plain(logpi, prod, C, n_chunks):
    """K7's phase 2 as plain torch, in f64: each contig's max-plus scan over
    its n_chunks products (prod (C n_chunks, M, M)) from ``logpi`` (M,),
    recording every chunk's entry vector, x <- max_k (P[i][k] + x_k), then
    x <- x - max x.  Returns the entry vectors (C n_chunks, M) f64."""
    M = prod.shape[-1]
    P = prod.view(C, n_chunks, M, M)
    x = logpi.to(device=prod.device, dtype=torch.float64).expand(C, M)
    entry = torch.empty((C, n_chunks, M), dtype=torch.float64, device=prod.device)
    for k in range(n_chunks):
        entry[:, k] = x
        y = torch.amax(P[:, k] + x[:, None, :], 2)
        x = y - torch.amax(y, 1, keepdim=True)
    return entry.view(-1, M)


def mp_row_maps(bp):
    """Each chunk row's exit -> entry map from its backpointers bp (R, c,
    M): maps[r, i] is the state at the row's start of the path that ends in
    state i at its end.  Returns (R, M) int64 numpy."""
    bp = np.asarray(bp.cpu() if torch.is_tensor(bp) else bp)
    R, c, M = bp.shape
    maps = np.broadcast_to(np.arange(M), (R, M)).copy()
    ridx = np.arange(R)[:, None]
    for t in range(c - 1, -1, -1):
        maps = bp[ridx, t, maps]
    return maps


def viterbi_boundary_states_chunked_plain(pi, Wops, seg_of_contig, chunk):
    """K7's chunked scan as plain torch, the twin the kernel is held to bit
    for bit (neither the CPU path nor the main path calls it): the contig
    table cut into chunk rows of ``chunk`` slots (``_chunk_rows``); the
    max-plus chunk products in f64 (``mp_chunk_products_plain``); the f64
    scan over each contig's chunks from log pi for every row's entry vector
    (``mp_chunk_scan_plain``), rounded to Wops's dtype; the sequential loop
    of ``viterbi_boundary_states_plain`` over every row at once from those
    (``_mp_rows_forward``); each row's exit -> entry map (``mp_row_maps``);
    each contig's exit state (the first argmax of its last row's final V)
    walked back through the later rows' maps to every row's exit state; then
    the backtrace of every row at once.  With one chunk a contig the rows
    start from log pi: the sequential loop.  Returns (seg_entry (S,),
    seg_exit (S,)) int32."""
    socn = np.asarray(seg_of_contig)
    C = socn.shape[0]
    S, M, _ = Wops.shape
    dt, dev = Wops.dtype, Wops.device
    rows, n_chunks = _chunk_rows(socn, chunk)
    logpi = _log_pi(pi.to(dev), dt)
    if n_chunks > 1:
        prod = mp_chunk_products_plain(Wops, rows)
        entry = mp_chunk_scan_plain(logpi, prod, C, n_chunks).to(dt)
    else:
        entry = logpi.expand(C, M)
    bp, V = _mp_rows_forward(Wops, rows, entry)
    bp = bp.cpu().numpy()  # (R, c, M)
    maps = mp_row_maps(bp).reshape(C, n_chunks, M)
    state = torch.argmax(V.view(C, n_chunks, M)[:, -1], 1).cpu().numpy()
    cidx = np.arange(C)
    row_exit = np.empty((C, n_chunks), np.int64)
    for k in range(n_chunks - 1, -1, -1):
        row_exit[:, k] = state
        state = maps[cidx, k, state]
    R = rows.shape[0]
    state = row_exit.reshape(R)
    ridx = np.arange(R)
    exit_states = np.empty((R, chunk), np.int64)
    entry_states = np.empty((R, chunk), np.int64)
    for t in range(chunk - 1, -1, -1):
        exit_states[:, t] = state
        state = bp[ridx, t, state]
        entry_states[:, t] = state
    return _set_states(rows, entry_states, exit_states, S, dev)


# the max-plus 'impossible' sentinel and anything near it is not a score
_MP_FINITE = -1e29


def viterbi_boundary_path_score(pi, Wops, seg_of_contig, seg_entry, seg_exit):
    """Each contig's Viterbi path score of the boundary states (seg_entry,
    seg_exit), in f64: log pi[entry of its first slot] + sum_t
    W_t[exit_t][entry_t] over its listed slots (0 for a contig that lists
    none).  Two boundary-state sequences of one contig are compared by this
    score (the agreement rule of K7, ``viterbi_boundary_delta``).  Returns
    (C,) f64."""
    socn = np.asarray(seg_of_contig)
    dev = Wops.device
    m = torch.as_tensor(socn >= 0, device=dev)
    idx = torch.as_tensor(np.maximum(socn, 0), device=dev)
    e = seg_entry.to(dev).long()[idx]
    x = seg_exit.to(dev).long()[idx]
    W = Wops.to(torch.float64)
    terms = torch.where(m, W[idx, x, e], 0.0)
    logpi = _log_pi(pi.to(device=dev, dtype=torch.float64), torch.float64)
    return terms.sum(1) + torch.where(m[:, 0], logpi[e[:, 0]], 0.0)


def viterbi_boundary_delta(Wops, seg_of_contig):
    """The near-tie margin of each contig's path score, δ = 2^-20 sum_t
    max_{i,k} |W_t[i, k]| over its listed slots, the entries above -1e29
    only (the max-plus sentinel is not a score): the f32 forward's rounding
    budget with a factor-4 margin.  The chunked scan (K7 and its twin) may
    pick other boundary states than the sequential loop only where the two
    paths' scores (``viterbi_boundary_path_score``) lie within δ.  Returns
    (C,) f64."""
    socn = np.asarray(seg_of_contig)
    dev = Wops.device
    W = Wops.to(torch.float64)
    big = torch.amax(torch.where(W > _MP_FINITE, W.abs(), 0.0), (1, 2))  # (S,)
    idx = torch.as_tensor(np.maximum(socn, 0), device=dev)
    m = torch.as_tensor(socn >= 0, device=dev)
    return 2.0**-20 * torch.where(m, big[idx], 0.0).sum(1)


def viterbi_boundary_agreement(pi, Wops, seg_of_contig, got, want):
    """K7's agreement rule between two sets of boundary states ``got`` and
    ``want`` ((seg_entry, seg_exit) each) of the same operators: returns
    (differs (C,) bool, whether a contig's listed states differ; gap (C,)
    f64, the distance of the two paths' scores; delta (C,) f64, from
    ``viterbi_boundary_delta``).  They agree when every contig that differs
    has gap <= delta."""
    socn = np.asarray(seg_of_contig)
    dev = Wops.device
    idx = torch.as_tensor(np.maximum(socn, 0), device=dev)
    m = torch.as_tensor(socn >= 0, device=dev)
    got, want = ([x.to(dev) for x in pair] for pair in (got, want))
    differs = torch.any(m & ((got[0][idx] != want[0][idx])
                             | (got[1][idx] != want[1][idx])), 1)
    gap = (viterbi_boundary_path_score(pi, Wops, socn, *got)
           - viterbi_boundary_path_score(pi, Wops, socn, *want)).abs()
    return differs, gap, viterbi_boundary_delta(Wops, socn)


def viterbi_segment_paths(T, E, keys, valid, seg_entry, seg_exit, block=None):
    """Phase C: each segment's interior MAP path from its boundary states
    (window_kernel.py:viterbi_segment_paths).  Returns path (S, L) int32,
    the state after each window (the reference's (L, S) transposed; padding
    windows repeat the adjacent state).  K5 on CUDA tensors; with ``block``
    (backpointers recomputed per block) K5 blocked
    (``viterbi_paths_blocked_cuda``)."""
    if T.is_cuda:
        if block is not None:
            return viterbi_paths_blocked_cuda(T, E, keys, valid, seg_entry, seg_exit,
                                              block)
        return viterbi_paths_cuda(T, E, keys, valid, seg_entry, seg_exit)
    return viterbi_paths_plain(T, E, keys, valid, seg_entry, seg_exit, block)


def viterbi_windows(pi, T, E, keys, valid, seg_of_contig, row_ends, block=None,
                    mesh=None):
    """MAP (Viterbi) decode through the window kernels
    (window_kernel.py:viterbi_windows): phase A (K4), phase B (K7), phase C
    (K5), then the state at each row's last window.  Returns (n_rows,)
    int32.

    Under a ``mesh`` (mesh.py:make_sharded_window_viterbi) keys and valid
    are this rank's block of segments: K4 on the block, the max-plus
    operators gathered, K7 replicated, K5 on the block; each row's state is
    picked by the rank whose block holds its last window (the others give 0)
    and summed over the ranks."""
    Wops = mesh_mod.gather_rows(mesh, viterbi_segment_ops(T, E, keys, valid))
    seg_entry, seg_exit = viterbi_boundary_states(pi, Wops, seg_of_contig)
    del Wops
    S, L = keys.shape
    lo = mesh_mod.block_start(mesh, S)
    path = viterbi_segment_paths(
        T, E, keys, valid, seg_entry[lo : lo + S].contiguous(),
        seg_exit[lo : lo + S].contiguous(), block=block,
    ).reshape(-1)
    rel = row_ends - lo * L
    mine = (rel >= 0) & (rel < S * L)
    picked = torch.where(mine, path[rel.clamp(0, S * L - 1)], 0).to(torch.int32)
    return mesh_mod.reduce_sum(mesh, picked)


# ---------------------------------------------------------------------------
# Host-side packing (NumPy; a copy of the JAX package's)
# ---------------------------------------------------------------------------

def pack_window_row_ids(spans_list, L, seg_of_contig):
    """(S, L) global compressed-row index per window, matching the
    segmentation ``pack_windows`` produced (same L, same segment order).
    ``spans_list``: one int array of row spans per contig.  Padding
    windows get the id of the row they follow (their gamma is exactly
    zero).  Returns (row_ids, n_rows_total)."""
    socn = np.asarray(seg_of_contig)
    S = int(socn.max()) + 1
    rid = np.zeros((S, L), dtype=np.int32)
    off = 0
    for c, spans in enumerate(spans_list):
        spans = np.asarray(spans, dtype=np.int64)
        ids = np.repeat(
            np.arange(off, off + len(spans), dtype=np.int32), spans
        )
        for j, seg in enumerate(socn[c]):
            if seg < 0:
                break
            chunk = ids[j * L : (j + 1) * L]
            rid[seg, : len(chunk)] = chunk
            if len(chunk) < L:
                rid[seg, len(chunk):] = chunk[-1] if len(chunk) else off
        off += len(spans)
    return rid, off


def pack_window_row_ends(spans_list, L, seg_of_contig):
    """(n_rows,) int64 flat segment-major index of each row's last window,
    strictly increasing: the gather points of the prefix-sum decode
    (``decode_gammas_windows``).  Segment ids are assigned sequentially per
    contig by pack_windows, so contig c's windows occupy the flat range
    [first_seg_c * L, ...] with padding only at the contig's tail."""
    socn = np.asarray(seg_of_contig)
    ends = []
    for c, spans in enumerate(spans_list):
        base = int(socn[c, 0]) * L
        within = np.cumsum(np.asarray(spans, dtype=np.int64)) - 1
        ends.append(base + within)
    out = np.concatenate(ends)
    assert np.all(np.diff(out) > 0)
    return out


def remat_block_size(L):
    """Alpha-remat block size: the divisor of L nearest sqrt(L) that is a
    multiple of RESCALE_EVERY (L is always padded to one).  Balances the
    snapshot stream (L/B) against the per-block recompute scratch (B)."""
    target = max(RESCALE_EVERY, int(np.sqrt(L)))
    best = RESCALE_EVERY
    for b in range(RESCALE_EVERY, L + 1, RESCALE_EVERY):
        if L % b == 0 and abs(b - target) < abs(best - target):
            best = b
    return best


def rows_to_key_ids(obs, key_id):
    """Vectorized observation-row -> key-id mapping: dict lookups only on
    the (few hundred) distinct rows instead of every row."""
    uniq, inv = np.unique(obs, axis=0, return_inverse=True)
    lut = np.array([key_id[tuple(r)] for r in uniq], dtype=np.int32)
    return lut[inv]


def decompress_to_windows(data_list, key_id):
    "Per-contig unit-window key-id streams from span-compressed rows."
    win = []
    for d in data_list:
        s = d[:, 0].astype(np.int64)
        k = rows_to_key_ids(np.asarray(d)[:, 1:], key_id)
        win.append(np.repeat(k, s))
    return win


def window_segment_length(W, seg_target=8192, min_seg_len=64,
                          max_seg_len=16384):
    """Segment length L for a total of W windows (see pack_windows): about
    ``seg_target`` segments, L a power of two clipped to
    [min_seg_len, max_seg_len] and rounded up to RESCALE_EVERY."""
    L = int(2 ** np.ceil(np.log2(max(W / seg_target, 1.0))))
    L = int(np.clip(L, min_seg_len, max_seg_len))
    return -(-L // RESCALE_EVERY) * RESCALE_EVERY


def cut_segments(win, L):
    """Cut per-contig window streams into length-<=L pieces.

    Returns (segs, seg_ids): the flat segment list and, per contig, the
    indices of its segments in stream order."""
    segs = []
    seg_ids = []
    for w in win:
        ids = []
        for off in range(0, len(w), L):
            ids.append(len(segs))
            segs.append(w[off : off + L])
        seg_ids.append(ids)
    return segs, seg_ids


def pack_windows(data_list, key_id, pad_key=0, seg_target=8192,
                 min_seg_len=64, max_seg_len=16384):
    """Decompress span-compressed contigs to unit windows and cut into
    fixed-length segments.

    Returns (keys (S, L) int32, valid (S, L) bool, seg_of_contig (C, NS)).

    ``seg_target`` ~ the target segment count: more, shorter segments
    mean fewer sequential steps (L) across more parallel segments (S).  The
    value is the JAX package's, tuned there; the port keeps it so both
    packages cut the same segments.
    """
    win = decompress_to_windows(data_list, key_id)
    W = sum(len(w) for w in win)
    L = window_segment_length(W, seg_target, min_seg_len, max_seg_len)
    segs, seg_ids = cut_segments(win, L)
    S = len(segs)
    keys = np.full((S, L), pad_key, dtype=np.int32)
    valid = np.zeros((S, L), dtype=bool)
    for i, seg in enumerate(segs):
        keys[i, : len(seg)] = seg
        valid[i, : len(seg)] = True
    NS = max(len(i) for i in seg_ids)
    seg_of_contig = np.full((len(win), NS), -1, dtype=np.int64)
    for c, ids in enumerate(seg_ids):
        seg_of_contig[c, : len(ids)] = ids
    return keys, valid, seg_of_contig
