"""Window-resolution E-step, in torch, with hand-written CUDA kernels.

Port of smcpp_tpu/ops/window_kernel.py (the direct Baum-Welch E-step,
``estep_direct``).  The observation stream is decompressed to unit windows
and cut into S segments of L windows (``pack_windows``); then

  pass 1   ``segment_operators``: per-segment transfer operators, one
           X <- diag(e) T^T X step per window (kernel K3);
           ``contig_boundaries``: tiny per-contig scans over the (S, M, M)
           operators give each segment's boundary alpha / beta vectors;
  pass 2   ``stats_pass``: an ascending alpha sweep storing the per-window
           alpha stream (K1), then a descending beta sweep reading it and
           accumulating xisum and the per-key posterior masses (K2);
  finally  ``boundary_stats``: the transitions that cross segment and
           contig boundaries.

Each of K1, K2 and K3 is a serial loop over the windows of a segment.  On a
CUDA tensor they run as the hand-written kernels in csrc/window_kernels.cu;
on a CPU tensor they run as the plain PyTorch loops in this module (the same
arithmetic, f32 or f64).  A CUDA tensor never falls back to the plain
version: the wrapper launches its kernel or raises.  The plain versions are
also what the kernels are held against on the card.

Numerics (identical to the reference): f32 arithmetic with exact f32
products at every precision rung; at 'default' the K3 carry is stored in
bf16 after every step and every block rescale, and the alpha stream is
stored in bf16 (``carry_dtype``); at 'tensorfloat32' and 'highest' both are
f32.  Every normalizer is window-local, so scale factors cancel exactly.
"""

import numpy as np
import torch

from . import _cuda

RESCALE_EVERY = 8
FLOOR = 1e-35
MATMUL_PRECISION = "default"

# Blocks of the descending sweep (K2): each block is one warp that walks the
# segments blockIdx, blockIdx + G, ... and owns one f64 partial of xisum and
# gsum.  A fixed count keeps the reduction order independent of the card.
DSC_BLOCKS = 1024


def carry_dtype(precision, base_dtype):
    """Storage dtype of the K3 carry and of the alpha stream
    (window_kernel.py:_carry_dtype): bf16 at the 'default'/'bfloat16' rung
    for f32 E-steps, the compute dtype otherwise."""
    if base_dtype != torch.float32:
        return base_dtype
    if precision in ("default", "bfloat16"):
        return torch.bfloat16
    return base_dtype


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
    replaces, and ``launches``, the number of times this process launched
    it (incremented where the kernel is launched, nowhere else)."""

    def __init__(self, name, source, replaces):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


SEGMENT_OPS = _Kernel(
    "segment_ops", "smcpp_tpu_torch/csrc/window_kernels.cu",
    "smcpp_tpu/ops/window_kernel.py:151",
)
ASC_SWEEP = _Kernel(
    "asc_sweep", "smcpp_tpu_torch/csrc/window_kernels.cu",
    "smcpp_tpu/ops/pallas_sweeps.py:215",
)
DSC_SWEEP = _Kernel(
    "dsc_sweep", "smcpp_tpu_torch/csrc/window_kernels.cu",
    "smcpp_tpu/ops/pallas_sweeps.py:255",
)
KERNELS = (SEGMENT_OPS, ASC_SWEEP, DSC_SWEEP)


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


def segment_ops_cuda(T, E, keys, valid, precision):
    """K3 (replaces window_kernel.py:_steps_block / segment_operators).

    What bounds it: serial depth along L windows and M^3 FMAs per window per
    segment.  Design: one warp per segment, lane k owns column k of the
    (M, M) carry in registers, T^T and the normalized emission table sit in
    shared memory, and the 8-window block rescale is one warp max; no block
    barrier inside the window loop.  Returns (ops (S, M, M), logs (S,))."""
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
    return ops, logs


def asc_sweep_cuda(T, E, keys, valid, A_in, precision):
    """K1 (replaces pallas_sweeps.py:_asc_kernel).

    What bounds it: serial depth (L windows, M^2 FMAs each) and the alpha
    stream written to device memory.  Design: one warp per segment, lane i
    owns alpha[i] and column i of T in registers, the other alphas arrive by
    warp shuffle, and the stream is laid out (S, L, M) so each window is one
    contiguous M-vector store.  Returns (alphas (S, L, M) in the carry
    dtype, alpha_end (S, M) f32)."""
    _check_inputs(T, E, keys, valid, A_in)
    S, L = keys.shape
    M = T.shape[0]
    cdt = carry_dtype(precision, torch.float32)
    alphas = torch.empty((S, L, M), dtype=cdt, device=T.device)
    alpha_end = torch.empty((S, M), dtype=torch.float32, device=T.device)
    lib = _cuda.lib()
    ASC_SWEEP.launches += 1
    _cuda.check(
        lib.smcpp_asc_sweep(
            T.data_ptr(), E.data_ptr(), keys.data_ptr(), valid.data_ptr(),
            A_in.data_ptr(), S, L, M, E.shape[0],
            int(cdt == torch.bfloat16), alphas.data_ptr(),
            alpha_end.data_ptr(), _stream(T.device),
        ),
        ASC_SWEEP.name,
    )
    return alphas, alpha_end


def dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end):
    """K2 (replaces pallas_sweeps.py:_dsc_kernel).

    What bounds it: serial depth (L windows per segment) and the f64
    accumulation of M^2 xisum terms per window.  Design: one warp per block
    walking segments in a fixed stride; lane j owns q[j], u[j], row j of T
    and row j of the f64 xisum accumulator in registers, gets u by warp
    shuffle, and adds its column of the per-key masses into the warp's f64
    shared-memory slice (no two lanes share an address, so no atomics).
    Per-block partials are summed here with one torch.sum in f64.  Returns
    (u_start (S, M) f32, xo (M, M) f64, gsum (n_keys, M) f64)."""
    _check_inputs(T, E, keys, valid, Q_end)
    S, L = keys.shape
    M = T.shape[0]
    n_keys = E.shape[0]
    if alphas.shape != (S, L, M) or alphas.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("alphas must be the (S, L, M) stream of asc_sweep_cuda")
    if alphas.device != T.device or not alphas.is_contiguous():
        raise ValueError("alphas must be a contiguous tensor on T's device")
    smem = 12 * n_keys * M
    if smem > 227 * 1024:
        raise ValueError(
            f"dsc_sweep: n_keys * M = {n_keys * M} needs {smem} B of shared "
            "memory per block, over the 227 KB a block can have"
        )
    G = min(S, DSC_BLOCKS)
    u_start = torch.empty((S, M), dtype=torch.float32, device=T.device)
    xo_part = torch.empty((G, M, M), dtype=torch.float64, device=T.device)
    gsum_part = torch.empty((G, n_keys, M), dtype=torch.float64, device=T.device)
    lib = _cuda.lib()
    DSC_SWEEP.launches += 1
    _cuda.check(
        lib.smcpp_dsc_sweep(
            T.data_ptr(), E.data_ptr(), keys.data_ptr(), valid.data_ptr(),
            alphas.data_ptr(), Q_end.data_ptr(), S, L, M, n_keys,
            int(alphas.dtype == torch.bfloat16), G, u_start.data_ptr(),
            xo_part.data_ptr(), gsum_part.data_ptr(), _stream(T.device),
        ),
        DSC_SWEEP.name,
    )
    return u_start, xo_part.sum(0), gsum_part.sum(0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def segment_ops_plain(T, E, keys, valid, precision):
    """Python loop over windows: the arithmetic of _steps_block, with the
    carry laid out (S, i, k).  Returns (ops (S, M, M), logs (S,))."""
    S, L = keys.shape
    M = T.shape[0]
    dt = E.dtype
    cdt = carry_dtype(precision, T.dtype)
    tiny = torch.finfo(dt).tiny
    Tt = T.T
    X = torch.eye(M, dtype=cdt, device=T.device).expand(S, M, M)
    logs = torch.zeros(S, dtype=T.dtype, device=T.device)
    for l in range(L):
        k, v = keys[:, l], valid[:, l]
        eT = E[k]  # (S, M)
        em = torch.clamp(torch.amax(eT, 1), min=tiny)
        eT = eT / em[:, None]
        Y = torch.matmul(Tt, X.to(dt)) * eT[:, :, None]
        Y = torch.clamp(Y, min=FLOOR)
        X = torch.where(v[:, None, None], Y, X.to(dt)).to(cdt)
        logs = logs + torch.where(v, torch.log(em), 0.0)
        if (l + 1) % RESCALE_EVERY == 0:
            Xf = X.to(dt)
            m = torch.clamp(torch.amax(torch.abs(Xf), (1, 2)), min=tiny)
            X = (Xf / m[:, None, None]).to(cdt)
            logs = logs + torch.log(m)
    return X.to(T.dtype), logs


def asc_sweep_plain(T, E, keys, valid, A_in, precision):
    """The ascending alpha sweep of stats_pass.  Returns (alphas (S, L, M)
    in the carry dtype, alpha_end (S, M))."""
    S, L = keys.shape
    M = T.shape[0]
    dt = E.dtype
    cdt = carry_dtype(precision, dt)
    tiny = torch.finfo(dt).tiny
    a = A_in.to(dt)
    alphas = torch.empty((S, L, M), dtype=cdt, device=T.device)
    for l in range(L):
        anew = E[keys[:, l]] * (a @ T)  # anew[s, i] = e[s, i] sum_j T[j, i] a[s, j]
        anew = anew / torch.clamp(torch.amax(anew, 1, keepdim=True), min=tiny)
        a = torch.where(valid[:, l, None], anew, a)
        alphas[:, l] = a.to(cdt)
    return alphas, a


def dsc_sweep_plain(T, E, keys, valid, alphas, Q_end):
    """The descending beta sweep of stats_pass, accumulating like the XLA
    reference: each window's per-key masses and outer products are summed
    over segments in the compute dtype, then added to f64 accumulators.
    Returns (u_start (S, M), xo (M, M) f64, gsum (n_keys, M) f64)."""
    S, L = keys.shape
    M = T.shape[0]
    n_keys = E.shape[0]
    dt = E.dtype
    tiny = torch.finfo(dt).tiny
    vnext = torch.cat([valid[:, 1:], torch.zeros_like(valid[:, :1])], 1)
    q = Q_end.to(dt)
    u = torch.zeros((S, M), dtype=dt, device=T.device)
    xo = torch.zeros((M, M), dtype=torch.float64, device=T.device)
    gsum = torch.zeros((n_keys, M), dtype=torch.float64, device=T.device)
    for l in range(L - 1, -1, -1):
        a = alphas[:, l].to(dt)
        k = keys[:, l]
        v, vn = valid[:, l, None], vnext[:, l, None]
        tv = u @ T.T  # tv[s, j] = sum_i T[j, i] u[s, i]
        qun = torch.where(vn, tv, q)
        Z = torch.clamp(torch.sum(a * qun, 1, keepdim=True), min=tiny)
        gamma = (a * qun / Z) * v
        ascale = (a / Z) * (v & vn)
        g_k = torch.zeros((n_keys, M), dtype=dt, device=T.device)
        g_k.index_add_(0, k.long(), gamma)
        gsum += g_k.to(torch.float64)
        xo += (ascale.T @ u).to(torch.float64)
        qn = qun / torch.clamp(torch.amax(qun, 1, keepdim=True), min=tiny)
        q = torch.where(v, qn, q)
        u = torch.where(v, E[k] * q, u)
    return u, xo, gsum


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
    contig's last).  Plain torch on every device: a loop over the (short)
    segment axis of each contig."""
    socn = np.asarray(seg_of_contig)
    C, NS = socn.shape
    S, M = ops.shape[0], ops.shape[-1]
    dev, dt = ops.device, ops.dtype
    tiny = torch.finfo(dt).tiny
    pad = torch.as_tensor(socn < 0, device=dev)
    idx = torch.as_tensor(np.maximum(socn, 0), device=dev)
    eye = torch.eye(M, dtype=dt, device=dev)
    ops_c = torch.where(pad[:, :, None, None], eye, ops[idx])  # (C, NS, M, M)
    logs_c = torch.where(pad, 0.0, logs[idx])
    cvalid = torch.any(torch.where(pad, False, seg_has[idx]), 1)

    alpha = pi.to(dt).expand(C, M)
    ll = torch.zeros(C, dtype=torch.float64, device=dev)
    a_pre = []
    for t in range(NS):
        a_pre.append(alpha)
        v = torch.einsum("cij,cj->ci", ops_c[:, t], alpha)
        c = torch.sum(v, 1)
        dll = (torch.log(c) + logs_c[:, t]).to(torch.float64)
        ll = ll + torch.where(cvalid, dll, 0.0)
        alpha = v / c[:, None]
    q = torch.ones((C, M), dtype=dt, device=dev)
    q_post = [None] * NS
    for t in range(NS - 1, -1, -1):
        q_post[t] = q
        qn = torch.einsum("cij,ci->cj", ops_c[:, t], q)
        q = qn / torch.clamp(torch.amax(qn, 1, keepdim=True), min=tiny)
    m = torch.as_tensor(socn >= 0, device=dev)
    rows = torch.as_tensor(socn[socn >= 0], device=dev)
    A_in = torch.zeros((S, M), dtype=dt, device=dev)
    Q_end = torch.zeros((S, M), dtype=dt, device=dev)
    A_in[rows] = torch.stack(a_pre, 1)[m]
    Q_end[rows] = torch.stack(q_post, 1)[m]
    return torch.sum(ll), A_in, Q_end, cvalid


def stats_pass(T, E, keys, valid, A_in, Q_end, e_all=None, precision=None,
               alpha_remat=None, emit_gamma=False):
    """Lockstep alpha/beta sweeps accumulating within-segment statistics
    (window_kernel.py:stats_pass).  Returns (alpha_end (S, M), u_start
    (S, M), xo (M, M) f64, gsum (n_keys, M) f64), where xo is the raw
    outer-product accumulator (multiply by T for the xisum contribution).

    On CUDA tensors: K1 then K2.  Only the default mode is ported: the
    emission stream ``e_all``, ``alpha_remat`` and ``emit_gamma`` raise."""
    if e_all is not None:
        raise NotImplementedError(
            "stats_pass: the e_all emission stream is not ported (ROADMAP B3); "
            "the sweeps gather emission rows instead"
        )
    if alpha_remat is not None:
        raise NotImplementedError(
            "stats_pass: alpha_remat is not ported yet (ROADMAP B3)"
        )
    if emit_gamma:
        raise NotImplementedError(
            "stats_pass: the emit_gamma stream is not ported yet (ROADMAP B5)"
        )
    precision = _precision(precision)
    if T.is_cuda:
        alphas, alpha_end = asc_sweep_cuda(T, E, keys, valid, A_in, precision)
        u_start, xo, gsum = dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end)
        return alpha_end, u_start, xo, gsum
    alphas, alpha_end = asc_sweep_plain(T, E, keys, valid, A_in, precision)
    u_start, xo, gsum = dsc_sweep_plain(T, E, keys, valid, alphas, Q_end)
    return alpha_end, u_start, xo, gsum


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


def estep_direct(pi, T, E, keys, valid, seg_of_contig, precision=None):
    """Direct Baum-Welch E-step (window_kernel.py:estep_direct).  Returns
    (ll, pi-stat, xisum, gamma_sums): ll and the statistics in f64."""
    precision = _precision(precision)
    ops, logs = segment_operators(T, E, keys, valid, precision)
    seg_has = torch.any(valid, 1)
    ll, A_in, Q_end, cvalid = contig_boundaries(
        pi, ops, logs, seg_of_contig, seg_has
    )
    alpha_end, u_start, xo, gsum = stats_pass(
        T, E, keys, valid, A_in.contiguous(), Q_end.contiguous(),
        precision=precision,
    )
    xo, pi_stat = boundary_stats(
        pi, T, alpha_end, u_start, xo, seg_of_contig, cvalid
    )
    return ll, pi_stat, xo * T.to(xo.dtype), gsum


# ---------------------------------------------------------------------------
# Host-side packing (NumPy; a copy of the JAX package's)
# ---------------------------------------------------------------------------

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
