"""Smoke run of the PyTorch/CUDA port (smcpp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the CUDA kernels from smcpp_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, in parallel;
3. each kernel against its plain PyTorch version on the card, on synthetic
   inputs at small shapes, with kernel and plain times: K1 asc_sweep, K2
   dsc_sweep and K3 segment_ops at S=64, L=512, M=15, 16 and 17, 89 keys,
   f32 at 'highest' and 'default'; K2g dsc_sweep_gamma, K4 viterbi_ops and K5
   viterbi_paths at S=64, L=512, M=2, 15, 16, 17 and 32, 89 keys, and K5
   also on inputs with exact ties (``tie_problem``: S=13, L=200); all six
   at M=32 with 1000 keys (emission tables past a block's shared memory);
   K6 boundary_scan and K7 viterbi_boundary (each also against its
   chunked twin) on those K3 and K4 operators, laid out as three contigs
   of uneven length, at M=2, 15, 16, 17 and 32, and K7 on exact inputs
   (``k7_exact``: twin states, small integers);
4. the main path: simulate 2 contigs x 100 Mbp with n=20 (port's
   data/simulate.py, seeded), then ``smcpp_tpu_torch.commands.main estimate
   --em-iterations 2 --device cuda`` at the default knots, spline and w;
   checks model.final.json and that every E-step kernel was launched; then
   each of K1-K3 and K6 against its plain version again, at both rungs, on
   the fitted manager's own inputs (its packed windows, f32 T and E, the
   segment operators and boundary vectors they give: the shape, M and key
   count the fit launched the kernels at), with kernel and plain times;
   then the span E-step (``hmm.estep``: the chunk products, K6 over them
   once, the SpanLoglik backward) on the same manager's packed rows, held
   against its window E-step (``span_estep``);
5. the posterior path: ``smcpp_tpu_torch.commands.main posterior --device
   cuda --map --intervals 0.025,0.5,0.975`` with phase 4's model on the
   first 100 Mbp contig (M=32, every base a window); checks the npz (gammas,
   sites, MAP states, quantiles), that every posterior kernel was launched
   (K3, K6, K1, K2 in the E-step; K3, K6, K1, K2g in the decode; K4, K7,
   K5), then times the decode's and the Viterbi's phases with CUDA events,
   holds K6 and K7 against their plain versions on the whole contig's
   operators, K5 on the whole contig (every window, from the boundary
   states K7 gives, with its two launches timed apart: ``k5_phases``), and
   the six window kernels on the posterior manager's own inputs,
   restricted to its first 32 segments; then both row-level routes on the
   same contig (``row_routes``): ``hmm.decode_gammas`` (K6 once) against
   the window decode's rows, the row Viterbi (f64 row powers, K7 once)
   against the window Viterbi's path, K7 on the row operators against its
   chunked twin, and their phases (``row_phases``);
6. ``estep_direct`` alone at the bench.py C3 shape (22 x 2.5e6 windows,
   M=16, 128 keys, drawn by the port's copy of bench.py's ``synth_contig``;
   median of 3 runs), in Gbp/s, with K6 against its plain version on its
   operators and K3 and K1 against their plain versions on the whole C3
   input at both rungs, then the SM clock under load;
7. one simulated contig of human chromosome 1's length (248,956,422 bp,
   n=20, its own seed) through ``posterior --device cuda --map
   --intervals`` with phase 4's model: over the 70% decode gate, so the
   decode runs row-level by the gate alone (``chr1_posterior``); checks
   the npz and the launches (K3, K6, K1, K2, then K6 in the row decode,
   then K4, K7, K5), prints the wall time, the peak device memory and the
   row decode's phases.

K2's plain version sums each window's per-key masses in f64
(``dsc_sweep_plain(..., sum_dtype=float64)``, ``k2_plain``): the f32
``index_add_`` of the default plain loop sums in an atomic order that
varies on the card, and its sums with it, where K2's gsum (64-bit fixed
point) is bit-identical from launch to launch.

K3's plain version is the window loop with each step's products summed in
f64 (``segment_ops_plain(..., sum_dtype=float64)``, the kernel's own
summation).  On the slice (phase 4, at the fit's rung) and at C3 (phase 6,
at both rungs) the E-step
log-likelihood from K3's operators is printed beside the one from its plain
version's, from the loop summed in f32 (the reference's summation) and from
the loop in f64, each with its distance from the last (``ll_agreement``).

K1's plain version is likewise the ascending sweep with each window's
products summed in f64 (``asc_sweep_plain(..., sum_dtype=float64)``); on
every input set K1 is held to it (the count of differing entries printed)
and to the f32-summed loop at the old tolerances, or, where that loop has
drifted past them, to lying nearer the all-f64 loop than it (``check_k1``);
its launch plan (warps per block, blocks, registers) is printed, and the
E-step's xisum and gsum from K1's stream are printed beside those from the
f32-summed loop's (``k1_estep_agreement``).

K6 is a chunked scan (f64 chunk products, an f64 scan over the chunks, an
f32 finish of every chunk at once; ``boundary_plan`` sets its chunk length
c and n_chunks).  On every input set (the small uneven contigs, the slice
at both rungs, the posterior contig, C3) it is held to its chunked twin
(``contig_boundaries_chunked_plain``, rtol 1e-6, ll 1e-9) and to the
sequential f32 loop at rtol 1e-5 (ll 1e-6), or, where that loop has
drifted past it, to lying nearer the all-f64 loop than it; two launches are
bit-identical (``check_k6``).  Its plan, dependent depth (c + n_chunks + c
steps, printed beside its bound) and the CUDA-event times of its setup and
three phases are printed there too (``k6_phases``).

K7 is K6's chunked scan in max-plus, four launches counted as one
(``ViterbiBoundary``: f64 chunk products, an f64 scan over the chunks, every
chunk's f32 forward, every chunk's backtrace).  On every input set it must
equal its chunked twin (``viterbi_boundary_states_chunked_plain``) bit for
bit, two launches bit-identical; against the sequential loop its states
must be equal or, in a contig whose states differ, the two paths' f64
scores within δ (``viterbi_boundary_delta``), equal on exact inputs
(``check_k7``, which prints the differing-state count, the largest score
gap beside δ and the entry vectors' distance from the sequential V); its
plan, depth and the times of its phases are printed (``k7_phases``).

K5 is two launches counted as one (``ViterbiPaths``: the forward sweep,
writing the backpointers four windows to a word, then the backtrace through
shared memory).  On every input set it must equal its plain version bit for
bit, exact ties included (the lowest maximizing state), two calls must be
bit-identical and its launches called one at a time must give the wrapper's
path (``check_k5``); its plan (``viterbi_paths_plan``) is printed there.

Every kernel time is printed beside its bound: the least time the card
could take for the same work on the same inputs, the largest of its
operations over the rate of their pipe (adds and FMAs at the FMA rate;
compares, maxima and selects at half that; all of them over the issue
rate) and the bytes it must move (each input read once, each output
written once) over the memory rate (``bound``, ``scan_bound``).  No
single PyTorch call computes any of these kernels (each is a serial scan
with a renormalisation at every step), so ``library_ms`` is null.

The line before the last is the kernels' JSON record (launches from each
kernel's own path: K1-K3 and K6 from phase 4's estimate, K2g, K4, K5 and K7
from phase 5's posterior; errors, times and bounds from the comparison on
that path's own inputs, for K5 the whole posterior contig); the last line
is ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no CUDA device is present.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# tolerances of tests/test_torch_cuda.py
HIGHEST_RTOL = 1e-5  # exact-f32 recursions in another summation order
DEFAULT_RTOL = 1e-3  # bf16 carries: a rounding may flip by one bf16 ulp
BF16_ULP = 2.0**-7

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): 67 TFLOP/s in
# float32 outside the tensor cores, 34 TFLOP/s in float64, 3.35 TB/s of
# HBM3.  Three pipes of the 132 SMs at 1.98 GHz: the FMA pipe (an f32 add,
# multiply or FMA is one operation at half the FLOP/s figure, 128 a clock
# per SM; 64 in float64), the ALU pipe (an f32 compare, minimum, maximum or
# select, 64 a clock per SM: the CUDA C++ Programming Guide's throughput
# table for compute capability 9.0), and issue (128 thread-instructions a
# clock per SM, whatever the pipe).
F32_OPS_PER_S = 67e12 / 2
F32_ALU_PER_S = F32_OPS_PER_S / 2
THREAD_INSTR_PER_S = F32_OPS_PER_S
F64_OPS_PER_S = 34e12 / 2
HBM_BYTES_PER_S = 3.35e12
# and 67 TFLOP/s in float64 on its tensor cores (mma.sync f64, K3 and K1):
# the same FMA rate as the float32 CUDA cores
F64_TC_FMA_PER_S = 67e12 / 2


def log(*a):
    print(*a, flush=True)


def card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log("torch device:", torch.cuda.get_device_name(0), "| torch",
        torch.__version__, "cuda", torch.version.cuda)
    return smi


def bound(name, E, keys, valid, elt=4, cuda_cores=False, alu_at_fma=False):
    """(bound_ms, bound_by) of one launch of kernel ``name`` on these inputs:
    the larger of its operations over the peak rate of their pipe (and all
    of them over the issue rate) and the bytes it must move (each input read
    once, each output written once) over the memory rate.  ``elt`` is the
    byte width of the alpha stream; ``alu_at_fma`` gives the earlier model:
    a max or a select one operation at the FMA rate, no issue limit, and
    K5's candidate an add, a max and a select (no compare).
    Operations count the valid windows (an invalid window skips the step's
    arithmetic); streams count every window.

      K3 segment_ops      M^3 f64 FMA per window on the tensor cores, and
                          per carry entry two f32/f64 conversions (f64
                          rate), a multiply (FMA pipe) and a max (ALU
                          pipe); ``cuda_cores``: M^3
                          f32 FMA, the earlier CUDA-core kernel's form of
                          the same work; keys, valid in, (S, M, M) out
      K1 asc_sweep        M^2 f64 FMA per window on the tensor cores (the
                          f32 CUDA cores' rate, so the same bound as the
                          earlier CUDA-core kernel's M^2 f32 FMA); keys,
                          valid, A_in in, the alpha stream out
      K2 dsc_sweep        2 M^2 f32 FMA and M^2 f64 add; the alpha stream in
      K2g dsc_sweep_gamma K2, plus the (S, L, M) f32 gamma stream out
      K4 viterbi_ops      M^3 add (FMA pipe) and M^3 max (ALU pipe); (S,
                          M, M) out
      K5 viterbi_paths    per candidate (M^2): an add (FMA pipe), then a
                          compare, a select of the score and a select of
                          the index (ALU pipe: the first-index argmax
                          compiles to FSETP, FSEL and SEL); (S, L) int32
                          path out
    """
    S, L = keys.shape
    n_keys, M = E.shape
    W, nv = S * L, int(valid.sum())
    b = 5 * W + 4 * (M * M + n_keys * M)  # keys, valid, T and E
    f64 = alu = 0
    if name == "segment_ops":
        b += 4 * S * (M * M + 1)
        if not cuda_cores:
            return _roofline(nv * M * M, 2 * nv * M * M, b, nv * M**3, nv * M * M,
                             alu_at_fma)
        f32 = nv * M**3
    elif name == "asc_sweep":
        return _roofline(0, 0, b + W * M * elt + 8 * S * M, nv * M * M)
    elif name in ("dsc_sweep", "dsc_sweep_gamma"):
        f32, f64 = 2 * nv * M * M, nv * M * M
        b += W * M * elt + 8 * S * M + 8 * (M * M + n_keys * M)
        if name == "dsc_sweep_gamma":
            b += 4 * W * M
    elif name == "viterbi_ops":
        f32, alu, b = nv * M**3, nv * M**3, b + 4 * S * M * M
    elif name == "viterbi_paths":
        f32, b = nv * M * M, b + 4 * W + 8 * S
        alu = (2 if alu_at_fma else 3) * nv * M * M
    else:
        raise ValueError(name)
    return _roofline(f32, f64, b, 0, alu, alu_at_fma)


def _roofline(f32, f64, b, f64_tc=0, alu=0, alu_at_fma=False):
    """(ms, bound_by): ``f32`` FMA-pipe operations, ``alu`` ALU-pipe ones,
    ``f64`` and ``f64_tc`` f64 ones off and on the tensor cores, ``b``
    bytes.  ``alu_at_fma``: the ALU operations at the FMA rate, no issue
    limit (the earlier model)."""
    if alu_at_fma:
        t_32 = (f32 + alu) / F32_OPS_PER_S
    else:
        t_32 = max(f32 / F32_OPS_PER_S, alu / F32_ALU_PER_S,
                   (f32 + alu) / THREAD_INSTR_PER_S)
    t_ops = max(t_32, f64 / F64_OPS_PER_S, f64_tc / F64_TC_FMA_PER_S)
    t_bytes = b / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def scan_bound(name, M, S, soc, alu_at_fma=False):
    """(bound_ms, bound_by) of one launch of a per-contig boundary scan over
    the (S, M, M) segment operators laid out by ``soc`` (C, NS): n listed
    segments, each operator read once; padded slots are the identity and
    cost nothing.

      K6 boundary_scan     2 n M^2 FMA (forward and backward matvecs); ops,
                           logs, pi and soc in, A_in and Q_end (S, M) f32
                           and ll out
      K7 viterbi_boundary  per candidate (n M^2) an add, a compare and two
                           selects, as K5; ops, log pi and soc in, (S,)
                           int32 entry and exit states out
    """
    soc = np.asarray(soc)
    n = int((soc >= 0).sum())
    b = 4 * n * M * M + 4 * M + 4 * soc.size
    if name == "boundary_scan":
        b += 4 * n + 8 * S * M + 8 * soc.shape[0]
        return _roofline(2 * n * M * M, 0, b)
    if name != "viterbi_boundary":
        raise ValueError(name)
    # the earlier model: an add and a max a candidate
    return _roofline(n * M * M, 0, b + 8 * S, 0, (1 if alu_at_fma else 3) * n * M * M,
                     alu_at_fma)


def build():
    from smcpp_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 0:.1f} s, "
        f"one per source in parallel) -> {_cuda.library_paths()}")


def cuda_ms(fn, reps):
    "Mean milliseconds of fn() on the card, timed with CUDA events."
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def problem(seed, S, L, M, n_keys):
    import torch

    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.95
    valid[-1, L // 2:] = False
    A_in = rng.rand(S, M)
    Q_end = rng.rand(S, M)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa: E731
    return (f(T), f(E), torch.as_tensor(keys, device="cuda"),
            torch.as_tensor(valid, device="cuda"), f(A_in), f(Q_end))


def check_close(name, got, want, rtol, atol):
    import torch

    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs err {err:.3g}, {int(bad.sum())} elements over "
            f"rtol={rtol:g} atol={atol:.3g})"
        )
    return err


def k3_plain(T, E, keys, valid, prec):
    "K3's plain version: the window loop with f64 sums."
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    return wk.segment_ops_plain(T, E, keys, valid, prec, sum_dtype=torch.float64)


def check_k3(tag, T, E, keys, valid, prec):
    """K3 against its plain version on one input set at one rung (ops at
    rtol 1e-3 at 'default', 1e-5 with f32 carries, logs at 1e-5), with two
    launches bit-identical; raises on a miss.  Returns the max abs err of
    ops."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    rtol = DEFAULT_RTOL if prec == "default" else HIGHEST_RTOL
    ops, logs = wk.segment_ops_cuda(T, E, keys, valid, prec)
    ops2, logs2 = wk.segment_ops_cuda(T, E, keys, valid, prec)
    if not (torch.equal(ops, ops2) and torch.equal(logs, logs2)):
        raise AssertionError(f"segment_ops [{tag}]: two launches differ")
    del ops2, logs2
    ops_p, logs_p = k3_plain(T, E, keys, valid, prec)
    err = check_close(f"segment_ops [{tag}] ops", ops, ops_p, rtol,
                      1e-7 * float(ops_p.abs().max()))
    check_close(f"segment_ops [{tag}] logs", logs, logs_p, 1e-5,
                1e-6 * float(logs_p.abs().max()))
    log(f"segment_ops [{tag}]: {int((ops != ops_p).sum())} of {ops.numel()} ops "
        f"and {int((logs != logs_p).sum())} of {logs.numel()} logs differ from "
        f"the plain version's bits")
    return err


def k1_plain(T, E, keys, valid, A_in, prec):
    "K1's plain version: the ascending sweep with f64 sums."
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    return wk.asc_sweep_plain(T, E, keys, valid, A_in, prec, sum_dtype=torch.float64)


def check_k1(tag, T, E, keys, valid, A_in, prec):
    """K1 against its plain version (the sweep with f64 sums): alpha_end at
    rtol 1e-5, the stream at rtol 1e-5, or one bf16 ulp where it is stored
    in bf16; two launches bit-identical.  Then against the f32-summed loop
    (the reference's summation) at the same tolerances; where that loop has
    drifted past them (a near-identity T over many windows accumulates its
    f32 sums' rounding), K1 must lie no farther than it from the exact loop
    (the sweep in f64 throughout).  Logs the count of entries that differ
    from the plain version's bits, the distances from the exact loop when
    they are taken, and K1's launch (asc_sweep_plan); raises on a miss.
    Returns (max abs err of alpha_end against the plain version, K1's
    stream, the f32-summed loop's stream)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    al, ae = wk.asc_sweep_cuda(T, E, keys, valid, A_in, prec)
    al2, ae2 = wk.asc_sweep_cuda(T, E, keys, valid, A_in, prec)
    if not (torch.equal(al, al2) and torch.equal(ae, ae2)):
        raise AssertionError(f"asc_sweep [{tag}]: two launches differ")
    del al2, ae2
    s_tol = BF16_ULP if al.dtype == torch.bfloat16 else HIGHEST_RTOL
    al_p, ae_p = k1_plain(T, E, keys, valid, A_in, prec)
    err = check_close(f"asc_sweep [{tag}] alpha_end", ae, ae_p, HIGHEST_RTOL, 1e-7)
    check_close(f"asc_sweep [{tag}] alphas", al, al_p, s_tol, 1e-7)
    n_al, n_ae = int((al != al_p).sum()), int((ae != ae_p).sum())
    del al_p, ae_p
    al_32, ae_32 = wk.asc_sweep_plain(T, E, keys, valid, A_in, prec)
    try:
        check_close(f"asc_sweep [{tag}] alpha_end (f32 sums)", ae, ae_32, HIGHEST_RTOL, 1e-7)
        check_close(f"asc_sweep [{tag}] alphas (f32 sums)", al, al_32, s_tol, 1e-7)
        vs_32 = "within tolerance of the f32-summed loop"
    except AssertionError as miss:
        al_x, ae_x = wk.asc_sweep_plain(T.double(), E.double(), keys, valid,
                                        A_in.double(), "highest")
        pairs = [("alpha_end", ae, ae_32, ae_x)]
        if al.dtype == torch.float32:
            pairs.append(("stream", al, al_32, al_x))
        dist = {}
        for name, k, f32, x in pairs:
            d = [float(((y.double() - x).abs() / (x.abs() + 1e-7)).max()) for y in (k, f32)]
            dist[name] = d
            if d[0] > d[1]:
                raise AssertionError(
                    f"asc_sweep [{tag}] {name}: {miss}; and K1 lies farther from "
                    f"the exact loop ({d[0]:.3e}) than the f32-summed loop ({d[1]:.3e})"
                ) from miss
        del al_x
        vs_32 = ("past tolerance of the f32-summed loop, and nearer the exact loop "
                 "(max relative distance, K1 / f32-summed loop: " + ", ".join(
                     f"{n} {d[0]:.3e} / {d[1]:.3e}" for n, d in dist.items()) + ")")
    plan = wk.asc_sweep_plan(keys.shape[0], T.shape[0], E.shape[0],
                             al.dtype == torch.bfloat16)
    log(f"asc_sweep [{tag}]: {n_al} of {al.numel()} stream and {n_ae} of "
        f"{ae.numel()} alpha_end entries differ from the plain version's bits; "
        f"{vs_32}; launch {plan}")
    return err, al, al_32.contiguous()


def k1_estep_agreement(tag, T, E, keys, valid, Q_end, alphas, alphas_32):
    """The E-step's xisum and gsum (K2 on each stream) from K1's alpha
    stream beside those from the f32-summed loop's: logs the largest
    difference of each, relative to its largest entry."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    _, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end)
    _, xo_p, gs_p = wk.dsc_sweep_cuda(T, E, keys, valid, alphas_32, Q_end)
    dx = float((xo - xo_p).abs().max() / xo_p.abs().max())
    dg = float((gs - gs_p).abs().max() / gs_p.abs().max())
    log(f"E-step from K1's stream [{tag}]: xisum and gsum differ from the "
        f"f32-summed loop's by {dx:.3e} and {dg:.3e} (of their largest entries)")


def k2_plain(T, E, keys, valid, alphas, Q_end):
    """K2's plain version: the descending sweep with each window's per-key
    sums in f64 (an f32 index_add_'s atomic order varies on the card, and
    its sums with it; K2's gsum is 64-bit fixed point)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    return wk.dsc_sweep_plain(T, E, keys, valid, alphas, Q_end,
                              sum_dtype=torch.float64)


def compare(tag, T, E, keys, valid, A_in, Q_end, prec, reps):
    """Each kernel against its plain version on one input set at one rung;
    raises on a miss.  Returns {kernel name: (max abs err, kernel ms, plain
    ms)}."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    e3 = check_k3(tag, T, E, keys, valid, prec)
    t3 = cuda_ms(lambda: wk.segment_ops_cuda(T, E, keys, valid, prec), reps)
    t3p = cuda_ms(lambda: k3_plain(T, E, keys, valid, prec), 1)
    # K1, and the E-step from its stream
    e1, al, al_p = check_k1(tag, T, E, keys, valid, A_in, prec)
    k1_estep_agreement(tag, T, E, keys, valid, Q_end, al, al_p)
    del al
    t1 = cuda_ms(lambda: wk.asc_sweep_cuda(T, E, keys, valid, A_in, prec), reps)
    t1p = cuda_ms(lambda: k1_plain(T, E, keys, valid, A_in, prec), 1)
    # K2 on the same (plain) stream, so only K2 differs
    u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, al_p, Q_end)
    u_p, xo_p, gs_p = k2_plain(T, E, keys, valid, al_p, Q_end)
    check_close(f"dsc_sweep [{tag}] u_start", u, u_p, HIGHEST_RTOL, 1e-7)
    check_close(f"dsc_sweep [{tag}] xo", xo, xo_p, HIGHEST_RTOL,
                1e-8 * float(xo_p.abs().max()))
    e2 = check_close(f"dsc_sweep [{tag}] gsum", gs, gs_p, HIGHEST_RTOL,
                     1e-8 * float(gs_p.abs().max()))
    nv = float(valid.sum())
    if abs(float(gs.sum()) - nv) > 1e-6 * nv:
        raise AssertionError(f"dsc_sweep [{tag}]: sum(gsum) != valid windows")
    t2 = cuda_ms(lambda: wk.dsc_sweep_cuda(T, E, keys, valid, al_p, Q_end), reps)
    t2p = cuda_ms(lambda: k2_plain(T, E, keys, valid, al_p, Q_end), 1)
    elt = al_p.element_size()
    rec = {
        "segment_ops": (e3, t3, t3p, *bound("segment_ops", E, keys, valid)),
        "asc_sweep": (e1, t1, t1p, *bound("asc_sweep", E, keys, valid, elt)),
        "dsc_sweep": (e2, t2, t2p, *bound("dsc_sweep", E, keys, valid, elt)),
    }
    log(f"[{tag}] ms kernel/plain/bound: "
        + " ".join(f"{n} {r[1]:.3f}/{r[2]:.1f}/{r[3]:.4f}" for n, r in rec.items())
        + f"; max abs err {e3:.2e} {e1:.2e} {e2:.2e}")
    return rec


def check_equal(name, got, want):
    "K4, K5 and K7 are exact (adds and maxima): the kernel must equal the plain."
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(
            f"{name}: kernel differs from its plain version in "
            f"{int((got != want).sum())} of {got.numel()} entries"
        )
    return 0.0


def compare_decode(tag, T, E, keys, valid, A_in, Q_end, entry, exit_, reps):
    """K2g, K4 and K5 against their plain versions on one input set, with
    f32 carries (the decode's rung); raises on a miss.  Returns {kernel
    name: (max abs err, kernel ms, plain ms, bound ms, bound by)}."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    al, _ = wk.asc_sweep_plain(T, E, keys, valid, A_in, "highest")
    al = al.contiguous()
    *_, gam = wk.dsc_sweep_gamma_cuda(T, E, keys, valid, al, Q_end)
    *_, gam_p = wk.dsc_sweep_plain(T, E, keys, valid, al, Q_end, True)
    eg = check_close(f"dsc_sweep_gamma [{tag}] gamma", gam, gam_p,
                     HIGHEST_RTOL, 1e-7)
    del gam, gam_p
    tg = cuda_ms(lambda: wk.dsc_sweep_gamma_cuda(T, E, keys, valid, al, Q_end), reps)
    tgp = cuda_ms(lambda: wk.dsc_sweep_plain(T, E, keys, valid, al, Q_end, True), 1)
    del al
    e4 = check_equal(f"viterbi_ops [{tag}]", wk.viterbi_ops_cuda(T, E, keys, valid),
                     wk.viterbi_ops_plain(T, E, keys, valid))
    t4 = cuda_ms(lambda: wk.viterbi_ops_cuda(T, E, keys, valid), reps)
    t4p = cuda_ms(lambda: wk.viterbi_ops_plain(T, E, keys, valid), 1)
    rec = {
        "dsc_sweep_gamma": (eg, tg, tgp, *bound("dsc_sweep_gamma", E, keys, valid)),
        "viterbi_ops": (e4, t4, t4p, *bound("viterbi_ops", E, keys, valid)),
        "viterbi_paths": compare_k5(tag, T, E, keys, valid, entry, exit_, reps),
    }
    log(f"[{tag}] ms kernel/plain/bound: "
        + " ".join(f"{n} {r[1]:.3f}/{r[2]:.1f}/{r[3]:.4f}" for n, r in rec.items())
        + f"; max abs err {eg:.2e} {e4:.2e} 0 (K5 bit for bit)")
    return rec


def check_k5(tag, T, E, keys, valid, entry, exit_):
    """K5 against viterbi_paths_plain on one input set, bit for bit (ties
    included: the lowest maximizing state); two calls bit-identical; its two
    launches one at a time (ViterbiPaths.fwd, then .back) equal to the
    wrapper's call.  Logs the plan; raises on a miss.  Returns the plain
    version's CUDA-event milliseconds (one run)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    got = wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)
    if not torch.equal(got, wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)):
        raise AssertionError(f"viterbi_paths [{tag}]: two launches differ")
    k5 = wk.ViterbiPaths(T, E, keys, valid, entry, exit_)
    k5.fwd()
    check_equal(f"viterbi_paths [{tag}] fwd() then back()", k5.back(), got)
    del k5
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = wk.viterbi_paths_plain(T, E, keys, valid, entry, exit_)
    stop.record()
    torch.cuda.synchronize()
    check_equal(f"viterbi_paths [{tag}]", got, want)
    S, L = keys.shape
    log(f"viterbi_paths [{tag}]: equal to the plain version bit for bit "
        f"({S * L} windows), two launches bit-identical; plan "
        f"{wk.viterbi_paths_plan(S, L, T.shape[0], E.shape[0])}")
    return start.elapsed_time(stop)


def compare_k5(tag, T, E, keys, valid, entry, exit_, reps):
    """``check_k5``, then the wrapper's mean time: (max abs err, kernel ms,
    plain ms, bound ms, bound by)."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    t5p = check_k5(tag, T, E, keys, valid, entry, exit_)
    t5 = cuda_ms(lambda: wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_), reps)
    return (0.0, t5, t5p, *bound("viterbi_paths", E, keys, valid))


def k5_phases(tag, T, E, keys, valid, entry, exit_, reps=5):
    """CUDA-event milliseconds of K5's two launches (ViterbiPaths: the
    forward sweep ``fwd`` and the backtrace ``back``), mean of ``reps``
    runs each after a warm-up, printed with the plan."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    k5 = wk.ViterbiPaths(T, E, keys, valid, entry, exit_)
    k5.fwd()
    t = {"viterbi_fwd": cuda_ms(k5.fwd, reps), "viterbi_back": cuda_ms(k5.back, reps)}
    log(f"K5 phases [{tag}], ms: " + ", ".join(f"{n} {v:.4f}" for n, v in t.items())
        + f"; plan {k5.plan}")
    return t


def tie_problem(seed, S, L, M, n_keys, a, b):
    """tests/_viterbi_ties.py's inputs on the card: K5's candidates a < b
    tie exactly at every valid window once both are reachable.  Returns
    (T, E, keys, valid, entry, exit)."""
    import importlib.util

    import torch

    # by path: an installed package named "tests" may shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "_viterbi_ties", os.path.join(HERE, "tests", "_viterbi_ties.py"))
    ties = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ties)
    return tuple(torch.as_tensor(x, device="cuda")
                 for x in ties.tie_inputs(seed, S, L, M, n_keys, a, b))


def k5_alone(reps=5):
    """K5 alone at the posterior's shape (S x L = 6104 x 16384, M = 32, 63
    keys) on synthetic inputs: ``check_k5`` against the plain version on
    every window, ``k5_phases``, and the wrapper's time beside its bound;
    then the tie inputs at small shapes.  Not part of ``main``: a quick
    check and timing of K5 on the card."""
    S, L, M, nk = 6104, 16384, 32, 63
    T, E, keys, valid, _, _ = problem(SEED, S, L, M, nk)
    entry, exit_ = states(SEED, S, M)
    tag = f"posterior shape, S x L = {S} x {L}, M = {M}, {nk} keys"
    _, t, tp, b, by = compare_k5(tag, T, E, keys, valid, entry, exit_, reps)
    k5_phases(tag, T, E, keys, valid, entry, exit_, reps)
    log(f"K5 alone [{tag}]: {t:.4f} ms a call (plain {tp:.1f} ms), bound {b:.4f} ms ({by})")
    del T, E, keys, valid
    for M in (2, 15, 16, 17, 32):
        check_k5(f"ties M={M}", *tie_problem(SEED, 13, 200, M, 89, M // 3, M - 1))


def _rel_dist(got, want):
    "Largest |got - want| / (|want| + 1e-7), in f64."
    got, want = got.double().reshape(-1), want.double().reshape(-1)
    return float(((got - want).abs() / (want.abs() + 1e-7)).max())


def check_k6(tag, pi, ops, logs, soc, seg_has):
    """K6 on one input set at boundary_plan's chunk length: two launches
    bit-identical; against its chunked twin (contig_boundaries_chunked_plain:
    the vectors at rtol 1e-6 / atol 1e-8, ll at rtol 1e-9); against the
    sequential f32 loop (contig_boundaries_plain: rtol 1e-5 / atol 1e-7, ll
    1e-6), or, where that loop has drifted past those, K6 must lie no
    farther than it from the all-f64 sequential loop (ll, A_in and Q_end
    each); cvalid equal.  Logs the plan, the dependent depth and the
    distances; raises on a miss.  Returns (max abs err of the vectors
    against the sequential loop, that loop's outputs)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    NS = np.asarray(soc).shape[1]
    c, n_chunks = wk.boundary_plan(NS)
    got = wk.boundary_scan_cuda(pi, ops, logs, soc, seg_has)
    again = wk.boundary_scan_cuda(pi, ops, logs, soc, seg_has)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"boundary_scan [{tag}]: two launches differ")
    del again
    twin = wk.contig_boundaries_chunked_plain(pi, ops, logs, soc, seg_has, c)
    e_twin = max(check_close(f"boundary_scan [{tag}] {n} (chunked twin)", got[i],
                             twin[i], 1e-6, 1e-8) for i, n in ((1, "A_in"), (2, "Q_end")))
    check_close(f"boundary_scan [{tag}] ll (chunked twin)", got[0].reshape(1),
                twin[0].reshape(1), 1e-9, 0.0)
    check_equal(f"boundary_scan [{tag}] cvalid (chunked twin)", got[3], twin[3])
    del twin
    plain = wk.contig_boundaries_plain(pi, ops, logs, soc, seg_has)
    check_equal(f"boundary_scan [{tag}] cvalid", got[3], plain[3])
    err = max(float((got[i].double() - plain[i].double()).abs().max()) for i in (1, 2))
    try:
        for i, n in ((1, "A_in"), (2, "Q_end")):
            check_close(f"boundary_scan [{tag}] {n}", got[i], plain[i], HIGHEST_RTOL, 1e-7)
        check_close(f"boundary_scan [{tag}] ll", got[0].reshape(1),
                    plain[0].reshape(1), 1e-6, 0.0)
        vs = "within tolerance of the sequential f32 loop"
    except AssertionError as miss:
        exact = wk.contig_boundaries_plain(pi.double(), ops.double(), logs.double(),
                                           soc, seg_has)
        dist = {}
        for i, n in ((0, "ll"), (1, "A_in"), (2, "Q_end")):
            d = [_rel_dist(y[i], exact[i]) for y in (got, plain)]
            dist[n] = d
            if d[0] > d[1]:
                raise AssertionError(
                    f"boundary_scan [{tag}] {n}: {miss}; and K6 lies farther from the "
                    f"f64 loop ({d[0]:.3e}) than the f32 loop ({d[1]:.3e})") from miss
        vs = ("past tolerance of the sequential f32 loop, and nearer the f64 loop "
              "(max relative distance, K6 / f32 loop: " + ", ".join(
                  f"{n} {d[0]:.3e} / {d[1]:.3e}" for n, d in dist.items()) + ")")
    depth = 2 * c + n_chunks if n_chunks > 1 else NS
    log(f"boundary_scan [{tag}]: plan c = {c}, n_chunks = {n_chunks}, "
        f"{np.asarray(soc).shape[0] * n_chunks} chunk rows, dependent depth {depth} "
        f"steps (sequential: {NS}); two launches bit-identical; chunked twin max abs "
        f"err {e_twin:.2e}; {vs}")
    return err, plain


def k6_phases(tag, pi, ops, logs, soc, seg_has, reps=20):
    """CUDA-event milliseconds of each of K6's phases (BoundaryScan) on one
    input set, mean of ``reps`` runs each after a warm-up: the wrapper's
    setup (the chunk rows' copy to the card, cvalid, the zeroed outputs),
    then the three launches (each reruns on the same inputs)."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    k6 = wk.BoundaryScan(pi, ops, logs, soc, seg_has)
    t = {
        "setup": cuda_ms(lambda: wk.BoundaryScan(pi, ops, logs, soc, seg_has), reps),
        "chunk_products": cuda_ms(k6.products, reps),
        "chunk_scan": cuda_ms(k6.chunk_scan, reps),
        "finish": cuda_ms(k6.finish, reps),
    }
    log(f"K6 phases [{tag}] (c = {k6.chunk}, n_chunks = {k6.n_chunks}), ms: "
        + ", ".join(f"{n} {v:.4f}" for n, v in t.items()))
    return t


def k6_alone(reps=20):
    """K6 alone at the cells' contig layouts on random operators (the
    posterior's 1 x 6104 at M = 32, the slice's 2 x 3907 at M = 15, C3's 22
    x 306 at M = 16): ``check_k6``, ``k6_phases``, and the time of a call
    at the plan's chunk length beside the sequential scan's (one chunk a
    contig).  Not part of ``main``: a quick timing of K6 on the card."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    for tag, C, NS, M in [("posterior", 1, 6104, 32), ("slice", 2, 3907, 15),
                          ("C3", 22, 306, 16)]:
        rng = np.random.RandomState(SEED)
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa: E731
        ops, logs = f(rng.uniform(0.01, 1.0, (C * NS, M, M))), f(rng.uniform(-40, -1, C * NS))
        pi = f(rng.dirichlet(np.ones(M)))
        soc = np.arange(C * NS).reshape(C, NS)
        has = torch.ones(C * NS, dtype=torch.bool, device="cuda")
        check_k6(tag, pi, ops, logs, soc, has)
        k6_phases(tag, pi, ops, logs, soc, has, reps)
        t = [cuda_ms(lambda: wk.boundary_scan_cuda(pi, ops, logs, soc, has, chunk=k), reps)
             for k in (None, NS)]
        log(f"K6 alone [{tag}, C x NS = {C} x {NS}, M = {M}]: {t[0]:.4f} ms a call at "
            f"the plan's chunk length, {t[1]:.4f} ms as the sequential scan")


def check_k7(tag, pi, W, soc, chunk=None, exact=False):
    """K7 on one input set at boundary_plan's chunk length (or ``chunk``):
    two launches bit-identical; equal to its chunked twin
    (viterbi_boundary_states_chunked_plain) bit for bit; against the
    sequential loop (viterbi_boundary_states_plain): equal, or, in each
    contig whose states differ, path scores (viterbi_boundary_path_score)
    within δ (viterbi_boundary_delta) of each other, and none past it;
    ``exact`` (inputs whose sums are all exact) asks for equal states.
    Logs the plan, n_chunks, the dependent depth, the differing-state count,
    the largest score gap beside δ, and the entry vectors' largest distance
    from the sequential loop's V at the chunk boundaries (lanes above
    -1e29).  Raises on a miss.  Returns (K7's states, the twin's CUDA-event
    ms of one run)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    socn = np.asarray(soc)
    C, NS = socn.shape
    M = W.shape[-1]
    c = chunk or wk.boundary_plan(NS)[0]
    got = wk.viterbi_boundary_cuda(pi, W, soc, chunk=c)
    again = wk.viterbi_boundary_cuda(pi, W, soc, chunk=c)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"viterbi_boundary [{tag}]: two launches differ")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    twin = wk.viterbi_boundary_states_chunked_plain(pi, W, soc, c)
    stop.record()
    torch.cuda.synchronize()
    for n, g, t in zip(("entry", "exit"), got, twin):
        check_equal(f"viterbi_boundary [{tag}] {n} (chunked twin)", g, t)
    seq = wk.viterbi_boundary_states_plain(pi, W, soc)
    listed = torch.as_tensor(socn[socn >= 0], device=W.device)
    n_diff = int(sum(int((g[listed] != q[listed]).sum()) for g, q in zip(got, seq)))
    diff, gap, delta = wk.viterbi_boundary_agreement(pi, W, soc, got, seq)
    max_gap = float(torch.where(diff, gap, 0.0).max())
    if bool((diff & (gap > delta)).any()) or (exact and n_diff):
        raise AssertionError(
            f"viterbi_boundary [{tag}]: {n_diff} boundary states differ from the "
            f"sequential loop, largest path-score gap {max_gap!r} against δ "
            f"{float(delta.max())!r}" + (" (exact inputs)" if exact else ""))
    # the entry vectors beside the sequential loop's V at each chunk boundary
    rows, n_chunks = wk._chunk_rows(socn, c)
    dist = 0.0
    if n_chunks > 1:
        k7 = wk.ViterbiBoundary(pi, W, soc, c)
        k7.products()
        k7.chunk_scan()
        entry = k7.entry.view(C, n_chunks, M)
        rows = rows.reshape(C, n_chunks, c)
        V = wk._log_pi(pi, W.dtype).expand(C, M)
        for k in range(n_chunks):
            ok = V > -1e29
            if bool(ok.any()):
                dist = max(dist, float((entry[:, k] - V).abs()[ok].max()))
            _, V = wk._mp_rows_forward(W, rows[:, k], V)
    depth = 3 * c + 2 * n_chunks if n_chunks > 1 else 2 * NS
    log(f"viterbi_boundary [{tag}]: plan c = {c}, n_chunks = {n_chunks}, "
        f"{C * n_chunks} chunk rows, dependent depth {depth} steps (sequential: "
        f"{2 * NS}); two launches bit-identical; equal to the chunked twin bit for "
        f"bit; {n_diff} of {2 * len(listed)} boundary states differ from the "
        f"sequential loop (largest path-score gap {max_gap!r}, δ {float(delta.max())!r}); "
        f"entry vectors within {dist!r} of its V at the chunk boundaries")
    return got, start.elapsed_time(stop)


def k7_phases(tag, pi, W, soc, reps=20):
    """CUDA-event milliseconds of each of K7's phases (ViterbiBoundary) on
    one input set, mean of ``reps`` runs each after a warm-up: the
    wrapper's setup (the chunk rows' copy to the card, log pi, the zeroed
    outputs), then the four launches (each reruns on the same inputs)."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    k7 = wk.ViterbiBoundary(pi, W, soc)
    k7.products()
    k7.chunk_scan()
    k7.forward()
    t = {
        "setup": cuda_ms(lambda: wk.ViterbiBoundary(pi, W, soc), reps),
        "vb_products": cuda_ms(k7.products, reps),
        "vb_chunk_scan": cuda_ms(k7.chunk_scan, reps),
        "vb_forward": cuda_ms(k7.forward, reps),
        "vb_trace": cuda_ms(k7.trace, reps),
    }
    log(f"K7 phases [{tag}] (c = {k7.chunk}, n_chunks = {k7.n_chunks}), ms: "
        + ", ".join(f"{n} {v:.4f}" for n, v in t.items()))
    return t


def k7_alone(reps=20):
    """K7 alone at the cells' contig layouts on random normalised max-plus
    operators (the posterior's 1 x 6104 at M = 32, the slice's 2 x 3907 at
    M = 15, C3's 22 x 306 at M = 16): ``check_k7``, ``k7_phases``, and the
    time of a call at the plan's chunk length beside the sequential scan
    (``chunk=NS``); then K4's operators of the tie inputs (twin states) and
    small-integer operators, where K7 must equal the sequential loop.  Not
    part of ``main``: a quick check and timing of K7 on the card."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    for tag, C, NS, M in [("posterior", 1, 6104, 32), ("slice", 2, 3907, 15),
                          ("C3", 22, 306, 16)]:
        rng = np.random.RandomState(SEED)
        W = rng.uniform(-30.0, 0.0, (C * NS, M, M))
        W -= W.max((1, 2), keepdims=True)
        W = torch.as_tensor(W, dtype=torch.float32, device="cuda")
        pi = torch.as_tensor(rng.dirichlet(np.ones(M)), dtype=torch.float32, device="cuda")
        soc = np.arange(C * NS).reshape(C, NS)
        check_k7(tag, pi, W, soc)
        k7_phases(tag, pi, W, soc, reps)
        t = [cuda_ms(lambda: wk.viterbi_boundary_cuda(pi, W, soc, chunk=k), reps)
             for k in (None, NS)]
        log(f"K7 alone [{tag}, C x NS = {C} x {NS}, M = {M}]: {t[0]:.4f} ms a call at "
            f"the plan's chunk length, {t[1]:.4f} ms as the sequential scan")
    k7_exact()


def k7_exact():
    """K7 on inputs whose sums are exact, where it must equal the sequential
    loop: K4's operators of the tie inputs (twin states a < b, tied at every
    step; no boundary state may be b) and small-integer operators with 5%
    -1e30 entries and a pi with a zero (no path may start there), over
    uneven contigs, at the plan's chunk length and chunks of 3."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    for M in (2, 15, 16, 17, 32):
        a, b = M // 3, M - 1
        T, E, keys, valid, _, _ = tie_problem(SEED, 13, 200, M, 89, a, b)
        W = wk.viterbi_ops_cuda(T, E, keys, valid)
        pi = torch.full((M,), 1.0 / M, device="cuda")
        soc = uneven_contigs(13)
        for chunk in (None, 3):
            got, _ = check_k7(f"ties M={M} chunk={chunk}", pi, W, soc, chunk, exact=True)
            if any(bool((g == b).any()) for g in got):
                raise AssertionError(f"viterbi_boundary [ties M={M}]: the twin state "
                                     f"{b} was taken over {a}")
        rng = np.random.RandomState(SEED + M)
        Wi = rng.randint(-3, 1, (64, M, M)).astype(np.float32)
        Wi[rng.rand(64, M, M) < 0.05] = -1e30
        pi = rng.dirichlet(np.ones(M))
        pi[1] = 0.0
        pi = torch.as_tensor(pi, dtype=torch.float32, device="cuda")
        soc = uneven_contigs(64)
        for chunk in (None, 3):
            got, _ = check_k7(f"small integers M={M} chunk={chunk}", pi,
                              torch.as_tensor(Wi, device="cuda"), soc, chunk, exact=True)
            if bool((got[0][torch.as_tensor(soc[:, 0], device="cuda")] == 1).any()):
                raise AssertionError(f"viterbi_boundary [small integers M={M}]: a "
                                     "path starts in a state with pi == 0")


def compare_boundary(tag, pi, ops, logs, soc, seg_has, W, reps):
    """K6 on the operators ``ops``, ``logs`` (``check_k6``, then its phase
    times) and K7 on ``W`` (``check_k7``, then its phase times; skipped
    when W is None), with the contig layout ``soc``; raises on a miss.
    Returns ({kernel name: (max abs err, kernel ms, plain ms, bound ms,
    bound by)}, the sequential loop's outputs (ll, A_in, Q_end, cvalid) and
    K7's (entry, exit) or None).  K7's plain ms is its chunked twin's."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    S, M = ops.shape[0], ops.shape[-1]
    e6, plain = check_k6(tag, pi, ops, logs, soc, seg_has)
    k6_phases(tag, pi, ops, logs, soc, seg_has)
    t6 = cuda_ms(lambda: wk.boundary_scan_cuda(pi, ops, logs, soc, seg_has), reps)
    t6p = cuda_ms(lambda: wk.contig_boundaries_plain(pi, ops, logs, soc, seg_has), 1)
    rec = {"boundary_scan": (e6, t6, t6p, *scan_bound("boundary_scan", M, S, soc))}
    states = None
    if W is not None:
        states, t7p = check_k7(tag, pi, W, soc)
        k7_phases(tag, pi, W, soc)
        t7 = cuda_ms(lambda: wk.viterbi_boundary_cuda(pi, W, soc), reps)
        rec["viterbi_boundary"] = (0.0, t7, t7p,
                                   *scan_bound("viterbi_boundary", M, S, soc))
    NS = np.asarray(soc).shape[1]
    c, n_chunks = wk.boundary_plan(NS)
    log(f"[{tag}] C x NS = {np.asarray(soc).shape} ms kernel/plain/bound: "
        + " ".join(f"{n} {r[1]:.3f}/{r[2]:.1f}/{r[3]:.4f}" for n, r in rec.items())
        + f"; K6 dependent depth {2 * c + n_chunks if n_chunks > 1 else NS} steps "
        f"(c = {c}, n_chunks = {n_chunks}); max abs err {e6:.2e}")
    return rec, plain, states


def uneven_contigs(S, C=3):
    "seg_of_contig for S segments over C contigs of uneven length, tail-padded."
    cuts = np.concatenate([[0], np.sort(np.random.RandomState(SEED).choice(
        np.arange(1, S), C - 1, replace=False)), [S]])
    soc = np.full((C, np.diff(cuts).max()), -1, np.int64)
    for c in range(C):
        soc[c, : cuts[c + 1] - cuts[c]] = np.arange(cuts[c], cuts[c + 1])
    return soc


def states(seed, S, M):
    import torch

    rng = np.random.RandomState(seed)
    return tuple(
        torch.as_tensor(rng.randint(0, M, S).astype(np.int32), device="cuda")
        for _ in range(2)
    )


def compare_small():
    """Every kernel against its plain version on synthetic inputs: K1-K3 at
    both rungs, K2g, K4 and K5 at f32 carries, K6 and K7 on K3's and K4's
    operators over uneven contigs, and the six window kernels with a key
    table past a block's shared memory."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    for S, L, M, nk in [(64, 512, 15, 89), (64, 512, 16, 89), (64, 512, 17, 89)]:
        T, E, keys, valid, A_in, Q_end = problem(SEED, S, L, M, nk)
        wk.check_key_range(keys.cpu().numpy(), nk)
        for prec in ("highest", "default"):
            compare(f"small S={S} L={L} M={M} keys={nk} {prec}",
                    T, E, keys, valid, A_in, Q_end, prec, 3)
    S, L, nk = 64, 512, 89
    for M in (2, 15, 16, 17, 32):
        T, E, keys, valid, A_in, Q_end = problem(SEED, S, L, M, nk)
        compare_decode(f"small S={S} L={L} M={M} keys={nk}", T, E, keys, valid,
                       A_in, Q_end, *states(SEED, S, M), 3)
        ops, logs = wk.segment_ops_cuda(T, E, keys, valid, "highest")
        pi = A_in[0] / A_in[0].sum()
        pi[1] = 0.0  # a state no MAP path may start in
        compare_boundary(f"small S={S} M={M}", pi, ops, logs, uneven_contigs(S),
                         torch.any(valid, 1), wk.viterbi_ops_cuda(T, E, keys, valid), 3)
        check_k5(f"ties S=13 L=200 M={M}", *tie_problem(SEED, 13, 200, M, 89,
                                                         M // 3, M - 1))
    k7_exact()
    S, L, M, nk = 64, 512, 32, 1000
    T, E, keys, valid, A_in, Q_end = problem(SEED, S, L, M, nk)
    for prec in ("highest", "default"):
        compare(f"large table S={S} L={L} M={M} keys={nk} {prec}",
                T, E, keys, valid, A_in, Q_end, prec, 3)
    compare_decode(f"large table S={S} L={L} M={M} keys={nk}", T, E, keys,
                   valid, A_in, Q_end, *states(SEED, S, M), 3)
    log("kernel comparisons (small): all within tolerance")


def compare_main_path(im):
    """Every E-step kernel against its plain version on the fitted manager's
    own inputs: its packed window keys and valid mask, its f32 T and E, the
    segment operators and the boundary vectors contig_boundaries gives them.
    Both rungs; returns the records at the rung the fit ended on
    ('tensorfloat32' stores what 'highest' stores)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    pi, T, E = (x.float().contiguous() for x in im.tensors())
    keys, valid, soc = im._wkeys, im._wvalid, im._soc
    S, L = keys.shape
    fit_rung = "default" if im.precision == "default" else "highest"
    records = {}
    for prec in ("highest", "default"):
        tag = f"main path S={S} L={L} M={T.shape[0]} keys={E.shape[0]} {prec}"
        ops, logs = wk.segment_ops_plain(T, E, keys, valid, prec)
        rec6, (_, A_in, Q_end, _), _ = compare_boundary(
            tag, pi, ops.contiguous(), logs, soc, torch.any(valid, 1), None, 5)
        rec = compare(tag, T, E, keys, valid, A_in.contiguous(),
                      Q_end.contiguous(), prec, 5)
        rec.update(rec6)
        if prec == fit_rung:
            records = rec
    log(f"kernel comparisons (main path): all within tolerance; records at "
        f"'{fit_rung}' (the fit ended on {im.precision!r})")
    return records


def simulate(workdir, name, L_bp, seed, n=20):
    """One contig of L_bp bases, n = 20 haplotypes, from the slice's truth
    (the port's data/simulate.py, theta = rho = 2.5e-4); returns its path."""
    from smcpp_tpu_torch.data.simulate import write_simulated
    from smcpp_tpu_torch.models.model import SMCModel

    truth = SMCModel([0.01, 0.1, 1.0, 5.0], 1e4, "piecewise")
    truth.y[:] = np.log([1.0, 0.3, 1.0, 2.0])
    fn = os.path.join(workdir, f"{name}.smc.gz")
    write_simulated(fn, truth, 2.5e-4, 2.5e-4, L=L_bp, n=n, seed=seed, pid="pop1")
    return fn


def main_path(workdir):
    """Simulate the slice's data and run estimate through the CLI entry
    point; returns (launches, kernel records from compare_main_path, the
    fitted model.final.json, the data files)."""
    import torch

    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.inference import analysis as an
    from smcpp_tpu_torch.inference import manager as mg
    from smcpp_tpu_torch.ops import window_kernel as wk

    L_bp, n, mu = 100_000_000, 20, 1.25e-8
    t0 = time.perf_counter()
    files = [simulate(workdir, f"contig{i}", L_bp, SEED + i) for i in range(2)]
    log(f"simulated 2 contigs x {L_bp / 1e6:.0f} Mbp, n={n}: "
        f"{time.perf_counter() - t0:.1f} s")

    # timing hooks: E-step durations and the stage-2 start
    events = []
    orig_estep = mg.OnePopInferenceManager.E_step
    orig_init_im = an.BaseAnalysis._init_inference_manager

    def timed_estep(self):
        t = time.perf_counter()
        out = orig_estep(self)
        torch.cuda.synchronize()
        events.append(("estep", len(self.hidden_states) - 1, t, time.perf_counter()))
        return out

    def timed_init_im(self, pe, hs):
        events.append(("manager", len(hs) - 1, time.perf_counter(), None))
        return orig_init_im(self, pe, hs)

    mg.OnePopInferenceManager.E_step = timed_estep
    an.BaseAnalysis._init_inference_manager = timed_init_im
    out = os.path.join(workdir, "out")
    for k in wk.KERNELS:
        k.launches = 0
    t_start = time.perf_counter()
    try:
        analysis = cli.main([
            "estimate", "--device", "cuda", "--em-iterations", "2",
            "-o", out, str(mu), *files,
        ])
    finally:
        mg.OnePopInferenceManager.E_step = orig_estep
        an.BaseAnalysis._init_inference_manager = orig_init_im
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k.name: k.launches for k in wk.ESTEP_KERNELS}

    with open(os.path.join(out, "model.final.json")) as f:
        d = json.load(f)
    y = np.asarray(d["model"]["y"], float)
    if not (np.all(np.isfinite(y)) and np.isfinite(d["rho"]) and d["rho"] > 0):
        raise AssertionError(f"model.final.json is not finite: {d}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    stage2_start = [e[2] for e in events if e[0] == "manager" and e[1] > 1][0]
    est2 = [(e[2], e[3]) for e in events if e[0] == "estep" and e[1] > 1]
    # the first stage-2 E-step sets the regularization penalty; then each EM
    # iteration is one E-step followed by its M-step
    iters = []
    for i, (a, b) in enumerate(est2[1:], 1):
        nxt = est2[i + 1][0] if i + 1 < len(est2) else t_end
        iters.append((b - a, nxt - b))
    M = len(analysis.hidden_states) - 1
    log(f"estimate: stage 1 {stage2_start - t_start:.2f} s, stage 2 "
        f"{t_end - stage2_start:.2f} s, total {t_end - t_start:.2f} s; "
        f"hidden states: {analysis.hidden_state_path} (M={M}); "
        f"S x L = {tuple(analysis._ims[('pop1',)]._wkeys.shape)}")
    for i, (e, m) in enumerate(iters):
        log(f"  EM iteration {i}: E-step {e:.3f} s, M-step {m:.3f} s")
    log(f"  final loglik {analysis.loglik():.6f}, rho {d['rho']:.6g}, "
        f"y {np.round(y, 4).tolist()}")
    log(f"  kernel launches on the main path: {launches}")
    im = analysis._ims[("pop1",)]
    t0 = time.perf_counter()
    pi, T, E = im.tensors()
    torch.cuda.synchronize()
    log(f"  f64 (pi, T, E) setup on the device: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    pi, T, E = (x.float().contiguous() for x in (pi, T, E))
    estep_breakdown("slice", pi, T, E, im._wkeys, im._wvalid, im._soc)
    ll_agreement("slice", pi, T, E, im._wkeys, im._wvalid, im._soc, im.precision)
    records = compare_main_path(im)
    span_estep(im)
    return launches, records, os.path.join(out, "model.final.json"), files


def phase_times(label, shape, phases):
    """Milliseconds of each phase yielded by the generator function
    ``phases`` (CUDA events after each yield), after one warm-up run."""
    import torch

    for _ in phases():
        pass
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    names = []
    for name in phases():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        names.append(name)
    torch.cuda.synchronize()
    parts = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    log(f"{label} breakdown [{shape}]: total {sum(parts):.2f} ms; "
        + ", ".join(f"{n} {t:.2f}" for n, t in zip(names, parts)))
    return dict(zip(names, parts))


def k3_bound(E, keys, valid):
    """K3's entry for ``log_bounds`` (its f64 tensor-core bound), after
    logging the CUDA-core bound of the same work beside it, the form earlier
    kernels' rows give."""
    b, by = bound("segment_ops", E, keys, valid)
    bc, byc = bound("segment_ops", E, keys, valid, cuda_cores=True)
    log(f"  segment_ops (K3) bound: f64 tensor cores {b:.4f} ms ({by}); "
        f"f32 CUDA cores {bc:.4f} ms ({byc})")
    return b, by


def ll_agreement(tag, pi, T, E, keys, valid, soc, prec):
    """The E-step log-likelihood from K3's operators (through
    contig_boundaries) beside the one from its plain version's (f64 sums),
    from the loop summed in f32 (the reference's summation, which the
    CUDA-core K3 of earlier commits reproduced bit for bit) and from the
    whole loop in f64 at 'highest' (the exact value, up to f64 rounding),
    with each one's relative distance from the exact value; raises when
    K3's differs from its plain version's by more than 1e-6 relative (K6's
    log-likelihood tolerance)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    seg_has = torch.any(valid, 1)

    def ll(ops, logs, pi=pi):
        return float(wk.contig_boundaries_plain(pi, ops, logs, soc, seg_has)[0]
                     if ops.dtype == torch.float64 else
                     wk.contig_boundaries(pi, ops.contiguous(), logs.contiguous(),
                                          soc, seg_has)[0])

    l_k = ll(*wk.segment_ops_cuda(T, E, keys, valid, prec))
    l_p = ll(*k3_plain(T, E, keys, valid, prec))
    l_32 = ll(*wk.segment_ops_plain(T, E, keys, valid, prec))
    l_x = ll(*wk.segment_ops_plain(T.double(), E.double(), keys, valid, "highest"),
             pi=pi.double())
    d_p, d_32 = abs(l_k - l_p) / abs(l_p), abs(l_k - l_32) / abs(l_32)
    x_k, x_p, x_32 = (abs(v - l_x) / abs(l_x) for v in (l_k, l_p, l_32))
    log(f"E-step loglik [{tag}, {prec!r}]: K3 {l_k!r}, plain (f64 sums) "
        f"{l_p!r}, plain (f32 sums) {l_32!r}, exact (f64 loop) {l_x!r}; K3's "
        f"relative difference from the first two {d_p:.3e}, {d_32:.3e}; "
        f"relative distance from the exact value: K3 {x_k:.3e}, plain (f64 "
        f"sums) {x_p:.3e}, plain (f32 sums) {x_32:.3e}")
    if not np.isfinite(l_k) or d_p > 1e-6:
        raise AssertionError(f"E-step loglik [{tag}]: K3 is {d_p:.3e} from its "
                             "plain version")


def log_bounds(label, times, bounds):
    """Each kernel phase's time beside its bound (``bound``) at the phase's
    own shape: {phase name: (bound_ms, bound_by)}."""
    log(f"{label} kernels, ms / bound ms (bound by): " + ", ".join(
        f"{n} {times[n]:.3f} / {b:.4f} ({by})" for n, (b, by) in bounds.items()))


def posterior_breakdown(im, pi, T, E):
    "Phases of the manager's window decode and window Viterbi, in ms."
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    keys, valid, soc = im._wkeys, im._wvalid, im._soc
    ends, prec = im._row_ends(), im._decode_precision()
    shape = (f"S x L = {tuple(keys.shape)}, M = {T.shape[0]}, "
             f"{E.shape[0]} keys, {len(ends)} rows, rung {prec!r}")

    def decode():
        ops, logs = wk.segment_operators(T, E, keys, valid, prec)
        yield "segment_ops (K3)"
        _, A_in, Q_end, _ = wk.contig_boundaries(pi, ops, logs, soc,
                                                 torch.any(valid, 1))
        yield "contig_boundaries (K6)"
        alphas, _ = wk.asc_sweep_cuda(T, E, keys, valid, A_in.contiguous(), prec)
        yield "asc_sweep (K1)"
        *_, gam = wk.dsc_sweep_gamma_cuda(T, E, keys, valid, alphas,
                                          Q_end.contiguous())
        del alphas
        yield "dsc_sweep_gamma (K2g)"
        wk.rows_from_windows(gam, ends)
        yield "prefix sum"

    def viterbi():
        W = wk.viterbi_ops_cuda(T, E, keys, valid)
        yield "viterbi_ops (K4)"
        entry, exit_ = wk.viterbi_boundary_states(pi, W, soc)
        yield "boundary states (K7)"
        path = wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)
        yield "viterbi_paths (K5)"
        path.reshape(-1)[ends]
        yield "row gather"

    t = phase_times("decode", shape, decode)
    t.update(phase_times("Viterbi", shape, viterbi))
    elt = wk.carry_dtype(prec, torch.float32).itemsize
    M, S = T.shape[0], keys.shape[0]
    log_bounds("posterior", t, {
        "segment_ops (K3)": k3_bound(E, keys, valid),
        "contig_boundaries (K6)": scan_bound("boundary_scan", M, S, soc),
        "asc_sweep (K1)": bound("asc_sweep", E, keys, valid, elt),
        "dsc_sweep_gamma (K2g)": bound("dsc_sweep_gamma", E, keys, valid, elt),
        "viterbi_ops (K4)": bound("viterbi_ops", E, keys, valid),
        "boundary states (K7)": scan_bound("viterbi_boundary", M, S, soc),
        "viterbi_paths (K5)": bound("viterbi_paths", E, keys, valid),
    })
    log("posterior bounds, ms (bound by), compares, maxima and selects at the ALU "
        "rate with the issue limit / at the FMA rate (the earlier model): "
        + ", ".join(f"{n} {a[0]:.4f} ({a[1]}) / {b[0]:.4f} ({b[1]})" for n, a, b in [
            ("viterbi_ops (K4)", bound("viterbi_ops", E, keys, valid),
             bound("viterbi_ops", E, keys, valid, alu_at_fma=True)),
            ("boundary states (K7)", scan_bound("viterbi_boundary", M, S, soc),
             scan_bound("viterbi_boundary", M, S, soc, alu_at_fma=True)),
            ("viterbi_paths (K5)", bound("viterbi_paths", E, keys, valid),
             bound("viterbi_paths", E, keys, valid, alu_at_fma=True)),
        ]))


def compare_posterior(im, pi, T, E, n_seg=32):
    """Every kernel against its plain version on the posterior manager's own
    inputs: K6 and K7 on the whole contig's segment operators (its packed
    windows, f32 T and E), and K5 on the whole contig from the boundary
    states K7 gives, with its two launches' times (``k5_phases``); the six
    window kernels on the boundary vectors and states those give,
    restricted to the first ``n_seg`` segments (the others' plain loops
    over every window would take minutes).  Returns the records of all
    eight kernels, K5's from the whole contig."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    keys, valid, soc = im._wkeys, im._wvalid, im._soc
    prec = im._decode_precision()
    ops, logs = wk.segment_operators(T, E, keys, valid, prec)
    rec6, (_, A_in, Q_end, _), (entry, exit_) = compare_boundary(
        f"posterior path, S = {keys.shape[0]}, M = {T.shape[0]}", pi, ops, logs,
        soc, torch.any(valid, 1), wk.viterbi_ops_cuda(T, E, keys, valid), 5)
    del ops
    sl = slice(0, n_seg)
    k, v = keys[sl].contiguous(), valid[sl].contiguous()
    a, q = A_in[sl].contiguous(), Q_end[sl].contiguous()
    tag = (f"posterior path, first {n_seg} segments: S x L = {tuple(k.shape)}, "
           f"M = {T.shape[0]}, {E.shape[0]} keys, rung {prec!r}")
    rec = compare(tag, T, E, k, v, a, q, prec, 5)
    rec.update(compare_decode(tag, T, E, k, v, a, q, entry[sl].contiguous(),
                              exit_[sl].contiguous(), 5))
    tag = (f"posterior path, whole contig: S x L = {tuple(keys.shape)}, "
           f"M = {T.shape[0]}, {E.shape[0]} keys")
    rec["viterbi_paths"] = compare_k5(tag, T, E, keys, valid, entry, exit_, 5)
    k5_phases(tag, T, E, keys, valid, entry, exit_)
    rec.update(rec6)
    log("kernel comparisons (posterior path): all within tolerance")
    return rec


def posterior_path(workdir, model_json, data):
    """Run posterior through the CLI entry point on one contig and check its
    output; returns (launches, kernel records from compare_posterior)."""
    import torch

    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.ops import window_kernel as wk

    out = os.path.join(workdir, "post.npz")
    intervals = [0.025, 0.5, 0.975]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in wk.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    im = cli.main([
        "posterior", "--device", "cuda", "--map", "--intervals",
        ",".join(map(str, intervals)), model_json, out, data,
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in wk.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    M = len(im.hidden_states) - 1
    S, L = im._wkeys.shape
    log(f"posterior: {wall:.2f} s wall, peak device memory {peak / 1e9:.2f} GB; "
        f"S x L = {(S, L)} ({S * L} windows), M = {M}, "
        f"{im.em_idx.n_keys} keys; kernel launches {launches}")
    want = {"segment_ops": 2, "asc_sweep": 2, "dsc_sweep": 1,
            "dsc_sweep_gamma": 1, "viterbi_ops": 1, "viterbi_paths": 1,
            "boundary_scan": 2, "viterbi_boundary": 1}
    short = {n: launches[n] for n, c in want.items() if launches[n] < c}
    if short:
        raise AssertionError(f"posterior kernels launched too few times: {short}")
    check_posterior_npz(out, data, im)
    pi, T, E = (x.float().contiguous() for x in im.tensors())
    posterior_breakdown(im, pi, T, E)
    records = compare_posterior(im, pi, T, E)
    row_routes(im, np.load(out)[data + "_map"])
    return launches, records


def check_posterior_npz(out, data, im):
    """The posterior's npz against what it must hold: per-contig gammas
    whose columns sum to 1, unnormalized row masses equal to the row spans,
    MAP states in [0, M), quantiles non-decreasing in q."""
    M = len(im.hidden_states) - 1
    z = np.load(out)
    g, sites = z[data], z[data + "_sites"]
    path, qs = z[data + "_map"], z[data + "_quantiles"]
    n_rows = len(sites)
    if g.shape != (M, n_rows) or path.shape != (n_rows,) or qs.shape != (3, n_rows):
        raise AssertionError(f"posterior npz shapes: gamma {g.shape}, map "
                             f"{path.shape}, quantiles {qs.shape}, {n_rows} rows")
    if not (np.all(np.isfinite(g)) and np.all(np.isfinite(qs))):
        raise AssertionError("posterior npz holds non-finite values")
    colerr = float(np.abs(g.sum(0) - 1.0).max())
    if colerr > 1e-4:
        raise AssertionError(f"gamma columns do not sum to 1 (max err {colerr:.2e})")
    mass = im.gammas[0].sum(1)
    spans = sites.astype(np.float64)
    rowerr = float(np.max(np.abs(mass - spans) / spans))
    if rowerr > 1e-3:
        raise AssertionError(
            f"row masses differ from the row spans (max relative {rowerr:.3g})")
    if path.min() < 0 or path.max() >= M:
        raise AssertionError(f"MAP states outside [0, {M}): {path.min()}..{path.max()}")
    if np.any(np.diff(qs, axis=0) < 0):
        raise AssertionError("posterior quantiles decrease in q")
    log(f"  npz: {n_rows} rows; column sums within {colerr:.2e} of 1; row "
        f"masses within {rowerr:.3g} (relative) of the spans (largest span "
        f"{int(spans.max())}); MAP states in [{path.min()}, {path.max()}], "
        f"{np.bincount(path, minlength=M).astype(bool).sum()} distinct; "
        f"median quantiles {np.round(np.median(qs, 1), 4).tolist()}")


def launched(fn):
    """(fn(), {kernel name: launches}) of the kernels fn launched, with every
    count set to 0 just before it."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    for k in wk.KERNELS:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in wk.KERNELS if k.launches}


def _rel(a, b):
    return abs(a - b) / abs(b)


def span_estep(im):
    """Phase 4's span E-step: ``hmm.estep`` (the chunk products, K6 over
    them, the SpanLoglik backward) on the fitted slice manager's own packed
    rows, held against the same manager's window E-step (estep_direct at
    'highest', f32 carries) at the bounds tests/test_torch_estimate.py holds
    the port to JAX with: ll rtol 1e-6, each statistic rtol 1e-4 / atol 1e-6
    of its largest entry.  Where the two log-likelihoods are further apart
    (the window's f32 sweeps drift over many windows), the span's must lie
    within rtol 1e-6 of the f64 evaluation (the window loop in f64,
    ``ll_agreement``'s exact value) and nearer it than the window's; the
    f64 evaluations of the two routes must agree at rtol 1e-12.  Prints the f64
    evaluations of both routes (the span's chunk scan and the window loop),
    the window E-step at the fit's rung, the launches (K6 once, nothing
    else), the chunk and batch counts and the CUDA-event times of the
    chunk products, K6 and the whole E-step."""
    import torch

    from smcpp_tpu_torch.ops import hmm
    from smcpp_tpu_torch.ops import window_kernel as wk

    pi64, T64, E64 = im.tensors()
    pi, T, E = (x.float().contiguous() for x in (pi64, T64, E64))
    spans, keys = im._rows()
    nbits, chunk, budget = im._nbits, im._chunk, im._row_budget()
    (C, L), M = spans.shape, T.shape[0]
    span, got = launched(lambda: hmm.estep(pi, T, E, spans, keys, nbits, chunk, budget))
    if got != {"boundary_scan": 1}:
        raise AssertionError(f"span E-step launches: {got} (want K6 once)")
    args = (pi, T, E, im._wkeys, im._wvalid, im._soc)
    win = wk.estep_direct(*args, precision="highest")
    win_fit = wk.estep_direct(*args, precision=im.precision)
    with torch.no_grad():
        Ms, logs = hmm._all_chunk_products(T64, E64, spans, keys, nbits, chunk, budget)
        ll_s64 = float(hmm._scan_chunks(pi64, Ms, logs, torch.any(spans > 0, 1)).sum())
        del Ms, logs
        ops, lg = wk.segment_ops_plain(T64, E64, im._wkeys, im._wvalid, "highest")
        ll_x = float(wk.contig_boundaries_plain(pi64, ops, lg, im._soc,
                                                torch.any(im._wvalid, 1))[0])
        del ops, lg
    ll_s, ll_w, ll_wf = float(span[0]), float(win[0]), float(win_fit[0])
    d = _rel(ll_s, ll_w)
    log(f"span E-step [slice]: ll span {ll_s!r}, window ('highest') {ll_w!r}, "
        f"window ({im.precision!r}, the fit's rung) {ll_wf!r}; f64: span chunk scan "
        f"{ll_s64!r}, window loop {ll_x!r} (apart {_rel(ll_s64, ll_x):.3e}); span "
        f"against window {d:.3e}; relative distance from the f64 window loop: "
        f"span {_rel(ll_s, ll_x):.3e}, window 'highest' {_rel(ll_w, ll_x):.3e}, "
        f"window {im.precision!r} {_rel(ll_wf, ll_x):.3e}")
    if not np.isfinite(ll_s) or _rel(ll_s64, ll_x) > 1e-12:
        raise AssertionError("span E-step: the log-likelihood is not finite, or the "
                             "two routes' f64 evaluations disagree")
    if d > 1e-6:
        if _rel(ll_s, ll_x) > 1e-6 or _rel(ll_s, ll_x) >= _rel(ll_w, ll_x):
            raise AssertionError(
                f"span E-step: ll {d:.3e} from the window E-step's, and not within "
                "rtol 1e-6 of the f64 evaluation and nearer it than the window's")
        log("span E-step: ll past rtol 1e-6 of the window E-step's, within rtol "
            "1e-6 of the f64 evaluation and nearer it than the window's")
    errs = []
    for name, a, b in zip(("gamma0", "xisum", "gamma_sums"), span[1:], win[1:]):
        a, b = a.double(), b.double()
        atol = 1e-6 * float(b.abs().max())
        bad = (a - b).abs() > atol + 1e-4 * b.abs()
        errs.append(f"{name} {float(((a - b).abs() / (b.abs() + atol)).max()):.3e}")
        if bool(bad.any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(
                f"span E-step {name}: {int(bad.sum())} entries over rtol 1e-4 / "
                f"atol {atol:.3g} of the window E-step's")
    n_chunks = C * L // chunk
    log(f"span E-step [slice]: statistics within rtol 1e-4 / atol 1e-6 of max of "
        f"the window E-step's (largest |d| / (|want| + atol): {', '.join(errs)}); "
        f"{int((im._spans > 0).sum())} rows, C x L = {(C, L)}, nbits {nbits}, "
        f"{n_chunks} chunks of {chunk}, batches of {hmm._batch_size(chunk, M, budget)} "
        f"chunks (products) and {hmm._tape_batch_size(chunk, M, nbits, budget)} "
        f"(the backward), budget {budget / 1e9:.1f} GB; launches {got}")

    def phases():
        with torch.no_grad():
            Ms, logs = hmm._all_chunk_products(T, E, spans, keys, nbits, chunk, budget)
        yield "chunk products"
        table, seg_has = hmm._chunk_layout(spans, chunk)
        wk.contig_boundaries(pi, Ms.view(-1, M, M), logs.view(-1), table, seg_has)
        yield "contig_boundaries (K6)"
        hmm.estep(pi, T, E, spans, keys, nbits, chunk, budget)
        yield "estep (forward and backward)"

    t = phase_times("span E-step [slice]", f"C x L = {(C, L)}, M = {M}, "
                    f"{n_chunks} chunks", phases)
    log(f"span E-step [slice]: the backward (estep less its forward) "
        f"{t['estep (forward and backward)'] - t['chunk products'] - t['contig_boundaries (K6)']:.2f} ms; "
        f"window E-step for comparison: see 'E-step [slice]' above")


def row_phases(label, im, viterbi=True):
    """CUDA-event milliseconds of the row-level decode's phases on the
    manager's packed rows (the row operators with the chunk products, K6,
    ``_chunk_gammas``, the pull) and, with ``viterbi``, the row Viterbi's
    (the f64 row powers, K7, the padding fill); K6's time beside its bound
    on the chunk table."""
    import torch

    from smcpp_tpu_torch.ops import hmm
    from smcpp_tpu_torch.ops import window_kernel as wk

    pi64, T64, E64 = im.tensors()
    pi, T, E = (x.float().contiguous() for x in (pi64, T64, E64))
    spans, keys = im._rows()
    nbits, chunk, budget = im._nbits, im._chunk, im._row_budget()
    (C, L), M = spans.shape, T.shape[0]
    table, seg_has = hmm._chunk_layout(spans, chunk)

    def decode():
        with torch.no_grad():
            Ms, logs = hmm._all_chunk_products(T, E, spans, keys, nbits, chunk, budget)
        yield "row operators + chunk products"
        _, A_in, Q_end, _ = wk.contig_boundaries(pi, Ms.view(-1, M, M), logs.view(-1),
                                                 table, seg_has)
        del Ms
        yield "contig_boundaries (K6)"
        g = hmm.rows_gammas(T, E, spans, keys, A_in, Q_end, nbits, chunk, budget)
        yield "_chunk_gammas"
        g.cpu()
        yield "pull"

    def row_viterbi():
        W = hmm.row_powers(T64, E64, spans, keys, nbits, budget)
        yield "row powers (f64)"
        Wops = W.transpose(1, 2).float().contiguous()
        del W
        rows = np.where(im._spans > 0, np.arange(C * L).reshape(C, L), -1)
        entry, exit_ = wk.viterbi_boundary_states(pi64, Wops, rows)
        yield "viterbi_boundary (K7)"
        hmm._fill_padding(exit_.view(C, L).long(), entry.view(C, L).long(),
                          spans > 0, pi64).cpu()
        yield "fill + pull"

    shape = (f"C x L = {(C, L)}, {int((im._spans > 0).sum())} rows, M = {M}, nbits "
             f"{nbits}, {table.size} chunks of {chunk}")
    t = phase_times(f"row decode [{label}]", shape, decode)
    b6 = scan_bound("boundary_scan", M, table.size, table)
    c, n = wk.boundary_plan(table.shape[1])
    log(f"row decode [{label}]: K6 {t['contig_boundaries (K6)']:.3f} ms / bound "
        f"{b6[0]:.4f} ({b6[1]}), plan c = {c}, n_chunks = {n}")
    if viterbi:
        t.update(phase_times(f"row Viterbi [{label}]", shape, row_viterbi))
        b7 = scan_bound("viterbi_boundary", M, C * L, np.where(im._spans > 0, 0, -1))
        c, n = wk.boundary_plan(L)
        log(f"row Viterbi [{label}]: K7 {t['viterbi_boundary (K7)']:.3f} ms / bound "
            f"{b7[0]:.4f} ({b7[1]}), plan c = {c}, n_chunks = {n}")
    return t


def row_routes(im, win_map):
    """Phase 5's row-level routes on the posterior contig (the manager the
    window posterior built): ``hmm.decode_gammas`` (K6 once, nothing else)
    against the window decode's rows, each row divided by its span, at rtol
    2e-3 / atol 1e-3 (tests/test_decode.py:372-404); the row-level Viterbi
    (``hmm.viterbi_paths``, f64 row powers and K7 once) against the window
    Viterbi's path ``win_map`` on at least 99% of rows (f32 against f64,
    tests/test_decode.py:456-487); K7 on the row operators bit for bit its
    chunked twin; then ``row_phases``."""
    from smcpp_tpu_torch.ops import hmm
    from smcpp_tpu_torch.ops import window_kernel as wk

    pi64, T64, E64 = im.tensors()
    pi, T, E = (x.float().contiguous() for x in (pi64, T64, E64))
    spans, keys = im._rows()
    nbits, chunk, budget = im._nbits, im._chunk, im._row_budget()
    C, L = spans.shape
    span = im._wrow_spans[0].astype(np.float64)[:, None]
    t0 = time.perf_counter()
    g, got = launched(lambda: im._per_input_row(hmm.decode_gammas(
        pi, T, E, spans, keys, nbits, chunk, budget).cpu().numpy())[0])
    t_dec = time.perf_counter() - t0
    if got != {"boundary_scan": 1}:
        raise AssertionError(f"row decode launches: {got} (want K6 once)")
    a, b = g / span, im.gammas[0] / span
    bad = np.abs(a - b) > 1e-3 + 2e-3 * np.abs(b)
    if bad.any() or not np.all(np.isfinite(g)):
        raise AssertionError(f"row decode: {int(bad.sum())} of {bad.size} per-base "
                             "gammas over rtol 2e-3 / atol 1e-3 of the window decode's")
    t0 = time.perf_counter()
    p, got = launched(lambda: hmm.viterbi_paths(
        pi64, T64, E64, spans, keys, nbits, budget)[0].cpu().numpy())
    t_vit = time.perf_counter() - t0
    if got != {"viterbi_boundary": 1}:
        raise AssertionError(f"row Viterbi launches: {got} (want K7 once)")
    p = p[np.cumsum(im._row_reps[0]) - 1]
    n_diff = int((p != win_map).sum())
    if n_diff > 0.01 * len(p):
        raise AssertionError(f"row Viterbi: {n_diff} of {len(p)} rows differ from "
                             "the window Viterbi's (more than 1%)")
    W = hmm.row_powers(T64, E64, spans, keys, nbits, budget).transpose(1, 2)
    W = W.float().contiguous()
    rows = np.where(im._spans > 0, np.arange(C * L).reshape(C, L), -1)
    k7 = wk.viterbi_boundary_cuda(pi64, W, rows)
    twin = wk.viterbi_boundary_states_chunked_plain(pi64, W, rows, wk.boundary_plan(L)[0])
    for name, x, y in zip(("entry", "exit"), k7, twin):
        check_equal(f"viterbi_boundary [row operators] {name} states", x, y)
    del W
    log(f"row routes [posterior contig]: the row decode {t_dec:.2f} s wall "
        f"(largest per-base gamma difference from the window decode's "
        f"{float(np.abs(a - b).max()):.3e}); the row Viterbi {t_vit:.2f} s wall, "
        f"{n_diff} of {len(p)} rows differ from the window Viterbi's; K7 on the "
        f"{int((im._spans > 0).sum())} row operators equals its chunked twin bit "
        "for bit")
    row_phases("posterior contig", im)


# human chromosome 1 (GRCh38), the longest unbinned contig a user decodes
CHR1_BP = 248_956_422


def chr1_posterior(workdir, model_json):
    """Phase 7: one simulated contig of CHR1_BP bases (n = 20, its own seed)
    through ``posterior --device cuda --map --intervals`` with phase 4's
    model.  Its window streams are over the 70% decode gate, so the decode
    must go row-level by the gate alone (no environment override); the
    E-step and the Viterbi stay on windows.  Checks the npz
    (``check_posterior_npz``) and the launches (K3, K6, K1, K2 in the
    E-step, K6 in the row decode, K4, K7, K5 in the Viterbi), prints the
    wall time, the peak device memory and the row decode's phases."""
    import torch

    from smcpp_tpu_torch.commands import main as cli

    if "SMCPP_TPU_ESTREAM_BYTES" in os.environ:
        raise AssertionError("phase 7 must reach the row-level decode by the gate "
                             "alone: unset SMCPP_TPU_ESTREAM_BYTES")
    t0 = time.perf_counter()
    data = simulate(workdir, "chr1", CHR1_BP, SEED + 7)
    log(f"simulated 1 contig x {CHR1_BP} bp, n=20: {time.perf_counter() - t0:.1f} s")
    out = os.path.join(workdir, "chr1.npz")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    im, launches = launched(lambda: cli.main([
        "posterior", "--device", "cuda", "--map", "--intervals", "0.025,0.5,0.975",
        model_json, out, data,
    ]))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    S, L = im._wkeys.shape
    M = len(im.hidden_states) - 1
    need, gate = im._window_stream_bytes(12), im._hbm_budget(0.70)
    log(f"posterior [chr1]: {wall:.2f} s wall, peak device memory {peak / 1e9:.2f} GB; "
        f"S x L = {(S, L)} ({S * L} windows), M = {M}, {im.em_idx.n_keys} keys, "
        f"{int((im._spans > 0).sum())} rows; the window decode needs "
        f"{need / 1e9:.1f} GB against 70% of the card, {gate / 1e9:.1f} GB; "
        f"kernel launches {launches}")
    if not im._use_windows or im._window_decode_fits():
        raise AssertionError("posterior [chr1]: the decode gate did not send the "
                             "decode to the row level")
    want = {"segment_ops": 1, "boundary_scan": 2, "asc_sweep": 1, "dsc_sweep": 1,
            "viterbi_ops": 1, "viterbi_boundary": 1, "viterbi_paths": 1}
    if launches != want:
        raise AssertionError(f"posterior [chr1] launches {launches}, want {want} "
                             "(K6's second launch is the row decode's)")
    check_posterior_npz(out, data, im)
    row_phases("chr1", im, viterbi=False)


def estep_breakdown(label, pi, T, E, keys, valid, soc, precision="default"):
    """Milliseconds of each phase of estep_direct (CUDA events around each
    call, after one warm-up run)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    def phases():
        ops, logs = wk.segment_operators(T, E, keys, valid, precision)
        yield "segment_ops (K3)"
        ll, A_in, Q_end, cvalid = wk.contig_boundaries(
            pi, ops, logs, soc, torch.any(valid, 1))
        yield "contig_boundaries (K6)"
        alphas, a_end = wk.asc_sweep_cuda(T, E, keys, valid, A_in.contiguous(),
                                          precision)
        yield "asc_sweep (K1)"
        u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end.contiguous())
        yield "dsc_sweep (K2)"
        wk.boundary_stats(pi, T, a_end, u, xo, soc, cvalid)
        yield "boundary_stats"

    t = phase_times(f"E-step [{label}]", f"S x L = {tuple(keys.shape)}, M = "
                    f"{T.shape[0]}, {E.shape[0]} keys", phases)
    elt = wk.carry_dtype(precision, torch.float32).itemsize
    log_bounds(f"E-step [{label}]", t, {
        "segment_ops (K3)": k3_bound(E, keys, valid),
        "contig_boundaries (K6)": scan_bound("boundary_scan", T.shape[0],
                                             keys.shape[0], soc),
        "asc_sweep (K1)": bound("asc_sweep", E, keys, valid, elt),
        "dsc_sweep (K2)": bound("dsc_sweep", E, keys, valid, elt),
    })


def c3_throughput():
    "estep_direct at the bench.py C3 shape, median of 3 timed runs."
    import torch

    from smcpp_tpu_torch.data.simulate import synth_contig
    from smcpp_tpu_torch.ops import window_kernel as wk

    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    C, WINDOWS, W, M, n_keys = 22, 2_500_000, 100, 16, 128
    raw = [synth_contig(rng, WINDOWS, n_keys, 3) for _ in range(C)]
    key_id = {(k,): k for k in range(n_keys)}
    keys, valid, soc = wk.pack_windows(raw, key_id, seg_target=8192,
                                       max_seg_len=16384)
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    pi_d, T_d, E_d = wk.from_numpy(pi, T, E, "cuda")
    kd = torch.as_tensor(keys, device="cuda")
    vd = torch.as_tensor(valid, device="cuda")
    out = wk.estep_direct(pi_d, T_d, E_d, kd, vd, soc)
    if not np.isfinite(float(out[0])):
        raise AssertionError("C3 E-step log-likelihood is not finite")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wk.estep_direct(pi_d, T_d, E_d, kd, vd, soc)
        float(out[0])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    estep_breakdown("C3", pi_d, T_d, E_d, kd, vd, soc)
    ops, logs = wk.segment_operators(T_d, E_d, kd, vd)
    compare_boundary("C3", pi_d, ops, logs, soc, torch.any(vd, 1), None, 5)
    del ops, logs
    log(f"C3 E-step: S x L = {keys.shape}, {dt * 1e3:.1f} ms (median of 3), "
        f"{C * WINDOWS * W / dt / 1e9:.2f} Gbp/s, peak mem "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"SM clock, max SM clock, power draw right after the C3 runs: {smi}")
    for prec in ("highest", "default"):
        check_k3(f"C3 S x L = {keys.shape} {prec}", T_d, E_d, kd, vd, prec)
        ll_agreement("C3", pi_d, T_d, E_d, kd, vd, soc, prec)
        ops, logs = wk.segment_operators(T_d, E_d, kd, vd, prec)
        _, A_in, Q_end, _ = wk.contig_boundaries(pi_d, ops, logs, soc, torch.any(vd, 1))
        del ops, logs
        tag = f"C3 S x L = {keys.shape} {prec}"
        _, al, al_p = check_k1(tag, T_d, E_d, kd, vd, A_in.contiguous(), prec)
        k1_estep_agreement(tag, T_d, E_d, kd, vd, Q_end.contiguous(), al, al_p)
        del al, al_p


def main():
    card()
    import torch

    build()
    compare_small()
    with tempfile.TemporaryDirectory() as workdir:
        launches, records, model_json, files = main_path(workdir)
        post_launches, post_records = posterior_path(workdir, model_json, files[0])
        c3_throughput()
        chr1_posterior(workdir, model_json)
    from smcpp_tpu_torch.ops import window_kernel as wk

    # K1-K3 and K6 from the estimate path, K2g, K4, K5 and K7 from the
    # posterior path
    for name in ("dsc_sweep_gamma", "viterbi_ops", "viterbi_paths",
                 "viterbi_boundary"):
        launches[name] = post_launches[name]
        records[name] = post_records[name]
    kernels = []
    for k in wk.KERNELS:
        err, ms, plain_ms, bound_ms, bound_by = records[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
