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
   against its window E-step (``span_estep``); then the f32 M-step's gate
   on the fitted manager and one coarse Q batch timed in f64 and in f32
   (``mstep_crossover``);
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
   row decode's phases;
8. two populations (``twopop_path``): joint data (n1 = 10 with the
   distinguished pair, n2 = 8, the widths of benchmarks/twopop_decode.py)
   from a known joint model (split 0.4, N0 = 2e4, theta = rho = 1e-3; the
   port's ``simulate_joint_contig``, seeded), with the true marginal fits as
   JSON: one joint contig of 100 Mbp for the posterior, and for the split
   two joint contigs of 50 Mbp (the first is the posterior contig's first
   half) and one pop-2 contig of 50 Mbp from the truth's splice;
   ``split --device cuda`` through the CLI (the split within +-25% of the
   truth; ``Q_split_batch`` on 16 candidates against the same objects on
   CPU tensors at rtol 1e-9; its wall time and objective evaluations), then
   ``posterior --device cuda --map --intervals`` at M = 32 on the 100 Mbp
   joint contig with the split's model: the npz checked as in phase 5, K3,
   K6, K1, K2, K2g, K4, K7 and K5 launched on the joint emission table,
   the uncached tensors() calls of the split and the posterior, the
   manager's tensors() through the traced joint CSFS (ops/jcsfs_traced.py)
   timed uncached beside the eager host route and held to the same route
   on CPU tensors (rtol 1e-9 / atol 1e-14) and to the eager route
   (``twopop_tensors``), the decode's and the Viterbi's phases, every
   kernel against its plain
   version on the two-population manager's own inputs (as in phase 5), and
   the window decode against the f64 span oracle on a probe of 4000 rows
   within 5e-2 (``twopop_probe``).  Alone:
   ``python3 -c 'import chip_smoke as c, tempfile; c.card(); c.build();
   c.twopop_path(tempfile.mkdtemp())'``;
9. the user's front end (``frontend_path``): 2 contigs x 50 Mbp from phase
   4's truth (theta = rho = 5e-4, 18 undistinguished haplotypes, seeds of
   their own) written as a VCF of 10 samples (``write_vcf``: s0 the
   distinguished pair), converted by ``vcf2smc`` through the CLI (records
   and Mbp per second; the rows read back must be the simulated rows with
   the fully derived sites folded: ``check_vcf2smc``), ``chunk -w 5000000
   4`` on the first, ``cv --device cuda --folds 2 --rp-values 4,6
   --em-iterations 1`` on both (K3, K6, K1 and K2 launched, each fold's best
   model and their aggregate checked, the device memory at the end of each
   fold printed), the same ``cv`` again (the resume: no launch, no fit, the
   same model.final.json), then ``simulate --engine hmm`` from the
   aggregate (n = 10, 1 Mbp).  Alone: ``python3 -c 'import chip_smoke as c,
   tempfile; c.card(); c.build(); c.frontend_path(tempfile.mkdtemp())'``;
10. several ranks (``multirank_path``, smcpp_tpu_torch/parallel/): child
   processes through the CLI, each with ``--device cuda`` and its
   ``--process-id``, NCCL with a card a rank where the machine has two, else
   two ranks sharing cuda:0 under gloo (``SMCPP_TPU_DIST_BACKEND=gloo``, each
   with half the decode gate's budget in ``SMCPP_TPU_ESTREAM_BYTES``): (a)
   phase 4's ``estimate`` host-local, one contig a rank (both ranks'
   model.final.json equal byte for byte, y within rtol 1e-4 / atol 1e-6 of
   phase 4's, K3, K6, K1, K2 launched in each rank), (b) the same with
   ``--replicated-data`` (byte for byte (a)'s fit), (c) phase 5's
   ``posterior`` with ``--replicated-data``, the contig's segments split
   over the ranks (rank 0's npz against phase 5's; every posterior kernel
   launched in each rank); each rank's wall time, peak device memory and
   the CUDA-event times of its collectives and sharded passes
   (``rank_child``).  Alone: ``python3 -c 'import chip_smoke as c,
   tempfile; c.card(); c.build(); c.multirank_path(tempfile.mkdtemp())'``;
11. the over-budget posterior (``over_budget_posterior``): three contigs of
   the lengths of GRCh38's chromosomes 1, 2 and 3 (689.4 Mbp, n = 20, seeds
   of their own) through ``posterior --device cuda --map --intervals`` with
   phase 4's model, at the defaults, with no ``SMCPP_TPU_ESTREAM_BYTES``:
   the card's own budget turns on alpha remat in the E-step (K1's snapshot
   mode, then K8 remat_sweep: each block recomputed from its snapshot in
   shared memory and descended, one launch a pass) and the blocked Viterbi
   (K5's blocked forward and backtrace), and the decode goes row level; the gate figures,
   the manager's log line, the launches and every file's npz are checked;
   the wall time, the peak device memory and the routes' phases printed
   (``over_budget_phases``); on the manager's first 32 segments each new
   kernel against its plain version and the remat E-step against the
   stored-stream one (``compare_remat``); the routes against the stored
   ones in time on 6104 segments and, for K5, on every segment
   (``remat_against_stored``).  Alone: ``python3 -c 'import chip_smoke as
   c, tempfile; c.card(); c.build(); c.over_budget_posterior(
   tempfile.mkdtemp(), "MODEL.json")'`` with a fitted model.final.json.
12. the wide sample (``wide_sample``): 2 contigs x 100 Mbp at n = 50
   undistinguished lineages from phase 4's truth (seeds 120, 121), where the
   f32 M-step's gate opens ((n+1) n K past 50,000): ``estimate
   --em-iterations 2 --device cuda`` through the CLI at the defaults, then
   again with the gate closed by hand (``wide_fit``): per fit the gate's
   work and decision, per EM iteration the E-step and M-step seconds, the Q
   batches and candidates (coarse and exact apart, and how many ran as the
   f32 program) and the M-step's peak device memory, the final
   log-likelihood; both model.final.json finite, the f32 programs run
   (``manager.FAST_PROGRAMS``' counts) in the first fit and in no other;
   on the first fit's manager JAX's rule for an f32 batch
   (``qbatch_rule``: the error bound on a coarse batch of the optimizer's
   prefetch shape, 24 rows a knot, and on a rho batch of 12, the same
   argmax on the rho batch, each coarse grid's f32 pick no further below
   its best f64 value than the batch's largest error), then one coarse
   batch timed in f64 and in f32
   (``mstep_crossover``, as at the end of phase 4 on its n = 20 manager,
   where the gate is closed and is opened by hand); the two fits'
   log-likelihoods within 1e-4 relative (the EM's ftol, as
   tests/test_torch_fast_mstep.py holds the CPU fits) and the largest |y|
   difference.  Alone: ``python3 -c 'import
   chip_smoke as c, tempfile; c.card(); c.build();
   c.wide_sample(tempfile.mkdtemp())'``.

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

K4 applies each run of equal keys whole: a run shorter than
``VITERBI_RUN_MIN`` windows a window at a time, a longer one as a binary
power of its operator.  On every input set it must equal its plain twin of
that run plan (``viterbi_ops_runs_plain``) bit for bit; its bound prices
the products the run plan needs (``viterbi_ops_counts``), and the window
walk's bound (one product a valid window) is printed beside it at the
posterior's shape.

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
from phase 5's posterior, K1's snapshot mode, K8 and K5's blocked modes
from phase 11's; errors, times and bounds from the comparison on that path's own
inputs, for K5 the whole posterior contig, for the over-budget modes phase
11's first 32 segments, each time one pass's launches of the kernel); the
last line is ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no CUDA device is present.
"""

import contextlib
import gzip
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
CARD = "card not read"  # nvidia-smi's name and power limit (``card``)

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
    global CARD
    CARD = smi
    return smi


def bound(name, E, keys, valid, elt=4, cuda_cores=False, alu_at_fma=False, block=None,
          walk=False):
    """(bound_ms, bound_by) of one launch of kernel ``name`` on these inputs:
    the larger of its operations over the peak rate of their pipe (and all
    of them over the issue rate) and the bytes it must move (each input read
    once, each output written once) over the memory rate.  ``elt`` is the
    byte width of the alpha stream; ``alu_at_fma`` gives the earlier model:
    a max or a select one operation at the FMA rate, no issue limit, and
    K5's candidate an add, a max and a select (no compare); ``walk`` prices
    K4 at one operator product a valid window, its earlier form.
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
      K4 viterbi_ops      M^3 add (FMA pipe) and M^3 max (ALU pipe) an
                          operator product, the products of the run plan
                          (window_kernel.viterbi_ops_counts: one a window
                          of a run shorter than VITERBI_RUN_MIN, bitlen(r)
                          - 1 + popcount(r) for a longer run of r); (S, M,
                          M) out
      K5 viterbi_paths    per candidate (M^2): an add (FMA pipe), then a
                          compare, a select of the score and a select of
                          the index (ALU pipe: the first-index argmax
                          compiles to FSETP, FSEL and SEL); (S, L) int32
                          path out

    The over-budget routes, per remat E-step or blocked Viterbi (``block``
    windows a block, nb = L / block):

      K1 asc_sweep_remat   the snapshot sweep: K1's M^2 f64 FMA per valid
                           window; keys, valid and A_in read, the (nb, S,
                           M) snapshots and alpha_end written
      K8 remat_sweep       the function's work, whatever K8 recomputes: one
                           recompute sweep (M^2 f64 FMA per valid window on
                           the tensor cores) beside the descent (K2's 2 M^2
                           f32 FMA and M^2 f64 add); keys, valid, the
                           snapshots and Q_end read, u_start, xisum and
                           gsum written
      K5 viterbi_fwd_blocked  two forward sweeps of K5's candidates; keys and
                           valid read twice, the (nb, S, M) f32 snapshots
                           written and read, the (S, L, M) int8
                           backpointers written
      K5 viterbi_back_blocked  the backpointers read, the (S, L) int32 path
                           written
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
        from smcpp_tpu_torch.ops import window_kernel as wk

        products = nv if walk else wk.viterbi_ops_counts(keys, valid)[0]
        f32, alu, b = products * M**3, products * M**3, b + 4 * S * M * M
    elif name == "viterbi_paths":
        f32, b = nv * M * M, b + 4 * W + 8 * S
        alu = (2 if alu_at_fma else 3) * nv * M * M
    elif name == "asc_sweep_remat":
        snaps = (W // block) * M * elt  # (nb, S, M) written
        return _roofline(0, 0, b + snaps + 12 * S * M, nv * M * M)
    elif name == "remat_sweep":
        f32, f64 = 2 * nv * M * M, nv * M * M
        b += (W // block) * M * elt + 8 * S * M + 8 * (M * M + n_keys * M)
        return _roofline(f32, f64, b, nv * M * M)
    elif name == "viterbi_fwd_blocked":
        f32, alu = 2 * nv * M * M, 2 * 3 * nv * M * M
        b = 2 * b + 2 * 4 * (W // block) * M + W * M + 8 * S
    elif name == "viterbi_back_blocked":
        f32, b = 0, W * M + 4 * W + 8 * S
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
    """K4, K5 and K7 are exact (adds and maxima): the kernel must equal its
    plain version (K4's: the twin of its run plan)."""
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
                     wk.viterbi_ops_runs_plain(T, E, keys, valid))
    t4 = cuda_ms(lambda: wk.viterbi_ops_cuda(T, E, keys, valid), reps)
    t4p = cuda_ms(lambda: wk.viterbi_ops_runs_plain(T, E, keys, valid), 1)
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


def slice_truth():
    "The slice's truth: knots 0.01, 0.1, 1, 5 (piecewise), N0 = 1e4."
    from smcpp_tpu_torch.models.model import SMCModel

    truth = SMCModel([0.01, 0.1, 1.0, 5.0], 1e4, "piecewise")
    truth.y[:] = np.log([1.0, 0.3, 1.0, 2.0])
    return truth


def simulate(workdir, name, L_bp, seed, n=20):
    """One contig of L_bp bases, n = 20 haplotypes, from the slice's truth
    (the port's data/simulate.py, theta = rho = 2.5e-4); returns its path."""
    from smcpp_tpu_torch.data.simulate import write_simulated

    fn = os.path.join(workdir, f"{name}.smc.gz")
    write_simulated(fn, slice_truth(), 2.5e-4, 2.5e-4, L=L_bp, n=n, seed=seed,
                    pid="pop1")
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
    ll = analysis.loglik()
    log(f"  final loglik {ll:.6f}, rho {d['rho']:.6g}, "
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
    mstep_crossover(f"phase 4 (n = {n})", im)
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
            ("viterbi_ops (K4) as the window walk", bound("viterbi_ops", E, keys, valid,
                                                          walk=True),
             bound("viterbi_ops", E, keys, valid, alu_at_fma=True, walk=True)),
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
    out = os.path.join(workdir, "post.npz")
    im, launches = cli_posterior("posterior", out, model_json, data)
    pi, T, E = (x.float().contiguous() for x in im.tensors())
    posterior_breakdown(im, pi, T, E)
    records = compare_posterior(im, pi, T, E)
    row_routes(im, np.load(out)[data + "_map"])
    return launches, records


def cli_posterior(label, out, model_json, data):
    """``posterior --device cuda --map --intervals 0.025,0.5,0.975`` through
    the CLI entry point on one contig, with every launch count set to 0 just
    before it; prints the wall time and the peak device memory, checks that
    the window E-step, decode and Viterbi launched every kernel and checks
    the npz (``check_posterior_npz``).  Returns (manager, launches)."""
    import torch

    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.ops import window_kernel as wk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in wk.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    im = cli.main([
        "posterior", "--device", "cuda", "--map", "--intervals",
        "0.025,0.5,0.975", model_json, out, data,
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in wk.KERNELS}
    peak = torch.cuda.max_memory_allocated()

    M = len(im.hidden_states) - 1
    S, L = im._wkeys.shape
    log(f"{label}: {wall:.2f} s wall, peak device memory {peak / 1e9:.2f} GB; "
        f"S x L = {(S, L)} ({S * L} windows), M = {M}, "
        f"{im.em_idx.n_keys} keys, {int((im._spans > 0).sum())} rows; "
        f"kernel launches {launches}")
    want = {"segment_ops": 2, "asc_sweep": 2, "dsc_sweep": 1,
            "dsc_sweep_gamma": 1, "viterbi_ops": 1, "viterbi_paths": 1,
            "boundary_scan": 2, "viterbi_boundary": 1}
    short = {n: launches[n] for n, c in want.items() if launches[n] < c}
    if short:
        raise AssertionError(f"{label} kernels launched too few times: {short}")
    check_posterior_npz(out, data, im)
    return im, launches


def check_posterior_npz(out, data, im, i=0):
    """The posterior's npz against what it must hold for ``data``, the
    ``i``-th file of the command: per-contig gammas whose columns sum to 1,
    unnormalized row masses equal to the row spans, MAP states in [0, M),
    quantiles non-decreasing in q."""
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
    mass = im.gammas[i].sum(1)
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


# Phase 11, the over-budget posterior: contigs of the lengths of GRCh38's
# chromosomes 1, 2 and 3, 689.4 Mbp in one manager
GENOME_BP = (248_956_422, 242_193_529, 198_295_559)
REMAT_SEGMENTS = 6104  # the 100 Mbp contig's segment count (phase 5)


class _Records(logging.Handler):
    "The messages one logger emits while it is attached."

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def over_budget_posterior(workdir, model_json):
    """Phase 11: three simulated contigs of chr1's, chr2's and chr3's lengths
    (n = 20, seeds of their own) through ``posterior --device cuda --map
    --intervals`` with phase 4's model, at the defaults (M = 32, every base a
    window), with no SMCPP_TPU_ESTREAM_BYTES: the card's own budget (37.5% of
    its memory) turns on both over-budget routes.  Checks that the cost
    model picked windows, the gate figures (alpha stream over the budget:
    alpha remat at remat_block_size(L); the decode over 70% of the card: row
    level; the backpointers over the budget: the blocked Viterbi), the
    manager's log line, the launches (K3, K6, K1 snapshot, K8 remat_sweep
    once; K6 in the row decode; K4, K7, K5 blocked forward and backtrace;
    no whole-stream K1, K2, K2g or K5) and every file's npz; prints the wall
    time, the peak device memory and the phases of the remat E-step and
    the blocked Viterbi (``over_budget_phases``).  Then on the manager's
    first 32 segments each new kernel against its plain version and the
    remat E-step against the stored-stream one (``compare_remat``), and the
    two routes against the stored ones in time on its first REMAT_SEGMENTS
    segments and, for K5, on every segment (``remat_against_stored``).
    Returns (launches, kernel records)."""
    import torch

    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.ops import window_kernel as wk

    if "SMCPP_TPU_ESTREAM_BYTES" in os.environ:
        raise AssertionError("phase 11 must reach the over-budget routes on the card's "
                             "own budget: unset SMCPP_TPU_ESTREAM_BYTES")
    t0 = time.perf_counter()
    data = [simulate(workdir, f"chr{i + 1}", bp, SEED + 11 + i)
            for i, bp in enumerate(GENOME_BP)]
    log(f"simulated 3 contigs of {', '.join(map(str, GENOME_BP))} bp "
        f"({sum(GENOME_BP) / 1e6:.1f} Mbp), n=20: {time.perf_counter() - t0:.1f} s")
    out = os.path.join(workdir, "genome.npz")
    rec = _Records()
    mlog = logging.getLogger("smcpp_tpu_torch.inference.manager")
    level = mlog.level
    mlog.addHandler(rec)
    mlog.setLevel(logging.INFO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        im, launches = launched(lambda: cli.main([*POSTERIOR, model_json, out, *data]))
    finally:
        mlog.removeHandler(rec)
        mlog.setLevel(level)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    S, L = im._wkeys.shape
    M = len(im.hidden_states) - 1
    B = wk.remat_block_size(L)
    n_rows = int((im._spans > 0).sum())
    span_cost = n_rows * 2 * im._nbits * 30
    ab = wk.carry_dtype(im.precision, torch.float32).itemsize
    budget = im._hbm_budget()
    gates = {
        "alpha stream": (im._window_stream_bytes(ab), budget),
        "decode (12 B)": (im._window_stream_bytes(12), im._hbm_budget(0.70)),
        "backpointers (2 B)": (im._window_stream_bytes(2), budget),
        "blocked Viterbi": (im._window_stream_bytes((B + 4.0 * (L // B)) / L), budget),
    }
    log(f"posterior [genome]: {wall:.2f} s wall, peak device memory {peak / 1e9:.2f} GB; "
        f"S x L = {(S, L)} ({S * L} windows), M = {M}, {im.em_idx.n_keys} keys, "
        f"{n_rows} rows, nbits {im._nbits}; cost model: windows {im._total_bases:.4g} "
        f"against span {span_cost:.4g} ({span_cost / im._total_bases:.3f}x); rung "
        f"{im.precision!r}, alpha carry {ab} B; remat block {im._alpha_remat}; snapshots "
        f"{S * (L // B) * M * ab / 1e9:.3f} GB (E-step), {S * (L // B) * M * 4 / 1e9:.3f} "
        f"GB (Viterbi); gates, need / against GB: " + ", ".join(
            f"{n} {a / 1e9:.2f} / {b / 1e9:.2f}" for n, (a, b) in gates.items()))
    log(f"  kernel launches {launches}; manager log: "
        + " | ".join(m for m in rec.messages if "remat" in m or "block" in m))
    if not im._use_windows:
        raise AssertionError("posterior [genome]: the cost model did not pick windows")
    if im._alpha_remat != B or not any(f"alpha remat ON (block {B})" in m
                                       for m in rec.messages):
        raise AssertionError(f"posterior [genome]: alpha remat is not on at block {B} "
                             f"({im._alpha_remat})")
    if im._window_decode_fits() or im._window_viterbi_fits():
        raise AssertionError("posterior [genome]: a window gate did not close")
    if gates["blocked Viterbi"][0] > budget:
        raise AssertionError("posterior [genome]: the blocked Viterbi is over budget too")
    nb = L // B
    want = {"segment_ops": 1, "boundary_scan": 2, "asc_sweep_remat": 1,
            "remat_sweep": 1, "viterbi_ops": 1, "viterbi_boundary": 1,
            "viterbi_fwd_blocked": 1 + nb, "viterbi_back_blocked": nb}
    if launches != want:
        raise AssertionError(f"posterior [genome] launches {launches}, want {want} "
                             "(K6's second launch is the row decode's)")
    for i, d in enumerate(data):
        check_posterior_npz(out, d, im, i)
    pi, T, E = (x.float().contiguous() for x in im.tensors())
    entry, exit_ = over_budget_phases(im, pi, T, E)
    records = compare_remat(im, pi, T, E, entry, exit_)
    remat_against_stored(im, pi, T, E, entry, exit_)
    return launches, records


def over_budget_phases(im, pi, T, E):
    """CUDA-event milliseconds of the phases of the manager's remat E-step
    (K3, K6, K1 snapshot, K8, ``boundary_stats``), with K8's launch plan
    (registers, spills, residency), and of its blocked Viterbi (K4, K7, K5's snapshot
    forward, the blocks' forward and backtrace summed), each beside its
    bound.  Returns K7's (seg_entry, seg_exit)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    keys, valid, soc = im._wkeys, im._wvalid, im._soc
    prec, B = im.precision, im._alpha_remat
    S, L = keys.shape
    shape = f"S x L = {(S, L)}, M = {T.shape[0]}, {E.shape[0]} keys, block {B}"
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def timed(t, name, fn):
        a, b = ev(), ev()
        a.record()
        out = fn()
        b.record()
        t.setdefault(name, []).append((a, b))
        return out

    def total(t):
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in v) for n, v in t.items()}

    t = {}
    ops, logs = timed(t, "segment_ops (K3)",
                      lambda: wk.segment_operators(T, E, keys, valid, prec))
    _, A_in, Q_end, cvalid = timed(t, "contig_boundaries (K6)", lambda: wk.contig_boundaries(
        pi, ops, logs, soc, torch.any(valid, 1)))
    del ops
    r = wk.AlphaRemat(T, E, keys, valid, A_in.contiguous(), Q_end.contiguous(), prec, B)
    timed(t, "asc_sweep_remat snapshots (K1)", r.snap)
    timed(t, "remat_sweep (K8)", r.sweep)
    a_end, u, xo, _ = timed(t, "finish", r.finish)
    timed(t, "boundary_stats", lambda: wk.boundary_stats(pi, T, a_end, u, xo, soc, cvalid))
    del r
    te = total(t)
    log(f"remat E-step breakdown [{shape}]: total {sum(te.values()):.2f} ms; "
        + ", ".join(f"{n} {v:.2f}" for n, v in te.items()))
    elt = wk.carry_dtype(prec, torch.float32).itemsize
    M = T.shape[0]
    log_bounds("remat E-step", te, {
        "segment_ops (K3)": k3_bound(E, keys, valid),
        "contig_boundaries (K6)": scan_bound("boundary_scan", M, S, soc),
        "asc_sweep_remat snapshots (K1)": bound("asc_sweep_remat", E, keys, valid, elt,
                                                block=B),
        "remat_sweep (K8)": bound("remat_sweep", E, keys, valid, elt, block=B),
    })
    log(f"  remat_sweep (K8) plan: {wk.remat_plan(S, L, M, E.shape[0], elt == 2, B)}; "
        f"on the card: {wk.remat_sweep_plan(S, M, E.shape[0], elt == 2)}")

    t = {}
    W = timed(t, "viterbi_ops (K4)", lambda: wk.viterbi_ops_cuda(T, E, keys, valid))
    entry, exit_ = timed(t, "viterbi_boundary (K7)",
                         lambda: wk.viterbi_boundary_states(pi, W, soc))
    del W
    k5 = wk.ViterbiPathsBlocked(T, E, keys, valid, entry, exit_, B)
    timed(t, "viterbi_fwd_blocked snapshots (K5)", k5.fwd_snap)
    for b in range(k5.n_blocks - 1, -1, -1):
        timed(t, "viterbi_fwd_blocked blocks (K5)", lambda: k5.fwd_block(b))
        timed(t, "viterbi_back_blocked (K5)", lambda: k5.back_block(b))
    del k5
    tv = total(t)
    log(f"blocked Viterbi breakdown [{shape}]: total {sum(tv.values()):.2f} ms; "
        + ", ".join(f"{n} {v:.2f}" for n, v in tv.items()))
    kf = tv["viterbi_fwd_blocked snapshots (K5)"] + tv["viterbi_fwd_blocked blocks (K5)"]
    bf = bound("viterbi_fwd_blocked", E, keys, valid, block=B)
    bb = bound("viterbi_back_blocked", E, keys, valid, block=B)
    log_bounds("blocked Viterbi", tv, {
        "viterbi_ops (K4)": bound("viterbi_ops", E, keys, valid),
        "viterbi_boundary (K7)": scan_bound("viterbi_boundary", M, S, soc),
        "viterbi_back_blocked (K5)": bb,
    })
    log(f"  viterbi_fwd_blocked (K5, both modes) {kf:.3f} ms / bound {bf[0]:.4f} ({bf[1]})")
    return entry, exit_


def compare_remat(im, pi, T, E, entry, exit_, n_seg=32):
    """The over-budget kernels against their plain versions on the manager's
    first ``n_seg`` segments, at its remat block, from the boundary vectors
    K3 and K6 give and K7's states, at both rungs ('default', the manager's,
    and 'highest'): K1's snapshots equal K1's whole stream at the block ends
    bit for bit, and the plain forward's (f64 sums: ``k1_plain``) at K1's
    tolerances, the differing entries counted; the remat pass (K1 snapshot,
    then K8) against the plain remat pass (``stats_pass_remat_plain``, f64
    sums) at K2's tolerances (rtol 1e-5 at 'highest', 1e-3 at 'default'),
    or, where that f32-summed pass has drifted past them at 'highest' (as in
    ``check_k1``), no farther than it from the exact pass (f64 throughout),
    with the stored route's distance printed beside; two passes
    bit-identical; at the manager's rung the remat E-step
    against the stored-stream E-step on the same segments (ll rtol 1e-6,
    statistics rtol 1e-2 / atol 1e-6: tests/test_decode.py's); K5 blocked
    equal to K5 and to ``viterbi_paths_plain(block=)`` bit for bit.  Returns
    {name: (max abs err, ms, plain ms, bound ms, bound by)} of the four
    kernels, each ms one E-step's or Viterbi's launches of it, at the
    manager's rung."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    B = im._alpha_remat
    sl = slice(0, n_seg)
    keys, valid = im._wkeys[sl].contiguous(), im._wvalid[sl].contiguous()
    soc = np.arange(n_seg)[None]  # the first segments are the first contig's
    S, L = keys.shape
    found = {}
    for prec in dict.fromkeys((im.precision, "highest", "default")):
        ops, logs = wk.segment_operators(T, E, keys, valid, prec)
        _, A_in, Q_end, _ = wk.contig_boundaries(pi, ops, logs, soc, torch.any(valid, 1))
        A_in, Q_end = A_in.contiguous(), Q_end.contiguous()
        cdt = wk.carry_dtype(prec, torch.float32)
        tag = (f"over-budget path, first {n_seg} segments: S x L = {(S, L)}, M = "
               f"{T.shape[0]}, {E.shape[0]} keys, rung {prec!r}, block {B}")
        s_tol = BF16_ULP if cdt == torch.bfloat16 else HIGHEST_RTOL
        rtol = DEFAULT_RTOL if prec == "default" else HIGHEST_RTOL

        # K1's snapshot mode
        r = wk.AlphaRemat(T, E, keys, valid, A_in, Q_end, prec, B)
        r.snap()
        al, ae = wk.asc_sweep_cuda(T, E, keys, valid, A_in, prec)
        want = torch.cat([A_in.to(cdt)[None], al[:, B - 1:L - 1:B].transpose(0, 1)])
        if not (torch.equal(r.snaps, want) and torch.equal(r.alpha_end, ae)):
            raise AssertionError(f"asc_sweep_remat [{tag}]: snapshots differ from K1's "
                                 "stream")
        t0 = time.perf_counter()
        al_p, ae_p = k1_plain(T, E, keys, valid, A_in, prec)
        torch.cuda.synchronize()
        k1p = (time.perf_counter() - t0) * 1e3
        snaps_p = torch.cat([A_in.to(cdt)[None], al_p[:, B - 1:L - 1:B].transpose(0, 1)])
        del al, al_p
        e1 = check_close(f"asc_sweep_remat [{tag}] snapshots", r.snaps, snaps_p, s_tol,
                         1e-7)
        check_close(f"asc_sweep_remat [{tag}] alpha_end", r.alpha_end, ae_p,
                    HIGHEST_RTOL, 1e-7)
        n_diff = int((r.snaps != snaps_p).sum()) + int((r.alpha_end != ae_p).sum())
        log(f"asc_sweep_remat [{tag}]: snapshots bit for bit K1's stream; {n_diff} of "
            f"{r.snaps.numel() + r.alpha_end.numel()} entries differ from the plain "
            "version's bits")

        # K8 against the plain remat pass
        r.sweep()
        got = r.finish()
        again = wk.stats_pass_remat_cuda(T, E, keys, valid, A_in, Q_end, prec, B)
        for name, g, a in zip(("alpha_end", "u_start", "xo", "gsum"), got, again):
            check_equal(f"remat_sweep [{tag}] {name}, two passes", g, a)
        t0 = time.perf_counter()
        want = wk.stats_pass_remat_plain(T, E, keys, valid, A_in, Q_end, prec, B,
                                         sum_dtype=torch.float64)
        torch.cuda.synchronize()
        k8p = (time.perf_counter() - t0) * 1e3
        names = ("alpha_end", "u_start", "xo", "gsum")
        e2, rel, missed = 0.0, {}, {}
        for name, g, w, atol in zip(names, got, want, (1e-7, 1e-7, 1e-8, 1e-8)):
            try:
                err = check_close(f"remat stats_pass [{tag}] {name}", g, w, rtol,
                                  atol * float(w.abs().max()) if name in ("xo", "gsum")
                                  else atol)
            except AssertionError as miss:
                if cdt == torch.bfloat16 or name == "alpha_end":
                    raise
                missed[name] = miss
                err = float((g.double() - w.double()).abs().max())
            rel[name] = _rel_dist(g, w)
            if name != "alpha_end":
                e2 = max(e2, err)
        nv = float(valid.sum())
        if abs(float(got[3].sum()) - nv) > 1e-6 * nv:
            raise AssertionError(f"remat stats_pass [{tag}]: sum(gsum) != valid windows")
        vs = ""
        if missed:
            # the plain pass sums T u in f32 (torch's order): over a near-identity T
            # and 16384 windows its rounding accumulates (check_k1's case), so K8
            # must lie no farther than it from the exact pass (f64 throughout);
            # the stored route's K2 (an f32 FMA chain) is measured beside them
            exact = wk.stats_pass_remat_plain(T.double(), E.double(), keys, valid,
                                              A_in.double(), Q_end.double(), "highest", B)
            stored = wk.stats_pass(T, E, keys, valid, A_in, Q_end, precision=prec)
            dist = {}
            for i, name in enumerate(names):
                if name not in missed:
                    continue
                d = [_rel_dist(y[i], exact[i]) for y in (got, want, stored)]
                dist[name] = d
                if d[0] > d[1]:
                    raise AssertionError(
                        f"{missed[name]}; and K8 lies farther from the exact pass "
                        f"({d[0]:.3e}) than the plain pass ({d[1]:.3e})") from missed[name]
            vs = ("; past tolerance of the plain pass in " + ", ".join(missed)
                  + ", and nearer the exact pass (f64 throughout; max relative "
                  "distance K8 / plain pass / stored K1 + K2: " + ", ".join(
                      f"{n} {d[0]:.3e} / {d[1]:.3e} / {d[2]:.3e}" for n, d in dist.items())
                  + ")")
        log(f"remat_sweep [{tag}]: two passes bit for bit; against the plain remat pass "
            "(f64 per-key sums), largest |got - want| / |want|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + vs)
        found[prec] = (e1, e2, k1p, k8p, A_in, Q_end)

    # the remat E-step against the stored-stream E-step, at the manager's rung
    prec = im.precision
    tag = (f"over-budget path, first {n_seg} segments: S x L = {(S, L)}, M = "
           f"{T.shape[0]}, {E.shape[0]} keys, rung {prec!r}, block {B}")
    ests = [wk.estep_direct(pi, T, E, keys, valid, soc, precision=prec, alpha_remat=a)
            for a in (B, None)]
    dll = _rel(float(ests[0][0]), float(ests[1][0]))
    if dll > 1e-6:
        raise AssertionError(f"remat E-step [{tag}]: ll {dll:.3e} from the stored stream's")
    dst = []
    for name, a, b in zip(("pi-stat", "xisum", "gamma_sums"), ests[0][1:], ests[1][1:]):
        check_close(f"remat E-step [{tag}] {name}", a, b, 1e-2, 1e-6)
        dst.append(float(((a - b).abs() / b.abs().clamp(min=1e-300)).max()))
    log(f"remat E-step [{tag}]: ll {dll:.3e} from the stored stream's (relative); "
        f"statistics within {max(dst):.3e} (relative; bf16 snapshots against the "
        "bf16 stream)")

    # K5 blocked
    e_, x_ = entry[sl].contiguous(), exit_[sl].contiguous()
    path = wk.viterbi_paths_blocked_cuda(T, E, keys, valid, e_, x_, B)
    check_equal(f"viterbi_paths_blocked [{tag}] against K5", path,
                wk.viterbi_paths_cuda(T, E, keys, valid, e_, x_))
    t0 = time.perf_counter()
    path_p = wk.viterbi_paths_plain(T, E, keys, valid, e_, x_, block=B)
    torch.cuda.synchronize()
    plain_k5_ms = (time.perf_counter() - t0) * 1e3
    check_equal(f"viterbi_paths_blocked [{tag}]", path, path_p)
    log(f"viterbi_paths_blocked [{tag}]: equal to K5 and to the plain blocked walk bit "
        "for bit")

    # times of one pass's launches of each kernel, and the plain versions'
    e1, e2, k1p, k8p, A_in, Q_end = found[prec]

    def remat_pass():
        rr = wk.AlphaRemat(T, E, keys, valid, A_in, Q_end, prec, B)
        yield "k1", rr.snap
        yield "k8", rr.sweep

    def blocked_pass():
        kk = wk.ViterbiPathsBlocked(T, E, keys, valid, e_, x_, B)
        yield "fwd", kk.fwd_snap
        for b in range(kk.n_blocks - 1, -1, -1):
            yield "fwd", lambda b=b: kk.fwd_block(b)
            yield "back", lambda b=b: kk.back_block(b)

    t = launch_times(remat_pass, 5)
    t.update(launch_times(blocked_pass, 5))
    elt = wk.carry_dtype(prec, torch.float32).itemsize
    rec = {
        "asc_sweep_remat": (e1, t["k1"], k1p,
                            *bound("asc_sweep_remat", E, keys, valid, elt, block=B)),
        "remat_sweep": (e2, t["k8"], k8p,
                        *bound("remat_sweep", E, keys, valid, elt, block=B)),
        "viterbi_fwd_blocked": (0.0, t["fwd"], plain_k5_ms,
                                *bound("viterbi_fwd_blocked", E, keys, valid, block=B)),
        "viterbi_back_blocked": (0.0, t["back"], plain_k5_ms,
                                 *bound("viterbi_back_blocked", E, keys, valid, block=B)),
    }
    log(f"[{tag}] ms kernel/plain/bound: "
        + " ".join(f"{n} {v[1]:.3f}/{v[2]:.1f}/{v[3]:.4f}" for n, v in rec.items())
        + f"; max abs err {e1:.2e} {e2:.2e} 0 0 (K5 blocked bit for bit; K8's plain "
        "time is the whole plain remat pass)")
    return rec


def launch_times(passes, reps):
    """Mean CUDA-event milliseconds a pass spends in each kind of launch:
    ``passes()`` yields (kind, launch) pairs in order; each launch is timed
    by events around it, summed by kind over the pass, averaged over
    ``reps`` passes after one warm-up pass."""
    import torch

    for _, fn in passes():
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        for kind, fn in passes():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            marks.append((kind, a, b))
    torch.cuda.synchronize()
    out = {}
    for kind, a, b in marks:
        out[kind] = out.get(kind, 0.0) + a.elapsed_time(b) / reps
    return out


def remat_against_stored(im, pi, T, E, entry, exit_):
    """The over-budget routes against the stored ones in time (CUDA events,
    in turns stored, remat, remat, stored): on the manager's first
    REMAT_SEGMENTS segments, the stored-stream K1 and K2 against the remat
    pass's K1 snapshot and K8, then the E-step on those segments with and
    without remat (the ll identical: it is K3's and K6's); on every segment, K5 against K5 blocked (bit
    for bit: the backpointer stream, over the budget's policy, still fits the
    card for this one comparison)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    prec, B = im.precision, im._alpha_remat
    n = min(REMAT_SEGMENTS, im._wkeys.shape[0])
    keys, valid = im._wkeys[:n].contiguous(), im._wvalid[:n].contiguous()
    M = T.shape[0]
    A_in = torch.rand((n, M), device=T.device)
    Q_end = torch.rand((n, M), device=T.device)

    def remat():
        rr = wk.AlphaRemat(T, E, keys, valid, A_in, Q_end, prec, B)
        yield "remat K1", rr.snap
        yield "remat K8", rr.sweep

    def stored():
        al = [None]

        def k1():
            al[0] = wk.asc_sweep_cuda(T, E, keys, valid, A_in, prec)[0]

        def k2():
            wk.dsc_sweep_cuda(T, E, keys, valid, al[0], Q_end)
            al[0] = None

        yield "stored K1", k1
        yield "stored K2", k2

    t = launch_times(stored, 3)
    t.update(launch_times(remat, 3))
    t2 = launch_times(remat, 3)
    t2.update(launch_times(stored, 3))
    log(f"stored against remat on the first {n} segments (S x L = {tuple(keys.shape)}, "
        f"M = {M}, rung {prec!r}, block {B}), ms, two turns: " + ", ".join(
            f"{k} {t[k]:.2f} / {t2[k]:.2f}" for k in sorted(t)))
    log(f"  K1 + K2: stored {t['stored K1'] + t['stored K2']:.2f} / "
        f"{t2['stored K1'] + t2['stored K2']:.2f}, remat K1 + K8 "
        f"{t['remat K1'] + t['remat K8']:.2f} / {t2['remat K1'] + t2['remat K8']:.2f}")
    # the E-step on the same segments (the first contig's), remat against stored:
    # the ll comes from K3 and K6 alone, so it is the same number
    soc = np.arange(n)[None]
    ests = [wk.estep_direct(pi, T, E, keys, valid, soc, precision=prec, alpha_remat=a)
            for a in (B, None)]
    if float(ests[0][0]) != float(ests[1][0]):
        raise AssertionError(f"remat E-step [first {n} segments]: ll "
                             f"{float(ests[0][0])!r} against the stored stream's "
                             f"{float(ests[1][0])!r}")
    dst = [_rel_dist(a, b) for a, b in zip(ests[0][1:], ests[1][1:])]
    log(f"remat E-step [first {n} segments]: ll identical to the stored stream's "
        f"({float(ests[0][0])!r}); statistics within {max(dst):.3e} (relative)")
    del ests
    S = im._wkeys.shape[0]
    k5 = [wk.viterbi_paths_cuda(T, E, im._wkeys, im._wvalid, entry, exit_)]
    blocked = wk.viterbi_paths_blocked_cuda(T, E, im._wkeys, im._wvalid, entry, exit_, B)
    check_equal(f"viterbi_paths_blocked [every segment, S = {S}]", blocked, k5[0])
    del k5, blocked
    tk = [cuda_ms(lambda: wk.viterbi_paths_cuda(T, E, im._wkeys, im._wvalid, entry,
                                                exit_), 2),
          cuda_ms(lambda: wk.viterbi_paths_blocked_cuda(T, E, im._wkeys, im._wvalid, entry,
                                                        exit_, B), 2)]
    tk += [cuda_ms(lambda: wk.viterbi_paths_blocked_cuda(T, E, im._wkeys, im._wvalid,
                                                         entry, exit_, B), 2),
           cuda_ms(lambda: wk.viterbi_paths_cuda(T, E, im._wkeys, im._wvalid, entry,
                                                 exit_), 2)]
    b5 = bound("viterbi_paths", E, im._wkeys, im._wvalid)
    bf = bound("viterbi_fwd_blocked", E, im._wkeys, im._wvalid, block=B)
    bb = bound("viterbi_back_blocked", E, im._wkeys, im._wvalid, block=B)
    log(f"K5 against K5 blocked on every segment (S x L = {tuple(im._wkeys.shape)}): "
        f"bit for bit; ms K5 / blocked / blocked / K5: "
        + " / ".join(f"{x:.2f}" for x in tk)
        + f"; bounds K5 {b5[0]:.3f} ({b5[1]}), blocked forward {bf[0]:.3f} ({bf[1]}) + "
        f"backtrace {bb[0]:.3f} ({bb[1]})")


def k8_alone(S=REMAT_SEGMENTS, L=16384, M=32, n_keys=63, block=128, reps=3):
    """K8 alone at the posterior's shape (S x L = 6104 x 16384, M = 32, 63
    keys, block 128) on synthetic inputs whose keys are mostly one key (a
    monomorphic window's), at both rungs: its plan (``remat_plan`` and the
    card's registers, spills and residency), the pass on the first 32
    segments against the plain remat pass at K2's tolerances, and the
    stored route (K1 + K2) against the remat pass (K1 snapshot + K8) in
    time, in turns stored, remat, remat, stored, beside their bounds.  Not
    part of ``main``: a quick check and timing of K8 on the card."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    T, E, keys, valid, A_in, Q_end = problem(SEED, S, L, M, n_keys)
    rng = np.random.RandomState(SEED + 8)
    mono = torch.as_tensor(rng.rand(S, L) < 0.95, device="cuda")
    keys = torch.where(mono, torch.zeros_like(keys), keys).contiguous()
    for prec in ("default", "highest"):
        bf16 = wk.carry_dtype(prec, torch.float32) == torch.bfloat16
        tag = f"K8 alone, S x L = {S} x {L}, M = {M}, {n_keys} keys, block {block}, {prec!r}"
        log(f"[{tag}] plan {wk.remat_plan(S, L, M, n_keys, bf16, block)}; on the card "
            f"{wk.remat_sweep_plan(S, M, n_keys, bf16)}")
        n = 32
        k, v, a, q = (x[:n].contiguous() for x in (keys, valid, A_in, Q_end))
        got = wk.stats_pass_remat_cuda(T, E, k, v, a, q, prec, block)
        want = wk.stats_pass_remat_plain(T, E, k, v, a, q, prec, block,
                                         sum_dtype=torch.float64)
        rtol = DEFAULT_RTOL if bf16 else HIGHEST_RTOL
        for name, g, w, atol in zip(("alpha_end", "u_start", "xo", "gsum"), got, want,
                                    (1e-7, 1e-7, 1e-8, 1e-8)):
            check_close(f"[{tag}] first {n} segments {name}", g, w, rtol,
                        atol * float(w.abs().max()) if name in ("xo", "gsum") else atol)
        log(f"[{tag}] first {n} segments: " + ", ".join(
            f"{nm} {_rel_dist(g, w):.3e}" for nm, g, w in
            zip(("alpha_end", "u_start", "xo", "gsum"), got, want)))

        def remat():
            rr = wk.AlphaRemat(T, E, keys, valid, A_in, Q_end, prec, block)
            yield "remat K1", rr.snap
            yield "remat K8", rr.sweep

        def stored():
            al = [None]

            def k1():
                al[0] = wk.asc_sweep_cuda(T, E, keys, valid, A_in, prec)[0]

            def k2():
                wk.dsc_sweep_cuda(T, E, keys, valid, al[0], Q_end)
                al[0] = None

            yield "stored K1", k1
            yield "stored K2", k2

        t = launch_times(stored, reps)
        t.update(launch_times(remat, reps))
        t2 = launch_times(remat, reps)
        t2.update(launch_times(stored, reps))
        elt = 2 if bf16 else 4
        b8 = bound("remat_sweep", E, keys, valid, elt, block=block)
        b2 = bound("dsc_sweep", E, keys, valid, elt)
        log(f"[{tag}] ms, two turns: " + ", ".join(
            f"{x} {t[x]:.2f} / {t2[x]:.2f}" for x in sorted(t))
            + f"; bounds K8 {b8[0]:.3f} ({b8[1]}), K2 {b2[0]:.3f} ({b2[1]})")


# Phase 8, two populations: the joint data's shape is that of
# benchmarks/twopop_decode.py (n1 = 10 with the distinguished pair, n2 = 8)
TWOPOP_N = (10, 8)
TWOPOP_SPLIT = 0.4
TWOPOP_BP = 100_000_000  # the posterior's joint contig
SPLIT_BP = 50_000_000  # each contig of the split (see twopop_data)
TWOPOP_THETA = 1e-3  # 4 N0 mu at N0 = 2e4, mu = 1.25e-8; rho the same
ORACLE_BOUND = 5e-2  # f32 window decode vs the f64 span oracle, relative
PROBE_ROWS = 4000


def twopop_truth():
    "The known joint model: model2 at 0.7 of model1's size below the split."
    from smcpp_tpu_torch.models import SMCModel, SMCTwoPopulationModel

    knots = [0.05, 0.2, 0.8, 3.0]
    m1 = SMCModel(knots, 2e4, "piecewise", "pop1")
    m2 = SMCModel(knots, 2e4, "piecewise", "pop2")
    m2.y[:] = np.log(0.7)
    return SMCTwoPopulationModel(m1, m2, TWOPOP_SPLIT)


def _head(data, bp):
    "The rows of the first ``bp`` bases of a contig."
    cs = np.cumsum(data[:, 0].astype(np.int64))
    i = int(np.searchsorted(cs, bp))
    head = data[: i + 1].copy()
    head[-1, 0] -= cs[i] - bp
    return head


def twopop_data(workdir):
    """The joint data, from the truth, with the true marginal fits as the
    JSON ``split`` reads.  The posterior decodes one joint contig of
    TWOPOP_BP bases; the split reads SPLIT_BP bases of each of its contigs
    (that contig's first half, a second joint contig and one pop-2 contig
    from the truth's splice): at TWOPOP_BP each, phase 8 made the script
    more than two minutes longer.  Returns (the posterior's contig, the
    split's contigs, the fit paths)."""
    from smcpp_tpu_torch.data import format as fmt
    from smcpp_tpu_torch.data.simulate import simulate_joint_contig, write_simulated

    truth = twopop_truth()
    n1, n2 = TWOPOP_N
    th = TWOPOP_THETA
    pids = [truth.model1.pid, truth.model2.pid]
    dist = [[["sim", 0], ["sim", 1]], []]
    undist = [[["u1", i] for i in range(n1)], [["u2", i] for i in range(n2)]]
    t0 = time.perf_counter()
    post = os.path.join(workdir, "joint0.smc.gz")
    data = simulate_joint_contig(truth, th, th, TWOPOP_BP, n1, n2, seed=SEED + 80)
    fmt.write_contig(post, data, pids, dist, undist)
    split = [os.path.join(workdir, f"split_{name}.smc.gz")
             for name in ("joint0", "joint1", "pop2")]
    fmt.write_contig(split[0], _head(data, SPLIT_BP), pids, dist, undist)
    data = simulate_joint_contig(truth, th, th, SPLIT_BP, n1, n2, seed=SEED + 81)
    fmt.write_contig(split[1], data, pids, dist, undist)
    write_simulated(split[2], truth.for_pop("pop2"), th, th, L=SPLIT_BP, n=n2,
                    seed=SEED + 82, pid="pop2")
    fits = []
    for m, name in [(truth.model1, "pop1"), (truth.model2, "pop2")]:
        p = os.path.join(workdir, f"{name}.fit.json")
        with open(p, "w") as f:
            json.dump({"theta": th, "rho": th, "alpha": 1, "model": m.to_dict(),
                       "hidden_states": {m.pid: [0.0, float("inf")]}}, f)
        fits.append(p)
    log(f"simulated the joint data (n1 = {n1}, n2 = {n2}, split "
        f"{TWOPOP_SPLIT}): 1 joint contig x {TWOPOP_BP / 1e6:.0f} Mbp for the "
        f"posterior, 2 joint and 1 pop-2 contig x {SPLIT_BP / 1e6:.0f} Mbp for "
        f"the split (the first of its first half): "
        f"{time.perf_counter() - t0:.1f} s")
    return post, split, fits


def split_objective_cpu(sa, splits):
    """Q_split_batch at ``splits`` from the same objective objects built on
    CPU tensors (each manager copied with its device set to the CPU)."""
    import copy

    import torch

    from smcpp_tpu_torch.inference.manager import TwoPopInferenceManager
    from smcpp_tpu_torch.ops.split_objective import (
        MarginalSplitObjective,
        SplitObjective,
    )

    const, _ = sa._split_parts()
    tot = np.full(len(splits), const)
    pid1 = sa.model.pids[0]
    for im in sa._ims.values():
        c = copy.copy(im)
        c._device = torch.device("cpu")
        if isinstance(im, TwoPopInferenceManager):
            tot = tot + SplitObjective(c).q_batch(splits)
        elif im.pid != (pid1,):
            tot = tot + MarginalSplitObjective(c, sa.model).q_batch(splits)
    return tot


def twopop_split(workdir, files, fits):
    """``split --device cuda`` through the CLI entry point on the joint and
    the marginal contigs: the split within +-25% of the truth, the card's
    Q_split_batch on 16 candidates against the same objects on CPU tensors
    at rtol 1e-9; prints the wall time and the objective evaluations.
    Returns the fitted model.final.json."""
    import torch

    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.inference import split as split_mod

    calls = []
    orig = split_mod.SplitAnalysis.Q_split_batch

    def counted(self, splits):
        calls.append(len(splits))
        return orig(self, splits)

    out = os.path.join(workdir, "split")
    split_mod.SplitAnalysis.Q_split_batch = counted
    t0 = time.perf_counter()
    try:
        sa = cli.main(["split", "--device", "cuda", "-o", out, *fits, *files])
    finally:
        split_mod.SplitAnalysis.Q_split_batch = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = sa.model.split
    managers = {pid: (type(im).__name__, im.em_idx.n_keys)
                for pid, im in sa._ims.items()}
    log(f"split: {wall:.2f} s wall; split {got!r} (truth {TWOPOP_SPLIT}, "
        f"{(got - TWOPOP_SPLIT) / TWOPOP_SPLIT:+.2%}); loglik {sa.loglik()!r}; "
        f"{len(calls)} batched objective calls, {sum(calls)} split candidates "
        f"(batch widths {calls}); managers {managers}")
    if not (np.isfinite(got) and 0.75 * TWOPOP_SPLIT < got < 1.25 * TWOPOP_SPLIT):
        raise AssertionError(f"split {got} is not within 25% of {TWOPOP_SPLIT}")
    splits = np.linspace(0.02, 0.98, 16) * sa._max_split
    card = sa.Q_split_batch(splits)
    cpu = split_objective_cpu(sa, splits)
    err = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        sa.Q_split_batch(splits)
    ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"  Q_split_batch on 16 candidates: card against CPU tensors, largest "
        f"relative difference {err:.3e} (rtol 1e-9); {ms:.2f} ms a batch on the card")
    if not (np.all(np.isfinite(card)) and err <= 1e-9):
        raise AssertionError(f"Q_split_batch on the card is {err:.3e} from the CPU's")
    with open(os.path.join(out, "model.final.json")) as f:
        d = json.load(f)
    if d["model"]["class"] != "SMCTwoPopulationModel":
        raise AssertionError(f"split wrote a {d['model']['class']}")
    return os.path.join(out, "model.final.json")


def twopop_probe(im, data):
    """The window decode against the f64 span oracle on the first PROBE_ROWS
    rows of the contig, as a contig of their own: a manager with the
    posterior's model, parameters and hidden states decodes them through
    the window kernels on the card (f32, the posterior's rung), and
    ``hmm.posterior_gammas`` gives the f64 oracle on the card; the largest
    error relative to max(|oracle|, 1e-2) must stay within ORACLE_BOUND."""
    import torch

    from smcpp_tpu_torch.data import format as fmt
    from smcpp_tpu_torch.inference.manager import TwoPopInferenceManager
    from smcpp_tpu_torch.ops import hmm

    c = fmt.load_data([data])[0]
    obs = np.insert(c.data[: PROBE_ROWS - 1], 0, [[1, -1, 0, 0, -1, 0, 0]], 0)
    pm = TwoPopInferenceManager(c.n[0], c.n[1], c.a[0], c.a[1], [obs],
                                im.hidden_states, tuple(c.pid), 0.5,
                                device="cuda", precision=im._precision)
    if not pm._use_windows:
        raise AssertionError("the probe manager must run the window kernels")
    pm.set_model(im.model)
    pm.theta, pm.rho, pm.alpha = im.theta, im.rho, im.alpha
    pm.save_gamma = True
    pm.E_step()
    g32 = pm.gammas[0]
    pi, T, E = pm.tensors()
    ref = hmm.posterior_gammas(
        pi, T, E, torch.as_tensor(pm._spans[0], device="cuda"),
        torch.as_tensor(pm._keys[0], device="cuda"), pm._nbits, pm._chunk,
    ).cpu().numpy()
    reps = pm._row_reps[0]
    offs = np.concatenate([[0], np.cumsum(reps)[:-1]])
    ref = np.add.reduceat(ref[: int(reps.sum())], offs, axis=0)
    err = float(np.max(np.abs(g32 - ref) / np.maximum(np.abs(ref), 1e-2)))
    rowerr = float(np.max(np.abs(g32.sum(1) - obs[:, 0]) / obs[:, 0]))
    log(f"  probe ({len(obs)} rows, {int(obs[:, 0].sum())} bp, "
        f"{pm.em_idx.n_keys} keys, rung {pm._decode_precision()!r}): window "
        f"decode against the f64 span oracle, largest relative error {err:.3e} "
        f"(bound {ORACLE_BOUND}); row masses within {rowerr:.2e} of the spans")
    if not err <= ORACLE_BOUND or rowerr > 1e-3:
        raise AssertionError(f"two-population decode {err:.3e} from the f64 oracle")


def _uncached_ms(im, fn):
    "One uncached call of ``fn`` (the value cache cleared): (result, ms)."
    import torch

    im._tensors_cache = (None, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _allclose_ratio(got, want, rtol, atol):
    "max |got - want| / (atol + rtol |want|): within the bound when <= 1."
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def twopop_tensors(im):
    """The two-population posterior manager's tensors() on the card,
    uncached: the traced route (ops/jcsfs_traced.py) on its first call,
    which builds its device constants and the pop-2 splice, then the median
    of 5 with the value cache cleared (the constants and the splice kept)
    and of 5 with the splice cleared too, beside the eager host route
    (ops/jcsfs.py); then the traced route on the card against the same
    route on CPU tensors of the same manager (f64 against f64: pi, T and E
    within rtol 1e-9 / atol 1e-14, the tests' atol: the smallest entries
    come out of sums of O(1) terms whose last ulp differs between the
    card's and the host's exp and summation order), and
    against the eager route at tests/test_jcsfs_traced.py's bounds (pi rtol
    1e-10 / atol 1e-14, E and pi T rtol 1e-6 / atol 1e-12)."""
    import copy

    import torch

    if not im._traced_tensors_ok():
        raise AssertionError("the two-population posterior must take the traced route")
    im._traced_cache.clear()
    im._splice_memo = None
    traced, first = _uncached_ms(im, im.tensors)
    warm = [_uncached_ms(im, im.tensors)[1] for _ in range(5)]
    cold = []
    for _ in range(5):
        im._splice_memo = None
        cold.append(_uncached_ms(im, im.tensors)[1])
    if len(im._traced_cache) != 1:
        raise AssertionError(f"{len(im._traced_cache)} TracedJointCSFS built, not 1")
    with torch.no_grad():
        eager, e_first = _uncached_ms(im, im._tensors_eager)
        e_rest = [_uncached_ms(im, im._tensors_eager)[1] for _ in range(2)]
    log(f"  tensors() uncached, traced route on the card: first call "
        f"{first:.2f} ms (the constants built), median of 5 {np.median(warm):.2f} ms "
        f"({', '.join(f'{t:.2f}' for t in warm)}), with the pop-2 splice "
        f"re-evaluated {np.median(cold):.2f} ms; eager host route (ops/jcsfs.py) "
        f"{e_first:.1f} ms, then {', '.join(f'{t:.1f}' for t in e_rest)} ms")

    c = copy.copy(im)
    c._device = torch.device("cpu")
    c._traced_cache = {}
    c._tensors_cache = (None, None)
    cpu = [x.numpy() for x in c.tensors()]
    card = [x.cpu().numpy() for x in traced]
    ratio = {n: _allclose_ratio(a, b, 1e-9, 1e-14)
             for n, a, b in zip(("pi", "T", "E"), card, cpu)}
    log("  traced route, card against CPU tensors (f64, rtol 1e-9 / atol 1e-14): "
        + ", ".join(f"{n} largest relative {float(np.max(np.abs(a - b) / b)):.3e}, "
                    f"absolute {float(np.max(np.abs(a - b))):.3e} ({ratio[n]:.3f} of "
                    f"the bound)" for n, a, b in zip(("pi", "T", "E"), card, cpu)))
    if not (all(np.all(np.isfinite(x)) for x in card) and max(ratio.values()) <= 1):
        raise AssertionError(f"traced tensors() on the card differ from the CPU's: {ratio}")

    (pi_t, T_t, E_t), (pi_e, T_e, E_e) = card, [x.cpu().numpy() for x in eager]
    ratio = {
        "pi": _allclose_ratio(pi_t, pi_e, 1e-10, 1e-14),
        "E": _allclose_ratio(E_t, E_e, 1e-6, 1e-12),
        "pi T": _allclose_ratio(pi_t[:, None] * T_t, pi_e[:, None] * T_e, 1e-6, 1e-12),
    }
    rel = {"pi": np.abs(pi_t - pi_e) / pi_e, "E": np.abs(E_t - E_e) / E_e,
           "pi T": np.abs(pi_t[:, None] * T_t - pi_e[:, None] * T_e)
           / (pi_e[:, None] * T_e)}
    log("  traced against eager route (pi rtol 1e-10 / atol 1e-14, E and pi T "
        "rtol 1e-6 / atol 1e-12): " + ", ".join(
            f"{n} largest relative {float(rel[n].max()):.3e} ({ratio[n]:.3f} of "
            f"the bound)" for n in ratio))
    if max(ratio.values()) > 1:
        raise AssertionError(f"traced tensors() outside the eager route's bounds: {ratio}")


def twopop_path(workdir):
    """Phase 8: two populations.  Simulates the joint data (``twopop_data``),
    runs ``split --device cuda`` (``twopop_split``), then ``posterior
    --device cuda --map --intervals`` at M = 32 on the first joint contig
    with the split's model (``cli_posterior``: the window E-step, decode and
    Viterbi on the joint emission table, every kernel launched); prints how
    many uncached tensors() calls each made, times and checks tensors()
    (``twopop_tensors``), prints the decode's and the Viterbi's phases,
    holds every kernel against its plain version on the two-population
    manager's own inputs (``compare_posterior``) and the window decode
    against the f64 span oracle (``twopop_probe``)."""
    from smcpp_tpu_torch.inference import manager as tman

    t0 = time.perf_counter()
    post, split, fits = twopop_data(workdir)
    tman.TENSORS.launches = 0
    model_json = twopop_split(workdir, split, fits)
    n_split = tman.TENSORS.launches
    out = os.path.join(workdir, "twopop.npz")
    tman.TENSORS.launches = 0
    im, launches = cli_posterior("posterior [two populations]", out, model_json,
                                 post)
    log(f"  joint emission table: {im.em_idx.n_keys} keys x M = "
        f"{len(im.hidden_states) - 1} ({im.em_idx.n_keys * (len(im.hidden_states) - 1) * 4} "
        f"bytes in f32), n = {im.n}, (a1, a2) = {(im.a1, im.a2)}; uncached "
        f"tensors() calls: split {n_split}, posterior {tman.TENSORS.launches}")
    twopop_tensors(im)
    pi, T, E = (x.float().contiguous() for x in im.tensors())
    posterior_breakdown(im, pi, T, E)
    compare_posterior(im, pi, T, E)
    twopop_probe(im, post)
    log(f"phase 8 (two populations): {time.perf_counter() - t0:.1f} s")
    return launches


# Phase 9, the user's front end: a VCF from the slice's truth through
# vcf2smc, chunk, cv and simulate, each through the CLI
FRONTEND_BP = 50_000_000  # each of the two contigs
FRONTEND_SAMPLES = 10  # s0 the distinguished pair; s1-s9, 18 haplotypes
FRONTEND_THETA = 5e-4  # theta = rho = 2 N0 mu at N0 = 1e4, mu = 2.5e-8
FRONTEND_RP = "4,6"  # cv --rp-values
CHUNK_BP = 5_000_000


def write_vcf(fn, contig, data, length, seed):
    """A gzipped VCF of one contig: a biallelic record (REF A, ALT T, phased
    GT) at the 1-based position of each segregating row (span 1) of
    ``data``, the rows (span, a, b, nb = 18) of ``simulate_contig``.  Sample
    s0 is the distinguished pair (0|0, 0|1 or 1|1 by a); samples s1-s9 carry
    the b derived alleles over their 18 haplotypes, placed by a permutation
    drawn from ``seed``; ``##contig`` gives the length.  Written with NumPy
    in one pass.  Returns the record count."""
    data = np.asarray(data, np.int64)
    n_hap = 2 * (FRONTEND_SAMPLES - 1)
    if np.any(data[:, 3] != n_hap):
        raise ValueError(f"the rows must have nb = {n_hap}")
    seg = (data[:, 1] != 0) | (data[:, 2] != 0)
    if np.any(data[seg, 0] != 1):
        raise ValueError("a segregating row spans more than one base")
    pos = np.cumsum(data[:, 0])[seg]
    a, b = data[seg, 1], data[seg, 2]
    R = len(pos)
    rng = np.random.RandomState(seed)
    hap = np.empty((R, 2 * FRONTEND_SAMPLES), np.uint8)
    hap[:, 0] = a >= 2
    hap[:, 1] = a >= 1
    hap[:, 2:] = rng.random_sample((R, n_hap)).argsort(axis=1) < b[:, None]
    gt = np.empty((R, 4 * FRONTEND_SAMPLES), np.uint8)  # "x|y\t" a sample
    gt[:, 0::4] = ord("0") + hap[:, 0::2]
    gt[:, 1::4] = ord("|")
    gt[:, 2::4] = ord("0") + hap[:, 1::2]
    gt[:, 3::4] = ord("\t")
    gt[:, -1] = ord("\n")
    lines = np.char.add(f"{contig}\t".encode(), pos.astype("S"))
    lines = np.char.add(lines, b"\t.\tA\tT\t.\tPASS\t.\tGT\t")
    lines = np.char.add(lines, gt.view(f"S{gt.shape[1]}").ravel())
    samples = "\t".join(f"s{i}" for i in range(FRONTEND_SAMPLES))
    header = (
        "##fileformat=VCFv4.2\n"
        f"##contig=<ID={contig},length={length}>\n"
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + samples + "\n"
    )
    with gzip.open(fn, "wb", compresslevel=1) as f:
        f.write(header.encode())
        f.write(b"".join(lines.tolist()))
    return R


def _smc_body(fn):
    "The rows of an SMC++ file as text, and its header's JSON."
    from smcpp_tpu_torch.data import format as fmt

    with fmt.optional_gzip(fn, "rt") as f:
        head = f.readline()
        return f.read(), json.loads(head[len("# SMC++ "):])


def check_vcf2smc(out, data, length):
    """vcf2smc's output against the simulated rows: equal, as text, to what
    ``format.write_contig`` writes for them with every (a, b) = (2, nb) site
    folded to (0, 0) (runs merged); spans summing to the contig's length;
    the header's pids, dist and undist as the VCF gives them."""
    from smcpp_tpu_torch.data import format as fmt

    folded = np.array(data, np.int64)
    folded[(folded[:, 1] == 2) & (folded[:, 2] == folded[:, 3]), 1:3] = 0
    want = out + ".want.smc"
    fmt.write_contig(want, folded, ["pop1"], [], [])
    got, head = _smc_body(out)
    if got != _smc_body(want)[0]:
        raise AssertionError(f"{out}: vcf2smc's rows differ from the simulated rows")
    os.remove(want)
    spans = np.array(got.split(), np.int64).reshape(-1, 4)[:, 0]
    if spans.sum() != length:
        raise AssertionError(f"{out}: spans sum to {spans.sum()}, not {length}")
    n = FRONTEND_SAMPLES
    want_head = {
        "pids": ["pop1"],
        "dist": [[["s0", 0], ["s0", 1]]],
        "undist": [[[f"s{k}", i] for k in range(1, n) for i in (0, 1)]],
    }
    if {k: head[k] for k in want_head} != want_head:
        raise AssertionError(f"{out}: header {head}")
    return len(spans)


def vcf_round_trip(workdir, contig, L_bp, seed):
    """Phase 9's first step for one contig: simulate L_bp bases from the
    slice's truth (18 undistinguished haplotypes, theta = rho =
    FRONTEND_THETA), write them as a VCF (``write_vcf``), run ``vcf2smc``
    through the CLI and check its output (``check_vcf2smc``).  Returns (the
    .smc.gz path, the record count, vcf2smc's seconds)."""
    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.data.simulate import simulate_contig

    # the CLI imports every command module on its first call: not vcf2smc's
    from smcpp_tpu_torch.commands import (  # noqa: F401
        chunk, cite, cv, estimate, plot, posterior, simulate, split, vcf2smc,
        version,
    )

    th = FRONTEND_THETA
    t0 = time.perf_counter()
    data = simulate_contig(slice_truth(), th, th, L_bp,
                           2 * (FRONTEND_SAMPLES - 1), seed=seed)
    vcf = os.path.join(workdir, f"chr{contig}.vcf.gz")
    n_rec = write_vcf(vcf, contig, data, L_bp, seed)
    t1 = time.perf_counter()
    out = os.path.join(workdir, f"chr{contig}.smc.gz")
    pop = "pop1:" + ",".join(f"s{i}" for i in range(FRONTEND_SAMPLES))
    cli.main(["vcf2smc", vcf, out, contig, pop])
    dt = time.perf_counter() - t1
    rows = check_vcf2smc(out, data, L_bp)
    log(f"  contig {contig}: {n_rec} VCF records over {L_bp / 1e6:g} Mbp "
        f"(simulated and written in {t1 - t0:.1f} s); vcf2smc {dt:.2f} s: "
        f"{n_rec / dt:.0f} records/s, {L_bp / 1e6 / dt:.2f} Mbp/s; {rows} "
        f"rows, equal to the simulated rows folded")
    return out, n_rec, dt


def frontend_cv(workdir, files):
    """``cv --device cuda`` on ``files`` (2 folds, FRONTEND_RP, one EM
    iteration), then the same command again: checks each fold's ``.done``
    and ``model.best.json``, ``model.final.json`` against the aggregate of
    the best models read back, the E-step kernels' launches, and that the
    second run refits nothing (no launch, no fit) and writes the same
    ``model.final.json``.  Prints the wall times, each training fit's
    seconds and the device memory at the end of each fold.  Returns the
    path of ``model.final.json``."""
    import torch

    from smcpp_tpu_torch.commands import cv as cv_mod
    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.inference import analysis as an
    from smcpp_tpu_torch.models import model as model_mod

    out = os.path.join(workdir, "cv")
    argv = ["cv", "--device", "cuda", "--folds", "2", "--rp-values",
            FRONTEND_RP, "--em-iterations", "1", "-o", out,
            str(FRONTEND_THETA / 2 / 1e4), *files]
    fits, setups, folds = [], [], []
    orig_init, orig_run = an.Analysis.__init__, an.Analysis.run
    orig_mark = cv_mod.mark_completed

    def timed_init(self, data, args):
        t = time.perf_counter()
        orig_init(self, data, args)
        torch.cuda.synchronize()
        setups.append(time.perf_counter() - t)

    def timed_run(self, niter=None):
        t = time.perf_counter()
        ret = orig_run(self, niter)
        torch.cuda.synchronize()
        if niter is None:  # a training fit (stage 1 runs one iteration)
            fits.append(time.perf_counter() - t)
        return ret

    @contextlib.contextmanager
    def marked(path):
        with orig_mark(path) as p:
            yield p
        torch.cuda.synchronize()
        folds.append((torch.cuda.memory_allocated(),
                      torch.cuda.max_memory_allocated()))

    an.Analysis.__init__, an.Analysis.run = timed_init, timed_run
    cv_mod.mark_completed = marked
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, launches = launched(lambda: cli.main(argv))
        wall = time.perf_counter() - t0
        n_fits, n_setups = len(fits), len(setups)
        t0 = time.perf_counter()
        _, resumed = launched(lambda: cli.main(argv))
        wall2 = time.perf_counter() - t0
    finally:
        an.Analysis.__init__, an.Analysis.run = orig_init, orig_run
        cv_mod.mark_completed = orig_mark

    log(f"  cv --device cuda (2 folds, --rp-values {FRONTEND_RP}, 1 EM "
        f"iteration): {wall:.2f} s wall; analysis set-ups (data pipeline, "
        f"stage 1, stage-2 set-up; held-out first in each fold) "
        f"{[round(t, 2) for t in setups]} s; training fits (one EM "
        f"iteration) {[round(f, 2) for f in fits]} s; kernel launches "
        f"{launches}")
    (a0, p0), (a1, p1) = folds[:2]
    log(f"  device memory at the end of fold 0 / fold 1: allocated "
        f"{a0 / 1e6:.1f} / {a1 / 1e6:.1f} MB, peak so far {p0 / 1e9:.3f} / "
        f"{p1 / 1e9:.3f} GB")
    if a1 > a0 + 0.05 * p0:
        raise AssertionError("cv kept the first fold's device memory")
    missing = [k for k in ("segment_ops", "boundary_scan", "asc_sweep",
                           "dsc_sweep") if not launches.get(k)]
    if missing:
        raise AssertionError(f"cv launched no {missing}")
    n_rp = len(FRONTEND_RP.split(","))
    if n_fits != 2 * n_rp:
        raise AssertionError(f"cv ran {n_fits} training fits, not {2 * n_rp}")
    best = []
    for i in range(2):
        fd = os.path.join(out, f"fold{i}")
        if not os.path.exists(os.path.join(fd, ".done")):
            raise AssertionError(f"{fd}/.done is missing")
        with open(os.path.join(fd, "model.best.json")) as f:
            best.append(model_mod.SMCModel.from_dict(json.load(f)["model"]))
    final = os.path.join(out, "model.final.json")
    with open(final) as f:
        text = f.read()
    m = json.loads(text)["model"]
    want = model_mod.aggregate(*best)
    if m["class"] != "SMCModel" or not np.all(np.isfinite(m["y"])):
        raise AssertionError(f"model.final.json: {m}")
    if not (np.allclose(m["knots"], want.knots, rtol=1e-12, atol=0)
            and np.allclose(m["y"], want.y, rtol=1e-12, atol=0)):
        raise AssertionError("model.final.json is not the aggregate of the "
                             "folds' best models")
    with open(final) as f:
        same = f.read() == text
    log(f"  cv resumed: {wall2:.2f} s wall, kernel launches {resumed}, "
        f"{len(setups) - n_setups} set-ups, {len(fits) - n_fits} fits; "
        f"model.final.json {'unchanged' if same else 'CHANGED'}")
    if resumed or len(fits) != n_fits or len(setups) != n_setups or not same:
        raise AssertionError("the resumed cv refitted or wrote another model")
    return final


def frontend_path(workdir):
    """Phase 9: the user's front end on the card.  Two contigs of
    FRONTEND_BP simulated from the slice's truth go through a VCF and
    ``vcf2smc`` (``vcf_round_trip``); ``chunk -w CHUNK_BP 4`` cuts the
    first; ``cv --device cuda`` fits both (``frontend_cv``); ``simulate
    --engine hmm`` draws 1 Mbp (n = 10) from the aggregate.  Alone:
    ``python3 -c 'import chip_smoke as c, tempfile; c.card(); c.build();
    c.frontend_path(tempfile.mkdtemp())'``."""
    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.data import format as fmt

    t0 = time.perf_counter()
    log(f"phase 9 (front end): VCF -> vcf2smc, 2 contigs x "
        f"{FRONTEND_BP / 1e6:g} Mbp, {FRONTEND_SAMPLES} samples")
    files, n_rec, secs = [], 0, 0.0
    for i, contig in enumerate(("1", "2")):
        out, n, dt = vcf_round_trip(workdir, contig, FRONTEND_BP, SEED + 90 + i)
        files.append(out)
        n_rec += n
        secs += dt
    log(f"  vcf2smc in all: {n_rec} records, {n_rec / secs:.0f} records/s, "
        f"{2 * FRONTEND_BP / 1e6 / secs:.2f} Mbp/s (host)")

    os.makedirs(os.path.join(workdir, "chunks"))
    pattern = os.path.join(workdir, "chunks", "chunk.{}.smc.gz")
    t1 = time.perf_counter()
    cli.main(["chunk", "-w", str(CHUNK_BP), "4", pattern, files[0]])
    got = sorted(os.listdir(os.path.join(workdir, "chunks")))
    sums = [int(fmt.load_contig(pattern.format(i)).data[:, 0].sum())
            for i in range(4)]
    log(f"  chunk -w {CHUNK_BP} 4: {len(got)} files, spans {sums}, "
        f"{time.perf_counter() - t1:.2f} s")
    if len(got) != 4 or sums != [CHUNK_BP] * 4:
        raise AssertionError(f"chunk wrote {got} with spans {sums}")

    final = frontend_cv(workdir, files)

    sim = os.path.join(workdir, "sim.smc.gz")
    t1 = time.perf_counter()
    cli.main(["simulate", "--engine", "hmm", final, "10", "1e6", sim])
    c = fmt.load_contig(sim)
    log(f"  simulate --engine hmm (n = 10, 1 Mbp): {len(c.data)} rows, "
        f"n = {c.n}, {time.perf_counter() - t1:.2f} s")
    if int(c.data[:, 0].sum()) != 1_000_000 or c.n != [18]:
        raise AssertionError(f"simulate wrote {c.data[:, 0].sum()} bases, n = {c.n}")
    log(f"phase 9 (front end): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 10: several ranks (parallel/) on the card
# ---------------------------------------------------------------------------

MULTIRANK = 2  # ranks of phase 10
MULTIRANK_TIMEOUT = 300  # seconds a rank may take before the phase kills it
# the fits' agreement with phase 4 (tests/test_distributed.py's bound) and
# the posterior's with phase 5
Y_RTOL, Y_ATOL = 1e-4, 1e-6
GAMMA_RTOL, GAMMA_ATOL = 1e-4, 1e-3
MAP_SHARE = 0.999  # of the rows: equal MAP states, quantiles within Q_RTOL
Q_RTOL = 1e-3

# the functions a rank times with CUDA events (synchronised around each
# call): the collectives of parallel/mesh.py, the sharded passes, and inside
# them the kernels' entry points
_RANK_HOOKS = (
    ("mesh", ("gather_rows", "reduce_sum")),
    ("wk", ("estep_direct", "decode_gammas_windows", "viterbi_windows",
            "segment_operators", "contig_boundaries", "stats_pass",
            "rows_from_windows", "viterbi_segment_ops",
            "viterbi_boundary_states", "viterbi_segment_paths")),
)


def rank_child():
    """One rank of phase 10, run as ``python3 -c 'import chip_smoke as c;
    c.rank_child()' SPEC.json``: the CLI entry point on SPEC's argv (which
    joins the group), with every launch count set to 0 just before it and
    the functions of _RANK_HOOKS timed; writes its wall time, peak device
    memory, launches and timings to SPEC's ``out``."""
    import torch

    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.ops import window_kernel as wk
    from smcpp_tpu_torch.parallel import mesh as mm

    with open(sys.argv[1]) as f:
        spec = json.load(f)
    times, stack = {}, []

    def hook(mod, name):
        fn = getattr(mod, name)

        def timed(*a, **k):
            x = a[1] if name in ("gather_rows", "reduce_sum") else None
            label = "/".join(stack + [name]) + (
                "" if x is None else f"{tuple(x.shape)} {str(x.dtype)[6:]}")
            stack.append(name)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            try:
                out = fn(*a, **k)
            finally:
                stack.pop()
            stop.record()
            torch.cuda.synchronize()
            n, ms = times.get(label, (0, 0.0))
            times[label] = (n + 1, ms + start.elapsed_time(stop))
            return out

        setattr(mod, name, timed)

    for mod, names in _RANK_HOOKS:
        for name in names:
            hook({"mesh": mm, "wk": wk}[mod], name)
    for k in wk.KERNELS:
        k.launches = 0
    # no CUDA call before the CLI picks this rank's card: a fresh process's
    # peak counter starts at 0
    t0 = time.perf_counter()
    cli.main(spec["argv"])
    torch.cuda.synchronize()
    with open(spec["out"], "w") as f:
        json.dump({"wall": time.perf_counter() - t0,
                   "peak": torch.cuda.max_memory_allocated(),
                   "launches": {k.name: k.launches for k in wk.KERNELS},
                   "times": times}, f)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multirank_env(ranks):
    """(environment, description) of ``ranks`` ranks: NCCL with a card a rank
    where the machine has that many cards; else the ranks share cuda:0
    under gloo (NCCL refuses two ranks on one card), each with the decode
    gate's share of the card (70% of it over the ranks) as its stream
    budget."""
    import torch

    n = torch.cuda.device_count()
    env = {}
    if n >= ranks:
        return env, f"NCCL, {ranks} ranks on {ranks} cards"
    total = torch.cuda.get_device_properties(0).total_memory
    env.update(SMCPP_TPU_DIST_BACKEND="gloo",
               SMCPP_TPU_ESTREAM_BYTES=str(0.70 * total / ranks))
    return env, (f"gloo, {ranks} ranks sharing cuda:0 (one card), stream "
                 f"budget {0.70 * total / ranks / 1e9:.1f} GB a rank")


def run_ranks(label, workdir, argv, env, ranks):
    """``argv(rank)`` through the CLI on ``ranks`` child processes joined by
    --coordinator / --num-processes / --process-id (one process, no group,
    at ``ranks`` 1); every rank is killed on MULTIRANK_TIMEOUT and a failed
    rank fails the phase.  Prints each rank's wall time, peak device memory,
    launches and timed calls; returns their records and the wall time from
    the start to the last rank's exit."""
    port = _free_port()
    group = [] if ranks == 1 else ["--coordinator", f"127.0.0.1:{port}",
                                   "--num-processes", str(ranks)]
    procs, outs = [], []
    t0 = time.perf_counter()
    for r in range(ranks):
        out = os.path.join(workdir, f"{label}.rank{r}.json")
        spec = os.path.join(workdir, f"{label}.spec{r}.json")
        pid = ["--process-id", str(r)] if group else []
        with open(spec, "w") as f:
            json.dump({"out": out, "argv": [*argv(r), *group, *pid]}, f)
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as c; c.rank_child()", spec],
            cwd=HERE, env={**os.environ, **env}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MULTIRANK_TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{label}: rank {r} exited {p.returncode}:\n"
                                 f"{text[-6000:]}")
    recs = []
    for r, out in enumerate(outs):
        with open(out) as f:
            rec = json.load(f)
        recs.append(rec)
        log(f"  {label} rank {r}: {rec['wall']:.2f} s wall (CLI entry to "
            f"exit), peak device memory {rec['peak'] / 1e9:.2f} GB, launches "
            f"{ {k: v for k, v in rec['launches'].items() if v} }")
        for name, (n, ms) in sorted(rec["times"].items()):
            log(f"    {name}: {n} calls, {ms:.2f} ms in all")
    log(f"  {label}: {wall:.1f} s from start to the last rank's exit")
    return recs, wall


def _launched_all(label, recs, names):
    for r, rec in enumerate(recs):
        short = [n for n in names if rec["launches"][n] <= 0]
        if short:
            raise AssertionError(f"{label}: rank {r} never launched {short}")


def multirank_path(workdir, files=None, model_json=None, post_npz=None,
                   ranks=MULTIRANK):
    """Phase 10: ``estimate`` and ``posterior`` on ``ranks`` ranks through
    the CLI (``run_ranks``), against one process.

    (a) ``estimate --em-iterations 2`` host-local: each rank loads one of
        phase 4's two 100 Mbp contigs (ranks past two none); the ranks'
        model.final.json equal
        byte for byte, y within Y_RTOL / Y_ATOL of phase 4's, K3, K6, K1
        and K2 launched in each rank;
    (b) the same with --replicated-data: byte for byte (a)'s fit where the
        ranks are as many as the contigs (each rank sums the same segments),
        else within Y_RTOL / Y_ATOL of phase 4's;
    (c) ``posterior --map --intervals 0.025,0.5,0.975 --replicated-data`` at
        M = 32 on phase 5's contig, its segments split over the ranks (rows
        straddle the boundary): rank 0's npz against phase 5's (gammas per
        row within GAMMA_RTOL / GAMMA_ATOL, MAP states on MAP_SHARE of the
        rows, quantiles, sites), K3, K6, K1, K2, K2g, K4, K7 and K5 launched
        in each rank.

    Alone (``files`` None) it first makes phase 4's data and runs phase 4's
    estimate and phase 5's posterior in this process:
    ``python3 -c 'import chip_smoke as c, tempfile; c.card(); c.build();
    c.multirank_path(tempfile.mkdtemp())'``."""
    import gc

    import torch

    t_phase = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    if files is None:
        files, model_json, post_npz = one_process_references(workdir)
    gc.collect()
    torch.cuda.empty_cache()
    env, how = multirank_env(ranks)
    log(f"phase 10 (multi-rank): {how}; "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB held by this process")

    def estimate(tag, *extra):
        recs, wall = run_ranks(tag, workdir, lambda r: [
            "estimate", "--device", "cuda", "--em-iterations", "2", *extra,
            "-o", os.path.join(workdir, f"{tag}{r}"), MU, *files], env, ranks)
        fits = []
        for r in range(ranks):
            with open(os.path.join(workdir, f"{tag}{r}", "model.final.json"), "rb") as f:
                fits.append(f.read())
        if any(f != fits[0] for f in fits):
            raise AssertionError(f"{tag}: the ranks wrote different model.final.json")
        _launched_all(tag, recs, ("segment_ops", "boundary_scan", "asc_sweep",
                                  "dsc_sweep"))
        return fits[0], wall

    hl, hl_wall = estimate(f"estimate-hostlocal-{ranks}")
    with open(model_json, "rb") as f:
        y1 = np.asarray(json.loads(f.read())["model"]["y"], float)
    y = np.asarray(json.loads(hl)["model"]["y"], float)
    dy = np.abs(y - y1)
    log(f"  host-local fit: y {np.round(y, 6).tolist()}; largest |y - y(phase "
        f"4)| {dy.max():.3g} (relative {np.max(dy / np.abs(y1)):.3g}); ranks "
        "byte-identical")
    if not np.allclose(y, y1, rtol=Y_RTOL, atol=Y_ATOL):
        raise AssertionError(f"the {ranks}-rank fit {y} is not phase 4's {y1}")
    rep, rep_wall = estimate(f"estimate-replicated-{ranks}", "--replicated-data")
    if ranks == len(files):
        # a contig a rank either way: each rank sums the same segments
        if rep != hl:
            raise AssertionError("--replicated-data's fit differs from host-local's")
        log("  --replicated-data fit: byte-identical to host-local's")
    else:
        # the replicated blocks cut the contigs elsewhere: the sums differ in
        # order only
        yr = np.asarray(json.loads(rep)["model"]["y"], float)
        log(f"  --replicated-data fit: largest |y - y(phase 4)| "
            f"{np.abs(yr - y1).max():.3g}")
        if not np.allclose(yr, y1, rtol=Y_RTOL, atol=Y_ATOL):
            raise AssertionError(f"the replicated fit {yr} is not phase 4's {y1}")

    out = os.path.join(workdir, f"post-{ranks}.npz")
    recs, post_wall = run_ranks(f"posterior-{ranks}", workdir, lambda r: [
        *POSTERIOR, "--replicated-data", model_json, out, files[0]], env, ranks)
    _launched_all("posterior", recs, ("segment_ops", "boundary_scan", "asc_sweep",
                                      "dsc_sweep", "dsc_sweep_gamma", "viterbi_ops",
                                      "viterbi_boundary", "viterbi_paths"))
    z, ref = np.load(out), np.load(post_npz)
    d = files[0]
    if not np.array_equal(z[d + "_sites"], ref[d + "_sites"]):
        raise AssertionError("posterior: the sites differ from phase 5's")
    g, g1 = z[d], ref[d]
    off = np.abs(g - g1) > GAMMA_ATOL + GAMMA_RTOL * np.abs(g1)
    share = float(np.mean(z[d + "_map"] == ref[d + "_map"]))
    q, q1 = z[d + "_quantiles"], ref[d + "_quantiles"]
    dq = np.abs(q - q1)
    q_share = float(np.mean(np.all(dq <= Q_RTOL * np.abs(q1), axis=0)))
    log(f"  posterior against phase 5: gammas differ by at most "
        f"{np.abs(g - g1).max():.3g} ({int(off.sum())} entries past rtol "
        f"{GAMMA_RTOL} / atol {GAMMA_ATOL}); MAP states equal on {share:.6f} "
        f"of {g.shape[1]} rows; quantiles within rtol {Q_RTOL} on {q_share:.6f} "
        f"of the rows (largest difference {dq.max():.3g})")
    if off.any() or share < MAP_SHARE or q_share < MAP_SHARE:
        raise AssertionError("the multi-rank posterior is not phase 5's")
    log(f"phase 10 (multi-rank, {how}): {time.perf_counter() - t_phase:.1f} s; "
        f"estimate host-local {hl_wall:.1f} s, replicated {rep_wall:.1f} s, "
        f"posterior {post_wall:.1f} s")
    return recs


MU = "1.25e-8"
POSTERIOR = ["posterior", "--device", "cuda", "--map", "--intervals",
             "0.025,0.5,0.975"]


def one_process_references(workdir):
    """Phase 4's data, estimate and phase 5's posterior in this process, for
    phase 10 alone: returns (files, model.final.json, posterior npz)."""
    from smcpp_tpu_torch.commands import main as cli

    files = [simulate(workdir, f"contig{i}", 100_000_000, SEED + i)
             for i in range(2)]
    cli.main(["estimate", "--device", "cuda", "--em-iterations", "2", "-o",
              os.path.join(workdir, "out"), MU, *files])
    model_json = os.path.join(workdir, "out", "model.final.json")
    post_npz = os.path.join(workdir, "post.npz")
    cli.main([*POSTERIOR, model_json, post_npz, files[0]])
    return files, model_json, post_npz


def _pass_ms(rec, name):
    "Milliseconds a rank spent in the timed calls named ``name`` (any path)."
    return sum(ms for label, (n, ms) in rec["times"].items()
               if label.split("/")[-1].split("(")[0] == name)


def scaling(workdir, rank_counts=(2, 4)):
    """C5 scaling on a machine with several cards: phase 10's posterior (and
    its fits) on 1 card (one process through the same instrumented child)
    and on each of ``rank_counts`` ranks, NCCL with a card a rank where the
    machine has the cards.  Prints, per rank count, the posterior's wall
    time from start to the last exit, and the slowest rank's time in the
    decode's and the Viterbi's sharded passes, K3, K4 and the collectives.
    ``python3 -c 'import chip_smoke as c, tempfile; c.card(); c.build();
    c.scaling(tempfile.mkdtemp())'``."""
    files, model_json, post_npz = one_process_references(workdir)
    rows = {1: run_ranks("posterior-1", workdir, lambda r: [
        *POSTERIOR, model_json, os.path.join(workdir, "post-1.npz"), files[0]],
        {}, 1)[0]}
    for n in rank_counts:
        rows[n] = multirank_path(os.path.join(workdir, f"r{n}"), files,
                                 model_json, post_npz, ranks=n)
    log("C5 scaling of the posterior (slowest rank, ms): ranks | decode | "
        "viterbi | K3 (both passes) | K4 | gather_rows | reduce_sum")
    for n, recs in sorted(rows.items()):
        cols = [max(_pass_ms(r, name) for r in recs) for name in (
            "decode_gammas_windows", "viterbi_windows", "segment_operators", "viterbi_segment_ops", "gather_rows",
            "reduce_sum")]
        log(f"  {n} | " + " | ".join(f"{c:.2f}" for c in cols))


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


# ---------------------------------------------------------------------------
# Phase 12, the wide sample: n = 50 undistinguished lineages, past the f32
# M-step's size gate at the defaults' K (manager.FAST_MSTEP_MIN_WORK)
# ---------------------------------------------------------------------------

WIDE_N = 50
WIDE_BP = 100_000_000
WIDE_SEEDS = (120, 121)
COARSE_ROWS = 24  # rows a knot of the optimizer's coarse grid (optimizer._BATCH)


@contextlib.contextmanager
def fast_mstep_gate(min_work):
    """The f32 M-step's size gate (OnePopInferenceManager.FAST_MSTEP_MIN_WORK)
    at ``min_work`` for the block: 0 opens it on any card, inf closes it,
    None leaves the default."""
    from smcpp_tpu_torch.inference.manager import OnePopInferenceManager as IM

    old = IM.FAST_MSTEP_MIN_WORK
    if min_work is not None:
        IM.FAST_MSTEP_MIN_WORK = min_work
    try:
        yield
    finally:
        IM.FAST_MSTEP_MIN_WORK = old


def mstep_gate(label, im):
    "Print the f32 M-step gate's work and decision for a manager."
    work = im.mstep_work()
    on = im._use_fast_mstep()
    log(f"{label}: M-step gate (n+1)*n*K = {im.n + 1}*{im.n}*{im._grid.K} = "
        f"{work:,} against {im.FAST_MSTEP_MIN_WORK:,}: f32 programs "
        f"{'on' if on else 'off'}")
    return work, on


def coarse_rows(im):
    """A coarse batch of the optimizer's prefetch shape about the manager's
    y: COARSE_ROWS rows a knot, knot k swept over y[k] +- 1.5."""
    y0 = np.asarray(im.model.y, float)
    K = len(y0)
    ys = np.tile(y0, (COARSE_ROWS * K, 1))
    for k in range(K):
        ys[k * COARSE_ROWS:(k + 1) * COARSE_ROWS, k] = (
            y0[k] + np.linspace(-1.5, 1.5, COARSE_ROWS))
    return ys


def qbatch_call(im, fast_ok, ys):
    """Host milliseconds of one synchronized ``im.Q_batch(ys=ys,
    fast_ok=fast_ok)`` and its peak device bytes above what was held."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    im.Q_batch(ys=ys, fast_ok=fast_ok)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t) * 1e3,
            torch.cuda.max_memory_allocated() - base)


def qbatch_device(im, fast_ok, ys):
    """One ``Q_batch`` under torch.profiler: (CUDA kernels launched, their
    summed device milliseconds), or None where the profiler shows no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        im.Q_batch(ys=ys, fast_ok=fast_ok)
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    return len(kern), sum(e.time_range.elapsed_us() for e in kern) / 1e3


def mstep_crossover(label, im, pairs=5):
    """The gate's figures on a fitted manager and one coarse batch of the
    optimizer's shape timed in f64 and as the f32 program (the gate opened
    by hand where it is closed), in turns (f64,
    f32, f32, f64) after a warm-up of each, medians of 2 x ``pairs`` calls;
    each batch's kernel launches and device milliseconds (torch.profiler)
    and its peak device bytes beside the chunk plan's estimate."""
    from smcpp_tpu_torch.inference import manager as mg

    mstep_gate(label, im)
    ys = coarse_rows(im)
    runs = {False: [], True: []}
    with fast_mstep_gate(0):
        before = mg.Q_BATCH32.launches
        for fast in (False, True):
            qbatch_call(im, fast, ys)
        for _ in range(pairs):
            for fast in (False, True, True, False):
                runs[fast].append(qbatch_call(im, fast, ys))
        if mg.Q_BATCH32.launches != before + 1 + 2 * pairs:
            raise AssertionError(f"{label}: the f32 program did not run")
        try:
            dev = {fast: qbatch_device(im, fast, ys) for fast in (False, True)}
        except (RuntimeError, AttributeError) as e:  # the tracer, not the program
            dev = {False: None, True: None}
            log(f"  torch.profiler: {e!r}")
    (t64, t32), (b64, b32) = (
        [float(np.median([r[i] for r in runs[f]])) for f in (False, True)]
        for i in (0, 1))
    rows = im.q_chunk(), im.q_chunk(f32=True)
    devs = "; ".join(
        f"{name} {d[0]} kernels, {d[1]:.2f} ms on the device" if d else
        f"{name} device time not measured"
        for name, d in (("f64", dev[False]), ("f32", dev[True])))
    log(f"  one coarse batch of {len(ys)} rows ({COARSE_ROWS} a knot), "
        f"host clock, median of {2 * pairs} in turns: f64 {t64:.2f} ms, f32 "
        f"{t32:.2f} ms ({t64 / t32:.2f}x); {devs}; peak above the resident "
        f"{b64 / 1e9:.3f} / {b32 / 1e9:.3f} GB (the plan counts {mg.Q_LIVE} "
        f"arrays of (n+1)*n*K a candidate: "
        f"{len(ys) * 8 * mg.Q_LIVE * im.mstep_work() / 1e9:.3f} / "
        f"{len(ys) * 4 * mg.Q_LIVE * im.mstep_work() / 1e9:.3f} GB; chunks of "
        f"{rows[0]} / {rows[1]} rows) [{CARD}]")
    return t64, t32


def qbatch_rule(tag, v32, v64, block=None):
    """JAX's bar for an f32 batch (tests/test_f32_setup.py:71-73): max |v32
    - v64| below lim = max(1e-3 * median |diff v64|, 1e-5 * max |v64|) and
    the same argmax.  A single grid (the rho batch) is held to both.  With
    ``block`` (a coarse batch: one scalar search's grid every ``block``
    rows) the argmax is each grid's: at the fitted optimum a grid's best
    rows tie closer than the f32 error, so its argmax may move (2 of 7
    grids on the card), and the error bound alone lets the f32 pick lie up
    to 2 x the batch's largest error below the grid's best f64 value; held
    is that it lies no more than that error below it (0.0024 against 0.081
    on the card)."""
    sig = np.median(np.abs(np.diff(v64)))
    err = float(np.max(np.abs(v32 - v64)))
    lim = max(1e-3 * sig, 1e-5 * float(np.abs(v64).max()))
    step = block or len(v64)
    same, loss = 0, 0.0
    for i in range(0, len(v64), step):
        a, b = v32[i:i + step], v64[i:i + step]
        same += int(np.argmax(a)) == int(np.argmax(b))
        loss = max(loss, float(b.max() - b[np.argmax(a)]))
    grids = -(-len(v64) // step)
    log(f"  {tag}: max |v32 - v64| {err:.6g} (limit {lim:.6g}; "
        f"{err / float(np.abs(v64).max()):.3g} of max |v64|); argmax the same "
        f"in {same} of {grids} grids, the f32 picks at most {loss:.6g} below "
        f"their grid's best f64 value; whole batch {int(np.argmax(v32))} / "
        f"{int(np.argmax(v64))}")
    if not err < lim:
        raise AssertionError(f"phase 12: the f32 {tag} fails JAX's error bound")
    if block is None and same != grids:
        raise AssertionError(f"phase 12: the f32 {tag} moves JAX's argmax")
    if loss > err:
        raise AssertionError(f"phase 12: an f32 pick of the {tag} lies {loss} "
                             f"below its grid's best, past the error {err}")


def wide_fit(workdir, label, files, min_work):
    """``estimate --em-iterations 2 --device cuda`` through the CLI on the
    wide sample with the f32 M-step's gate at ``min_work``
    (``fast_mstep_gate``); prints each
    stage-2 EM iteration's E-step and M-step seconds, its Q batches and
    candidates (coarse and exact apart, f32 where the program ran) and its
    M-step's peak device memory.  Returns (analysis, y, f32 program runs)."""
    import torch

    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.inference import manager as mg

    out = os.path.join(workdir, f"wide_{label}")
    estep, calls = [], []
    orig_estep = mg.OnePopInferenceManager.E_step
    orig_qbatch = mg.OnePopInferenceManager.Q_batch

    held = [0]  # bytes allocated when the last E-step ended

    def timed_estep(self):
        torch.cuda.synchronize()
        # the M-step's peak: since the last E-step, above what it held then
        peak = (torch.cuda.max_memory_allocated(), held[0])
        t = time.perf_counter()
        res = orig_estep(self)
        torch.cuda.synchronize()
        estep.append((len(self.hidden_states) - 1, t, time.perf_counter(), peak))
        torch.cuda.reset_peak_memory_stats()
        held[0] = torch.cuda.memory_allocated()
        return res

    def counted_qbatch(self, ys=None, rhos=None, theta=None, alpha=None,
                       fast_ok=False):
        rows = len(ys) if ys is not None else len(rhos)
        calls.append((len(self.hidden_states) - 1, time.perf_counter(),
                      bool(fast_ok), bool(fast_ok and self._use_fast_mstep()),
                      rows))
        return orig_qbatch(self, ys, rhos, theta, alpha, fast_ok)

    mg.OnePopInferenceManager.E_step = timed_estep
    mg.OnePopInferenceManager.Q_batch = counted_qbatch
    for p in mg.FAST_PROGRAMS:
        p.launches = 0
    t0 = time.perf_counter()
    try:
        with fast_mstep_gate(min_work):
            analysis = cli.main([
                "estimate", "--device", "cuda", "--em-iterations", "2",
                "-o", out, "1.25e-8", *files,
            ])
            im = analysis._ims[("pop1",)]
            work, on = mstep_gate(f"fit {label} (the gate "
                                  f"{'closed by hand' if min_work else 'as is'})",
                                  im)
    finally:
        mg.OnePopInferenceManager.E_step = orig_estep
        mg.OnePopInferenceManager.Q_batch = orig_qbatch
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    last_peak = (torch.cuda.max_memory_allocated(), held[0])
    ran = {p.name: p.launches for p in mg.FAST_PROGRAMS}

    with open(os.path.join(out, "model.final.json")) as f:
        d = json.load(f)
    y = np.asarray(d["model"]["y"], float)
    if not (np.all(np.isfinite(y)) and np.isfinite(d["rho"]) and d["rho"] > 0):
        raise AssertionError(f"phase 12 ({label}): model.final.json is not finite: {d}")
    est2 = [e for e in estep if e[0] > 1]
    log(f"fit {label}: {t_end - t0:.2f} s, stage 2 from {est2[0][1] - t0:.2f} s; "
        f"M = {est2[0][0]}; f32 program runs {ran} [{CARD}]")
    for i, (_, _, e_end, _) in enumerate(est2[1:], 1):
        nxt = est2[i + 1] if i + 1 < len(est2) else None
        m_end = nxt[1] if nxt else t_end
        peak = nxt[3] if nxt else last_peak
        mine = [c for c in calls if c[0] > 1 and e_end <= c[1] < m_end]
        coarse = [c for c in mine if c[2]]
        exact = [c for c in mine if not c[2]]
        f32 = [c for c in coarse if c[3]]
        log(f"  EM iteration {i - 1}: E-step {e_end - est2[i][1]:.3f} s, M-step "
            f"{m_end - e_end:.3f} s; Q batches coarse {len(coarse)} "
            f"({sum(c[4] for c in coarse)} candidates, {len(f32)} as f32), "
            f"exact {len(exact)} ({sum(c[4] for c in exact)} candidates); "
            f"M-step peak {peak[0] / 1e9:.3f} GB, {(peak[0] - peak[1]) / 1e9:.3f} "
            f"above what the process held as it began [{CARD}]")
    ll = analysis.loglik()
    log(f"  final loglik {ll:.6f}, rho {d['rho']:.6g}, "
        f"y {np.round(y, 4).tolist()}")
    return analysis, y, ran, on, ll


def wide_sample(workdir):
    """Phase 12: 2 contigs x WIDE_BP at n = WIDE_N from the slice's truth
    (theta = rho = 2.5e-4, seeds WIDE_SEEDS), fitted twice through the CLI:
    at the defaults (the f32 M-step engaged) and with the gate closed.
    Checks both fits finite, the f32 programs run in the first and not in
    the second, JAX's rule on the card on the first fit's manager (its last
    E-step's statistics, ``qbatch_rule``): one coarse batch of the
    optimizer's prefetch shape and one rho batch of 12 over the optimizer's
    rho window, and the two fits' log-likelihoods within 1e-4 relative (the
    EM's ftol, the CPU fits' bound in tests/test_torch_fast_mstep.py)."""
    t0 = time.perf_counter()
    files = [simulate(workdir, f"wide{i}", WIDE_BP, seed, n=WIDE_N)
             for i, seed in enumerate(WIDE_SEEDS)]
    log(f"phase 12 (wide sample): simulated 2 contigs x {WIDE_BP / 1e6:.0f} "
        f"Mbp, n={WIDE_N}: {time.perf_counter() - t0:.1f} s")
    a32, y32, ran32, on32, ll32 = wide_fit(workdir, "f32", files, None)
    if not on32 or ran32["q_batch32"] <= 0:
        raise AssertionError(f"phase 12: the f32 M-step did not engage: {ran32}")
    im = a32._ims[("pop1",)]
    ys = coarse_rows(im)
    qbatch_rule(f"coarse batch of {len(ys)} rows",
                im.Q_batch(ys=ys, fast_ok=True), im.Q_batch(ys=ys),
                block=COARSE_ROWS)
    rhos = np.geomspace(im.theta / 100, im.theta * 100, 12)
    qbatch_rule("rho batch of 12", im.Q_batch(rhos=rhos, fast_ok=True),
                im.Q_batch(rhos=rhos))
    mstep_crossover(f"phase 12 (n = {WIDE_N})", im)
    del a32, im
    _, y64, ran64, on64, ll64 = wide_fit(workdir, "f64", files, float("inf"))
    if on64 or any(ran64.values()):
        raise AssertionError(f"phase 12: f32 programs ran, the gate closed: {ran64}")
    log(f"  largest |y_f32 - y_f64| {np.abs(y32 - y64).max():.6g}; "
        f"log-likelihoods {abs(ll32 - ll64) / abs(ll64):.3g} apart (relative)")
    if not abs(ll32 - ll64) <= 1e-4 * abs(ll64):
        raise AssertionError(f"phase 12: the fits' log-likelihoods part: "
                             f"{ll32} / {ll64}")
    log(f"phase 12 (wide sample): {time.perf_counter() - t0:.1f} s")


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
        with tempfile.TemporaryDirectory() as w2:
            twopop_path(w2)
        with tempfile.TemporaryDirectory() as w2:
            frontend_path(w2)
        multirank_path(os.path.join(workdir, "multirank"), files, model_json,
                       os.path.join(workdir, "post.npz"))
        t0 = time.perf_counter()
        over_launches, over_records = over_budget_posterior(workdir, model_json)
        log(f"phase 11 (over-budget posterior): {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as w2:
            wide_sample(w2)
    from smcpp_tpu_torch.ops import window_kernel as wk

    # K1-K3 and K6 from the estimate path, K2g, K4, K5 and K7 from the
    # posterior path, the over-budget kernels from phase 11's posterior
    for name in ("dsc_sweep_gamma", "viterbi_ops", "viterbi_paths",
                 "viterbi_boundary"):
        launches[name] = post_launches[name]
        records[name] = post_records[name]
    for k in wk.REMAT_KERNELS:
        launches[k.name] = over_launches[k.name]
        records[k.name] = over_records[k.name]
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
