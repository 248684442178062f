"""Inference managers, in torch.

Port of ``OnePopInferenceManager`` and ``TwoPopInferenceManager`` of
smcpp_tpu/inference/manager.py (which replace the reference's C++
InferenceManager, SMC++ src/inference_manager.cpp).  Both share
``_InferenceManager``: the data packing, the kernel choice, the E-step, the
decode and the MAP paths; they differ in the emission index and in how
``tensors()`` builds (pi, T, E):

* the E-step: the window kernel (ops/window_kernel.py:estep_direct) on the
  manager's device, float32, with the CUDA kernels on a GPU;
* the M-step objective: the float64 Q family (pi, T, E -> Q) with autograd
  for dQ/dy and a leading batch dimension for ``Q_batch``, on the same
  device; the optimizer's coarse bracketing batches as f32 programs on a
  GPU past a size gate (``_use_fast_mstep``).  The E-statistics are
  constants in Q (src/hmm.cpp:155-193);
* the posterior decode (``save_gamma`` / ``gammas``) and the MAP paths
  (``map_paths``) through the window kernels;
* the span kernel (ops/hmm.py) where the cost model picks it, and the
  row-level decode and Viterbi past the window gates and at M = 1;
* two populations: (pi, T, E) in float64 on the manager's device, the
  joint CSFS included (ops/jcsfs_traced.py; ops/jcsfs.py on the host for
  marginals that are not spline models); the split-time objective at
  trivial hidden states (ops/split_objective.py).

Everything runs on the ``device`` the manager was built with.  Asking for
CUDA where there is none raises; nothing falls back to the CPU.

Under a process group (parallel/distributed.py; ``mesh``) each rank holds
its block of the segment rows (window kernel) or of the contigs (span
kernel) on its own device, and the E-step, the decode and the MAP paths run
sharded (parallel/mesh.py), their results the same on every rank.  With
``local_data`` (host-local ingestion, parallel/hostlocal.py) ``data_list``
holds only this rank's contigs: the aggregates are summed over the ranks,
the window kernel always runs, and the decodes return this rank's rows.
"""

import contextlib
import json
import logging
import os
import tempfile

import numpy as np
import torch

from .. import trace
from ..models import SMCTwoPopulationModel
from ..ops import csfs as csfs_mod
from ..ops import emission as em_mod
from ..ops import grid as grid_mod
from ..ops import hmm, qconst
from ..ops import ratefunc, transition
from ..ops import window_kernel as wk
from ..parallel import distributed, hostlocal
from ..parallel import mesh as mesh_mod
from . import qgraph

logger = logging.getLogger(__name__)

# E-step precision ladder.  The rung sets the storage dtype of the window
# kernels' carries (ops/window_kernel.py:carry_dtype): bf16 at 'default',
# f32 above; the arithmetic is exact f32 on every rung.  The optimizer
# climbs one rung when the likelihood decreases beyond tolerance.
PRECISION_LADDER = ("default", "tensorfloat32", "highest")
_PRECISION_ALIASES = {"bfloat16": "default", "float32": "highest"}

# The largest arrays of one candidate's Q are the CSFS "above" integrals'
# (n+1, n, K) intermediates (ops/ratefunc.py:tjj_above); Q_LIVE of them (and
# of the smaller (keys, M), (M, M) arrays) are counted live at once when a
# batch is cut into chunks that fit the Q budget (``q_chunk_rows``).
Q_LIVE = 16

# The share of the card's memory one chunk of a Q batch may take, beside
# what the data and the E-step's statistics hold (Q_LIVE counts about twice
# the peak measured at n = 50).  Its own budget: the E-stream's override
# (SMCPP_TPU_ESTREAM_BYTES) does not reach it.
Q_MEM_FRAC = 0.25


def q_chunk_rows(n, K, n_keys, M, itemsize, budget):
    """Candidates of one batched Q evaluation: the per-candidate bytes at
    ``itemsize`` (8 for f64, 4 for the f32 programs) against ``budget``
    bytes, at least one.  Chunks are independent, so the plan changes no
    value."""
    per = itemsize * Q_LIVE * ((n + 1) * max(n, 1) * K + n_keys * M + M * M)
    return max(1, int(budget // per))


class _Program:
    """A program's Python face (an f32 M-step program, the two-population
    tensors() build): ``launches`` counts the calls that ran it
    (incremented where it runs, nowhere else), as ops/window_kernel.py
    counts kernel launches."""

    def __init__(self, name):
        self.name = name
        self.launches = 0


Q_BATCH32 = _Program("q_batch32")
Q_RHO32 = _Program("q_rho_batch32")
FAST_PROGRAMS = (Q_BATCH32, Q_RHO32)
# the two-population manager's uncached tensors() calls
TENSORS = _Program("twopop_tensors")


@contextlib.contextmanager
def exact_f32():
    """Float32 products at full f32 for the block: no TF32 pass may reach
    the f32 programs' einsums (bf16/TF32 passes in the CSFS and emission
    contractions cost about 390 log-likelihood units at the fixed point,
    manager.py:1209-1213 of the reference package)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def resolve_device(device):
    "A torch.device; CUDA must exist when it is asked for."
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU"
        )
    return dev


def _best_max_span(all_spans):
    """Pick the span cap S minimizing the span kernel's cost model
    (rows_after_split * matmuls_per_row), matmuls_per_row ~ 2 * bit_length(S).
    """
    s = np.concatenate(all_spans).astype(np.int64)
    best, best_cost = None, np.inf
    for b in range(2, 25):
        S = (1 << b) - 1
        rows = int(np.sum(np.maximum(1, -(-s // S))))
        cost = rows * 2 * b
        if cost < best_cost:
            best, best_cost = S, cost
    return best


def _split_spans(s, k, S):
    "Split rows with span > S into balanced sub-rows of span <= S."
    reps = np.maximum(1, -(-s // S)).astype(np.int64)
    if reps.max(initial=1) == 1:
        return s, k
    k2 = np.repeat(k, reps)
    s2 = np.repeat(s // reps, reps)
    # distribute the remainders: the first (s % reps) sub-rows get +1
    ends = np.cumsum(reps)
    starts = ends - reps
    idx = np.arange(len(k2))
    row = np.repeat(np.arange(len(s)), reps)
    offset = idx - starts[row]
    s2 = s2 + (offset < (s % reps)[row])
    return s2.astype(np.int64), k2


def pack_observations(data_list, key_id, chunk, max_span=None):
    """Map contig rows to key ids and pad into (C, Lmax) arrays.

    Rows with span == 0 / key 0 are padding.  Spans wider than ``max_span``
    (cost-model-chosen by default) are split into multiple rows.  Returns
    (spans, keys, reps) where ``reps`` gives, per contig, the number of
    packed sub-rows each original row became."""
    if not data_list:
        return (np.zeros((0, chunk), np.int32), np.zeros((0, chunk), np.int32),
                [])
    raw = []
    for d in data_list:
        s = d[:, 0].astype(np.int64)
        k = wk.rows_to_key_ids(d[:, 1:], key_id)
        raw.append((s, k))
    if max_span is None:
        max_span = _best_max_span([s for s, _ in raw])
    spans_l, keys_l, reps_l = [], [], []
    for s, k in raw:
        s2, k2 = _split_spans(s, k, max_span)
        spans_l.append(s2.astype(np.int32))
        keys_l.append(k2)
        reps_l.append(np.maximum(1, -(-s // max_span)).astype(np.int64))
    C = len(spans_l)
    Lmax = max(len(s) for s in spans_l)
    Lmax = -(-Lmax // chunk) * chunk
    spans = np.zeros((C, Lmax), dtype=np.int32)
    keys = np.zeros((C, Lmax), dtype=np.int32)
    for i, (s, k) in enumerate(zip(spans_l, keys_l)):
        spans[i, : len(s)] = s
        keys[i, : len(k)] = k
    return spans, keys, reps_l


def _all_keys(data_list, mesh=None, ncols=None):
    """The distinct observation keys (every column but the span) of the
    data; with a host-local ``mesh``, of every rank's data (``ncols`` pins
    the key width for a rank with no contigs)."""
    if mesh is None:
        return np.unique(
            np.concatenate([d[:, 1:] for d in data_list], axis=0), axis=0
        )
    lk = (np.concatenate([d[:, 1:] for d in data_list], axis=0) if data_list
          else np.zeros((0, ncols), np.int64))
    return hostlocal.global_unique_rows(lk.astype(np.int64), mesh, ncols=ncols)


def _job_mesh(mesh):
    "The manager's mesh: ``mesh`` if given, else the live process group's."
    return mesh if mesh is not None else distributed.current()


def _pi_and_e(em_idx, a, grid, branch_lengths, theta, alpha, c=None):
    """pi and E from the per-piece sizes ``a`` on ``grid`` and the CSFS (or
    joint CSFS) branch lengths of each hidden interval, in ``a``'s dtype;
    ``c``: the grid's constants (ops/qconst.py), made here when None."""
    c = ratefunc.consts(grid, a, c)
    pi = ratefunc.initial_distribution(a, grid, c)
    em = csfs_mod.incorporate_theta(branch_lengths, theta, c)
    e2 = em_mod.e2_matrix(ratefunc.average_coal_times(a, grid, c), theta, alpha)
    return pi, em_mod.emission_matrix(em_idx, em, e2, c)


def _hmm_tensors(em_idx, a, grid, rho, branch_lengths, theta, alpha, c=None):
    "(pi, T, E): ``_pi_and_e`` and the transition matrix."
    c = ratefunc.consts(grid, a, c)
    pi, E = _pi_and_e(em_idx, a, grid, branch_lengths, theta, alpha, c)
    return pi, transition.transition_matrix(a, rho, grid, c), E


def _marginal_model(model, pid):
    "Concrete marginal model for a (possibly joint) model object."
    if isinstance(model, SMCTwoPopulationModel):
        return model.for_pop(pid)
    return model


class _InferenceManager:
    """What the one- and two-population managers share: the packed data and
    the kernel choice, the E-step (window kernel, span kernel or the M = 1
    closed form), the posterior decode and the MAP paths.  A subclass
    supplies the emission index ``em_idx`` and ``tensors()``."""

    def __init__(self, em_idx, data_list, hidden_states, pid, chunk, device,
                 precision, mesh=None, local_data=False):
        self.pid = pid
        self._precision = precision
        self.hidden_states = np.asarray(hidden_states, dtype=np.float64)
        self._mesh = mesh
        self._local_data = local_data
        self._device = resolve_device(device)
        if mesh is not None:
            if mesh.device.type != self._device.type:
                raise ValueError(
                    f"the manager's device {self._device} is not the rank's "
                    f"device {mesh.device}"
                )
            self._device = mesh.device
        self.em_idx = em_idx
        spans, keys, self._row_reps = pack_observations(
            data_list, self.em_idx.key_id(), chunk
        )
        self._spans, self._keys, self._chunk = spans, keys, chunk
        self._rows_d = None
        max_span = int(spans.max(initial=0))
        self._total_bases = float(sum(d[:, 0].sum() for d in data_list))
        self._key_counts = np.bincount(
            keys.ravel(),
            weights=spans.ravel().astype(np.float64),
            minlength=self.em_idx.n_keys,
        ).astype(np.float64)
        self._n_contigs = spans.shape[0]
        if local_data:
            # the totals the M = 1 E-step, the cost model and the M-step use
            max_span = int(hostlocal.allreduce_max(np.int64(max_span), mesh))
            self._total_bases = float(
                hostlocal.allreduce_sum(np.float64(self._total_bases), mesh))
            self._key_counts = hostlocal.allreduce_sum(self._key_counts, mesh)
            self._n_contigs = int(
                hostlocal.allreduce_sum(np.int64(self._n_contigs), mesh))
        self._nbits = max(1, max_span.bit_length())
        self._init_kernel_choice(data_list, spans)

        # mutable parameters
        self.model = None
        self.theta = None
        self.rho = None
        self.alpha = 1
        self._stats = None
        self._stats_dev = None
        self._ll = None
        self.save_gamma = False
        self.gammas = None
        self._build_estep_fn()

    # -- kernel choice and the window-stream memory policy ---------------
    def _init_kernel_choice(self, data_list, spans):
        """Pick the E-step kernel by the reference's cost model
        (manager.py:_init_kernel_choice) and stage its inputs: the packed
        windows for the window kernel, the packed rows for the span kernel
        (ops/hmm.py)."""
        if len(self.hidden_states) == 2:
            # single hidden interval: the closed-form E-step (_estep_m1)
            self._use_windows = False
            return
        n_rows = int((spans > 0).sum())
        window_cost = self._total_bases
        span_cost = n_rows * 2 * self._nbits * 30
        # host-local shards always run the window kernel, as the reference's
        # do: the span kernel's (C, L) rows have no host-local placement
        self._use_windows = self._local_data or window_cost < span_cost
        logger.debug(
            "IM(pid=%s): %d contigs, padded L=%d, %d keys, nbits=%d, "
            "kernel=%s, device=%s, ranks=%d",
            self.pid, spans.shape[0], spans.shape[1], self.em_idx.n_keys,
            self._nbits, "window" if self._use_windows else "span",
            self._device, 1 if self._mesh is None else self._mesh.size,
        )
        if not self._use_windows:
            self._rows()
            return
        # row spans per contig, for the window decode's row ends
        self._wrow_spans = [d[:, 0].astype(np.int64) for d in data_list]
        self._wrow_offset = 0
        self._wlocal = None
        if self._local_data:
            wkeys, wvalid, soc, self._wlocal = hostlocal.pack_windows_local(
                data_list, self.em_idx.key_id(), self._mesh
            )
        else:
            wkeys, wvalid, soc = wk.pack_windows(data_list, self.em_idx.key_id())
            if self._mesh is not None:
                wkeys, wvalid = (
                    mesh_mod.local_block(self._mesh, x)
                    for x in mesh_mod.pad_segments(wkeys, wvalid, self._mesh.size)
                )
        wk.check_key_range(wkeys, self.em_idx.n_keys)
        # under a mesh: this rank's block of the segment rows
        self._wkeys = torch.as_tensor(wkeys, device=self._device)
        self._wvalid = torch.as_tensor(wvalid, device=self._device)
        self._soc = soc

    def _rows(self):
        """The packed rows (spans, keys) as (C, L) int32 tensors on the device;
        under a replicated mesh, this rank's block of the contigs (padded with
        span-0 contigs to a multiple of the ranks)."""
        if self._rows_d is None:
            rows = (self._spans, self._keys)
            if self._mesh is not None and not self._local_data:
                rows = (mesh_mod.local_block(self._mesh, mesh_mod.pad_rows(x, self._mesh.size))
                        for x in rows)
            self._rows_d = tuple(torch.as_tensor(x, device=self._device)
                                 for x in rows)
        return self._rows_d

    def _row_budget(self):
        """Byte budget of one batch of the row-level kernels (ops/hmm.py):
        the device budget on a GPU, the reference's 256 MB elsewhere."""
        if self._device.type == "cuda":
            return self._hbm_budget()
        return hmm.BATCH_BYTES

    def _hbm_budget(self, frac=0.375):
        """Per-device byte budget for window-state streams: ``frac`` of the
        card's memory as torch.cuda.mem_get_info reports it (6 GB on the
        CPU, as in the reference).  SMCPP_TPU_ESTREAM_BYTES overrides it with
        an absolute budget that every gate and every ``frac`` compares
        against (manager.py:_hbm_budget)."""
        v = os.environ.get("SMCPP_TPU_ESTREAM_BYTES")
        if v is not None:
            return float(v)
        if self._device.type != "cuda":
            return 6e9
        _free, total = torch.cuda.mem_get_info(self._device)
        return frac * float(total)

    def _window_stream_bytes(self, bytes_per_state):
        """Bytes of a (windows x M) stream at bytes_per_state per element, on
        this rank's device (its block of the segments under a mesh)."""
        S, L = self._wkeys.shape
        return S * L * (len(self.hidden_states) - 1) * bytes_per_state

    def _window_decode_fits(self):
        """The gamma decode's streams fit 70% of the card: the decode runs
        at the tensorfloat32 rung (f32 carries), so alpha (4 B) + gamma
        (4 B) + a 4 B allowance for transients per window and state, as the
        reference accounts (manager.py:476-488).  The decode is a program of
        its own whose streams are its footprint, hence 70% and not the
        E-step's 37.5%."""
        return self._window_stream_bytes(12) <= self._hbm_budget(0.70)

    def _window_viterbi_fits(self):
        "MAP decode: the int8 backpointer stream + int32 path, about 2 B."
        return self._window_stream_bytes(2) <= self._hbm_budget()

    def _decode_precision(self):
        """Posterior decodes never run below the tensorfloat32 rung: bf16
        operator carries put visible noise on segment-boundary posteriors."""
        p = self.precision
        return p if p == "highest" else "tensorfloat32"

    def _build_estep_fn(self):
        """The per-window stream policy of the reference
        (manager.py:_build_estep_fn, :909-942): the E-step stores the alpha
        stream (carry dtype, 2 or 4 B/window/M) while it fits the budget;
        over it, ``_alpha_remat`` is the block size of alpha remat
        (``remat_block_size(L)``), which keeps one carry snapshot per block
        and recomputes each block's alphas.  Called again after
        ``raise_precision``, so a climb past bf16 (4 B) switches to remat
        mid-EM.  The emission stream is never needed here (the kernels
        gather emission rows)."""
        self._alpha_remat = None
        if not self._use_windows:
            return
        ab = torch.finfo(wk.carry_dtype(self.precision, torch.float32)).bits // 8
        need = self._window_stream_bytes(ab)
        budget = self._hbm_budget()
        if need > budget:
            self._alpha_remat = wk.remat_block_size(self._wkeys.shape[1])
            logger.info(
                "window streams (%.1f GB/device) over budget (%.1f GB): "
                "alpha remat ON (block %d)",
                need / 1e9, budget / 1e9, self._alpha_remat,
            )

    # -- precision ladder -------------------------------------------------
    @property
    def precision(self):
        "Effective E-step precision rung."
        p = self._precision if self._precision is not None else wk.MATMUL_PRECISION
        return _PRECISION_ALIASES.get(p, p)

    def raise_precision(self):
        """Climb one rung of PRECISION_LADDER; returns the new rung, or None
        if already at 'highest'."""
        cur = self.precision
        try:
            i = PRECISION_LADDER.index(cur)
        except ValueError:
            return None
        if i + 1 >= len(PRECISION_LADDER):
            return None
        self._precision = PRECISION_LADDER[i + 1]
        self._build_estep_fn()
        logger.info("E-step precision raised: %s -> %s", cur, self._precision)
        return self._precision

    # -- parameters and the Q statistics ------------------------------------
    def _f64(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), device=self._device)

    def _stats_t(self):
        "The E-statistics as f64 tensors on the device (cached per E-step)."
        if self._stats_dev is None or self._stats_dev[0] is not self._stats:
            self._stats_dev = (self._stats, tuple(self._f64(s) for s in self._stats))
        return self._stats_dev[1]

    @staticmethod
    def _q_of(pi, T, E, stats):
        """Q from (pi, T, E) and the f64 statistics.  Logs of f32 tensors
        (the f32 programs) are taken in f32 and promoted by the statistics,
        so every sum runs in f64: the statistics reach about 5e7 in mass,
        past what an f32 sum holds to the f32 programs' tolerance."""
        gamma0, xisum, gamma_sums = stats
        return (
            torch.sum(gamma0 * torch.log(pi), -1)
            + torch.sum(gamma_sums * torch.log(E), (-2, -1))
            + torch.sum(xisum * torch.log(T), (-2, -1))
        )

    # -- E-step ------------------------------------------------------------
    def E_step(self):
        m1 = len(self.hidden_states) == 2
        route = ("m1" if m1 else "rows" if not self._use_windows
                 else "windows" if self._alpha_remat is None else "remat")
        with trace.span("estep." + route):
            if m1:
                ll = self._estep_m1()
                if self.save_gamma:
                    self.gammas = self._gammas_m1()
                return ll
            with trace.span("tensors"):
                pi, T, E = self.tensors()
            pi_d, T_d, E_d = (x.float().contiguous() for x in (pi, T, E))
            mesh = self._mesh
            if self._use_windows:
                ll, gamma0, xisum, gamma_sums = wk.estep_direct(
                    pi_d, T_d, E_d, self._wkeys, self._wvalid, self._soc,
                    precision=self.precision, alpha_remat=self._alpha_remat,
                    mesh=mesh,
                )
            else:
                # this rank's contigs; the statistics summed over the ranks in f64
                ll, gamma0, xisum, gamma_sums = (
                    mesh_mod.reduce_sum(mesh, x.detach().to(torch.float64))
                    for x in hmm.estep(pi_d, T_d, E_d, *self._rows(), self._nbits,
                                       self._chunk, self._row_budget())
                )
            with trace.span("pull"):
                self._ll = float(ll)
                self._stats = tuple(
                    x.detach().to(torch.float64).cpu().numpy()
                    for x in (gamma0, xisum, gamma_sums)
                )
            with trace.span("check"):
                self._check_finite(self._ll, self._stats, pi, T, E)
            if self.save_gamma:
                self.gammas = self._compute_gammas(pi_d, T_d, E_d)
        return self._ll

    def _estep_m1(self):
        """Exact closed-form E-step for a single hidden interval (the stage-1
        warm start): the HMM degenerates to independent sites, so the per-key
        posterior masses are the span totals."""
        pi, T, E = self.tensors()
        logE = np.log(E.cpu().numpy()[:, 0])
        counts = self._key_counts
        self._ll = float(counts @ logE)
        total = counts.sum()
        self._stats = (
            np.array([float(self._n_contigs)]),
            np.array([[total]]),
            counts[:, None].copy(),
        )
        self._check_finite(self._ll, self._stats, pi, T, E)
        return self._ll

    def loglik(self):
        return self._ll

    # -- posterior decode and MAP paths -----------------------------------
    def _gammas_m1(self):
        """Row gammas at a single hidden interval: each row's posterior mass
        is its span, exactly (manager.py:1292-1306); sub-rows made by span
        splitting are summed back to the caller's rows."""
        return [s[:, None] for s in self._per_input_row(self._spans.astype(np.float64))]

    def _per_input_row(self, rows):
        """Cut (C, L, ...) packed sub-row results into one array per contig
        of the caller's rows, summing the sub-rows span splitting made."""
        out = []
        for i, reps in enumerate(self._row_reps):
            r = rows[i, : int(reps.sum())]
            if reps.max(initial=1) > 1:
                r = np.add.reduceat(r, np.concatenate([[0], np.cumsum(reps)[:-1]]), axis=0)
            out.append(r)
        return out

    def _row_ends(self):
        """Flat segment-major index of every row's last window, on the device
        (every rank's rows under host-local ingestion, numbered in rank
        order; ``_wrow_offset`` is this rank's first)."""
        if getattr(self, "_wrow_ends", None) is None:
            if self._local_data:
                _, self._wrow_offset, ends = hostlocal.decode_row_placement(
                    self._wrow_spans, self._wlocal, self._mesh
                )
            else:
                ends = wk.pack_window_row_ends(
                    self._wrow_spans, self._wkeys.shape[1], self._soc
                )
            self._wrow_ends = torch.as_tensor(ends, device=self._device)
        return self._wrow_ends

    def _split_rows(self, rows):
        "Cut this rank's rows of a (n_rows, ...) host array into one per contig."
        out, off = [], self._wrow_offset
        for spans in self._wrow_spans:
            out.append(rows[off : off + len(spans)])
            off += len(spans)
        return out

    def _compute_gammas(self, pi_d, T_d, E_d):
        """Posterior masses per original input row, one (L_i, M) f32 array
        per contig: through the window decode (decode_gammas_windows) when
        the E-step runs on windows and its streams fit the card, else the
        row-level decode (hmm.decode_gammas, manager.py:334-410), its
        sub-rows summed back to the caller's rows.  The pull is f32 (the
        reference's f16 pull is not ported)."""
        mesh = self._mesh
        # the route is named once chosen, so that the span holds the whole
        # call, the choice of the route included
        with trace.span("decode") as span:
            if self._use_windows and self._window_decode_fits():
                span.rename("decode.windows")
                _, g = wk.decode_gammas_windows(
                    pi_d, T_d, E_d, self._wkeys, self._wvalid, self._soc,
                    self._row_ends(), precision=self._decode_precision(), mesh=mesh,
                )
                with trace.span("pull"):
                    g = g.cpu().numpy()
                with trace.span("split"):
                    return self._split_rows(g)
            span.rename("decode.rows")
            if self._local_data:
                raise NotImplementedError(
                    "posterior decode under host-local ingestion needs the window "
                    "gamma stream to fit the device budget "
                    "(SMCPP_TPU_ESTREAM_BYTES); raise the budget or run with "
                    "--replicated-data"
                )
            # this rank's contigs; every rank's rows gathered in rank order
            g = mesh_mod.gather_rows(mesh, hmm.decode_gammas(
                pi_d, T_d, E_d, *self._rows(), self._nbits, self._chunk,
                self._row_budget(),
            ))
            with trace.span("pull"):
                g = g.to(torch.float32).cpu().numpy()
            with trace.span("split"):
                return self._per_input_row(g)

    def _viterbi_route(self):
        """The MAP decode's route and block: ('windows', None) when the
        window backpointer stream fits the budget, ('blocked', B) when the
        backpointers recomputed per block of B windows do, else ('rows',
        None), the row-level Viterbi."""
        if self._use_windows:
            if self._window_viterbi_fits():
                return "windows", None
            L = self._wkeys.shape[1]
            block = wk.remat_block_size(L)
            eff = (block * 1.0 + 4.0 * (L // block)) / L  # int8 blk + f32 snaps
            if self._window_stream_bytes(eff) <= self._hbm_budget():
                return "blocked", block
        return "rows", None

    def map_paths(self):
        """Row-resolution MAP (Viterbi) hidden-state paths, one (L_i,) int32
        array per contig (manager.py:698-771): when the E-step runs on
        windows, the state at each row's last window through the window
        max-plus kernels (viterbi_windows), or, over the backpointer budget,
        with the backpointers recomputed per block (K5 blocked on the card).
        Otherwise (the span kernel, past both window gates, M = 1) the
        row-level Viterbi (hmm.viterbi_paths) in f64 over the packed rows; a
        split row reports the state at its last sub-row's end."""
        with trace.span("viterbi") as span:  # named once chosen, as the decode
            route, block = self._viterbi_route()
            span.rename("viterbi." + route)
            with trace.span("tensors"):
                pi, T, E = self.tensors()
            if route != "rows":
                if block is not None:
                    logger.info(
                        "window Viterbi backpointer stream over budget; "
                        "streaming per block (%d)", block,
                    )
                pi32, T32, E32 = (x.float().contiguous() for x in (pi, T, E))
                states = wk.viterbi_windows(
                    pi32, T32, E32, self._wkeys, self._wvalid, self._soc,
                    self._row_ends(), block=block, mesh=self._mesh,
                )
                with trace.span("pull"):
                    states = states.cpu().numpy()
                with trace.span("split"):
                    return [p.astype(np.int32) for p in self._split_rows(states)]
            # replicated: this rank's contigs, every rank's paths gathered;
            # host-local: every contig is this rank's, decoded on its own
            paths = mesh_mod.gather_rows(
                None if self._local_data else self._mesh,
                hmm.viterbi_paths(pi, T, E, *self._rows(), self._nbits,
                                  self._row_budget()),
            )
            with trace.span("pull"):
                paths = paths.cpu().numpy()
            with trace.span("split"):
                return [paths[i, np.cumsum(reps) - 1]
                        for i, reps in enumerate(self._row_reps)]

    def _check_finite(self, ll, stats, pi, T, E):
        """Detect NaN/Inf in the E-step outputs and dump diagnostics: the
        inputs and statistics go to an .npz in $SMCPP_TPU_DEBUG_DUMP (or the
        temp directory) and a RuntimeError names the manager (reference:
        src/hmm.cpp:35-43)."""
        bad = [
            name
            for name, v in [
                ("loglik", ll),
                ("gamma0", stats[0]),
                ("xisum", stats[1]),
                ("gamma_sums", stats[2]),
            ]
            if not np.all(np.isfinite(v))
        ]
        if not bad:
            return
        pi, T, E = (np.asarray(x.cpu()) for x in (pi, T, E))
        d = os.environ.get("SMCPP_TPU_DEBUG_DUMP") or tempfile.gettempdir()
        path = os.path.join(d, f"smcpp_tpu_torch_nan_dump_{os.getpid()}.npz")
        try:
            np.savez(
                path, pi=pi, T=T, E=E, loglik=np.asarray(ll),
                gamma0=stats[0], xisum=stats[1], gamma_sums=stats[2],
            )
        except OSError:
            path = "<dump failed>"
        for name, v in [("pi", pi), ("T", T), ("E", E)]:
            logger.error(
                "%s: shape=%s min=%g max=%g nonfinite=%d", name, v.shape,
                v.min(), v.max(), int(np.sum(~np.isfinite(v))),
            )
        raise RuntimeError(
            f"non-finite E-step output ({', '.join(bad)}) in manager "
            f"pid={self.pid}; inputs and statistics dumped to {path}. "
            "Likely causes: degenerate model parameters (check the EM log) "
            "or hidden-state intervals with ~zero occupancy."
        )


class OnePopInferenceManager(_InferenceManager):
    def __init__(
        self,
        n,
        data_list,
        hidden_states,
        pid=None,
        polarization_error=0.5,
        chunk=64,
        device="cuda",
        precision=None,
        mesh=None,
        local_data=False,
    ):
        self.n = int(n)
        self._grid = None
        self._joint = False
        mesh = _job_mesh(mesh)
        local_data = bool(local_data) and mesh is not None
        em_idx = em_mod.build_emission_index(
            _all_keys(data_list, mesh if local_data else None, ncols=3),
            self.n, na=2, polarization_error=polarization_error,
        )
        super().__init__(em_idx, data_list, hidden_states, pid, chunk, device,
                         precision, mesh, local_data)
        # the Q programs: their constants a grid and dtype, their graphs
        self._bundles = {}
        self._qg = qgraph.QGraphs(self._device)
        self._qstats = self._qstats_of = None

    # -- model and the Q family --------------------------------------------
    def set_model(self, model):
        """A one-population model, or a joint model whose marginal for this
        manager's population (``pid[0]``) it fits: that marginal and its
        grid change with the split time, so they are rebuilt per call.
        Another model object or another grid drops the Q programs'
        constants and graphs."""
        if model is not self.model:
            self._drop_programs()
        self.model = model
        self._joint = isinstance(model, SMCTwoPopulationModel)
        if self._joint:
            self._grid = None
            return
        g = grid_mod.make_time_grid(model.s, self.hidden_states)
        if self._grid is None or not np.array_equal(g.ts, self._grid.ts):
            self._grid = g
            self._drop_programs()

    def _drop_programs(self):
        self._bundles = {}
        self._qg.clear()

    def _bundle(self, grid, dtype):
        """The Q family's constants on ``grid`` in ``dtype`` (ops/qconst.py),
        made whole once a grid: no Q evaluation copies them again.  One
        that replaces another drops the graphs, which read the old arrays."""
        b = self._bundles.get(dtype)
        if b is None or b.grid is not grid:
            if b is not None:
                self._qg.clear()
            b = qconst.QConsts(grid, dtype, self._device).prime(
                self.n, self.em_idx, self.model if dtype == torch.float64 else None)
            self._bundles[dtype] = b
        return b

    def _tensors_fn(self, y, theta, rho, alpha):
        """(pi, T, E) in f64 from knot values ``y`` (..., K) and ``rho``
        (...,): the differentiable setup pipeline."""
        c = self._bundle(self._grid, torch.float64)
        a = self.model.stepwise_values_fn(y, c)
        return self._tensors_of(a, self._grid, rho, theta, alpha, c)

    def _tensors_of(self, a, grid, rho, theta, alpha, c=None):
        c = ratefunc.consts(grid, a, c)
        bl = csfs_mod.conditioned_sfs(a, grid, self.n, c)
        return _hmm_tensors(self.em_idx, a, grid, rho, bl, theta, alpha, c)

    def tensors(self):
        """(pi, T, E) at the current parameters, f64 on the manager's device
        (a graph's replay on a GPU, copied out; eager under a joint model)."""
        with torch.no_grad():
            if self._joint:
                marg = _marginal_model(self.model, self.pid[0])
                grid = grid_mod.make_time_grid(marg.s, self.hidden_states)
                return self._tensors_of(
                    self._f64(marg.stepwise_values()), grid,
                    self._f64(self.rho), self.theta, self.alpha,
                )
            th, al = self.theta, self.alpha

            def prog(y, rho):
                return self._tensors_fn(y, th, rho, al)

            return self._qg.run(("tensors", float(th), float(al)), prog,
                                (self.model.y, self.rho), copy=True)

    def Q(self, y=None, theta=None, rho=None, alpha=None):
        """Q at (possibly overridden) parameters, float: gamma0 . log pi +
        sum gs * log E + sum xisum * log T (reference HMM::Q,
        hmm.cpp:155-193).  Under a joint model, at the current parameters."""
        with trace.span("q.one"):
            if self._joint:
                return float(self._q_of(*self.tensors(), self._stats_t()))
            y, theta, rho, alpha = self._params(y, theta, rho, alpha)
            with torch.no_grad():
                pi, T, E = self._tensors_fn(self._f64(y), theta, self._f64(rho), alpha)
                return float(self._q_of(pi, T, E, self._stats_t()))

    def Q_and_grad(self, y=None, theta=None, rho=None, alpha=None):
        "(Q, dQ/dy) at (possibly overridden) parameters, by autograd."
        with trace.span("q.grad"):
            y, theta, rho, alpha = self._params(y, theta, rho, alpha)
            yt = self._f64(y).requires_grad_(True)
            pi, T, E = self._tensors_fn(yt, theta, self._f64(rho), alpha)
            q = self._q_of(pi, T, E, self._stats_t())
            (g,) = torch.autograd.grad(q, yt)
            return float(q.detach()), g.cpu().numpy()

    @property
    def supports_qbatch(self):
        "Batched Q over y and rho (not under a joint model)."
        return not self._joint

    # -- the f32 M-step (manager.py:1099-1234 of the reference package) ----
    # minimum (n+1) * n * K of the f32 programs: below it the f64 objective
    # is already cheap (the reference's constant, kept as it is)
    FAST_MSTEP_MIN_WORK = 50_000

    def mstep_work(self):
        "(n+1) * max(n, 1) * K, the size of the CSFS's largest array."
        return (self.n + 1) * max(self.n, 1) * self._grid.K

    def _use_fast_mstep(self):
        """True when the optimizer's coarse Q batches run as the f32 programs:
        not under a joint model or before a grid, never on the CPU (the f64
        objective is exact there), and from FAST_MSTEP_MIN_WORK on.  The
        choice rests on what the manager sees; the reference's
        SMCPP_TPU_FAST_MSTEP switch is not read (ROADMAP C)."""
        if self._joint or self._grid is None:
            return False
        if self._device.type == "cpu":
            return False
        return self.mstep_work() >= self.FAST_MSTEP_MIN_WORK

    def _grid32(self):
        """The grid in f32 (its terminal width clamped from BIG_T to 1e25,
        TimeGrid.astype), cached per grid."""
        if getattr(self, "_grid32_of", (None,))[0] is not self._grid:
            self._grid32_of = (self._grid, self._grid.astype(np.float32))
        return self._grid32_of[1]

    def _tensors32(self, ys, theta, rhos, alpha):
        """The f32 program: (pi, T, E) in f32 at knot values ``ys`` (..., K)
        and ``rhos`` (B,) (f64 tensors on the manager's device, or host
        arrays); pi and E follow ``ys``'s batch shape, T has ``rhos``'s.
        The spline in f64, cast to f32, then pi and E on the f32 grid with
        every product at full f32.  T is the f64 transition rounded to f32:
        its diagonal, 1 - O(1e-3), carries nearly all of xisum's mass, and
        built in f32 (as the reference does) it came out about 13 ulp off,
        which on fitted statistics took a coarse batch to 0.93 of the f32
        bar with another argmax; rounded it is 1 ulp off.  T's work does
        not grow with n."""
        ys, rhos_t = (x if torch.is_tensor(x) else self._f64(x) for x in (ys, rhos))
        grid32 = self._grid32()
        c64 = self._bundle(self._grid, torch.float64)
        c32 = self._bundle(grid32, torch.float32)
        with torch.no_grad(), exact_f32():
            a = self.model.stepwise_values_fn(ys, c64)
            T = transition.transition_matrix(
                a.expand(*rhos_t.shape, a.shape[-1]), rhos_t, self._grid, c64)
            a32 = a.float()
            bl = csfs_mod.conditioned_sfs(a32, grid32, self.n, c32)
            pi, E = _pi_and_e(self.em_idx, a32, grid32, bl, float(theta),
                              float(alpha), c32)
        return pi, T.float(), E

    def _q_budget(self):
        """Bytes one chunk of a Q batch may take: Q_MEM_FRAC of the card's
        memory, 6 GB on the CPU (the host budget of ``_hbm_budget``)."""
        if self._device.type != "cuda":
            return 6e9
        _free, total = torch.cuda.mem_get_info(self._device)
        return Q_MEM_FRAC * float(total)

    def q_chunk(self, f32=False):
        "Candidates of one chunk of a Q batch (``q_chunk_rows``)."
        return q_chunk_rows(self.n, self._grid.K, self.em_idx.n_keys,
                            self._grid.M, 4 if f32 else 8, self._q_budget())

    def Q_batch(self, ys=None, rhos=None, theta=None, alpha=None,
                fast_ok=False):
        """Q at a batch of candidate parameters, evaluated with a leading
        batch dimension (the reference vmaps).  ``ys``: (B, K) candidate y
        rows (default: current y), and/or ``rhos``: (B,) candidate
        recombination rates (default: current rho).  With ``fast_ok`` (the
        optimizer's coarse bracketing batches) and ``_use_fast_mstep()`` the
        f32 programs evaluate it; every other batch is f64.  The batch is
        cut into chunks by ``q_chunk``.  Returns a (B,) float array."""
        if ys is None and rhos is None:
            raise ValueError("Q_batch needs ys and/or rhos")
        fast = fast_ok and self._use_fast_mstep()
        with trace.span("q.batch32" if fast else "q.batch64"):
            y0, th, rho0, al = self._params(None, theta, None, alpha)
            if ys is None:
                return self.q_rho_batch(np.asarray(rhos, np.float64), th, al,
                                        f32=fast)
            ysb = np.asarray(ys, np.float64)
            B = len(ysb)
            rhob = np.full(B, rho0) if rhos is None else np.asarray(rhos, np.float64)
            out = np.empty(B)
            stats = self._q_stats()
            step = self.q_chunk(fast)

            def prog(ys, rhos):
                with torch.no_grad():
                    if fast:
                        pi, T, E = self._tensors32(ys, th, rhos, al)
                    else:
                        pi, T, E = self._tensors_fn(ys, th, rhos, al)
                    return self._q_of(pi, T, E, stats)

            for i in range(0, B, step):
                j = min(B, i + step)
                key = ("batch32" if fast else "batch64", j - i, float(th), float(al))
                out[i:j] = self._qg.run(key, prog, (ysb[i:j], rhob[i:j])).cpu().numpy()
        if fast:
            Q_BATCH32.launches += 1
        return out

    def q_rho_batch(self, rhos, theta=None, alpha=None, f32=False):
        """Q over candidate rhos at the current y: rho only enters T, so the
        CSFS / emission setup runs once and each candidate costs one M x M
        transition build (reference: the dirty-flag graph recomputes only
        the transition on setRho, inference_manager.cpp:213-229); with
        ``f32``, the f32 program."""
        with trace.span("q.rho32" if f32 else "q.rho64"):
            y0, th, _, al = self._params(None, theta, None, alpha)
            gamma0, xisum, gamma_sums = self._q_stats()

            def prog(y, rhos_t):
                with torch.no_grad():
                    if f32:
                        pi, T, E = self._tensors32(y, th, rhos_t, al)
                    else:
                        g, c = self._grid, self._bundle(self._grid, torch.float64)
                        a = self.model.stepwise_values_fn(y, c)
                        bl = csfs_mod.conditioned_sfs(a, g, self.n, c)
                        pi, E = _pi_and_e(self.em_idx, a, g, bl, th, al, c)
                        T = transition.transition_matrix(
                            a.expand(len(rhos_t), -1), rhos_t, g, c)
                    base = torch.sum(gamma0 * torch.log(pi)) + torch.sum(
                        gamma_sums * torch.log(E)
                    )
                    return base + torch.sum(xisum * torch.log(T), (-2, -1))

            key = ("rho32" if f32 else "rho64", len(rhos), float(th), float(al))
            out = self._qg.run(key, prog, (y0, np.asarray(rhos, np.float64))).cpu().numpy()
        if f32:
            Q_RHO32.launches += 1
        return out

    def _q_stats(self):
        """The E-statistics as f64 tensors in the manager's own buffers,
        refreshed when an E-step replaced them: what the Q programs read,
        so a captured program reads the newest (``_stats_t`` makes new
        tensors each E-step)."""
        if self._qstats_of is not self._stats:
            src = self._stats_t()
            if self._qstats is None:
                self._qstats = tuple(torch.empty_like(s) for s in src)
            for d, s in zip(self._qstats, src):
                d.copy_(s)
            self._qstats_of = self._stats
        return self._qstats

    def _params(self, y, theta, rho, alpha):
        return (
            np.asarray(self.model.y if y is None else y, np.float64),
            self.theta if theta is None else theta,
            self.rho if rho is None else rho,
            self.alpha if alpha is None else alpha,
        )

    def marginal_split_objective(self):
        """Q(split) for the pop-2 *marginal* of a joint model
        (ops/split_objective.py:MarginalSplitObjective), rebuilt when the
        model object or the E-statistics change; the pop-1 marginal has no
        split dependence."""
        from ..ops.split_objective import MarginalSplitObjective

        key = (id(self.model), id(self._stats), self.theta, self.alpha)
        if getattr(self, "_msplit_obj_key", None) != key:
            self._msplit_obj = MarginalSplitObjective(self, self.model)
            self._msplit_obj_key = key
        return self._msplit_obj


class TwoPopInferenceManager(_InferenceManager):
    """Two-population inference manager: joint-CSFS emissions over (a1, b1,
    a2, b2) keys, the distinguished model's transition and initial
    distribution (reference: src/inference_manager.cpp:525-550 and
    src/jcsfs.cpp).  ``tensors()`` builds (pi, T, E) in f64 on the
    manager's device: through the joint CSFS of ops/jcsfs_traced.py when
    both marginals are spline models (the route the reference package
    takes by default), else through the host JCSFS of ops/jcsfs.py."""

    def __init__(
        self,
        n1,
        n2,
        a1,
        a2,
        data_list,
        hidden_states,
        pid,
        polarization_error=0.5,
        chunk=64,
        K=10,
        device="cuda",
        precision=None,
        mesh=None,
        local_data=False,
    ):
        from ..ops.jcsfs import JointCSFS

        if not (a1 + a2 == 2 and a1 in (1, 2)):
            raise ValueError(
                f"two distinguished lineages, in pop 1 or one in each: got "
                f"(a1, a2) = ({a1}, {a2})"
            )
        self.n1, self.n2, self.a1, self.a2 = int(n1), int(n2), int(a1), int(a2)
        self.n = (self.n1, self.n2)
        mesh = _job_mesh(mesh)
        local_data = bool(local_data) and mesh is not None
        em_idx = em_mod.build_emission_index_2pop(
            _all_keys(data_list, mesh if local_data else None, ncols=6),
            self.n, (self.a1, self.a2), polarization_error,
        )
        super().__init__(em_idx, data_list, hidden_states, pid, chunk, device,
                         precision, mesh, local_data)
        self._jcsfs = JointCSFS(
            self.n1, self.n2, self.a1, self.a2, self.hidden_states, K=K
        )
        self._tensors_cache = (None, None)
        self._splice_memo = None
        self._traced_cache = {}

    def set_model(self, model):
        self.model = model

    def tensors(self):
        """(pi, T, E) at the current parameters, f64 on the manager's device.
        One entry is cached per (model parameters, split, theta, rho,
        alpha), so the posterior's repeated calls reuse it; each uncached
        call counts in ``TENSORS.launches``."""
        model = self.model
        key = (json.dumps(model.to_dict(), sort_keys=True), self.theta,
               self.rho, self.alpha)
        if self._tensors_cache[0] == key:
            return self._tensors_cache[1]
        with trace.span("tensors2"), torch.no_grad():
            out = (self._tensors_traced() if self._traced_tensors_ok()
                   else self._tensors_eager())
        TENSORS.launches += 1
        self._tensors_cache = (key, out)
        return out

    def _traced_tensors_ok(self):
        """The joint CSFS of ops/jcsfs_traced.py needs spline marginals (their
        static piece grids); the route follows the model alone."""
        from ..models import SMCModel

        m = self.model
        return (
            isinstance(m, SMCTwoPopulationModel)
            and isinstance(m.model1, SMCModel)
            and isinstance(m.model2, SMCModel)
        )

    def _tensors_traced(self):
        """(pi, T, E) through ``TracedJointCSFS`` on the manager's device.

        The pop-2 marginal is the reference's for_pop splice (model2 below
        the split, model1 above, re-fit through a spline); its knots move
        with the split, so its stepwise values are evaluated on the host,
        memoised on (y1, y2, split), and passed as a size vector on the
        splice's own piece grid.  One ``TracedJointCSFS`` (its constants on
        the device) is kept per static key, so a split search or a change
        of y builds nothing.  pi, T and the average coalescence times come
        from model1's grid when the distinguished pair is together, from
        ``apart_grid_hs`` (APART_FIN below the split) when apart."""
        from ..ops import jcsfs_traced as jt

        model = self.model
        m1 = model.model1
        sk = (m1.y.tobytes(), model.model2.y.tobytes(), float(model.split))
        if self._splice_memo is None or self._splice_memo[0] != sk:
            m2s = _marginal_model(model, model.pids[1])
            self._splice_memo = (sk, m2s, np.asarray(m2s.stepwise_values(),
                                                     np.float64))
        _, m2s, m2s_vals = self._splice_memo
        key = (m1.s.tobytes(), m2s.s.tobytes(), self.hidden_states.tobytes(),
               self.theta, self.alpha, m1._spline_name, len(m1.y))
        entry = self._traced_cache.get(key)
        if entry is None:
            tj = jt.TracedJointCSFS(
                self.n1, self.n2, self.a1, self.a2, m1.s, m2s.s,
                self.hidden_states, K=self._jcsfs.K, device=self._device,
            )
            entry = self._traced_cache[key] = (
                tj, grid_mod.make_time_grid(m1.s, self.hidden_states))
        tj, grid1 = entry
        split = float(model.split)
        a1v = m1.stepwise_values_fn(self._f64(m1.y))
        J = tj.compute(a1v, self._f64(m2s_vals), split)
        if self.a1 == 2:
            a, grid = a1v, grid1
        else:
            a, grid = jt.apart_grid_hs(a1v, tj.part1, split, self.hidden_states)
        return _hmm_tensors(self.em_idx, a, grid, self._f64(self.rho), J,
                            self.theta, self.alpha)

    def _tensors_eager(self):
        """(pi, T, E) through the host JCSFS (ops/jcsfs.py, NumPy f64), then
        the distinguished marginal's pi and T, theta and the emission index
        on the device: the route for marginals that are not spline
        models."""
        from ..ops.jcsfs_traced import APART_FIN

        model = self.model
        # the distinguished lineages apart (a1 = a2 = 1): the model with an
        # infinite size before the split
        dm = _marginal_model(model, None if self.a1 == 1 else model.pids[0])
        a = np.asarray(dm.stepwise_values(), dtype=np.float64)
        m1 = _marginal_model(model, model.pids[0])
        m2 = _marginal_model(model, model.pids[1])
        J = self._jcsfs.compute(
            (np.asarray(m1.stepwise_values(), dtype=np.float64), m1.s),
            (np.asarray(m2.stepwise_values(), dtype=np.float64), m2.s),
            model.split,
        )  # (M, a1+1, D)
        a_fin = np.where(np.isinf(a), APART_FIN, a)
        grid = grid_mod.make_time_grid(dm.s, self.hidden_states)
        return _hmm_tensors(
            self.em_idx, self._f64(a_fin), grid, self._f64(self.rho),
            self._f64(J), self.theta, self.alpha,
        )

    def Q(self, **kw):
        "Q at the current parameters (the split is the only free one)."
        return float(self._q_of(*self.tensors(), self._stats_t()))

    def split_objective(self):
        """Batched, differentiable Q(split) (ops/split_objective.py),
        rebuilt when the model object or the E-statistics change."""
        from ..ops.split_objective import SplitObjective

        key = (id(self.model), id(self._stats), self.theta, self.alpha)
        if getattr(self, "_split_obj_key", None) != key:
            self._split_obj = SplitObjective(self)
            self._split_obj_key = key
        return self._split_obj


def make_manager(n, a, data_list, hidden_states, pid, polarization_error,
                 device="cuda", precision=None, local_data=False):
    """The manager for data of sample sizes ``n`` and distinguished lineages
    ``a`` per population: one population, or two (a joint pid).  Under a
    process group it shards over the group; ``local_data``: ``data_list``
    is this rank's shard (host-local ingestion)."""
    if len(n) == 1:
        return OnePopInferenceManager(
            n[0], data_list, hidden_states, pid, polarization_error,
            device=device, precision=precision, local_data=local_data,
        )
    return TwoPopInferenceManager(
        n[0], n[1], a[0], a[1], data_list, hidden_states, pid,
        polarization_error, device=device, precision=precision,
        local_data=local_data,
    )
