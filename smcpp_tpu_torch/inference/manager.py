"""One-population inference manager, in torch.

Port of ``OnePopInferenceManager`` of smcpp_tpu/inference/manager.py
(which replaces the reference's C++ InferenceManager,
SMC++ src/inference_manager.cpp):

* the E-step: the window kernel (ops/window_kernel.py:estep_direct) on the
  manager's device, float32, with the CUDA kernels on a GPU;
* the M-step objective: the float64 Q family (pi, T, E -> Q) with autograd
  for dQ/dy and a leading batch dimension for ``Q_batch``, on the same
  device.  The E-statistics are constants in Q (src/hmm.cpp:155-193);
* the posterior decode (``save_gamma`` / ``gammas``) and the MAP paths
  (``map_paths``) through the window kernels, single device;
* the span kernel (ops/hmm.py) where the cost model picks it, and the
  row-level decode and Viterbi past the window gates and at M = 1.

Everything runs on the ``device`` the manager was built with.  Asking for
CUDA where there is none raises; nothing falls back to the CPU.
"""

import logging
import os
import tempfile

import numpy as np
import torch

from ..ops import csfs as csfs_mod
from ..ops import emission as em_mod
from ..ops import grid as grid_mod
from ..ops import hmm
from ..ops import ratefunc, transition
from ..ops import window_kernel as wk

logger = logging.getLogger(__name__)

# E-step precision ladder.  The rung sets the storage dtype of the window
# kernels' carries (ops/window_kernel.py:carry_dtype): bf16 at 'default',
# f32 above; the arithmetic is exact f32 on every rung.  The optimizer
# climbs one rung when the likelihood decreases beyond tolerance.
PRECISION_LADDER = ("default", "tensorfloat32", "highest")
_PRECISION_ALIASES = {"bfloat16": "default", "float32": "highest"}

# Rows of one batched Q evaluation: bounds the (B, n+1, n, K) intermediates
# of the CSFS "above" integrals.
Q_CHUNK = 64


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


class OnePopInferenceManager:
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
    ):
        self.n = int(n)
        self.pid = pid
        self._precision = precision
        self.hidden_states = np.asarray(hidden_states, dtype=np.float64)
        self._device = resolve_device(device)

        all_keys = np.unique(
            np.concatenate([d[:, 1:] for d in data_list], axis=0), axis=0
        )
        self.em_idx = em_mod.build_emission_index(
            all_keys, self.n, na=2, polarization_error=polarization_error
        )
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
        self._nbits = max(1, max_span.bit_length())
        self._init_kernel_choice(data_list, spans)

        # mutable parameters
        self.model = None
        self.theta = None
        self.rho = None
        self.alpha = 1
        self._grid = None
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
        self._use_windows = window_cost < span_cost
        logger.debug(
            "IM(pid=%s): %d contigs, padded L=%d, %d keys, nbits=%d, "
            "kernel=%s, device=%s",
            self.pid, spans.shape[0], spans.shape[1], self.em_idx.n_keys,
            self._nbits, "window" if self._use_windows else "span",
            self._device,
        )
        if not self._use_windows:
            self._rows()
            return
        wkeys, wvalid, soc = wk.pack_windows(data_list, self.em_idx.key_id())
        wk.check_key_range(wkeys, self.em_idx.n_keys)
        self._wkeys = torch.as_tensor(wkeys, device=self._device)
        self._wvalid = torch.as_tensor(wvalid, device=self._device)
        self._soc = soc
        # row spans per contig, for the window decode's row ends
        self._wrow_spans = [d[:, 0].astype(np.int64) for d in data_list]

    def _rows(self):
        "The packed rows (spans, keys) as (C, L) int32 tensors on the device."
        if self._rows_d is None:
            self._rows_d = tuple(torch.as_tensor(x, device=self._device)
                                 for x in (self._spans, self._keys))
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
        "Bytes of a (windows x M) stream at bytes_per_state per element."
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
        (manager.py:_build_estep_fn): the alpha stream (carry dtype, 2 or 4
        B/window/M) must fit the budget.  Over budget the reference switches
        to alpha remat, which is not ported yet: this raises.  The emission
        stream is never needed here (the kernels gather emission rows)."""
        if not self._use_windows:
            return
        ab = torch.finfo(wk.carry_dtype(self.precision, torch.float32)).bits // 8
        need = self._window_stream_bytes(ab)
        budget = self._hbm_budget()
        if need > budget:
            raise NotImplementedError(
                f"the alpha stream ({need / 1e9:.1f} GB) is over the device "
                f"budget ({budget / 1e9:.1f} GB) and alpha remat is not "
                "ported yet (ROADMAP B3)"
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

    # -- model and the Q family --------------------------------------------
    def set_model(self, model):
        self.model = model
        g = grid_mod.make_time_grid(model.s, self.hidden_states)
        if self._grid is None or not np.array_equal(g.ts, self._grid.ts):
            self._grid = g

    def _f64(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), device=self._device)

    def _tensors_fn(self, y, theta, rho, alpha):
        """(pi, T, E) in f64 from knot values ``y`` (..., K) and ``rho``
        (...,): the differentiable setup pipeline."""
        grid, n = self._grid, self.n
        a = self.model.stepwise_values_fn(y)
        pi = ratefunc.initial_distribution(a, grid)
        T = transition.transition_matrix(a, rho, grid)
        em = csfs_mod.incorporate_theta(csfs_mod.conditioned_sfs(a, grid, n), theta)
        e2 = em_mod.e2_matrix(ratefunc.average_coal_times(a, grid), theta, alpha)
        E = em_mod.emission_matrix(self.em_idx, em, e2)
        return pi, T, E

    def tensors(self):
        "(pi, T, E) at the current parameters, f64 on the manager's device."
        with torch.no_grad():
            return self._tensors_fn(
                self._f64(self.model.y), self.theta, self._f64(self.rho),
                self.alpha,
            )

    def _stats_t(self):
        "The E-statistics as f64 tensors on the device (cached per E-step)."
        if self._stats_dev is None or self._stats_dev[0] is not self._stats:
            self._stats_dev = (self._stats, tuple(self._f64(s) for s in self._stats))
        return self._stats_dev[1]

    @staticmethod
    def _q_of(pi, T, E, stats):
        gamma0, xisum, gamma_sums = stats
        return (
            torch.sum(gamma0 * torch.log(pi), -1)
            + torch.sum(gamma_sums * torch.log(E), (-2, -1))
            + torch.sum(xisum * torch.log(T), (-2, -1))
        )

    def Q(self, y=None, theta=None, rho=None, alpha=None):
        """Q at (possibly overridden) parameters, float: gamma0 . log pi +
        sum gs * log E + sum xisum * log T (reference HMM::Q,
        hmm.cpp:155-193)."""
        y, theta, rho, alpha = self._params(y, theta, rho, alpha)
        with torch.no_grad():
            pi, T, E = self._tensors_fn(self._f64(y), theta, self._f64(rho), alpha)
            return float(self._q_of(pi, T, E, self._stats_t()))

    def Q_and_grad(self, y=None, theta=None, rho=None, alpha=None):
        "(Q, dQ/dy) at (possibly overridden) parameters, by autograd."
        y, theta, rho, alpha = self._params(y, theta, rho, alpha)
        yt = self._f64(y).requires_grad_(True)
        pi, T, E = self._tensors_fn(yt, theta, self._f64(rho), alpha)
        q = self._q_of(pi, T, E, self._stats_t())
        (g,) = torch.autograd.grad(q, yt)
        return float(q.detach()), g.cpu().numpy()

    @property
    def supports_qbatch(self):
        return True

    def Q_batch(self, ys=None, rhos=None, theta=None, alpha=None,
                fast_ok=False):
        """Q at a batch of candidate parameters, evaluated with a leading
        batch dimension (the reference vmaps).  ``ys``: (B, K) candidate y
        rows (default: current y), and/or ``rhos``: (B,) candidate
        recombination rates (default: current rho).  ``fast_ok`` is accepted
        for the optimizer's interface; the port always evaluates in f64.
        Returns a (B,) float array."""
        if ys is None and rhos is None:
            raise ValueError("Q_batch needs ys and/or rhos")
        y0, th, rho0, al = self._params(None, theta, None, alpha)
        if ys is None:
            return self.q_rho_batch(np.asarray(rhos, np.float64), th, al)
        ysb = np.asarray(ys, np.float64)
        B = len(ysb)
        rhob = np.full(B, rho0) if rhos is None else np.asarray(rhos, np.float64)
        out = np.empty(B)
        stats = self._stats_t()
        with torch.no_grad():
            for i in range(0, B, Q_CHUNK):
                j = min(B, i + Q_CHUNK)
                pi, T, E = self._tensors_fn(
                    self._f64(ysb[i:j]), th, self._f64(rhob[i:j]), al
                )
                out[i:j] = self._q_of(pi, T, E, stats).cpu().numpy()
        return out

    def q_rho_batch(self, rhos, theta=None, alpha=None):
        """Q over candidate rhos at the current y: rho only enters T, so the
        CSFS / emission setup runs once and each candidate costs one M x M
        transition build (reference: the dirty-flag graph recomputes only
        the transition on setRho, inference_manager.cpp:213-229)."""
        y0, th, _, al = self._params(None, theta, None, alpha)
        grid, n = self._grid, self.n
        gamma0, xisum, gamma_sums = self._stats_t()
        with torch.no_grad():
            a = self.model.stepwise_values_fn(self._f64(y0))
            pi = ratefunc.initial_distribution(a, grid)
            em = csfs_mod.incorporate_theta(csfs_mod.conditioned_sfs(a, grid, n), th)
            e2 = em_mod.e2_matrix(ratefunc.average_coal_times(a, grid), th, al)
            E = em_mod.emission_matrix(self.em_idx, em, e2)
            base = torch.sum(gamma0 * torch.log(pi)) + torch.sum(
                gamma_sums * torch.log(E)
            )
            rhos_t = self._f64(rhos)
            T = transition.transition_matrix(a.expand(len(rhos_t), -1), rhos_t, grid)
            return (base + torch.sum(xisum * torch.log(T), (-2, -1))).cpu().numpy()

    def _params(self, y, theta, rho, alpha):
        return (
            np.asarray(self.model.y if y is None else y, np.float64),
            self.theta if theta is None else theta,
            self.rho if rho is None else rho,
            self.alpha if alpha is None else alpha,
        )

    # -- E-step ------------------------------------------------------------
    def E_step(self):
        if len(self.hidden_states) == 2:
            ll = self._estep_m1()
            if self.save_gamma:
                self.gammas = self._gammas_m1()
            return ll
        pi, T, E = self.tensors()
        pi_d, T_d, E_d = (x.float().contiguous() for x in (pi, T, E))
        if self._use_windows:
            ll, gamma0, xisum, gamma_sums = wk.estep_direct(
                pi_d, T_d, E_d, self._wkeys, self._wvalid, self._soc,
                precision=self.precision,
            )
        else:
            ll, gamma0, xisum, gamma_sums = hmm.estep(
                pi_d, T_d, E_d, *self._rows(), self._nbits, self._chunk,
                self._row_budget(),
            )
        self._ll = float(ll)
        self._stats = tuple(
            x.detach().to(torch.float64).cpu().numpy()
            for x in (gamma0, xisum, gamma_sums)
        )
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
        "Flat segment-major index of every row's last window, on the device."
        if getattr(self, "_wrow_ends", None) is None:
            ends = wk.pack_window_row_ends(
                self._wrow_spans, self._wkeys.shape[1], self._soc
            )
            self._wrow_ends = torch.as_tensor(ends, device=self._device)
        return self._wrow_ends

    def _split_rows(self, rows):
        "Cut a (n_rows, ...) host array into one array per contig."
        out, off = [], 0
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
        if self._use_windows and self._window_decode_fits():
            _, g = wk.decode_gammas_windows(
                pi_d, T_d, E_d, self._wkeys, self._wvalid, self._soc,
                self._row_ends(), precision=self._decode_precision(),
            )
            return self._split_rows(g.cpu().numpy())
        g = hmm.decode_gammas(pi_d, T_d, E_d, *self._rows(), self._nbits,
                              self._chunk, self._row_budget())
        return self._per_input_row(g.to(torch.float32).cpu().numpy())

    def _window_map_paths(self, pi, T, E, block=None):
        """MAP paths through the window max-plus kernels (viterbi_windows);
        ``block`` streams the phase-C backpointers per block."""
        states = wk.viterbi_windows(
            pi, T, E, self._wkeys, self._wvalid, self._soc, self._row_ends(),
            block=block,
        )
        return [p.astype(np.int32) for p in self._split_rows(states.cpu().numpy())]

    def map_paths(self):
        """Row-resolution MAP (Viterbi) hidden-state paths, one (L_i,) int32
        array per contig (manager.py:698-771): when the E-step runs on
        windows, the state at each row's last window through the window
        max-plus kernels, or, over the backpointer budget, with the
        backpointers streamed per block (plain version only here; on CUDA it
        raises, ROADMAP B6).  Otherwise (the span kernel, past both window
        gates, M = 1) the row-level Viterbi (hmm.viterbi_paths) in f64 over
        the packed rows; a split row reports the state at its last
        sub-row's end."""
        pi, T, E = self.tensors()
        if self._use_windows:
            pi32, T32, E32 = (x.float().contiguous() for x in (pi, T, E))
            if self._window_viterbi_fits():
                return self._window_map_paths(pi32, T32, E32)
            L = self._wkeys.shape[1]
            block = wk.remat_block_size(L)
            eff = (block * 1.0 + 4.0 * (L // block)) / L  # int8 blk + f32 snaps
            if self._window_stream_bytes(eff) <= self._hbm_budget():
                logger.info(
                    "window Viterbi backpointer stream over budget; "
                    "streaming per block (%d)", block,
                )
                return self._window_map_paths(pi32, T32, E32, block=block)
        paths = hmm.viterbi_paths(pi, T, E, *self._rows(), self._nbits,
                                  self._row_budget()).cpu().numpy()
        return [paths[i, np.cumsum(reps) - 1] for i, reps in enumerate(self._row_reps)]

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
