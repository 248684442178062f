"""The two-population emission tensor as one device function of the
marginal sizes and the split time.

Port of smcpp_tpu/ops/jcsfs_traced.py.  The eager joint CSFS
(ops/jcsfs.py) runs NumPy loops over each hidden interval on the host,
because ``shift_params`` / ``truncate_params`` change array lengths and each
interval branches on its position against the split (below, straddling,
above).  Here every shape is fixed by the static piece grids and hidden
states, and the whole tensor is float64 torch on one device:

* **Dual-slot grids.**  Every piece of the merged partition of {model piece
  boundaries} u {hidden states} is split into a below-split slot and an
  above-split slot, of widths ``clip(min(hi, split) - lo, 0)`` and
  ``clip(hi - max(lo, split), 0)``.  Clipping at the split keeps the order
  of the merged boundaries, so node indices, ``src`` maps and hidden-state
  indices are static and only the widths move with the split.  Truncation
  at the split: below slots keep the model size, above slots are empty and
  a crash piece (CRASH_A) follows; a shift to the split: below slots are
  empty; the "apart" model: below slots at APART_FIN.  The split is a
  concrete float at call time, so the widths are host NumPy arrays and the
  grids are ordinary ``TimeGrid`` objects; the size vectors are device
  tensors.  The tjj integrals (ops/ratefunc.py) mask empty pieces.
* **Unified straddle weights.**  With ``ex_m = exp(-R1(hs_m))`` the
  above-split share of interval m is
  ``w_m = clip((exp(-R1(split)) - ex_{m+1}) / (ex_m - ex_{m+1}), 0, 1)``:
  0 below the split, 1 above, the reference's straddle weight in between
  (jcsfs.cpp:370-420).  Intervals on the wrong side of the split give
  empty conditioning windows whose CSFS rows (finite garbage or NaN) are
  dropped by masks before any product reads them.
* **Batched conditioning.**  The M per-interval truncated and shifted CSFS
  evaluations are single ``conditioned_sfs`` calls on the dual grids, and
  the Gauss-Legendre transports batch over (M, K) with the Moran
  eigensystems held as device constants.

Two deviations from the eager path, both held in
tests/test_torch_jcsfs_traced.py: the below-at-split CSFS takes the exact
eps -> 0 closed form (``_tb0_traced``, as ops/split_objective.py does)
where the eager path takes a two-sided 1e-6 interval; and pop 2 below the
split reads the caller's size vector on its own piece grid (the manager
passes the for_pop splice's values, as the eager path uses).

Reference: SMC++ src/jcsfs.cpp (pre_compute_together :370-420, helpers
:89-216, pre_compute_apart :257-367), documented twin smcpp/jcsfs.py.
"""

import numpy as np
import torch

from .. import defaults
from . import exact
from .csfs import conditioned_sfs
from .grid import TimeGrid, make_time_grid
from .jcsfs import JointCSFS, _modified, _moran
from .split_objective import (
    CRASH_A,
    _Expm,
    _leggauss01,
    _tb0_integrals,
    _undist_matrix,
)

# Finite stand-in for the apart model's infinite pre-split size: 1e12 leaves
# < 1e-12 spurious coalescent mass over any O(1) interval, while 1e300
# overflows the closed-form 3x3 expm at M > 1 (NaN transition rows).
APART_FIN = 1e12

_F64 = torch.float64


# ---------------------------------------------------------------------------
# static partition and dual-slot grids
# ---------------------------------------------------------------------------

class _Part:
    """Static merged partition of model piece boundaries and hidden states
    (host NumPy, computed once per cache key)."""

    def __init__(self, s, hidden_states):
        g = make_time_grid(s, hidden_states)
        self.K = g.K
        self.lo = g.ts[:-1].copy()
        # cap the terminal inf boundary so clip arithmetic stays finite
        hi = g.ts[1:].copy()
        hi[-1] = np.finfo(np.float64).max
        self.hi = hi
        self.src = g.src
        self.hs_indices = g.hs_indices
        self.hidden_states = np.asarray(g.hidden_states, np.float64)


def _interleave(x, y):
    "(K,), (K,) -> (2K,) alternating x0, y0, x1, y1, ...; NumPy or torch."
    if torch.is_tensor(x):
        return torch.stack([x, y], 1).reshape(-1)
    return np.stack([x, y], 1).reshape(-1)


def _grid_from(dt, src, hs_idx, hidden_states):
    "A TimeGrid of the host widths ``dt``; ts is their running sum."
    return TimeGrid(
        ts=np.concatenate([[0.0], np.cumsum(dt)]), dt=dt, src=src,
        hs_indices=hs_idx, hidden_states=hidden_states,
    )


def _pieces(part, a_model):
    "The model sizes on the partition's pieces."
    return a_model[torch.as_tensor(part.src, device=a_model.device)]


def trunc_dual(part: _Part, a_model, split, include_crash):
    """Dual grid of the model truncated at ``split``.

    Below slots keep the model size over ``clip(min(hi, split) - lo, 0)``;
    above slots are empty (node times become ``min(t, split)``); a crash
    piece (CRASH_A, BIG_T) follows.  ``include_crash`` puts the crash region
    inside the terminal hidden interval (the eager [0, inf] conditioning of
    a truncated model, where lineages surviving to the split coalesce in
    the crash), against ending the hidden window at the split (per-interval
    conditioning bounded by min(hs, split))."""
    w_b = np.clip(np.minimum(part.hi, split) - part.lo, 0.0, None)
    K = part.K
    dt = np.concatenate([_interleave(w_b, np.zeros_like(w_b)),
                         [defaults.BIG_T]])
    a_pieces = _pieces(part, a_model)
    crash = torch.full_like(a_pieces, CRASH_A)
    a_dual = torch.cat([_interleave(a_pieces, crash), crash[:1]])
    hs_idx = 2 * part.hs_indices
    if include_crash:
        hs_idx[-1] = 2 * K + 1
    grid = _grid_from(dt, np.arange(2 * K + 1, dtype=np.int64), hs_idx,
                      part.hidden_states)
    return a_dual, grid


def shift_dual(part: _Part, a_model, split):
    """Dual grid of the model shifted to start at ``split``: below slots
    empty, above slots ``clip(hi - max(lo, split), 0)``; node times become
    ``max(t - split, 0)``, so hidden boundary m sits at
    ``max(hs_m - split, 0)`` at its static node index."""
    w_a = np.clip(part.hi - np.maximum(part.lo, split), 0.0, None)
    w_a[-1] = defaults.BIG_T
    dt = _interleave(np.zeros_like(w_a), w_a)
    a_pieces = _pieces(part, a_model)
    grid = _grid_from(dt, np.arange(2 * part.K, dtype=np.int64),
                      2 * part.hs_indices, part.hidden_states)
    return _interleave(a_pieces, a_pieces), grid


def apart_grid_hs(a_model, part: _Part, split, hidden_states):
    """Dual grid of the 'apart' distinguished model (APART_FIN below the
    split, the model's sizes above) with the hidden states at static node
    indices: the apart model's pi, transition and average coalescence
    times (real time axis).  ``hidden_states`` must equal the ones
    ``part`` was built with."""
    del hidden_states  # part carries them; kept for call-site clarity
    w_b = np.clip(np.minimum(part.hi, split) - part.lo, 0.0, None)
    w_a = np.clip(part.hi - np.maximum(part.lo, split), 0.0, None)
    w_a[-1] = defaults.BIG_T
    dt = _interleave(w_b, w_a)
    a_pieces = _pieces(part, a_model)
    a_dual = _interleave(torch.full_like(a_pieces, APART_FIN), a_pieces)
    grid = _grid_from(dt, np.arange(2 * part.K, dtype=np.int64),
                      2 * part.hs_indices, part.hidden_states)
    return a_dual, grid


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

class _TracedEta:
    """Static piece widths, device sizes ``a``; R at host times (the piece of
    a time is found on the host, the value computed on the device).  Its
    ``lo``, ``hi``, ``ada_t`` and ``Rrng_t`` are those of
    split_objective._StaticEta, so ``_tb0_integrals`` reads it."""

    def __init__(self, a, s):
        self.a = a
        s = np.asarray(s, np.float64)
        self.cs = np.concatenate([[0.0], np.cumsum(s)])
        self.cs[-1] = np.inf
        f = lambda x: torch.as_tensor(x, dtype=a.dtype, device=a.device)  # noqa: E731
        self.lo = f(self.cs[:-1])
        self.hi = f(np.where(np.isinf(self.cs[1:]), np.finfo(np.float64).max,
                             self.cs[1:]))
        self.ada_t = 1.0 / a
        self.Rrng_t = torch.cat([
            a.new_zeros(1),
            torch.cumsum(self.ada_t[:-1] * f(np.diff(self.cs[:-1])), 0),
        ])

    def R(self, t):
        "R at the host time(s) ``t`` (float or array) -> device tensor."
        t = np.asarray(t, np.float64)
        ip = np.clip(np.searchsorted(self.cs, t, side="right") - 1,
                     0, len(self.a) - 1)
        ipt = torch.as_tensor(ip, device=self.a.device)
        dt = torch.as_tensor(t - self.cs[ip], dtype=self.a.dtype,
                             device=self.a.device)
        return self.Rrng_t[ipt] + self.ada_t[ipt] * dt


def _expm_at(eig: _Expm, ts):
    "U exp(D t) Uinv at device times of any shape (...,) -> (..., N, N)."
    return eig(ts)


def _tb0_traced(eta: _TracedEta, split, n):
    """Closed-form ``int_0^split exp(-rate_j R(t)) dt`` (n+1,), rate_j =
    C(j,2)-1: the exact eps -> 0 below-at-split limit, as the split
    objective takes it."""
    return _tb0_integrals(eta, eta.a.new_tensor(split), n)


# ---------------------------------------------------------------------------
# the joint CSFS
# ---------------------------------------------------------------------------

class TracedJointCSFS:
    """J[m] (a1+1, (n1+1)(a2+1)(n2+1)) for all M hidden intervals as one
    float64 function of (a1 sizes, a2 sizes, split) on ``device``.

    Fixed at construction: both marginal piece grids (s1, s2), the hidden
    states, the sample configuration, the hypergeometric kernels, the Moran
    eigensystems and the quadrature rule, all as device constants.  Given
    at call time: the marginal stepwise size vectors and the split."""

    def __init__(self, n1, n2, a1, a2, s1, s2, hidden_states, K=10,
                 device="cuda"):
        assert a1 + a2 == 2 and a1 in (1, 2) and a2 in (0, 1)
        self.n1, self.n2, self.a1, self.a2 = n1, n2, a1, a2
        self.device = dev = torch.device(device)
        self.hs = np.asarray(hidden_states, np.float64)
        self.M = len(self.hs) - 1
        self.K = K
        self.s1 = np.asarray(s1, np.float64)
        self.s2 = np.asarray(s2, np.float64)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)  # noqa: E731

        # static partitions: per-interval conditioning needs the hidden
        # states spliced in; whole-axis ([0, inf]) conditioning does not
        self.part1 = _Part(self.s1, self.hs)
        self.part1_single = _Part(self.s1, np.array([0.0, np.inf]))
        self.part2_single = _Part(self.s2, np.array([0.0, np.inf]))

        # combinatorial kernels (identical to the eager JointCSFS)
        ref = JointCSFS(n1, n2, a1, a2, [0.0, np.inf], K=K)
        self.S0, self.S2, self.Sn1 = f(ref.S0), f(ref.S2), f(ref.Sn1)
        u, w = _leggauss01(K)
        self.quad_u, self.quad_w = f(u), f(w)
        self._U = {k: f(_undist_matrix(k))
                   for k in (n1, n1 + n2 - 1, n2 - 2, n1 - 1, n2 - 1) if k >= 0}
        mc = exact.cached_matrices(n1)
        self._M0, self._M1 = f(mc.M0), f(mc.M1)
        self._eig = {("moran", N): _Expm(_moran(N), dev) for N in (n2, n1 + 1)}
        for key in ((n1, 0, 2), (n1, 1, 2), (n1, 2, 2), (n1, 0, 1),
                    (n1, 1, 1), (n2, 0, 1), (n2, 1, 1)):
            self._eig[key] = _Expm(_modified(*key), dev)

        # index maps of the hypergeometric gathers: nseg = np1 + np2
        IDX1 = np.add.outer(np.arange(n1 + 1), np.arange(n2 + 1))
        self._H1 = f(ref.hyp1[np.arange(n1 + 1)[:, None], IDX1])
        self._IDX1 = torch.as_tensor(IDX1, device=dev)
        IDX2 = np.add.outer(np.arange(n1 + 2), np.arange(n2 + 1))
        valid = (IDX2 >= 1) & (IDX2 <= n1 + n2)
        IDX2c = np.clip(IDX2 - 1, 0, n1 + n2 - 1)
        self._IDX2c = torch.as_tensor(IDX2c, device=dev)
        self._H2 = f(np.where(valid, ref.hyp2[np.arange(n1 + 2)[:, None], IDX2c],
                              0.0))
        self._hs_inf = torch.as_tensor(np.isinf(self.hs), device=dev)

    def _sizes(self, a):
        if not torch.is_tensor(a):
            a = np.array(a, np.float64)
        return torch.as_tensor(a, dtype=_F64, device=self.device)

    def _mask(self, m):
        "A static (M,) mask as a device tensor shaped to broadcast on (M, ...)."
        return torch.as_tensor(m, device=self.device)

    # -- public ---------------------------------------------------------
    def compute(self, a1v, a2v, split):
        "(M, a1+1, (n1+1)(a2+1)(n2+1)) branch lengths, floored, corners zeroed."
        a1v, a2v, split = self._sizes(a1v), self._sizes(a2v), float(split)
        with torch.no_grad():
            J = (
                self._together(a1v, a2v, split)
                if self.a1 == 2
                else self._apart(a1v, a2v, split)
            )
            n1, n2, a1, a2 = self.n1, self.n2, self.a1, self.a2
            J = torch.clamp(J, min=1e-20)  # a fresh tensor: written in place
            v = J.view(self.M, a1 + 1, n1 + 1, a2 + 1, n2 + 1)
            v[:, 0, 0, 0, 0] = 0.0
            v[:, a1, n1, a2, n2] = 0.0
        return J

    # -- together (a1 = 2, a2 = 0): jcsfs.cpp:370-420 -------------------
    def _together(self, a1v, a2v, split):
        n1, n2, M = self.n1, self.n2, self.M
        eta1 = _TracedEta(a1v, self.s1)
        eta2 = _TracedEta(a2v, self.s2)
        Rts1 = eta1.R(split)
        Rts2 = eta2.R(split)
        eMn2 = _expm_at(self._eig[("moran", n2)], Rts2)

        # straddle weights: w_m = P(T > split | T in interval m)
        hs_fin = np.where(np.isinf(self.hs), 1.0, self.hs)
        ex = torch.where(self._hs_inf, 0.0, torch.exp(-eta1.R(hs_fin)))  # (M+1,)
        e_split = torch.exp(-Rts1)
        denom = ex[:-1] - ex[1:]
        live = denom > 1e-300
        w_raw = torch.clamp(
            (e_split - ex[1:]) / torch.where(live, denom, 1.0), 0.0, 1.0
        )
        # zero-mass intervals: weight by the position of the interval start
        w = torch.where(live, w_raw, self._mask(self.hs[:-1] >= split).to(_F64))
        bmask = self._mask(self.hs[:-1] < split)  # below part exists
        amask = self._mask(self.hs[1:] > split)  # above part exists
        wbm = torch.where(bmask, 1.0 - w, 0.0)  # (M,)
        wam = torch.where(amask, w, 0.0)
        b3 = bmask[:, None, None]

        v = a1v.new_zeros((M, 3, n1 + 1, n2 + 1))

        # ---- below the split (jcsfs.cpp:89-164), all intervals at once
        a_t, g_t = trunc_dual(self.part1, a1v, split, include_crash=False)
        # (M, 3, n1+1); garbage rows where !bmask
        cb = conditioned_sfs(a_t, g_t, n1)
        cb = torch.where(b3, torch.nan_to_num(torch.clamp(cb, min=0.0)), 0.0)
        v[:, :, :, 0] += wbm[:, None, None] * cb
        trunc_sfs = cb.reshape(M, -1) @ self._U[n1].T  # (M, n1+1)
        Et = trunc_sfs @ self.Sn1
        # the reference *assigns* (split - Et) to the (2, n1) corner,
        # overwriting the truncated-CSFS value (jcsfs.py note)
        v[:, 2, n1, 0] += wbm * ((split - Et) - cb[:, 2, n1])

        # above-split SFS transported down (shared across intervals)
        a_sh1, g_sh1 = shift_dual(self.part1_single, a1v, split)
        cs1 = conditioned_sfs(a_sh1, g_sh1, n1 + n2 - 1)[0]
        sfs_above = self._U[n1 + n2 - 1] @ cs1.reshape(-1)  # (n1+n2,)
        G2 = self._H2 * sfs_above[self._IDX2c]  # (n1+2, n2+1)

        # per-interval Gauss-Legendre transports over (t1, min(t2, split))
        lo_u = torch.maximum(ex[1:], e_split)  # (M,)
        hi_u = ex[:-1]
        span = torch.clamp(hi_u - lo_u, min=0.0)
        uu = lo_u[:, None] + self.quad_u[None, :] * span[:, None]
        uu = torch.clamp(uu, 1e-300, 1.0)
        Rt = -torch.log(uu)  # (M, K)
        tq = torch.clamp(Rts1 - Rt, min=0.0)
        A = _expm_at(self._eig[("moran", n1 + 1)], tq)  # (M, K, n1+2, n1+2)
        B = _expm_at(self._eig[(n1, 0, 2)], Rt)  # (M, K, n1+1, n1+1)
        Cm = _expm_at(self._eig[(n1, 2, 2)], Rt)
        A0 = (A * self.S0)[..., :-1]
        A2 = (A * self.S2)[..., 1:]
        wq = self.quad_w
        eMn10 = torch.einsum("q,mqij,mqjl->mil", wq, A0, B)  # (M, n1+2, n1+1)
        eMn12 = torch.einsum("q,mqij,mqjl->mil", wq, A2, Cm)
        blk0 = torch.einsum("mij,ik,kl->mjl", eMn10, G2, eMn2)
        blk2 = torch.einsum("mij,ik,kl->mjl", eMn12, G2, eMn2)
        wb3 = wbm[:, None, None]
        v[:, 0] += wb3 * torch.where(b3, torch.nan_to_num(blk0), 0.0)
        v[:, 2] += wb3 * torch.where(b3, torch.nan_to_num(blk2), 0.0)

        # ---- above the split (jcsfs.cpp:166-216), all intervals at once
        a_sh, g_sh = shift_dual(self.part1, a1v, split)
        rsfs = conditioned_sfs(a_sh, g_sh, n1 + n2)  # (M, 3, n1+n2+1)
        rsfs = torch.where(amask[:, None, None], torch.nan_to_num(rsfs), 0.0)
        eMn1 = [
            _expm_at(self._eig[(n1, 0, 2)], Rts1),
            _expm_at(self._eig[(n1, 1, 2)], Rts1),
        ]
        eMn1.append(torch.flip(eMn1[0], (0, 1)))
        wa3 = wam[:, None, None]
        for i in range(3):
            Gm = self._H1[None] * rsfs[:, i, :][:, self._IDX1]  # (M, n1+1, n2+1)
            v[:, i] += wa3 * torch.einsum("ij,mik,kl->mjl", eMn1[i], Gm, eMn2)
        # pop 1 below, conditioned on coalescence at the split
        tb0 = _tb0_traced(eta1, split, n1)
        r0 = torch.clamp(tb0 @ self._M0, min=0.0)  # (n1,)
        r1 = torch.clamp(tb0 @ self._M1, min=0.0)
        v[:, 0, 1:, 0] += wam[:, None] * r0[None, :]
        v[:, 1, :, 0] += wam[:, None] * r1[None, :]

        # ---- pop 2 below the split (jcsfs.cpp:403-418), same for all m
        if n2 == 1:
            v[:, 0, 0, 1] += split
        elif n2 > 1:
            a_t2, g_t2 = trunc_dual(self.part2_single, a2v, split,
                                    include_crash=True)
            cs2 = conditioned_sfs(a_t2, g_t2, n2 - 2)[0]
            rsfs2 = (self._U[n2 - 2] @ cs2.reshape(-1))[: n2 - 1]
            v[:, 0, 0, 1:n2] += rsfs2[None, :]
            Sn2 = torch.as_tensor(np.arange(1, n2) / n2, device=self.device)
            v[:, 0, 0, n2] += split - Sn2 @ rsfs2
        return v.reshape(M, 3, (n1 + 1) * (n2 + 1))

    # -- apart (a1 = a2 = 1): jcsfs.cpp:257-367 --------------------------
    def _apart(self, a1v, a2v, split):
        n1, n2, M = self.n1, self.n2, self.M
        eta1 = _TracedEta(a1v, self.s1)
        eta2 = _TracedEta(a2v, self.s2)
        Rts1 = eta1.R(split)
        Rts2 = eta2.R(split)
        # the distinguished pair cannot coalesce below the split: only
        # intervals reaching above it carry conditional mass
        amask = self._mask(self.hs[1:] > split)  # (M,)

        a_sh, g_sh = shift_dual(self.part1, a1v, split)
        cs = conditioned_sfs(a_sh, g_sh, n1 + n2)  # (M, 3, n1+n2+1)
        cs = torch.where(amask[:, None, None], torch.nan_to_num(cs), 0.0)

        T10 = _expm_at(self._eig[(n1, 0, 1)], Rts1)
        T11 = _expm_at(self._eig[(n1, 1, 1)], Rts1)
        T20 = _expm_at(self._eig[(n2, 0, 1)], Rts2)
        T21 = _expm_at(self._eig[(n2, 1, 1)], Rts2)
        v = a1v.new_zeros((M, 2, n1 + 1, 2, n2 + 1))
        for (r0, r1), (Ma, Mb, fac, csrow) in {
            (1, 1): (T11, T21, 1.0, 2),
            (1, 0): (T11, T20, 0.5, 1),
            (0, 1): (T10, T21, 0.5, 1),
            (0, 0): (T10, T20, 1.0, 0),
        }.items():
            Gm = self._H1[None] * cs[:, csrow, :][:, self._IDX1]
            v[:, r0, :, r1, :] += fac * torch.einsum("ij,mik,kl->mjl", Ma, Gm, Mb)

        # truncated below-split SFS per population (jcsfs.cpp:320-367),
        # added to every interval.  split == 0 degrades gracefully: the
        # truncated model is crash-only, its branch lengths ~ 0.
        for first, (av, ni, part) in enumerate(
            [(a1v, n1, self.part1_single), (a2v, n2, self.part2_single)]
        ):
            if ni == 0:
                continue
            a_t, g_t = trunc_dual(part, av, split, include_crash=True)
            csi = conditioned_sfs(a_t, g_t, ni - 1)[0]
            rsfs = (self._U[ni - 1] @ csi.reshape(-1))[:ni]
            ks = torch.arange(1, ni + 1, dtype=_F64, device=self.device)
            fac = ks / (ni + 1.0)
            x1 = (1.0 - fac) * rsfs
            x2 = fac * rsfs
            remain = ks @ rsfs / (ni + 1.0)
            if first == 0:
                v[:, 0, 1:, 0, 0] += x1[None, :]
                v[:, 1, :ni, 0, 0] += x2[None, :]
                v[:, 1, ni, 0, 0] += split - remain
            else:
                v[:, 0, 0, 0, 1:] += x1[None, :]
                v[:, 0, 0, 1, :ni] += x2[None, :]
                v[:, 0, 0, 1, ni] += split - remain
        return v.reshape(M, 2, (n1 + 1) * 2 * (n2 + 1))
