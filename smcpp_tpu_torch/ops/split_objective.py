"""Batched, differentiable split-time objective, in torch.

Port of smcpp_tpu/ops/split_objective.py.  The split workflow searches a
single scalar, the split time, at trivial hidden states ([0, inf], M = 1),
so the whole two-population EM objective collapses to
``Q(split) = sum_k counts_k * log E_k(split)`` (pi and T are trivial at
M = 1).  The reference rebuilds the whole JCSFS per candidate
(SMC++ src/jcsfs.cpp:218-255, value only); here ``E(split)`` is one
float64 torch function of the split, evaluated on the manager's device:
``q_batch`` maps it over a batch of candidates with ``torch.func.vmap`` and
``q_and_grad`` takes ``dQ/dsplit`` from autograd.

What keeps the shapes static while the split varies:

* ``shift_params`` / ``truncate_params`` change array lengths; here they
  become zero-width pieces: a truncated model keeps all K pieces with widths
  ``clamp(min(cs[i+1], split) - cs[i], 0)`` plus a static crash piece, a
  shifted model keeps widths ``clamp(cs[i+1] - max(cs[i], split), 0)``.  The
  tjj integrals (ops/ratefunc.py) mask zero-width pieces, and the hidden
  interval [0, split] of a truncated grid always ends at the crash piece, so
  ``hs_indices`` never depends on the split;
* the below part conditioned on coalescence at the split (ops/jcsfs.py,
  ``_below_at_split``: a two-sided 1e-6 interval) becomes its exact
  eps -> 0 limit, the closed-form single integrals
  ``tb0[j] = int_0^split exp(-rate_j R(t)) dt``;
* the conditional-coalescence transports use ops/jcsfs.py's Gauss-Legendre
  rule, the Moran eigendecompositions are constants and the propagators
  ``U exp(D t) Uinv`` are evaluated at the split-dependent times.

Like the reference package, the joint objective uses the raw model2 history
where the eager JCSFS receives the spliced pop-2 marginal (model2 below the
split, model1 above, re-fit through a spline): only the below-split part of
that model enters the JCSFS, so the two agree up to the re-fit's sampling.
"""

import numpy as np
import torch

from .. import defaults
from . import csfs as csfs_mod
from . import emission as em_mod
from . import exact, ratefunc
from .grid import TimeGrid, make_time_grid
from .jcsfs import JointCSFS, _modified, _moran

CRASH_A = 1e-8  # truncate_params' post-truncation crash size
APART_A = 1e300  # stand-in for the infinite pre-split size of the apart model

_HS_TRIVIAL = np.array([0.0, np.inf])


# ---------------------------------------------------------------------------
# static helpers
# ---------------------------------------------------------------------------

def _undist_matrix(n):
    "Static (n+1, 3(n+1)) map: flattened (3, n+1) CSFS -> undistinguished SFS."
    U = np.zeros((n + 1, 3 * (n + 1)))
    for a in range(3):
        for b in range(n + 1):
            k = a + b
            if 1 <= k < n + 2:
                U[k - 1, a * (n + 1) + b] = 1.0
    return U


def _leggauss01(K):
    u, w = np.polynomial.legendre.leggauss(K)
    return 0.5 * (u + 1.0), 0.5 * w


class _StaticEta:
    """Static piecewise model on a device; R and Rinv in closed form at
    split-dependent times (a piece is found by counting the boundaries at or
    below t, which maps over a batch)."""

    def __init__(self, a, s, device):
        self.a = np.asarray(a, dtype=np.float64)
        self.s = np.asarray(s, dtype=np.float64)
        self.ada = 1.0 / self.a
        self.cs = np.concatenate([[0.0], np.cumsum(self.s)])
        self.cs[-1] = np.inf
        self.Rrng = np.concatenate(
            [[0.0], np.cumsum(self.ada[:-1] * np.diff(self.cs[:-1]))]
        )
        f = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
        self.a_t, self.ada_t, self.Rrng_t = f(self.a), f(self.ada), f(self.Rrng)
        self.lo = f(self.cs[:-1])
        # piece ends with inf capped for arithmetic
        self.hi = f(np.where(np.isinf(self.cs[1:]), np.finfo(np.float64).max,
                             self.cs[1:]))

    def R(self, t):
        ip = torch.sum(self.lo[1:] <= t[..., None], -1)
        return self.Rrng_t[ip] + self.ada_t[ip] * (t - self.lo[ip])

    def Rinv(self, y):
        ip = torch.sum(self.Rrng_t[1:] <= y[..., None], -1)
        return (y - self.Rrng_t[ip]) / self.ada_t[ip] + self.lo[ip]


def _grid(dt, K1, hs_idx):
    "A TimeGrid of the widths ``dt`` (a tensor) over K1 pieces."
    return TimeGrid(
        ts=torch.cat([dt.new_zeros(1), torch.cumsum(dt, 0)]), dt=dt,
        src=np.arange(K1, dtype=np.int64),
        hs_indices=np.asarray(hs_idx, dtype=np.int64),
        hidden_states=_HS_TRIVIAL,
    )


def _big_t(like):
    return torch.full((1,), defaults.BIG_T, dtype=like.dtype, device=like.device)


def _trunc_grid(eta, split, upto_split):
    """The model truncated at ``split`` (crash piece after): per-piece sizes
    and grid.  upto_split: hidden interval [0, split] (the crash piece
    excluded) or [0, inf] (included, as the pop-2 below-split SFS uses)."""
    w = torch.clamp(torch.minimum(eta.hi, split) - eta.lo, min=0.0)
    K = len(eta.a)
    dt = torch.cat([w, _big_t(w)])
    a_aug = torch.cat([eta.a_t, eta.a_t.new_full((1,), CRASH_A)])
    return a_aug, _grid(dt, K + 1, [0, K if upto_split else K + 1])


def _shift_grid(eta, split):
    "The model shifted to start at ``split`` (hidden states [0, inf])."
    w = torch.clamp(eta.hi - torch.maximum(eta.lo, split), min=0.0)
    K = len(eta.a)
    dt = torch.cat([w[:-1], _big_t(w)])
    return eta.a_t, _grid(dt, K, [0, K])


def _apart_grid(eta, split):
    "The 'apart' model: infinite size below the split."
    w = torch.clamp(eta.hi - torch.maximum(eta.lo, split), min=0.0)
    K = len(eta.a)
    dt = torch.cat([split.reshape(1), w[:-1], _big_t(w)])
    a_aug = torch.cat([eta.a_t.new_full((1,), APART_A), eta.a_t])
    return a_aug, _grid(dt, K + 1, [0, K + 1])


def _tb0_integrals(eta, split, n):
    """Closed-form ``int_0^split exp(-rate_j R(t)) dt``, rate_j = C(j,2)-1:
    the exact eps -> 0 limit of conditioning the below integrals on
    coalescence *at* the split."""
    js = np.arange(2, n + 3)
    rates = (js * (js - 1) // 2 - 1).astype(np.float64)[:, None]  # (n+1, 1)
    delta = torch.clamp(torch.minimum(eta.hi, split) - eta.lo, min=0.0)[None, :]
    c = lambda x: torch.as_tensor(x, device=delta.device)  # noqa: E731
    rates_safe = c(np.where(rates == 0, 1.0, rates))
    ada = eta.ada_t[None, :]
    v_pos = (
        torch.exp(-c(rates) * eta.Rrng_t[None, :])
        * (-torch.expm1(-rates_safe * ada * delta))
        / (rates_safe * ada)
    )
    return torch.sum(torch.where(c(rates == 0), delta, v_pos), 1)  # (n+1,)


class _Expm:
    "U exp(D t) Uinv of a Moran rate matrix on a device."

    def __init__(self, eig, device):
        f = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
        self.U, self.D, self.Ui = f(eig.U), f(eig.D), f(eig.Uinv)

    def __call__(self, t):
        "t () -> (N, N); t (K,) -> (K, N, N)."
        return (self.U * torch.exp(self.D * t[..., None])[..., None, :]) @ self.Ui


class _Acc:
    """Out-of-place sums into a tensor of a static shape, by flat index
    (``index_add``), so the accumulation maps over a batch of splits."""

    def __init__(self, shape, device):
        self.idx = np.arange(int(np.prod(shape))).reshape(shape)
        self.device = device
        self.v = torch.zeros(self.idx.size, dtype=torch.float64, device=device)

    def add(self, where, val):
        ii = self.idx[where]
        val = torch.as_tensor(val, dtype=torch.float64, device=self.device)
        self.v = self.v.index_add(
            0, torch.as_tensor(np.ravel(ii), device=self.device),
            val.broadcast_to(np.shape(ii)).reshape(-1),
        )


# ---------------------------------------------------------------------------
# the objectives
# ---------------------------------------------------------------------------

class _Objective:
    "q_batch / q_and_grad around a float64 function ``_q`` of one split."

    def q_batch(self, splits):
        "Q at each of the ``splits``: one mapped evaluation, (B,) array."
        x = torch.as_tensor(np.asarray(splits, np.float64), device=self._device)
        with torch.no_grad():
            return torch.func.vmap(self._q)(x).cpu().numpy()

    def q_and_grad(self, split):
        "(Q, dQ/dsplit) at one split, the derivative by autograd."
        x = torch.tensor(float(split), dtype=torch.float64, device=self._device,
                         requires_grad=True)
        v = self._q(x)
        if not v.requires_grad:
            # piecewise constant in the split (the marginal's static grid)
            return float(v), 0.0
        (g,) = torch.autograd.grad(v, x)
        return float(v.detach()), float(g)

    def _q_of_E(self, em, act):
        e2 = em_mod.e2_matrix(act, self.theta, self.alpha)
        E = em_mod.emission_matrix(self.idx, em, e2)
        return torch.sum(self.counts * torch.log(E))


class SplitObjective(_Objective):
    """Q(split) for a TwoPopInferenceManager with trivial hidden states.  The
    model state (marginal histories, theta, alpha, emission index, the
    E-step's key counts) is captured at construction; only the split
    varies.  ``_j_together`` follows jcsfs.cpp's below and above parts
    through the straddling M = 1 interval, ``_j_apart`` jcsfs.cpp:257-367."""

    def __init__(self, im, quad_K=16):
        self._device = dev = im._device
        self.n1, self.n2 = im.n1, im.n2
        self.a1, self.a2 = im.a1, im.a2
        self.theta, self.alpha = float(im.theta), im.alpha
        self.idx = im.em_idx
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)  # noqa: E731
        self.counts = f(im._stats[2])

        m1, m2 = im.model.model1, im.model.model2
        self.eta1 = _StaticEta(np.asarray(m1.stepwise_values()), m1.s, dev)
        self.eta2 = _StaticEta(np.asarray(m2.stepwise_values()), m2.s, dev)
        n1, n2 = self.n1, self.n2

        # combinatorial kernels shared with ops/jcsfs.py
        ref = JointCSFS(n1, n2, self.a1, self.a2, _HS_TRIVIAL, K=quad_K)
        self.S0, self.S2, self.Sn1 = f(ref.S0), f(ref.S2), f(ref.Sn1)
        u, w = _leggauss01(quad_K)
        self.quad_u, self.quad_w = f(u), f(w)
        self._U = {k: f(_undist_matrix(k))
                   for k in (n1, n1 + n2 - 1, n2 - 2, n1 - 1, n2 - 1) if k >= 0}
        mc = exact.cached_matrices(n1)
        self._M0, self._M1 = f(mc.M0), f(mc.M1)
        self._moran_n2 = _Expm(_moran(n2), dev)
        self._moran_n1p1 = _Expm(_moran(n1 + 1), dev)
        self._mod = {
            key: _Expm(_modified(*key), dev)
            for key in ((n1, 0, 2), (n1, 1, 2), (n1, 2, 2), (n1, 0, 1),
                        (n1, 1, 1), (n2, 0, 1), (n2, 1, 1))
        }
        # G's index maps: nseg = np1 + np2
        IDX1 = np.add.outer(np.arange(n1 + 1), np.arange(n2 + 1))
        self._IDX1 = torch.as_tensor(IDX1, device=dev)
        self._H1 = f(ref.hyp1[np.arange(n1 + 1)[:, None], IDX1])
        IDX2 = np.add.outer(np.arange(n1 + 2), np.arange(n2 + 1))
        valid = (IDX2 >= 1) & (IDX2 <= n1 + n2)
        IDX2c = np.clip(IDX2 - 1, 0, n1 + n2 - 1)
        self._IDX2c = torch.as_tensor(IDX2c, device=dev)
        self._H2 = f(np.where(valid, ref.hyp2[np.arange(n1 + 2)[:, None], IDX2c],
                              0.0))
        # the e2 row's average coalescence time: constant when together
        # (the distinguished model is model1), split-dependent when apart
        if self.a1 == 2:
            g = make_time_grid(self.eta1.s, _HS_TRIVIAL)
            with torch.no_grad():
                self._act_static = ratefunc.average_coal_times(self.eta1.a_t, g)

    def _q(self, split):
        a1, a2, n1, n2 = self.a1, self.a2, self.n1, self.n2
        J = self._j_together(split) if a1 == 2 else self._j_apart(split)
        J = torch.clamp(J, min=1e-20)
        # zero the nonsegregating corners (jcsfs.cpp:218-244)
        corner = np.zeros((a1 + 1, n1 + 1, a2 + 1, n2 + 1), dtype=bool)
        corner[0, 0, 0, 0] = corner[a1, n1, a2, n2] = True
        J = torch.where(torch.as_tensor(corner.reshape(-1), device=J.device), 0.0, J)
        em = csfs_mod.incorporate_theta(J.reshape(1, a1 + 1, -1), self.theta)
        if a1 == 2:
            act = self._act_static
        else:
            a_ap, g_ap = _apart_grid(self.eta1, split)
            act = ratefunc.average_coal_times(a_ap, g_ap)
        return self._q_of_E(em, act)

    def _csfs(self, a, grid, n):
        return csfs_mod.conditioned_sfs(a, grid, n)[0]  # (3, n+1)

    def _sfs(self, a, grid, n):
        "The undistinguished SFS (n+1,) of the CSFS on grid."
        return self._U[n] @ self._csfs(a, grid, n).reshape(-1)

    # -- together (a1 = 2): jcsfs.cpp:89-255, M = 1 straddle -------------
    def _j_together(self, split):
        n1, n2 = self.n1, self.n2
        Rts1 = self.eta1.R(split)
        Rts2 = self.eta2.R(split)
        eMn2 = self._moran_n2(Rts2)
        w = torch.exp(-Rts1)  # P(T > split)
        v = _Acc((3, n1 + 1, 1, n2 + 1), self._device)
        self._tau_below(v, split, 1.0 - w, Rts1, eMn2)
        self._tau_above(v, split, w, Rts1, eMn2)

        # pop 2 below the split (jcsfs.cpp:403-418)
        if n2 == 1:
            v.add((0, 0, 0, 1), split)
        elif n2 > 1:
            a_t2, g_t2 = _trunc_grid(self.eta2, split, upto_split=False)
            rsfs2 = self._sfs(a_t2, g_t2, n2 - 2)[: n2 - 1]
            v.add((0, 0, 0, slice(1, n2)), rsfs2)
            Sn2 = torch.as_tensor(np.arange(1, n2) / n2, device=self._device)
            v.add((0, 0, 0, n2), split - Sn2 @ rsfs2)
        return v.v

    def _tau_below(self, v, split, weight, Rts1, eMn2):
        "Distinguished pair coalesces below the split (jcsfs.cpp:89-164)."
        n1 = self.n1
        a_t, g_t = _trunc_grid(self.eta1, split, upto_split=True)
        trunc_csfs = self._csfs(a_t, g_t, n1)
        v.add((slice(None), slice(None), 0, 0),
              weight * torch.clamp(trunc_csfs, min=0.0))
        trunc_sfs = self._U[n1] @ trunc_csfs.reshape(-1)
        Et = self.Sn1 @ trunc_sfs
        v.add((2, n1, 0, 0), weight * (split - Et)
              - weight * torch.clamp(trunc_csfs[2, n1], min=0.0))

        a_sh, g_sh = _shift_grid(self.eta1, split)
        sfs_above = self._sfs(a_sh, g_sh, self.n1 + self.n2 - 1)  # (n1+n2,)

        # Gauss-Legendre conditional-time transports over (0, split)
        lo_u = torch.exp(-Rts1)
        uu = lo_u + self.quad_u * (1.0 - lo_u)
        ts = self.eta1.Rinv(-torch.log(uu))
        Rt = self.eta1.R(ts)  # == -log(uu), recomputed as the reference does
        A = self._moran_n1p1(Rts1 - Rt)  # (K, n1+2, n1+2)
        B = self._mod[(n1, 0, 2)](Rt)
        C = self._mod[(n1, 2, 2)](Rt)
        A0 = (A * self.S0[None, None, :])[:, :, :-1]
        A2 = (A * self.S2[None, None, :])[:, :, 1:]
        eMn10_avg = torch.einsum("k,kij,kjl->il", self.quad_w, A0, B)
        eMn12_avg = torch.einsum("k,kij,kjl->il", self.quad_w, A2, C)

        # G[np1, np2] = hyp2[np1, nseg-1] * sfs_above[nseg-1], nseg = np1+np2
        G = self._H2 * sfs_above[self._IDX2c]
        v.add((0, slice(None), 0, slice(None)), weight * (eMn10_avg.T @ G @ eMn2))
        v.add((2, slice(None), 0, slice(None)), weight * (eMn12_avg.T @ G @ eMn2))

    def _tau_above(self, v, split, weight, Rts1, eMn2):
        "Distinguished pair coalesces above the split (jcsfs.cpp:166-216)."
        n1, n2 = self.n1, self.n2
        a_sh, g_sh = _shift_grid(self.eta1, split)
        rsfs = self._csfs(a_sh, g_sh, n1 + n2)  # (3, n1+n2+1)
        eMn1 = [self._mod[(n1, 0, 2)](Rts1), self._mod[(n1, 1, 2)](Rts1)]
        eMn1.append(torch.flip(eMn1[0], (0, 1)))
        for i in range(3):
            G = self._H1 * rsfs[i][self._IDX1]
            v.add((i, slice(None), 0, slice(None)),
                  weight * (eMn1[i].T @ G @ eMn2))
        # pop 1 below, conditioned on coalescence at the split (the exact
        # eps -> 0 limit of the eager two-sided interval)
        tb0 = _tb0_integrals(self.eta1, split, n1)
        v.add((0, slice(1, None), 0, 0), weight * torch.clamp(tb0 @ self._M0, min=0.0))
        v.add((1, slice(None), 0, 0), weight * torch.clamp(tb0 @ self._M1, min=0.0))

    # -- apart (a1 = a2 = 1): jcsfs.cpp:257-367 --------------------------
    def _j_apart(self, split):
        n1, n2 = self.n1, self.n2
        a_sh, g_sh = _shift_grid(self.eta1, split)
        cs = self._csfs(a_sh, g_sh, n1 + n2)  # (3, n1+n2+1)
        Rts1 = self.eta1.R(split)
        Rts2 = self.eta2.R(split)
        T10 = self._mod[(n1, 0, 1)](Rts1)
        T11 = self._mod[(n1, 1, 1)](Rts1)
        T20 = self._mod[(n2, 0, 1)](Rts2)
        T21 = self._mod[(n2, 1, 1)](Rts2)
        v = _Acc((2, n1 + 1, 2, n2 + 1), self._device)
        for (r0, r1), (Ma, Mb, fac, csrow) in {
            (1, 1): (T11, T21, 1.0, 2),
            (1, 0): (T11, T20, 0.5, 1),
            (0, 1): (T10, T21, 0.5, 1),
            (0, 0): (T10, T20, 1.0, 0),
        }.items():
            G = self._H1 * cs[csrow][self._IDX1]
            v.add((r0, slice(None), r1, slice(None)), fac * (Ma.T @ G @ Mb))

        # truncated below-split SFS per population (jcsfs.cpp:320-367)
        for first, (eta, ni) in enumerate([(self.eta1, n1), (self.eta2, n2)]):
            if ni == 0:
                continue
            a_t, g_t = _trunc_grid(eta, split, upto_split=False)
            rsfs = self._sfs(a_t, g_t, ni - 1)[:ni]
            ks = torch.arange(1, ni + 1, dtype=torch.float64, device=self._device)
            fac = ks / (ni + 1.0)
            x1 = (1.0 - fac) * rsfs
            x2 = fac * rsfs
            remain = ks @ rsfs / (ni + 1.0)
            if first == 0:
                v.add((0, slice(1, None), 0, 0), x1)
                v.add((1, slice(None, ni), 0, 0), x2)
                v.add((1, ni, 0, 0), split - remain)
            else:
                v.add((0, 0, 0, slice(1, None)), x1)
                v.add((0, 0, 1, slice(None, ni)), x2)
                v.add((0, 0, 1, ni), split - remain)
        return v.v


class MarginalSplitObjective(_Objective):
    """Q(split) for a *one-population marginal* manager whose model is the
    pop-2 splice (model2 below the split, model1 above,
    models/model.py:for_pop).

    The eager path re-builds an SMCModel over the union knots and re-fits
    its spline per candidate; here the stepwise values are selected on a
    static dense time grid, ``a(t) = model2(t) if t < split else
    model1(t)``, which agrees with the eager splice up to the spline re-fit's
    interpolation between samples (exact for piecewise splines)."""

    def __init__(self, im, model):
        self._device = dev = im._device
        self.n = im.n
        self.idx = im.em_idx
        self.theta, self.alpha = float(im.theta), im.alpha
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)  # noqa: E731
        self.counts = f(im._stats[2])
        m1, m2 = model.model1, model.model2
        kts = np.unique(np.r_[m1.knots, m2.knots])
        s = np.r_[
            kts[0],
            np.diff(
                np.logspace(
                    np.log10(kts[0]), np.log10(kts[-1]), defaults.pieces
                )
            ),
        ]
        t_pts = np.cumsum(s)
        self.t_pts = f(t_pts)
        self.v1 = f(m1(t_pts))
        self.v2 = f(m2(t_pts))
        self.grid = make_time_grid(s, _HS_TRIVIAL)

    def _q(self, split):
        a = torch.where(self.t_pts < split, self.v2, self.v1)
        a = torch.clamp(
            a,
            defaults.minimum_population_size,
            defaults.maximum_population_size,
        )
        em = csfs_mod.incorporate_theta(
            csfs_mod.conditioned_sfs(a, self.grid, self.n), self.theta)
        return self._q_of_E(em, ratefunc.average_coal_times(a, self.grid))
