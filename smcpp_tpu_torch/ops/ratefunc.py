"""Piecewise-constant coalescent rate function, in torch.

Port of smcpp_tpu/ops/ratefunc.py.  Every function takes the per-piece
population-size tensor ``a`` with any leading batch dimensions (``(..., K0)``)
and a ``TimeGrid`` whose index maps are static (its times and widths may be
tensors: ops/split_objective.py); results carry the same leading
dimensions.  The closed forms are those of the reference
(SMC++ src/piecewise_constant_rate_function.cpp):

* the terminal infinite piece has the finite width ``defaults.BIG_T``, so
  every "t == infinity" branch collapses to the right limit
  (exp(-ada * BIG_T) == 0.0 in float64);
* the single integrals are combined with prefix/suffix log-sum-exp, so large
  exponents never overflow;
* zero-width pieces are masked statically.

The grid's static arrays come from ``c``, a ``QConsts`` (ops/qconst.py) of
the grid in ``a``'s dtype and device; without one a function makes its own.

Branches that ``torch.where`` does not select are kept finite, so autograd
never multiplies a zero cotangent by inf.
"""

import numpy as np
import torch

from .. import defaults
from .grid import TimeGrid
from .qconst import QConsts

_LN2 = 0.6931471805599453


def consts(grid, like, c=None):
    "``c``, or a fresh ``QConsts`` of ``grid`` in ``like``'s dtype and device."
    return c if c is not None else QConsts(grid, like.dtype, like.device)


def ada_on_grid(a, grid: TimeGrid, c=None):
    "Per-augmented-piece inverse population size (the coalescent rate)."
    return (1.0 / a)[..., consts(grid, a, c).src]


def cumulative_rate(ada, grid: TimeGrid, c=None):
    """R(ts[i]) for every grid point i (K+1 values); the last entry is a
    huge-but-finite stand-in for R(inf)."""
    c = consts(grid, ada, c)
    z = torch.zeros(ada.shape[:-1] + (1,), dtype=ada.dtype, device=ada.device)
    return torch.cat([z, torch.cumsum(ada * c.dt, -1)], -1)


def _log1mexp(x):
    "log(-expm1(-x)) for x > 0, stable in both regimes."
    return torch.where(
        x > _LN2,
        torch.log1p(-torch.exp(-torch.clamp(x, max=700.0))),
        torch.log(-torch.expm1(-torch.clamp(x, min=1e-300))),
    )


def _log_denoms(Rr, c):
    """log P(coal in hidden interval h), with a leading -R_h shift
    (``log_denom`` of the reference)."""
    Rh = Rr[..., c.hs_lo]
    Rh1 = Rr[..., c.hs_hi]
    return -Rh + _log1mexp(Rh1 - Rh)


def initial_distribution(a, grid: TimeGrid, c=None):
    """pi_m = e^{-R(h_m)} - e^{-R(h_{m+1})}, floored and normalized
    (src/inference_manager.cpp:56-69)."""
    c = consts(grid, a, c)
    Rr = cumulative_rate(ada_on_grid(a, grid, c), grid, c)
    ex = torch.exp(-Rr[..., c.hs])
    pi = torch.clamp(ex[..., :-1] - ex[..., 1:], min=defaults.pi_floor)
    return pi / torch.sum(pi, -1, keepdim=True)


def average_coal_times(a, grid: TimeGrid, c=None):
    """E[T | coal in hidden interval h] for each h
    (piecewise_constant_rate_function.cpp:371-403)."""
    c = consts(grid, a, c)
    ada = ada_on_grid(a, grid, c)
    Rr = cumulative_rate(ada, grid, c)
    ld = _log_denoms(Rr, c)  # (..., M)
    dt = c.dt
    piece_int = torch.exp(-Rr[..., :-1]) * (-torch.expm1(-ada * dt)) / ada
    piece_int = torch.where(c.zero_piece, 0.0, piece_int)
    integral = torch.einsum(
        "hk,...k->...h", c.seg, piece_int * torch.exp(-ld[..., c.piece_h])
    )
    R0 = Rr[..., c.hs_lo]
    R1 = Rr[..., c.hs_hi]
    x = c.t0 * torch.exp(-(R0 + ld)) + integral - c.t1 * torch.exp(-(R1 + ld))
    # intervals with zero coalescent mass are undefined (reference: NaN)
    return torch.where(R1 - R0 > 0, x, torch.nan)


def _log_single_integrals(rates, ada, Rr, c):
    """log of int_{ts_k}^{ts_{k+1}} exp(-rate * R(t)) dt per (rate, piece);
    ``rates`` the (R, 1) rates of ``c`` (``QConsts._rates``).  Returns
    (..., R, K) (piecewise_constant_rate_function.cpp:197-211)."""
    dt = c.dt
    zero_piece = c.zero_piece[None, :]
    x = rates.safe * ada[..., None, :] * dt  # (..., R, K)
    x_safe = torch.where(zero_piece, 1.0, x)
    log_si = (
        -rates.rate * Rr[..., None, :-1]
        + _log1mexp(x_safe)
        - torch.log(ada[..., None, :] * rates.safe)
    )
    log_dt = torch.log(torch.clamp(dt, min=1e-300))
    log_si = torch.where(rates.zero, log_dt, log_si)
    return torch.where(zero_piece, -torch.inf, log_si)


def _suffix_lse(log_si):
    "logsumexp over pieces strictly after k (last axis)."
    c = torch.flip(torch.logcumsumexp(torch.flip(log_si, (-1,)), -1), (-1,))
    pad = torch.full_like(c[..., :1], -torch.inf)
    return torch.cat([c[..., 1:], pad], -1)


def _prefix_lse(log_si):
    "logsumexp over pieces strictly before k (last axis)."
    c = torch.logcumsumexp(log_si, -1)
    pad = torch.full_like(c[..., :1], -torch.inf)
    return torch.cat([pad, c[..., :-1]], -1)


def tjj_below(a, grid: TimeGrid, n: int, c=None):
    """Double integrals "below": (..., M, n+1), rate_j = C(j,2)-1 for
    j = 2..n+2 (piecewise_constant_rate_function.cpp:301-334)."""
    c = consts(grid, a, c)
    ada = ada_on_grid(a, grid, c)
    Rr = cumulative_rate(ada, grid, c)
    ld_m = _log_denoms(Rr, c)[..., c.piece_h][..., None, :]
    rates = c.below(n)  # (n+1, 1), first entry 0
    r_t = rates.rate
    Rm = Rr[..., None, :-1]
    ad = (ada * c.dt)[..., None, :]
    adaK = ada[..., None, :]
    zero_piece = c.zero_piece[None, :]

    l1r = 1.0 + r_t
    coef = torch.exp(-l1r * Rm - ld_m)
    v_pos = coef * (torch.expm1(-l1r * ad) / l1r - torch.expm1(-ad)) / (
        rates.safe * adaK
    )
    v_zero = torch.exp(-Rm - ld_m) * (1.0 - torch.exp(-ad) * (1.0 + ad)) / adaK
    dia = torch.where(rates.zero, v_zero, v_pos)
    dia = torch.where(zero_piece, 0.0, dia)

    plse = _prefix_lse(_log_single_integrals(rates, ada, Rr, c))
    dRm = (Rr[..., 1:] - Rr[..., :-1])[..., None, :]
    term2 = -torch.expm1(-dRm) * torch.exp(-Rm - ld_m + plse)
    return torch.einsum("hk,...rk->...hr", c.seg, dia + term2)


def tjj_above(a, grid: TimeGrid, n: int, c=None):
    """Double integrals "above": (..., M, n+1, n) with entries
    C[h, jj-2, j-2], jj = 2..n+2 (Moran eigen-rate C(jj,2)-1), j = 2..n+1
    (piecewise_constant_rate_function.cpp:213-299)."""
    c = consts(grid, a, c)
    ada = ada_on_grid(a, grid, c)
    Rr = cumulative_rate(ada, grid, c)
    ld_m = _log_denoms(Rr, c)[..., c.piece_h][..., None, None, :]
    k = c.above(n)  # (JJ, 1, 1) and (1, J, 1) rates
    l1, r = k.l1, k.r
    Rm = Rr[..., None, None, :-1]
    Rm1 = Rr[..., None, None, 1:]
    ad = (ada * c.dt)[..., None, None, :]
    adaK = ada[..., None, None, :]
    zero_piece = c.zero_piece[None, None, :]

    coef = torch.exp(-l1 * Rm - ld_m)
    denom_lr, abs_lr = k.denom, k.abs_lr
    # the only full-rank (JJ, J, K) transcendental, shared with term2
    em1 = torch.expm1(-abs_lr * ad)

    v_eq = coef * (1.0 - torch.exp(-r * ad) * (1.0 + r * ad)) / (r * r) / adaK
    v_lt = -coef * (
        torch.expm1(-l1 * ad) / l1 + torch.exp(-r * ad) * (-em1) / denom_lr
    ) / (r * adaK)
    v_gt = -coef * (
        torch.expm1(-l1 * ad) / l1 + torch.exp(-l1 * ad) * em1 / denom_lr
    ) / (r * adaK)
    dia = torch.where(k.eq, v_eq, torch.where(k.lt, v_lt, v_gt))
    dia = torch.where(zero_piece, 0.0, dia)

    slse = _suffix_lse(_log_single_integrals(k.single, ada, Rr, c))[..., None, :, :]
    coef1 = torch.exp(-l1 * Rm1 - ld_m)
    E0 = torch.exp(r * Rm + slse)
    E1 = torch.exp(r * Rm1 + slse)
    t_ne = torch.where(k.rp_pos, coef * E0, coef1 * E1) * (-em1) / abs_lr
    t_eq = ad * torch.exp(-ld_m + slse)
    term2 = torch.where(k.rp_zero, t_eq, t_ne)
    return torch.einsum("hk,...ijk->...hij", c.seg, dia + term2)


# ---------------------------------------------------------------------------
# Host-side (NumPy) utilities on raw (a, s) models — hidden-state balancing
# and other root finding outside the differentiable pipeline.
# ---------------------------------------------------------------------------

class HostRateFunction:
    "Plain NumPy piecewise-constant rate function (no hidden-state splicing)."

    def __init__(self, a, s):
        self.a = np.asarray(a, dtype=np.float64)
        self.ada = 1.0 / self.a
        self.s = np.asarray(s, dtype=np.float64)
        self.ts = np.concatenate([[0.0], np.cumsum(self.s)])
        self.ts[-1] = np.inf
        self.Rrng = np.concatenate(
            [[0.0], np.cumsum(self.ada[:-1] * np.diff(self.ts[:-1]))]
        )

    def R(self, t):
        "Cumulative hazard at time t (scalar or array)."
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        ip = np.minimum(
            np.searchsorted(self.ts, t, side="right") - 1, len(self.ada) - 1
        )
        out = self.Rrng[ip] + self.ada[ip] * (t - self.ts[ip])
        return out if out.size > 1 else out[0]

    def Rinv(self, y):
        "Inverse of R."
        y = np.atleast_1d(np.asarray(y, dtype=np.float64))
        ip = np.minimum(
            np.searchsorted(self.Rrng, y, side="right") - 1, len(self.ada) - 1
        )
        out = (y - self.Rrng[ip]) / self.ada[ip] + self.ts[ip]
        return out if out.size > 1 else out[0]
