"""Frozen copy of smcpp_tpu_torch/ops/ratefunc.py, the plain PyTorch and NumPy
code the benchmark's reference recomputes the port's set-up with.
Later changes to the port do not reach it.  The original docstring
follows.

Piecewise-constant coalescent rate function, in torch.

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

Branches that ``torch.where`` does not select are kept finite, so autograd
never multiplies a zero cotangent by inf.
"""

import numpy as np
import torch

from . import defaults
from .grid import TimeGrid

_LN2 = 0.6931471805599453


def nC2(v):
    v = np.asarray(v)
    return v * (v - 1) // 2


def _const(x, like):
    """A static numpy array as a tensor on ``like``'s device and dtype (a
    tensor, such as the piece widths of a grid that depends on a traced
    split time, passes through)."""
    if torch.is_tensor(x):
        return x.to(dtype=like.dtype, device=like.device)
    return torch.as_tensor(
        np.ascontiguousarray(x), dtype=like.dtype, device=like.device
    )


def ada_on_grid(a, grid: TimeGrid):
    "Per-augmented-piece inverse population size (the coalescent rate)."
    src = torch.as_tensor(grid.src, device=a.device)
    return (1.0 / a)[..., src]


def cumulative_rate(ada, grid: TimeGrid):
    """R(ts[i]) for every grid point i (K+1 values); the last entry is a
    huge-but-finite stand-in for R(inf)."""
    z = torch.zeros(ada.shape[:-1] + (1,), dtype=ada.dtype, device=ada.device)
    return torch.cat([z, torch.cumsum(ada * _const(grid.dt, ada), -1)], -1)


def _log1mexp(x):
    "log(-expm1(-x)) for x > 0, stable in both regimes."
    return torch.where(
        x > _LN2,
        torch.log1p(-torch.exp(-torch.clamp(x, max=700.0))),
        torch.log(-torch.expm1(-torch.clamp(x, min=1e-300))),
    )


def _log_denoms(Rr, grid: TimeGrid):
    """log P(coal in hidden interval h), with a leading -R_h shift
    (``log_denom`` of the reference)."""
    Rh = Rr[..., grid.hs_indices[:-1]]
    Rh1 = Rr[..., grid.hs_indices[1:]]
    return -Rh + _log1mexp(Rh1 - Rh)


def initial_distribution(a, grid: TimeGrid):
    """pi_m = e^{-R(h_m)} - e^{-R(h_{m+1})}, floored and normalized
    (src/inference_manager.cpp:56-69)."""
    Rr = cumulative_rate(ada_on_grid(a, grid), grid)
    ex = torch.exp(-Rr[..., grid.hs_indices])
    pi = torch.clamp(ex[..., :-1] - ex[..., 1:], min=defaults.pi_floor)
    return pi / torch.sum(pi, -1, keepdim=True)


def average_coal_times(a, grid: TimeGrid):
    """E[T | coal in hidden interval h] for each h
    (piecewise_constant_rate_function.cpp:371-403)."""
    ada = ada_on_grid(a, grid)
    Rr = cumulative_rate(ada, grid)
    ld = _log_denoms(Rr, grid)  # (..., M)
    dt = _const(grid.dt, ada)
    zero_piece = torch.as_tensor(grid.dt <= 0.0, device=ada.device)
    piece_int = torch.exp(-Rr[..., :-1]) * (-torch.expm1(-ada * dt)) / ada
    piece_int = torch.where(zero_piece, 0.0, piece_int)
    seg = _const(grid.segment_matrix(), ada)
    integral = torch.einsum(
        "hk,...k->...h", seg, piece_int * torch.exp(-ld[..., grid.interval_of_piece])
    )
    hs = grid.hidden_states
    t0 = _const(hs[:-1], ada)
    t1 = _const(np.where(np.isinf(hs[1:]), 0.0, hs[1:]), ada)
    R0 = Rr[..., grid.hs_indices[:-1]]
    R1 = Rr[..., grid.hs_indices[1:]]
    x = t0 * torch.exp(-(R0 + ld)) + integral - t1 * torch.exp(-(R1 + ld))
    # intervals with zero coalescent mass are undefined (reference: NaN)
    return torch.where(R1 - R0 > 0, x, torch.nan)


def _log_single_integrals(rates, ada, Rr, grid: TimeGrid):
    """log of int_{ts_k}^{ts_{k+1}} exp(-rate * R(t)) dt per (rate, piece);
    ``rates`` static (R,).  Returns (..., R, K)
    (piecewise_constant_rate_function.cpp:197-211)."""
    rates = np.asarray(rates, dtype=np.float64)[:, None]
    rates_t = _const(rates, ada)
    rates_safe = _const(np.where(rates == 0, 1.0, rates), ada)
    dt = _const(grid.dt, ada)
    zero_piece = torch.as_tensor((grid.dt <= 0.0)[None, :], device=ada.device)
    x = rates_safe * ada[..., None, :] * dt  # (..., R, K)
    x_safe = torch.where(zero_piece, 1.0, x)
    log_si = (
        -rates_t * Rr[..., None, :-1]
        + _log1mexp(x_safe)
        - torch.log(ada[..., None, :] * rates_safe)
    )
    log_dt = torch.log(torch.clamp(dt, min=1e-300))
    log_si = torch.where(_const(rates == 0, ada).bool(), log_dt, log_si)
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


def tjj_below(a, grid: TimeGrid, n: int):
    """Double integrals "below": (..., M, n+1), rate_j = C(j,2)-1 for
    j = 2..n+2 (piecewise_constant_rate_function.cpp:301-334)."""
    ada = ada_on_grid(a, grid)
    Rr = cumulative_rate(ada, grid)
    ld_m = _log_denoms(Rr, grid)[..., grid.interval_of_piece][..., None, :]
    rates = nC2(np.arange(2, n + 3)) - 1  # (n+1,), first entry 0
    ratesf = rates.astype(np.float64)[:, None]
    r_t = _const(ratesf, ada)
    dt = _const(grid.dt, ada)
    Rm = Rr[..., None, :-1]
    ad = (ada * dt)[..., None, :]
    adaK = ada[..., None, :]
    zero_piece = torch.as_tensor((grid.dt <= 0.0)[None, :], device=ada.device)

    l1r = 1.0 + r_t
    coef = torch.exp(-l1r * Rm - ld_m)
    v_pos = coef * (torch.expm1(-l1r * ad) / l1r - torch.expm1(-ad)) / (
        _const(np.where(ratesf == 0, 1.0, ratesf), ada) * adaK
    )
    v_zero = torch.exp(-Rm - ld_m) * (1.0 - torch.exp(-ad) * (1.0 + ad)) / adaK
    dia = torch.where(_const(ratesf == 0, ada).bool(), v_zero, v_pos)
    dia = torch.where(zero_piece, 0.0, dia)

    plse = _prefix_lse(_log_single_integrals(rates, ada, Rr, grid))
    dRm = (Rr[..., 1:] - Rr[..., :-1])[..., None, :]
    term2 = -torch.expm1(-dRm) * torch.exp(-Rm - ld_m + plse)
    seg = _const(grid.segment_matrix(), ada)
    return torch.einsum("hk,...rk->...hr", seg, dia + term2)


def tjj_above(a, grid: TimeGrid, n: int):
    """Double integrals "above": (..., M, n+1, n) with entries
    C[h, jj-2, j-2], jj = 2..n+2 (Moran eigen-rate C(jj,2)-1), j = 2..n+1
    (piecewise_constant_rate_function.cpp:213-299)."""
    ada = ada_on_grid(a, grid)
    Rr = cumulative_rate(ada, grid)
    ld_m = _log_denoms(Rr, grid)[..., grid.interval_of_piece][..., None, None, :]
    jjs = np.arange(2, n + 3)
    js = np.arange(2, n + 2)
    l1n = nC2(jjs).astype(np.float64)[:, None, None]  # (JJ,1,1)
    rn = nC2(js).astype(np.float64)[None, :, None]  # (1,J,1)
    l1, r = _const(l1n, ada), _const(rn, ada)
    dt = _const(grid.dt, ada)
    Rm = Rr[..., None, None, :-1]
    Rm1 = Rr[..., None, None, 1:]
    ad = (ada * dt)[..., None, None, :]
    adaK = ada[..., None, None, :]
    zero_piece = torch.as_tensor((grid.dt <= 0.0)[None, None, :], device=ada.device)

    coef = torch.exp(-l1 * Rm - ld_m)
    eq = _const(l1n == rn, ada).bool()
    denom_lr = _const(np.where(l1n - rn == 0, 1.0, l1n - rn), ada)
    abs_lr = _const(np.where(l1n == rn, 1.0, np.abs(l1n - rn)), ada)
    # the only full-rank (JJ, J, K) transcendental, shared with term2
    em1 = torch.expm1(-abs_lr * ad)

    v_eq = coef * (1.0 - torch.exp(-r * ad) * (1.0 + r * ad)) / (r * r) / adaK
    v_lt = -coef * (
        torch.expm1(-l1 * ad) / l1 + torch.exp(-r * ad) * (-em1) / denom_lr
    ) / (r * adaK)
    v_gt = -coef * (
        torch.expm1(-l1 * ad) / l1 + torch.exp(-l1 * ad) * em1 / denom_lr
    ) / (r * adaK)
    dia = torch.where(eq, v_eq, torch.where(_const(rn < l1n, ada).bool(), v_lt, v_gt))
    dia = torch.where(zero_piece, 0.0, dia)

    slse = _suffix_lse(_log_single_integrals(nC2(js), ada, Rr, grid))[..., None, :, :]
    rp = l1n - rn
    coef1 = torch.exp(-l1 * Rm1 - ld_m)
    E0 = torch.exp(r * Rm + slse)
    E1 = torch.exp(r * Rm1 + slse)
    t_ne = torch.where(_const(rp > 0, ada).bool(), coef * E0, coef1 * E1) * (-em1) / abs_lr
    t_eq = ad * torch.exp(-ld_m + slse)
    term2 = torch.where(_const(rp == 0, ada).bool(), t_eq, t_ne)
    seg = _const(grid.segment_matrix(), ada)
    return torch.einsum("hk,...ijk->...hij", seg, dia + term2)


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
