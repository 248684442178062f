"""Frozen copy of smcpp_tpu_torch/ops/transition.py, the plain PyTorch and NumPy
code the benchmark's reference recomputes the port's set-up with.
Later changes to the port do not reach it.  The original docstring
follows.

SMC' transition matrix over hidden TMRCA intervals, in torch.

Port of smcpp_tpu/ops/transition.py.  The 3-state recombination process
(0 = linked, 1 = floating lineage, 2 = re-coalesced below) is advanced across
the time grid with closed-form 3x3 matrix exponentials (sinh/cosh form,
reference src/transition.cpp:112-130) and prefix products.  The
below-diagonal entries accumulate nonnegative per-piece increments of
P(0, 2) instead of differencing nearly equal prefix products, so float64
suffices where the reference uses 256-bit MPFR (src/transition.cpp:133-169).

All functions take leading batch dimensions on ``a`` and ``rho``.
"""

import numpy as np
import torch

from . import defaults
from . import ratefunc
from .grid import TimeGrid


def expm_recomb(c_rho, c_eta):
    """Closed-form expm of c_rho*A_rho + c_eta*A_eta, broadcasting over
    leading dims; returns (..., 3, 3)."""
    sq = torch.clamp(torch.sqrt(4.0 * c_eta * c_eta + c_rho * c_rho), min=1e-300)
    s = torch.sinh(0.5 * sq) / sq
    c = torch.cosh(0.5 * sq)
    e = torch.exp(-c_eta - c_rho / 2.0)
    q00 = e * (c + (2.0 * c_eta - c_rho) * s)
    q01 = 2.0 * e * c_rho * s
    q02 = 1.0 - q00 - q01
    q10 = 2.0 * e * c_eta * s
    q11 = e * (c - (2.0 * c_eta - c_rho) * s)
    q12 = 1.0 - q10 - q11
    z = torch.zeros_like(q00)
    o = torch.ones_like(q00)
    return torch.stack(
        [
            torch.stack([q00, q01, q02], -1),
            torch.stack([q10, q11, q12], -1),
            torch.stack([z, z, o], -1),
        ],
        -2,
    )


def _piece_expms(ada, rho, grid: TimeGrid):
    """Per-piece 3x3 expm (..., K, 3, 3): identity for zero-width pieces, the
    absorbing matrix for the terminal piece."""
    is_last = np.zeros(grid.K, dtype=bool)
    is_last[-1] = True
    zero_piece = torch.as_tensor(~is_last & (grid.dt <= 0.0), device=ada.device)
    # the closed form overflows on the terminal width: mask dt first
    dt = ratefunc._const(np.where(is_last, 1.0, grid.dt), ada)
    E = expm_recomb(rho[..., None] * dt, ada * dt)
    absorbing = torch.tensor(
        [[0.0, 0.0, 1.0]] * 3, dtype=E.dtype, device=E.device
    )
    last = torch.as_tensor(is_last, device=ada.device)[:, None, None]
    E = torch.where(last, absorbing, E)
    ident = torch.eye(3, dtype=E.dtype, device=E.device)
    return torch.where(zero_piece[:, None, None], ident, E)


def _prefix_products(E):
    """P_i = E_0 @ ... @ E_{i-1} for i = 0..K (P_0 = I): (..., K+1, 3, 3).
    A Python loop of 3x3 products (K <= ~120 pieces)."""
    eye = torch.eye(3, dtype=E.dtype, device=E.device).expand(
        E.shape[:-3] + (3, 3)
    )
    prods = [eye]
    for k in range(E.shape[-3]):
        prods.append(prods[-1] @ E[..., k, :, :])
    return torch.stack(prods, -3)


def transition_matrix(a, rho, grid: TimeGrid):
    """The (..., M, M) transition kernel between hidden TMRCA intervals
    (reference HJTransition, src/transition.cpp:171-253)."""
    M = grid.M
    rho = torch.as_tensor(rho, dtype=a.dtype, device=a.device)
    rho = rho.expand(a.shape[:-1])
    ada = ratefunc.ada_on_grid(a, grid)
    Rr = ratefunc.cumulative_rate(ada, grid)
    E = _piece_expms(ada, rho, grid)
    P = _prefix_products(E)  # (..., K+1, 3, 3)

    H = grid.hs_indices
    R_hs = Rr[..., H]

    # below-diagonal: increments of P(0, 2) between hidden states
    inc = P[..., :-1, 0, 0] * E[..., 0, 2] + P[..., :-1, 0, 1] * E[..., 1, 2]
    cum = torch.cat([torch.zeros_like(inc[..., :1]), torch.cumsum(inc, -1)], -1)
    expm_diff = cum[..., H[1:-1]] - cum[..., H[:-2]]  # (..., M-1)

    # average coalescence times and their enclosing pieces
    act = torch.nan_to_num(ratefunc.average_coal_times(a, grid), nan=0.0)
    ts = ratefunc._const(grid.ts, a)
    rct_ip = torch.clamp(
        torch.searchsorted(ts, act.detach().contiguous(), right=True) - 1,
        0, grid.K - 1,
    )  # (..., M)
    delta = act - ts[rct_ip]
    ada_r = torch.gather(ada, -1, rct_ip)
    Epart = expm_recomb(rho[..., None] * delta, ada_r * delta)  # (..., M, 3, 3)
    idx = rct_ip[..., None, None].expand(rct_ip.shape + (3, 3))
    B = torch.gather(P, -3, idx) @ Epart
    R_rct = torch.gather(Rr, -1, rct_ip) + ada_r * delta
    p_float = B[..., 0, 1] * torch.exp(-(R_hs[..., 1:] - R_rct))

    # coalescence of the floating lineage in a higher interval k > j
    j_idx = np.arange(1, M + 1)
    Rj = R_hs[..., j_idx]
    Rkm1 = R_hs[..., j_idx - 1]
    dRk = R_hs[..., j_idx] - Rkm1
    upper = torch.as_tensor(j_idx[None, :] > j_idx[:, None], device=a.device)
    # mask the exponent BEFORE exp (entries with k <= j would overflow)
    arg = torch.where(upper, -(Rkm1[..., None, :] - Rj[..., :, None]), -1.0)
    pc = torch.exp(arg) * (-torch.expm1(-dRk))[..., None, :]
    upper_part = torch.where(upper, p_float[..., :, None] * pc, 0.0)

    lower = torch.as_tensor(
        np.arange(M)[None, :] < np.arange(M)[:, None], device=a.device
    )
    zero = torch.zeros(
        expm_diff.shape[:-1] + (1,), dtype=expm_diff.dtype, device=expm_diff.device
    )
    ed = torch.cat([expm_diff, zero], -1)
    lower_part = torch.where(lower, ed[..., None, :], 0.0)
    Phi = lower_part + upper_part
    rowsum = torch.sum(Phi, -1)
    Phi = Phi + torch.diag_embed(1.0 - rowsum)
    Phi = torch.clamp(Phi, min=defaults.transition_floor)
    beta = defaults.transition_beta
    # the reference divides beta by the number of hidden boundaries, M + 1
    return Phi * (1.0 - beta) + beta / (M + 1)
