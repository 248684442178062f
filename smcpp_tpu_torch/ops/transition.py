"""SMC' transition matrix over hidden TMRCA intervals, in torch.

Port of smcpp_tpu/ops/transition.py.  The 3-state recombination process
(0 = linked, 1 = floating lineage, 2 = re-coalesced below) is advanced across
the time grid with closed-form 3x3 matrix exponentials (sinh/cosh form,
reference src/transition.cpp:112-130) and prefix products.  The
below-diagonal entries accumulate nonnegative per-piece increments of
P(0, 2) instead of differencing nearly equal prefix products, so float64
suffices where the reference uses 256-bit MPFR (src/transition.cpp:133-169).

All functions take leading batch dimensions on ``a`` and ``rho``.
"""

import torch

from .. import defaults
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


def _piece_expms(ada, rho, c):
    """Per-piece 3x3 expm (..., K, 3, 3): identity for zero-width pieces, the
    absorbing matrix for the terminal piece."""
    # the closed form overflows on the terminal width: mask dt first
    dt = c.pe_dt
    E = expm_recomb(rho[..., None] * dt, ada * dt)
    E = torch.where(c.pe_last, c.absorbing, E)
    return torch.where(c.pe_zero[:, None, None], c.eye3, E)


def _prefix_products(E, eye3):
    """P_i = E_0 @ ... @ E_{i-1} for i = 0..K (P_0 = I): (..., K+1, 3, 3).
    A Python loop of 3x3 products (K <= ~120 pieces)."""
    eye = eye3.expand(E.shape[:-3] + (3, 3))
    prods = [eye]
    for k in range(E.shape[-3]):
        prods.append(prods[-1] @ E[..., k, :, :])
    return torch.stack(prods, -3)


def transition_matrix(a, rho, grid: TimeGrid, c=None):
    """The (..., M, M) transition kernel between hidden TMRCA intervals
    (reference HJTransition, src/transition.cpp:171-253); ``c`` the grid's
    ``QConsts`` (ops/qconst.py), made here when None."""
    M = grid.M
    c = ratefunc.consts(grid, a, c)
    rho = torch.as_tensor(rho, dtype=a.dtype, device=a.device)
    rho = rho.expand(a.shape[:-1])
    ada = ratefunc.ada_on_grid(a, grid, c)
    Rr = ratefunc.cumulative_rate(ada, grid, c)
    E = _piece_expms(ada, rho, c)
    P = _prefix_products(E, c.eye3)  # (..., K+1, 3, 3)

    R_hs = Rr[..., c.hs]

    # below-diagonal: increments of P(0, 2) between hidden states
    inc = P[..., :-1, 0, 0] * E[..., 0, 2] + P[..., :-1, 0, 1] * E[..., 1, 2]
    cum = torch.cat([torch.zeros_like(inc[..., :1]), torch.cumsum(inc, -1)], -1)
    expm_diff = cum[..., c.hs_mid] - cum[..., c.hs_lo2]  # (..., M-1)

    # average coalescence times and their enclosing pieces
    act = torch.nan_to_num(ratefunc.average_coal_times(a, grid, c), nan=0.0)
    ts = c.ts
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
    Rj = R_hs[..., 1:]
    Rkm1 = R_hs[..., :-1]
    dRk = Rj - Rkm1
    upper = c.upper
    # mask the exponent BEFORE exp (entries with k <= j would overflow)
    arg = torch.where(upper, -(Rkm1[..., None, :] - Rj[..., :, None]), -1.0)
    pc = torch.exp(arg) * (-torch.expm1(-dRk))[..., None, :]
    upper_part = torch.where(upper, p_float[..., :, None] * pc, 0.0)

    zero = torch.zeros(
        expm_diff.shape[:-1] + (1,), dtype=expm_diff.dtype, device=expm_diff.device
    )
    ed = torch.cat([expm_diff, zero], -1)
    lower_part = torch.where(c.lower, ed[..., None, :], 0.0)
    Phi = lower_part + upper_part
    rowsum = torch.sum(Phi, -1)
    Phi = Phi + torch.diag_embed(1.0 - rowsum)
    Phi = torch.clamp(Phi, min=defaults.transition_floor)
    beta = defaults.transition_beta
    # the reference divides beta by the number of hidden boundaries, M + 1
    return Phi * (1.0 - beta) + beta / (M + 1)
