"""Conditioned SFS (one population), in torch: expected branch lengths
subtending each (a, b) class, conditioned on the TMRCA of the distinguished
pair lying in each hidden interval.  Port of smcpp_tpu/ops/csfs.py
(reference SMC++ src/conditioned_sfs.cpp); the exact n-dependent
matrices come from ops/exact.py.
"""

import torch

from .. import defaults
from . import ratefunc
from .grid import TimeGrid


def conditioned_sfs(a, grid: TimeGrid, n: int, c=None):
    """CSFS branch lengths, shape (..., M, 3, n+1): row a' = derived count
    in the distinguished pair, column b = derived count among the
    undistinguished lineages.  The "above" contraction runs in the stable
    symmetrized Moran eigenbasis (exact.stable_eigensystem), its matrices
    from ``c`` (ops/qconst.py; made here when None)."""
    c = ratefunc.consts(grid, a, c)
    m = c.moran(n)
    tb = ratefunc.tjj_below(a, grid, n, c)  # (..., M, n+1)
    row0_below = tb @ m.M0  # (..., M, n)
    row1_below = tb @ m.M1  # (..., M, n+1)
    Ct = ratefunc.tjj_above(a, grid, n, c)[..., 1:, :]  # drop jj=2 (lambda=0)
    row0_above = torch.einsum("ik,...hki->...hk", m.X0, Ct) @ m.Uinv0
    row2_above = torch.einsum("ik,...hki->...hk", m.X2, Ct) @ m.Uinv2
    z = torch.zeros_like(tb[..., :1])
    return torch.stack(
        [
            torch.cat([z, row0_below + row0_above], -1),
            row1_below,
            torch.cat([row2_above, z], -1),
        ],
        -2,
    )


def incorporate_theta(csfs, theta, c=None):
    """Branch lengths -> per-site emission probabilities
    (conditioned_sfs.cpp:99-148): csfs * (-expm1(-theta tauh)) / tauh, the
    (0, 0) entry completing the distribution, floored at 1e-10."""
    c = ratefunc.consts(None, csfs, c)
    tauh = torch.sum(csfs, (-2, -1), keepdim=True)
    ret = csfs * (-torch.expm1(-theta * tauh)) / tauh
    total = torch.sum(ret, (-2, -1), keepdim=True)
    ret = torch.where(c.first(tuple(ret.shape[-2:])), 1.0 - total, ret)
    return torch.clamp(ret, min=defaults.emission_floor)
