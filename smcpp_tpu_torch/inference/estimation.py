"""Estimation utilities: hidden-state balancing and time-point grids.

Host-side NumPy (the reference routes these through the C++ rate function;
SMC++ smcpp/estimation_tools.py:170-233)."""

import numpy as np

from ..ops.ratefunc import HostRateFunction


def balance_hidden_states(model, M):
    """Break points [0, b_1, ..., b_{M-1}, inf) with equal coalescent mass
    under the model.  Returned in coalescent units (the reference returns
    generations and every caller divides by 2 N0 again).

    The coalescent survival function is exp(-R(t)) with R piecewise linear,
    so the equal-mass quantiles come in closed form from R's exact inverse —
    no iterative root finding (the reference brackets + brentqs each one,
    estimation_tools.py:170-197)."""
    eta = HostRateFunction(model.stepwise_values(), model.s)
    pieces = M - 1
    survival = (pieces - np.arange(1, pieces)) / pieces
    interior = np.atleast_1d(eta.Rinv(-np.log(survival)))
    return np.concatenate([[0.0], interior, [np.inf]])


def extract_pieces(piece_str):
    """Convert a PSMC-style piece string like "32*1+16*2" to piece spans
    (estimation_tools.py:28-38)."""
    pieces = []
    for piece in piece_str.split("+"):
        try:
            num, span = map(int, piece.split("*"))
        except ValueError:
            span = int(piece)
            num = 1
        pieces += [span] * num
    return pieces


def construct_time_points(t1, tK, pieces, offset):
    "Log-spaced time points grouped by pieces (estimation_tools.py:41-48)."
    s = np.diff(
        np.logspace(np.log10(offset + t1), np.log10(tK), sum(pieces) + 1)
    )
    time_points = np.zeros(len(pieces))
    count = 0
    for i, p in enumerate(pieces):
        time_points[i] = s[count : count + p].sum()
        count += p
    return np.concatenate([[t1], time_points])
