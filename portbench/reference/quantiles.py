"""How far a posterior TMRCA quantile lies from its level under the
reference's posterior.

``posterior`` reports, for each row and level q, the point where the
row's piecewise-linear CDF over the hidden intervals reaches q (the left
edge of the last, infinite interval where it is reached there).  The
reference reads the CDF of its own masses at that point and reports how far
the CDF lies from q: 0 for an exact answer, and a distance in probability
wherever a quantile sits on a flat stretch of the CDF, so that the check
does not swing with rounding there."""

import numpy as np


def cdf_gap(gamma, hidden_states, qs, x):
    """Largest |F(x) - q| over rows and levels: gamma (L, M) the reference's
    masses of each row (rows sum to 1), x (len(qs), L) the reported
    quantiles in coalescent units."""
    hs = np.asarray(hidden_states, np.float64)
    M = gamma.shape[1]
    cdf = np.cumsum(gamma, 1)
    prev = np.concatenate([np.zeros((len(gamma), 1)), cdf[:, :-1]], 1)
    edges = hs[:M]  # left edges; the last interval is infinite
    worst = 0.0
    rows = np.arange(len(gamma))
    for qi, q in enumerate(qs):
        xq = x[qi]
        m = np.clip(np.searchsorted(edges, xq, side="right") - 1, 0, M - 1)
        lo = edges[m]
        hi = np.where(m + 1 < M, hs[np.minimum(m + 1, M)], np.inf)
        width = np.where(np.isfinite(hi), hi - lo, 1.0)
        frac = np.where(np.isfinite(hi), np.clip((xq - lo) / width, 0.0, 1.0), 0.0)
        f_lo = prev[rows, m] + gamma[rows, m] * frac
        # at the left edge of the infinite interval the reported point
        # stands for all of its mass
        f_hi = np.where(m == M - 1, 1.0, f_lo)
        worst = max(worst, float(np.max(np.maximum(f_lo - q, q - f_hi), initial=0.0)))
    return worst


def posterior_quantiles(gamma, hidden_states, qs):
    """Posterior TMRCA quantiles per row from state masses gamma (M, L):
    piecewise-linear CDF inversion within each hidden interval, the left
    edge of the infinite last one (a frozen copy of the port's
    commands/posterior.py:posterior_quantiles, for the control)."""
    cdf = np.cumsum(gamma, axis=0)
    hs = np.asarray(hidden_states)
    out = np.empty((len(qs), gamma.shape[1]))
    for qi, q in enumerate(qs):
        m = np.argmax(cdf >= q, axis=0)
        prev = np.take_along_axis(np.vstack([np.zeros((1, cdf.shape[1])), cdf]), m[None], 0)[0]
        g = np.take_along_axis(gamma, m[None], 0)[0]
        lo, hi = hs[m], hs[m + 1]
        hi = np.where(np.isinf(hi), lo, hi)
        frac = np.clip((q - prev) / np.maximum(g, 1e-30), 0.0, 1.0)
        out[qi] = lo + frac * (hi - lo)
    return out
