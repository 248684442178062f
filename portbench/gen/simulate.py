"""Contigs drawn from the model's own coalescent HMM, as the port's
``simulate_contig`` (smcpp_tpu_torch/data/simulate.py) draws them: a hidden
TMRCA path along the genome from (pi, T), and at each base an observation
from the theta-incorporated CSFS of the state it lies in.  The model's
tensors come from the reference's frozen copy of the Q family, in float64.

What differs is where the draws are made.  The hidden path is a jump chain
drawn on the host (one step a run of a state, some tens of thousands a
chromosome); each base's segregating-or-not and each segregating site's
class are drawn on ``device`` with a ``torch.Generator`` seeded from the
run's seed, in a few large calls, so a chromosome takes well under a
second.  The rows are those of the SMC++ format, (span, a, b, nb), with
nb = n everywhere: runs of nonsegregating bases and single sites.
"""

import numpy as np
import torch

from ..reference import csfs, grid, ratefunc, transition
from ..reference.model import SMCModel
from ..reference.tensors import balance_hidden_states

STATES = 32  # hidden-state edges of the simulation, as the port's simulate_contig


def truth_model(cfg):
    "The configuration's true size history (its 'truth' entry)."
    t = cfg["truth"]
    m = SMCModel(t["knots"], t["N0"], t.get("spline", "piecewise"), "pop1")
    m.y[:] = np.log(np.asarray(t["sizes"], np.float64))
    return m


def model_tensors(model, theta, rho, n, M=STATES):
    "pi (M,), T (M, M) and the per-state site distribution (M, 3 (n + 1))."
    hs = balance_hidden_states(model, M)
    g = grid.make_time_grid(model.s, hs)
    a = torch.as_tensor(np.asarray(model.stepwise_values(), np.float64))
    with torch.no_grad():
        pi = ratefunc.initial_distribution(a, g).numpy()
        T = transition.transition_matrix(a, rho, g).numpy()
        em = csfs.incorporate_theta(csfs.conditioned_sfs(a, g, n), theta).numpy()
    return pi, T, np.maximum(em.reshape(len(pi), -1), 0.0)


def hidden_runs(pi, T, L, rng):
    """The hidden path as (states, run lengths) summing to L, from a
    ``numpy.random.Generator``: each run's length is geometric in the
    state's self-transition, each next state drawn from the off-diagonal
    row."""
    Tn = T / T.sum(1, keepdims=True)
    stay = np.diag(Tn).copy()
    jump = Tn.copy()
    np.fill_diagonal(jump, 0.0)
    cum = np.cumsum(jump / jump.sum(1, keepdims=True), 1)
    cum[:, -1] = 1.0
    log_stay = np.log(np.clip(stay, 1e-300, 1.0 - 1e-12))
    s = int(np.searchsorted(np.cumsum(pi / pi.sum()), rng.random()))
    s = min(s, len(pi) - 1)
    states, lengths, pos = [], [], 0
    while pos < L:
        u, v = rng.random(2)
        run = min(int(np.ceil(np.log1p(-u) / log_stay[s])) or 1, L - pos)
        states.append(s)
        lengths.append(run)
        pos += run
        s = min(int(np.searchsorted(cum[s], v, side="right")), len(pi) - 1)
    return np.asarray(states, np.int64), np.asarray(lengths, np.int64)


def contig(model, theta, rho, L, n, seed, device, tensors=None):
    """One contig of L bases with n undistinguished lineages, as an (rows, 4)
    int64 array (span, a, b, nb)."""
    pi, T, em = tensors if tensors is not None else model_tensors(model, theta, rho, n)
    rng = np.random.default_rng(seed)
    states, lengths = hidden_runs(pi, T, L, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2**62)))
    emt = torch.as_tensor(em, device=device)
    p_seg = 1.0 - emt[:, 0] / emt.sum(1)
    seg = emt.clone()
    seg[:, 0] = 0.0
    cdf = torch.cumsum(seg / seg.sum(1, keepdim=True), 1)
    st = torch.repeat_interleave(torch.as_tensor(states, device=device),
                                 torch.as_tensor(lengths, device=device))
    u = torch.rand(L, generator=gen, device=device, dtype=torch.float64)
    pos = torch.nonzero(u < p_seg[st])[:, 0]
    del u
    sst = st[pos]
    del st
    w = torch.rand(len(pos), generator=gen, device=device, dtype=torch.float64)
    cat = torch.empty(len(pos), dtype=torch.int64, device=device)
    for s in range(len(pi)):
        on = sst == s
        if bool(on.any()):
            c = torch.searchsorted(cdf[s], w[on], right=True)
            cat[on] = torch.clamp(c, max=cdf.shape[1] - 1)
    pos, cat = pos.cpu().numpy(), cat.cpu().numpy()
    return rows_from_sites(pos, cat, L, n)


def rows_from_sites(pos, cat, L, n):
    """(span, a, b, nb) rows of a contig of L bases whose segregating sites
    lie at ``pos`` (sorted) with flat CSFS class ``cat`` = a (n + 1) + b."""
    k = len(pos)
    gap = np.diff(np.r_[-1, pos]) - 1  # nonsegregating bases before each site
    tail = L - (pos[-1] + 1 if k else 0)
    rows = np.zeros((2 * k + 1, 4), np.int64)
    rows[0:2 * k:2, 0] = gap
    rows[1:2 * k:2, 0] = 1
    rows[1:2 * k:2, 1], rows[1:2 * k:2, 2] = np.divmod(cat, n + 1)
    rows[2 * k, 0] = tail
    rows[:, 3] = n
    return rows[rows[:, 0] > 0]


def genome(cfg, lengths, seed, device):
    """The contigs of ``lengths`` for the configuration: its truth, theta,
    rho and n; contig i from seed + i."""
    m = truth_model(cfg)
    n = cfg["n"]
    tens = model_tensors(m, cfg["theta"], cfg["rho"], n)
    out = [contig(m, cfg["theta"], cfg["rho"], int(L), n, seed + i, device, tens)
           for i, L in enumerate(lengths)]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the program starts from an empty cache
    return out
