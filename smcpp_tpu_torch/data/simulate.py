"""Generative simulation from the model's own coalescent HMM.

Port of ``simulate_contig`` and ``write_simulated`` of
smcpp_tpu/data/simulate.py: a hidden TMRCA path is sampled along the genome
from (pi, T), and per-site observations from the theta-incorporated CSFS —
the exact generative process the inference engine fits.  The model tensors
are computed in float64 on the CPU; the sampling is NumPy with an explicit
``RandomState``.
"""

import numpy as np
import torch

from ..inference import estimation
from ..ops import csfs as csfs_mod
from ..ops import grid as grid_mod
from ..ops import ratefunc, transition


def simulate_contig(model, theta, rho, L, n, seed=0, M=32):
    """Simulate one contig of length L bases with n undistinguished lineages.

    Returns an (rows, 4) int32 observation array in the SMC++ row format
    (span, a, b, nb) with nb == n everywhere.
    """
    rng = np.random.RandomState(seed)
    hs = estimation.balance_hidden_states(model, M)
    g = grid_mod.make_time_grid(model.s, hs)
    a_vals = torch.as_tensor(np.asarray(model.stepwise_values(), np.float64))
    with torch.no_grad():
        pi = ratefunc.initial_distribution(a_vals, g).numpy()
        T = transition.transition_matrix(a_vals, rho, g).numpy()
        em = csfs_mod.incorporate_theta(
            csfs_mod.conditioned_sfs(a_vals, g, n), theta
        ).numpy()  # (M, 3, n+1)

    # --- sample the hidden path as (state, run-length) pairs
    Tn = T / T.sum(axis=1, keepdims=True)
    self_p = np.diag(Tn)
    jump = Tn.copy()
    np.fill_diagonal(jump, 0.0)
    jump /= jump.sum(axis=1, keepdims=True)
    states, lengths = [], []
    s = rng.choice(len(pi), p=pi / pi.sum())
    pos = 0
    while pos < L:
        run = rng.geometric(max(1.0 - self_p[s], 1e-12))
        run = min(run, L - pos)
        states.append(s)
        lengths.append(run)
        pos += run
        if pos < L:
            s = rng.choice(len(pi), p=jump[s])

    # --- per-run emissions: segregating sites are sparse
    rows = []
    nk = em.shape[1] * em.shape[2]
    for s, run in zip(states, lengths):
        probs = em[s].ravel().astype(np.float64)
        probs = np.maximum(probs, 0)
        p_seg = 1.0 - probs[0] / probs.sum()
        k = rng.binomial(run, p_seg)
        if k == 0:
            rows.append((run, 0, 0, n))
            continue
        positions = np.sort(rng.choice(run, size=k, replace=False))
        seg_probs = probs.copy()
        seg_probs[0] = 0.0
        seg_probs /= seg_probs.sum()
        cats = rng.choice(nk, size=k, p=seg_probs)
        last = 0
        for p_, c in zip(positions, cats):
            gap = p_ - last
            if gap > 0:
                rows.append((gap, 0, 0, n))
            aa, bb = divmod(int(c), em.shape[2])
            rows.append((1, aa, bb, n))
            last = p_ + 1
        if run - last > 0:
            rows.append((run - last, 0, 0, n))
    return np.asarray(rows, dtype=np.int32)


def write_simulated(fn, model, theta, rho, L, n, seed=0, pid="pop1"):
    "Simulate and write one contig in SMC++ format."
    from . import format as fmt

    data = simulate_contig(model, theta, rho, L, n, seed)
    dist = [[["sim", 0], ["sim", 1]]]
    undist = [[["sim_u", i] for i in range(n)]]
    fmt.write_contig(fn, data, [pid], dist, undist)
    return fn
