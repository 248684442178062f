"""Generative simulation from the model's own coalescent HMM.

Port of ``simulate_contig``, ``write_simulated``, ``simulate_joint_contig``
and ``write_simulated_joint`` of smcpp_tpu/data/simulate.py: a hidden TMRCA
path is sampled along the genome from (pi, T), and per-site observations
from the theta-incorporated CSFS (or, for two populations, the joint CSFS) —
the exact generative process the inference engine fits.  The model tensors
are computed in float64 on the CPU; the sampling is NumPy with an explicit
``RandomState``.

``synth_contig`` is a copy of bench.py's synthetic observation stream (the
E-step shape of the C3 benchmark cell), drawn from a ``numpy.random.Generator``.
"""

import numpy as np
import torch

from ..inference import estimation
from ..ops import csfs as csfs_mod
from ..ops import grid as grid_mod
from ..ops import ratefunc, transition


def _hidden_runs(pi, T, L, rng):
    "The hidden path as (state, run-length) pairs, sampled from (pi, T)."
    Tn = T / T.sum(axis=1, keepdims=True)
    self_p = np.diag(Tn)
    jump = Tn.copy()
    np.fill_diagonal(jump, 0.0)
    jump /= jump.sum(axis=1, keepdims=True)
    states, lengths = [], []
    s = rng.choice(len(pi), p=pi / pi.sum())
    pos = 0
    while pos < L:
        run = min(rng.geometric(max(1.0 - self_p[s], 1e-12)), L - pos)
        states.append(s)
        lengths.append(run)
        pos += run
        if pos < L:
            s = rng.choice(len(pi), p=jump[s])
    return states, lengths


def _site_runs(em, states, lengths, rng):
    """Per-run emissions (segregating sites are sparse): the rows of the
    runs as (span, category) arrays, category -1 for a nonsegregating
    stretch and the flat index into ``em[state]`` for a segregating site.
    Per run, in order: the stretch before each site, the site (span 1), the
    stretch after the last one; stretches of span 0 are dropped.  The draws
    are those of the reference package's per-site loop, in its order."""
    probs = np.maximum(em.reshape(len(em), -1).astype(np.float64), 0)
    nk = probs.shape[1]
    p_seg = 1.0 - probs[:, 0] / probs.sum(1)
    seg_probs = probs.copy()
    seg_probs[:, 0] = 0.0
    seg_probs /= seg_probs.sum(1, keepdims=True)
    ks, positions, cats = [], [], []
    for s, run in zip(states, lengths):
        k = rng.binomial(run, p_seg[s])
        ks.append(k)
        if k == 0:
            continue
        positions.append(np.sort(rng.choice(run, size=k, replace=False)))
        cats.append(rng.choice(nk, size=k, p=seg_probs[s]))
    lengths = np.asarray(lengths, np.int64)
    ks = np.asarray(ks, np.int64)
    P = np.concatenate(positions).astype(np.int64) if positions else np.zeros(0, np.int64)
    C = np.concatenate(cats).astype(np.int64) if cats else np.zeros(0, np.int64)
    n_runs = len(lengths)
    run_of_site = np.repeat(np.arange(n_runs), ks)
    first = np.concatenate([[0], np.cumsum(ks)[:-1]]).astype(np.int64)
    j = np.arange(len(P)) - first[run_of_site]  # the site's index in its run
    prev_end = np.where(j > 0, np.concatenate([[0], P[:-1] + 1]), 0)
    has = ks > 0
    last_end = np.zeros(n_runs, np.int64)
    last_end[has] = P[first[has] + ks[has] - 1] + 1
    base = 2 * first + np.arange(n_runs)  # each run's first row
    span = np.empty(2 * len(P) + n_runs, np.int64)
    cat = np.full(len(span), -1, np.int64)
    at = base[run_of_site] + 2 * j
    span[at] = P - prev_end
    span[at + 1] = 1
    cat[at + 1] = C
    span[base + 2 * ks] = lengths - last_end
    keep = span > 0
    return span[keep], cat[keep]


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
    states, lengths = _hidden_runs(pi, T, L, rng)
    span, cat = _site_runs(em, states, lengths, rng)
    seg = cat >= 0
    aa, bb = np.divmod(cat, em.shape[2])
    return np.c_[span, np.where(seg, aa, 0), np.where(seg, bb, 0),
                 np.full(len(span), n)].astype(np.int32)


def write_simulated(fn, model, theta, rho, L, n, seed=0, pid="pop1"):
    "Simulate and write one contig in SMC++ format."
    from . import format as fmt

    data = simulate_contig(model, theta, rho, L, n, seed)
    dist = [[["sim", 0], ["sim", 1]]]
    undist = [[["sim_u", i] for i in range(n)]]
    fmt.write_contig(fn, data, [pid], dist, undist)
    return fn


def simulate_joint_contig(model12, theta, rho, L, n1, n2, seed=0, M=24):
    """Simulate a two-population (a1=2) contig from the joint generative HMM:
    hidden TMRCA path from the pop-1 model's (pi, T), per-site observations
    from the theta-incorporated joint CSFS.

    Returns (rows, 7) int32: (span, a1, b1, n1, a2, b2, n2)."""
    from ..ops.jcsfs import JointCSFS

    rng = np.random.RandomState(seed)
    m1 = model12.model1
    hs = estimation.balance_hidden_states(m1, M)
    g = grid_mod.make_time_grid(m1.s, hs)
    a_vals = torch.as_tensor(np.asarray(m1.stepwise_values(), np.float64))
    with torch.no_grad():
        pi = ratefunc.initial_distribution(a_vals, g).numpy()
        T = transition.transition_matrix(a_vals, rho, g).numpy()

    jc = JointCSFS(n1, n2, 2, 0, hs, K=10, seed=seed)
    m2 = model12.model2
    J = jc.compute(
        (np.asarray(m1.stepwise_values(), np.float64), m1.s),
        (np.asarray(m2.stepwise_values(), np.float64), m2.s),
        model12.split,
    )  # (M, 3, (n1+1)(n2+1))
    em = csfs_mod.incorporate_theta(torch.as_tensor(J), theta).numpy()
    states, lengths = _hidden_runs(pi, T, L, rng)
    span, cat = _site_runs(em, states, lengths, rng)
    seg = cat >= 0
    D2 = n2 + 1
    a1_, rest = np.divmod(cat, (n1 + 1) * D2)
    b1_, b2_ = np.divmod(rest, D2)
    z = np.zeros(len(span), np.int64)
    return np.c_[span, np.where(seg, a1_, 0), np.where(seg, b1_, 0), z + n1,
                 z, np.where(seg, b2_, 0), z + n2].astype(np.int32)


def write_simulated_joint(fn, model12, theta, rho, L, n1, n2, seed=0):
    "Simulate and write one two-population contig in SMC++ format."
    from . import format as fmt

    data = simulate_joint_contig(model12, theta, rho, L, n1, n2, seed)
    dist = [[["sim", 0], ["sim", 1]], []]
    undist = [[["u1", i] for i in range(n1)], [["u2", i] for i in range(n2)]]
    fmt.write_contig(fn, data, [model12.model1.pid, model12.model2.pid],
                     dist, undist)
    return fn


def synth_contig(rng, n_windows, n_keys, full_key_lo):
    """Span-compressed (span, key) rows of ``n_windows`` windows in all,
    mimicking thinned and binned human data: mostly short runs of keys 0-2
    (nonsegregating and dinucleotide windows), some long ones, and sparse
    single windows of keys in [full_key_lo, n_keys).  ``rng`` is a
    ``numpy.random.Generator``; the same generator state gives the same rows
    as bench.py's ``synth_contig``."""
    out_spans = []
    out_keys = []
    total = 0
    while total < n_windows:
        m = 200_000
        r = rng.random(m)
        spans = np.where(
            r < 0.80,
            rng.geometric(0.45, m),
            np.where(r < 0.97, rng.geometric(0.02, m), 1),
        ).astype(np.int64)
        keys = np.where(
            r < 0.97,
            rng.integers(0, 3, m),
            rng.integers(full_key_lo, n_keys, m),
        ).astype(np.int32)
        cs = np.cumsum(spans)
        take = np.searchsorted(cs, n_windows - total, side="left") + 1
        take = min(take, m)
        spans = spans[:take]
        keys = keys[:take]
        overshoot = int(np.sum(spans)) - (n_windows - total)
        if overshoot > 0:
            spans[-1] -= overshoot
        total += int(np.sum(spans))
        out_spans.append(spans)
        out_keys.append(keys)
    s = np.concatenate(out_spans)
    k = np.concatenate(out_keys)
    keep = s > 0
    return np.c_[s[keep], k[keep]].astype(np.int64)
