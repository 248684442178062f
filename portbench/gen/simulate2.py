"""Joint contigs of two populations drawn from the split model's own
coalescent HMM, as the port's ``simulate_joint_contig``
(smcpp_tpu_torch/data/simulate.py) draws them: the distinguished pair's
hidden TMRCA path from population 1's (pi, T), and at each base a joint
observation from the theta-incorporated joint CSFS of the state it lies in.
The tensors come from the reference's frozen copies (``reference.tensors2``,
the host joint CSFS), in float64; the draws are ``simulate.contig``'s, on
the flat class a1 D + b1 (n2 + 1) + b2, D = (n1 + 1)(n2 + 1).  The rows are
those of the port's joint format, (span, a1, b1, n1, a2, b2, n2), with a2 = 0
(population 2 holds no distinguished lineage) and the full sample
everywhere."""

import json
import os

import numpy as np
import torch

from ..reference import grid, ratefunc, transition
from ..reference.csfs import incorporate_theta
from ..reference.tensors import balance_hidden_states
from ..reference.tensors2 import SplitModel, joint_csfs
from . import simulate


def model_tensors(sm, theta, rho, n1, n2, M=simulate.STATES):
    """pi (M,), T (M, M) and the per-state joint site distribution (M, 3 D)."""
    m1 = sm.model1
    hs = balance_hidden_states(m1, M)
    g = grid.make_time_grid(m1.s, hs)
    a = torch.as_tensor(np.asarray(m1.stepwise_values(), np.float64))
    with torch.no_grad():
        pi = ratefunc.initial_distribution(a, g).numpy()
        T = transition.transition_matrix(a, rho, g).numpy()
        em = incorporate_theta(torch.as_tensor(joint_csfs(sm, n1, n2, hs)), theta).numpy()
    return pi, T, np.maximum(em.reshape(len(pi), -1), 0.0)


def joint_rows(rows, n1, n2):
    """``simulate.contig``'s rows over the flat joint class (span, a1, rest,
    D - 1) as joint rows (span, a1, b1, n1, 0, b2, n2)."""
    b1, b2 = np.divmod(rows[:, 2], n2 + 1)
    out = np.zeros((len(rows), 7), np.int64)
    out[:, 0], out[:, 1], out[:, 2], out[:, 3] = rows[:, 0], rows[:, 1], b1, n1
    out[:, 5], out[:, 6] = b2, n2
    return out


def genome(cfg, lengths, seed, device):
    """The joint contigs of ``lengths`` for the configuration: its truth,
    theta, rho, n1 and n2; contig i from seed + i."""
    sm = SplitModel.of(cfg["truth"])
    n1, n2 = cfg["n1"], cfg["n2"]
    tens = model_tensors(sm, cfg["theta"], cfg["rho"], n1, n2)
    D = (n1 + 1) * (n2 + 1)
    out = [joint_rows(simulate.contig(sm.model1, cfg["theta"], cfg["rho"], int(L), D - 1,
                                      seed + i, device, tens), n1, n2)
           for i, L in enumerate(lengths)]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the program starts from an empty cache
    return out


def write_all(directory, contigs, n1, n2, pids=("pop1", "pop2")):
    """The contigs in the SMC++ text format (``smcfile.write``'s, with the
    joint header: the pair in population 1, none in population 2), as
    files c000.smc, c001.smc, ... in the contigs' order."""
    header = {"version": "portbench", "pids": list(pids),
              "dist": [[["d", 0], ["d", 1]], []],
              "undist": [[["u1", i] for i in range(n1)], [["u2", i] for i in range(n2)]]}
    paths = []
    for i, rows in enumerate(contigs):
        path = os.path.join(directory, f"c{i:03d}.smc")
        with open(path, "w") as f:
            f.write("# SMC++ " + json.dumps(header) + "\n")
            f.write("".join([" ".join(map(str, r)) + "\n" for r in rows.tolist()]))
        paths.append(path)
    return paths
