"""The port's two-population posterior against the benchmark's plain
reference (portbench/reference/: the frozen host joint CSFS ``jcsfs``, the
joint emission index ``emission2`` and the (pi, T, E) assembly
``tensors2``), which imports nothing of the port, on the CPU.

* (pi, T, E) on seeded random split models, n1 and n2 in 2-6, M in 4-8:
  the port's eager route (``_tensors_eager``, ops/jcsfs.py) equals the
  reference to rounding (rtol 1e-12: the same operations), and its
  ``tensors()``, the traced route (ops/jcsfs_traced.py), lies within rtol
  1e-6 of it in E: the traced route takes population 1's below-split CSFS
  at the split in the exact eps -> 0 limit where the eager route takes a
  two-sided interval of 1e-6 (ROADMAP.md, "Recorded divergences"); pi and
  T do not involve the joint CSFS and agree to rounding.
* A short joint contig drawn by the benchmark's generator (gen/simulate2.py),
  decoded by the port as ``posterior`` decodes it (float32 on the CPU),
  against the reference's float64 HMM over the same rows.
* The reference itself: summed over population 2's counts, its joint CSFS
  is the reference's one-population CSFS of model 1 at n1.
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench.gen import simulate2
from portbench.reference import csfs as ref_csfs
from portbench.reference import grid as ref_grid
from portbench.reference import hmm as ref_hmm
from portbench.reference import quantiles as ref_quantiles
from portbench.reference import tensors as ref_tensors
from portbench.reference import tensors2
from smcpp_tpu_torch.commands.posterior import posterior_quantiles
from smcpp_tpu_torch.inference import estimation
from smcpp_tpu_torch.inference.manager import make_manager
from smcpp_tpu_torch.models import model_from_dict

THETA = RHO = 2.5e-4
LEAD = [1, -1, 0, 0, -1, 0, 0]  # posterior's first row: one missing base


def random_truth(seed):
    """A split model of piecewise histories: 3-4 knots in (0.01, 5), sizes
    from 0.1 to 10, a split in (0.02, 2)."""
    rng = np.random.default_rng(seed)

    def pop():
        k = int(rng.integers(3, 5))
        knots = np.sort(np.exp(rng.uniform(np.log(0.01), np.log(5.0), k)))
        return {"knots": knots.tolist(), "sizes": np.exp(rng.uniform(-2.3, 2.3, k)).tolist()}

    return {"N0": 1e4, "split": float(np.exp(rng.uniform(np.log(0.02), np.log(2.0)))),
            "pop1": pop(), "pop2": pop()}


def port_model(truth):
    "The port's split model of a configuration's ``truth``."
    def marginal(p):
        return {"class": "SMCModel", "knots": truth[p]["knots"], "N0": truth["N0"],
                "spline_class": "Piecewise", "y": np.log(truth[p]["sizes"]).tolist(),
                "pid": p}

    return model_from_dict({"class": "SMCTwoPopulationModel", "model1": marginal("pop1"),
                            "model2": marginal("pop2"), "split": truth["split"]})


def manager(truth, contigs, n1, n2, M):
    "The port's manager as ``posterior`` builds it over ``contigs`` (joint rows)."
    m = port_model(truth)
    hs = estimation.balance_hidden_states(m.distinguished_model, M + 1)
    obs = [np.vstack([LEAD, c]) for c in contigs]
    im = make_manager((n1, n2), (2, 0), obs, hs, ("pop1", "pop2"), 0.5, device="cpu")
    im.set_model(m)
    im.theta, im.rho, im.alpha = THETA, RHO, 1
    return im, obs


def every_key(n1, n2):
    "One row of each full-sample joint key."
    return [np.array([[1, a1, b1, n1, 0, b2, n2] for a1 in range(3)
                      for b1 in range(n1 + 1) for b2 in range(n2 + 1)], np.int64)]


CASES = [(seed, 2 + seed % 5, 2 + (3 * seed + 1) % 5, 4 + seed % 5) for seed in range(8)]


@pytest.mark.parametrize("seed,n1,n2,M", CASES,
                         ids=[f"s{s}-n{a}-{b}-M{m}" for s, a, b, m in CASES])
def test_tensors_match_reference(seed, n1, n2, M):
    truth = random_truth(seed)
    im, obs = manager(truth, every_key(n1, n2), n1, n2, M)
    sm = tensors2.SplitModel.of(truth)
    hs = ref_tensors.balance_hidden_states(sm.model1, M + 1)
    np.testing.assert_array_equal(hs, im.hidden_states)
    idx = tensors2.emission_index(obs, (n1, n2), 0.5)
    np.testing.assert_array_equal(idx.keys, im.em_idx.keys)
    np.testing.assert_allclose(idx.W, im.em_idx.W, rtol=1e-15, atol=0)
    ref = tensors2.tensors(sm, hs, idx, THETA, RHO, 1, "cpu")
    for got, want in zip(im._tensors_eager(), ref):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    pi, T, E = im.tensors()
    torch.testing.assert_close(pi, ref[0], rtol=1e-12, atol=0)
    torch.testing.assert_close(T, ref[1], rtol=1e-12, atol=0)
    torch.testing.assert_close(E, ref[2], rtol=1e-6, atol=0)


def truth_of_config():
    "twopop_n18_20's truth (portbench/configs/twopop_n18_20.json)."
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "portbench", "configs", "twopop_n18_20.json")
    with open(path) as f:
        return json.load(f)["truth"]


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_decode_matches_reference(seed):
    """The port's normalised masses, quantiles and MAP path on a joint contig
    of 120 kbp (n1 = 4, n2 = 5, M = 8) against the reference's float64 HMM:
    the port decodes in float32, so the masses agree to about 1e-4 and the
    MAP path's score to a small fraction of a nat."""
    n1, n2, M = 4, 5, 8
    cfg = {"truth": truth_of_config(), "n1": n1, "n2": n2, "theta": 10 * THETA,
           "rho": 10 * RHO}
    contigs = simulate2.genome(cfg, [120_000], seed, "cpu")
    im, obs = manager(cfg["truth"], contigs, n1, n2, M)
    im.theta, im.rho = cfg["theta"], cfg["rho"]
    im.save_gamma = True
    im.E_step()
    g = im.gammas[0][: len(obs[0])].T
    g = g / np.where(g.sum(0) == 0, 1.0, g.sum(0))
    path = im.map_paths()[0][: len(obs[0])]
    qs = [0.025, 0.5, 0.975]
    q = posterior_quantiles(g, im.hidden_states, qs)

    sm = tensors2.SplitModel.of(cfg["truth"])
    idx = tensors2.emission_index(obs, (n1, n2), 0.5)
    pi, T, E = tensors2.tensors(sm, im.hidden_states, idx, cfg["theta"], cfg["rho"], 1, "cpu")
    keys = ref_tensors.keys_of(idx, obs[0])
    sp, ky = ref_hmm.pack([(obs[0][:, 0], keys)])
    R = ref_hmm.Rows(sp, ky, "cpu")
    gr = R.gammas(pi, T, E)[0, : len(obs[0])]
    gr = (gr / gr.sum(-1, keepdim=True)).numpy()
    assert np.abs(g.T - gr).max() < 2e-3
    assert np.abs(g.T - gr).mean() < 1e-4
    assert ref_quantiles.cdf_gap(gr, im.hidden_states, qs, q) < 2e-3
    full = np.zeros_like(sp)
    full[0, : len(path)] = path
    _, gap = R.viterbi_gap(pi, T, E, full)
    assert gap < 0.05


@pytest.mark.parametrize("n1,n2,M", [(3, 4, 6), (5, 2, 8), (2, 6, 5)])
def test_reference_jcsfs_marginal_is_the_one_population_csfs(n1, n2, M):
    """Below the split population 1 is model 1, and above it the ancestral
    population is model 1 too, so the joint CSFS summed over population 2's
    counts is model 1's CSFS at n1, but in two entries: (0, 0), where the
    joint CSFS holds the branches that population 2's lineages alone
    subtend and the CSFS holds 0, and (2, n1), where it holds those that all
    of population 1's and some of population 2's subtend.  The rest agrees
    to 1e-6 of each interval's largest entry (1e-8 seen): the transports
    average over the pair's coalescence time by a 10-node Gauss-Legendre
    rule, and the Moran exponentials go through a real-cast
    eigendecomposition."""
    sm = tensors2.SplitModel.of(truth_of_config())
    hs = ref_tensors.balance_hidden_states(sm.model1, M + 1)
    J = tensors2.joint_csfs(sm, n1, n2, hs).reshape(M, 3, n1 + 1, n2 + 1).sum(-1)
    g = ref_grid.make_time_grid(sm.model1.s, hs)
    with torch.no_grad():
        C = ref_csfs.conditioned_sfs(torch.as_tensor(sm.model1.stepwise_values()), g, n1)
    C = C.numpy()
    keep = np.ones((3, n1 + 1), bool)
    keep[0, 0] = keep[2, n1] = False
    gap = np.abs(J - C)[:, keep].max(1) / np.abs(C[:, keep]).max(1)
    assert gap.max() < 1e-6, (
        "the joint CSFS's marginal over population 2 is not model 1's CSFS: "
        f"relative gaps by interval {gap}")
