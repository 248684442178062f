"""pi, T and E of the two-population coalescent HMM in float64, the
distinguished pair in population 1: the port's split model
(smcpp_tpu_torch/models/model.py:SMCTwoPopulationModel, its ``for_pop``
splice) and its eager ``tensors()`` route (inference/manager.py:
TwoPopInferenceManager._tensors_eager), over the frozen copies of the Q
family and of the host joint CSFS (``jcsfs``)."""

import numpy as np
import torch

from . import csfs, emission, emission2, grid, ratefunc, transition
from .jcsfs import JointCSFS
from .model import SMCModel


def size_model(knots, N0, sizes, pid=None):
    "A piecewise history with ``sizes`` (of N0) from each knot on."
    m = SMCModel(knots, N0, "piecewise", pid)
    m.y[:] = np.log(np.asarray(sizes, np.float64))
    return m


def values_at(model, points):
    "The model's sizes at ``points`` (the spline, unclipped)."
    y = torch.as_tensor(np.asarray(model.y, np.float64))
    with torch.no_grad():
        return model.eval_at(y, np.asarray(points, np.float64)).numpy()


class SplitModel:
    """Two piecewise marginals and a clean split: population 2 is its own
    model below the split and population 1's above it."""

    def __init__(self, model1, model2, split):
        self.model1, self.model2, self.split = model1, model2, float(split)

    @classmethod
    def of(cls, truth):
        "From a configuration's ``truth``: pop1, pop2 (knots, sizes), N0, split."
        return cls(*(size_model(truth[p]["knots"], truth["N0"], truth[p]["sizes"], p)
                     for p in ("pop1", "pop2")), truth["split"])

    def pop2(self):
        """Population 2's marginal (the reference's for_pop splice,
        model.py:293-313): knots of both models and the split, model 2's
        values below the split, model 1's from it on."""
        m1, m2 = self.model1, self.model2
        kts = np.unique(np.sort(np.r_[m1.knots, m2.knots, self.split]))
        i = np.searchsorted(kts, self.split)
        vals = np.empty(len(kts))
        vals[:i] = values_at(m2, kts[:i])
        vals[i] = values_at(m1, [self.split])[0]
        vals[i + 1:] = values_at(m1, kts[i + 1:])
        return size_model(kts, m1.N0, vals, m2.pid)


def emission_index(contigs, n, polarization_error):
    "The joint emission index of every distinct key of the contigs."
    keys = np.unique(np.concatenate([c[:, 1:] for c in contigs]), axis=0)
    return emission2.build_emission_index_2pop(keys, n, (2, 0), polarization_error)


def joint_csfs(sm, n1, n2, hidden_states, K=10):
    "The split model's joint CSFS branch lengths, (M, 3, (n1 + 1)(n2 + 1))."
    m1, m2 = sm.model1, sm.pop2()
    return JointCSFS(n1, n2, hidden_states, K).compute(
        (m1.stepwise_values(), m1.s), (m2.stepwise_values(), m2.s), sm.split)


def tensors(sm, hidden_states, idx, theta, rho, alpha, device):
    """(pi, T, E), float64 on ``device``: pi, T and the average coalescence
    times from population 1's history (the pair's), E from the joint CSFS
    and the index ``idx``."""
    n1, n2 = idx.n
    m1 = sm.model1
    J = joint_csfs(sm, n1, n2, hidden_states)
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device)  # noqa: E731
    g = grid.make_time_grid(m1.s, np.asarray(hidden_states, np.float64))
    a = f64(m1.stepwise_values())
    with torch.no_grad():
        pi = ratefunc.initial_distribution(a, g)
        em = csfs.incorporate_theta(f64(J), theta)
        e2 = emission.e2_matrix(ratefunc.average_coal_times(a, g), theta, alpha)
        E = emission.emission_matrix(idx, em, e2)
        T = transition.transition_matrix(a, f64(rho), g)
    return pi, T, E
