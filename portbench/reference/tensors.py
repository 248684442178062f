"""pi, T and E of the coalescent HMM from a model's parameters, in float64:
the port's ``_pi_and_e`` and ``_hmm_tensors`` (inference/manager.py) and
``balance_hidden_states`` (inference/estimation.py) over the frozen copy of
the Q family."""

import numpy as np
import torch

from . import csfs, emission, grid, ratefunc, transition
from .model import SMCModel


def balance_hidden_states(model, M):
    """Break points [0, b_1, ..., b_{M-1}, inf) with equal coalescent mass
    under ``model``, in coalescent units."""
    eta = ratefunc.HostRateFunction(model.stepwise_values(), model.s)
    pieces = M - 1
    survival = (pieces - np.arange(1, pieces)) / pieces
    interior = np.atleast_1d(eta.Rinv(-np.log(survival)))
    return np.concatenate([[0.0], interior, [np.inf]])


def constant_model(ne_n0, N0):
    "The one-piece model ``estimate`` balances its hidden states under."
    m = SMCModel([1.0], N0, "piecewise", None)
    m.y[:] = np.log(ne_n0)
    return m


def emission_index(contigs, n, polarization_error):
    "The emission index of every distinct (a, b, nb) of the contigs."
    keys = np.unique(np.concatenate([c[:, 1:] for c in contigs]), axis=0)
    return emission.build_emission_index(keys, n, na=2,
                                         polarization_error=polarization_error)


def keys_of(idx, rows):
    "Each row's key id in the emission index."
    lut = idx.key_id()
    return np.fromiter((lut[tuple(r)] for r in rows[:, 1:].tolist()),
                       np.int64, len(rows))


class Tensors:
    """(pi, T, E) as differentiable functions of (y, rho) for one model
    layout: the knots, N0, the hidden states, n, theta and alpha."""

    def __init__(self, knots, N0, hidden_states, idx, theta, alpha, device,
                 spline="piecewise"):
        self.model = SMCModel(knots, N0, spline, None)
        self.hidden_states = np.asarray(hidden_states, np.float64)
        self.grid = grid.make_time_grid(self.model.s, self.hidden_states)
        self.idx, self.theta, self.alpha = idx, theta, alpha
        self.device = device

    def f64(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device)

    def __call__(self, y, rho):
        "(pi, T, E) at knot values y (K,) and rho, f64 tensors."
        a = self.model.stepwise_values_fn(y)
        bl = csfs.conditioned_sfs(a, self.grid, self.idx.n)
        pi = ratefunc.initial_distribution(a, self.grid)
        em = csfs.incorporate_theta(bl, self.theta)
        e2 = emission.e2_matrix(ratefunc.average_coal_times(a, self.grid),
                                self.theta, self.alpha)
        E = emission.emission_matrix(self.idx, em, e2)
        T = transition.transition_matrix(a, rho, self.grid)
        return pi, T, E

    def at(self, y, rho):
        with torch.no_grad():
            return self(self.f64(y), self.f64(rho))


def q_value(pi, T, E, stats):
    "Q = gamma0 . log pi + sum gamma_sums log E + sum xisum log T."
    gamma0, xisum, gamma_sums = stats
    return (torch.sum(gamma0 * torch.log(pi)) + torch.sum(gamma_sums * torch.log(E))
            + torch.sum(xisum * torch.log(T)))
