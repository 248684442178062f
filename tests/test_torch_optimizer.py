"""The port's EM optimizer (a copy of the JAX package's SMCPPOptimizer)
against the original, on synthetic objectives: the same sequence of Q
evaluations, the same decisions and the same final parameters, through the
sequential first M-step, the unified Jacobi rounds, the rho search, the
multi-coordinate L-BFGS-B path and the ftol endgame."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from smcpp_tpu.inference.optimizer import SMCPPOptimizer as JaxOptimizer  # noqa: E402
from smcpp_tpu_torch.inference.optimizer import (  # noqa: E402
    SMCPPOptimizer as TorchOptimizer,
)


class FakeAnalysis:
    """Separable concave Q over (y, log rho) with every call recorded; the
    log-likelihood sequence improves, then stalls below ftol."""

    def __init__(self, K, seed):
        rng = np.random.RandomState(seed)
        self.model = SimpleNamespace(y=np.zeros(K), K=K)
        self.opt = rng.normal(0.0, 1.0, K)
        self.w = rng.uniform(0.5, 2.0, K)
        self.has_fast_batch = True
        self._theta = 1e-3
        self.rho = 1e-3
        self.rho_opt = 4e-3
        self._ims = {}
        self.calls = []
        self.lls = [-100.0, -90.0, -89.99, -89.9899, -89.98989, -89.989889]
        self.n_estep = 0

    def _q(self, ys, rhos):
        ys = np.atleast_2d(np.asarray(ys, float))
        rhos = np.full(len(ys), self.rho) if rhos is None else np.asarray(rhos)
        return (-np.sum(self.w * (ys - self.opt) ** 2, axis=1)
                - (np.log(rhos) - np.log(self.rho_opt)) ** 2)

    def Q_batch(self, ys=None, rhos=None, coarse=False):
        if ys is None:
            ys = np.tile(self.model.y, (len(rhos), 1))
        self.calls.append(("Q_batch", np.round(ys, 12).tolist(),
                           None if rhos is None else np.round(rhos, 15).tolist(),
                           coarse))
        return self._q(ys, rhos)

    def Q_and_grad(self, y=None):
        y = np.asarray(self.model.y if y is None else y, float)
        self.calls.append(("Q_and_grad", np.round(y, 12).tolist()))
        return self._q(y[None], None)[0], -2.0 * self.w * (y - self.opt)

    def E_step(self):
        self.calls.append(("E_step",))
        self.n_estep += 1

    def loglik(self):
        return self.lls[min(self.n_estep, len(self.lls)) - 1]

    def raise_precision(self):
        return False


@pytest.mark.parametrize("single,learn_rho,K,seed", [
    (True, True, 6, 0),
    (True, False, 4, 1),
    (False, False, 5, 2),
])
def test_optimizer_matches_jax(single, learn_rho, K, seed):
    runs = []
    for cls in (JaxOptimizer, TorchOptimizer):
        a = FakeAnalysis(K, seed)
        opt = cls(a, xtol=0.01, ftol=1e-4, single=single, learn_rho=learn_rho)
        opt.run(len(a.lls))
        runs.append((a, opt))
    (ja, jopt), (ta, topt) = runs
    assert ta.calls == ja.calls
    np.testing.assert_array_equal(ta.model.y, ja.model.y)
    assert ta.rho == ja.rho
    assert topt._radius == jopt._radius
    assert (getattr(topt, "_force_sequential", False)
            == getattr(jopt, "_force_sequential", False))
    # and the fit moved toward the optimum
    assert np.abs(ta.model.y - ta.opt).max() < np.abs(ta.opt).max()
