"""Two-population split-time estimation.

Port of ``SplitAnalysis`` of smcpp_tpu/inference/split.py.  Mirrors SMC++
smcpp/analysis/split.py: loads the two marginal fits, builds an
SMCTwoPopulationModel with the split at max_split / 2, and runs one EM
iteration in which only the split time moves, by the batched search over the
split objective (TwoPopulationOptimizer, ops/split_objective.py).
"""

import json
import logging

import numpy as np

from ..models import SMCTwoPopulationModel, model_from_dict
from .analysis import BaseAnalysis
from .manager import TwoPopInferenceManager
from .optimizer import TwoPopulationOptimizer

logger = logging.getLogger(__name__)


class SplitAnalysis(BaseAnalysis):
    # Under host-local ingestion the split search runs at trivial hidden
    # states (M = 1), whose closed-form E-step needs only the key counts
    # summed over the ranks.

    def __init__(self, files, args):
        super().__init__(files, args)
        if self.npop != 2:
            raise RuntimeError("split requires two-population data")
        self._init_model(args.pop1, args.pop2)
        if self._headers is not None:
            has_joint = any(len(pid) == 2 for pid, _n, _a in self._headers)
        else:
            has_joint = any(c.npop == 2 for c in self.contigs)
        if not has_joint:
            raise RuntimeError(
                "Data contains no joint frequency spectrum information."
            )
        # the reference uses trivial hidden states for the split search
        # (analysis/split.py:23-25)
        self.hidden_states = np.array([0.0, np.inf])
        self._init_inference_manager(
            args.polarization_error, self.hidden_states
        )
        self._optimizer = TwoPopulationOptimizer(
            self,
            ftol=args.ftol,
            xtol=args.xtol,
            outdir=getattr(args, "outdir", None),
            base=getattr(args, "base", "model"),
            max_split=self._max_split,
        )
        self._niter = 1

    def _init_model(self, pop1, pop2):
        with open(pop1) as f:
            d = json.load(f)
        self._theta = d["theta"]
        self._rho = d["rho"]
        m1 = model_from_dict(d["model"])
        with open(pop2) as f:
            d2 = json.load(f)
        m2 = model_from_dict(d2["model"])
        if d2["theta"] != self._theta:
            raise RuntimeError(
                f"the marginal fits disagree on theta ({self._theta} in {pop1}, "
                f"{d2['theta']} in {pop2})"
            )
        self._max_split = m2._knots[-1]
        self._model = SMCTwoPopulationModel(m1, m2, self._max_split * 0.5)

    # split plumbing used by the scalar optimizer
    @property
    def split(self):
        return self._model.split

    @split.setter
    def split(self, x):
        self._model.split = x

    def broadcast_parameters(self):
        "Every rank takes rank 0's split, after each M-step."
        if self._mesh is not None:
            self._model.split = float(self._broadcast([self._model.split])[0])

    def Q(self, y=None, theta=None, rho=None, alpha=None, split=None):
        if split is not None:
            self._model.split = split
        return sum(im.Q() for im in self._ims.values())

    # -- the batched split search -------------------------------------------
    @property
    def has_split_batch(self):
        "Every manager's split dependence is batched (trivial hs + stats)."
        return all(
            im._stats is not None and len(im.hidden_states) == 2
            for im in self._ims.values()
        )

    def _split_parts(self):
        """(constant, [objectives]) decomposition of Q(split): joint managers
        contribute the JCSFS objective, the pop-2 marginal manager the
        splice objective; the pop-1 marginal does not depend on the split
        and contributes a constant."""
        const = 0.0
        objs = []
        pid1 = self._model.pids[0]
        for im in self._ims.values():
            if isinstance(im, TwoPopInferenceManager):
                objs.append(im.split_objective())
            elif im.pid == (pid1,):
                const += im.Q()
            else:
                objs.append(im.marginal_split_objective())
        return const, objs

    def Q_split_batch(self, splits):
        "Q at a batch of split candidates, one mapped evaluation per part."
        const, objs = self._split_parts()
        tot = np.full(len(splits), const)
        for o in objs:
            tot = tot + o.q_batch(splits)
        return tot
