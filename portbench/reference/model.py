"""Frozen copy of smcpp_tpu_torch/models/model.py, the plain PyTorch and NumPy
code the benchmark's reference recomputes the port's set-up with.
Later changes to the port do not reach it.  The original docstring
follows.

Size-history models, in torch.

Port of smcpp_tpu/models/model.py: the same
semantics and the same JSON as the reference's model classes
(SMC++ smcpp/model.py).  Parameters live in a NumPy float vector
``y``; every derived quantity is a torch function of it, so autograd gives
dQ/dy.
"""

import numpy as np
import torch

from . import defaults
from . import spline as spline_mod


class SMCModel:
    "Spline model over log-size at K knots (model.py:118-257)."

    NPOP = 1

    def __init__(self, knots, N0, spline_class="piecewise", pid=None):
        self._knots = np.array(knots, dtype=np.float64)
        self._N0 = N0
        self._pid = pid
        if isinstance(spline_class, str):
            self._spline_name = spline_class
        else:  # a class from spline_mod
            self._spline_name = spline_class.__name__
        self._spline = spline_mod.SPLINE_CLASSES[self._spline_name](
            np.log(self._knots)
        )
        self.y = np.zeros(len(self._knots))


    @property
    def N0(self):
        return self._N0

    @property
    def pid(self):
        return self._pid

    @property
    def knots(self):
        return self._knots

    @property
    def K(self):
        "Number of free parameters (the knots)."
        return len(self.y)

    @property
    def s(self):
        "100-piece logspace discretization (model.py:134-144)."
        return np.r_[
            self._knots[0],
            np.diff(
                np.logspace(
                    np.log10(self._knots[0]),
                    np.log10(self._knots[-1]),
                    defaults.pieces,
                )
            ),
        ]

    # ---- differentiable pipeline (y: tensor with leading batch dims) ----
    def eval_at(self, y, points):
        "exp(spline(log points))."
        return torch.exp(self._spline(y, np.log(np.asarray(points))))

    def stepwise_values_fn(self, y):
        "Stepwise values on the s-grid, clipped (model.py:203-209)."
        vals = self.eval_at(y, np.cumsum(self.s))
        return torch.clamp(
            vals,
            defaults.minimum_population_size,
            defaults.maximum_population_size,
        )

    def regularizer_fn(self, y):
        return self._spline.roughness(y)

    # ---- concrete conveniences (float64 on the CPU) ----------------------
    def _y(self):
        return torch.as_tensor(np.asarray(self.y, np.float64))

    def stepwise_values(self):
        with torch.no_grad():
            return self.stepwise_values_fn(self._y()).numpy()
