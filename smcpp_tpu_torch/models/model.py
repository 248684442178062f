"""Size-history models, in torch.

Port of the one-population half of smcpp_tpu/models/model.py: the same
semantics and the same JSON as the reference's model classes
(SMC++ smcpp/model.py).  Parameters live in a NumPy float vector
``y``; every derived quantity is a torch function of it, so autograd gives
dQ/dy.
"""

import numpy as np
import torch

from .. import defaults
from . import spline as spline_mod


def cumsum0(ary):
    return np.concatenate([[0.0], np.cumsum(ary)])


class PiecewiseModel:
    "Raw (a, s) piecewise-constant model (model.py:58-95)."

    NPOP = 1

    def __init__(self, a, s, N0=None, pid=None):
        assert len(a) == len(s)
        self.a = np.asarray(a, dtype=np.float64)
        self.s = np.asarray(s, dtype=np.float64)
        self._N0 = N0
        self._pid = pid

    @property
    def N0(self):
        return self._N0

    @property
    def pid(self):
        return self._pid

    @property
    def knots(self):
        return np.cumsum(self.s)

    @property
    def distinguished_model(self):
        return self

    def stepwise_values(self):
        return self.a

    def for_pop(self, pop):
        assert pop == self.pid
        return self


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
        self.y = np.zeros(getattr(self._spline, "n_coef", len(self._knots)))

    # canonical name as the reference serializes it
    _CANONICAL = {
        "piecewise": "Piecewise",
        "cubic": "CubicSpline",
        "pchip": "PChipSpline",
        "akima": "AkimaSpline",
        "bspline": "BSpline",
        "Piecewise": "Piecewise",
        "CubicSpline": "CubicSpline",
        "PChipSpline": "PChipSpline",
        "AkimaSpline": "AkimaSpline",
        "BSpline": "BSpline",
    }

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
        "Number of free parameters (== knots except for BSpline: K + 2)."
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

    @property
    def distinguished_model(self):
        return self

    def for_pop(self, pid):
        assert pid == self.pid
        return self

    def set_knot_values(self, values):
        "Set y so the spline matches log values at the knots (bspline: lsq fit)."
        logv = np.log(np.asarray(values, dtype=np.float64))
        if hasattr(self._spline, "fit_to"):
            self.y = np.asarray(self._spline.fit_to(logv))
        else:
            self.y = logv.copy()

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

    def __call__(self, x):
        with torch.no_grad():
            return self.eval_at(self._y(), x).numpy()

    def stepwise_values(self):
        with torch.no_grad():
            return self.stepwise_values_fn(self._y()).numpy()

    def regularizer(self):
        with torch.no_grad():
            return float(self.regularizer_fn(self._y()))

    def randomize(self, rng=np.random):
        self.y = self.y + rng.normal(0.0, 1e-4, size=len(self.y))

    def copy(self):
        return model_from_dict(self.to_dict())

    def to_dict(self):
        return {
            "class": "SMCModel",
            "knots": list(map(float, self._knots)),
            "N0": self._N0,
            "spline_class": self._CANONICAL[self._spline_name],
            "y": [float(v) for v in self.y],
            "pid": self._pid,
        }

    @classmethod
    def from_dict(cls, d):
        assert d["class"] == "SMCModel"
        r = cls(d["knots"], d["N0"], d["spline_class"], d["pid"])
        r.y = np.asarray(d["y"], dtype=np.float64)
        return r


def model_from_dict(d):
    """Read a model JSON dict as written by ``SMCModel.to_dict`` of either
    package.  The two-population model is not part of this port yet."""
    if d["class"] != "SMCModel":
        raise NotImplementedError(
            f"model class {d['class']!r} is not ported yet (ROADMAP A7)"
        )
    return SMCModel.from_dict(d)
