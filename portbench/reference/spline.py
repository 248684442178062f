"""Frozen copy of smcpp_tpu_torch/models/spline.py, the plain PyTorch and NumPy
code the benchmark's reference recomputes the port's set-up with.
Later changes to the port do not reach it; of its splines only the
piecewise one, the configurations' ``--spline``, is kept.  The original
docstring follows.

Differentiable splines over log-population-size knot values, in torch.

Port of smcpp_tpu/models/spline.py.  Each spline is a function of the knot
value tensor ``y`` (any leading batch dimensions, knots on the last axis);
knot locations and query points are static NumPy, so evaluation is fixed
linear algebra plus elementwise selects and autograd supplies the gradient
(the reference uses object-dtype NumPy over its vendored ``ad`` scalars,
SMC++ smcpp/spline/).
"""

import numpy as np
import torch


def _t(x, like):
    return torch.as_tensor(
        np.ascontiguousarray(x), dtype=like.dtype, device=like.device
    )


def _append0(x):
    "Append a zero on the last axis."
    return torch.cat([x, torch.zeros_like(x[..., :1])], -1)


class Spline:
    "Order-p polynomial spline with flat extrapolation (spline/spline.py)."

    P = 0

    def __init__(self, x):
        self.x = np.asarray(x, dtype=np.float64)

    def coefficients(self, y):
        "Return (..., P+1, K) coefficient rows, highest order first."
        raise NotImplementedError

    def __call__(self, y, points):
        "Evaluate at static query points."
        points = np.atleast_1d(np.asarray(points, dtype=np.float64))
        x = self.x
        coef = self.coefficients(y)
        ip = np.searchsorted(x, points, side="right") - 1
        below = ip < 0
        above = ip >= len(x) - 1
        good = ~below & ~above
        ipg = np.clip(ip, 0, len(x) - 2)
        powers = np.arange(self.P, -1, -1)[:, None]
        xi = np.where(good[None, :], (points - x[ipg]) ** powers, 0.0)
        vals = torch.sum(coef[..., ipg] * _t(xi, coef), -2)
        vals = torch.where(_t(below, coef).bool(), coef[..., -1, :1], vals)
        vals = torch.where(_t(above, coef).bool(), coef[..., -1, -1:], vals)
        return vals

    def roughness(self, y):
        "Sum of squared second differences of the knot values."
        return torch.sum(torch.diff(y, 2, -1) ** 2, -1)


class Piecewise(Spline):
    P = 0

    def coefficients(self, y):
        return y[..., None, :]


SPLINE_CLASSES = {
    "piecewise": Piecewise,
    # the name as serialized by the reference (model JSON compatibility)
    "Piecewise": Piecewise,
}
