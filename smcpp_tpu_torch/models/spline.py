"""Differentiable splines over log-population-size knot values, in torch.

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


class CubicSpline(Spline):
    """Natural cubic spline (spline/cubic.py:28-67); the tridiagonal solve
    depends only on knot spacings and is a precomputed dense matrix."""

    P = 3

    def __init__(self, x):
        super().__init__(x)
        h = np.diff(self.x)
        K = len(self.x)
        a = np.append(h[:-1] / 3.0, h[-1])
        b = 2.0 * np.concatenate([[h[0]], (h[1:] + h[:-1]) / 3.0, [h[-1]]])
        c = np.concatenate([[h[0]], h[1:] / 3.0])
        T = np.zeros((K, K))
        T[np.arange(K), np.arange(K)] = b
        T[np.arange(1, K), np.arange(K - 1)] = a
        T[np.arange(K - 1), np.arange(1, K)] = c
        self._solve = np.linalg.inv(T)
        self._h = h

    def _rhs(self, y):
        jh = torch.diff(y, 1, -1) / _t(self._h, y)
        return torch.cat(
            [3.0 * jh[..., :1], jh[..., 1:] - jh[..., :-1], -3.0 * jh[..., -1:]],
            -1,
        )

    def coefficients(self, y):
        h = _t(self._h, y)
        jh = torch.diff(y, 1, -1) / h
        cb = self._rhs(y) @ _t(self._solve, y).T
        ca = _append0((cb[..., 1:] - cb[..., :-1]) / h / 3.0)
        cc = jh - h * (2.0 * cb[..., :-1] + cb[..., 1:]) / 3.0
        last = (
            3.0 * ca[..., -2:-1] * h[-1] ** 2
            + 2.0 * cb[..., -2:-1] * h[-1]
            + cc[..., -1:]
        )
        cc = torch.cat([cc, last], -1)
        return torch.stack([ca, cb, cc, y], -2)

    def roughness(self, y):
        "Exact integral of the squared second derivative (cubic.py:63-67)."
        coef = self.coefficients(y)
        a, b = coef[..., 0, :-1], coef[..., 1, :-1]
        xi = _t(np.diff(self.x), y)
        return torch.sum(
            12.0 * a**2 * xi**3 + 12.0 * a * b * xi**2 + 4.0 * b**2 * xi, -1
        )


def _smooth_abs(x):
    return torch.sqrt(x**2 + 1e-3)


class PChipSpline(CubicSpline):
    "C1 monotone cubic (spline/pchip.py), elementwise-select formulation."

    def coefficients(self, y):
        x = self.x
        hn = np.diff(x)
        h = _t(hn, y)
        n = len(x)
        delta = torch.diff(y, 1, -1) / h
        w1 = _t(2 * hn[1:] + hn[:-1], y)
        w2 = _t(hn[1:] + 2 * hn[:-1], y)
        d0s, d1s = delta[..., :-1], delta[..., 1:]
        same = torch.sign(d0s) * torch.sign(d1s) > 0
        delta_safe0 = torch.where(d0s == 0, 1.0, d0s)
        delta_safe1 = torch.where(d1s == 0, 1.0, d1s)
        hm = (w1 + w2) / (w1 / delta_safe0 + w2 / delta_safe1)
        d_int = torch.where(same, hm, 0.0)

        def endpoint(h1, h2, del1, del2):
            d = ((2 * h1 + h2) * del1 - h1 * del2) / (h1 + h2)
            d = torch.where(torch.sign(d) != torch.sign(del1), 0.0, d)
            return torch.where(
                (torch.sign(del1) != torch.sign(del2))
                & (_smooth_abs(d) > _smooth_abs(3 * del1)),
                3 * del1,
                d,
            )

        d0 = endpoint(hn[0], hn[1], delta[..., 0], delta[..., 1])
        dn = endpoint(hn[n - 2], hn[n - 3], delta[..., n - 2], delta[..., n - 3])
        d = torch.cat([d0[..., None], d_int, dn[..., None]], -1)
        c = (3 * delta - 2 * d[..., : n - 1] - d[..., 1:n]) / h
        b = (d[..., : n - 1] - 2 * delta + d[..., 1:n]) / h**2
        return torch.stack([_append0(b), _append0(c), d, y], -2)


class AkimaSpline(CubicSpline):
    "Akima's interpolant (spline/akima.py), elementwise formulation."

    def coefficients(self, y):
        x = self.x
        dx = _t(np.diff(x), y)
        n = len(x)
        m = torch.diff(y, 1, -1) / dx
        mm = 2.0 * m[..., 0:1] - m[..., 1:2]
        mmm = 2.0 * mm - m[..., 0:1]
        mp = 2.0 * m[..., n - 2 : n - 1] - m[..., n - 3 : n - 2]
        mpp = 2.0 * mp - m[..., n - 2 : n - 1]
        m1 = torch.cat([mmm, mm, m, mp, mpp], -1)
        dm = _smooth_abs(torch.diff(m1, 1, -1))
        f1 = dm[..., 2 : n + 2]
        f2 = dm[..., 0:n]
        f12 = f1 + f2
        use = f12 > 1e-9 * torch.amax(f12, -1, keepdim=True)
        f12_safe = torch.where(use, f12, 1.0)
        b = torch.where(
            use,
            (f1 * m1[..., 1 : n + 1] + f2 * m1[..., 2 : n + 2]) / f12_safe,
            m1[..., 1 : n + 1],
        )
        c = (3.0 * m - 2.0 * b[..., : n - 1] - b[..., 1:n]) / dx
        d = (b[..., : n - 1] + b[..., 1:n] - 2.0 * m) / dx**2
        return torch.stack([_append0(d), _append0(c), b, y], -2)


class BSpline(Spline):
    """Cubic B-spline over a clamped knot vector: K + 2 control points for K
    knots, evaluated through a static scipy design matrix (flat
    extrapolation, second-difference roughness; spline/bspline.py)."""

    P = 3

    def __init__(self, x):
        super().__init__(x)
        import scipy.interpolate

        K = len(self.x)
        self._t = np.concatenate([[self.x[0]] * 3, self.x, [self.x[-1]] * 3])
        self.n_coef = K + 2

        def design(points):
            pts = np.clip(points, self.x[0], self.x[-1])
            return np.asarray(
                scipy.interpolate.BSpline.design_matrix(
                    pts, self._t, 3, extrapolate=False
                ).todense()
            )

        self._design = design
        self._fit_pinv = np.linalg.pinv(design(self.x))

    def __call__(self, y, points):
        points = np.atleast_1d(np.asarray(points, dtype=np.float64))
        return y @ _t(self._design(points), y).T

    def fit_to(self, knot_values):
        "Control points whose spline least-squares matches values at knots."
        return self._fit_pinv @ np.asarray(knot_values, dtype=np.float64)


SPLINE_CLASSES = {
    "piecewise": Piecewise,
    "cubic": CubicSpline,
    "pchip": PChipSpline,
    "akima": AkimaSpline,
    "bspline": BSpline,
    # names as serialized by the reference (model JSON compatibility)
    "Piecewise": Piecewise,
    "CubicSpline": CubicSpline,
    "PChipSpline": PChipSpline,
    "AkimaSpline": AkimaSpline,
    "BSpline": BSpline,
}
