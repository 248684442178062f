"""The Q family's oracles (tests/test_ratefunc.py, test_transition.py,
test_spline.py, test_csfs.py, test_golden.py) through the port.

Each test builds its seeded NumPy inputs as the JAX test does, holds the
port's function to the JAX test's oracle (quadrature, scipy's expm, a loop
reference, analytic invariants, golden values) at that test's own
tolerance, and holds it to the JAX function on the same inputs at the same
tolerance.  Gradients come from torch autograd against finite differences
and against jax.grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate
import scipy.linalg
import torch

from smcpp_tpu.models import spline as jsp
from smcpp_tpu.ops import csfs as jcsfs
from smcpp_tpu.ops import emission as jemission
from smcpp_tpu.ops import grid as jgrid
from smcpp_tpu.ops import hmm as jhmm
from smcpp_tpu.ops import ratefunc as jratefunc
from smcpp_tpu.ops import transition as jtransition
from smcpp_tpu_torch import defaults
from smcpp_tpu_torch.models import spline as sp
from smcpp_tpu_torch.models.model import SMCModel, model_from_dict
from smcpp_tpu_torch.ops import csfs, emission, exact, hmm, ratefunc, transition
from smcpp_tpu_torch.ops import grid as gridmod

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)


def T64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def N(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def nC2(v):
    return v * (v - 1) / 2


def _both(name, got, jax_fn, rtol, atol=0.0):
    "The port's value against the JAX function's on the same inputs."
    np.testing.assert_allclose(N(got), np.asarray(jax_fn()), rtol=rtol,
                               atol=atol, err_msg=f"{name}: port vs JAX")


def _fd_check(f, a, grad, rtol, atol):
    eps = 1e-6
    for i in range(len(a)):
        ap, am = a.copy(), a.copy()
        ap[i] += eps
        am[i] -= eps
        fd = (float(f(T64(ap))) - float(f(T64(am)))) / (2 * eps)
        assert np.isclose(grad[i], fd, rtol=rtol, atol=atol), i


def _autograd(f, a):
    at = T64(a).requires_grad_(True)
    f(at).backward()
    return at.grad.numpy()


# -- ratefunc (tests/test_ratefunc.py) ------------------------------------------

@pytest.fixture
def rsetup():
    rng = np.random.RandomState(0)
    K = 7
    s = np.r_[0.05, rng.uniform(0.05, 0.5, K - 1)]
    a = rng.uniform(0.2, 5.0, K)
    hs = np.array([0.0, 0.1, 0.5, 1.0, 2.5, np.inf])
    return a, s, hs, gridmod.make_time_grid(s, hs), jgrid.make_time_grid(s, hs)


def quad(f, lo, hi, ts):
    "Quadrature with breakpoints at the piece boundaries."
    pts = [x for x in ts if lo < x < hi and np.isfinite(x)]
    v, _ = scipy.integrate.quad(f, lo, hi, limit=400, points=pts or None)
    return v


def _density(eta):
    def density(t):
        ip = min(np.searchsorted(eta.ts, t, side="right") - 1, len(eta.ada) - 1)
        return eta.ada[ip] * np.exp(-eta.R(t))

    return density


def test_cumulative_rate_matches_host(rsetup):
    a, s, hs, g, jg = rsetup
    Rr = N(ratefunc.cumulative_rate(ratefunc.ada_on_grid(T64(a), g), g))
    R = ratefunc.HostRateFunction(a, s).R
    for i, t in enumerate(g.ts[:-1]):
        assert np.isclose(Rr[i], R(t), rtol=1e-12), (i, t)
    _both("cumulative_rate", Rr[:-1], lambda: jratefunc.cumulative_rate(
        jratefunc.ada_on_grid(a, jg), jg)[:-1], rtol=1e-12)


def test_initial_distribution(rsetup):
    a, s, hs, g, jg = rsetup
    pi = N(ratefunc.initial_distribution(T64(a), g))
    R = ratefunc.HostRateFunction(a, s).R
    expected = np.array([
        np.exp(-R(hs[m])) - (0.0 if np.isinf(hs[m + 1]) else np.exp(-R(hs[m + 1])))
        for m in range(len(hs) - 1)
    ])
    expected /= expected.sum()
    np.testing.assert_allclose(pi, expected, rtol=1e-12)
    assert np.isclose(pi.sum(), 1.0)
    _both("pi", pi, lambda: jratefunc.initial_distribution(a, jg), rtol=1e-12)


def test_average_coal_times(rsetup):
    a, s, hs, g, jg = rsetup
    act = N(ratefunc.average_coal_times(T64(a), g))
    eta = ratefunc.HostRateFunction(a, s)
    density = _density(eta)
    for m in range(len(hs) - 1):
        lo, hi = hs[m], hs[m + 1]
        ub = hi if np.isfinite(hi) else 60.0
        num = quad(lambda t: t * density(t), lo, ub, eta.ts[:-1])
        den = quad(density, lo, ub, eta.ts[:-1])
        assert np.isclose(act[m], num / den, rtol=1e-6), m
        assert hs[m] <= act[m] <= hs[m + 1]
    _both("act", act, lambda: jratefunc.average_coal_times(a, jg), rtol=1e-6)


def test_tjj_below_quadrature(rsetup):
    """tjj_below[h, j-2] = E[int_0^T exp(-rate R(t)) dt | T in h], rate =
    C(j,2) - 1."""
    a, s, hs, g, jg = rsetup
    n = 4
    out = N(ratefunc.tjj_below(T64(a), g, n))
    eta = ratefunc.HostRateFunction(a, s)
    R, density = eta.R, _density(eta)
    for h in range(len(hs) - 1):
        lo, hi = hs[h], hs[h + 1]
        ub = hi if np.isfinite(hi) else 60.0
        den = quad(density, lo, ub, eta.ts[:-1])
        for idx, j in enumerate(range(2, n + 3)):
            rate = nC2(j) - 1

            def inner(T):
                return quad(lambda t: np.exp(-rate * R(t)), 0.0, T, eta.ts[:-1])

            num = quad(lambda T: inner(T) * density(T), lo, ub, eta.ts[:-1])
            assert np.isclose(out[h, idx], num / den, rtol=1e-5), (h, j)
    _both("tjj_below", out, lambda: jratefunc.tjj_below(a, jg, n), rtol=1e-5)


def test_tjj_above_quadrature(rsetup):
    """tjj_above[h, jj-2, j-2] = (1/P(h)) int_h dT eta(T) e^{-(lam+1) R(T)}
    int_T^inf dt e^{-rate (R(t) - R(T))}, lam = C(jj,2) - 1, rate = C(j,2)."""
    a, s, hs, g, jg = rsetup
    n = 3
    out = N(ratefunc.tjj_above(T64(a), g, n))
    eta = ratefunc.HostRateFunction(a, s)
    R, density = eta.R, _density(eta)
    UB = 80.0
    for h in range(len(hs) - 1):
        lo, hi = hs[h], hs[h + 1]
        ub = hi if np.isfinite(hi) else UB
        den = quad(density, lo, ub, eta.ts[:-1])
        for jj in range(2, n + 3):
            lam = nC2(jj) - 1
            for j in range(2, n + 2):
                rate = nC2(j)

                def outer(T):
                    RT = R(T)
                    inner = quad(lambda t: np.exp(-rate * (R(t) - RT)), T, UB,
                                 eta.ts[:-1])
                    return density(T) * np.exp(-lam * RT) * inner

                num = quad(outer, lo, ub, eta.ts[:-1])
                assert np.isclose(out[h, jj - 2, j - 2], num / den, rtol=1e-4), (h, jj, j)
    _both("tjj_above", out, lambda: jratefunc.tjj_above(a, jg, n), rtol=1e-4)


def test_tjj_gradients_finite(rsetup):
    a, s, hs, g, jg = rsetup
    n = 4

    def f(av):
        return ratefunc.tjj_below(av, g, n).sum() + ratefunc.tjj_above(av, g, n).sum()

    ga = _autograd(f, a)
    assert np.all(np.isfinite(ga))
    _fd_check(f, a, ga, rtol=1e-4, atol=1e-8)
    _both("d tjj / da", ga, lambda: jax.grad(
        lambda av: jratefunc.tjj_below(av, jg, n).sum()
        + jratefunc.tjj_above(av, jg, n).sum())(a), rtol=1e-4, atol=1e-8)


def test_degenerate_zero_width_pieces():
    "Stage-1 warm-start models have zero-width pieces; nothing may NaN."
    s = np.r_[1.0, np.zeros(9)]
    a = np.full(10, 2.0)
    hs = np.array([0.0, 0.7, 1.9, np.inf])
    g, jg = gridmod.make_time_grid(s, hs), jgrid.make_time_grid(s, hs)
    at = T64(a)
    for name, fn, jfn in [
        ("pi", lambda: ratefunc.initial_distribution(at, g),
         lambda: jratefunc.initial_distribution(a, jg)),
        ("act", lambda: ratefunc.average_coal_times(at, g),
         lambda: jratefunc.average_coal_times(a, jg)),
        ("tjj_below", lambda: ratefunc.tjj_below(at, g, 3),
         lambda: jratefunc.tjj_below(a, jg, 3)),
        ("tjj_above", lambda: ratefunc.tjj_above(at, g, 3),
         lambda: jratefunc.tjj_above(a, jg, 3)),
    ]:
        v = N(fn())
        assert np.all(np.isfinite(v)), name
        _both(name, v, jfn, rtol=1e-10, atol=1e-300)
    ga = _autograd(lambda av: ratefunc.tjj_below(av, g, 3).sum(), a)
    assert np.all(np.isfinite(ga))


# -- transition (tests/test_transition.py) ----------------------------------------

A_RHO = np.array([[-1.0, 1, 0], [0, 0, 0], [0, 0, 0]])
A_ETA = np.array([[0.0, 0, 0], [1, -2, 1], [0, 0, 0]])


def test_expm_closed_form():
    rng = np.random.RandomState(0)
    for _ in range(20):
        c_rho = rng.uniform(0, 3)
        c_eta = rng.uniform(1e-4, 4)
        got = N(transition.expm_recomb(T64(c_rho), T64(c_eta)))
        want = scipy.linalg.expm(c_rho * A_RHO + c_eta * A_ETA)
        np.testing.assert_allclose(got, want, atol=1e-12)
        _both("expm", got, lambda: jtransition.expm_recomb(c_rho, c_eta),
              rtol=0.0, atol=1e-12)


def reference_phi(a, s, hs, rho):
    "Loop-based HJ transition (tests/test_transition.py:reference_phi)."
    g = gridmod.make_time_grid(s, hs)
    ada = (1.0 / np.asarray(a))[g.src]
    ts = g.ts
    K = g.K
    dt = np.diff(ts)
    Rr = np.concatenate([[0.0], np.cumsum(ada[:-1] * dt[:-1])])
    Rr = np.append(Rr, np.inf)
    E = [None] * K
    for k in range(K):
        if np.isinf(ts[k + 1]):
            E[k] = np.array([[0.0, 0, 1], [0, 0, 1], [0, 0, 1]])
        else:
            E[k] = scipy.linalg.expm(rho * dt[k] * A_RHO + ada[k] * dt[k] * A_ETA)
    P = [np.eye(3)]
    for k in range(K):
        P.append(P[-1] @ E[k])
    H = g.hs_indices
    M = g.M
    act = N(ratefunc.average_coal_times(T64(a), g))
    Phi = np.zeros((M, M))
    expm_diff = np.array([P[H[k]][0, 2] - P[H[k - 1]][0, 2] for k in range(1, M)])
    for j in range(1, M + 1):
        Phi[j - 1, : j - 1] = expm_diff[: j - 1]
        rct = act[j - 1]
        ip = min(np.searchsorted(ts, rct, side="right") - 1, K - 1)
        delta = rct - ts[ip]
        B = P[ip] @ scipy.linalg.expm(rho * delta * A_RHO + ada[ip] * delta * A_ETA)
        R_rct = Rr[ip] + ada[ip] * delta
        Rj = Rr[H[j]] - R_rct
        p_float = B[0, 1] * (0.0 if np.isinf(Rj) else np.exp(-Rj))
        if j == M:
            p_float = 0.0
        for k in range(j + 1, M + 1):
            inc = Rr[H[k]] - Rr[H[k - 1]]
            p_coal = np.exp(-(Rr[H[k - 1]] - Rr[H[j]]))
            if not np.isinf(inc):
                p_coal *= -np.expm1(-inc)
            Phi[j - 1, k - 1] += p_float * p_coal
        Phi[j - 1, j - 1] = 0.0
        Phi[j - 1, j - 1] = 1.0 - Phi[j - 1].sum()
    Phi = np.maximum(Phi, 1e-20)
    beta = 1e-5
    return Phi * (1 - beta) + beta / (M + 1)


def _phi(a, s, hs, rho):
    g, jg = gridmod.make_time_grid(s, hs), jgrid.make_time_grid(s, hs)
    got = N(transition.transition_matrix(T64(a), rho, g))
    return got, lambda: jtransition.transition_matrix(a, rho, jg)


def test_phi_matches_loop_reference():
    rng = np.random.RandomState(1)
    s = rng.uniform(0.05, 0.5, 8)
    a = rng.uniform(0.3, 4.0, 8)
    hs = np.array([0.0, 0.15, 0.45, 0.9, 1.6, np.inf])
    got, jfn = _phi(a, s, hs, 1.7e-2)
    np.testing.assert_allclose(got, reference_phi(a, s, hs, 1.7e-2),
                               rtol=1e-9, atol=1e-14)
    _both("Phi", got, jfn, rtol=1e-9, atol=1e-14)


def test_phi_structure():
    rng = np.random.RandomState(2)
    s = rng.uniform(0.05, 0.5, 10)
    a = rng.uniform(0.1, 8.0, 10)
    hs = np.array([0.0, 0.1, 0.3, 0.7, 1.2, 2.0, 4.0, np.inf])
    Phi, jfn = _phi(a, s, hs, 1e-2)
    M = len(hs) - 1
    assert Phi.shape == (M, M)
    np.testing.assert_allclose(Phi.sum(axis=1), 1.0, atol=1e-4)
    assert np.all(Phi >= defaults.transition_beta / (M + 1) * 0.999)
    assert np.all(np.argmax(Phi, axis=1) == np.arange(M))
    _both("Phi", Phi, jfn, rtol=1e-9, atol=1e-14)


def test_phi_gradient_fd():
    rng = np.random.RandomState(3)
    s = rng.uniform(0.05, 0.5, 6)
    a = rng.uniform(0.3, 4.0, 6)
    hs = np.array([0.0, 0.3, 0.9, 2.0, np.inf])
    g, jg = gridmod.make_time_grid(s, hs), jgrid.make_time_grid(s, hs)
    rho = 2e-2

    def f(av):
        return torch.sum(torch.log(transition.transition_matrix(av, rho, g)))

    ga = _autograd(f, a)
    assert np.all(np.isfinite(ga))
    _fd_check(f, a, ga, rtol=2e-4, atol=1e-7)
    _both("d Phi / da", ga, lambda: jax.grad(lambda av: jnp.sum(
        jnp.log(jtransition.transition_matrix(av, rho, jg))))(a),
        rtol=2e-4, atol=1e-7)


def test_phi_m1_degenerate():
    "hs = [0, inf] (stage-1 warm start) gives the 1x1 matrix [~1]."
    Phi, jfn = _phi(np.full(6, 2.0), np.r_[1.0, np.zeros(5)], np.array([0.0, np.inf]),
                    1e-2)
    assert Phi.shape == (1, 1)
    assert np.isclose(Phi[0, 0], 1.0, atol=1e-4)
    _both("Phi", Phi, jfn, rtol=0.0, atol=1e-4)


# -- splines (tests/test_spline.py) -----------------------------------------------

KNOTS = np.array([0.1, 0.3, 0.9, 2.7, 8.1])
Y = np.array([0.5, -0.2, 0.3, 0.8, -0.1])
ALL = ["Piecewise", "CubicSpline", "PChipSpline", "AkimaSpline"]


def _spl(name, y, points):
    "The port's and JAX's spline of class ``name`` at ``points``."
    got = N(getattr(sp, name)(KNOTS)(T64(y), points))
    return got, np.asarray(getattr(jsp, name)(KNOTS)(y, points))


@pytest.mark.parametrize("cls", ALL)
def test_interpolates_knots(cls):
    got, want = _spl(cls, Y, KNOTS)
    np.testing.assert_allclose(got, Y, atol=1e-10)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-10)


@pytest.mark.parametrize("cls", ALL[1:])
def test_c1_continuity(cls):
    eps = 1e-7
    for k in KNOTS[1:-1]:
        pts = [k - 2 * eps, k - eps, k + eps, k + 2 * eps]
        v, jv = _spl(cls, Y, pts)
        assert np.isclose(v[1], v[2], atol=1e-5)
        assert np.isclose((v[1] - v[0]) / eps, (v[3] - v[2]) / eps, atol=1e-3)
        np.testing.assert_allclose(v, jv, rtol=0.0, atol=1e-12)


def test_cubic_c2_continuity():
    "Second derivative continuous at interior knots (from the coefficients)."
    coef = N(sp.CubicSpline(KNOTS).coefficients(T64(Y)))
    np.testing.assert_allclose(coef, np.asarray(jsp.CubicSpline(KNOTS).coefficients(Y)),
                               rtol=1e-12, atol=1e-12)
    h = np.diff(KNOTS)
    for i in range(1, len(KNOTS) - 1):
        d2_left = 6 * coef[0, i - 1] * h[i - 1] + 2 * coef[1, i - 1]
        assert np.isclose(d2_left, 2 * coef[1, i], atol=1e-9), i


@pytest.mark.parametrize("cls", ALL)
def test_flat_extrapolation(cls):
    got, want = _spl(cls, Y, [1e-3, 100.0])
    assert np.isclose(got[0], Y[0]) and np.isclose(got[1], Y[-1])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_pchip_monotone():
    ym = np.array([0.0, 0.5, 0.7, 2.0, 2.1])
    q = np.linspace(KNOTS[0], KNOTS[-1], 200)
    v, jv = _spl("PChipSpline", ym, q)
    assert np.all(np.diff(v) >= -1e-9)
    np.testing.assert_allclose(v, jv, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cls", ALL)
def test_grad_and_roughness(cls):
    q = np.linspace(0.05, 9.0, 13)
    Ym = np.array([0.1, 0.3, 0.8, 1.5, 1.9])
    s, js = getattr(sp, cls)(KNOTS), getattr(jsp, cls)(KNOTS)

    def f(y):
        return (s(y, q) ** 2).sum() + s.roughness(y)

    g = _autograd(f, Ym)
    assert np.all(np.isfinite(g))
    _fd_check(f, Ym, g, rtol=1e-4, atol=1e-7)
    _both("d spline / dy", g, lambda: jax.grad(
        lambda y: (js(y, q) ** 2).sum() + js.roughness(y))(Ym), rtol=1e-4, atol=1e-7)


def test_model_roundtrip():
    m = SMCModel(KNOTS, 10000.0, "cubic", pid="pop1")
    m.y = Y.copy()
    d = m.to_dict()
    assert d["spline_class"] == "CubicSpline"
    m2 = model_from_dict(d)
    np.testing.assert_allclose(m2.stepwise_values(), m.stepwise_values())
    assert len(m.s) == 100
    sv = m.stepwise_values()
    assert np.all(sv >= 1e-3) and np.all(sv <= 1e3)
    from smcpp_tpu.models.model import SMCModel as JaxModel

    jm = JaxModel(KNOTS, 10000.0, "cubic", pid="pop1")
    jm.y = Y.copy()
    np.testing.assert_allclose(sv, np.asarray(jm.stepwise_values()), rtol=1e-12)


def test_bspline():
    s, js = sp.BSpline(KNOTS), jsp.BSpline(KNOTS)
    target = np.array([1.0, 1.5, 2.0, 1.2, 0.8])
    y = s.fit_to(np.log(target))
    np.testing.assert_allclose(y, js.fit_to(np.log(target)), rtol=1e-12)
    assert len(y) == len(KNOTS) + 2
    vals = N(s(T64(y), KNOTS))
    np.testing.assert_allclose(np.exp(vals), target, rtol=0.15)
    ext = N(s(T64(y), [1e-3, 100.0]))
    assert np.isclose(ext[0], vals[0], atol=1e-8)
    assert np.isclose(ext[1], vals[-1], atol=1e-8)
    q = np.linspace(0.2, 5, 7)
    g = _autograd(lambda yy: (s(yy, q) ** 2).sum(), y)
    assert np.all(np.isfinite(g))
    _both("d bspline / dy", g, lambda: jax.grad(lambda yy: (js(yy, q) ** 2).sum())(y),
          rtol=1e-10, atol=1e-12)


# -- CSFS (tests/test_csfs.py) ----------------------------------------------------

def moran_dense(n, a, na, mod=exact):
    sub, dia, sup = mod._modified_moran_rate_matrix(n, a, na)
    M = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        M[i, i] = float(dia[i])
        if i > 0:
            M[i, i - 1] = float(sub[i])
        if i < n:
            M[i, i + 1] = float(sup[i])
    return M


def undistinguished_sfs(sfs):
    "Marginalize the (3, n+1) CSFS onto the total derived count."
    a_dim = sfs.shape[0] - 1
    n = sfs.shape[1] - 1
    usfs = np.zeros(n + a_dim)
    for i in range(a_dim + 1):
        for j in range(n + 1):
            if 0 <= i + j < n + a_dim:
                usfs[i + j] += sfs[i, j]
    return usfs


def _csfs(a, s, hs, n):
    "The port's CSFS and a thunk of JAX's on the same grid."
    g, jg = gridmod.make_time_grid(s, hs), jgrid.make_time_grid(s, hs)
    return N(csfs.conditioned_sfs(T64(a), g, n)), lambda: jcsfs.conditioned_sfs(a, jg, n)


@pytest.mark.parametrize("which", ["moran", "stable"])
def test_moran_eigensystems(which):
    """The exact eigensystem reconstructs the Moran rate matrix; the stable
    T-block one is biorthonormal, reconstructs T and matches D (both JAX
    tests, one case each), and both equal JAX's."""
    from smcpp_tpu.ops import exact as jexact

    if which == "moran":
        for n in [2, 5, 11]:
            mei = exact.moran_eigensystem(n)
            M = moran_dense(n, 0, 2)
            np.testing.assert_allclose(M, moran_dense(n, 0, 2, jexact))
            np.testing.assert_allclose(mei.U @ np.diag(mei.D) @ mei.Uinv, M, atol=1e-8)
            np.testing.assert_allclose(mei.Uinv @ mei.U, np.eye(n + 1), atol=1e-9)
            np.testing.assert_array_equal(mei.U, jexact.moran_eigensystem(n).U)
        return
    for n in [1, 2, 5, 11, 40]:
        mse = exact.stable_eigensystem(n)
        T = moran_dense(n, 0, 2)[1:, 1:]
        np.testing.assert_allclose(mse.Uinv @ mse.U, np.eye(n), atol=1e-10)
        np.testing.assert_allclose(mse.U @ np.diag(mse.D) @ mse.Uinv, T, atol=1e-8)
        ks = np.arange(3, n + 3)
        np.testing.assert_allclose(mse.D, -(ks * (ks - 1) / 2.0 - 1.0), rtol=1e-12)
        j = jexact.stable_eigensystem(n)
        np.testing.assert_allclose(mse.U, j.U, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(mse.Uinv, j.Uinv, rtol=1e-12, atol=1e-14)


def test_constant_model_sfs_invariant():
    "Constant model, full time range: undistinguished SFS = 2/k for k >= 1."
    for ntot in [3, 5, 8]:
        n = ntot - 2
        out, jfn = _csfs(np.ones(3), np.array([1.0, 1.0, 2.0]), np.array([0.0, np.inf]), n)
        undist = undistinguished_sfs(out[0])
        np.testing.assert_allclose(undist[1:], 2.0 / np.arange(1, ntot), rtol=1e-8)
        _both("csfs", out, jfn, rtol=1e-8, atol=1e-14)


def test_row1_sums_to_twice_expected_tmrca():
    "The a' = 1 row sums to 2 E[T | interval] (test_bugs.py:29-35)."
    s, a = np.array([1.0, 1.0, 2.0]), np.ones(3)
    ts = [0.0, 0.5, 1.0, 2.0, np.inf]
    for t1, t2 in zip(ts[:-1], ts[1:]):
        for n in [0, 2, 7]:
            out, jfn = _csfs(a, s, np.array([t1, t2]), n)
            q, _ = scipy.integrate.quad(lambda t: t * np.exp(-t), t1, t2)
            ans = q / (np.exp(-t1) - np.exp(-t2))
            np.testing.assert_allclose(out[0].sum(axis=1)[1], 2.0 * ans, rtol=1e-6)
            _both("csfs", out, jfn, rtol=1e-6, atol=1e-14)


def test_row1_sums_nonconstant_model():
    rng = np.random.RandomState(1)
    s = rng.uniform(0.1, 0.5, 6)
    a = rng.uniform(0.3, 4.0, 6)
    hs = np.array([0.0, 0.2, 0.8, 1.5, np.inf])
    out, jfn = _csfs(a, s, hs, 4)
    act = N(ratefunc.average_coal_times(T64(a), gridmod.make_time_grid(s, hs)))
    np.testing.assert_allclose(out.sum(axis=2)[:, 1], 2.0 * act, rtol=1e-6)
    _both("csfs", out, jfn, rtol=1e-6, atol=1e-14)


def test_csfs_nonnegative_and_finite():
    rng = np.random.RandomState(2)
    s = rng.uniform(0.02, 0.4, 12)
    a = rng.uniform(1e-2, 1e2, 12)
    out, jfn = _csfs(a, s, np.array([0.0, 0.05, 0.3, 1.0, 3.0, np.inf]), 10)
    assert np.all(np.isfinite(out))
    assert np.all(out >= -1e-12)
    _both("csfs", out, jfn, rtol=1e-8, atol=1e-12)


def test_incorporate_theta_distribution():
    rng = np.random.RandomState(3)
    s = rng.uniform(0.05, 0.4, 8)
    a = rng.uniform(0.2, 5.0, 8)
    hs = np.array([0.0, 0.3, 1.2, np.inf])
    g, jg = gridmod.make_time_grid(s, hs), jgrid.make_time_grid(s, hs)
    em = N(csfs.incorporate_theta(csfs.conditioned_sfs(T64(a), g, 5), 1e-4))
    assert np.all(em > 0)
    assert np.all(em <= 1)
    np.testing.assert_allclose(em.sum(axis=(1, 2)), 1.0, atol=1e-6)
    _both("emissions", em, lambda: jcsfs.incorporate_theta(
        jcsfs.conditioned_sfs(a, jg, 5), 1e-4), rtol=1e-6, atol=1e-15)


def test_csfs_large_n_envelope():
    """The f64 CSFS in the stable basis holds about 1e-12 through n = 200
    (the reference's exactly normalized eigenbasis degrades past n ~ 60);
    the port against JAX at both ends of the range."""
    s, a = np.array([1.0, 1.0, 2.0]), np.ones(3)
    g = gridmod.make_time_grid(s, np.array([0.0, np.inf]))
    jg = jgrid.make_time_grid(s, np.array([0.0, np.inf]))
    for n in [60, 100, 150, 200]:
        out = N(csfs.conditioned_sfs(T64(a), g, n))[0]
        undist = undistinguished_sfs(out)
        np.testing.assert_allclose(undist[1:], 2.0 / np.arange(1, n + 2), rtol=1e-10)
        assert out.min() >= 0.0
        if n in (60, 200):  # JAX's exact matrices cost minutes at each n
            want = np.asarray(jcsfs.conditioned_sfs(a, jg, n, xp=np))[0]
            np.testing.assert_allclose(out, want, rtol=1e-10, atol=1e-14)


def test_csfs_gradient_fd():
    rng = np.random.RandomState(4)
    s = rng.uniform(0.05, 0.4, 6)
    a = rng.uniform(0.3, 4.0, 6)
    hs = np.array([0.0, 0.4, 1.5, np.inf])
    g, jg = gridmod.make_time_grid(s, hs), jgrid.make_time_grid(s, hs)

    def f(av):
        return torch.sum(csfs.incorporate_theta(csfs.conditioned_sfs(av, g, 4), 1e-4) ** 2)

    ga = _autograd(f, a)
    _fd_check(f, a, ga, rtol=1e-4, atol=1e-9)
    _both("d csfs / da", ga, lambda: jax.grad(lambda av: jnp.sum(
        jcsfs.incorporate_theta(jcsfs.conditioned_sfs(av, jg, 4), 1e-4) ** 2))(a),
        rtol=1e-4, atol=1e-9)


# -- golden values (tests/test_golden.py) -----------------------------------------

def fixed_problem():
    s = np.array([0.05, 0.1, 0.2, 0.4, 0.8, 1.6])
    a = np.array([2.0, 1.5, 0.8, 0.5, 1.0, 3.0])
    hs = np.array([0.0, 0.1, 0.3, 0.7, 1.5, np.inf])
    return a, gridmod.make_time_grid(s, hs), jgrid.make_time_grid(s, hs)


def test_golden_pi_and_transition():
    a, g, jg = fixed_problem()
    pi = N(ratefunc.initial_distribution(T64(a), g))
    np.testing.assert_allclose(
        pi,
        [0.05666455012650784, 0.18692162613539898, 0.4035477422792442,
         0.20204584926510122, 0.15082023219374774],
        rtol=1e-10,
    )
    _both("pi", pi, lambda: jratefunc.initial_distribution(jnp.asarray(a), jg),
          rtol=1e-10)
    T = N(transition.transition_matrix(T64(a), 1e-2, g))
    np.testing.assert_allclose(T.sum(axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        np.diag(T),
        [0.9994911708887326, 0.9984416691539665, 0.9980034833873568,
         0.9955615992410298, 0.9947325846366666],
        rtol=1e-8,
    )
    _both("T", T, lambda: jtransition.transition_matrix(jnp.asarray(a), 1e-2, jg),
          rtol=1e-8, atol=1e-14)


def test_golden_csfs():
    a, g, jg = fixed_problem()
    bl = N(csfs.conditioned_sfs(T64(a), g, 4))
    np.testing.assert_allclose(
        bl.sum(axis=(1, 2)),
        [4.606808203442039, 4.479079340239874, 3.9800324482514338,
         3.991856077656391, 10.28718903171539],
        rtol=1e-9,
    )
    np.testing.assert_allclose(
        bl[0, :, 0], [0.0, 0.09920953931813842, 0.3322126633558882], rtol=1e-8
    )
    _both("csfs", bl, lambda: jcsfs.conditioned_sfs(jnp.asarray(a), jg, 4),
          rtol=1e-9, atol=1e-15)


def test_golden_estep():
    a, g, jg = fixed_problem()
    at = T64(a)
    keys = [(-1, 0, 0), (0, 0, 0), (1, 0, 0)] + [
        (x, b, 4) for x in (0, 1, 2) for b in range(5)
    ]
    idx = emission.build_emission_index(keys, 4)
    pi = ratefunc.initial_distribution(at, g)
    T = transition.transition_matrix(at, 1e-2, g)
    em = csfs.incorporate_theta(csfs.conditioned_sfs(at, g, 4), 1e-4)
    e2 = emission.e2_matrix(ratefunc.average_coal_times(at, g), 1e-4, 100)
    E = emission.emission_matrix(idx, em, e2)
    rng = np.random.RandomState(7)
    spans = rng.randint(1, 50, size=(2, 64)).astype(np.int32)
    kk = rng.randint(0, idx.n_keys, size=(2, 64)).astype(np.int32)
    ll, g0, xi, gs = hmm.estep(pi, T, E, torch.as_tensor(spans),
                               torch.as_tensor(kk), 6, 8)
    assert np.isclose(float(ll), -21662.49850867423, rtol=1e-8), float(ll)
    total = float(spans.sum())
    assert np.isclose(float(xi.sum()), total, rtol=1e-9)
    assert np.isclose(float(gs.sum()), total, rtol=1e-9)
    assert np.isclose(float(g0.sum()), 2.0, rtol=1e-9)
    # the same E-step in the JAX package
    jidx = jemission.build_emission_index(keys, 4)
    jpi = jratefunc.initial_distribution(jnp.asarray(a), jg)
    jT = jtransition.transition_matrix(jnp.asarray(a), 1e-2, jg)
    jem = jcsfs.incorporate_theta(jcsfs.conditioned_sfs(jnp.asarray(a), jg, 4), 1e-4)
    je2 = jemission.e2_matrix(jratefunc.average_coal_times(jnp.asarray(a), jg), 1e-4, 100)
    jE = jemission.emission_matrix(jidx, jem, je2)
    want = jhmm.estep(jpi, jT, jnp.asarray(jE), jnp.asarray(spans), jnp.asarray(kk), 6, 8)
    for name, x, w in zip(("ll", "gamma0", "xisum", "gamma_sums"), (ll, g0, xi, gs), want):
        np.testing.assert_allclose(N(x), np.asarray(w), rtol=1e-8, atol=1e-9,
                                   err_msg=name)
