"""The precision ladder of the port (tests/test_precision.py's oracles), on
the CPU, against the JAX package where both have the function.

On the CPU every rung computes exact f32/f64 products, so these tests pin the
plumbing as the JAX tests do: the rung threads through the window E-step
without changing an f64 result (and the result is JAX's), the managers'
ladder rebuilds a working E-step on both kernels (window and span) with the
log-likelihood moving only at the bf16-carry level and agreeing with JAX's
at every rung, the optimizer redoes the E-step one rung up when the
likelihood falls, and the bf16 carry of 'default' stays inside the JAX
test's accuracy envelope against the f64 E-step.  The carry dtype of each
rung is tests/test_torch_window_kernel.py::test_carry_dtype_follows_the_ladder;
the environment's rung and carry, tests/test_torch_env.py.

Bounds and why: f64 across rungs rtol 1e-12 (the same arithmetic); the
port's direct f64 E-step against JAX's AD E-step, tests/test_torch_window_
oracles.py's (ll rtol 1e-10, statistics rtol 1e-7); the ladder's steps those
of tests/test_precision.py (rtol 1e-4 leaving 'default', 1e-6 from
'tensorfloat32' to 'highest'); the two managers at one rung
tests/test_torch_remat.py's (ll rtol 1e-6); the bf16 envelope the JAX
test's (ll rtol 1e-5; statistics 5e-2, 2e-3, 5e-3).
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.inference.manager import OnePopInferenceManager as JaxManager  # noqa: E402
from smcpp_tpu.models import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.inference import manager as torch_manager  # noqa: E402
from smcpp_tpu_torch.inference.optimizer import SMCPPOptimizer  # noqa: E402
from smcpp_tpu_torch.models import SMCModel as TorchModel  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_parallel import _synth_contigs  # noqa: E402

sys.path.remove(HERE)

jax.config.update("jax_enable_x64", True)


def _problem(seed, nk, M, S, L, p_valid, e_min):
    "The JAX tests' problems, drawn in their order."
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, nk, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < p_valid
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(e_min, 1.0, (nk, M))
    soc = np.arange(S, dtype=np.int32).reshape(S, 1)
    return pi, T, E, keys, valid, soc


def _direct(pi, T, E, keys, valid, soc, dtype, **kw):
    return twk.estep_direct(*twk.from_numpy(pi, T, E, "cpu", dtype),
                            torch.as_tensor(keys), torch.as_tensor(valid), soc, **kw)


def _stats_close(got, want, rtol_ll, rtols, atol=0.0):
    assert np.isclose(float(got[0]), float(want[0]), rtol=rtol_ll, atol=0)
    for g, w, r in zip(got[1:], want[1:], rtols):
        g = g.detach().double().numpy() if torch.is_tensor(g) else np.asarray(g, np.float64)
        np.testing.assert_allclose(g, np.asarray(w, np.float64), rtol=r, atol=atol)


@pytest.mark.parametrize("precision", ["tensorfloat32", "highest"])
def test_window_kernel_precision_param(precision):
    """test_precision.py:21: an explicit rung gives the f64 result of the
    default rung (the parameter threads through), JAX's direct E-step's at
    that rung and the log-likelihood of JAX's AD E-step (whose statistics
    the JAX test uses; the port has only the direct E-step)."""
    pi, T, E, keys, valid, soc = _problem(3, 7, 5, 4, 32, 0.9, 0.1)
    base = _direct(pi, T, E, keys, valid, soc, torch.float64)
    out = _direct(pi, T, E, keys, valid, soc, torch.float64, precision=precision)
    _stats_close(out, base, 1e-12, (1e-12,) * 3)
    args = (jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys),
            jnp.asarray(valid), soc)
    _stats_close(out, jwk.estep_direct(*args, precision=precision), 1e-10, (1e-10,) * 3)
    jad = jwk.estep_windows(*args, precision=precision)
    assert np.isclose(float(out[0]), float(jad[0]), rtol=1e-10)


def _managers(data, n):
    "The JAX manager and the port's on the same data, states and model."
    hs = np.r_[0.0, np.logspace(-1.2, 0.6, 7), np.inf]
    jim = JaxManager(n, data, hs, ("p",), 0.5, devices=[jax.devices()[0]])
    tim = torch_manager.OnePopInferenceManager(n, data, hs, ("p",), 0.5, device="cpu")
    for im, Model in ((jim, JaxModel), (tim, TorchModel)):
        m = Model(np.array([0.05, 0.3, 1.5]), 1e4, "piecewise")
        m.y[:] = 0.2
        im.set_model(m)
        im.theta = 1e-4
        im.rho = 1e-4
    return jim, tim


@pytest.mark.parametrize("span_range,windows", [((1, 12), True), ((2000, 9000), False)],
                         ids=["window-kernel", "span-kernel"])
def test_manager_precision_ladder(span_range, windows):
    """test_precision.py:54 and :63: the ladder rebuilds the E-step of
    either kernel; the log-likelihood moves at the bf16-carry level leaving
    'default' and by f32 rounding after; the top of the ladder returns None;
    at every rung the port's E-step agrees with JAX's."""
    rng = np.random.RandomState(11 if windows else 12)
    n = 4
    jim, tim = _managers(_synth_contigs(rng, n, 3 if windows else 2, *span_range), n)
    assert tim._use_windows == jim._use_windows == windows
    lls = []
    for rung in ("default", "tensorfloat32", "highest"):
        assert tim.precision == jim.precision == rung
        ll_t, ll_j = tim.E_step(), jim.E_step()
        assert np.isclose(ll_t, ll_j, rtol=1e-6)
        lls.append(ll_t)
        want = None if rung == "highest" else _next_rung(rung)
        assert tim.raise_precision() == want
        assert jim.raise_precision() == want
    assert np.isclose(lls[1], lls[0], rtol=1e-4)
    assert np.isclose(lls[2], lls[1], rtol=1e-6)
    assert tim.precision == "highest"


def _next_rung(rung):
    "The rung above ``rung`` on the managers' ladder."
    ladder = torch_manager.PRECISION_LADDER
    return ladder[ladder.index(rung) + 1]


class _FallbackStub:
    "Analysis stub: loglik jumps down once, recovers after raise_precision."

    def __init__(self):
        self.raised = False
        self.esteps = 0

    def E_step(self):
        self.esteps += 1

    def loglik(self):
        return -1000.0 if self.raised else -1010.0

    def raise_precision(self):
        self.raised = True
        return True


def test_optimizer_precision_fallback():
    """test_precision.py:91: a likelihood that falls past ftol climbs one
    rung and redoes the E-step; not on the first iteration, not at the top
    of the ladder, never on an improvement."""
    a = _FallbackStub()
    opt = SMCPPOptimizer.__new__(SMCPPOptimizer)
    opt._analysis = a
    opt._ftol = 1e-6
    opt._old_loglik = None
    assert opt._maybe_raise_precision(-1005.0) == -1005.0
    assert not a.raised
    opt._old_loglik = -1005.0
    ll = opt._maybe_raise_precision(-1010.0)
    assert a.raised and a.esteps == 1
    assert ll == -1000.0
    a2 = _FallbackStub()
    a2.raise_precision = lambda: False
    opt._analysis = a2
    assert opt._maybe_raise_precision(-1010.0) == -1010.0
    assert a2.esteps == 0
    a3 = _FallbackStub()
    opt._analysis = a3
    opt._old_loglik = -1005.0
    assert opt._maybe_raise_precision(-1001.0) == -1001.0
    assert not a3.raised


def test_bf16_carry_accuracy():
    """test_precision.py:127: f32 inputs at 'default' store the carries in
    bf16; the E-step stays inside the JAX test's envelope of the f64 E-step
    (ll rtol 1e-5; pi-stat, xisum, gamma sums rtol 5e-2, 2e-3, 5e-3), and
    is JAX's direct bf16 E-step at the window kernel's bf16 bounds (ll rtol
    1e-6, statistics rtol 1e-4: tests/test_torch_remat.py's)."""
    pi, T, E, keys, valid, soc = _problem(5, 12, 8, 6, 256, 0.95, 0.05)
    f64 = _direct(pi, T, E, keys, valid, soc, torch.float64, precision="highest")
    bf = _direct(pi, T, E, keys, valid, soc, torch.float32, precision="default")
    _stats_close(bf, f64, 1e-5, (5e-2, 2e-3, 5e-3), atol=1e-8)
    a32 = [jnp.asarray(x, jnp.float32) for x in (pi, T, E)]
    jbf = jwk.estep_direct(*a32, jnp.asarray(keys), jnp.asarray(valid), soc,
                           precision="default")
    _stats_close(bf, jbf, 1e-6, (1e-4,) * 3, atol=1e-8)
