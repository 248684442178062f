"""The port's float64 M-step objective (the Q family) and models against the
JAX package, on the CPU.

One-population managers of both packages are built on the same small
dataset and hidden states, given the same model, parameters and
E-statistics, and compared: pi, T, E and Q at rtol 1e-10, dQ/dy at rtol
1e-8 (autograd against jax.grad; both are float64, differing only in
summation order).  T and E also get an absolute 1e-14: their smallest
entries (T's upper triangle near 1e-6, E's CSFS entries near the 1e-10
floor) come out of sums and prefix products of O(1) terms, whose last-ulp
rounding (about 1e-15 absolute) depends on the order of the 3x3 products.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from smcpp_tpu.inference import estimation as jest  # noqa: E402
from smcpp_tpu.inference.manager import OnePopInferenceManager as JaxIM  # noqa: E402
from smcpp_tpu.models import model as jmodel  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.inference import estimation as test_  # noqa: E402
from smcpp_tpu_torch.inference.manager import OnePopInferenceManager as TorchIM  # noqa: E402
from smcpp_tpu_torch.models import model as tmodel  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

jax.config.update("jax_enable_x64", True)


def _data(rng, n, C=2, rows=400):
    "Random span-compressed one-population rows (span, a, b, nb)."
    out = []
    for _ in range(C):
        d = np.zeros((rows, 4), np.int32)
        d[:, 0] = rng.geometric(0.05, rows)
        d[:, 3] = n
        seg = rng.rand(rows) < 0.3
        d[seg, 1] = rng.randint(0, 3, seg.sum())
        d[seg, 2] = rng.randint(0, n + 1, seg.sum())
        miss = rng.rand(rows) < 0.05
        d[miss, 1] = -1
        d[miss, 2:] = 0
        out.append(d)
    return out


@pytest.fixture(scope="module", params=[(0, 4, 4), (1, 10, 8), (2, 10, 4)],
                ids=["n4-k4", "n10-k8", "n10-k4"])
def pair(request):
    seed, n, knots = request.param
    rng = np.random.RandomState(seed)
    data = _data(rng, n)
    kn = np.logspace(-2, 0.5, knots)
    jm = jmodel.SMCModel(kn, 1e4, "piecewise", ("pop1",))
    y = rng.normal(0.0, 0.6, jm.K)
    jm.y = y.copy()
    tm = tmodel.SMCModel(kn, 1e4, "piecewise", ("pop1",))
    tm.y = y.copy()
    hs = test_.balance_hidden_states(tm, 2 * knots + 1)
    np.testing.assert_allclose(hs, jest.balance_hidden_states(jm, 2 * knots + 1),
                               rtol=1e-14)
    M = len(hs) - 1
    stats = (
        rng.dirichlet(np.ones(M)) * 3,
        rng.rand(M, M) * 100,
        None,
    )
    ims = []
    for cls, m, kw in [
        (JaxIM, jm, dict(compute_device=jax.devices("cpu")[0])),
        (TorchIM, tm, dict(device="cpu")),
    ]:
        im = cls(n, [d.copy() for d in data], hs, ("pop1",), 0.5, **kw)
        im.set_model(m)
        im.theta, im.rho, im.alpha = 1e-3, 4e-4, 100
        gs = np.random.RandomState(seed + 10).rand(im.em_idx.n_keys, M) * 50
        im._stats = (stats[0], stats[1], gs)
        ims.append(im)
    return ims


def test_emission_index_is_a_copy(pair):
    jim, tim = pair
    for f in ("keys", "W", "kind", "parity"):
        np.testing.assert_array_equal(getattr(tim.em_idx, f), getattr(jim.em_idx, f))


def test_tensors_match(pair):
    jim, tim = pair
    for name, j, t in zip(("pi", "T", "E"), jim.tensors(), tim.tensors()):
        t = t.numpy()
        atol = 1e-14 if name in ("T", "E") else 0.0
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-10, atol=atol,
                                   err_msg=name)


def test_q_and_grad_match(pair):
    jim, tim = pair
    rng = np.random.RandomState(7)
    for _ in range(2):
        y = jim.model.y + rng.normal(0.0, 0.3, len(jim.model.y))
        np.testing.assert_allclose(tim.Q(y=y), jim.Q(y=y), rtol=1e-10)
        qj, gj = jim.Q_and_grad(y=y)
        qt, gt = tim.Q_and_grad(y=y)
        np.testing.assert_allclose(qt, qj, rtol=1e-10)
        np.testing.assert_allclose(gt, gj, rtol=1e-8, atol=1e-8 * np.abs(gj).max())


def test_q_batch_matches_loop_and_jax(pair):
    jim, tim = pair
    rng = np.random.RandomState(8)
    K = len(tim.model.y)
    ys = tim.model.y + rng.normal(0.0, 0.3, (5, K))
    rhos = tim.rho * np.exp(rng.normal(0.0, 0.5, 5))
    got = tim.Q_batch(ys=ys, rhos=rhos)
    loop = [tim.Q(y=y, rho=r) for y, r in zip(ys, rhos)]
    np.testing.assert_allclose(got, loop, rtol=1e-12)
    np.testing.assert_allclose(got, jim.Q_batch(ys=ys, rhos=rhos), rtol=1e-10)
    # rho-only sweep: the shared-setup program
    np.testing.assert_allclose(
        tim.Q_batch(rhos=rhos), jim.Q_batch(rhos=rhos), rtol=1e-10
    )
    np.testing.assert_allclose(
        tim.Q_batch(rhos=rhos), [tim.Q(rho=r) for r in rhos], rtol=1e-12
    )


def test_jax_tensors_drive_the_port_estep(pair):
    """(pi, T, E) made by the JAX manager, placed on the port's device with
    ``from_numpy``, give the JAX E-step's result through the port's E-step
    on the port's own window packing (f32 at 'highest': rtol 1e-5)."""
    jim, tim = pair
    assert jim._use_windows and tim._use_windows
    np.testing.assert_array_equal(tim._wkeys.numpy(), np.asarray(jim._wkeys))
    pi, T, E = (np.asarray(x, np.float32) for x in jim.tensors())
    want = jwk.estep_direct(pi, T, E, jim._wkeys, jim._wvalid, jim._soc,
                            precision="highest")
    got = twk.estep_direct(*twk.from_numpy(pi, T, E, "cpu"), tim._wkeys,
                           tim._wvalid, tim._soc, precision="highest")
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.double().numpy(), w, rtol=1e-5,
                                   atol=1e-8 * np.abs(w).max())


@pytest.mark.parametrize("spline", ["piecewise", "cubic", "pchip", "akima", "bspline"])
def test_splines_match(spline):
    rng = np.random.RandomState(3)
    kn = np.logspace(-2, 0.7, 7)
    jm = jmodel.SMCModel(kn, 1e4, spline)
    tm = tmodel.SMCModel(kn, 1e4, spline)
    y = rng.normal(0.0, 0.7, jm.K)
    jm.y, tm.y = y.copy(), y.copy()
    np.testing.assert_allclose(tm.stepwise_values(), np.asarray(jm.stepwise_values()),
                               rtol=1e-12)
    pts = np.logspace(-3, 1, 17)
    np.testing.assert_allclose(tm(pts), np.asarray(jm(pts)), rtol=1e-12)
    np.testing.assert_allclose(tm.regularizer(), jm.regularizer(), rtol=1e-12,
                               atol=1e-14)
    # gradients of a scalar of the stepwise values and of the roughness
    w = rng.rand(len(tm.s))
    gj = jax.grad(lambda v: (w * jm.stepwise_values_fn(v)).sum()
                  + jm.regularizer_fn(v))(y)
    yt = torch.tensor(y, requires_grad=True)
    ((torch.as_tensor(w) * tm.stepwise_values_fn(yt)).sum()
     + tm.regularizer_fn(yt)).backward()
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gj), rtol=1e-10,
                               atol=1e-12)


def test_model_json_round_trips_between_packages(tmp_path):
    jm = jmodel.SMCModel(np.logspace(-2, 0.5, 6), 1.3e4, "cubic", "pop1")
    jm.y = np.linspace(-0.4, 0.9, jm.K)
    fn = tmp_path / "m.json"
    fn.write_text(json.dumps(jm.to_dict()))
    tm = tmodel.model_from_dict(json.loads(fn.read_text()))
    assert tm.to_dict() == jm.to_dict()
    np.testing.assert_allclose(tm.stepwise_values(), np.asarray(jm.stepwise_values()),
                               rtol=1e-12)
    back = jmodel.model_from_dict(json.loads(json.dumps(tm.to_dict())))
    np.testing.assert_array_equal(back.y, jm.y)
    # the two-population model reads across the packages too (it raised
    # before ROADMAP A7 was ported)
    jj = jmodel.SMCTwoPopulationModel(jm, jmodel.model_from_dict(jm.to_dict()), 0.3)
    tj = tmodel.model_from_dict(json.loads(json.dumps(jj.to_dict())))
    assert isinstance(tj, tmodel.SMCTwoPopulationModel)
    assert tj.to_dict() == jj.to_dict()
    assert jmodel.model_from_dict(tj.to_dict()).to_dict() == jj.to_dict()
