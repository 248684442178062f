"""The port's split-time objective (smcpp_tpu_torch/ops/split_objective.py)
against its own eager JCSFS and against the JAX package, on the CPU.

* the four tests of tests/test_split_objective.py against the port: the
  split-dependent J tensors against the eager ``JointCSFS.compute`` at rtol
  1e-6 / atol 1e-8 (the only residual is the eager two-sided 1e-6
  below-at-split interval, replaced here by its exact limit); the
  manager-level Q against the eager Q at rtol 1e-3 (raw model2 against the
  spliced marginal); dQ/dsplit against central differences at rtol 1e-4;
  the marginal objective against the eager Q at rtol 2e-3 and its gradient;
* parity: ``SplitObjective.q_batch`` and ``MarginalSplitObjective.q_batch``
  equal to JAX's on the same statistics at rtol 1e-9, ``q_and_grad`` at
  rtol 1e-7 (both float64; the port maps over the batch with
  torch.func.vmap and differentiates with autograd, JAX with vmap and grad:
  measured 3e-16 and 1e-15).
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from smcpp_tpu.inference.manager import OnePopInferenceManager as JaxOne  # noqa: E402
from smcpp_tpu.inference.manager import TwoPopInferenceManager as JaxTwo  # noqa: E402
from smcpp_tpu.models import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu.models import SMCTwoPopulationModel as JaxJoint  # noqa: E402
from smcpp_tpu_torch.inference.manager import OnePopInferenceManager as TorchOne  # noqa: E402
from smcpp_tpu_torch.inference.manager import TwoPopInferenceManager as TorchTwo  # noqa: E402
from smcpp_tpu_torch.models import PiecewiseModel, SMCModel, SMCTwoPopulationModel  # noqa: E402
from smcpp_tpu_torch.ops import jcsfs as tmod  # noqa: E402
from smcpp_tpu_torch.ops.split_objective import SplitObjective  # noqa: E402

jax.config.update("jax_enable_x64", True)

MODEL1 = (np.array([1.0, 4.0]), np.array([0.5, 1.0]))
MODEL2 = (np.array([2.0, 4.0, 2.0]), np.array([0.1, 0.2, 0.3]))
KNOTS = np.array([0.05, 0.2, 0.8, 3.0])


def _stub(a1, a2, n1, n2, K=16):
    """A SplitObjective of the raw (a, s) models MODEL1 and MODEL2 (only its
    J-tensor machinery is used), and the eager JointCSFS."""
    im = types.SimpleNamespace(
        n1=n1, n2=n2, a1=a1, a2=a2, theta=1e-4, alpha=1, em_idx=None,
        _stats=(None, None, np.zeros((1, 1))), _device=torch.device("cpu"),
        model=types.SimpleNamespace(model1=PiecewiseModel(*MODEL1),
                                    model2=PiecewiseModel(*MODEL2)),
    )
    return SplitObjective(im, quad_K=K), tmod.JointCSFS(
        n1, n2, a1, a2, [0.0, np.inf], K=K)


@pytest.mark.parametrize(
    "a1,a2,n1,n2", [(2, 0, 5, 8), (1, 1, 4, 5)],
    ids=["together", "apart"],
)
def test_traced_j_matches_eager(a1, a2, n1, n2):
    so, ref = _stub(a1, a2, n1, n2)
    fn = so._j_together if a1 == 2 else so._j_apart
    for split in [0.05, 0.3, 0.8, 2.0]:
        with torch.no_grad():
            Jt = fn(torch.tensor(split, dtype=torch.float64)).numpy()
        Jt = np.maximum(Jt, 1e-20)
        v = Jt.reshape(1, a1 + 1, n1 + 1, a2 + 1, n2 + 1).copy()
        v[:, 0, 0, 0, 0] = 0.0
        v[:, a1, n1, a2, n2] = 0.0
        Je = ref.compute(MODEL1, MODEL2, split)
        np.testing.assert_allclose(v.reshape(Je.shape), Je, rtol=1e-6, atol=1e-8)


def _joint_data(a1, a2, n1=3, n2=3):
    rng = np.random.RandomState(5)
    rows = 60
    data = []
    for _ in range(3):
        data.append(np.c_[
            rng.randint(1, 50, rows),
            rng.randint(0, a1 + 1, rows), rng.randint(0, n1 + 1, rows),
            np.full(rows, n1),
            rng.randint(0, a2 + 1, rows) if a2 else np.zeros(rows),
            rng.randint(0, n2 + 1, rows), np.full(rows, n2),
        ].astype(np.int64))
    return data


def _joint_model(Model, Joint, split):
    m1 = Model(KNOTS, 2e4, "piecewise", "p1")
    m1.y[:] = 0.1
    m2 = Model(KNOTS, 2e4, "piecewise", "p2")
    m2.y[:] = -0.2
    return Joint(m1, m2, split)


def _params(im, model):
    im.set_model(model)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 1
    im.E_step()
    return im, model


def _make_joint_setup(split=0.4, a1=2, a2=0):
    im = TorchTwo(3, 3, a1, a2, _joint_data(a1, a2), np.array([0.0, np.inf]),
                  ("p1", "p2"), 0.5, device="cpu")
    return _params(im, _joint_model(SMCModel, SMCTwoPopulationModel, split))


def test_manager_q_batch_close_to_eager():
    im, model = _make_joint_setup()
    so = im.split_objective()
    splits = np.array([0.05, 0.2, 0.5, 1.0, 2.0])
    qt = so.q_batch(splits)
    qe = np.array(
        [(setattr(model, "split", float(s)), im.Q())[1] for s in splits]
    )
    # raw-model2 vs spliced-marginal deviation only (module docstring)
    np.testing.assert_allclose(qt, qe, rtol=1e-3)


def test_split_grad_matches_fd():
    im, _ = _make_joint_setup()
    so = im.split_objective()
    for s in (0.15, 0.5, 1.2):
        v, g = so.q_and_grad(s)
        eps = 1e-5
        v1, _ = so.q_and_grad(s + eps)
        v0, _ = so.q_and_grad(s - eps)
        fd = (v1 - v0) / (2 * eps)
        assert np.isclose(g, fd, rtol=1e-4), (s, g, fd)


def _marginal_data(n=4):
    rng = np.random.RandomState(7)
    rows = 50
    return [
        np.c_[
            rng.randint(1, 40, rows), rng.randint(0, 3, rows),
            rng.randint(0, n + 1, rows), np.full(rows, n),
        ].astype(np.int64)
        for _ in range(2)
    ]


def _make_marginal_setup(split=0.4):
    im = TorchOne(4, _marginal_data(), np.array([0.0, np.inf]), ("p2",), 0.5,
                  device="cpu")
    return _params(im, _joint_model(SMCModel, SMCTwoPopulationModel, split))


def test_marginal_split_objective_matches_eager():
    im, model = _make_marginal_setup()
    mo = im.marginal_split_objective()
    splits = np.array([0.1, 0.3, 0.7, 1.5])
    qt = mo.q_batch(splits)
    qe = np.array(
        [(setattr(model, "split", float(s)), im.Q())[1] for s in splits]
    )
    # static-grid splice vs eager spline re-fit: small discretization gap
    np.testing.assert_allclose(qt, qe, rtol=2e-3)
    # gradient sanity
    v, g = mo.q_and_grad(0.5)
    eps = 1e-5
    v1, _ = mo.q_and_grad(0.5 + eps)
    v0, _ = mo.q_and_grad(0.5 - eps)
    assert np.isclose(g, (v1 - v0) / (2 * eps), rtol=1e-3, atol=1e-3)


# --- parity with JAX on the same statistics --------------------------------

SPLITS = np.array([0.02, 0.05, 0.2, 0.4, 0.5, 1.0, 2.0, 2.9])


def _pair(kind, a1=2, a2=0):
    "The JAX and the port's objective, built on the same statistics."
    hs = np.array([0.0, np.inf])
    out = []
    for Two, One, Model, Joint, kw in (
        (JaxTwo, JaxOne, JaxModel, JaxJoint, {}),
        (TorchTwo, TorchOne, SMCModel, SMCTwoPopulationModel, {"device": "cpu"}),
    ):
        if kind == "joint":
            im = Two(3, 3, a1, a2, _joint_data(a1, a2), hs, ("p1", "p2"), 0.5, **kw)
        else:
            im = One(4, _marginal_data(), hs, ("p2",), 0.5, **kw)
        im, model = _params(im, _joint_model(Model, Joint, 0.4))
        out.append(im)
    jim, tim = out
    for a, b in zip(jim._stats, tim._stats):
        np.testing.assert_array_equal(a, b)
    tim._stats = tuple(np.array(s) for s in jim._stats)
    if kind == "joint":
        return jim.split_objective(), tim.split_objective()
    return jim.marginal_split_objective(), tim.marginal_split_objective()


@pytest.mark.parametrize("kind,a1,a2", [("joint", 2, 0), ("joint", 1, 1),
                                        ("marginal", 2, 0)],
                         ids=["together", "apart", "marginal"])
def test_q_batch_matches_jax(kind, a1, a2):
    jo, to = _pair(kind, a1, a2)
    np.testing.assert_allclose(to.q_batch(SPLITS), jo.q_batch(SPLITS), rtol=1e-9)
    for s in (0.15, 0.5, 1.2):
        (vt, gt), (vj, gj) = to.q_and_grad(s), jo.q_and_grad(s)
        np.testing.assert_allclose(vt, vj, rtol=1e-7)
        np.testing.assert_allclose(gt, gj, rtol=1e-7)
