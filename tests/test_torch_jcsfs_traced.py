"""The port's traced joint CSFS (smcpp_tpu_torch/ops/jcsfs_traced.py) and the
two-population manager's default ``tensors()`` route against the JAX
package's, on the CPU: tests/test_jcsfs_traced.py's 18 cases.

Inputs are that file's ``_models()`` / ``_manager()`` (N1, N2 = 4, 3; pchip
marginals), at splits below, inside and above the hidden states and on a
hidden-state boundary (0.9999999), with the distinguished pair together
(a1 = 2) and apart (a1 = a2 = 1).

* ``TracedJointCSFS.compute`` against JAX's on the same marginal vectors
  at rtol 1e-10 / atol 1e-14 (measured at most 5e-15 apart), and against
  the port's eager ``JointCSFS`` at JAX's own rule (1e-6 relative on
  entries above 1e-8, atol 1e-9: the eps -> 0 below-split limit against
  the eager two-sided 1e-6 interval);
* the manager's ``tensors()`` against JAX's default (traced) ``tensors()``
  at rtol 1e-10 / atol 1e-14, except the T rows of the apart model's
  below-split intervals, which carry under 1e-11 of pi and which both
  float64 paths know to about 3 digits (held at rtol 1e-2, as
  tests/test_torch_twopop.py holds the eager pair); and against the port's
  own eager route at tests/test_jcsfs_traced.py's bounds;
* the window E-step's log-likelihood against JAX's default E-step at rtol
  1e-8 (measured 9e-11), its statistics at the cross-package bound of the
  window kernels (rtol 1e-4, atol 1e-6 of the largest entry, as
  tests/test_torch_twopop.py); and the port's traced E-step against its
  eager one at JAX's own bounds (ll rtol 1e-8, statistics rtol 1e-5 / atol
  1e-8), except the entries of the apart model's below-split states,
  held at rtol 1e-2 as their T rows are (measured 1.3e-3);
* one ``TracedJointCSFS`` per static key across split and y changes;
* the route follows the model type and does not read
  SMCPP_TPU_TRACED_JCSFS.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from smcpp_tpu.inference import estimation  # noqa: E402
from smcpp_tpu.models import model as jmodel  # noqa: E402
from smcpp_tpu.ops.jcsfs_traced import TracedJointCSFS as JaxTraced  # noqa: E402
from smcpp_tpu_torch.ops.jcsfs import JointCSFS  # noqa: E402
from smcpp_tpu_torch.ops.jcsfs_traced import TracedJointCSFS  # noqa: E402
from tests.test_torch_twopop import N1, N2, _managers, _models  # noqa: E402

jax.config.update("jax_enable_x64", True)

RTOL, ATOL = 1e-10, 1e-14


def _close_tensors(got, want, a1):
    """pi, E and the live T rows at RTOL / ATOL; the apart model's
    below-split T rows (pi under 1e-10, their mass under 1e-11) at 1e-2."""
    (pi_t, T_t, E_t), (pi_j, T_j, E_j) = got, want
    np.testing.assert_allclose(pi_t, pi_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(E_t, E_j, rtol=RTOL, atol=ATOL)
    live = pi_j > 1e-10
    assert live.sum() >= 2 and (a1 == 1 or live.all())
    np.testing.assert_allclose(T_t[live], T_j[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(T_t[~live], T_j[~live], rtol=1e-2)
    assert pi_j[~live].sum() < 1e-11


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
@pytest.mark.parametrize("split", [0.005, 0.25, 2.0])
def test_traced_joint_csfs_matches_eager(a1, a2, split):
    "Raw J: JAX's traced J at rtol 1e-10, the port's eager J at JAX's rule."
    m1, m2 = _models(jmodel)
    a1v, a2v = np.asarray(m1.stepwise_values()), np.asarray(m2.stepwise_values())
    hs = np.asarray(estimation.balance_hidden_states(m1, 7))
    J_t = TracedJointCSFS(N1, N2, a1, a2, m1.s, m2.s, hs, K=10,
                          device="cpu").compute(a1v, a2v, split)
    assert J_t.dtype == torch.float64
    J_t = J_t.numpy()
    assert np.all(np.isfinite(J_t))
    J_j = np.asarray(
        JaxTraced(N1, N2, a1, a2, m1.s, m2.s, hs, K=10).compute(a1v, a2v, split)
    )
    np.testing.assert_allclose(J_t, J_j, rtol=RTOL, atol=ATOL)
    J_e = JointCSFS(N1, N2, a1, a2, hs, K=10).compute(
        (a1v, m1.s), (a2v, m2.s), split
    )
    sig = np.abs(J_e) > 1e-8
    rel = np.abs(J_t - J_e) / np.maximum(np.abs(J_e), 1e-12)
    assert rel[sig].max() < 1e-6
    np.testing.assert_allclose(J_t, J_e, atol=1e-9)


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
@pytest.mark.parametrize("split,M", [(0.25, 6), (0.005, 6), (2.0, 6),
                                     (0.9999999, 8)])
def test_traced_tensors_match_eager(a1, a2, split, M):
    "tensors(): JAX's traced route at rtol 1e-10, the port's eager at 1e-6."
    jim, tim = _managers(a1, a2, M, split)
    assert jim._traced_tensors_ok() and tim._traced_tensors_ok()
    want = [np.asarray(x) for x in jim.tensors()]
    got = [x.numpy() for x in tim.tensors()]
    assert len(tim._traced_cache) == 1
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
    _close_tensors(got, want, a1)

    with torch.no_grad():
        pi_e, T_e, E_e = [x.numpy() for x in tim._tensors_eager()]
    pi_t, T_t, E_t = got
    np.testing.assert_allclose(pi_t, pi_e, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(E_t, E_e, rtol=1e-6, atol=1e-12)
    # T rows of zero-mass intervals are numerically arbitrary in both
    # routes (near-0/0 average coalescence times): weight by pi
    np.testing.assert_allclose(pi_t[:, None] * T_t, pi_e[:, None] * T_e,
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
def test_traced_estep_loglik_matches_eager(a1, a2, monkeypatch):
    jim, tim = _managers(a1, a2, 6, 0.25, precision="highest")
    assert jim._use_windows and tim._use_windows
    ll_j, ll_t = jim.E_step(), tim.E_step()
    stats_t = [np.array(s) for s in tim._stats]
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-8)
    for t, j in zip(stats_t, jim._stats):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())

    # the port's eager route, as tests/test_jcsfs_traced.py holds JAX's;
    # the entries of the apart model's below-split states (pi under 1e-10)
    # carry their T rows' 3-digit agreement (measured 1.3e-3)
    live = tim.tensors()[0].numpy() > 1e-10
    monkeypatch.setattr(tim, "_traced_tensors_ok", lambda: False)
    tim._tensors_cache = (None, None)
    ll_e = tim.E_step()
    np.testing.assert_allclose(ll_t, ll_e, rtol=1e-8)
    masks = (live, live[:, None] & live[None, :],
             np.broadcast_to(live, tim._stats[2].shape))
    for t, e, m in zip(stats_t, tim._stats, masks):
        np.testing.assert_allclose(t[m], e[m], rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(t[~m], e[~m], rtol=1e-2, atol=1e-8)


def test_traced_cache_no_retrace_on_split_or_y():
    """Split and y changes under one static key reuse one TracedJointCSFS
    (the split search must build nothing per candidate), and give JAX's
    tensors at the new parameters."""
    jim, tim = _managers(2, 0, 6, 0.25)
    tim.tensors()
    assert len(tim._traced_cache) == 1
    tj = next(iter(tim._traced_cache.values()))[0]
    for im in (jim, tim):
        im.model.split = 0.4
        im.model.model1.y[:] += 0.01
    got = [x.numpy() for x in tim.tensors()]
    assert len(tim._traced_cache) == 1
    assert next(iter(tim._traced_cache.values()))[0] is tj
    assert np.all(np.isfinite(got[2]))
    _close_tensors(got, [np.asarray(x) for x in jim.tensors()], 2)


class _Marginal:
    "A marginal that is not an SMCModel: forwards to one."

    def __init__(self, m):
        self._m = m

    def __getattr__(self, name):
        return getattr(self._m, name)

    def __call__(self, x):
        return self._m(x)


def test_traced_env_revert(monkeypatch):
    """The route follows the model: SMCPP_TPU_TRACED_JCSFS=0 is not read
    (the traced route stays, equal to JAX's default), and marginals that
    are not SMCModels take the eager route (equal to JAX's =0 route)."""
    monkeypatch.setenv("SMCPP_TPU_TRACED_JCSFS", "0")
    jim, tim = _managers(2, 0, 6, 0.25)
    assert tim._traced_tensors_ok() and not jim._traced_tensors_ok()
    got = [x.numpy() for x in tim.tensors()]
    assert len(tim._traced_cache) == 1
    monkeypatch.delenv("SMCPP_TPU_TRACED_JCSFS")
    _close_tensors(got, [np.asarray(x) for x in jim.tensors()], 2)

    jim, tim = _managers(2, 0, 6, 0.25)
    tim.model.model1 = _Marginal(tim.model.model1)
    tim.model.model2 = _Marginal(tim.model.model2)
    assert not tim._traced_tensors_ok()
    got = [x.numpy() for x in tim.tensors()]
    assert not tim._traced_cache
    monkeypatch.setenv("SMCPP_TPU_TRACED_JCSFS", "0")
    _close_tensors(got, [np.asarray(x) for x in jim.tensors()], 2)
