"""The port's two-population model and manager against the JAX package, on
the CPU.

* ``SMCTwoPopulationModel``: ``for_pop`` (the apart model, model1, the pop-2
  splice) and the JSON round trip, read across the two packages;
* the port's eager ``tensors()`` route (``_tensors_eager``, ops/jcsfs.py)
  against JAX's eager path (SMCPP_TPU_TRACED_JCSFS=0) at rtol 1e-10 (both
  float64; pi, T and E also at atol 1e-14 as tests/test_torch_qfamily.py
  holds the one-population tensors: their smallest entries come out of sums
  of O(1) terms whose last-ulp rounding depends on the order), except the T
  rows of the apart model's below-split intervals, which both paths know to
  about 3 digits (held at rtol 1e-2; they carry under 1e-11 of pi); and the
  default route, ops/jcsfs_traced.py, against JAX's default traced path at
  the same bounds (pi T also at tests/test_jcsfs_traced.py's rtol 1e-6);
* the window E-step's log-likelihood and statistics against JAX's (both
  packages' default traced tensors, both at 'highest'), at the bounds
  tests/test_torch_estimate.py holds the one-population manager to: ll rtol
  1e-6, statistics rtol 1e-4 and atol 1e-6 of the largest entry;
* the four tests of tests/test_twopop_kernel.py against the port: the
  window E-step against the span E-step (both f32 here: ll rtol 1e-6,
  statistics rtol 1e-4 / atol 1e-6 of the largest entry; the production
  'default' rung within rtol 1e-3 of 'highest' on the aggregates), the
  decode against the f64 span oracle (rtol 5e-3, atol 2e-3), the apart pair
  finite, the tensors cache tracking model, split and rho;
* ``simulate_joint_contig`` against JAX's on the same seed, row for row.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from smcpp_tpu.data import simulate as jsim  # noqa: E402
from smcpp_tpu.inference import estimation  # noqa: E402
from smcpp_tpu.inference.manager import TwoPopInferenceManager as JaxTwo  # noqa: E402
from smcpp_tpu.models import model as jmodel  # noqa: E402
from smcpp_tpu_torch.data import simulate as tsim  # noqa: E402
from smcpp_tpu_torch.inference.manager import TwoPopInferenceManager as TorchTwo  # noqa: E402
from smcpp_tpu_torch.models import model as tmodel  # noqa: E402
from smcpp_tpu_torch.ops import hmm  # noqa: E402

jax.config.update("jax_enable_x64", True)

N1, N2 = 4, 3


def _models(mod, spline="pchip"):
    "tests/test_jcsfs_traced.py's marginal models, in package ``mod``."
    knots = np.logspace(-2, np.log10(3.0), 5)
    m1 = mod.SMCModel(knots, 2e4, spline, pid="pop1")
    m1.y[:] = np.sin(np.linspace(0, 2.0, len(m1.y))) * 0.4
    m2 = mod.SMCModel(knots, 2e4, spline, pid="pop2")
    m2.y[:] = 0.2
    return m1, m2


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("split", [0.005, 0.25, 2.0])
def test_model_for_pop_and_json_match_jax(split):
    jm = jmodel.SMCTwoPopulationModel(*_models(jmodel), split)
    tm = tmodel.SMCTwoPopulationModel(*_models(tmodel), split)
    assert tm.pids == jm.pids == ["pop1", "pop2"]
    assert tm.N0 == jm.N0 and tm.K == jm.K and tm.split_ind == jm.split_ind
    np.testing.assert_array_equal(tm.s, jm.s)
    for pid in (None, "pop1", "pop2"):
        t, j = tm.for_pop(pid), jm.for_pop(pid)
        assert type(t).__name__ == type(j).__name__
        np.testing.assert_allclose(t.s, j.s, rtol=1e-14)
        np.testing.assert_allclose(t.stepwise_values(), j.stepwise_values(),
                                   rtol=1e-12)
    np.testing.assert_allclose(tm.regularizer(), jm.regularizer(), rtol=1e-10)
    assert tm.distinguished_model is tm.model1
    # JSON written by either package loads in the other
    dj = json.loads(json.dumps(jm.to_dict()))
    dt = json.loads(json.dumps(tm.to_dict()))
    assert dt == dj and dt["class"] == "SMCTwoPopulationModel"
    back = tmodel.model_from_dict(dj)
    assert isinstance(back, tmodel.SMCTwoPopulationModel)
    assert back.to_dict() == dj and back.copy().to_dict() == dj
    assert jmodel.model_from_dict(dt).to_dict() == dt
    assert isinstance(tmodel.model_from_dict(jm.model1.to_dict()),
                      tmodel.SMCModel)


# --- the manager's tensors ----------------------------------------------------

def _data(a1, a2, n_rows=300, seed=11):
    rng = np.random.RandomState(seed)
    data = np.zeros((n_rows, 7), dtype=np.int32)
    data[:, 0] = rng.randint(20, 400, n_rows)
    data[:, 1] = rng.randint(0, a1 + 1, n_rows)
    data[:, 3] = N1
    data[:, 2] = rng.randint(0, N1 + 1, n_rows)
    data[:, 4] = -1 if a2 == 0 else rng.randint(0, a2 + 1, n_rows)
    data[:, 6] = N2
    data[:, 5] = rng.randint(0, N2 + 1, n_rows)
    return data


def _managers(a1, a2, M, split, **kw):
    "JAX's and the port's managers on the same data, model and parameters."
    data = _data(a1, a2)
    out = []
    for mod, Two, dev in ((jmodel, JaxTwo, {}), (tmodel, TorchTwo, {"device": "cpu"})):
        m1, m2 = _models(mod)
        jm = mod.SMCTwoPopulationModel(m1, m2, split)
        hs = estimation.balance_hidden_states(_models(jmodel)[0], M + 1)
        im = Two(N1, N2, a1, a2, [data], hs, ("pop1", "pop2"), 0.5, **dev, **kw)
        im.set_model(jm)
        im.theta = 1e-4
        im.rho = 1e-4
        im.alpha = 1
        out.append(im)
    return out


CASES = [(0.25, 6), (0.005, 6), (2.0, 6), (0.9999999, 8)]


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
@pytest.mark.parametrize("split,M", CASES)
def test_tensors_match_jax_eager(a1, a2, split, M, monkeypatch):
    "The port's eager route (ops/jcsfs.py), called directly, against JAX's."
    jim, tim = _managers(a1, a2, M, split)
    monkeypatch.setenv("SMCPP_TPU_TRACED_JCSFS", "0")
    assert not jim._traced_tensors_ok()
    want = [np.asarray(x) for x in jim.tensors()]
    with torch.no_grad():
        got = [x.numpy() for x in tim._tensors_eager()]
    assert all(g.dtype == np.float64 for g in got)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    (pi_t, T_t, E_t), (pi_j, T_j, E_j) = got, want
    np.testing.assert_allclose(pi_t, pi_j, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(E_t, E_j, rtol=1e-10, atol=1e-14)
    # The apart model's intervals below the split hold only the 1e12
    # stand-in's spurious mass (pi near 1e-13): their T rows divide by it,
    # so both float64 paths keep about 3 digits there (measured 1e-3
    # relative apart).  They are held at rtol 1e-2, with their mass under
    # 1e-11; every other row at rtol 1e-10.
    live = pi_j > 1e-10
    assert live.sum() >= 2 and (a1 == 1 or live.all())
    np.testing.assert_allclose(T_t[live], T_j[live], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(T_t[~live], T_j[~live], rtol=1e-2)
    assert pi_j[~live].sum() < 1e-11


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
@pytest.mark.parametrize("split,M", [(0.25, 6), (2.0, 6)])
def test_tensors_near_jax_traced(a1, a2, split, M):
    "tensors() (the traced route) against JAX's default traced tensors()."
    jim, tim = _managers(a1, a2, M, split)
    assert jim._traced_tensors_ok() and tim._traced_tensors_ok()
    pi_j, T_j, E_j = [np.asarray(x) for x in jim.tensors()]
    pi_t, T_t, E_t = [x.numpy() for x in tim.tensors()]
    np.testing.assert_allclose(pi_t, pi_j, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(E_t, E_j, rtol=1e-10, atol=1e-14)
    live = pi_j > 1e-10
    np.testing.assert_allclose(T_t[live], T_j[live], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(T_t[~live], T_j[~live], rtol=1e-2)
    np.testing.assert_allclose(pi_t[:, None] * T_t, pi_j[:, None] * T_j,
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
def test_estep_matches_jax(a1, a2):
    "Both packages' default (traced) routes into the window E-step."
    jim, tim = _managers(a1, a2, 6, 0.25, precision="highest")
    assert jim._traced_tensors_ok() and tim._traced_tensors_ok()
    assert jim._use_windows and tim._use_windows
    ll_j, ll_t = jim.E_step(), tim.E_step()
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-6)
    for t, j in zip(tim._stats, jim._stats):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())


# --- the four tests of tests/test_twopop_kernel.py, against the port --------

@pytest.fixture(scope="module")
def twopop_setup():
    rng = np.random.RandomState(11)
    n_rows = 400
    # columns: span, a1, b1, nb1, a2, b2, nb2 with the distinguished pair
    # in pop1 (a1=2, a2=0 — the vcf2smc default for joint data)
    data = np.zeros((n_rows, 7), dtype=np.int32)
    data[:, 0] = rng.randint(20, 400, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    data[:, 4] = -1
    data[:, 6] = 1
    data[:, 5] = rng.randint(0, 2, n_rows)

    m1 = tmodel.SMCModel([0.01, 3.0], 20000.0, "piecewise", pid="pop1")
    m1.y[:] = 0.0
    m2 = tmodel.SMCModel([0.01, 3.0], 20000.0, "piecewise", pid="pop2")
    m2.y[:] = 0.1
    jm = tmodel.SMCTwoPopulationModel(m1, m2, 0.25)
    hs = estimation.balance_hidden_states(m1, 6)
    return data, jm, hs


def _make_im(data, jm, hs, force_span=False, precision=None):
    im = TorchTwo(2, 1, 2, 0, [data], hs, ("pop1", "pop2"), 0.5, device="cpu",
                  precision=precision)
    if force_span:
        assert im._use_windows  # the cost model picked windows first
        im._use_windows = False
    im.set_model(jm)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 1
    return im


def test_twopop_window_kernel_selected_and_matches_span(twopop_setup):
    data, jm, hs = twopop_setup
    im_w = _make_im(data, jm, hs, precision="highest")
    assert im_w._use_windows, "cost model should pick the window kernel here"
    im_s = _make_im(data, jm, hs, force_span=True, precision="highest")

    ll_w = im_w.E_step()
    ll_s = im_s.E_step()
    assert np.isclose(ll_w, ll_s, rtol=1e-6)
    for a, b in zip(im_w._stats, im_s._stats):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * np.abs(b).max())

    # the production bf16-carry rung stays within kernel noise of 'highest'
    # on the aggregates
    im_f = _make_im(data, jm, hs, precision="default")
    ll_f = im_f.E_step()
    assert np.isclose(ll_f, ll_w, rtol=1e-3)
    for a, b in zip(im_f._stats, im_w._stats):
        assert np.isclose(np.sum(a), np.sum(b), rtol=1e-3)


def test_twopop_posterior_decode_matches_span_oracle(twopop_setup):
    data, jm, hs = twopop_setup
    im = _make_im(data, jm, hs)
    im.save_gamma = True
    im.E_step()
    g = im.gammas[0]
    assert g.shape[0] == len(data)
    np.testing.assert_allclose(g.sum(axis=1), data[:, 0], rtol=1e-3)

    # span-kernel oracle, per contig, f64
    pi, T, E = im.tensors()
    ref = hmm.posterior_gammas(
        pi, T, E, torch.as_tensor(im._spans[0]), torch.as_tensor(im._keys[0]),
        im._nbits, im._chunk,
    ).numpy()
    nsub = int(im._row_reps[0].sum())
    offs = np.concatenate([[0], np.cumsum(im._row_reps[0])[:-1]])
    ref_rows = np.add.reduceat(ref[:nsub], offs, axis=0)
    # decode runs the f32 E-step dtype; gammas reach ~2e2 per row
    np.testing.assert_allclose(g, ref_rows, rtol=5e-3, atol=2e-3)


def test_apart_pair_estep_finite(twopop_setup):
    """a1 = a2 = 1 (distinguished lineages split across populations): the
    pre-split size is infinite, which must NOT produce NaN transition rows
    on an M > 1 grid."""
    _, jm, hs = twopop_setup
    rng = np.random.RandomState(5)
    n_rows = 120
    data = np.zeros((n_rows, 7), dtype=np.int32)
    data[:, 0] = rng.randint(10, 200, n_rows)
    data[:, 1] = rng.randint(0, 2, n_rows)
    data[:, 3] = 1
    data[:, 2] = rng.randint(0, 2, n_rows)
    data[:, 4] = rng.randint(0, 2, n_rows)
    data[:, 6] = 1
    data[:, 5] = rng.randint(0, 2, n_rows)
    im = TorchTwo(1, 1, 1, 1, [data], hs, ("pop1", "pop2"), 0.5, device="cpu")
    im.set_model(jm)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 1
    im.save_gamma = True
    ll = im.E_step()
    assert np.isfinite(ll)
    g = im.gammas[0]
    np.testing.assert_allclose(g.sum(axis=1), data[:, 0], rtol=1e-3)
    # no posterior mass below the split for the never-coalesced-below pair
    below = np.asarray(hs[1:]) <= jm.split
    if below.any():
        assert g[:, below].sum() < 1e-3 * g.sum()


def test_tensors_cache_tracks_model_and_rho(twopop_setup):
    """tensors() keeps one cached (pi, T, E) per parameter set: changing the
    model values, the split time or rho must give fresh tensors, equal to a
    from-scratch manager's with no cache history."""
    data, jm, hs = twopop_setup
    im = _make_im(data, jm, hs)
    base = [x.clone() for x in im.tensors()]
    assert im.tensors()[2] is im.tensors()[2]  # the cached entry

    im.rho = 5e-4
    fresh = _make_im(data, jm, hs)
    fresh.rho = 5e-4
    for a, b in zip(im.tensors(), fresh.tensors()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(im.tensors()[1], base[1])

    m1b = tmodel.SMCModel([0.01, 3.0], 20000.0, "piecewise", pid="pop1")
    m1b.y[:] = 0.3
    m2b = tmodel.SMCModel([0.01, 3.0], 20000.0, "piecewise", pid="pop2")
    m2b.y[:] = -0.2
    jmb = tmodel.SMCTwoPopulationModel(m1b, m2b, 0.6)
    im.set_model(jmb)
    im.rho = 1e-4
    fresh2 = _make_im(data, jmb, hs)
    for a, b in zip(im.tensors(), fresh2.tensors()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(im.tensors()[2], base[2])
    # in-place changes of the model's values and split are seen too
    e0 = im.tensors()[2].clone()
    jmb.model1.y[:] += 0.05
    assert not torch.equal(im.tensors()[2], e0)
    e1 = im.tensors()[2].clone()
    jmb.split = 0.7
    assert not torch.equal(im.tensors()[2], e1)


# --- the simulator ------------------------------------------------------------

def test_simulate_joint_contig_matches_jax():
    out = []
    for mod, sim in ((jmodel, jsim), (tmodel, tsim)):
        m1, m2 = _models(mod, "piecewise")
        out.append(sim.simulate_joint_contig(
            mod.SMCTwoPopulationModel(m1, m2, 0.4), 1e-3, 1e-3, 400_000, 4, 3,
            seed=2))
    assert out[1].dtype == np.int32 and out[1].shape[1] == 7
    assert out[1][:, 0].sum() == 400_000
    np.testing.assert_array_equal(out[1], out[0])
