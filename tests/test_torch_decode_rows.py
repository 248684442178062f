"""The port's row-level posterior decode and MAP paths (ops/hmm.py and the
manager's row-level branches) against the JAX package, on the CPU: the
row-level cases of tests/test_decode.py, and the manager's span E-step and
row-level posterior against JAX's manager.

Inputs are made from a seed with NumPy and handed to both packages.
Bounds and why:

* float64 kernels: the same recursions in another order: rtol 1e-10 on the
  row gammas (test_decode.py holds the JAX decode to its oracle at atol
  1e-12), MAP paths exactly equal;
* the managers run the span E-step and the decode in float32 on both
  sides, through the same row operators and scans summed in another order
  (the port accumulates the statistics in f64, JAX in f32): the
  log-likelihood at rtol 1e-6 and the statistics at rtol 1e-4 / atol
  1e-6 x their largest entry (the bounds tests/test_torch_estimate.py holds
  the window E-step to); the row gammas at rtol 1e-4 / atol 1e-4 x the
  row's span (f32 gradients through up to 2 nbits rescaled squarings);
  the row-level Viterbi is float64 on both sides: paths exactly equal;
* the window decode against the row decode on one manager, and the window
  Viterbi against the f64 row Viterbi: test_decode.py's bounds (rtol 2e-3,
  atol 1e-3; at least 99% of rows equal).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.inference import estimation as jax_est  # noqa: E402
from smcpp_tpu.inference.manager import (  # noqa: E402
    OnePopInferenceManager as JaxManager,
)
from smcpp_tpu.models import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu.ops import hmm as jhmm  # noqa: E402
from smcpp_tpu_torch.inference import manager as torch_manager  # noqa: E402
from smcpp_tpu_torch.models import SMCModel as TorchModel  # noqa: E402
from smcpp_tpu_torch.ops import hmm  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def small_hmm():
    "tests/test_decode.py's small_hmm."
    rng = np.random.RandomState(7)
    M, nK = 6, 9
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.01, 1.0, (nK, M))
    C, L = 4, 32
    spans = rng.randint(0, 9, (C, L)).astype(np.int32)
    spans[1, -7:] = 0  # ragged padding
    keys = rng.randint(0, nK, (C, L)).astype(np.int32)
    keys[spans == 0] = 0
    return pi, T, E, spans, keys


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def test_decode_gammas_matches_oracle(small_hmm):
    pi, T, E, spans, keys = small_hmm
    nbits, chunk = 5, 8
    g = hmm.decode_gammas(*_t(pi, T, E, spans, keys), nbits, chunk).numpy()
    for c in range(spans.shape[0]):
        ref = hmm.posterior_gammas(*_t(pi, T, E, spans[c], keys[c]), nbits, chunk)
        np.testing.assert_allclose(g[c], ref.numpy(), atol=1e-12)
    np.testing.assert_allclose(g.sum(axis=2), spans, atol=1e-9)
    g_j = np.asarray(jhmm.decode_gammas(*_j(pi, T, E, spans, keys), nbits, chunk))
    np.testing.assert_allclose(g, g_j, rtol=1e-10, atol=1e-12)


def test_viterbi_paths_matches_single(small_hmm):
    pi, T, E, spans, keys = small_hmm
    nbits = 5
    vb = hmm.viterbi_paths(*_t(pi, T, E, spans, keys), nbits).numpy()
    for c in range(spans.shape[0]):
        ref = hmm.viterbi_path(*_t(pi, T, E, spans[c], keys[c]), nbits)
        np.testing.assert_array_equal(vb[c], ref.numpy())
    np.testing.assert_array_equal(
        vb, np.asarray(jhmm.viterbi_paths(*_j(pi, T, E, spans, keys), nbits)))


# ---------------------------------------------------------------------------
# The managers
# ---------------------------------------------------------------------------

def _make_ims(data_list, M=5, hs=None):
    """JAX's manager (one device) and the port's (CPU) on the same rows
    and hidden states, at test_decode.py's model."""
    ims = []
    for Model, make in (
        (JaxModel, lambda hs: JaxManager(2, data_list, hs, ("pop1",), 0.5,
                                         devices=[jax.devices()[0]])),
        (TorchModel, lambda hs: torch_manager.OnePopInferenceManager(
            2, data_list, hs, ("pop1",), 0.5, device="cpu")),
    ):
        m = Model([0.01, 3.0], 20000.0, "piecewise")
        m.y[:] = 0.0
        if hs is None:
            hs = jax_est.balance_hidden_states(m, M + 1)
        im = make(hs)
        im.set_model(m)
        im.theta, im.rho, im.alpha = 1e-4, 1e-4, 1
        ims.append(im)
    return ims


def _split_rows_data(seed=3, n_rows=60):
    "test_decode.py's span-splitting rows: a few long homozygous runs."
    rng = np.random.RandomState(seed)
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 30, n_rows)
    data[5, 0] = 40000
    data[20, 0] = 35000
    data[40, 0] = 50000
    data[:, 1] = rng.randint(0, 2, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows) % (data[:, 3] + 1)
    return data


def _window_rows_data(seed, n_rows, max_span):
    rng = np.random.RandomState(seed)
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, max_span, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    return data


def _hold_stats(tim, jim):
    np.testing.assert_allclose(tim.loglik(), jim.loglik(), rtol=1e-6)
    for t, j in zip(tim._stats, jim._stats):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())


def _hold_gammas(g_t, g_j, spans):
    assert g_t.dtype == np.float32 and g_t.shape == g_j.shape
    d = np.abs(g_t.astype(np.float64) - g_j)
    err = d - 1e-4 * np.abs(g_j)
    assert np.all(err <= 1e-4 * np.asarray(spans, np.float64)[:, None])


def test_gamma_alignment_under_span_splitting(monkeypatch):
    """pack_observations splits long spans into sub-rows; the decoded
    gammas and MAP paths still line up 1:1 with the caller's rows, and
    equal JAX's manager's (which takes the span kernel here too)."""
    monkeypatch.setenv("SMCPP_TPU_DECODE_TRANSFER", "f32")
    data = _split_rows_data()
    n_rows = len(data)
    jim, im = _make_ims([data])
    assert not im._use_windows and not jim._use_windows  # the span kernel
    assert any(r.max() > 1 for r in im._row_reps)
    for x in (jim, im):
        x.save_gamma = True
        x.E_step()
    g = im.gammas[0]
    assert g.shape == (n_rows, 5)
    np.testing.assert_allclose(g.sum(axis=1), data[:, 0], rtol=1e-3)
    _hold_stats(im, jim)
    _hold_gammas(g, jim.gammas[0], data[:, 0])

    paths = im.map_paths()
    assert paths[0].shape == (n_rows,) and paths[0].dtype == np.int32
    np.testing.assert_array_equal(paths[0], jim.map_paths()[0])

    # oracle: an unsplit packing (max span large enough to avoid splitting)
    spans, keys, reps = torch_manager.pack_observations(
        [data], im.em_idx.key_id(), im._chunk, max_span=1 << 20)
    assert all(r.max() == 1 for r in reps)
    pi, T, E = im.tensors()
    nbits = max(1, int(spans.max()).bit_length())
    g_ref = hmm.decode_gammas(pi, T, E, *_t(spans, keys), nbits, im._chunk)[0, :n_rows]
    # the manager decode runs in f32; span sums reach ~5e4
    np.testing.assert_allclose(g, g_ref.numpy(), rtol=5e-3, atol=1e-5)
    p_ref = hmm.viterbi_paths(pi, T, E, *_t(spans, keys), nbits)[0, :n_rows]
    assert (paths[0] == p_ref.numpy()).mean() >= 0.99


def test_window_decode_matches_row_decode(monkeypatch):
    """The window decode and the row-level decode agree on one manager;
    the row decode (forced with the span kernel's flag) equals JAX's."""
    monkeypatch.setenv("SMCPP_TPU_DECODE_TRANSFER", "f32")
    data = _window_rows_data(21, 300, 40)
    jim, im = _make_ims([data])
    assert im._use_windows and im._window_decode_fits()
    im.save_gamma = True
    im.E_step()
    g_win = im.gammas[0]
    assert g_win.shape == (300, 5)
    np.testing.assert_allclose(g_win.sum(axis=1), data[:, 0], rtol=1e-3)

    pi, T, E = (x.float() for x in im.tensors())
    im2 = _make_ims([data], hs=im.hidden_states)[1]
    im2._use_windows = False  # route _compute_gammas to the row decode
    g_row = im2._compute_gammas(pi, T, E)[0]
    np.testing.assert_allclose(g_win, g_row, rtol=2e-3, atol=1e-3)

    jim._use_windows = False
    jpi, jT, jE = (jnp.asarray(np.asarray(x), jnp.float32) for x in jim.tensors())
    _hold_gammas(g_row, jim._compute_gammas(jpi, jT, jE)[0], data[:, 0])


def test_window_viterbi_matches_row_viterbi():
    """map_paths through the window max-plus kernels agrees with the f64
    row-level Viterbi, which equals JAX's."""
    data = _window_rows_data(41, 220, 30)
    jim, im = _make_ims([data])
    assert im._use_windows and im._window_decode_fits()
    p_win = im.map_paths()[0]
    pi, T, E = im.tensors()
    ref = hmm.viterbi_path(pi, T, E, *_t(im._spans[0], im._keys[0]), im._nbits).numpy()
    jpi, jT, jE = (jnp.asarray(np.asarray(x), jnp.float64) for x in jim.tensors())
    ref_j = np.asarray(jhmm.viterbi_path(jpi, jT, jE, np.asarray(jim._spans[0]),
                                         np.asarray(jim._keys[0]), jim._nbits))
    np.testing.assert_array_equal(ref, ref_j)
    ends = np.cumsum(im._row_reps[0]) - 1
    assert p_win.shape == (220,)
    assert (p_win == ref[ends]).mean() > 0.99


def _force_span_kernel(monkeypatch, Manager):
    orig = Manager._init_kernel_choice

    def init(self, data_list, spans):
        self._total_bases = 1e12
        return orig(self, data_list, spans)

    monkeypatch.setattr(Manager, "_init_kernel_choice", init)


def test_manager_span_estep_matches_jax(monkeypatch):
    """The span E-step (two contigs of many short rows, which the cost model
    sends to windows unless forced) against JAX's manager, and its
    row-level decode and Viterbi."""
    monkeypatch.setenv("SMCPP_TPU_DECODE_TRANSFER", "f32")
    for Manager in (JaxManager, torch_manager.OnePopInferenceManager):
        _force_span_kernel(monkeypatch, Manager)
    data_list = [_window_rows_data(8, 240, 30), _window_rows_data(9, 150, 30)]
    jim, im = _make_ims(data_list)
    assert not im._use_windows and not jim._use_windows
    for x in (jim, im):
        x.save_gamma = True
        x.E_step()
    _hold_stats(im, jim)
    for g_t, g_j, d in zip(im.gammas, jim.gammas, data_list):
        _hold_gammas(g_t, g_j, d[:, 0])
    for p_t, p_j in zip(im.map_paths(), jim.map_paths()):
        assert p_t.dtype == np.int32
        np.testing.assert_array_equal(p_t, p_j)
