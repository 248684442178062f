"""Non-finite E-step output aborts with a diagnostic dump, in the port
(``_InferenceManager._check_finite``, smcpp_tpu_torch/inference/manager.py)
as in the JAX package: tests/test_nan_surfacing.py's two tests, each run on
both packages' managers over the same data and model.

A NaN E-step raises RuntimeError("non-finite E-step output ...") and writes
one ``smcpp_tpu_torch_nan_dump_<pid>.npz`` into $SMCPP_TPU_DEBUG_DUMP with
pi, T, E, loglik and the statistics, as JAX writes its
``smcpp_tpu_nan_dump_<pid>.npz``; the dumped pi, T and E agree with JAX's
at rtol 1e-6 (JAX dumps the E-step's f32 copies, the port its f64 tensors).
A finite E-step writes nothing and gives JAX's log-likelihood at rtol 1e-6
(tests/test_torch_estimate.py's bound).
"""

import os

import jax
import numpy as np
import pytest
import torch

from smcpp_tpu_torch.inference import manager as tman
from smcpp_tpu_torch.models import SMCModel
from tests.test_parallel import _make_im, _synth_contigs


def _torch_im(data, n):
    "The port's counterpart of tests/test_parallel.py's _make_im."
    hs = np.r_[0.0, np.logspace(-1.2, 0.6, 7), np.inf]
    im = tman.OnePopInferenceManager(n, data, hs, ("p",), 0.5, device="cpu")
    m = SMCModel(np.array([0.05, 0.3, 1.5]), 1e4, "piecewise")
    m.y[:] = 0.2
    im.set_model(m)
    im.theta = 1e-4
    im.rho = 1e-4
    return im


def _ims(seed):
    rng = np.random.RandomState(seed)
    n = 4
    data = _synth_contigs(rng, n, 2, 1, 12)
    return _make_im(data, n, devices=[jax.devices()[0]]), _torch_im(data, n)


def test_estep_nan_aborts_with_dump(tmp_path, monkeypatch):
    jim, tim = _ims(21)
    M = len(tim.hidden_states) - 1
    assert tim._use_windows

    def nan_estep(*a, **k):
        return (torch.tensor(np.nan), torch.full((M,), np.nan),
                torch.zeros(M, M), torch.zeros(tim.em_idx.n_keys, M))

    monkeypatch.setattr(tman.wk, "estep_direct", nan_estep)
    jim._estep_fn = lambda *a, **k: (
        np.nan, np.full(M, np.nan), np.zeros((M, M)),
        np.zeros((jim.em_idx.n_keys, M)),
    )
    dumps = {}
    for name, im in (("jax", jim), ("torch", tim)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("SMCPP_TPU_DEBUG_DUMP", str(d))
        with pytest.raises(RuntimeError, match="non-finite E-step output"):
            im.E_step()
        dumps[name] = list(d.glob("*.npz"))
    assert [p.name for p in dumps["torch"]] == [
        f"smcpp_tpu_torch_nan_dump_{os.getpid()}.npz"]
    assert len(dumps["jax"]) == 1 and dumps["jax"][0].name.startswith(
        "smcpp_tpu_nan_dump_")
    zt, zj = np.load(dumps["torch"][0]), np.load(dumps["jax"][0])
    assert set(zt.files) >= {"pi", "T", "E", "loglik", "gamma0"}
    assert set(zt.files) == set(zj.files)
    assert np.isnan(float(zt["loglik"])) and np.isnan(float(zj["loglik"]))
    assert np.all(np.isnan(zt["gamma0"]))
    for k in ("pi", "T", "E"):
        assert zt[k].shape == zj[k].shape
        np.testing.assert_allclose(zt[k], zj[k], rtol=1e-6)


def test_estep_finite_passes(tmp_path, monkeypatch):
    monkeypatch.setenv("SMCPP_TPU_DEBUG_DUMP", str(tmp_path))
    jim, tim = _ims(22)
    ll = tim.E_step()
    assert np.isfinite(ll)
    np.testing.assert_allclose(ll, jim.E_step(), rtol=1e-6)
    assert not list(tmp_path.glob("*.npz"))
