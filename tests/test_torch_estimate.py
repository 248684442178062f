"""The port's one-population ``estimate`` against the JAX package, end to end
on the CPU.

A small two-contig dataset is simulated with the JAX package's
``write_simulated`` (n = 6, sized so the manager's cost model picks the
window kernel), and both packages' ``Analysis`` run with the same arguments
and the same global NumPy seed: stage 1, then one stage-2 EM iteration.

Bounds and why:

* stage 1 is float64 on both sides (closed-form E-step, f64 Q): the fitted
  y agrees at 1e-8;
* stage 2 runs the f32 window E-step.  Both sides compute the same f32
  recursions, with the bf16 carry rounding at the same points at
  'default', but sum in another order: the statistics agree to about 1e-7
  relative.  The EM iteration's grid searches and parabola vertices move
  with Q, so the knot values are held at 1e-4 (measured 1.3e-6), rho at
  1e-5 relative and the log-likelihood at 1e-7 relative (measured 3e-9).
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from smcpp_tpu.data.simulate import write_simulated  # noqa: E402
from smcpp_tpu.inference import analysis as jax_analysis  # noqa: E402
from smcpp_tpu.models.model import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu_torch.commands import main as torch_main  # noqa: E402
from smcpp_tpu_torch.inference import analysis as torch_analysis  # noqa: E402
from smcpp_tpu_torch.inference import manager as torch_manager  # noqa: E402


@pytest.fixture(scope="module")
def smc_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    m = JaxModel([0.01, 0.1, 1.0, 5.0], 1e4, "piecewise")
    m.y[:] = np.log([1.0, 0.3, 1.0, 2.0])
    files = []
    for i in range(2):
        fn = str(d / f"sim{i}.smc.gz")
        write_simulated(fn, m, 2e-4, 2e-4, L=2_000_000, n=6, seed=i)
        files.append(fn)
    return files


def _args(**kw):
    d = dict(
        mu=1.25e-8, r=None, em_iterations=1, knots=8, spline="piecewise",
        polarization_error=0.5, unfold=False, w=100, thinning=None,
        timepoints=None, outdir=None, base="model", algorithm="L-BFGS-B",
        xtol=0.1, ftol=1e-4, regularization_penalty=6, lambda_=None,
        nonseg_cutoff=None, multi=False, cores=None, seed=0, device="cpu",
        precision=None,
    )
    d.update(kw)
    return argparse.Namespace(**d)


def _run(mod, files, monkeypatch, **kw):
    """Analysis + one EM iteration; returns (analysis, stage-1 y)."""
    stage1 = []
    orig = mod.Analysis._init_model

    def record(self, spline_class):
        if hasattr(self, "_model"):  # the stage-2 model replaces stage 1's
            stage1.append(self._model.y.copy())
        orig(self, spline_class)

    monkeypatch.setattr(mod.Analysis, "_init_model", record)
    np.random.seed(0)
    a = mod.Analysis(files, _args(**kw))
    a.run(1)
    monkeypatch.setattr(mod.Analysis, "_init_model", orig)
    return a, stage1[0]


@pytest.fixture(scope="module")
def runs(smc_files):
    mp = pytest.MonkeyPatch()
    try:
        return {
            prec: (
                _run(jax_analysis, smc_files, mp, precision=prec),
                _run(torch_analysis, smc_files, mp, precision=prec),
            )
            for prec in ("highest", "default")
        }
    finally:
        mp.undo()


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_estimate_matches_jax(runs, precision):
    (ja, jy1), (ta, ty1) = runs[precision]
    np.testing.assert_allclose(ty1, jy1, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(ta.hidden_states, ja.hidden_states, rtol=1e-10)
    assert len(ta.hidden_states) == 18  # empirical TMRCA: M = 2 * knots + 1
    np.testing.assert_allclose(ta.model.y, ja.model.y, atol=1e-4)
    np.testing.assert_allclose(ta.rho, ja.rho, rtol=1e-5)
    np.testing.assert_allclose(ta.loglik(), ja.loglik(), rtol=1e-7)


def test_window_kernel_selected(runs):
    (_, _), (ta, _) = runs["highest"]
    (im,) = ta._ims.values()
    assert im._use_windows and im._wkeys.shape[1] % 8 == 0


def test_balanced_fallback_matches_jax(smc_files, monkeypatch):
    """Without scikit-learn both packages fall back to balanced hidden
    states: 2 * knots = 16 boundaries, M = 15 intervals.  The stage-2 setup
    and its first E-step agree."""
    monkeypatch.setitem(sys.modules, "sklearn.mixture", None)
    np.random.seed(0)
    ja = jax_analysis.Analysis(smc_files, _args(precision="highest"))
    np.random.seed(0)
    ta = torch_analysis.Analysis(smc_files, _args(precision="highest"))
    assert ta.hidden_state_path == "balanced"
    assert len(ta.hidden_states) == len(ja.hidden_states) == 16
    np.testing.assert_allclose(ta.hidden_states, ja.hidden_states, rtol=1e-10)
    np.testing.assert_allclose(ta.model.y, ja.model.y, rtol=1e-8)
    np.testing.assert_allclose(ta.loglik(), ja.loglik(), rtol=1e-6)
    (jim,) = ja._ims.values()
    (tim,) = ta._ims.values()
    for j, t in zip(jim._stats, tim._stats):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())


def test_span_kernel_choice_runs_and_matches_jax(smc_files, monkeypatch):
    """When the cost model picks the span kernel (forced on both sides) the
    port runs it (ops/hmm.py; it raised before the span kernel was ported):
    the stage-2 set-up's E-step agrees with JAX's, at the window E-step's
    bounds above (both f32, summed in another order)."""
    for Manager in (jax_analysis.OnePopInferenceManager,
                    torch_manager.OnePopInferenceManager):
        orig = Manager._init_kernel_choice

        def init(self, data_list, spans, orig=orig):
            self._total_bases = 1e12
            return orig(self, data_list, spans)

        monkeypatch.setattr(Manager, "_init_kernel_choice", init)
    np.random.seed(0)
    ja = jax_analysis.Analysis(smc_files, _args(precision="highest"))
    np.random.seed(0)
    ta = torch_analysis.Analysis(smc_files, _args(precision="highest"))
    (jim,) = ja._ims.values()
    (tim,) = ta._ims.values()
    assert not tim._use_windows and not jim._use_windows
    np.testing.assert_allclose(ta.hidden_states, ja.hidden_states, rtol=1e-10)
    np.testing.assert_allclose(ta.model.y, ja.model.y, rtol=1e-8)
    np.testing.assert_allclose(ta.loglik(), ja.loglik(), rtol=1e-6)
    for j, t in zip(jim._stats, tim._stats):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())


def test_cli_estimate_cpu(smc_files, tmp_path):
    out = tmp_path / "out"
    torch_main.main([
        "estimate", "--device", "cpu", "--em-iterations", "1",
        "-o", str(out), "1.25e-8", *smc_files,
    ])
    with open(out / "model.final.json") as f:
        d = json.load(f)
    assert d["model"]["class"] == "SMCModel"
    assert np.all(np.isfinite(d["model"]["y"]))
    assert np.isfinite(d["rho"]) and d["rho"] > 0
    assert os.path.exists(out / ".debug.txt")


def test_cuda_requested_without_a_card_raises(smc_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_analysis.Analysis(smc_files, _args(device="cuda"))


def test_cli_estimate_profile_dir(smc_files, tmp_path):
    """--profile-dir (the JAX CLI's flag) is accepted and writes a Chrome
    trace of the run: torch.profiler's, not jax.profiler's, with the
    program's M-step and Q spans in it."""
    out, prof = tmp_path / "out", tmp_path / "prof"
    torch_main.main([
        "estimate", "--device", "cpu", "--em-iterations", "1",
        "--profile-dir", str(prof), "-o", str(out), "1.25e-8", *smc_files,
    ])
    assert os.path.exists(out / "model.final.json")
    path = prof / "trace.json"
    assert path.stat().st_size > 0
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("name", "").startswith("aten::")
               for e in events)
    # the program's spans (smcpp_tpu_torch/trace.py) beside the profiler's
    spans = [e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "smcpp"]
    assert any(n.startswith("mstep.") for n in spans)
    assert any(n.startswith("q.") for n in spans)
