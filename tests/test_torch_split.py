"""The port's ``split`` and two-population ``posterior`` against the JAX
package, end to end on the CPU.

The data are simulated with the port's ``write_simulated_joint`` (equal row
for row to the JAX package's on the same seed, tests/test_torch_twopop.py)
into ``tmp_path``: two joint contigs of 1 Mbp (n1 = n2 = 4) and one pop-2
marginal contig from the truth's splice, with the true marginal fits
written as the JSON that ``split`` reads.

* ``SplitAnalysis``: the port's split equals JAX's on the same files within
  rtol 1e-3 (both search the same float64 objective; measured 1e-12), and
  so does the log-likelihood at the found split;
* the ``split`` CLI writes a ``model.final.json`` of class
  ``SMCTwoPopulationModel``;
* ``posterior --device cpu --M 8 --map --intervals`` on a joint contig
  against the JAX CLI's npz, at the bounds tests/test_torch_posterior.py
  holds the one-population npz to: hidden states at rtol 1e-12, sites
  exactly, normalized gammas at rtol 1e-4 / atol 1e-5, MAP states on 99.9%
  of rows, quantiles at rtol 1e-4 / atol 1e-6;
* a port of tests/test_split_recovery.py: the split of a simulated dataset
  within +-25% of the truth (under 30 s on the CPU, so not marked slow);
* ``--device cuda`` with no card raises in ``split`` and ``posterior``.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from smcpp_tpu.commands import main as jax_main  # noqa: E402
from smcpp_tpu.inference.split import SplitAnalysis as JaxSplit  # noqa: E402
from smcpp_tpu_torch.commands import main as torch_main  # noqa: E402
from smcpp_tpu_torch.data.simulate import write_simulated, write_simulated_joint  # noqa: E402
from smcpp_tpu_torch.inference.manager import TwoPopInferenceManager  # noqa: E402
from smcpp_tpu_torch.inference.split import SplitAnalysis as TorchSplit  # noqa: E402
from smcpp_tpu_torch.models import SMCModel, SMCTwoPopulationModel  # noqa: E402

KNOTS = np.array([0.05, 0.2, 0.8, 3.0])


def _truth(split=0.4):
    m1 = SMCModel(KNOTS, 2e4, "piecewise", "pop1")
    m1.y[:] = np.log(1.0)
    m2 = SMCModel(KNOTS, 2e4, "piecewise", "pop2")
    m2.y[:] = np.log(0.7)
    return SMCTwoPopulationModel(m1, m2, split)


def _write_fits(d, joint, theta, rho):
    "The true marginal fits, as the split command reads them."
    paths = []
    for m, name in [(joint.model1, "p1"), (joint.model2, "p2")]:
        p = os.path.join(d, f"{name}.json")
        with open(p, "w") as f:
            json.dump({"theta": theta, "rho": rho, "alpha": 1,
                       "model": m.to_dict(), "hidden_states": {m.pid: [0.0]}}, f)
        paths.append(p)
    return paths


def _args(out, pop1, pop2, mu, **kw):
    d = dict(
        mu=mu, r=None, em_iterations=1, knots=4, spline="piecewise",
        polarization_error=0.5, unfold=False, w=100, thinning=None,
        timepoints=None, outdir=out, base="model", algorithm="L-BFGS-B",
        xtol=0.1, ftol=1e-4, regularization_penalty=6, lambda_=None,
        nonseg_cutoff=None, multi=False, cores=None, seed=0, precision=None,
        pop1=pop1, pop2=pop2,
    )
    d.update(kw)
    os.makedirs(out, exist_ok=True)
    return argparse.Namespace(**d)


@pytest.fixture(scope="module")
def joint_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("split"))
    joint = _truth()
    theta = rho = 1e-3
    files = []
    for i in range(2):
        fn = os.path.join(d, f"j{i}.smc.gz")
        write_simulated_joint(fn, joint, theta, rho, L=1_000_000, n1=4, n2=4,
                              seed=i)
        files.append(fn)
    fn = os.path.join(d, "m2.smc.gz")
    write_simulated(fn, joint.for_pop("pop2"), theta, rho, L=1_000_000, n=4,
                    seed=5, pid="pop2")
    files.append(fn)
    return d, files, _write_fits(d, joint, theta, rho), theta


@pytest.fixture(scope="module")
def split_runs(joint_data):
    d, files, (p1, p2), theta = joint_data
    out = {}
    for name, SA, kw in (("jax", JaxSplit, {}), ("torch", TorchSplit, {"device": "cpu"})):
        np.random.seed(0)
        sa = SA(files, _args(os.path.join(d, f"out_{name}"), p1, p2,
                             theta / (2 * 2e4), **kw))
        sa.run(1)
        out[name] = sa
    return out


def test_split_matches_jax(split_runs):
    ja, ta = split_runs["jax"], split_runs["torch"]
    assert sorted(ta._ims) == sorted(ja._ims) == [("pop1", "pop2"), ("pop2",)]
    assert isinstance(ta._ims[("pop1", "pop2")], TwoPopInferenceManager)
    assert ta.has_split_batch
    np.testing.assert_allclose(ta.model.split, ja.model.split, rtol=1e-3)
    np.testing.assert_allclose(ta.loglik(), ja.loglik(), rtol=1e-3)
    assert 0.0 < ta.model.split < ta._max_split
    # each part's value and derivative at the found split, against JAX's
    for (_, jo), (_, to) in zip(*(sorted(
            (type(o).__name__, o) for o in a._split_parts()[1]) for a in (ja, ta))):
        np.testing.assert_allclose(to.q_and_grad(ta.model.split),
                                   jo.q_and_grad(ta.model.split), rtol=1e-7)


def test_split_cli_writes_joint_model(joint_data, tmp_path):
    d, files, (p1, p2), _ = joint_data
    out = str(tmp_path / "cli")
    sa = torch_main.main(["split", "--device", "cpu", "-o", out, p1, p2, *files])
    with open(os.path.join(out, "model.final.json")) as f:
        j = json.load(f)
    assert j["model"]["class"] == "SMCTwoPopulationModel"
    assert j["model"]["split"] == pytest.approx(sa.model.split, rel=1e-12)
    assert np.isfinite(j["model"]["split"]) and j["theta"] > 0



def test_split_cli_profile_dir(joint_data, tmp_path):
    """split --profile-dir writes a Chrome trace of the run, as estimate's,
    with the program's spans: the split search's M-step and the joint
    tensors()."""
    d, files, (p1, p2), _ = joint_data
    prof = tmp_path / "prof"
    torch_main.main(["split", "--device", "cpu", "--profile-dir", str(prof),
                     "-o", str(tmp_path / "cli"), p1, p2, *files])
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("name", "").startswith("aten::")
               for e in events)
    spans = [e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "smcpp"]
    assert any(n.startswith("mstep.") for n in spans)
    assert "tensors2" in spans
    assert any(n.startswith("estep.") for n in spans)


@pytest.mark.parametrize("command", ["split", "posterior"])
def test_cuda_requested_without_a_card_raises(command, joint_data, tmp_path,
                                               monkeypatch):
    """``--device cuda`` with no card raises in both two-population commands;
    nothing carries on on the CPU."""
    d, files, (p1, p2), _ = joint_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if command == "split":
        argv = ["split", "--device", "cuda", "-o", str(tmp_path), p1, p2, *files]
    else:
        model = str(tmp_path / "model.json")
        with open(model, "w") as f:
            json.dump({"model": _truth().to_dict(), "theta": 1e-3, "rho": 1e-3,
                       "alpha": 1}, f)
        argv = ["posterior", "--device", "cuda", "--M", "4", model,
                str(tmp_path / "p.npz"), files[0]]
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main.main(argv)
    assert not os.path.exists(tmp_path / "model.final.json")
    assert not os.path.exists(tmp_path / "p.npz")

@pytest.fixture(scope="module")
def posterior_runs(tmp_path_factory):
    """One joint contig the cost model sends to windows; JAX's posterior and
    the port's (--device cpu), same arguments."""
    d = tmp_path_factory.mktemp("post2")
    joint = _truth(0.25)
    data = str(d / "joint.smc.gz")
    write_simulated_joint(data, joint, 2e-3, 2e-4, L=50_000, n1=4, n2=3, seed=3)
    model = str(d / "model.final.json")
    with open(model, "w") as f:
        json.dump({"model": joint.to_dict(), "theta": 2e-3, "rho": 2e-4,
                   "alpha": 1}, f)
    args = ["posterior", "--M", "8", "--map", "--intervals",
            "0.025,0.5,0.975", model]
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("SMCPP_TPU_DECODE_TRANSFER", "f32")
        mp.setenv("SMCPP_TPU_DEVICES", "1")  # one device, as the port runs
        jax_main.main(args + [str(d / "jax.npz"), data])
    finally:
        mp.undo()
    im = torch_main.main(args[:1] + ["--device", "cpu"] + args[1:] +
                         [str(d / "torch.npz"), data])
    return np.load(d / "jax.npz"), np.load(d / "torch.npz"), data, im


def test_cli_twopop_posterior_matches_jax(posterior_runs):
    zj, zt, data, im = posterior_runs
    assert isinstance(im, TwoPopInferenceManager) and im._use_windows
    assert sorted(zt.files) == sorted(zj.files) == sorted(
        ["hidden_states", data, data + "_sites", data + "_map",
         data + "_quantiles"]
    )
    np.testing.assert_allclose(zt["hidden_states"], zj["hidden_states"], rtol=1e-12)
    np.testing.assert_array_equal(zt[data + "_sites"], zj[data + "_sites"])
    g = zt[data]
    assert g.shape == (8, len(zt[data + "_sites"]))
    np.testing.assert_allclose(g.sum(0), 1.0, rtol=1e-5)
    np.testing.assert_allclose(g, zj[data], rtol=1e-4, atol=1e-5)
    assert (zt[data + "_map"] == zj[data + "_map"]).mean() >= 0.999
    q = zt[data + "_quantiles"]
    assert np.all(np.diff(q, axis=0) >= 0)
    np.testing.assert_allclose(q, zj[data + "_quantiles"], rtol=1e-4, atol=1e-6)


def test_split_recovery(tmp_path):
    """tests/test_split_recovery.py on the port: two 3 Mbp joint contigs
    simulated under a known split; the split search recovers it within
    +-25%."""
    joint = _truth(0.4)
    theta = rho = 1e-4
    files = []
    for i in range(2):
        fn = str(tmp_path / f"j{i}.smc.gz")
        write_simulated_joint(fn, joint, theta, rho, L=3_000_000, n1=4, n2=4,
                              seed=i)
        files.append(fn)
    p1, p2 = _write_fits(str(tmp_path), joint, theta, rho)
    np.random.seed(0)
    sa = TorchSplit(files, _args(str(tmp_path / "out"), p1, p2,
                                 theta / (2 * 2e4), device="cpu"))
    sa.run(1)
    got = sa.model.split
    assert 0.75 * 0.4 < got < 1.25 * 0.4, got
    # the search must have used the batched split objective
    assert sa.has_split_batch
