"""Multi-process execution of the port (smcpp_tpu_torch/parallel/) on the CPU:
gloo groups of OS processes, formed by distributed.initialize or by the CLI's
--coordinator / --num-processes / --process-id (the cases of
tests/test_distributed.py, on the port's own simulated data in place of the
example VCF).  Every case is held against the port's one-process run and
against JAX's, both run in this process on the same inputs (the CLI cases
through each package's CLI, JAX's on one device).

* the two-process window E-step, each rank holding only its block of the
  segment rows, against the one-process E-step and JAX's;
* ``estimate`` through the CLI, host-local (one file: rank 1's shard is
  empty; two files: one each) and with --replicated-data: every rank writes
  the same model.final.json byte for byte, and y lies within rtol 1e-4 /
  atol 1e-6 of the one-process fit (tests/test_distributed.py's bound) and
  within tests/test_torch_estimate.py's bounds of JAX's (see _check_fit for
  the two-file case).  With two equal contigs both modes give every rank
  the same segments, so their fits are byte-identical too; with one file
  the modes place the segments apart and agree to the bound;
* host-local ``split`` and ``posterior`` (one and two populations), and the
  replicated ``posterior``: the split at rtol 1e-6 of the one process's and
  1e-3 of JAX's; each npz's gammas at rtol 1e-4 / atol 2e-5
  (tests/test_distributed.py's atol) of both, MAP states equal to the one
  process's and on 99.9% of the rows to JAX's;
* the fingerprint guard, a 4-rank dry run of the manager (against the
  port's and JAX's managers), and the misconfigurations that must raise.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from smcpp_tpu.commands import main as jax_main
from smcpp_tpu_torch.commands import main as torch_main
from smcpp_tpu_torch.data.simulate import write_simulated, write_simulated_joint
from smcpp_tpu_torch.models import SMCModel, SMCTwoPopulationModel
from smcpp_tpu_torch.ops import window_kernel as twk
from smcpp_tpu_torch.parallel import distributed

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dist_worker as W  # noqa: E402

sys.path.remove(HERE)

KNOTS = np.array([0.05, 0.2, 0.8, 3.0])
THETA = 1e-3


def _truth():
    m1 = SMCModel(KNOTS, 2e4, "piecewise", "pop1")
    m1.y[:] = 0.0
    m2 = SMCModel(KNOTS, 2e4, "piecewise", "pop2")
    m2.y[:] = np.log(0.7)
    return SMCTwoPopulationModel(m1, m2, 0.4)


def _fit_json(path, model):
    with open(path, "w") as f:
        json.dump({"theta": THETA, "rho": THETA, "alpha": 1,
                   "model": model.to_dict(),
                   "hidden_states": {model.pid if hasattr(model, "pid") else "x": [0.0]}},
                  f)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    "Two one-population contigs of equal length, two joint contigs, the fits."
    d = tmp_path_factory.mktemp("dist")
    truth = _truth()
    one = [str(d / f"c{i}.smc.gz") for i in range(2)]
    for i, fn in enumerate(one):
        write_simulated(fn, truth.model1, THETA, THETA, L=200_000, n=4, seed=i)
    joint = [str(d / f"j{i}.smc.gz") for i in range(2)]
    for i, fn in enumerate(joint):
        write_simulated_joint(fn, truth, THETA, THETA, L=200_000, n1=4, n2=4,
                              seed=10 + i)
    return types.SimpleNamespace(
        d=d, one=one, joint=joint,
        fit1=_fit_json(d / "p1.json", truth.model1),
        fit2=_fit_json(d / "p2.json", truth.model2),
        fitj=_fit_json(d / "joint.json", truth),
    )


class _OneProcess:
    """The one-process oracles, each run once for the module in this
    process: the port's CLI (``--device cpu``) and the JAX package's CLI
    (one device, as the port runs; f32 decode transfer, as
    tests/test_torch_posterior.py runs it) on the same files."""

    def __init__(self, d):
        self.d, self._done = d, {}

    def _run(self, key, main, argv, env=()):
        if key not in self._done:
            mp = pytest.MonkeyPatch()
            try:
                for k, v in env:
                    mp.setenv(k, v)
                main(argv)
            finally:
                mp.undo()
            self._done[key] = True

    def out(self, which, tag):
        return str(self.d / f"{which}-{tag}")

    def run(self, which, tag, argv, output=None):
        """``argv`` (the subcommand first) through ``which`` ('torch' or
        'jax'), with ``output`` (a file or directory, named by ``tag``) where
        ``argv`` holds None; returns the output's path."""
        out = self.out(which, tag) + (output or "")
        argv = [out if a is None else a for a in argv]
        if which == "torch":
            self._run((which, tag), torch_main.main, [argv[0], "--device", "cpu",
                                                      *argv[1:]])
        else:
            self._run((which, tag), jax_main.main, argv,
                      [("SMCPP_TPU_DEVICES", "1"),
                       ("SMCPP_TPU_DECODE_TRANSFER", "f32")])
        return out


@pytest.fixture(scope="module")
def one(data):
    return _OneProcess(data.d)


def _model(outdir):
    with open(os.path.join(outdir, "model.final.json"), "rb") as f:
        return f.read()


def _y(raw):
    return np.asarray(json.loads(raw)["model"]["y"], float)


ESTIMATE = ["estimate", "--device", "cpu", "--em-iterations", "1", "--knots",
            "4", "--seed", "0"]


def _estimate_ranks(tmp_path, tag, files, *extra):
    logs = W.cli_ranks(lambda r: [*ESTIMATE, "-o", str(tmp_path / f"{tag}{r}"),
                                  *extra, "1.25e-8", *files], 2)
    fits = [_model(tmp_path / f"{tag}{r}") for r in range(2)]
    assert fits[0] == fits[1], "the ranks wrote different fits"
    return fits[0], logs


def _check_fit(fit, one, files, stage2_vs_jax=True):
    """A multi-rank fit against the one-process fits of ``files``: the
    port's at tests/test_distributed.py's bound (y rtol 1e-4 / atol 1e-6);
    JAX's at tests/test_torch_estimate.py's (theta and the stage-2 hidden
    states, which stage 1 decides, rtol 1e-10; y atol 1e-4 and rho rtol 1e-5
    after the stage-2 iteration).

    ``stage2_vs_jax`` False holds only theta and the hidden states to JAX:
    the last point of the model's s-grid ties the last knot, and which of
    the two last knot values it takes turns on the last bits of the hidden
    states (ROADMAP C), which the port's and JAX's stage-1 fits put 1e-13
    apart."""
    tag = f"estimate{len(files)}"
    argv = [*ESTIMATE[:1], *ESTIMATE[3:], "-o", None, "1.25e-8", *files]
    single = _model(one.run("torch", tag, argv))
    np.testing.assert_allclose(_y(fit), _y(single), rtol=1e-4, atol=1e-6)
    got, jx = json.loads(fit), json.loads(_model(one.run("jax", tag, argv)))
    np.testing.assert_allclose(got["hidden_states"]["pop1"],
                               jx["hidden_states"]["pop1"], rtol=1e-10)
    np.testing.assert_allclose(got["theta"], jx["theta"], rtol=1e-10)
    if stage2_vs_jax:
        np.testing.assert_allclose(_y(fit), np.asarray(jx["model"]["y"]), atol=1e-4)
        np.testing.assert_allclose(got["rho"], jx["rho"], rtol=1e-5)


def test_two_process_window_estep(tmp_path):
    """Each rank holds only its half of the segment rows; the E-step on the
    group equals the one-process E-step and JAX's (f64: ll rtol 1e-10,
    statistics rtol 1e-8)."""
    import jax
    import jax.numpy as jnp

    from smcpp_tpu.ops import window_kernel as jwk

    jax.config.update("jax_enable_x64", True)
    ranks = W.launch("window_estep", 2, tmp_path)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k])
    z = ranks[0]
    pi, T, E, kk, vv, soc, _ = W.window_problem(2)
    assert int(z["n_local"]) * 2 == -(-kk.shape[0] // 2) * 2
    one = twk.estep_direct(*W._t(pi, T, E, dtype=torch.float64), *W._t(kk, vv), soc)
    jx = jwk.estep_windows(jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
                           jnp.asarray(kk), jnp.asarray(vv), soc)
    for ref in ([x.numpy() for x in one], [np.asarray(x) for x in jx]):
        assert np.isclose(float(z["ll"]), float(ref[0]), rtol=1e-10, atol=0)
        for k, r in zip(("gamma0", "xisum", "gamma_sums"), ref[1:]):
            np.testing.assert_allclose(z[k], r, rtol=1e-8)


def test_two_process_estimate_cli(data, one, tmp_path):
    """One input file: host-local ingestion leaves rank 1 with no contig (its
    E-step blocks hold one all-invalid segment) and every collective still
    lines up; --replicated-data splits the contig's segments over the
    ranks."""
    hl, logs = _estimate_ranks(tmp_path, "hl", data.one[:1])
    assert "host-local ingestion: process 1/2 loads 0 of 1 files" in logs[1]
    rep, logs = _estimate_ranks(tmp_path, "rep", data.one[:1], "--replicated-data")
    assert all("host-local ingestion" not in log for log in logs)
    for fit in (hl, rep):
        _check_fit(fit, one, data.one[:1])
    np.testing.assert_allclose(_y(hl), _y(rep), rtol=1e-4, atol=1e-6)


def test_two_process_hostlocal_estimate_cli(data, one, tmp_path):
    """Two files, one a rank: each rank loads and packs only its own (the log
    says so), and the fit equals --replicated-data's byte for byte (the same
    segments on each rank either way) and the one-process fits to the
    bounds."""
    hl, logs = _estimate_ranks(tmp_path, "hl", data.one)
    for r, log in enumerate(logs):
        assert f"host-local ingestion: process {r}/2 loads 1 of 2 files" in log
        assert f"host-local window packing: process {r}/2 packed 1 contigs" in log
    rep, _ = _estimate_ranks(tmp_path, "rep", data.one, "--replicated-data")
    assert hl == rep
    _check_fit(hl, one, data.one, stage2_vs_jax=False)


def test_torchrun_estimate_cli(data, one, tmp_path):
    """Launched by torchrun, whose environment (WORLD_SIZE, RANK, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) forms the group with no flag: the host-local
    fit of the two files, as with --coordinator."""
    out = tmp_path / "trun"
    logs = W.run_on_port(lambda port: [[
        sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
        "--master-port", str(port), "-m", "smcpp_tpu_torch.commands.main",
        *ESTIMATE, "-o", str(out), "1.25e-8", *data.one]])
    for r in range(2):
        assert f"process group initialized: rank {r} / 2 on cpu" in logs[0]
    _check_fit(_model(out), one, data.one, stage2_vs_jax=False)


def test_two_process_hostlocal_split_cli(data, one, tmp_path):
    """The split on two joint files, one a rank: the M = 1 E-step needs only
    the key counts summed over the ranks, so the split matches the one
    process's (rtol 1e-6) and JAX's (tests/test_torch_split.py's rtol
    1e-3)."""
    argv = ["split", "--device", "cpu", data.fit1, data.fit2, *data.joint]
    logs = W.cli_ranks(lambda r: [*argv, "-o", str(tmp_path / f"sp{r}")], 2)
    for r, log in enumerate(logs):
        assert f"host-local ingestion: process {r}/2 loads 1 of 2 files" in log
    s0, s1 = (json.loads(_model(tmp_path / d))["model"]["split"]
              for d in ("sp0", "sp1"))
    assert s0 == s1
    ref = ["split", "-o", None, *argv[3:]]
    ss, sj = (json.loads(_model(one.run(w, "split", ref)))["model"]["split"]
              for w in ("torch", "jax"))
    np.testing.assert_allclose(s0, ss, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(s0, sj, rtol=1e-3)


# Row gammas (normalized, f32) against JAX's one-process npz: XLA sums the
# f32 prefix sums in another order and the ranks cut the blocks at other
# offsets, each an error of an f32 ulp of the running block prefix, the
# mechanism tests/test_distributed.py bounds at atol 2e-5 (on these rows the
# one-process port is 1.6e-5 past JAX's rtol 1e-4; tests/test_torch_posterior
# .py's atol 1e-5 is for its shorter rows and M = 16).
JAX_GAMMA_ATOL = 2e-5


def _check_npz(z, fns, one, tag, model, files, extra):
    """The npz of a multi-rank posterior (``fns``, a subset of ``files``)
    against the one-process runs on ``files``: the port's at gammas rtol
    1e-4 / atol 2e-5 (tests/test_distributed.py: the f32 prefix sums carry
    an error of an f32 ulp of the running sum within a block, whose
    boundaries differ between one process and a rank's block) with MAP
    states equal; JAX's with hidden states at rtol 1e-12, sites equal,
    gammas at rtol 1e-4 / JAX_GAMMA_ATOL and MAP states on 99.9% of the
    rows (tests/test_torch_posterior.py)."""
    argv = ["posterior", "--M", "8", *extra, model, None, *files]
    ref = np.load(one.run("torch", tag, argv, ".npz"))
    jx = np.load(one.run("jax", tag, argv, ".npz"))
    np.testing.assert_allclose(z["hidden_states"], jx["hidden_states"], rtol=1e-12)
    for fn in fns:
        np.testing.assert_allclose(z[fn], ref[fn], rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(z[fn], jx[fn], rtol=1e-4, atol=JAX_GAMMA_ATOL)
        for r in (ref, jx):
            np.testing.assert_array_equal(z[fn + "_sites"], r[fn + "_sites"])
        if "--map" in extra:
            np.testing.assert_array_equal(z[fn + "_map"], ref[fn + "_map"])
            assert np.mean(z[fn + "_map"] == jx[fn + "_map"]) >= 0.999


def _posterior_ranks(tmp_path, one, tag, model, files, extra=()):
    argv = ["posterior", "--device", "cpu", "--M", "8", *extra, model]
    logs = W.cli_ranks(lambda r: [*argv, str(tmp_path / "post.npz"), *files], 2)
    for r, fn in enumerate(files):
        assert f"host-local posterior: process {r}/2 decodes 1 of 2" in logs[r]
        z = np.load(str(tmp_path / f"post.proc{r}.npz"))
        if "--map" in extra:
            assert set(z.files) == {"hidden_states", fn, fn + "_sites", fn + "_map"}
        _check_npz(z, [fn], one, tag, model, files, extra)


def test_two_process_hostlocal_posterior_cli(data, one, tmp_path):
    """Each rank decodes its own file through the window decode reduced over
    the group and writes <output>.procI.npz."""
    _posterior_ranks(tmp_path, one, "post1", data.fit1, data.one, ["--map"])


@pytest.mark.parametrize("pops", ["one", "two"])
def test_two_process_replicated_posterior_cli(data, one, tmp_path, pops):
    """--replicated-data: every rank loads both files, the decode and the
    Viterbi shard the segment rows over the ranks (rows straddle their
    blocks), and rank 0 writes <output>, the one process's decode."""
    model, files = (data.fit1, data.one) if pops == "one" else (data.fitj, data.joint)
    argv = ["posterior", "--device", "cpu", "--M", "8", "--map", model]
    W.cli_ranks(lambda r: [*argv, "--replicated-data", str(tmp_path / "post.npz"),
                           *files], 2)
    assert not any(p.name.startswith("post.proc") for p in tmp_path.iterdir())
    z = np.load(str(tmp_path / "post.npz"))
    tag = "post1" if pops == "one" else "post2map"
    ref = np.load(one.run("torch", tag, ["posterior", "--M", "8", "--map", model,
                                         None, *files], ".npz"))
    assert set(z.files) == set(ref.files)
    _check_npz(z, files, one, tag, model, files, ["--map"])


def test_fingerprint_guard_catches_dtype_mismatch(tmp_path):
    "Ranks contributing different dtypes fail loudly, on every rank."
    for r in W.launch("fingerprint", 2, tmp_path):
        assert int(r["caught"]) == 1


def test_two_process_hostlocal_twopop_posterior_cli(data, one, tmp_path):
    "The two-population manager decodes host-local joint data too."
    _posterior_ranks(tmp_path, one, "post2", data.fitj, data.joint)


def test_four_rank_dryrun(tmp_path):
    """A dry run of the multi-rank path on four ranks: one sharded E-step
    through the manager, then Q_and_grad, the same on every rank; against
    the port's manager in one process (ll rtol 1e-6, statistics rtol 1e-4 /
    atol 1e-5, tests/test_torch_parallel.py's manager bounds) and JAX's
    manager on one device (the same bounds; Q and its gradient from the
    E-step's f32 statistics at rtol 1e-5)."""
    import jax

    from smcpp_tpu.inference.manager import OnePopInferenceManager
    from smcpp_tpu.models import SMCModel as JaxModel

    ranks = W.launch("dryrun", 4, tmp_path)
    for r in ranks[1:]:
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k])
    z = ranks[0]
    n, d = W.manager_data((1, 12))
    im = W.make_manager(d, n)
    assert int(z["n_local"]) * 4 == -(-im._wkeys.shape[0] // 4) * 4
    jim = OnePopInferenceManager(n, d, W.HS, ("p",), 0.5, devices=jax.devices()[:1])
    m = JaxModel(np.array([0.05, 0.3, 1.5]), 1e4, "piecewise")
    m.y[:] = 0.2
    jim.set_model(m)
    jim.theta = jim.rho = 1e-4
    for mgr in (im, jim):
        assert np.isclose(float(z["ll"]), float(mgr.E_step()), rtol=1e-6)
        np.testing.assert_allclose(z["xisum"], np.asarray(mgr._stats[1]),
                                   rtol=1e-4, atol=1e-5)
    q, g = jim.Q_and_grad()
    assert np.isclose(float(z["q"]), float(q), rtol=1e-5)
    np.testing.assert_allclose(z["grad"], np.asarray(g), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("argv,env,match", [
    (["--num-processes", "2"], {}, "coordinator"),
    (["--process-id", "1"], {}, "coordinator"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2"], {}, "process-id"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "2"],
     {}, "outside"),
    ([], {"WORLD_SIZE": "2"}, "torchrun"),
], ids=["no-coordinator", "id-only", "no-id", "id-out-of-range", "torchrun-env"])
def test_misconfigured_job_raises(data, tmp_path, monkeypatch, argv, env, match):
    """A job that asks for several processes and is set up wrong raises; it
    never runs as one process."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises((ValueError, RuntimeError), match=match):
        torch_main.main([*ESTIMATE, "-o", str(tmp_path), *argv, "1.25e-8",
                         data.one[0]])
    assert distributed.current() is None
    assert not os.path.exists(tmp_path / "model.final.json")


@pytest.mark.parametrize("device,env,want", [
    ("cuda", None, "nccl"), ("cpu", None, "gloo"), ("cuda", "gloo", "gloo"),
    ("cpu", "nccl", ValueError), ("cuda", "mpi", ValueError),
])
def test_backend_follows_the_device(monkeypatch, device, env, want):
    """NCCL for a CUDA rank and gloo for a CPU rank; gloo on a card only
    when SMCPP_TPU_DIST_BACKEND names it."""
    monkeypatch.delenv(distributed.BACKEND_ENV, raising=False)
    if env is not None:
        monkeypatch.setenv(distributed.BACKEND_ENV, env)
    if isinstance(want, str):
        assert distributed._backend(torch.device(device)) == want
    else:
        with pytest.raises(want):
            distributed._backend(torch.device(device))
