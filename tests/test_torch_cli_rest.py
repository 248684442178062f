"""The port's ``chunk``, ``simulate``, ``plot`` (with ``plotting.py``),
``cv`` and ``models.model.aggregate``/``to_msp`` against the JAX package's,
and the port's CLI surface against the JAX CLI's.

``chunk`` and ``simulate --engine hmm`` must write the same text as JAX's at
the same ``--seed``; ``plot --csv`` and ``aggregate`` must agree with JAX's
at rtol 1e-12 (the same float64 arithmetic, in torch on one side and jnp on
the other).  ``cv`` runs on the CPU at a tiny size: 2 contigs x 200 kbp,
n = 4, 4 knots, ``--rp-values 4,6``, one EM iteration.
"""

import argparse
import csv
import gzip
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from smcpp_tpu import plotting as jplotting  # noqa: E402
from smcpp_tpu.commands import main as jax_main  # noqa: E402
from smcpp_tpu.models import model as jmodel  # noqa: E402
from smcpp_tpu_torch import plotting as tplotting  # noqa: E402
from smcpp_tpu_torch.commands import main as torch_main  # noqa: E402
from smcpp_tpu_torch.data import format as tfmt  # noqa: E402
from smcpp_tpu_torch.data.simulate import simulate_contig  # noqa: E402
from smcpp_tpu_torch.data.simulate import write_simulated  # noqa: E402
from smcpp_tpu_torch.models import model as tmodel  # noqa: E402

MAINS = (("jax", jax_main.main), ("torch", torch_main.main))


def _text(fn):
    opener = gzip.open if str(fn).endswith(".gz") else open
    with opener(fn, "rt") as f:
        return f.read()


def _one_pop_dict(spline="piecewise", knots=(0.02, 0.1, 0.5, 2.0), pid="pop1",
                  y=(0.3, -0.5, 0.2, 0.8)):
    m = tmodel.SMCModel(list(knots), 1.5e4, spline, pid)
    y = np.asarray(y, float)
    m.y = np.r_[y, y[:2]][: len(m.y)] if len(m.y) > len(y) else y
    return m.to_dict()


def _two_pop_dict():
    m1 = tmodel.SMCModel.from_dict(_one_pop_dict(pid="pop1"))
    m2 = tmodel.SMCModel.from_dict(_one_pop_dict(pid="pop2",
                                                 y=(-0.2, 0.4, 0.1, 0.5)))
    return tmodel.SMCTwoPopulationModel(m1, m2, 0.3).to_dict()


def _model_json(path, d, theta=5e-4):
    with open(path, "w") as f:
        json.dump({"theta": theta, "rho": theta, "alpha": 1, "model": d}, f)
    return str(path)


# ---------------------------------------------------------------- chunk

@pytest.fixture(scope="module")
def smc_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("smc")
    m = tmodel.SMCModel.from_dict(_one_pop_dict(pid=None))
    out = {}
    for i, L in enumerate((200_000, 130_000)):
        data = simulate_contig(m, 1e-3, 1e-3, L, 6, seed=i)
        for ext in ("smc", "smc.gz"):
            fn = str(d / f"c{i}.{ext}")
            tfmt.write_contig(fn, data, ["pop1"], [[["x", 0], ["x", 1]]],
                              [[["u", k] for k in range(6)]])
            out.setdefault(ext, []).append(fn)
    return out


@pytest.mark.parametrize("ext", ["smc", "smc.gz"])
@pytest.mark.parametrize("w,n,seed,both", [(20_000, 6, 0, True),
                                           (50_000, 3, 7, False)])
def test_chunk_matches_jax(smc_files, tmp_path, ext, w, n, seed, both):
    files = smc_files[ext] if both else smc_files[ext][:1]
    for tag, main in MAINS:
        os.makedirs(tmp_path / tag)
        main(["chunk", "--seed", str(seed), "-w", str(w), str(n),
              str(tmp_path / tag / "chunk.{}.smc.gz"), *files])
    for i in range(n):
        got = _text(tmp_path / "torch" / f"chunk.{i}.smc.gz")
        assert got == _text(tmp_path / "jax" / f"chunk.{i}.smc.gz")
        spans = np.array([r.split()[0] for r in got.splitlines()[1:]], np.int64)
        assert spans.sum() == w
    assert len(os.listdir(tmp_path / "torch")) == n


def test_chunk_without_full_chunks_matches_jax(smc_files, tmp_path):
    errs = []
    for tag, main in MAINS:
        with pytest.raises(RuntimeError) as e:
            main(["chunk", "-w", "10000000", "2",
                  str(tmp_path / f"{tag}.{{}}.smc"), *smc_files["smc"]])
        errs.append(str(e.value))
    assert errs[1] == errs[0] == "no full-size chunks available"


# ------------------------------------------------------------- simulate

@pytest.mark.parametrize("which,argv", [
    ("one_pop", ["--seed", "3", "4", "300000"]),
    ("one_pop", ["-u", "2e-8", "-r", "5e-9", "--seed", "1", "2", "1e5"]),
    ("two_pop", ["--seed", "2", "3", "150000"]),
])
def test_simulate_hmm_matches_jax(tmp_path, which, argv):
    d = _one_pop_dict() if which == "one_pop" else _two_pop_dict()
    model = _model_json(tmp_path / "model.json", d)
    *opts, n, length = argv
    texts = []
    for tag, main in MAINS:
        out = str(tmp_path / f"{tag}.smc.gz")
        main(["simulate", "--engine", "hmm", *opts, model, n, length, out])
        texts.append(_text(out))
    assert texts[1] == texts[0]
    rows = np.array([r.split() for r in texts[1].splitlines()[1:]], np.int64)
    assert rows[:, 0].sum() == int(float(length))
    assert set(rows[:, 3]) == {2 * int(n) - 2}


def test_simulate_msprime_absent_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "msprime", None)
    model = _model_json(tmp_path / "model.json", _one_pop_dict())
    msgs = []
    for tag, main in MAINS:
        with pytest.raises(SystemExit) as e:
            main(["simulate", model, "2", "1e5", str(tmp_path / f"{tag}.vcf")])
        msgs.append(e.value.code)
    assert msgs[1] == msgs[0]
    assert "msprime is not installed" in msgs[1]


def _msprime_stub():
    "A stand-in msprime module whose event classes record their arguments."
    mod = types.ModuleType("msprime")

    class _Event:
        def __init__(self, **kw):
            self.__dict__.update(kw)

        def record(self):
            return (type(self).__name__, sorted(self.__dict__.items()))

    mod.PopulationParametersChange = type("PopulationParametersChange",
                                          (_Event,), {})
    mod.MassMigration = type("MassMigration", (_Event,), {})
    return mod


@pytest.mark.parametrize("which", ["piecewise", "cubic", "two_pop"])
def test_to_msp_matches_jax(monkeypatch, which):
    monkeypatch.setitem(sys.modules, "msprime", _msprime_stub())
    d = _two_pop_dict() if which == "two_pop" else _one_pop_dict(which)
    jev = jmodel.model_from_dict(d).to_msp()
    tev = tmodel.model_from_dict(d).to_msp()
    assert [e.record()[0] for e in tev] == [e.record()[0] for e in jev]
    for t, j in zip(tev, jev):
        tr, jr = dict(t.record()[1]), dict(j.record()[1])
        assert tr.keys() == jr.keys()
        for k in tr:
            np.testing.assert_allclose(float(tr[k]), float(jr[k]), rtol=1e-12)
    if which == "two_pop":
        assert sum(e.record()[0] == "MassMigration" for e in tev) == 1
        assert any(getattr(e, "population", 0) == 1 for e in tev)


# ------------------------------------------------------- plotting, plot

def _series_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["label"] == w["label"] and g["kind"] == w["kind"]
        np.testing.assert_allclose(g["x"], w["x"], rtol=1e-12)
        np.testing.assert_allclose(g["y"], w["y"], rtol=1e-12)
        if w["knots_x"] is None:
            assert g["knots_x"] is None
        else:
            np.testing.assert_allclose(g["knots_x"], w["knots_x"], rtol=1e-12)


@pytest.mark.parametrize("which", ["piecewise", "cubic", "pchip", "bspline",
                                   "two_pop"])
@pytest.mark.parametrize("step", [False, True])
def test_model_to_plot_dict_matches_jax(which, step):
    d = {"model": _two_pop_dict() if which == "two_pop" else _one_pop_dict(which)}
    got = tplotting.model_to_plot_dict(d, step=step)
    want = jplotting.model_to_plot_dict(d, step=step)
    assert [label for label, _ in got] == [label for label, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "kind":
                assert g[k] == w[k]
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-12)
    psfs = [(label, dict(s, g=25.0, off=100.0)) for label, s in got]
    _series_equal(tplotting.build_series(psfs), jplotting.build_series(psfs))


def test_build_series_exponential_pieces_matches_jax():
    "Old-schema models with ``b`` (piecewise exponential) and presets."
    from smcpp_tpu_torch import util

    psfs = [("exp", {"N0": 1e4, "a": [2.0, 1.0, 0.5, 3.0],
                     "b": [1.0, 0.7, 2.0, 3.0], "s": [0.1, 0.2, 0.5, 1.0]}),
            ("human", dict(util.human, g=29.0)),
            ("saw", dict(util.sawtooth, off=50.0))]
    _series_equal(tplotting.build_series(psfs), jplotting.build_series(psfs))


def _read_csv(fn):
    with open(fn, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


PLOTS = {
    "piecewise": (["-c"], ["piecewise"]),
    "spline_years_step": (["-c", "-g", "29", "-s", "-k"], ["cubic"]),
    "two_pop_offsets": (["-c", "-t", "0", "500", "1000"],
                        ["two_pop", "piecewise", "cubic"]),
    "presets_linear_limits": (["--csv", "--linear", "-x", "1e2", "1e6",
                               "-y", "1e3", "1e6", "--logy"],
                              ["human", "sawtooth", "piecewise"]),
}


@pytest.mark.parametrize("case", sorted(PLOTS))
def test_plot_csv_matches_jax(tmp_path, case):
    flags, which = PLOTS[case]
    models = []
    for i, w in enumerate(which):
        if w in ("human", "sawtooth"):
            models.append(w)
        else:
            d = _two_pop_dict() if w == "two_pop" else _one_pop_dict(w)
            models.append(_model_json(tmp_path / f"m{i}.json", d))
    tables = []
    for tag, main in MAINS:
        png = tmp_path / f"{tag}.png"
        main(["plot", str(png), *models, *flags])
        assert png.stat().st_size > 0
        tables.append(_read_csv(tmp_path / f"{tag}.csv"))
    (jhead, jrows), (thead, trows) = tables
    assert thead == jhead == ["label", "x", "y", "plot_type", "plot_num"]
    assert len(trows) == len(jrows) > 0
    for t, j in zip(trows, jrows):
        assert (t[0], t[3], t[4]) == (j[0], j[3], j[4])
        np.testing.assert_allclose([float(t[1]), float(t[2])],
                                   [float(j[1]), float(j[2])], rtol=1e-12)


@pytest.mark.parametrize("case", ["offsets", "missing"])
def test_plot_exits_match_jax(tmp_path, case):
    model = _model_json(tmp_path / "m.json", _one_pop_dict())
    args = {"offsets": ["x.png", model, "-t", "1", "2"],
            "missing": ["x.png", str(tmp_path / "nothere.json")]}[case]
    codes = []
    for _, main in MAINS:
        with pytest.raises(SystemExit) as e:
            main(["plot", *args])
        codes.append(e.value.code)
    assert codes[1] == codes[0] and isinstance(codes[0], str)


# ------------------------------------------------------------ aggregate

@pytest.mark.parametrize("splines", [("piecewise", "piecewise"),
                                     ("cubic", "piecewise", "pchip")])
def test_aggregate_matches_jax(splines):
    ds = [_one_pop_dict(s, knots=(0.02 * (i + 1), 0.1, 0.5 + i, 2.0),
                        y=(0.3 * i, -0.5, 0.2, 0.8 - i / 3))
          for i, s in enumerate(splines)]
    got = tmodel.aggregate(*[tmodel.SMCModel.from_dict(d) for d in ds])
    want = jmodel.aggregate(*[jmodel.SMCModel.from_dict(d) for d in ds])
    g, w = got.to_dict(), want.to_dict()
    assert (g["class"], g["spline_class"], g["pid"], g["N0"]) == (
        w["class"], w["spline_class"], w["pid"], w["N0"])
    np.testing.assert_allclose(g["knots"], w["knots"], rtol=1e-12)
    np.testing.assert_allclose(g["y"], w["y"], rtol=1e-12)
    np.testing.assert_allclose(got(got.knots), want(want.knots), rtol=1e-12)


# ------------------------------------------------------------------- cv

@pytest.fixture(scope="module")
def cv_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cv")
    true = tmodel.SMCModel(np.array([0.05, 2.0]), 2e4, "piecewise", "pop1")
    true.y = np.log(np.array([1.5, 0.8]))
    files = []
    for i in range(2):
        fn = str(d / f"c{i}.smc.gz")
        write_simulated(fn, true, 1e-4, 1e-4, L=200_000, n=4, seed=i)
        files.append(fn)
    return files


CV_ARGS = ["--device", "cpu", "--folds", "2", "--em-iterations", "1",
           "--knots", "4", "--rp-values", "4,6"]


@pytest.fixture(scope="module")
def cv_run(cv_files, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cvrun") / "cv")
    torch_main.main(["cv", *CV_ARGS, "-o", out, "1.25e-8", *cv_files])
    return out


def test_cv_writes_folds_and_aggregate(cv_run):
    best = []
    for i in range(2):
        fd = os.path.join(cv_run, f"fold{i}")
        assert os.path.exists(os.path.join(fd, ".done"))
        assert os.path.exists(os.path.join(fd, "model.final.json"))
        with open(os.path.join(fd, "model.best.json")) as f:
            best.append(tmodel.SMCModel.from_dict(json.load(f)["model"]))
    with open(os.path.join(cv_run, "model.final.json")) as f:
        d = json.load(f)
    assert d["model"]["class"] == "SMCModel"
    assert np.all(np.isfinite(d["model"]["y"]))
    want = tmodel.aggregate(*best)
    np.testing.assert_allclose(d["model"]["knots"], want.knots, rtol=1e-12)
    np.testing.assert_allclose(d["model"]["y"], want.y, rtol=1e-12)
    # the aggregate of JAX's aggregate on the same best models
    jbest = [jmodel.SMCModel.from_dict(m.to_dict()) for m in best]
    np.testing.assert_allclose(d["model"]["y"], jmodel.aggregate(*jbest).y,
                               rtol=1e-12)
    assert np.isfinite(d["rho"]) and d["rho"] > 0


def test_cv_resume_refits_nothing(cv_run, cv_files, monkeypatch):
    from smcpp_tpu_torch.inference import analysis

    def refuse(*a, **k):
        raise AssertionError("the resumed cv built or ran an analysis")

    monkeypatch.setattr(analysis.Analysis, "run", refuse)
    monkeypatch.setattr(analysis.Analysis, "__init__", refuse)
    final = os.path.join(cv_run, "model.final.json")
    before = _text(final)
    torch_main.main(["cv", *CV_ARGS, "-o", cv_run, "1.25e-8", *cv_files])
    assert _text(final) == before


def test_cv_single_fold(cv_files, tmp_path):
    out = str(tmp_path / "cv")
    with pytest.raises(SystemExit) as e:
        torch_main.main(["cv", *CV_ARGS, "--fold", "1", "-o", out, "1.25e-8",
                         *cv_files])
    assert e.value.code == 0
    assert os.path.exists(os.path.join(out, "fold1", ".done"))
    assert os.path.exists(os.path.join(out, "fold1", "model.best.json"))
    assert not os.path.exists(os.path.join(out, "fold0"))
    assert not os.path.exists(os.path.join(out, "model.final.json"))


def test_cv_profile_dir(cv_files, tmp_path):
    """cv --profile-dir writes a Chrome trace of the fold loop, as
    estimate's, with the program's spans."""
    prof = tmp_path / "prof"
    with pytest.raises(SystemExit) as e:
        torch_main.main(["cv", *CV_ARGS, "--fold", "0", "--profile-dir",
                         str(prof), "-o", str(tmp_path / "cv"), "1.25e-8",
                         *cv_files])
    assert e.value.code == 0
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "smcpp"]
    for prefix in ("estep.", "mstep.", "q."):
        assert any(n.startswith(prefix) for n in spans), prefix


@pytest.mark.parametrize("bad", [["--folds", "3"], ["--folds", "1"],
                                 ["--fold", "2"], ["--fold", "-1"]])
def test_cv_exits_match_jax(cv_files, tmp_path, bad):
    codes = []
    for tag, main in MAINS:
        argv = ["cv", "--em-iterations", "1", *bad, "-o",
                str(tmp_path / tag), "1.25e-8", *cv_files]
        if tag == "torch":
            argv.insert(1, "--device=cpu")
        with pytest.raises(SystemExit) as e:
            main(argv)
        codes.append(e.value.code)
    assert codes[1] == codes[0] and isinstance(codes[0], str)


# ---------------------------------------------------------- CLI surface

# the port's --device in place of JAX's --devices (one rank owns one device,
# so the port has no cap on a mesh's devices)
JAX_ONLY = {"--devices"}
TORCH_ONLY = {"--device"}
# the port's posterior writes a profiler trace of its decode, as estimate does
TORCH_ONLY_IN = {"posterior": {"--profile-dir"}}


def _surface(pkg):
    import importlib

    mod = importlib.import_module(f"{pkg}.commands.command")
    for name in ("chunk", "cite", "cv", "estimate", "plot", "posterior",
                 "simulate", "split", "vcf2smc", "version"):
        importlib.import_module(f"{pkg}.commands.{name}")
    out = {}
    for cls in mod.ConsoleCommand.__subclasses__():
        p = argparse.ArgumentParser()
        cls(p)
        opts = {s for a in p._actions for s in a.option_strings}
        pos = [(a.dest, a.nargs) for a in p._actions if not a.option_strings]
        out[cls.__name__.lower()] = (opts, pos)
    return out


def test_cli_surface_matches_jax():
    jax, port = _surface("smcpp_tpu"), _surface("smcpp_tpu_torch")
    assert sorted(port) == sorted(jax)
    for name in jax:
        jopts, jpos = jax[name]
        topts, tpos = port[name]
        assert tpos == jpos, name
        assert topts - TORCH_ONLY - TORCH_ONLY_IN.get(name, set()) == jopts - JAX_ONLY, name
        assert ("--device" in topts) == ("--devices" in jopts), name


def test_cli_help_imports_no_jax_and_no_matplotlib():
    """``smc++ --help`` and every command's module import neither JAX, nor
    the JAX package, nor matplotlib (absent on the GPU machine)."""
    code = (
        "import sys\n"
        "from smcpp_tpu_torch.commands import main\n"
        "for cmd in ([], ['plot'], ['cv'], ['vcf2smc'], ['simulate'], ['chunk']):\n"
        "    try:\n"
        "        main.main(cmd + ['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'smcpp_tpu', 'matplotlib'))\n"
        "print('BAD', bad)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
