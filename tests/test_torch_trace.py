"""The port's spans (smcpp_tpu_torch/trace.py) on the CPU: nothing recorded
and nothing touched while no profiler records; under torch.profiler the
spans nest, share the profiler's clock, mark the E-step, the M-step and
its Q evaluations of a fit and the stages of a posterior decode, and leave
the fit's numbers bit for bit as they were; ``--profile-dir`` writes them
into the Chrome trace of ``estimate``, ``split``, ``cv`` and ``posterior``."""

import argparse
import json
import threading
import time

import numpy as np
import pytest
import torch

from smcpp_tpu_torch import trace
from smcpp_tpu_torch.commands import main as torch_main
from smcpp_tpu_torch.data.simulate import write_simulated
from smcpp_tpu_torch.inference.analysis import Analysis
from smcpp_tpu_torch.models import SMCModel

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]


def _profiled(work):
    "(work()'s value, the spans it recorded) under torch.profiler."
    with torch.profiler.profile(activities=CPU) as prof:
        t0 = time.time_ns()
        out = work()
        t1 = time.time_ns()
    return out, trace.records(t0, t1), prof


@pytest.fixture(scope="module")
def smc_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    m = SMCModel([0.01, 0.1, 1.0, 5.0], 1e4, "piecewise")
    m.y[:] = np.log([1.0, 0.3, 1.0, 2.0])
    files = []
    for i in range(2):
        fn = str(d / f"sim{i}.smc.gz")
        write_simulated(fn, m, 2e-4, 2e-4, L=1_000_000, n=6, seed=i)
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


def test_span_off_records_nothing_and_touches_no_device(monkeypatch):
    assert not torch.autograd._profiler_enabled()

    def refuse(*a, **k):
        raise AssertionError("a span touched the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = trace.records()
    with trace.span("a") as s:
        s.rename("b")
        with trace.span("c"):
            value = (1, [2.0])
    assert value == (1, [2.0])
    # no object is made: every call hands back the one inert span
    assert trace.span("x") is trace.span("y") is s
    assert trace.records() == before
    _, recs, _ = _profiled(lambda: trace.span("on").__enter__().__exit__())
    assert [r.name for r in recs] == ["on"]


def test_spans_nest_under_the_profiler():
    def work():
        with trace.span("outer") as o:
            with trace.span("a"):
                with trace.span("leaf"):
                    pass
            with trace.span("b"):
                pass
            o.rename("outer.done")
        return 42

    value, recs, _ = _profiled(work)
    assert value == 42
    assert [r.name for r in recs] == ["outer.done", "a", "leaf", "b"]
    by = {r.name: r for r in recs}
    assert by["outer.done"].parent == -1
    assert by["a"].parent == by["b"].parent == by["outer.done"].index
    assert by["leaf"].parent == by["a"].index
    assert {r.tid for r in recs} == {threading.get_native_id()}
    for r in recs:
        assert r.start <= r.end
    assert by["outer.done"].start <= by["a"].start and by["b"].end <= by["outer.done"].end


def test_span_shares_the_profilers_clock():
    a = torch.randn(64, 64, dtype=torch.float64)

    def work():
        with trace.span("mm"):
            return torch.mm(a, a)

    _, recs, prof = _profiled(work)
    (r,) = recs
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert r.start <= e.start_ns() and e.start_ns() + e.duration_ns() <= r.end
        assert e.device_resource_id() == r.tid


def test_chrome_trace_gains_the_spans(tmp_path):
    def work():
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(3).sum()

    with torch.profiler.profile(activities=CPU) as prof:
        t0 = time.time_ns()
        work()
        t1 = time.time_ns()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    recs = trace.records(t0, t1)
    trace.add_to_chrome_trace(path, recs)
    with open(path) as f:
        doc = json.load(f)
    ev = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "smcpp"}
    assert set(ev) == {"outer", "inner"}
    base = doc.get("baseTimeNanoseconds", 0)
    ops = [e for e in doc["traceEvents"] if e.get("name") == "aten::sum"]
    assert ops
    for e in ops:
        assert ev["inner"]["ts"] <= e["ts"] <= ev["inner"]["ts"] + ev["inner"]["dur"]
        assert e["tid"] == ev["inner"]["tid"] and e["pid"] == ev["inner"]["pid"]
    assert ev["outer"]["ts"] == pytest.approx((recs[0].start - base) / 1e3)


def _fit(files, profiled):
    """Stage 1, then one stage-2 EM iteration: (y, rho, loglik, spans)."""
    np.random.seed(0)
    a = Analysis(files, _args())
    if profiled:
        _, recs, _ = _profiled(lambda: a.run(1))
    else:
        a.run(1)
        recs = []
    return a.model.y.copy(), float(a.rho), a.loglik(), recs


def test_fit_spans_and_numbers_unchanged(smc_files):
    y0, rho0, ll0, none = _fit(smc_files, False)
    y1, rho1, ll1, recs = _fit(smc_files, True)
    assert none == []
    # the profiler and the spans change no number of the fit
    assert np.array_equal(y0, y1) and rho0 == rho1 and ll0 == ll1
    by = {r.index: r for r in recs}
    names = [r.name for r in recs]
    assert any(n.startswith("estep.") for n in names)
    msteps = [r for r in recs if r.name in ("mstep.unified", "mstep.sequential")]
    assert len(msteps) == 1 and msteps[0].parent == -1

    def under(r, top):
        while r.parent in by:
            r = by[r.parent]
            if r.index == top.index:
                return True
        return False

    qs = [r for r in recs if r.name.startswith("q.")]
    assert qs and all(under(q, msteps[0]) for q in qs)
    estep = next(r for r in recs if r.name.startswith("estep."))
    assert {r.name for r in recs if r.parent == estep.index} >= {"tensors", "pull", "check"}


@pytest.fixture(scope="module")
def fitted(smc_files, tmp_path_factory):
    "model.final.json of a one-iteration fit of the simulated files."
    out = tmp_path_factory.mktemp("fit")
    torch_main.main(["estimate", "--device", "cpu", "--em-iterations", "1",
                     "-o", str(out), "1.25e-8", *smc_files])
    return str(out / "model.final.json")


def _posterior_argv(model, npz, data, *extra):
    return ["posterior", "--device", "cpu", "--M", "8", "--map", "--intervals",
            "0.025,0.5,0.975", *extra, model, npz, data]


def test_posterior_spans(smc_files, fitted, tmp_path):
    argv = _posterior_argv(fitted, str(tmp_path / "post.npz"), smc_files[0])
    _, recs, _ = _profiled(lambda: torch_main.main(argv))
    names = [r.name for r in recs]
    for prefix in ("estep.", "decode.", "viterbi.", "posterior.quantiles",
                   "posterior.normalise", "posterior.save"):
        assert any(n.startswith(prefix) for n in names), prefix
    by = {r.index: r for r in recs}
    decode = next(r for r in recs if r.name.startswith("decode."))
    assert by[decode.parent].name.startswith("estep.")
    assert {r.name for r in recs if r.parent == decode.index} >= {"pull", "split"}
    viterbi = next(r for r in recs if r.name.startswith("viterbi."))
    assert viterbi.parent == -1
    assert {r.name for r in recs if r.parent == viterbi.index} >= {"tensors", "pull", "split"}


def test_posterior_profile_dir(smc_files, fitted, tmp_path):
    """posterior --profile-dir writes a Chrome trace of the decode with the
    program's spans, the command's own stages among them."""
    prof = tmp_path / "prof"
    torch_main.main(_posterior_argv(fitted, str(tmp_path / "post.npz"),
                                    smc_files[0], "--profile-dir", str(prof)))
    assert (tmp_path / "post.npz").exists()
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "smcpp"]
    for prefix in ("estep.", "decode.", "viterbi.", "posterior.quantiles",
                   "posterior.normalise", "posterior.save"):
        assert any(n.startswith(prefix) for n in spans), prefix
    assert trace.records() == []  # written out, then cleared
