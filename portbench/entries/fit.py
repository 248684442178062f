"""Entry 'fit': the second stage of ``smc++ estimate`` (stage-2 EM
iterations through ``Analysis.run``: inference/analysis.py ->
inference/optimizer.py:SMCPPOptimizer.run), again and again from one saved
state.

Set-up runs ``Analysis`` as ``estimate`` builds it (the data pipeline,
stage 1, the thinned and binned stage-2 data, its hidden states and
regularisation), saves the state a stage-2 fit starts from (the model,
rho, theta, alpha, each manager's precision rung and the optimizer's
state), and warms one iteration from it.  The window then runs whole fits
of ``--em-iterations`` iterations, each from the saved state, so every run
walks the same iterations whatever its length; it closes at the first
iteration boundary after ``--seconds``.  An iteration is an E-step and the
M-step after it; a fit that stops on its tolerance ends with an E-step of
its own, counted in the window's time.

Traffic keys: ``trace_seconds`` (how much of a traced window the profiler
records) and ``limits`` (the limit of each number the check compares)."""

import argparse
import copy
import gc
import shutil
import sys
import tempfile
import time

import numpy as np
import scipy.optimize
import torch

from portbench.gen import simulate, smcfile
from portbench.reference import hmm as ref_hmm
from portbench.reference import pipeline
from portbench.reference import tensors as ref_tensors

REGULARIZATION = 6  # estimate's default penalty exponent: lambda = |Q| 10^-6


class WindowClosed(Exception):
    pass


class State:
    pass


def analysis_args(cfg, files, outdir, device):
    "The arguments ``smc++ estimate -o OUT MU FILES`` parses to."
    from smcpp_tpu_torch.commands.estimate import Estimate

    p = argparse.ArgumentParser()
    Estimate(p)
    e = cfg["estimate"]
    return p.parse_args(["--device", device, "--precision", e["precision"],
                         "-o", outdir, "--knots", str(e["knots"]),
                         "--spline", e["spline"], "-w", str(e["w"]),
                         "--em-iterations", str(e["em_iterations"]),
                         str(e["mu"]), *files])


def snapshot(a):
    "What a stage-2 fit starts from."
    return {"y": a.model.y.copy(), "rho": a.rho, "theta": a.theta, "alpha": a.alpha,
            "opt": copy.deepcopy({k: v for k, v in vars(a._optimizer).items()
                                  if k != "_analysis"}),
            "rungs": {pid: im._precision for pid, im in a._ims.items()}}


def restore(a, s):
    a.model.y = s["y"].copy()
    a.rho, a.theta, a.alpha = s["rho"], s["theta"], s["alpha"]
    vars(a._optimizer).update(copy.deepcopy(s["opt"]))
    for pid, im in a._ims.items():
        if im._precision != s["rungs"][pid]:
            im._precision = s["rungs"][pid]
            im._build_estep_fn()


def setup(run):
    from smcpp_tpu_torch.inference.analysis import Analysis

    cfg = run.cfg
    st = State()
    st.bp = list(cfg["genome_bp"].values())
    with run.part("generate"):
        st.contigs = simulate.genome(cfg, st.bp, run.seed, run.device)
    st.tmp = tempfile.mkdtemp(prefix="portbench-")
    with run.part("write"):
        files = smcfile.write_all(st.tmp, st.contigs, cfg["n"])
    args = analysis_args(cfg, files, st.tmp, run.device.type)
    np.random.seed(args.seed)  # as the command does before it builds the analysis
    # the configuration's hidden states are the balanced ones, which stage 2
    # takes where scikit-learn is absent (as on the card's machine)
    saved = sys.modules.get("sklearn", False)
    sys.modules["sklearn"] = None
    try:
        with run.part("analysis"):
            a = Analysis(args.data, args)
    finally:
        if saved is False:
            del sys.modules["sklearn"]
        else:
            sys.modules["sklearn"] = saved
    if a.hidden_state_path != "balanced":
        raise RuntimeError(f"stage 2 took the {a.hidden_state_path} hidden states")
    st.a, st.start = a, snapshot(a)
    st.niter = cfg["estimate"]["em_iterations"]
    install(run, st)
    with run.part("warm"):
        st.live = False
        a._optimizer.run(1)
        restore(a, st.start)
    return st


def install(run, st):
    """Wrappers around the iteration's boundaries (``Analysis.E_step`` and
    the optimizer's ``_check_termination``): they record each E-step's
    parameters and statistics, close the window at an iteration boundary,
    and in the traced run time the E-step and count ``Q_batch`` calls."""
    a = st.a
    estep, check_term = a.E_step, a._optimizer._check_termination
    st.phase_e, st.e_s = False, 0.0

    def E_step():
        if st.live and not st.phase_e:
            run.close_span("mstep")
            now = time.perf_counter()
            close_iteration(st, now)
            if now - st.t0 >= run.seconds:
                st.t_end = now
                raise WindowClosed
            if run.trace is not None and now - st.t0 >= run.traffic["trace_seconds"]:
                run.trace.stop()  # reading the trace is no part of an iteration
                now = time.perf_counter()
            st.fit.append({"y": a.model.y.copy(), "rho": float(a.rho)})
            st.phase_e, st.iter_start, st.e_s = True, now, 0.0
        t = time.perf_counter()
        with run.span("estep"):
            estep()
        st.e_s += time.perf_counter() - t

    def _check_termination(ll):
        if st.live:
            st.phase_e = False
            st.fit[-1]["ll"] = {pid: im.loglik() for pid, im in a._ims.items()}
            st.fit[-1]["stats"] = {pid: tuple(x.copy() for x in im._stats)
                                   for pid, im in a._ims.items()}
            run.open_span("mstep")
        return check_term(ll)

    a.E_step = E_step
    a._optimizer._check_termination = _check_termination
    if run.traced:
        for im in a._ims.values():
            qb = im.Q_batch

            def Q_batch(*args, _qb=qb, **kw):
                if st.live:
                    run.count("q_batch")
                return _qb(*args, **kw)

            im.Q_batch = Q_batch


def close_iteration(st, now):
    "The iteration running since ``iter_start`` ends at ``now``."
    if st.iter_start is not None:
        st.iterations.append((now - st.iter_start, st.e_s))
        st.iter_start = None


def window(run):
    st, a = run.state, run.state.a
    st.iterations, st.iter_start, st.fits = [], None, []
    st.live = True
    if run.trace is not None:
        run.trace.start()
    st.t0 = time.perf_counter()
    fit_s, t_fit = [], st.t0
    try:
        while True:
            restore(a, st.start)
            st.fit = []
            st.fits.append(st.fit)
            a._optimizer.run(st.niter)
            run.close_span("mstep")
            now = time.perf_counter()
            close_iteration(st, now)
            fit_s.append(now - t_fit)
            t_fit = now
            st.fit.append({"y": a.model.y.copy(), "rho": float(a.rho), "end": True})
            if now - st.t0 >= run.seconds:
                st.t_end = now
                break
    except WindowClosed:
        run.close_span("mstep")
        st.fit.append({"y": a.model.y.copy(), "rho": float(a.rho), "end": True})
    st.live = False
    st.q_prog = {pid: im.Q() for pid, im in a._ims.items()}
    st.ref_pid = next(iter(a._ims))
    st.keys = a._ims[st.ref_pid].em_idx.keys.copy()
    st.knots = a.model.knots.copy()
    st.hidden_states = np.asarray(a.hidden_states).copy()
    run.window = {"start": st.t0, "end": st.t_end, "units": len(st.iterations),
                  "seconds": st.t_end - st.t0,
                  "fits": [sum("stats" in r for r in f) for f in st.fits],
                  "fit_s": fit_s,
                  "iterations": st.iterations if run.traced else None}


def end_to_end(run):
    w = run.window
    return {"em_iteration_s": (w["end"] - w["start"]) / w["units"]}


def release(run):
    st = run.state
    st.a = None
    gc.collect()


def recorded_fit(st):
    "The last fit of the window with an E-step recorded, with its final model."
    for fit in reversed(st.fits):
        if len(fit) >= 2 and "stats" in fit[0]:
            return fit
    raise RuntimeError("no fit in the window completed an E-step")


def check(run):
    """The fit held to the reference, in float64: the E-step's
    log-likelihood and statistics at the first and the last E-step of the
    recorded fit, Q at the fit's result, and the first M-step's gain of the
    penalised Q against the reference's own maximisation of it."""
    cfg, st = run.cfg, run.state
    try:
        return _check(run, cfg, st)
    finally:
        shutil.rmtree(st.tmp, ignore_errors=True)


def reference_setup(cfg, contigs, device):
    """The stage-2 data and model layout, worked out again: (Tensors, Rows,
    stage-1 rows)."""
    e = cfg["estimate"]
    n, mu = cfg["n"], e["mu"]
    N0 = 0.5e-4 / mu
    theta = 2.0 * N0 * mu
    rows1 = pipeline.stage1(contigs)
    ne = pipeline.watterson(rows1) / (2.0 * mu * N0)
    hs = ref_tensors.balance_hidden_states(ref_tensors.constant_model(ne, N0), 2 * e["knots"])
    rows2 = pipeline.stage2(rows1, e["w"], int(500 * np.log(2 + n)))
    idx = ref_tensors.emission_index(rows2, n, e["polarization_error"])
    tens = ref_tensors.Tensors(hs[1:-1:2], N0, hs, idx, theta, e["w"], device, e["spline"])
    keys = [ref_tensors.keys_of(idx, r) for r in rows2]
    return tens, [(r[:, 0], k) for r, k in zip(rows2, keys)]


def _check(run, cfg, st):
    tens, rk = reference_setup(cfg, st.contigs, run.device)
    R = ref_hmm.Rows(*ref_hmm.pack(rk), run.device, budget=ref_hmm.free_budget(run.device))
    lim = run.traffic["limits"]
    layout_ok = (np.array_equal(tens.idx.keys, st.keys)
                 and np.allclose(tens.hidden_states, st.hidden_states, rtol=1e-12)
                 and np.allclose(tens.model.knots, st.knots, rtol=1e-12))
    if not layout_ok:
        return [(k, float("inf"), v) for k, v in lim.items()], 1
    fit = recorded_fit(st)
    worst = compare(tens, R, fit, st.ref_pid, st.q_prog, cfg)
    return [(k, v, lim[k]) for k, v in worst.items()], 0


def compare(tens, R, fit, pid, q_prog, cfg, gain=True):
    """The worst of each number over the recorded fit: its first and last
    E-steps' log-likelihood and statistics against the reference's at the
    same parameters, Q at the fit's result (``q_prog``, by manager) and the
    first M-step's gain (left out where ``gain`` is false)."""
    done = [r for r in fit if "stats" in r]
    worst = {"ll_rel": 0.0, "stats_rel": 0.0}
    ref = {}
    for r in {id(done[0]): done[0], id(done[-1]): done[-1]}.values():
        pi, T, E = tens.at(r["y"], r["rho"])
        ll, *stats = R.estep(pi, T, E)
        ref[id(r)] = stats
        worst["ll_rel"] = max(worst["ll_rel"], abs(r["ll"][pid] - ll) / abs(ll))
        for got, want in zip(r["stats"][pid], stats):
            worst["stats_rel"] = max(worst["stats_rel"], float(
                np.abs(got - want).max() / np.abs(want).max()))
    # Q at the fit's result, with the statistics of its last E-step
    end = fit[-1]
    stats = [tens.f64(s) for s in ref[id(done[-1])]]
    with torch.no_grad():
        q = float(ref_tensors.q_value(*tens(tens.f64(end["y"]), tens.f64(end["rho"])), stats))
    worst["q_rel"] = abs(q_prog[pid] - q) / abs(q)
    if not gain:
        return worst
    # the first M-step: its gain of the penalised Q against the best gain
    stats0 = [tens.f64(s) for s in ref[id(done[0])]]
    worst["mstep_gain_ratio"] = gain_ratio(tens, stats0, done[0], fit[1], cfg)
    return worst


def gain_ratio(tens, stats, start, step, cfg):
    """(F* - F(start)) / (F(step) - F(start)), F the penalised Q of
    ``stats`` and F* its maximum by L-BFGS-B from ``start`` over the knot
    values and log rho, within estimate's bounds; inf where the step gains
    nothing."""
    from portbench.reference import defaults

    theta = tens.theta
    with torch.no_grad():
        q0 = float(ref_tensors.q_value(*tens(tens.f64(start["y"]), tens.f64(start["rho"])), stats))
    lam = abs(q0) * 10.0**-REGULARIZATION

    def F(y, rho):
        return ref_tensors.q_value(*tens(y, rho), stats) - lam * tens.model.regularizer_fn(y)

    def negF(x):
        xt = tens.f64(x).requires_grad_(True)
        v = F(xt[:-1], torch.exp(xt[-1]))
        (g,) = torch.autograd.grad(v, xt)
        return -float(v.detach()), -g.cpu().numpy()

    def value(r):
        with torch.no_grad():
            return float(F(tens.f64(r["y"]), tens.f64(r["rho"])))

    K = len(start["y"])
    lo, hi = np.log(defaults.minimum), np.log(defaults.maximum)
    bounds = [(lo, hi)] * K + [(np.log(theta / 100), np.log(theta * 100))]
    x0 = np.r_[start["y"], np.log(start["rho"])]
    res = scipy.optimize.minimize(negF, x0, jac=True, method="L-BFGS-B", bounds=bounds,
                                  options={"maxiter": 500})
    f0, f1 = value(start), value(step)
    best = max([v for v in (-float(res.fun), f1) if np.isfinite(v)], default=f1)
    if not (np.isfinite(f0) and np.isfinite(f1) and f1 > f0):
        return float("inf")
    return (best - f0) / (f1 - f0)
