"""Entry 'posterior': what ``smc++ posterior --map --intervals q1,q2,...``
runs after loading its data (smcpp_tpu_torch/commands/posterior.py), on one
manager built in set-up: the E-step with the posterior masses saved (the
E-step, then ``_compute_gammas``), the masses normalised per row, the MAP
path (``map_paths``) and the quantiles (``posterior_quantiles``); the npz is
not written.  The window decodes the traffic's contigs again and again and
ends with the first decode that ends after ``--seconds``.

Traffic keys: ``contigs`` (names in the configuration's genome), ``M``
(hidden states), ``intervals`` (the quantile levels), ``trace_seconds``
(how much of a traced window the profiler records) and ``limits`` (the
limit of each number the check compares)."""

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.gen import simulate, smcfile
from portbench.reference import hmm as ref_hmm
from portbench.reference import pipeline, quantiles
from portbench.reference import tensors as ref_tensors

POLARIZATION_ERROR = 0.5  # posterior's default


class State:
    pass


def truth_json(cfg):
    "The model file a user would pass: the configuration's truth."
    t = cfg["truth"]
    return {"class": "SMCModel", "knots": list(map(float, t["knots"])),
            "N0": t["N0"], "spline_class": "Piecewise",
            "y": [float(v) for v in np.log(t["sizes"])], "pid": "pop1"}


def setup(run):
    from smcpp_tpu_torch.data import format as fmt
    from smcpp_tpu_torch.inference import estimation
    from smcpp_tpu_torch.inference.manager import make_manager
    from smcpp_tpu_torch.models import model_from_dict

    cfg, tr = run.cfg, run.traffic
    st = State()
    st.bp = [int(cfg["genome_bp"][c]) for c in tr["contigs"]]
    with run.part("generate"):
        st.contigs = simulate.genome(cfg, st.bp, run.seed, run.device)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        with run.part("write"):
            files = smcfile.write_all(tmp, st.contigs, cfg["n"])
        with run.part("load"):
            m = model_from_dict(truth_json(cfg))
            contigs = fmt.load_data(files)
            st.hidden_states = estimation.balance_hidden_states(
                m.distinguished_model, tr["M"] + 1)
            st.obs = [np.insert(c.data, 0, [[1] + [-1, 0, 0]], 0) for c in contigs]
            c0 = contigs[0]
            st.im = make_manager(c0.n, c0.a, st.obs, st.hidden_states,
                                 tuple(c0.pid), POLARIZATION_ERROR,
                                 device=run.device.type)
            st.im.set_model(m)
            st.im.theta, st.im.rho, st.im.alpha = cfg["theta"], cfg["rho"], 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if run.traced:
        inner = st.im._compute_gammas

        def compute_gammas(*a):
            with run.span("decode"):
                return inner(*a)

        st.im._compute_gammas = compute_gammas
    with run.part("warm"):
        decode(run, st)
    return st


def decode(run, st):
    """One posterior decode of every contig: (gammas, paths, quantiles).  It
    mirrors what ``Posterior.main`` runs after building its manager
    (smcpp_tpu_torch/commands/posterior.py, from ``im.save_gamma = True``
    to the quantiles), the npz left out: a change there has to be made
    here too until the port has one function for it."""
    from smcpp_tpu_torch.commands.posterior import posterior_quantiles

    im = st.im
    with run.span("estep"):
        im.save_gamma = True
        im.E_step()
    with run.span("quantiles"):
        gammas = []
        for i, g in enumerate(im.gammas):
            g = g[: len(st.obs[i])].T
            colsum = g.sum(axis=0)
            colsum[colsum == 0] = 1.0
            gammas.append(g / colsum)
    with run.span("viterbi"):
        paths = [p[: len(st.obs[i])] for i, p in enumerate(im.map_paths())]
    with run.span("quantiles"):
        qs = [posterior_quantiles(g, st.hidden_states, run.traffic["intervals"])
              for g in gammas]
    return gammas, paths, qs


def window(run):
    st = run.state
    if run.trace is not None:
        run.trace.start()
    t0 = time.perf_counter()
    n, first = 0, None
    while True:
        out = decode(run, st)
        n += 1
        first = first or out
        now = time.perf_counter()
        if run.trace is not None and now - t0 >= run.traffic["trace_seconds"]:
            run.trace.stop()
        if now - t0 >= run.seconds:
            break
    run.window = {"start": t0, "end": now, "units": n, "bases": n * sum(st.bp),
                  "seconds": now - t0,
                  "outputs": [first, out] if n > 1 else [out]}
    if run.traced:
        rows, idx = shapes(run)
        run.window["shape"] = {"spans": np.concatenate([r[:, 0] for r in rows]),
                               "M": run.traffic["M"], "n_keys": idx.n_keys}


def end_to_end(run):
    w = run.window
    return {"posterior_mbp_s": w["bases"] / 1e6 / (w["end"] - w["start"])}


def shapes(run):
    "Rows (span, key) of each contig as the reference derives them."
    st = run.state
    rows = [pipeline.posterior_rows(c) for c in st.contigs]
    idx = ref_tensors.emission_index(rows, run.cfg["n"], POLARIZATION_ERROR)
    return rows, idx


def release(run):
    run.state.im = None
    gc.collect()


def check(run):
    """The decodes of the window held to the reference, in float64 on the
    run's device: of the normalised posterior masses the largest gap and the mean gap over every
    row and state, the quantiles' distance in probability, and the MAP
    path's score below the best.  The E-step's log-likelihood and
    statistics are no output of posterior (its npz holds the masses, the
    MAP path and the quantiles), so they are not compared here; the fit's
    check holds the E-step's kernels to the reference."""
    ref = reference(run)
    worst = compare(run, ref, run.window["outputs"])
    lim = run.traffic["limits"]
    return [(k, v, lim[k]) for k, v in worst.items()], 0


def reference(run, dtype=torch.float64):
    """What the reference works out from the data and the model: the rows,
    the hidden states, pi, T and E, and every row's normalised posterior
    masses.  ``dtype`` below float64 gives the control's masses."""
    cfg, tr = run.cfg, run.traffic
    rows, idx = shapes(run)
    t = cfg["truth"]
    ref_model = simulate.truth_model(cfg)
    hs = ref_tensors.balance_hidden_states(ref_model, tr["M"] + 1)
    tens = ref_tensors.Tensors(t["knots"], t["N0"], hs, idx, cfg["theta"], 1, run.device)
    pi, T, E = (x.to(dtype) for x in tens.at(ref_model.y, cfg["rho"]))
    keys = [ref_tensors.keys_of(idx, r) for r in rows]
    sp, ky = ref_hmm.pack([(r[:, 0], k) for r, k in zip(rows, keys)])
    R = ref_hmm.Rows(sp, ky, run.device, budget=ref_hmm.free_budget(run.device))
    g = R.gammas(pi, T, E)
    g = (g / g.sum(-1, keepdim=True).clamp(min=torch.finfo(g.dtype).tiny)).float().cpu().numpy()
    return {"rows": rows, "hs": hs, "R": R, "pi": pi, "T": T, "E": E, "g": g, "sp": sp}


def compare(run, ref, outputs):
    """The worst of each number over ``outputs``, each (gammas, paths,
    quantiles) as ``decode`` returns them: ``gamma_gap`` and ``gamma_mean``
    (the largest and the mean |gap| of a row's normalised mass, over every
    row and state), ``quantile_gap`` (the reference's CDF at each reported
    quantile, its distance to the level) and ``map_gap_nats``."""
    rows, g, hs = ref["rows"], ref["g"], ref["hs"]
    worst = dict.fromkeys(("gamma_gap", "gamma_mean", "quantile_gap", "map_gap_nats"), 0.0)
    for gammas, paths, qs in outputs:
        total = count = 0.0
        for i, (gp, qp) in enumerate(zip(gammas, qs)):
            L = len(rows[i])
            d = np.abs(gp.T - g[i, :L])
            worst["gamma_gap"] = max(worst["gamma_gap"], float(d.max()))
            total, count = total + float(d.sum()), count + d.size
            worst["quantile_gap"] = max(worst["quantile_gap"], quantiles.cdf_gap(
                g[i, :L], hs, run.traffic["intervals"], qp))
        worst["gamma_mean"] = max(worst["gamma_mean"], total / count)
        path = np.zeros_like(ref["sp"])
        for i, pp in enumerate(paths):
            path[i, : len(pp)] = pp
        _, gap = ref["R"].viterbi_gap(ref["pi"], ref["T"], ref["E"], path)
        worst["map_gap_nats"] = max(worst["map_gap_nats"], gap)
    return worst


def control_outputs(run, ref_low, path_low):
    """The control's answer in ``decode``'s form: the reference's masses
    computed in a lower precision, normalised per row, their quantiles, and
    the reference's MAP path computed in a lower precision (``path_low``,
    (C, L))."""
    gammas, qs, paths = [], [], []
    for i, r in enumerate(ref_low["rows"]):
        gi = ref_low["g"][i, : len(r)].astype(np.float64).T
        gammas.append(gi)
        qs.append(quantiles.posterior_quantiles(gi, ref_low["hs"], run.traffic["intervals"]))
        paths.append(path_low[i, : len(r)])
    return [(gammas, paths, qs)]
