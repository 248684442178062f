"""Size-history plotting.

Port of smcpp_tpu/plotting.py.  CLI-output parity with SMC++ (`smc++ plot`,
smcpp/plotting.py): same figure content and the same CSV
schema ``[label, x, y, plot_type, plot_num]``.  The implementation is
declarative — every curve is first *computed* into a series record
(label, x, y, kind) in physical units, then the records are rendered and
exported; no drawing happens while sampling the histories.  matplotlib is
imported only when a figure is drawn (``pretty_plot``).
"""

import numpy as np


def pretty_plot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    return fig, ax


def _exp_history(a, b, s, pts=200):
    """Dense samples of a piecewise-exponential history (old-schema model
    JSONs): over piece i the size decays from ``a[i]`` down to ``b[i]``;
    after the last breakpoint it holds at ``a[-1]``.  Returns (x, y) in
    coalescent units."""
    ends = np.cumsum(s, dtype=float)
    starts = ends - s
    xs, ys = [], []
    for a_i, b_i, t0, t1 in zip(a[:-1], b[:-1], starts[:-1], ends[:-1]):
        t = np.linspace(t0, t1, pts)
        rate = np.log(a_i / b_i) / (t1 - t0)
        xs.append(t)
        ys.append(b_i * np.exp(rate * (t1 - t)))
    tail = ends[-2]
    xs.append([tail, 2.0 * tail])
    ys.append([a[-1], a[-1]])
    return np.concatenate(xs), np.concatenate(ys)


def _step_history(a, s):
    "Left-extended step samples of a piecewise-constant history."
    x = np.r_[0.0, np.cumsum(s, dtype=float)]
    y = np.r_[a[0], a]
    return x, y


def build_series(psfs):
    """Compute plotted series in physical units.

    ``psfs``: [(label, d)] with d holding coalescent-scaled arrays plus
    ``N0`` (and optionally ``g`` years/generation, ``b`` for old-schema
    exponential pieces, ``knots``).  Returns a list of records
    {label, x, y, kind, knots_x} with x in generations (or years)."""
    out = []
    for label, d in psfs:
        scale_t = 2.0 * d["N0"] * (d.get("g") or 1)
        off = d.get("off", 0.0)
        a = np.asarray(d["a"], float)
        s = np.asarray(d["s"], float)
        if "b" in d:
            x, y = _exp_history(a, np.asarray(d["b"], float), s)
            kind = "plot"
        else:
            x, y = _step_history(a, s)
            # model-JSON series default to path rendering like the
            # reference; the -s flag (kind="step") switches
            kind = d.get("kind", "step")
        rec = {
            "label": label,
            "x": x * scale_t + off,
            "y": y * d["N0"],
            "kind": kind,
            "knots_x": None,
        }
        if "knots" in d:
            rec["knots_x"] = np.asarray(d["knots"], float) * scale_t + off
        out.append(rec)
    return out


def plot_psfs(psfs, xlim, ylim, xlabel, knots=False, logy=False, stats={},
              vlines=()):
    """Render size histories; returns (figure, csv_rows) where csv_rows[0]
    is the header and each further row is one series (the reference's CSV
    schema).  ``vlines``: x positions (physical units) marked with dashed
    vertical lines — the two-pop split time."""
    series = build_series(psfs)
    fig, ax = pretty_plot()
    for vx in vlines:
        ax.axvline(vx, color="grey", linestyle="--", linewidth=1)
    seen = set()
    for rec in series:
        kwargs = {"linewidth": 2}
        if rec["label"] not in seen:
            seen.add(rec["label"])
            kwargs["label"] = rec["label"]
        if rec["kind"] == "step":
            ax.step(rec["x"], rec["y"], where="post", **kwargs)
        else:
            ax.plot(rec["x"], rec["y"], **kwargs)
        if knots and rec["knots_x"] is not None:
            ax.scatter(
                rec["knots_x"],
                np.interp(rec["knots_x"], rec["x"], rec["y"]),
                marker="x",
            )
    ax.set_xscale("log")
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(r"$N_e$")
    if xlim:
        ax.set_xlim(*xlim)
    if ylim:
        ax.set_ylim(*ylim)
    if len(psfs) > 1:
        ax.legend(loc="best")
    rows = [["label", "x", "y", "plot_type", "plot_num"]]
    rows += [
        [r["label"], list(r["x"]), list(r["y"]), r["kind"], i]
        for i, r in enumerate(series)
    ]
    return fig, rows


def model_to_plot_dict(d, step=False):
    """Convert a model.final.json dict into plotting series.

    ``step``: step-rendered piecewise-constant output (the reference's
    ``--step-function``); default is path rendering of the same stepwise
    samples (plot.py:85-99).  For a two-pop model the second population's
    history is truncated at the split (it equals pop1's before it) and a
    ``vline`` marks the split time (plot.py:91-98)."""
    from .models import model_from_dict

    kind = "step" if step else "plot"
    m = model_from_dict(d["model"])
    if d["model"]["class"] == "SMCTwoPopulationModel":
        out = []
        for pid in m.pids:
            mm = m.for_pop(pid)
            series = {
                "N0": mm.N0,
                "a": np.asarray(mm.stepwise_values()),
                "s": np.asarray(mm.s, float),
                "knots": mm.knots,
                "kind": kind,
            }
            if pid == m.pids[-1]:
                ends = np.cumsum(series["s"])
                # for_pop(pid2) unions the split into the knot grid, so
                # normally split <= ends[-1]; clamp n anyway so a caller
                # passing a hand-built model can't index past the grid.
                n = min(int((ends < m.split).sum()) + 1, len(series["s"]))
                series["a"] = series["a"][:n]
                s = series["s"][:n]
                s[-1] = m.split - (ends[n - 2] if n > 1 else 0.0)
                series["s"] = s
                series["vline"] = float(m.split)
            out.append((pid, series))
        return out
    return [
        (d["model"].get("pid") or "model", {
            "N0": m.N0,
            "a": np.asarray(m.stepwise_values()),
            "s": m.s,
            "knots": m.knots,
            "kind": kind,
        })
    ]
