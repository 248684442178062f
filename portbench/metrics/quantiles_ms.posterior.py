"""Milliseconds of the posterior command's host work a decode: the
masses normalised per row, and ``posterior_quantiles``."""


def read(run):
    s, n = run.spans.get("quantiles"), run.window.get("units", 0)
    return 1e3 * sum(s) / n if s and n else None
