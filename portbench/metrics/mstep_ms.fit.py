"""Milliseconds of an M-step of the fit: each completed iteration's
synchronised host time less its E-step span, the mean over the window's
iterations.  Layer: the Q family (pi, T, E -> Q in f64, the coarse batches
as f32 programs) and the optimizer that drives it."""


def read(run):
    it = run.window.get("iterations")
    return 1e3 * sum(t - e for t, e in it) / len(it) if it else None
