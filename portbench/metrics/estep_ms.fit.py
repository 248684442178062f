"""Milliseconds of an E-step of the fit: the synchronised span around
``Analysis.E_step`` (the window kernels through ``InferenceManager.E_step``),
the mean over the window's E-steps."""


def read(run):
    s = run.spans.get("estep")
    return 1e3 * sum(s) / len(s) if s else None
