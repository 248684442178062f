"""Q batches an EM iteration: calls of the manager's ``Q_batch`` (counted
by a wrapper the traced run installs) over the iterations completed in
the window.  Layer: the EM driver and M-step policy."""


def read(run):
    n = run.window.get("units", 0)
    return run.counters.get("q_batch", 0) / n if n else None
