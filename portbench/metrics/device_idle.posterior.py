"""Share of the traced window in which no operation ran on the card: one
less the union of the device's intervals in torch.profiler's trace over
the traced part of the window, in percent."""


def read(run):
    b, w = run.window.get("busy_s"), run.window.get("trace_s")
    return 100.0 * (1.0 - b / w) if b is not None and w else None
