"""Milliseconds of an M-step outside its Q evaluations: each outermost
``mstep.*`` span's duration less that of the outermost ``q.*`` spans
inside it, the mean over the M-steps: the optimizer's own host time."""

from portbench import progtrace


def read(run):
    sp = progtrace.of(run)
    if not sp:
        return None
    return progtrace.per(sp.outermost("mstep."), lambda m: (m.end - m.start) - sum(
        q.end - q.start for q in sp.inside(m, "q.")))
