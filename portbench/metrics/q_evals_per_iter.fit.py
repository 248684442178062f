"""Q evaluations an M-step makes: the program's outermost ``q.*`` spans
inside its ``mstep.*`` spans, batched and scalar alike, over the number of
M-steps.  Layer: the EM driver and M-step policy."""

from portbench import progtrace


def read(run):
    sp = progtrace.of(run)
    if not sp:
        return None
    return progtrace.per(sp.outermost("mstep."),
                         lambda m: len(sp.inside(m, "q.")), 1.0)
