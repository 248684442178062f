"""Kernel launches one Q evaluation takes: the CUDA runtime's launch events
on the span's thread inside the program's outermost ``q.*`` spans within
its ``mstep.*`` spans (a Q batch, a rho batch, one Q or Q with its
gradient), over the number of those spans."""

from portbench import progtrace


def read(run):
    sp = progtrace.of(run)
    return progtrace.per(progtrace.q_evals(sp), sp.launches_in, 1.0) if sp else None
