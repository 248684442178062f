"""Milliseconds a decode in which the card runs nothing inside the
program's ``decode.*`` span (``_compute_gammas``: the window decode or the
row route, to the masses on the host)."""

from portbench import progtrace


def read(run):
    sp = progtrace.of(run)
    return progtrace.per(sp.outermost("decode."), sp.idle_ns) if sp else None
