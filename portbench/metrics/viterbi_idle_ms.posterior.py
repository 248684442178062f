"""Milliseconds a decode in which the card runs nothing inside the
program's ``viterbi.*`` span (``map_paths``: the window, blocked or row
Viterbi, to the paths on the host)."""

from portbench import progtrace


def read(run):
    sp = progtrace.of(run)
    return progtrace.per(sp.outermost("viterbi."), sp.idle_ns) if sp else None
