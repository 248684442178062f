"""Share of the M-step in which the card runs nothing: one less the
device's busy time inside the program's outermost ``mstep.*`` spans
(smcpp_tpu_torch/trace.py, from ``SMCPPOptimizer.run``) over their
duration, in percent."""

from portbench import progtrace


def read(run):
    sp = progtrace.of(run)
    ms = sp.outermost("mstep.") if sp else []
    if not ms:
        return None
    total = sum(s.end - s.start for s in ms)
    return 100.0 * (1.0 - sum(sp.busy_ns(s.start, s.end) for s in ms) / total)
