"""Milliseconds a decode of the port's ``posterior_quantiles``: the
program's ``posterior.quantiles`` spans over the decodes (``decode.*``
spans) of the traced part; the benchmark's copy of the normalisation is
left out."""

from portbench import progtrace


def read(run):
    sp = progtrace.of(run)
    n = len(sp.outermost("decode.")) if sp else 0
    if not n:
        return None
    return 1e-6 * sum(s.end - s.start for s in sp.named("posterior.quantiles")) / n
