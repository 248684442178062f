"""Share of the Q evaluations that replay a captured graph: the outermost
``q.*`` spans inside the program's ``mstep.*`` spans that hold a
``q.graph`` span (smcpp_tpu_torch/inference/qgraph.py), over all of them.
None where the program records no ``q.graph`` or ``q.capture`` span at all
(a port without captured Q programs)."""

from portbench import progtrace


def read(run):
    sp = progtrace.of(run)
    if not sp or not (sp.named("q.graph") or sp.named("q.capture")):
        return None
    return progtrace.per(progtrace.q_evals(sp),
                         lambda q: 1.0 if sp.inside(q, "q.graph") else 0.0, 1.0)
