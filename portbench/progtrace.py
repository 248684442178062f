"""The program's own spans in a traced run (``smcpp_tpu_torch/trace.py``),
laid over torch.profiler's events on their shared clock (``time.time_ns``):
the device's busy time inside a span, the CUDA runtime's kernel launches on
a span's thread, and the spans' nesting.

``of(run)`` reads them once a run, within the traced part
``[run.trace.t0, run.trace.t1]``.  It returns None without a card (no
profiler trace) and where the program records no spans (a checkout whose
port has no ``trace`` module), so a metric that reads it prints nothing
there.

Device intervals are the profiler's device events less user annotations
(``record_function`` ranges, which the profiler repeats on the device's
timeline) and the benchmark's own ``portbench.*`` ranges; a launch is a
host event whose name holds ``LaunchKernel`` (``cudaLaunchKernel``,
``cuLaunchKernel`` and their variants).
"""

import bisect
import collections

from portbench import harness

Span = collections.namedtuple("Span", "index name start end parent tid")


class Spans:
    """Spans (index, name, start, end, parent index, thread id), device
    intervals (start, end) and launches (start, thread id), in ns of one
    clock; ``bench`` holds the benchmark's spans (start, end, name)."""

    def __init__(self, spans, device, launches, bench=()):
        self.spans = sorted((Span(*s) for s in spans), key=lambda s: s.start)
        self.by_index = {s.index: s for s in self.spans}
        merged = []
        for s, t in sorted(device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy = merged
        self._starts = [s for s, _ in merged]
        self._cum = [0]
        for s, t in merged:
            self._cum.append(self._cum[-1] + t - s)
        self._launch = collections.defaultdict(list)
        for t, tid in launches:
            self._launch[tid].append(t)
        for v in self._launch.values():
            v.sort()
        self.bench = list(bench)

    # -- nesting ------------------------------------------------------------
    def ancestors(self, s):
        "The spans enclosing ``s``, innermost first."
        out, p = [], self.by_index.get(s.parent)
        while p is not None:
            out.append(p)
            p = self.by_index.get(p.parent)
        return out

    def named(self, prefix):
        return [s for s in self.spans if s.name.startswith(prefix)]

    def outermost(self, prefix):
        "Spans named ``prefix``... that no span so named encloses."
        return [s for s in self.named(prefix)
                if not any(a.name.startswith(prefix) for a in self.ancestors(s))]

    def inside(self, outer, prefix):
        "The outermost spans named ``prefix``... among ``outer``'s descendants."
        return [s for s in self.outermost(prefix)
                if any(a.index == outer.index for a in self.ancestors(s))]

    # -- the device and the launches ---------------------------------------
    def _busy_to(self, t):
        k = bisect.bisect_right(self._starts, t)
        if k == 0:
            return 0
        a, b = self.busy[k - 1]
        return self._cum[k - 1] + min(t, b) - a

    def busy_ns(self, lo, hi):
        "Time in [lo, hi] in which some operation ran on the device."
        return self._busy_to(hi) - self._busy_to(lo) if hi > lo else 0

    def idle_ns(self, s):
        "Time inside span ``s`` in which the device ran nothing."
        return (s.end - s.start) - self.busy_ns(s.start, s.end)

    def gaps(self, lo, hi):
        "The device's idle intervals within [lo, hi]."
        out, prev = [], lo
        for a, b in self.busy:
            if b <= lo:
                continue
            if a >= hi:
                break
            if a > prev:
                out.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            out.append((prev, hi))
        return out

    def launches_in(self, s):
        "Kernel launches that started inside span ``s`` on its thread."
        v = self._launch.get(s.tid, [])
        return bisect.bisect_right(v, s.end) - bisect.bisect_left(v, s.start)


def events(prof):
    """(device intervals, launches, benchmark spans) of a torch.profiler
    run, in ns on ``time.time_ns``'s clock."""
    device, launches, bench = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        s = harness.Trace._ns(e, "start")
        t = s + harness.Trace._ns(e, "duration")
        if str(e.device_type()).endswith("CUDA"):
            if not (annotation or name.startswith("portbench.")):
                device.append((s, t))
        elif name.startswith("portbench."):
            bench.append((s, t, name[len("portbench."):]))
        elif "LaunchKernel" in name:
            launches.append((s, e.device_resource_id()))
    return device, launches, bench


def of(run):
    "The run's ``Spans``, read once (None where there is nothing to read)."
    if "_progtrace" not in vars(run):
        run._progtrace = _read(run)
    return run._progtrace


def _read(run):
    tr = run.trace
    if tr is None or tr.t0 is None or tr.t1 is None:
        return None
    try:
        from smcpp_tpu_torch import trace
    except ImportError:  # a port without spans
        return None
    recs = trace.records(tr.t0, tr.t1)
    if not recs:
        return None
    return Spans(recs, *events(tr.prof))


def q_evals(sp):
    """The Q evaluations of the M-steps: the outermost ``q.*`` spans inside
    the outermost ``mstep.*`` spans."""
    return [q for m in sp.outermost("mstep.") for q in sp.inside(m, "q.")]


def per(spans, value, scale=1e-6):
    "The sum of ``value(s)`` over ``spans`` a span, times ``scale``."
    return scale * sum(value(s) for s in spans) / len(spans) if spans else None
