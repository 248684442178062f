"""Traced runs of benchmark cells, the card's idle time broken down by the
program's spans (smcpp_tpu_torch/trace.py).

    python3 tools/span_breakdown.py --seed 7 [--seconds 30] [--out FILE] CELL ...

Each cell runs once as ``portbench/run.py --trace 1`` runs it, in this
process.  For each it prints the result line, then a JSON record: the idle
time of the traced part by the innermost program span open on the host
(``top/inner`` names; ``-`` where none is open), and for each of the
benchmark's own spans (``estep``, ``mstep``, ``decode``, ``viterbi``, ...)
its idle time and the share of it that falls inside some program span.
``--out`` also writes the records there as one JSON list.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness, progtrace  # noqa: E402


def segments(intervals):
    """(start, end, label) intervals that nest properly -> the sorted
    disjoint pieces (a, b, label of the innermost interval open there)."""
    marks = sorted([(s, 1, -(t - s), lab) for s, t, lab in intervals]
                   + [(t, 0, 0, lab) for s, t, lab in intervals],
                   key=lambda m: m[:3])
    out, stack, prev = [], [], None
    for t, opening, _, lab in marks:
        if stack and prev is not None and t > prev:
            out.append((prev, t, stack[-1]))
        if opening:
            stack.append(lab)
        else:
            stack.reverse()
            stack.remove(lab)
            stack.reverse()
        prev = t
    return out


def refine(pieces, segs):
    """Sorted disjoint ``pieces`` (a, b, labels) cut at the sorted disjoint
    ``segs`` (a, b, label): each piece's labels gain the segment's label
    (None outside every segment)."""
    out, j = [], 0
    for a, b, labs in pieces:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        t, k = a, j
        while t < b:
            if k < len(segs) and segs[k][0] <= t:
                e = min(b, segs[k][1])
                out.append((t, e, labs + (segs[k][2],)))
                t = e
                if segs[k][1] <= t:
                    k += 1
            else:
                e = min(b, segs[k][0]) if k < len(segs) else b
                out.append((t, e, labs + (None,)))
                t = e
    return out


def breakdown(run):
    sp = progtrace.of(run)
    if sp is None:
        return None
    lo, hi = run.trace.t0, run.trace.t1

    def path(s):
        anc = sp.ancestors(s)
        return s.name if not anc else f"{anc[-1].name}/{s.name}"

    prog = segments([(s.start, s.end, path(s)) for s in sp.spans])
    bench = segments([(s, t, n) for s, t, n in sp.bench])
    pieces = refine(refine([(a, b, ()) for a, b in sp.gaps(lo, hi)], bench), prog)
    by_span, by_bench = {}, {}
    for a, b, (bn, pn) in pieces:
        by_span[pn or "-"] = by_span.get(pn or "-", 0) + (b - a)
        if bn is not None:
            d = by_bench.setdefault(bn, [0, 0])
            d[0] += b - a
            d[1] += (b - a) if pn is not None else 0
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
    return {
        "window_s": (hi - lo) / 1e9,
        "idle_s": sum(b - a for a, b in sp.gaps(lo, hi)) / 1e9,
        "idle_by_program_span_s": {k: v / 1e9 for k, v in top(by_span).items()},
        "idle_by_benchmark_span": {k: {"idle_s": v[0] / 1e9,
                                       "in_program_span": v[1] / v[0] if v[0] else None}
                                   for k, v in by_bench.items()},
        "spans": len(sp.spans),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cells", nargs="+")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    runs = []
    init = harness.Run.__init__

    def keep(self, *args, **kw):
        init(self, *args, **kw)
        runs.append(self)

    harness.Run.__init__ = keep
    records = []
    for cell in a.cells:
        line, err = harness.execute(cell, a.seed, a.seconds, True)
        print("\n".join(err), file=sys.stderr)
        print(line, flush=True)
        rec = {"cell": cell, "seed": a.seed, "result": json.loads(line),
               "spans": breakdown(runs[-1])}
        print(json.dumps(rec["spans"]), flush=True)
        records.append(rec)
        runs[-1].state = None
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
