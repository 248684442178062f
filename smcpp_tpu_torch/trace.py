"""Spans of the program's layers, recorded while torch.profiler records.

``span(name)`` marks one call into a layer (an M-step, one Q evaluation,
an E-step, a decode, ...).  While ``torch.profiler`` is not recording it
does nothing: no record, no allocation, no device synchronisation; the
check is one call of ``torch.autograd._profiler_enabled()``.  While it
records, each span appends one record to this module's list: its name,
its start and end on ``time.time_ns()`` (the clock of the profiler's own
events, so a span can be laid over the device's operations), the index of
the span that encloses it on its thread (-1 for none) and the thread's
native id.

A span never synchronises the device and never calls ``record_function``
(the profiler would count such a range as device time).  Its duration is
host time: a span that ends in a copy to the host (``.cpu()``) includes
the device work that copy waited for, and the device's share of any span
is read from the profiler's events on the shared clock.

The name carries the route: ``estep.windows`` / ``estep.remat`` /
``estep.rows`` / ``estep.m1``, ``decode.windows`` / ``decode.rows``,
``viterbi.windows`` / ``viterbi.blocked`` / ``viterbi.rows``,
``mstep.unified`` / ``mstep.sequential`` / ``mstep.split``, ``q.*`` for
one evaluation of the Q family, ``posterior.*`` for the command's host
stages, and short names (``tensors``, ``pull``, ``split``, ...) for their
children; ``tensors2`` marks an uncached two-population ``tensors()``.
"""

import collections
import itertools
import json
import os
import threading
import time

import torch

Record = collections.namedtuple("Record", "index name start end parent tid")

_enabled = torch.autograd._profiler_enabled
_lock = threading.Lock()
_index = itertools.count()
_records = []  # [index, name, start, end, parent, tid], in start order
_local = threading.local()


class _Off:
    "The span while no profiler records: it does nothing."

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def rename(self, name):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("_rec",)

    def __init__(self, name):
        self._rec = [None, name, None, None, -1, threading.get_native_id()]

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self._rec
        rec[4] = stack[-1] if stack else -1
        with _lock:
            rec[0] = next(_index)
            _records.append(rec)
        stack.append(rec[0])
        rec[2] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._rec[3] = time.time_ns()
        _local.stack.pop()
        return False

    def rename(self, name):
        "Name the span anew, for a route known only once it has run."
        self._rec[1] = name


def span(name):
    """A context manager around one call into a layer, recorded while
    torch.profiler is recording; ``rename`` on what it yields names the
    route after the fact."""
    if not _enabled():
        return _OFF
    return _Span(name)


def records(t0=None, t1=None):
    """The finished spans that lie within [t0, t1] (time.time_ns(); either
    bound may be None), as ``Record`` tuples in start order."""
    with _lock:
        recs = list(_records)
    return [Record(*r) for r in recs
            if r[3] is not None and (t0 is None or r[2] >= t0)
            and (t1 is None or r[3] <= t1)]


def clear():
    "Drop every record (spans still open keep their indices)."
    with _lock:
        _records.clear()


def add_to_chrome_trace(path, recs):
    """Write ``recs`` into the Chrome trace at ``path`` (as torch.profiler's
    ``export_chrome_trace`` writes it) as complete events on the host thread
    that ran them, on the trace's own time base, so each span shows above
    the operations it launched."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    for r in recs:
        doc["traceEvents"].append({"ph": "X", "cat": "smcpp", "name": r.name, "pid": pid,
                       "tid": r.tid, "ts": (r.start - base) / 1e3,
                       "dur": (r.end - r.start) / 1e3,
                       "args": {"index": r.index, "parent": r.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)
