"""portbench/metrics/q_graph_share.fit.py on synthetic spans (ns), without
a card."""

import os
import types

import pytest

from portbench import harness, progtrace

# index, name, start, end, parent, thread
SPANS = [
    (0, "mstep.unified", 0, 100, -1, 7),
    (1, "mstep.round", 5, 95, 0, 7),
    (2, "q.batch64", 10, 30, 1, 7),
    (3, "q.rho64", 12, 28, 2, 7),
    (4, "q.batch32", 40, 60, 1, 7),
    (5, "estep.windows", 120, 200, -1, 7),
    (6, "pull", 180, 200, 5, 7),
    (7, "mstep.sequential", 210, 260, -1, 7),
    (8, "q.grad", 220, 230, 7, 7),
]
DEVICE = [(15, 25), (20, 35), (45, 50), (130, 170), (300, 310)]
LAUNCHES = [(11, 7), (13, 7), (29, 7), (41, 7), (42, 9), (61, 7), (221, 7)]


def _run(spans, device, launches):
    run = types.SimpleNamespace(trace=None)
    run._progtrace = progtrace.Spans(spans, device, launches)
    return run


def _read(run):
    path = os.path.join(harness.HERE, "metrics", "q_graph_share.fit.py")
    return harness.load_module(path).read(run)


def test_q_graph_share_reads_the_replays_inside_the_msteps_evaluations():
    # q.batch64 (2) holds a replay, q.batch32 (4) a capture and its replay,
    # q.grad (8) none; a replay under the E-step (10) is no M-step's
    spans = SPANS + [(9, "q.graph", 13, 27, 2, 7), (10, "q.graph", 130, 140, 5, 7),
                     (11, "q.capture", 41, 50, 4, 7), (12, "q.graph", 51, 59, 4, 7)]
    assert _read(_run(spans, DEVICE, LAUNCHES)) == pytest.approx(2 / 3)


def test_q_graph_share_counts_a_capture_without_its_replay_as_eager():
    spans = SPANS + [(9, "q.capture", 41, 50, 4, 7)]
    assert _read(_run(spans, DEVICE, LAUNCHES)) == pytest.approx(0.0)


@pytest.mark.parametrize("run", [
    types.SimpleNamespace(trace=None),     # an untraced run
    _run([], [], []),                      # a trace with no spans
    _run(SPANS, DEVICE, LAUNCHES),         # a port that records no graph span
], ids=["untraced", "no_spans", "no_graph_spans"])
def test_q_graph_share_reads_nothing_without_graph_spans(run):
    assert _read(run) is None
