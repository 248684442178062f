"""portbench/progtrace.py on synthetic spans and events (ns), and the
per-layer metrics that read it, without a card."""

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


@pytest.fixture
def sp():
    return progtrace.Spans(SPANS, DEVICE, LAUNCHES)


def test_busy_time_merges_overlapping_intervals(sp):
    assert sp.busy == [[15, 35], [45, 50], [130, 170], [300, 310]]
    assert sp.busy_ns(0, 100) == 25
    assert sp.busy_ns(20, 46) == 16
    assert sp.busy_ns(0, 1000) == 75
    assert sp.busy_ns(36, 44) == 0
    assert sp.busy_ns(50, 40) == 0


def test_idle_inside_spans_and_gaps(sp):
    spans = {s.index: s for s in sp.spans}
    assert sp.idle_ns(spans[0]) == 75
    assert sp.idle_ns(spans[5]) == 40
    assert sp.idle_ns(spans[6]) == 20
    assert sp.gaps(0, 100) == [(0, 15), (35, 45), (50, 100)]
    assert sp.gaps(16, 34) == []


def test_outermost_spans_and_nesting(sp):
    assert [s.index for s in sp.outermost("q.")] == [2, 4, 8]
    assert [s.index for s in sp.outermost("mstep.")] == [0, 7]
    m0, m1 = sp.outermost("mstep.")
    assert [s.index for s in sp.inside(m0, "q.")] == [2, 4]
    assert [s.index for s in sp.inside(m1, "q.")] == [8]
    assert [a.index for a in sp.ancestors(sp.by_index[3])] == [2, 1, 0]


def test_launches_counted_on_the_spans_thread(sp):
    q = sp.by_index
    assert sp.launches_in(q[2]) == 3  # 11, 13, 29; not the nested span twice
    assert sp.launches_in(q[4]) == 1  # 41 on thread 7; 42 ran on thread 9
    assert sp.launches_in(q[8]) == 1


class _Event:
    def __init__(self, name, dev, start, dur, tid=7, annotation=False):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._t, self._a = tid, annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def device_resource_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_events_drop_user_annotations_and_the_benchmarks_ranges():
    prof = _prof([
        _Event("segment_ops_kernel", "CUDA", 10, 5),
        _Event("smcpp.range", "CUDA", 0, 100, annotation=True),
        _Event("portbench.estep", "CUDA", 0, 100),
        _Event("portbench.estep", "CPU", 0, 100),
        _Event("cudaLaunchKernel", "CPU", 8, 1),
        _Event("cuLaunchKernelEx", "CPU", 9, 1, tid=3),
        _Event("aten::mm", "CPU", 1, 50),
    ])
    device, launches, bench = progtrace.events(prof)
    assert device == [(10, 15)]
    assert launches == [(8, 7), (9, 3)]
    assert bench == [(0, 100, "estep")]


def _run(spans, device, launches):
    run = types.SimpleNamespace(trace=None)
    run._progtrace = progtrace.Spans(spans, device, launches)
    return run


def _metric(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py")).read


def test_fit_metrics_read_the_spans():
    run = _run(SPANS, DEVICE, LAUNCHES)
    # M-steps 0-100 (busy 25) and 210-260 (busy 0)
    assert _metric("mstep_idle.fit")(run) == pytest.approx(100 * (1 - 25 / 150))
    assert _metric("q_launches.fit")(run) == pytest.approx((3 + 1 + 1) / 3)
    assert _metric("q_evals_per_iter.fit")(run) == pytest.approx(3 / 2)
    # (100 - 20 - 20) and (50 - 10), in ms
    assert _metric("mstep_host_ms.fit")(run) == pytest.approx(1e-6 * (60 + 40) / 2)


def test_q_metrics_count_only_the_msteps_evaluations():
    # a Q evaluation outside every M-step (an E-step's, say) is no M-step's
    spans = SPANS + [(9, "q.batch64", 150, 160, 5, 7)]
    run = _run(spans, DEVICE, LAUNCHES + [(151, 7), (152, 7)])
    assert [s.index for s in progtrace.q_evals(run._progtrace)] == [2, 4, 8]
    assert _metric("q_launches.fit")(run) == pytest.approx((3 + 1 + 1) / 3)
    assert _metric("q_evals_per_iter.fit")(run) == pytest.approx(3 / 2)


def test_posterior_metrics_read_the_spans():
    spans = [
        (0, "decode.rows", 0, 100, -1, 1),
        (1, "gammas", 10, 90, 0, 1),
        (2, "viterbi.windows", 100, 150, -1, 1),
        (3, "posterior.quantiles", 150, 160, -1, 1),
        (4, "posterior.quantiles", 160, 164, -1, 1),
        (5, "decode.rows", 200, 300, -1, 1),
        (6, "viterbi.windows", 300, 340, -1, 1),
        (7, "posterior.quantiles", 340, 346, -1, 1),
    ]
    run = _run(spans, [(20, 80), (110, 140), (210, 300)], [])
    assert _metric("decode_idle_ms.posterior")(run) == pytest.approx(1e-6 * (40 + 10) / 2)
    assert _metric("viterbi_idle_ms.posterior")(run) == pytest.approx(1e-6 * (20 + 40) / 2)
    assert _metric("quantiles_host_ms.posterior")(run) == pytest.approx(1e-6 * 20 / 2)


@pytest.mark.parametrize("name", [
    "mstep_idle.fit", "q_launches.fit", "q_evals_per_iter.fit", "mstep_host_ms.fit",
    "decode_idle_ms.posterior", "viterbi_idle_ms.posterior",
    "quantiles_host_ms.posterior"])
def test_metrics_read_nothing_without_a_trace_or_spans(name):
    assert _metric(name)(types.SimpleNamespace(trace=None)) is None
    assert _metric(name)(_run([], [], [])) is None
