"""The one-population Q programs as captured CUDA graphs
(smcpp_tpu_torch/inference/qgraph.py) and the resident constants they read
(smcpp_tpu_torch/ops/qconst.py).

On the CPU the capture is stood in for by ``_Emulated``: the program's
aten operations are recorded once (as a capture records kernels) and run
again on replay with every Python number as recorded and every tensor the
program did not make itself by identity, as a graph reads the same memory.
A replay whose program read a tensor the manager later replaces, or a
Python number that has changed, gives stale values there as it would on
the card; host data entering the program (``aten.lift_fresh``, an array
turned into a tensor, what a capture refuses on the card) or a read of a
device value on the host (``aten._local_scalar_dense``) fails the stand-in
capture.  The ``cuda`` tests hold the real graphs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_qgraph.py

Replay against eager: bit for bit (the same kernels on the same inputs).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from smcpp_tpu_torch import trace
from smcpp_tpu_torch.inference import estimation as est
from smcpp_tpu_torch.inference import manager as mg
from smcpp_tpu_torch.inference import qgraph
from smcpp_tpu_torch.models import SMCModel, SMCTwoPopulationModel
from smcpp_tpu_torch.ops import qconst

torch.set_num_threads(1)


# -- the stand-in capture ---------------------------------------------------------

class _Recorder(TorchDispatchMode):
    "The aten operations of a program, with their arguments and outputs."

    REFUSED = ("aten.lift_fresh", "aten._local_scalar_dense")

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if str(func).startswith(self.REFUSED):
            raise RuntimeError(f"{func} inside a captured program")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class _Emulated:
    "A CPU stand-in for ``qgraph._Graph`` (module docstring)."

    def __init__(self, fn, inputs, device):
        self.dev = [torch.as_tensor(np.asarray(x, np.float64), device=device).clone()
                    for x in inputs]
        with _Recorder() as r:
            self.out = fn(*self.dev)
        self.ops = r.ops

    def replay(self, inputs):
        for d, x in zip(self.dev, inputs):
            d.copy_(torch.as_tensor(np.asarray(x, np.float64)))
        env = {}
        sub = lambda x: env.get(id(x), x) if torch.is_tensor(x) else x  # noqa: E731
        for func, args, kwargs, out in self.ops:
            new = func(*tree_map(sub, args), **tree_map(sub, kwargs))
            for o, v in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                if torch.is_tensor(o):
                    env[id(o)] = v
        for o in tree_flatten(self.out)[0]:
            o.copy_(env[id(o)])
        return self.out


def _emulate(qg):
    "``qg`` captures on the CPU through the stand-in."
    qg.capture_on = True
    qg._capture = lambda fn, inputs: _Emulated(fn, inputs, qg.device)
    return qg


# -- the cache's policy -----------------------------------------------------------

def _double(x):
    return 2.0 * x


def test_a_key_runs_eagerly_then_is_captured_then_replays():
    qg = _emulate(qgraph.QGraphs("cpu"))
    for i, want in enumerate([(0, 1, 0), (1, 1, 1), (1, 1, 2), (1, 1, 3)]):
        x = np.arange(3.0) + i
        np.testing.assert_array_equal(qg.run("k", _double, (x,)).numpy(), 2 * x)
        assert (qg.captures, qg.eager, qg.replays) == want
    assert len(qg) == 1


def test_keys_are_apart_and_the_least_recent_goes_past_the_cap():
    qg = _emulate(qgraph.QGraphs("cpu", cap=2))
    for k in "ab" * 2 + "c" * 2:
        qg.run(k, _double, (np.ones(2),))
    assert list(qg._graphs) == ["b", "c"] and qg.captures == 3
    # a dropped key starts again from its first sighting
    qg.run("a", _double, (np.ones(2),))
    assert qg.eager == 4 and qg.captures == 3


def test_clear_forgets_graphs_and_sightings():
    qg = _emulate(qgraph.QGraphs("cpu"))
    for _ in range(2):
        qg.run("a", _double, (np.ones(2),))
    qg.run("b", _double, (np.ones(2),))
    qg.clear()
    qg.run("b", _double, (np.ones(2),))
    assert len(qg) == 0 and qg.eager == 3


def test_copy_returns_copies_of_a_replay():
    qg = _emulate(qgraph.QGraphs("cpu"))
    outs = [qg.run("k", lambda x: (x + 1, x * 3), (np.full(2, float(i)),), copy=True)
            for i in range(3)]
    assert [float(o[1][0]) for o in outs] == [0.0, 3.0, 6.0]


def test_the_cpu_runs_every_call_eagerly():
    qg = qgraph.QGraphs("cpu")
    for _ in range(3):
        qg.run("k", _double, (np.ones(2),))
    assert (qg.eager, qg.captures, qg.replays, len(qg)) == (3, 0, 0, 0)


def test_capture_and_replay_spans(monkeypatch):
    qg = _emulate(qgraph.QGraphs("cpu"))
    names = []

    class _Span:
        def __init__(self, name):
            names.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "span", _Span)
    for _ in range(3):
        qg.run("k", _double, (np.ones(2),))
    assert names == ["q.capture", "q.graph", "q.graph"]


# -- the manager's programs through the stand-in -----------------------------------

N = 12


def _manager(device, spline="piecewise", seed=1, knots=np.logspace(-2, 0.9, 6)):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(300):
        if rng.random() < 0.8:
            rows.append((3, int(rng.integers(0, 2)), 0, 0))
        else:
            rows.append((1, int(rng.integers(0, 3)), int(rng.integers(0, N + 1)), N))
    m = SMCModel(knots, 2e4, spline, ("pop1",))
    m.y[:] = rng.normal(0.0, 0.3, size=len(m.y))
    hs = est.balance_hidden_states(m, 8)
    im = mg.OnePopInferenceManager(N, [np.array(rows, np.int32)], hs, ("pop1",), 0.5,
                                   device=device)
    im.set_model(m)
    im.theta, im.rho, im.alpha = 1e-4, 1e-4, 100
    im._stats = _stats(im, rng)
    return im


def _stats(im, rng):
    "E-statistics of the manager's shapes, positive, about 5e7 in mass."
    M, k = len(im.hidden_states) - 1, im.em_idx.n_keys
    return (rng.dirichlet(np.ones(M)), rng.random((M, M)) * 5e7 / M**2,
            rng.random((k, M)) * 5e7 / (k * M))


def _calls(im, rng):
    "Each program once: its values by name."
    ys = im.model.y[None] + rng.normal(0, 0.1, (5, len(im.model.y)))
    rhos = np.linspace(0.5, 2.0, 5) * 1e-4
    out = {"batch64": im.Q_batch(ys=ys), "batch64_rho": im.Q_batch(ys=ys, rhos=rhos),
           "rho64": im.Q_batch(rhos=rhos),
           "tensors": [x.cpu().numpy() for x in im.tensors()]}
    if im._use_fast_mstep():
        out["batch32"] = im.Q_batch(ys=ys, fast_ok=True)
        out["rho32"] = im.Q_batch(rhos=rhos, fast_ok=True)
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(np.atleast_1d(a[k]) if k != "tensors" else a[k],
                        np.atleast_1d(b[k]) if k != "tensors" else b[k]):
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture
def pair(monkeypatch):
    "Two managers on the same data, one capturing through the stand-in."
    monkeypatch.setattr(mg.OnePopInferenceManager, "_use_fast_mstep",
                        lambda self: not self._joint and self._grid is not None)
    eager, graphed = _manager("cpu"), _manager("cpu")
    _emulate(graphed._qg)
    return eager, graphed


@pytest.mark.parametrize("spline", ["piecewise", "cubic", "pchip", "akima", "bspline"])
def test_replays_equal_eager_values_bit_for_bit(spline, monkeypatch):
    monkeypatch.setattr(mg.OnePopInferenceManager, "_use_fast_mstep",
                        lambda self: not self._joint and self._grid is not None)
    eager, graphed = _manager("cpu", spline), _manager("cpu", spline)
    _emulate(graphed._qg)
    for i in range(3):  # eager, captured, replayed
        _same(_calls(graphed, np.random.default_rng(i)), _calls(eager, np.random.default_rng(i)))
    # five keys (the two f64 batches share one); 18 calls
    qg = graphed._qg
    assert (qg.captures, qg.eager, qg.replays) == (5, 5, 13)


def test_a_chunk_remainder_is_its_own_shape(pair, monkeypatch):
    eager, graphed = pair
    for im in pair:
        monkeypatch.setattr(im, "q_chunk", lambda f32=False: 3)
    ys = graphed.model.y[None] + np.linspace(0, 0.2, 7)[:, None]
    for _ in range(3):
        for fast in (False, True):
            np.testing.assert_array_equal(graphed.Q_batch(ys=ys, fast_ok=fast),
                                          eager.Q_batch(ys=ys, fast_ok=fast))
    assert {k[:2] for k in graphed._qg._graphs} == {
        ("batch64", 3), ("batch64", 1), ("batch32", 3), ("batch32", 1)}


def _warm(graphed, eager):
    "Every program captured and replayed once."
    for i in range(3):
        _calls(graphed, np.random.default_rng(i))
        _calls(eager, np.random.default_rng(i))
    assert graphed._qg.captures == 5


def test_new_statistics_reach_a_captured_program(pair):
    eager, graphed = pair
    _warm(graphed, eager)
    stats = _stats(eager, np.random.default_rng(7))
    eager._stats = stats
    graphed._stats = tuple(s.copy() for s in stats)
    _same(_calls(graphed, np.random.default_rng(9)), _calls(eager, np.random.default_rng(9)))
    assert graphed._qg.captures == 5


@pytest.mark.parametrize("param", ["theta", "alpha"])
def test_a_new_theta_or_alpha_is_a_new_key(pair, param):
    eager, graphed = pair
    _warm(graphed, eager)
    for im in pair:
        setattr(im, param, 2.0 * getattr(im, param))
    eager_count = graphed._qg.eager
    _same(_calls(graphed, np.random.default_rng(9)), _calls(eager, np.random.default_rng(9)))
    assert graphed._qg.eager == eager_count + 5


def test_a_new_grid_drops_the_graphs_and_the_constants(pair):
    eager, graphed = pair
    _warm(graphed, eager)
    bundle = graphed._bundles[torch.float64]
    for im in pair:
        m = SMCModel(np.logspace(-2.2, 1.0, 6), 2e4, "piecewise", ("pop1",))
        m.y[:] = im.model.y
        im.set_model(m)
    assert len(graphed._qg) == 0 and not graphed._bundles
    for i in range(3):
        _same(_calls(graphed, np.random.default_rng(i)), _calls(eager, np.random.default_rng(i)))
    assert graphed._bundles[torch.float64] is not bundle


def test_the_same_model_keeps_the_graphs(pair):
    eager, graphed = pair
    _warm(graphed, eager)
    graphed.set_model(graphed.model)
    assert len(graphed._qg) == 5


def test_a_joint_model_never_captures():
    im = _manager("cpu")
    _emulate(im._qg)
    m2 = SMCModel(np.logspace(-2, 0.9, 6), 2e4, "piecewise", ("pop2",))
    m1 = im.model
    m1._pid = "pop1"
    im.pid = ("pop1",)
    im.set_model(SMCTwoPopulationModel(m1, m2, 0.5))
    for _ in range(3):
        im.tensors()
        im.Q()
    assert im._qg.captures == 0 and len(im._qg) == 0


def test_q_and_its_gradient_stay_eager(pair):
    _, graphed = pair
    for _ in range(3):
        graphed.Q()
        graphed.Q_and_grad()
    assert graphed._qg.captures == 0 and graphed._qg.eager == 0


def test_the_bundle_holds_every_constant_of_a_program():
    "After ``prime`` an evaluation adds nothing to the bundle."
    im = _manager("cpu", "pchip")
    im.Q_batch(ys=im.model.y[None])
    b = im._bundles[torch.float64]
    before = dict(b._memo), dict(vars(b))
    im.Q_batch(ys=np.tile(im.model.y, (2, 1)))
    im.tensors()
    assert dict(b._memo) == before[0] and dict(vars(b)) == before[1]
    # and a fresh bundle gives the same arrays as the primed one
    fresh = qconst.QConsts(b.grid, torch.float64, "cpu")
    for name in qconst.QConsts.GRID:
        assert torch.equal(getattr(fresh, name), getattr(b, name)), name


# -- on the card ------------------------------------------------------------------

def _cuda_pair(monkeypatch, spline="piecewise"):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(mg.OnePopInferenceManager, "_use_fast_mstep",
                        lambda self: not self._joint and self._grid is not None)
    eager, graphed = _manager("cuda", spline), _manager("cuda", spline)
    eager._qg.capture_on = False
    return eager, graphed


@pytest.fixture
def cuda_pair(monkeypatch):
    return _cuda_pair(monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("spline", ["piecewise", "cubic", "bspline"])
def test_card_replays_equal_eager_bit_for_bit(spline, monkeypatch):
    """Every program, a full chunk and a remainder of each batch: replay
    against eager on the card, bit for bit."""
    eager, graphed = pair = _cuda_pair(monkeypatch, spline)
    for im in pair:
        monkeypatch.setattr(im, "q_chunk", lambda f32=False: 4)
    for i in range(4):
        _same(_calls(graphed, np.random.default_rng(i)), _calls(eager, np.random.default_rng(i)))
    # seven keys (4 and 1 rows of each batch; the two f64 batches share
    # theirs), 36 calls
    qg = graphed._qg
    assert (qg.captures, qg.eager, qg.replays, len(qg)) == (7, 7, 29, 7)
    assert eager._qg.captures == 0


@pytest.mark.cuda
def test_card_stale_capture_traps(cuda_pair):
    eager, graphed = cuda_pair
    for i in range(3):
        _calls(graphed, np.random.default_rng(i))
    stats = _stats(eager, np.random.default_rng(7))
    eager._stats, graphed._stats = stats, tuple(s.copy() for s in stats)
    _same(_calls(graphed, np.random.default_rng(8)), _calls(eager, np.random.default_rng(8)))
    for im in cuda_pair:
        im.theta *= 2.0
    _same(_calls(graphed, np.random.default_rng(9)), _calls(eager, np.random.default_rng(9)))
    for im in cuda_pair:
        m = SMCModel(np.logspace(-2.2, 1.0, 6), 2e4, "piecewise", ("pop1",))
        m.y[:] = im.model.y
        im.set_model(m)
    for i in range(3):
        _same(_calls(graphed, np.random.default_rng(i)), _calls(eager, np.random.default_rng(i)))


@pytest.mark.cuda
def test_card_replay_copies_only_its_inputs_and_the_profiler_sees_its_kernels(cuda_pair):
    """Under torch.profiler, captured there: a replayed batch's only
    host-to-device copies are its two inputs, and its kernels appear among
    the profiler's device events."""
    _, graphed = cuda_pair
    ys = np.tile(graphed.model.y, (3, 1))
    graphed.Q_batch(ys=ys)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        graphed.Q_batch(ys=ys)  # captured under the profiler
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        graphed.Q_batch(ys=ys)
        torch.cuda.synchronize()
    assert graphed._qg.captures == 1 and graphed._qg.replays == 2
    names = [e.name for e in prof.events()]
    h2d = [n for n in names if "HtoD" in n]
    assert len(h2d) == 2, h2d
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy" not in e.name and "Memset" not in e.name]
    assert len(kernels) > 100
    assert not any("LaunchKernel" in n for n in names)
