"""The port's f32 M-step (the optimizer's coarse Q batches as f32 programs on
a GPU: manager ``_use_fast_mstep``, ``_tensors32``, ``Q_batch(fast_ok=True)``)
against its own f64 objective and the JAX package's ``_setup_fast``
programs, on the CPU; the tests of tests/test_f32_setup.py through the
port.

The f32 programs are built and run here on CPU tensors (the gate keeps them
off the CPU, so the tests that run them open it by hand): the same f32 grid
(TimeGrid.astype, terminal width 1e25), the same dtype-following constants,
the same f64 sums.  The bar is the JAX test's: on statistics scaled to 5e7
in mass, max |v32 - v64| < max(1e-3 * median |diff v64|, 1e-5 * max |v64|)
and the same argmax, at n = 30 (the JAX test's width) and n = 50 (past the
size gate at the defaults' K = 113).
"""

import argparse
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from smcpp_tpu.inference import estimation as jest  # noqa: E402
from smcpp_tpu.inference.manager import OnePopInferenceManager as JaxIM  # noqa: E402
from smcpp_tpu.models import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu.ops import grid as jgrid  # noqa: E402
from smcpp_tpu_torch.data.simulate import write_simulated  # noqa: E402
from smcpp_tpu_torch.inference import analysis as an  # noqa: E402
from smcpp_tpu_torch.inference import manager as mg  # noqa: E402
from smcpp_tpu_torch.inference.optimizer import SMCPPOptimizer  # noqa: E402
from smcpp_tpu_torch.models import SMCModel  # noqa: E402
from smcpp_tpu_torch.ops import grid as grid_mod  # noqa: E402

jax.config.update("jax_enable_x64", True)


def _data(n):
    "tests/test_f32_setup.py:_make_im's rows and model draws."
    rng = np.random.default_rng(1)
    rows = []
    for _ in range(300):
        if rng.random() < 0.8:
            rows.append((3, int(rng.integers(0, 2)), 0, 0))
        else:
            rows.append(
                (1, int(rng.integers(0, 3)), int(rng.integers(0, n + 1)), n)
            )
    return [np.array(rows, dtype=np.int32)] * 2, rng


@pytest.fixture(scope="module", params=[30, 50], ids=["n30", "n50"])
def pair(request):
    """The JAX test's manager (n, M = 12) and the port's on the same data,
    model and hidden states, with the JAX E-step's statistics scaled to 5e7
    in mass, as test_fast_q_matches_f64 scales them."""
    n = request.param
    data, rng = _data(n)
    jm = JaxModel(np.logspace(-2, 0.9, 8), 2e4, "piecewise", ("pop1",))
    jm.y[:] = rng.normal(0.0, 0.3, size=len(jm.y))
    hs = jest.balance_hidden_states(jm, 12)
    jim = JaxIM(n, data, hs, ("pop1",), 0.5,
                compute_device=jax.devices("cpu")[0])
    jim.set_model(jm)
    jim.theta, jim.rho, jim.alpha = 1e-4, 1e-4, 100
    jim.E_step()
    g0, xi, gs = jim._stats
    scale = 5e7 / gs.sum()
    jim._stats = (g0, xi * scale, gs * scale)
    tm = SMCModel(np.logspace(-2, 0.9, 8), 2e4, "piecewise", ("pop1",))
    tm.y = np.array(jm.y)
    tim = mg.OnePopInferenceManager(n, data, hs, ("pop1",), 0.5, device="cpu")
    tim.set_model(tm)
    tim.theta, tim.rho, tim.alpha = 1e-4, 1e-4, 100
    tim._stats = tuple(np.asarray(s) for s in jim._stats)
    return jim, tim


def _rule(v32, v64):
    "JAX's bar (tests/test_f32_setup.py:71-73): error far below the signal."
    sig = np.median(np.abs(np.diff(v64)))
    assert np.max(np.abs(v32 - v64)) < max(1e-3 * sig, 1e-5 * np.abs(v64).max())
    assert int(np.argmax(v32)) == int(np.argmax(v64))


def _opened(im, monkeypatch):
    "The gate opened on the CPU, where it is closed."
    monkeypatch.setattr(im, "_use_fast_mstep", lambda: True)


def test_grid_astype():
    g = grid_mod.make_time_grid(np.logspace(-2, 1, 5), [0.0, 0.1, 1.0, np.inf])
    g32 = g.astype(np.float32)
    assert g32.dt.dtype == np.float32
    assert np.isfinite(g32.dt[-1]) and g32.dt[-1] <= 1e25
    assert g32.segment_matrix().dtype == np.float32
    np.testing.assert_array_equal(g32.src, g.src)
    np.testing.assert_array_equal(g32.hs_indices, g.hs_indices)
    assert g.astype(np.float64) is g
    j32 = jgrid.make_time_grid(np.logspace(-2, 1, 5),
                               [0.0, 0.1, 1.0, np.inf]).astype(np.float32)
    for f in ("ts", "dt", "hidden_states"):
        np.testing.assert_array_equal(getattr(g32, f), getattr(j32, f))


def test_fast_q_matches_f64_and_jax(pair, monkeypatch):
    """The f32 batch and rho batch against the port's f64 values and
    against JAX's ``_setup_fast`` programs on the same statistics."""
    jim, tim = pair
    _opened(tim, monkeypatch)
    m = tim.model
    B = 16
    ys = np.tile(m.y, (B, 1))
    ys[:, 4] = np.linspace(-1.5, 1.5, B)
    v64 = tim.Q_batch(ys=ys)
    before = mg.Q_BATCH32.launches
    v32 = tim.Q_batch(ys=ys, fast_ok=True)
    assert mg.Q_BATCH32.launches == before + 1
    _rule(v32, v64)
    y0, th, rho0, al, g0d, xsd, gsd = jim._q_args(None, None, None, None)
    j32 = np.asarray(jim._setup_fast()[0](ys, th, np.full(B, rho0), al, g0d,
                                          xsd, gsd), np.float64)
    _rule(v32, j32)
    _rule(j32, v64)

    rhos = np.geomspace(1e-6, 1e-2, 12)
    r64 = tim.Q_batch(rhos=rhos)
    before = mg.Q_RHO32.launches
    r32 = tim.Q_batch(rhos=rhos, fast_ok=True)
    assert mg.Q_RHO32.launches == before + 1
    _rule(r32, r64)
    rj32 = np.asarray(jim._setup_fast()[1](y0, th, rhos, al, g0d, xsd, gsd),
                      np.float64)
    _rule(r32, rj32)
    _rule(rj32, r64)


def test_tensors32_are_f32(pair):
    """Every output of ``_tensors32`` is f32, finite, of the f64 shapes, and
    holds the f64 tensors and JAX's f32 ones to f32's absolute precision on
    probabilities: atol 1e-6 (T's sub-diagonal entries are differences of
    cumulative sums of O(1), so their f32 error is absolute, about 4 ulp of
    1; measured 2.5e-7 against f64 at n = 30)."""
    jim, tim = pair
    ys = np.tile(tim.model.y, (3, 1))
    out = tim._tensors32(ys, tim.theta, np.full(3, tim.rho), tim.alpha)
    M = len(tim.hidden_states) - 1
    shapes = [(3, M), (3, M, M), (3, tim.em_idx.n_keys, M)]
    for x, shape in zip(out, shapes):
        assert x.dtype == torch.float32 and tuple(x.shape) == shape
        assert torch.all(torch.isfinite(x))
    # T is the f64 transition rounded to f32 (manager._tensors32)
    assert torch.equal(out[1][0], tim.tensors()[1].float())
    j32 = jax.jit(jim._tensors32_traceable())(np.asarray(tim.model.y), tim.theta,
                                     tim.rho, tim.alpha)
    for x, y, j in zip(out, tim.tensors(), j32):
        x = x[0].double().numpy()
        np.testing.assert_allclose(x, y.numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(x, np.asarray(j, np.float64), rtol=1e-4,
                                   atol=1e-6)
    # the rho batch's call: one y, pi and E once, T a candidate rho
    rhos = np.array([0.5, 1.0, 2.0]) * tim.rho
    pi, T, E = tim._tensors32(tim.model.y, tim.theta, rhos, tim.alpha)
    assert [tuple(x.shape) for x in (pi, T, E)] == [s[1:] if i != 1 else s
                                                    for i, s in enumerate(shapes)]
    assert all(x.dtype == torch.float32 for x in (pi, T, E))
    # batched and unbatched contractions may sum in another order: a few
    # ulp of their summands, which cancel in E's smallest entries (measured
    # 1.3e-6 relative at n = 30)
    for x, ref in ((pi, out[0][0]), (E, out[2][0]), (T[1], out[1][0])):
        torch.testing.assert_close(x, ref, rtol=1e-5, atol=0)


class _F64Ops(torch.overrides.TorchFunctionMode):
    "Records every torch call that returns a float64 tensor."

    def __init__(self):
        super().__init__()
        self.f64 = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(torch.is_tensor(o) and o.dtype == torch.float64 for o in outs):
            self.f64.append(getattr(func, "__name__", str(func)))
        return out


def test_no_silent_promotion(pair):
    """Past the spline, no op of the f32 pipeline makes an f64 tensor: every
    constant of ratefunc, the CSFS and its Moran matrices, the emission
    index's W and the transition follows the working dtype (the program
    rounds T from f64, but the transition in f32 stays f32 too)."""
    _, tim = pair
    a = tim.model.stepwise_values_fn(torch.as_tensor(np.tile(tim.model.y, (2, 1))))
    a32, rho32 = a.float(), torch.full((2,), tim.rho, dtype=torch.float32)
    with torch.no_grad(), mg.exact_f32(), _F64Ops() as mode:
        out = tim._tensors_of(a32, tim._grid32(), rho32, float(tim.theta),
                              float(tim.alpha))
    assert mode.f64 == [], sorted(set(mode.f64))
    assert all(x.dtype == torch.float32 for x in out)


def test_exact_calls_stay_f64(pair, monkeypatch):
    """With the gate open, ``fast_ok=False`` batches, Q and Q_and_grad stay
    f64 (the f64 values bit for bit, no f32 program run); a coarse batch
    reaches the f32 programs only while the gate holds."""
    _, tim = pair
    ys = np.tile(tim.model.y, (4, 1)) + np.linspace(0, 0.3, 4)[:, None]
    closed = tim.Q_batch(ys=ys, fast_ok=True)  # the CPU: gate closed
    counts = [p.launches for p in mg.FAST_PROGRAMS]
    _opened(tim, monkeypatch)
    np.testing.assert_array_equal(tim.Q_batch(ys=ys), closed)
    np.testing.assert_array_equal(tim.Q_batch(rhos=[1e-4, 2e-4]),
                                  tim.Q_batch(rhos=[1e-4, 2e-4], fast_ok=False))
    q, g = tim.Q_and_grad(y=ys[1])
    np.testing.assert_allclose([tim.Q(y=ys[1]), q], closed[1], rtol=1e-12)
    assert g.dtype == np.float64
    assert [p.launches for p in mg.FAST_PROGRAMS] == counts
    assert not np.array_equal(tim.Q_batch(ys=ys, fast_ok=True), closed)
    assert mg.Q_BATCH32.launches == counts[0] + 1


def test_f32_program_errors_raise(pair, monkeypatch):
    "An f32 program that raises makes the call raise: no quiet f64 retry."
    _, tim = pair
    _opened(tim, monkeypatch)

    def broken():
        raise RuntimeError("f32 grid broken")

    monkeypatch.setattr(tim, "_grid32", broken)
    with pytest.raises(RuntimeError, match="f32 grid broken"):
        tim.Q_batch(ys=np.tile(tim.model.y, (2, 1)), fast_ok=True)
    with pytest.raises(RuntimeError, match="f32 grid broken"):
        tim.Q_batch(rhos=[1e-4], fast_ok=True)


# -- the gate: JAX's manager.py:1105-1125, case by case ---------------------

def _fake(pkg, n, K, device, joint=False, grid=True):
    "A manager of either package holding only what the gate reads."
    cls = mg.OnePopInferenceManager if pkg == "torch" else JaxIM
    im = cls.__new__(cls)
    im.n, im._joint = n, joint
    im._grid = SimpleNamespace(K=K) if grid else None
    if pkg == "torch":
        im._device = torch.device(device)  # a device object, no card needed
    else:
        im._device = SimpleNamespace(platform="cpu" if device == "cpu" else "gpu")
    return im


@pytest.mark.parametrize("n,K,device,joint,grid,want", [
    (50, 113, "cuda", True, True, False),       # a joint model
    (50, 113, "cuda", False, False, False),     # no grid yet
    (50, 113, "cpu", False, True, False),       # the CPU, past the size
    (4, 20, "cuda", False, True, False),        # 400 < 50,000
    (50, 113, "cuda", False, True, True),       # 288,150 >= 50,000
    (20, 113, "cuda", False, True, False),      # 47,460 < 50,000
    (21, 113, "cuda", False, True, True),       # 52,206: where K = 113 opens
    (0, 113, "cuda", False, True, False),       # max(n, 1)
], ids=["joint", "no-grid", "cpu", "small", "n50", "n20", "n21", "n0"])
def test_gate_cases_match_jax(monkeypatch, n, K, device, joint, grid, want):
    """The port's gate decides as JAX's (manager.py:1105-1125) wherever
    JAX's SMCPP_TPU_FAST_MSTEP is unset; the port does not read it."""
    monkeypatch.delenv("SMCPP_TPU_FAST_MSTEP", raising=False)
    assert mg.OnePopInferenceManager.FAST_MSTEP_MIN_WORK == JaxIM.FAST_MSTEP_MIN_WORK
    got = _fake("torch", n, K, device, joint, grid)._use_fast_mstep()
    assert got == _fake("jax", n, K, device, joint, grid)._use_fast_mstep()
    assert got is want


@pytest.mark.parametrize("env", ["0", "1force"])
def test_gate_reads_no_switch(monkeypatch, env):
    """JAX's SMCPP_TPU_FAST_MSTEP (=0 off, =1force past the size gate) is
    not ported: the port's gate rests on the device and the size alone
    (ROADMAP C)."""
    monkeypatch.setenv("SMCPP_TPU_FAST_MSTEP", env)
    for n, want in ((50, True), (4, False)):
        assert _fake("torch", n, 113 if n == 50 else 20, "cuda")._use_fast_mstep() is want


def test_fast_routing_gates(pair, monkeypatch):
    """A real manager on the CPU keeps the gate closed, past the size too:
    the f64 objective is exact there."""
    _, tim = pair
    assert not tim._use_fast_mstep()
    monkeypatch.setattr(mg.OnePopInferenceManager, "FAST_MSTEP_MIN_WORK", 0)
    assert not tim._use_fast_mstep()


# -- the chunk plan -----------------------------------------------------------

def test_q_chunk_plan(pair, monkeypatch):
    """Rows of a chunk from the per-candidate bytes at the program's dtype
    against the Q budget (``_q_budget``, set by hand here), which the
    E-stream's SMCPP_TPU_ESTREAM_BYTES does not reach; chunking changes no
    value."""
    _, tim = pair
    n, K, nk, M = tim.n, tim._grid.K, tim.em_idx.n_keys, tim._grid.M
    per64 = 8 * mg.Q_LIVE * ((n + 1) * n * K + nk * M + M * M)
    assert mg.q_chunk_rows(n, K, nk, M, 8, 10 * per64) == 10
    assert mg.q_chunk_rows(n, K, nk, M, 4, 10 * per64) == 20
    assert mg.q_chunk_rows(n, K, nk, M, 8, per64 - 1) == 1
    # the defaults' widths: n = 200, K = 113 fits 51 f64 candidates in 37.5%
    # of an 80 GB card, where the fixed 64 rows needed more
    assert mg.q_chunk_rows(200, 113, 603, 15, 8, 0.375 * 80e9) == 51
    ys = np.tile(tim.model.y, (7, 1)) + np.linspace(-0.4, 0.4, 7)[:, None]
    whole = tim.Q_batch(ys=ys)
    rows = tim.q_chunk(), tim.q_chunk(f32=True)
    monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", "1")
    assert (tim.q_chunk(), tim.q_chunk(f32=True)) == rows
    monkeypatch.setattr(tim, "_q_budget", lambda: 3 * per64)
    assert tim.q_chunk() == 3 and tim.q_chunk(f32=True) == 6
    np.testing.assert_allclose(tim.Q_batch(ys=ys), whole, rtol=1e-13)


# -- a short fit with the f32 programs -------------------------------------------

@pytest.fixture(scope="module")
def sim_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fast_sim")
    m = SMCModel([0.01, 0.1, 1.0, 5.0], 1e4, "piecewise")
    m.y[:] = np.log([1.0, 0.3, 1.0, 2.0])
    files = []
    for i in range(2):
        fn = str(d / f"sim{i}.smc.gz")
        write_simulated(fn, m, 2e-4, 2e-4, L=1_000_000, n=10, seed=i)
        files.append(fn)
    return files


def _args(**kw):
    "estimate's arguments at its defaults, on the CPU (test_torch_estimate)."
    d = dict(
        mu=1.25e-8, r=None, em_iterations=1, knots=8, spline="piecewise",
        polarization_error=0.5, unfold=False, w=100, thinning=None,
        timepoints=None, outdir=None, base="model", algorithm="L-BFGS-B",
        xtol=0.1, ftol=1e-4, regularization_penalty=6, lambda_=None,
        nonseg_cutoff=None, multi=False, cores=None, seed=0, device="cpu",
        precision=None,
    )
    d.update(kw)
    return argparse.Namespace(**d)


EM_ITERS = 3


def _fit(files, fast, monkeypatch):
    if fast:
        monkeypatch.setattr(mg.OnePopInferenceManager, "_use_fast_mstep",
                            lambda self: not self._joint and self._grid is not None)
    before = [p.launches for p in mg.FAST_PROGRAMS]
    np.random.seed(0)
    a = an.Analysis(files, _args(em_iterations=EM_ITERS, precision="highest"))
    a.run(EM_ITERS)
    monkeypatch.undo()
    ran = [p.launches - b for p, b in zip(mg.FAST_PROGRAMS, before)]
    return a, ran


def test_short_fit_with_f32_programs(sim_files, monkeypatch):
    """Stage 1 and three EM iterations with every coarse batch in f32,
    beside the f64 fit on the same data, both with the E-step at 'highest'
    (a climb of the E-step's precision ladder in one fit and not the other
    would move its log-likelihood by itself).  The f32 values only position
    the bracketing grids and every accept is an f64 comparison, so the fits
    differ only where the searches stop: the log-likelihoods agree within
    1e-4 relative, the EM's own ftol, the level at which it calls two values
    the same (measured 6.2e-7; 3.6e-7 and 1.7e-6 on two other seeds).  The
    knots are not compared: on 2 Mbp the ancient knots lie past most of the
    data's coalescences, flat directions of Q where two fits of the same
    likelihood stop apart."""
    a64, ran64 = _fit(sim_files, False, monkeypatch)
    a32, ran32 = _fit(sim_files, True, monkeypatch)
    assert ran64 == [0, 0] and ran32[0] > 0
    ll64, ll32 = a64.loglik(), a32.loglik()
    assert np.isfinite(ll32) and np.all(np.isfinite(a32._model.y))
    assert abs(ll32 - ll64) <= 1e-4 * abs(ll64), (ll32, ll64)


# -- the optimizer's coarse rounds (tests/test_f32_setup.py:98-215) ------------

def _bare_opt():
    return SMCPPOptimizer.__new__(SMCPPOptimizer)


def test_batched_argmax_coarse_never_decides():
    """The shrinking-grid search may bracket with a noisy 'coarse'
    objective but makes every decision from exact evaluations: a
    +10-biased coarse round must not leak into the returned optimum."""
    opt = _bare_opt()
    calls = {"coarse": 0, "exact": 0}

    def f(xs, coarse=False):
        xs = np.asarray(xs, float)
        v = -((xs - 0.3) ** 2)
        if coarse:
            calls["coarse"] += 1
            return v + 10.0
        calls["exact"] += 1
        return v

    x, val = opt._batched_argmax(f, -3.0, 3.0, xatol=1e-3)
    assert abs(x - 0.3) < 1e-2
    assert val <= 0.0 + 1e-12
    assert calls["coarse"] == 1 and calls["exact"] >= 1


def test_batched_argmax_exact_when_no_coarse_consumer():
    "Callers that ignore the coarse flag (pure-f64 paths) still converge."
    opt = _bare_opt()

    def f(xs, coarse=False):
        xs = np.asarray(xs, float)
        return -np.abs(xs - 1.234) ** 1.5

    x, _ = opt._batched_argmax(f, -3.0, 3.0, xatol=1e-3)
    assert abs(x - 1.234) < 5e-3


def test_batched_argmax_prefetched_bracket():
    """A prefetched coarse bracket replaces the round-0 dispatch: no coarse
    evaluation is issued, and the returned value comes from exact
    evaluations only."""
    opt = _bare_opt()
    calls = {"coarse": 0, "exact": 0}

    def f(xs, coarse=False):
        xs = np.asarray(xs, float)
        calls["coarse" if coarse else "exact"] += 1
        return -((xs - 0.3) ** 2) + (10.0 if coarse else 0.0)

    xs0 = np.linspace(-3.0, 3.0, opt._BATCH)
    v0 = -((xs0 - 0.35) ** 2) + 7.0
    x, val = opt._batched_argmax(f, -3.0, 3.0, xatol=1e-3, coarse0=(xs0, v0))
    assert abs(x - 0.3) < 1e-2
    assert val <= 1e-12
    assert calls["coarse"] == 0 and calls["exact"] >= 1


def test_batched_argmax_prefetch_edge_rejected():
    "An edge-argmax prefetched bracket is rejected: a fresh coarse round runs."
    opt = _bare_opt()
    calls = {"coarse": 0}

    def f(xs, coarse=False):
        xs = np.asarray(xs, float)
        if coarse:
            calls["coarse"] += 1
        return -((xs - 0.3) ** 2)

    xs0 = np.linspace(-3.0, 3.0, opt._BATCH)
    x, _ = opt._batched_argmax(f, -3.0, 3.0, xatol=1e-3, coarse0=(xs0, xs0.copy()))
    assert calls["coarse"] == 1
    assert abs(x - 0.3) < 1e-2


def test_prefetch_coarse_grids_match_scalar_windows():
    """_prefetch_coarse builds, for each coordinate with a trust radius,
    the grid the scalar search would evaluate in its round 0, in ONE
    batched coarse Q call."""

    class A:
        model = SimpleNamespace(K=3, y=np.array([0.1, -0.2, 0.4]))
        has_fast_batch = True

        def __init__(self):
            self.calls = []

        def Q_batch(self, ys=None, rhos=None, coarse=False):
            self.calls.append((np.asarray(ys).shape, coarse))
            return -np.sum((np.asarray(ys) - 0.25) ** 2, axis=1)

    a = A()
    opt = SMCPPOptimizer(a, single=True)
    opt._radius = {0: 0.5, 2: 1.0}
    pf = opt._prefetch_coarse()
    assert set(pf) == {0, 2}
    assert a.calls == [((2 * opt._BATCH, 3), True)]
    for k in (0, 2):
        lo, hi = opt._scalar_window(k, a.model.y[k])
        xs, vals = pf[k]
        np.testing.assert_allclose(xs, np.linspace(lo, hi, opt._BATCH))
        assert len(vals) == opt._BATCH
