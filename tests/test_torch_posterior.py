"""The port's posterior (gamma decode and MAP paths, plain PyTorch versions
of K2g, K4 and K5 and the glue around them) against smcpp_tpu, on the CPU.

Inputs are made from a seed with NumPy and handed to both packages.
Bounds and why:

* float64: the same recursions summed in another order: 1e-12, and MAP
  paths exactly equal;
* float32 sweeps at 'highest': rtol 1e-5 (the bound of
  tests/test_torch_window_kernel.py);
* the max-plus operators (phase A): adds and maxima only, but log T and
  log E come from two libraries' f32 logarithms, an ulp apart at most, and
  each of the L steps adds such a term: rtol 1e-6 and an absolute bound of
  L ulps of the O(1) scores;
* float32 MAP paths: at least 99.9% of rows equal (a near-tie can flip, as
  tests/test_decode.py:486-487 allows);
* row gammas: differences of f32 prefix sums within blocks of
  PREFIX_BLOCK windows, summed in another order by XLA: rtol 1e-5 and an
  absolute bound of a few f32 ulps of the block prefix.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.commands import main as jax_main  # noqa: E402
from smcpp_tpu.data.simulate import write_simulated  # noqa: E402
from smcpp_tpu.inference import estimation as jax_est  # noqa: E402
from smcpp_tpu.inference.manager import (  # noqa: E402
    OnePopInferenceManager as JaxManager,
)
from smcpp_tpu.models import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.commands import main as torch_main  # noqa: E402
from smcpp_tpu_torch.inference import manager as torch_manager  # noqa: E402
from smcpp_tpu_torch.models import SMCModel as TorchModel  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

jax.config.update("jax_enable_x64", True)

# a few f32 ulps of the largest within-block prefix (PREFIX_BLOCK windows)
PREFIX_ATOL = 4 * twk.PREFIX_BLOCK * 2.0**-24


def _sweep_problem(seed, S, L, M, n_keys, dtype):
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M).astype(dtype)
    E = rng.uniform(0.05, 1.0, (n_keys, M)).astype(dtype)
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.9
    valid[-2:, L // 3:] = False  # ragged contig tails
    A_in = rng.rand(S, M).astype(dtype)
    Q_end = rng.rand(S, M).astype(dtype)
    return T, E, keys, valid, A_in, Q_end


def _close(got, want, rtol, atol_frac=0.0, atol=0.0):
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=max(atol, atol_frac * max(np.abs(want).max(), 1e-300)),
    )


@pytest.mark.parametrize("M", [5, 16, 32])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_stats_pass_emit_gamma(M, dtype, rtol):
    args = _sweep_problem(0, 6, 64, M, 40, dtype)
    ref = jwk.stats_pass(*map(jnp.asarray, args), None, precision="highest",
                         emit_gamma=True)
    got = twk.stats_pass(*map(torch.as_tensor, args), precision="highest",
                         emit_gamma=True)
    assert len(got) == 5
    for g, r in zip(got[:4], ref[:4]):
        _close(g, r, rtol, 1e-8 if dtype == np.float32 else 1e-14)
    gam = got[4]
    assert gam.shape == (6, 64, M) and gam.dtype == torch.from_numpy(args[0]).dtype
    # the reference's stream is (L, M, S); the port's (S, L, M)
    _close(gam, np.transpose(np.asarray(ref[4]), (2, 0, 1)), rtol,
           1e-8 if dtype == np.float32 else 1e-14)
    valid = args[3]
    np.testing.assert_allclose(gam.sum(-1).numpy()[valid], 1.0, rtol=1e-5)
    assert np.all(gam.numpy()[~valid] == 0)


def _packed(seed, M=6, n_keys=9, rows=(300, 180), dtype=np.float32):
    """Span-compressed rows of two contigs, packed to windows as the manager
    packs them, with the row spans and model tensors."""
    rng = np.random.RandomState(seed)
    data = []
    for n_rows in rows:
        d = np.zeros((n_rows, 2), np.int64)
        d[:, 0] = rng.randint(1, 12, n_rows)
        d[:, 1] = rng.randint(0, n_keys, n_rows)
        data.append(d)
    key_id = {(k,): k for k in range(n_keys)}
    keys, valid, soc = twk.pack_windows(data, key_id, seg_target=8, min_seg_len=64)
    spans = [d[:, 0] for d in data]
    pi = rng.dirichlet(np.ones(M)).astype(dtype)
    T = (rng.dirichlet(np.ones(M) * 4, size=M) + np.eye(M) * 4).astype(dtype)
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.02, 1.0, (n_keys, M)).astype(dtype)
    return pi, T, E, keys, valid, soc, spans


def test_pack_window_rows_match_jax():
    *_, keys, valid, soc, spans = _packed(1)
    L = keys.shape[1]
    ends = twk.pack_window_row_ends(spans, L, soc)
    assert ends.dtype == np.int64
    np.testing.assert_array_equal(ends, jwk.pack_window_row_ends(spans, L, soc))
    rid, n = twk.pack_window_row_ids(spans, L, soc)
    rid_j, n_j = jwk.pack_window_row_ids(spans, L, soc)
    assert n == n_j == sum(len(s) for s in spans)
    np.testing.assert_array_equal(rid, rid_j)
    # each row's last window carries its own row id
    np.testing.assert_array_equal(rid.reshape(-1)[ends], np.arange(n))


@pytest.mark.parametrize("M", [6, 16])
def test_decode_gammas_windows(M):
    pi, T, E, keys, valid, soc, spans = _packed(2, M=M)
    ends = twk.pack_window_row_ends(spans, keys.shape[1], soc)
    ll_j, g_j = jwk.decode_gammas_windows(
        *map(jnp.asarray, (pi, T, E, keys, valid)), soc, jnp.asarray(ends)
    )
    ll, g = twk.decode_gammas_windows(
        *map(torch.as_tensor, (pi, T, E, keys, valid)), soc, torch.as_tensor(ends)
    )
    _close(ll, ll_j, 1e-5)
    assert g.dtype == torch.float32 and g.shape == (len(ends), M)
    _close(g, g_j, 1e-5, atol=PREFIX_ATOL)
    np.testing.assert_allclose(g.sum(1).numpy(), np.concatenate(spans), rtol=1e-4)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 0.0)])
def test_viterbi_segment_ops(dtype, rtol):
    T, E, keys, valid, _, _ = _sweep_problem(3, 6, 64, 16, 40, dtype)
    ref = jwk.viterbi_segment_ops(*map(jnp.asarray, (T, E, keys, valid)))
    got = twk.viterbi_segment_ops(*map(torch.as_tensor, (T, E, keys, valid)))
    assert got.shape == (6, 16, 16)
    # entries are O(1) log scores and the -1e30 sentinel
    _close(got, ref, rtol, atol=0.0 if dtype == np.float64 else 64 * 2.0**-23)


def _vit_inputs(seed, dtype):
    pi, T, E, keys, valid, soc, spans = _packed(seed, M=8, dtype=dtype)
    ends = twk.pack_window_row_ends(spans, keys.shape[1], soc)
    return pi, T, E, keys, valid, soc, ends


def _agree(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if dtype == np.float64:
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_viterbi_boundary_states(dtype):
    pi, T, E, keys, valid, soc, _ = _vit_inputs(4, dtype)
    W_j = jwk.viterbi_segment_ops(*map(jnp.asarray, (T, E, keys, valid)))
    ref = jwk.viterbi_boundary_states(jnp.asarray(pi), W_j, soc)
    # the same operators on both sides, so phase B alone is compared
    got = twk.viterbi_boundary_states(torch.as_tensor(pi),
                                      torch.as_tensor(np.array(W_j)), soc)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        _agree(g.numpy(), r, dtype)
    # a state with pi == 0 never starts a MAP path
    pi0 = pi.copy()
    pi0[0] = 0
    entry, _ = twk.viterbi_boundary_states(torch.as_tensor(pi0),
                                           torch.as_tensor(np.array(W_j)), soc)
    assert np.all(entry.numpy()[soc[:, 0]] != 0)


@pytest.mark.parametrize("block", [None, 8, 16, 64])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_viterbi_segment_paths(block, dtype):
    _, T, E, keys, valid, _, _ = _vit_inputs(5, dtype)
    S = keys.shape[0]
    rng = np.random.RandomState(6)
    entry, exit_ = (rng.randint(0, 8, S).astype(np.int32) for _ in range(2))
    ref = jwk.viterbi_segment_paths(
        *map(jnp.asarray, (T, E, keys, valid, entry, exit_)), block=block
    )
    got = twk.viterbi_segment_paths(
        *map(torch.as_tensor, (T, E, keys, valid, entry, exit_)), block=block
    )
    assert got.dtype == torch.int32 and got.shape == keys.shape
    # the reference's paths are (L, S); the port's (S, L)
    _agree(got.numpy(), np.asarray(ref).T, dtype)
    if block is not None:  # the blocked mode reproduces the full stream's
        full = twk.viterbi_segment_paths(
            *map(torch.as_tensor, (T, E, keys, valid, entry, exit_))
        )
        assert torch.equal(got, full)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_viterbi_windows(dtype):
    pi, T, E, keys, valid, soc, ends = _vit_inputs(7, dtype)
    ref = jwk.viterbi_windows(*map(jnp.asarray, (pi, T, E, keys, valid)), soc,
                              jnp.asarray(ends))
    got = twk.viterbi_windows(*map(torch.as_tensor, (pi, T, E, keys, valid)),
                              soc, torch.as_tensor(ends))
    assert got.dtype == torch.int32 and got.shape == (len(ends),)
    _agree(got.numpy(), ref, dtype)


# ---------------------------------------------------------------------------
# The manager and the CLI
# ---------------------------------------------------------------------------

def _data(seed, n_rows=240):
    rng = np.random.RandomState(seed)
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 30, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    return data


def _managers(data_list, M=5):
    hs = None
    ims = []
    for Model, make in (
        (JaxModel, lambda hs: JaxManager(2, data_list, hs, ("pop1",), 0.5,
                                         devices=[jax.devices()[0]])),
        (TorchModel, lambda hs: torch_manager.OnePopInferenceManager(
            2, data_list, hs, ("pop1",), 0.5, device="cpu")),
    ):
        m = Model([0.01, 3.0], 20000.0, "piecewise")
        m.y[:] = 0.0
        if hs is None:
            hs = jax_est.balance_hidden_states(m, M + 1)
        im = make(hs)
        im.set_model(m)
        im.theta, im.rho, im.alpha = 1e-4, 1e-4, 1
        ims.append(im)
    return ims


def test_manager_gammas_and_map_paths(monkeypatch):
    # the reference's exact f32 pull (its default pull is f16)
    monkeypatch.setenv("SMCPP_TPU_DECODE_TRANSFER", "f32")
    data_list = [_data(8), _data(9, 150)]
    jim, tim = _managers(data_list)
    assert jim._use_windows and tim._use_windows
    for im in (jim, tim):
        im.save_gamma = True
        im.E_step()
    assert len(tim.gammas) == 2
    for g_t, g_j, d in zip(tim.gammas, jim.gammas, data_list):
        assert g_t.shape == (len(d), 5) and g_t.dtype == np.float32
        np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g_t.sum(1), d[:, 0], rtol=1e-4)
    for p_t, p_j in zip(tim.map_paths(), jim.map_paths()):
        assert p_t.dtype == np.int32
        assert (p_t == p_j).mean() >= 0.999


def test_manager_viterbi_over_budget_streams_blocks(monkeypatch):
    """Between the blocked and the full backpointer stream the manager takes
    the blocked mode (the plain version on the CPU), with the same paths."""
    (tim,) = _managers([_data(10, 200)])[1:]
    full = tim.map_paths()
    L = tim._wkeys.shape[1]
    block = twk.remat_block_size(L)
    lo = tim._window_stream_bytes((block + 4.0 * (L // block)) / L)
    hi = tim._window_stream_bytes(2)
    monkeypatch.setattr(tim, "_hbm_budget", lambda frac=0.375: (lo + hi) / 2)
    assert not tim._window_viterbi_fits()
    for a, b in zip(full, tim.map_paths()):
        np.testing.assert_array_equal(a, b)


def test_manager_m1_closed_form():
    data = _data(11, 50)
    data[5, 0] = 200000  # split by pack_observations
    ims = []
    for Model, Manager, kw in (
        (JaxModel, JaxManager, {}),
        (TorchModel, torch_manager.OnePopInferenceManager, {"device": "cpu"}),
    ):
        m = Model([0.01, 3.0], 20000.0, "piecewise")
        m.y[:] = 0.0
        im = Manager(2, [data], np.array([0.0, np.inf]), ("pop1",), 0.5, **kw)
        im.set_model(m)
        im.theta, im.rho, im.alpha = 1e-4, 1e-4, 1
        im.save_gamma = True
        im.E_step()
        ims.append(im)
    assert any(r.max() > 1 for r in ims[1]._row_reps)
    g = ims[1].gammas[0]
    assert g.shape == (50, 1)
    np.testing.assert_array_equal(g[:, 0], data[:, 0])
    np.testing.assert_array_equal(g, ims[0].gammas[0])
    with pytest.raises(NotImplementedError, match="A6"):
        ims[1].map_paths()


def test_decode_over_the_gate_raises(monkeypatch):
    (tim,) = _managers([_data(12, 100)])[1:]
    monkeypatch.setattr(tim, "_hbm_budget", lambda frac=0.375: 1.0)
    assert not tim._window_decode_fits()
    tim.save_gamma = True
    with pytest.raises(NotImplementedError, match="A6") as e:
        tim.E_step()
    assert "windows" in str(e.value) and "gate" in str(e.value)
    with pytest.raises(NotImplementedError, match="A6"):
        tim.map_paths()


@pytest.fixture(scope="module")
def posterior_runs(tmp_path_factory):
    """One seeded contig the cost model sends to windows; JAX's posterior
    and the port's (--device cpu), same arguments."""
    d = tmp_path_factory.mktemp("post")
    m = JaxModel([0.01, 0.1, 1.0, 5.0], 1e4, "piecewise")
    m.y[:] = np.log([1.0, 0.3, 1.0, 2.0])
    data = str(d / "sim.smc.gz")
    write_simulated(data, m, 2e-3, 2e-4, L=50_000, n=6, seed=3)
    model = str(d / "model.final.json")
    with open(model, "w") as f:
        json.dump({"model": m.to_dict(), "theta": 2e-3, "rho": 2e-4,
                   "alpha": 1}, f)
    args = ["posterior", "--M", "16", "--map", "--intervals",
            "0.025,0.5,0.975", model]
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("SMCPP_TPU_DECODE_TRANSFER", "f32")
        mp.setenv("SMCPP_TPU_DEVICES", "1")  # one device, as the port runs
        jax_main.main(args + [str(d / "jax.npz"), data])
    finally:
        mp.undo()
    im = torch_main.main(args[:1] + ["--device", "cpu"] + args[1:] +
                         [str(d / "torch.npz"), data])
    return np.load(d / "jax.npz"), np.load(d / "torch.npz"), data, im


def test_cli_posterior_matches_jax(posterior_runs):
    """Every array of the two npz files: hidden states and sites exactly;
    normalized gammas at rtol 1e-4 / atol 1e-5 (the manager bound); MAP
    states on 99.9% of rows; quantiles at rtol 1e-4 / atol 1e-6 (each is a
    piecewise-linear function of the gammas, continuous across interval
    edges)."""
    zj, zt, data, im = posterior_runs
    assert im._use_windows
    assert sorted(zt.files) == sorted(zj.files) == sorted(
        ["hidden_states", data, data + "_sites", data + "_map",
         data + "_quantiles"]
    )
    np.testing.assert_allclose(zt["hidden_states"], zj["hidden_states"], rtol=1e-12)
    np.testing.assert_array_equal(zt[data + "_sites"], zj[data + "_sites"])
    g = zt[data]
    assert g.shape == (16, len(zt[data + "_sites"]))
    np.testing.assert_allclose(g.sum(0), 1.0, rtol=1e-5)
    np.testing.assert_allclose(g, zj[data], rtol=1e-4, atol=1e-5)
    assert (zt[data + "_map"] == zj[data + "_map"]).mean() >= 0.999
    q = zt[data + "_quantiles"]
    assert np.all(np.diff(q, axis=0) >= 0)
    np.testing.assert_allclose(q, zj[data + "_quantiles"], rtol=1e-4, atol=1e-6)


# --- viterbi_boundary_states (K7's plain version) on edge shapes -----------

def _soc_cases(case, S, rng):
    """seg_of_contig for S segments: 'uneven' three contigs of uneven
    length with tail padding; 'unlisted' two contigs that leave some
    segments unlisted (their states stay 0); 'one_contig' C = 1."""
    if case == "one_contig":
        return np.arange(S, dtype=np.int64)[None]
    if case == "unlisted":
        listed = np.sort(rng.choice(S, S - 4, replace=False))
        soc = np.full((2, S), -1, np.int64)
        soc[0, :3] = listed[:3]
        soc[1, : len(listed) - 3] = listed[3:]
        return soc
    cuts = np.linspace(0, S, 4).astype(int)
    soc = np.full((3, np.diff(cuts).max()), -1, np.int64)
    for c in range(3):
        soc[c, : cuts[c + 1] - cuts[c]] = np.arange(cuts[c], cuts[c + 1])
    return soc


@pytest.mark.parametrize("case", ["uneven", "unlisted", "one_contig"])
@pytest.mark.parametrize("M", [2, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_viterbi_boundary_states_edge_shapes(case, M, dtype):
    """Small-integer max-plus operators force ties (the first maximizing
    state wins on both sides), a state with pi == 0 and -1e30 entries carry
    the 'impossible' score."""
    rng = np.random.RandomState(14)
    S = 13
    W = rng.randint(-3, 1, (S, M, M)).astype(dtype)
    W[rng.rand(S, M, M) < 0.05] = -1e30
    pi = rng.dirichlet(np.ones(M)).astype(dtype)
    pi[1] = 0
    soc = _soc_cases(case, S, rng)
    ref = jwk.viterbi_boundary_states(jnp.asarray(pi), jnp.asarray(W), soc)
    got = twk.viterbi_boundary_states_plain(torch.as_tensor(pi),
                                            torch.as_tensor(W), soc)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.shape == (S,)
        _agree(g.numpy(), r, dtype)
    unlisted = np.setdiff1d(np.arange(S), soc[soc >= 0])
    for g in got:
        assert np.all(g.numpy()[unlisted] == 0)
    assert np.all(got[0].numpy()[soc[:, 0]] != 1)  # no path starts at pi == 0


def test_viterbi_boundary_states_dispatches_plain_on_cpu(monkeypatch):
    def no_kernel(*a):
        raise AssertionError("the CUDA wrapper ran on CPU tensors")

    monkeypatch.setattr(twk, "viterbi_boundary_cuda", no_kernel)
    pi, T, E, keys, valid, soc, _ = _vit_inputs(4, np.float32)
    W = twk.viterbi_segment_ops(*map(torch.as_tensor, (T, E, keys, valid)))
    before = twk.VITERBI_BOUNDARY.launches
    got = twk.viterbi_boundary_states(torch.as_tensor(pi), W, soc)
    want = twk.viterbi_boundary_states_plain(torch.as_tensor(pi), W, soc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert twk.VITERBI_BOUNDARY.launches == before
