"""Alpha remat (the E-step over the device budget) and the blocked Viterbi
of the port, against the JAX package's, on the CPU.

``stats_pass(alpha_remat=B)`` keeps one carry snapshot per block of B
windows, rounded to the carry dtype, and recomputes each block's alphas
during the descending sweep (smcpp_tpu/ops/window_kernel.py:567-613); the
manager turns it on when the alpha stream is over the budget
(manager.py:909-942), and the Viterbi streams its backpointers per block
past its own gate (manager.py:711-725).  Inputs are made from a seed with
NumPy and handed to both packages.  Bounds and why:

* float64: JAX's remat oracle (tests/test_window_kernel.py:289), rtol 1e-11
  / atol 1e-14 of the largest entry: the same recursions summed in another
  order;
* float32 at 'highest' and at 'default' (bf16 snapshots on both sides,
  rounded at the same points): the bounds of
  tests/test_torch_window_kernel.py, rtol 1e-5 and 1e-4;
* the managers under a tiny budget: ll rtol 1e-6 and the statistics at
  rtol 1e-2 / atol 1e-6 against the full-memory route
  (tests/test_decode.py:168-197; the bf16 snapshots round other values
  than the stored bf16 stream); against JAX's manager under the same
  budget the window E-step's bounds, ll rtol 1e-6, statistics rtol 1e-4;
* the row-level decode past its gate: tests/test_torch_decode_rows.py's
  bound, rtol 1e-4 plus 1e-4 of the row's span;
* MAP paths: the blocked paths equal the unblocked ones exactly (adds and
  maxima only, f32 snapshots); against JAX, 99.9% of rows
  (tests/test_decode.py:486-487).
"""

import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.inference import estimation as jax_est  # noqa: E402
from smcpp_tpu.inference.manager import (  # noqa: E402
    OnePopInferenceManager as JaxManager,
)
from smcpp_tpu.models import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.inference import manager as torch_manager  # noqa: E402
from smcpp_tpu_torch.models import SMCModel as TorchModel  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

jax.config.update("jax_enable_x64", True)

BOUNDS = {  # (precision, dtype) -> (rtol, atol as a fraction of the max)
    ("highest", np.float64): (1e-11, 1e-14),
    ("highest", np.float32): (1e-5, 1e-8),
    ("default", np.float32): (1e-4, 1e-8),
}
RUNGS = [("highest", np.float64), ("highest", np.float32), ("default", np.float32)]
L = 256  # remat_block_size(256) == 16
BLOCKS = [8, twk.remat_block_size(L), L]


def _problem(seed, S, M, n_keys, dtype):
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M).astype(dtype)
    E = rng.uniform(0.05, 1.0, (n_keys, M)).astype(dtype)
    pi = rng.dirichlet(np.ones(M)).astype(dtype)
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.9
    valid[-2:, L // 3:] = False  # ragged contig tails
    A_in = rng.rand(S, M).astype(dtype)
    Q_end = rng.rand(S, M).astype(dtype)
    return pi, T, E, keys, valid, A_in, Q_end


def _close(got, want, rtol, atol_frac):
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_frac * max(np.abs(want).max(), 1e-300)
    )


def test_remat_block_size():
    assert BLOCKS == [8, 16, 256]
    assert twk.remat_block_size(16384) == jwk.remat_block_size(16384) == 128
    for n in (64, 200, 512, 4096):
        assert twk.remat_block_size(n) == jwk.remat_block_size(n)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("precision,dtype", RUNGS)
def test_stats_pass_remat_matches_jax(precision, dtype, block):
    _, T, E, keys, valid, A_in, Q_end = _problem(1, 6, 8, 20, dtype)
    ref = jwk.stats_pass(*map(jnp.asarray, (T, E, keys, valid, A_in, Q_end)),
                         precision=precision, alpha_remat=block)
    got = twk.stats_pass(*map(torch.as_tensor, (T, E, keys, valid, A_in, Q_end)),
                         precision=precision, alpha_remat=block)
    rtol, atol = BOUNDS[(precision, dtype)]
    assert len(got) == 4
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("precision,dtype", RUNGS)
def test_estep_direct_remat_matches_jax(precision, dtype, block):
    pi, T, E, keys, valid, _, _ = _problem(2, 12, 16, 40, dtype)
    soc = np.arange(12).reshape(3, 4)
    ref = jwk.estep_direct(*map(jnp.asarray, (pi, T, E, keys, valid)), soc,
                           precision=precision, alpha_remat=block)
    got = twk.estep_direct(*twk.from_numpy(pi, T, E, "cpu", torch.from_numpy(T).dtype),
                           torch.as_tensor(keys), torch.as_tensor(valid), soc,
                           precision=precision, alpha_remat=block)
    rtol, atol = BOUNDS[(precision, dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)
    assert abs(float(got[3].sum()) - valid.sum()) < 1e-6 * valid.sum()


def test_remat_plain_equals_stored_stream_in_f64():
    """In f64 the snapshots are not rounded, so remat is the stored-stream
    pass up to summation order (JAX's oracle bound); alpha_end is the same
    sweep's, bit for bit."""
    _, T, E, keys, valid, A_in, Q_end = map(torch.as_tensor,
                                            _problem(3, 5, 6, 15, np.float64))
    full = twk.stats_pass(T, E, keys, valid, A_in, Q_end, precision="highest")
    for block in BLOCKS:
        got = twk.stats_pass(T, E, keys, valid, A_in, Q_end, precision="highest",
                             alpha_remat=block)
        assert torch.equal(got[0], full[0])
        for g, f in zip(got[1:], full[1:]):
            _close(g, f.numpy(), 1e-11, 1e-14)


def test_remat_excludes_gamma_and_checks_the_block():
    _, T, E, keys, valid, A_in, Q_end = map(torch.as_tensor,
                                            _problem(4, 3, 4, 9, np.float32))
    with pytest.raises(ValueError, match="emit_gamma"):
        twk.stats_pass(T, E, keys, valid, A_in, Q_end, alpha_remat=16,
                       emit_gamma=True)
    with pytest.raises(ValueError, match="divide"):
        twk.stats_pass(T, E, keys, valid, A_in, Q_end, alpha_remat=24)


# ---------------------------------------------------------------------------
# Through the managers
# ---------------------------------------------------------------------------

def _data(seed, n_rows=200):
    rng = np.random.RandomState(seed)
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(5, 60, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    return data


def _managers(data_list, M=5, jax_side=True):
    "The JAX manager (optional) and the port's on the same data and states."
    hs = jax_est.balance_hidden_states(_model(JaxModel), M + 1)
    ims = []
    if jax_side:
        ims.append(JaxManager(2, data_list, hs, ("pop1",), 0.5,
                              devices=[jax.devices()[0]]))
    ims.append(torch_manager.OnePopInferenceManager(2, data_list, hs, ("pop1",), 0.5,
                                                    device="cpu"))
    for im in ims:
        im.set_model(_model(JaxModel if isinstance(im, JaxManager) else TorchModel))
        im.theta, im.rho, im.alpha = 1e-4, 1e-4, 1
    return ims


def _model(Model):
    m = Model([0.01, 3.0], 20000.0, "piecewise")
    m.y[:] = 0.0
    return m


def _alpha_need(tim):
    return tim._window_stream_bytes(
        torch.finfo(twk.carry_dtype(tim.precision, torch.float32)).bits // 8)


def test_manager_tiny_budget_matches_jax_and_full_memory(monkeypatch, caplog):
    """SMCPP_TPU_ESTREAM_BYTES=1 turns alpha remat on in both packages (the
    same block, the same log line); the port's E-step matches JAX's under
    that budget and its own full-memory E-step at tests/test_decode.py's
    bounds."""
    data = [_data(8)]
    (full,) = _managers(data, jax_side=False)
    assert full._use_windows and full._alpha_remat is None
    ll_full = full.E_step()
    monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", "1")
    with caplog.at_level(logging.INFO):
        jim, tim = _managers(data)
    block = twk.remat_block_size(tim._wkeys.shape[1])
    assert tim._alpha_remat == block
    lines = [r.getMessage() for r in caplog.records if "alpha remat ON" in r.getMessage()]
    assert [x for x in lines if f"(block {block})" in x] and len(lines) >= 2
    ll_j, ll_t = jim.E_step(), tim.E_step()
    assert np.isclose(ll_t, ll_j, rtol=1e-6)
    for t, j in zip(tim._stats, jim._stats):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())
    assert np.isclose(ll_t, ll_full, rtol=1e-6)
    for a, b in zip(full._stats, tim._stats):
        np.testing.assert_allclose(b, a, rtol=1e-2, atol=1e-6)


def test_manager_remat_follows_the_budget(monkeypatch):
    """Over the budget remat is on; when the stream fits again a rebuild
    clears it; the estep goes through estep_direct with the manager's
    block."""
    (tim,) = _managers([_data(9)], jax_side=False)
    need = _alpha_need(tim)
    seen = []
    orig = twk.estep_direct

    def spy(*a, **kw):
        seen.append(kw.get("alpha_remat"))
        return orig(*a, **kw)

    monkeypatch.setattr(twk, "estep_direct", spy)
    for budget, want in ((need * 0.99, twk.remat_block_size(tim._wkeys.shape[1])),
                         (need * 1.01, None)):
        monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", repr(budget))
        tim._build_estep_fn()
        assert tim._alpha_remat == want
        tim.E_step()
        assert seen[-1] == want


def test_raise_precision_switches_to_remat_mid_em(monkeypatch, caplog):
    """A budget between the bf16 stream (2 B) and the f32 stream (4 B):
    'default' stores the stream; raise_precision() climbs to f32 carries
    and re-gates, so the next E-step runs remat in both packages, and the
    two agree."""
    jim, tim = _managers([_data(10)])
    assert tim.precision == jim.precision == "default"
    need2 = tim._window_stream_bytes(2)
    monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", repr(need2 * 1.5))
    jim._estep_fn = jim._build_estep_fn()
    tim._build_estep_fn()
    assert tim._alpha_remat is None
    tim.E_step()
    with caplog.at_level(logging.INFO):
        assert tim.raise_precision() == jim.raise_precision() == "tensorfloat32"
    assert tim._alpha_remat == twk.remat_block_size(tim._wkeys.shape[1])
    assert sum("alpha remat ON" in r.getMessage() for r in caplog.records) == 2
    ll_j, ll_t = jim.E_step(), tim.E_step()
    assert np.isclose(ll_t, ll_j, rtol=1e-6)
    for t, j in zip(tim._stats, jim._stats):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6 * np.abs(j).max())


def test_over_budget_posterior_matches_jax(monkeypatch):
    """The over-budget posterior on the CPU, in both packages under one
    budget between the blocked and the whole backpointer stream: the
    E-step runs remat, the decode goes row-level by its gate, and the
    Viterbi runs blocked.  The port's gammas match JAX's and its blocked
    MAP paths equal its unblocked ones."""
    monkeypatch.setenv("SMCPP_TPU_DECODE_TRANSFER", "f32")
    data = [_data(11, 150), _data(12, 120)]
    (free,) = _managers(data, jax_side=False)
    want_paths = free.map_paths()
    Lw = free._wkeys.shape[1]
    block = twk.remat_block_size(Lw)
    lo = free._window_stream_bytes((block + 4.0 * (Lw // block)) / Lw)
    hi = free._window_stream_bytes(2)
    assert lo < hi
    monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", repr((lo + hi) / 2))
    jim, tim = _managers(data)
    assert tim._alpha_remat == block
    assert not tim._window_decode_fits() and not tim._window_viterbi_fits()
    for im in (jim, tim):
        im.save_gamma = True
        im.E_step()
    assert np.isclose(tim.loglik(), jim.loglik(), rtol=1e-6)
    for g_t, g_j, d in zip(tim.gammas, jim.gammas, data):
        np.testing.assert_allclose(g_t.sum(1), d[:, 0], rtol=1e-4)
        err = np.abs(g_t.astype(np.float64) - g_j) - 1e-4 * np.abs(g_j)
        assert np.all(err <= 1e-4 * d[:, :1])
    calls = []
    orig = twk.viterbi_segment_paths

    def spy(*a, **kw):
        calls.append(kw.get("block"))
        return orig(*a, **kw)

    monkeypatch.setattr(twk, "viterbi_segment_paths", spy)
    got = tim.map_paths()
    assert calls == [block]
    for a, b, j in zip(got, want_paths, jim.map_paths()):
        np.testing.assert_array_equal(a, b)
        assert (a == j).mean() >= 0.999


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_viterbi_paths_equal_unblocked(dtype):
    """viterbi_paths_plain(block=) over every block size that divides L
    equals the unblocked walk, and JAX's blocked walk."""
    rng = np.random.RandomState(13)
    S, Lv, M, n_keys = 7, 96, 6, 11
    T = rng.dirichlet(np.ones(M) * 3, size=M).astype(dtype)
    E = rng.uniform(0.05, 1.0, (n_keys, M)).astype(dtype)
    keys = rng.randint(0, n_keys, (S, Lv)).astype(np.int32)
    valid = rng.rand(S, Lv) < 0.9
    valid[-1, Lv // 2:] = False
    entry = rng.randint(0, M, S).astype(np.int32)
    exit_ = rng.randint(0, M, S).astype(np.int32)
    args = tuple(map(torch.as_tensor, (T, E, keys, valid, entry, exit_)))
    full = twk.viterbi_segment_paths(*args)
    for block in (8, 16, 32, 48, 96):
        np.testing.assert_array_equal(
            twk.viterbi_segment_paths(*args, block=block).numpy(), full.numpy())
    ref = jwk.viterbi_segment_paths(*map(jnp.asarray, (T, E, keys, valid, entry, exit_)),
                                    block=16)
    np.testing.assert_array_equal(full.numpy(), np.asarray(ref).T)
