"""The port's window E-step (plain PyTorch versions of K1-K3 and the glue
around them) against smcpp_tpu.ops.window_kernel, on the CPU.

Inputs are made from a seed with NumPy and handed to both packages.
Bounds:

* float64: 1e-12 (the same recursions, summed in another order);
* float32 at 'highest': rtol 1e-5 / atol 1e-8 of the largest entry (the
  bound of tests/test_pallas_sweeps.py), against both the XLA sweeps and the
  Pallas sweeps run in interpret mode;
* float32 at 'default' (bf16 carries on both sides, rounded at the same
  points): rtol 1e-4.  A one-ulp f32 difference before a bf16 rounding can
  flip it; the measured differences are at the f32 level (about 1e-7).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.ops import pallas_sweeps as jps  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

jax.config.update("jax_enable_x64", True)

BOUNDS = {  # (precision, dtype) -> (rtol, atol as a fraction of the max)
    ("highest", np.float64): (1e-12, 1e-14),
    ("highest", np.float32): (1e-5, 1e-8),
    ("default", np.float32): (1e-4, 1e-8),
}


def _problem(seed, S, L, M, n_keys, dtype):
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


CASES = [
    ("highest", np.float64, 16),
    ("highest", np.float32, 16),
    ("highest", np.float32, 17),
    ("default", np.float32, 16),
    ("default", np.float32, 17),
]


@pytest.mark.parametrize("precision,dtype,M", CASES)
def test_segment_operators(precision, dtype, M):
    _, T, E, keys, valid, _, _ = _problem(0, 12, 256, M, 89, dtype)
    ops_j, logs_j = jwk.segment_operators(
        jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys), jnp.asarray(valid),
        precision=precision,
    )
    ops_t, logs_t = twk.segment_operators(
        torch.as_tensor(T), torch.as_tensor(E), torch.as_tensor(keys),
        torch.as_tensor(valid), precision=precision,
    )
    assert ops_t.dtype == torch.from_numpy(T).dtype
    rtol, atol = BOUNDS[(precision, dtype)]
    _close(ops_t, ops_j, rtol, atol)
    _close(logs_t, logs_j, rtol, atol)


@pytest.mark.parametrize("precision,dtype,M", CASES)
def test_stats_pass(precision, dtype, M):
    _, T, E, keys, valid, A_in, Q_end = _problem(1, 10, 200, M, 89, dtype)
    ref = jwk.stats_pass(
        *map(jnp.asarray, (T, E, keys, valid, A_in, Q_end)), None,
        precision=precision,
    )
    got = twk.stats_pass(
        *map(torch.as_tensor, (T, E, keys, valid, A_in, Q_end)),
        precision=precision,
    )
    rtol, atol = BOUNDS[(precision, dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)
    # conservation: each valid window's posterior sums to one
    gsum = got[3]
    assert gsum.dtype == torch.float64
    assert abs(float(gsum.sum()) - valid.sum()) < 1e-6 * valid.sum()


def test_stats_pass_matches_pallas_interpret():
    """The port's sweeps against the Pallas TPU kernels (P1, P2) run in
    interpret mode, as tests/test_pallas_sweeps.py runs them."""
    _, T, E, keys, valid, A_in, Q_end = _problem(2, 8, 256, 16, 89, np.float32)
    ref = jps.sweeps(
        jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys.T),
        jnp.asarray(valid.T), jnp.asarray(A_in), jnp.asarray(Q_end),
        alpha_dtype=jnp.float32, precision="highest", interpret=True,
    )
    got = twk.stats_pass(
        *map(torch.as_tensor, (T, E, keys, valid, A_in, Q_end)),
        precision="highest",
    )
    for g, r in zip(got, ref):
        _close(g, r, 1e-5, 1e-8)


def _soc(S, C):
    "seg_of_contig for S segments over C contigs of uneven length."
    cuts = np.linspace(0, S, C + 1).astype(int)
    ns = np.diff(cuts)
    soc = np.full((C, ns.max()), -1, np.int64)
    for c in range(C):
        soc[c, : ns[c]] = np.arange(cuts[c], cuts[c + 1])
    return soc


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_contig_boundaries(dtype):
    pi, T, E, keys, valid, _, _ = _problem(3, 14, 64, 16, 40, dtype)
    ops, logs = jwk.segment_operators(*map(jnp.asarray, (T, E, keys, valid)),
                                      precision="highest")
    soc = _soc(14, 3)
    seg_has = valid.any(1)
    ref = jwk.contig_boundaries(jnp.asarray(pi), ops, logs, soc,
                                jnp.asarray(seg_has))
    got = twk.contig_boundaries(
        torch.as_tensor(pi), torch.as_tensor(np.array(ops)),
        torch.as_tensor(np.array(logs)), soc, torch.as_tensor(seg_has),
    )
    rtol, atol = BOUNDS[("highest", dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)


@pytest.mark.parametrize("precision,dtype,M", CASES)
def test_estep_direct(precision, dtype, M):
    pi, T, E, keys, valid, _, _ = _problem(4, 15, 128, M, 60, dtype)
    soc = _soc(15, 4)
    ref = jwk.estep_direct(*map(jnp.asarray, (pi, T, E, keys, valid)), soc,
                           precision=precision)
    pi_t, T_t, E_t = twk.from_numpy(pi, T, E, "cpu", torch.from_numpy(T).dtype)
    got = twk.estep_direct(pi_t, T_t, E_t, torch.as_tensor(keys),
                           torch.as_tensor(valid), soc, precision=precision)
    rtol, atol = BOUNDS[(precision, dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)
    assert abs(float(got[3].sum()) - valid.sum()) < 1e-6 * valid.sum()


def test_unported_modes_raise():
    _, T, E, keys, valid, A_in, Q_end = map(
        torch.as_tensor, _problem(5, 4, 64, 16, 20, np.float32)
    )
    with pytest.raises(NotImplementedError, match="B3"):
        twk.stats_pass(T, E, keys, valid, A_in, Q_end, e_all=E)
    with pytest.raises(NotImplementedError, match="B3"):
        twk.stats_pass(T, E, keys, valid, A_in, Q_end, alpha_remat=8)
    with pytest.raises(NotImplementedError, match="B5"):
        twk.stats_pass(T, E, keys, valid, A_in, Q_end, emit_gamma=True)


def test_check_key_range():
    twk.check_key_range(np.array([[0, 3], [19, 2]], np.int32), 20)
    twk.check_key_range(np.zeros((0, 8), np.int32), 1)
    for bad in ([[0, 20]], [[-1, 0]]):
        with pytest.raises(ValueError, match="out of range"):
            twk.check_key_range(np.array(bad, np.int32), 20)


def test_carry_dtype_follows_the_ladder():
    assert twk.carry_dtype("default", torch.float32) == torch.bfloat16
    assert twk.carry_dtype("tensorfloat32", torch.float32) == torch.float32
    assert twk.carry_dtype("highest", torch.float32) == torch.float32
    assert twk.carry_dtype("default", torch.float64) == torch.float64
    for p in ("default", "tensorfloat32", "highest"):
        assert np.dtype(jwk._carry_dtype(p, jnp.float32)).itemsize == (
            torch.finfo(twk.carry_dtype(p, torch.float32)).bits // 8
        )
