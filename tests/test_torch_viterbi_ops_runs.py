"""K4's run plan as plain PyTorch on the CPU: its twin
``viterbi_ops_runs_plain`` (each run of equal keys walked a window at a time
below ``VITERBI_RUN_MIN`` windows, else applied as a binary power of its
operator), the run finder ``viterbi_runs`` and the count of products
``viterbi_ops_counts``, against the JAX package's ``viterbi_segment_ops``
and the port's window walk ``viterbi_ops_plain``.

Inputs are made from a seed with NumPy (tests/_viterbi_runs.py) and handed to
both packages.  What "agrees" means:

* the same entries are impossible (at or below -1e29: the -1e30 sentinel,
  or -inf where T or E has a zero) on both sides;
* the other entries lie within 6 L eps (|W| + |log T| + |log E|), each the
  largest finite magnitude, eps the dtype's unit roundoff.  Why: the twin
  and the walk sum each path's terms in another grouping.  A max-plus
  product never widens the gap between two operators taken up to a
  constant, and renormalising removes only a constant, so each side's
  roundings add up: at most three a window (the add of log T, the add of
  log E, the renormalisation), each within eps of an intermediate no larger
  than the sum of the three magnitudes; twice that for the two sides.  The
  JAX side's f32 logarithms may differ from torch's by an ulp a term, which
  the bound covers at these magnitudes;
* where no run reaches the cut-off the twin is the walk, bit for bit;
* the MAP boundary states (the plain K7) from the twin's operators and from
  the walk's agree by ``viterbi_boundary_agreement``'s rule, and where they
  are equal the plain K5 gives the same path.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

from _viterbi_runs import KINDS, run_inputs  # noqa: E402

jax.config.update("jax_enable_x64", True)

S, L, N_KEYS = 6, 200, 9  # L is not a multiple of 32
IMPOSSIBLE = -1e29


def _tol(W, T, E, L, dtype):
    "The reassociation bound of the module docstring."
    eps = np.finfo(dtype).eps / 2

    def big(x):
        x = np.asarray(x, np.float64)
        return float(np.abs(x[np.isfinite(x) & (x > IMPOSSIBLE)]).max())

    with np.errstate(divide="ignore"):
        return 6 * L * eps * (big(W) + big(np.log(T)) + big(np.log(E)))


def _agree(got, want, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    imp = want <= IMPOSSIBLE
    np.testing.assert_array_equal(got <= IMPOSSIBLE, imp)
    np.testing.assert_allclose(got[~imp], want[~imp], rtol=0, atol=atol)


def _twin(T, E, keys, valid):
    return twk.viterbi_ops_runs_plain(*map(torch.as_tensor, (T, E, keys, valid))).numpy()


def _walk(T, E, keys, valid):
    return twk.viterbi_ops_plain(*map(torch.as_tensor, (T, E, keys, valid))).numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M", [2, 15, 16, 17, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_twin_matches_jax_and_walk(dtype, M, kind):
    T, E, keys, valid = run_inputs(1, S, L, M, N_KEYS, kind, dtype)
    got = _twin(T, E, keys, valid)
    ref = np.array(jwk.viterbi_segment_ops(*map(jnp.asarray, (T, E, keys, valid))))
    walk = _walk(T, E, keys, valid)
    assert got.shape == (S, M, M) and got.dtype == dtype
    atol = _tol(walk, T, E, L, dtype)
    _agree(got, ref, atol)
    _agree(got, walk, atol)
    # each segment's maximum is 0, as the walk leaves it
    np.testing.assert_array_equal(got.max((1, 2)), np.zeros(S, dtype))
    if kind == "alternating":
        np.testing.assert_array_equal(got, walk)


@pytest.mark.parametrize("L_seg", [8, 97, 2000])
@pytest.mark.parametrize("M", [2, 16, 17, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_powers_keep_the_sentinel(dtype, M, L_seg):
    """One run a segment (r = L, powers alone) with zeros in T and E: every
    impossible entry is exactly -1e30, never -inf, lower, or NaN, after up
    to ten squarings, and the rest agree with the walk."""
    T, E, _, _ = run_inputs(2, 3, L_seg, M, N_KEYS, "zeros", dtype)
    _, _, keys, valid = run_inputs(2, 3, L_seg, M, N_KEYS, "one_key", dtype)
    got = _twin(T, E, keys, valid)
    assert np.isfinite(got).all()
    assert got.min() == dtype(-1e30)
    imp = got <= IMPOSSIBLE
    assert imp.any() and (got[imp] == dtype(-1e30)).all()
    walk = _walk(T, E, keys, valid)
    _agree(got, walk, _tol(walk, T, E, L_seg, dtype))


def test_runs_and_products_by_hand():
    """Segment 0: runs of 3 and 8 windows, 14 of one key split by an
    invalid window into 9 and 4, 7, then invalid windows to its end;
    segment 1: one run of 100.  The walk below the cut-off, bitlen(r) - 1 +
    popcount(r) products from it."""
    assert twk.VITERBI_RUN_MIN == 8
    keys = np.full((2, 100), 5, np.int32)
    keys[0] = 7
    keys[0, :25] = [4] * 3 + [1] * 8 + [2] * 14
    valid = np.ones((2, 100), bool)
    valid[0, 20] = False
    valid[0, 32:] = False
    seg, key, length = twk.viterbi_runs(keys, valid)
    np.testing.assert_array_equal(seg, [0, 0, 0, 0, 0, 1])
    np.testing.assert_array_equal(key, [4, 1, 2, 2, 7, 5])
    np.testing.assert_array_equal(length, [3, 8, 9, 4, 7, 100])
    # 8 = 1000b: 3 + 1; 9 = 1001b: 3 + 2; 100 = 1100100b: 6 + 3
    np.testing.assert_array_equal(twk.run_products(length), [3, 4, 5, 4, 7, 9])
    assert twk.viterbi_ops_counts(torch.as_tensor(keys), torch.as_tensor(valid)) == (
        32, 131)
    np.testing.assert_array_equal(twk.run_products([0, 1, 7, 8, 16, 255, 2**20 + 1]),
                                  [0, 1, 7, 4, 5, 15, 22])


@pytest.mark.parametrize("kind", ["alternating", "mixed"])
def test_counts_of_the_walk_and_of_runs(kind):
    "The walk is one product a valid window; the mixed runs need fewer."
    _, _, keys, valid = run_inputs(3, S, 1000, 4, N_KEYS, kind)
    products, windows = twk.viterbi_ops_counts(keys, valid)
    assert windows == int(valid.sum())
    if kind == "alternating":
        assert products == windows
    else:
        assert products < windows / 4


@pytest.mark.parametrize("M", [2, 15, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_map_path_agrees_with_the_walk(dtype, M):
    """Boundary states (the plain K7) from the twin's operators and from the
    walk's, three contigs over 12 segments: by the agreement rule, scored
    on the walk's operators; the plain K5 paths equal where the states do."""
    T, E, keys, valid = run_inputs(4, 12, L, M, N_KEYS, "mixed", dtype)
    t = [torch.as_tensor(x) for x in (T, E, keys, valid)]
    rng = np.random.RandomState(4)
    pi = torch.as_tensor(rng.dirichlet(np.ones(M)).astype(dtype))
    soc = np.array([[0, 1, 2, 3, 4], [5, 6, -1, -1, -1], [7, 8, 9, 10, 11]])
    Wt, Ww = twk.viterbi_ops_runs_plain(*t), twk.viterbi_ops_plain(*t)
    got = twk.viterbi_boundary_states(pi, Wt, soc)
    want = twk.viterbi_boundary_states(pi, Ww, soc)
    diff, gap, delta = twk.viterbi_boundary_agreement(pi, Ww, soc, got, want)
    assert not bool((diff & (gap > delta)).any())
    if dtype == np.float64:
        assert not bool(diff.any())
    same = (got[0] == want[0]) & (got[1] == want[1])
    pt = twk.viterbi_segment_paths(*t, *got)
    pw = twk.viterbi_segment_paths(*t, *want)
    assert torch.equal(pt[same], pw[same])


def test_cpu_dispatch_walks():
    """viterbi_segment_ops on CPU tensors stays the window walk (the JAX
    parity test of tests/test_torch_posterior.py holds it in f64 exactly)."""
    t = [torch.as_tensor(x) for x in run_inputs(5, S, L, 16, N_KEYS, "mixed", np.float64)]
    assert torch.equal(twk.viterbi_segment_ops(*t), twk.viterbi_ops_plain(*t))
