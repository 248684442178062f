"""K7's chunked max-plus scan as plain PyTorch on the CPU: its twin
``viterbi_boundary_states_chunked_plain`` and the agreement rule's helpers
``viterbi_boundary_path_score`` and ``viterbi_boundary_delta``, against the
JAX package's sequential ``viterbi_boundary_states``.

Inputs are made from a seed with NumPy and handed to both packages; both
sides take the same max-plus operators, so the boundary scan alone is
compared.  What "agrees" means:

* inputs whose sums are all exact (small integers with -1e30 entries; the
  twin-state operators of tests/_viterbi_ties.py, tied at every step):
  equal states in both dtypes, ties to the lowest state, and no path starts
  in a state with pi == 0;
* K4's operators of a seeded problem: in float64 equal states; in float32
  at least 99.9% of the states equal (the rule of
  tests/test_torch_posterior.py), and in a contig whose states differ the
  two paths' f64 scores lie within δ (``viterbi_boundary_delta``);
* a 2000-segment contig against the sequential f32 and f64 loops: equal
  states or scores within δ, and the twin's score no lower than the f32
  loop's by more than δ.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

from _viterbi_ties import tie_inputs  # noqa: E402

jax.config.update("jax_enable_x64", True)

S = 40
CASES = ["uneven", "unlisted", "one_contig", "empty"]
CHUNKS = ["1", "3", "8", "NS", "2NS"]


def _layout(case):
    """seg_of_contig for S segments: 'uneven' three contigs of uneven length
    with tail padding; 'unlisted' two contigs that leave four segments
    unlisted; 'one_contig' C = 1; 'empty' the uneven three and a contig that
    lists no segment."""
    rng = np.random.RandomState(3)
    if case == "one_contig":
        return np.arange(S, dtype=np.int64)[None]
    if case == "unlisted":
        listed = np.sort(rng.choice(S, S - 4, replace=False))
        soc = np.full((2, S), -1, np.int64)
        soc[0, :3] = listed[:3]
        soc[1, : len(listed) - 3] = listed[3:]
        return soc
    cuts = np.linspace(0, S, 4).astype(int)
    soc = np.full((3 + (case == "empty"), np.diff(cuts).max()), -1, np.int64)
    for c in range(3):
        soc[c, : cuts[c + 1] - cuts[c]] = np.arange(cuts[c], cuts[c + 1])
    return soc


def _k4_problem(seed, n, L, M, dtype):
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M).astype(dtype)
    E = rng.uniform(0.05, 1.0, (29, M)).astype(dtype)
    keys = rng.randint(0, 29, (n, L)).astype(np.int32)
    valid = rng.rand(n, L) < 0.9
    return T, E, keys, valid


@functools.lru_cache(maxsize=None)
def _ops(kind, M, dtype):
    """pi with a zero and max-plus operators (S, M, M): 'ints' small integers
    with 5% -1e30 entries; 'k4' JAX's viterbi_segment_ops of a seeded
    problem."""
    rng = np.random.RandomState(M)
    pi = rng.dirichlet(np.ones(M))
    pi[1] = 0.0
    if kind == "ints":
        W = rng.randint(-3, 1, (S, M, M)).astype(dtype)
        W[rng.rand(S, M, M) < 0.05] = -1e30
    else:
        T, E, keys, valid = _k4_problem(M, S, 32, M, dtype)
        W = np.array(jwk.viterbi_segment_ops(*map(jnp.asarray, (T, E, keys, valid))))
    return pi.astype(dtype), W


def _jax_states(pi, W, soc):
    return tuple(np.asarray(x) for x in
                 jwk.viterbi_boundary_states(jnp.asarray(pi), jnp.asarray(W), soc))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("M", [2, 15, 32])
@pytest.mark.parametrize("kind", ["ints", "k4"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunked_twin_matches_jax(dtype, kind, M, case, chunk):
    pi, W = _ops(kind, M, dtype)
    soc = _layout(case)
    NS = soc.shape[1]
    k = {"NS": NS, "2NS": 2 * NS}.get(chunk) or int(chunk)
    got = [g.numpy() for g in twk.viterbi_boundary_states_chunked_plain(
        torch.as_tensor(pi), torch.as_tensor(W), soc, k)]
    ref = _jax_states(pi, W, soc)
    for g, r in zip(got, ref):
        assert g.dtype == np.int32 and g.shape == (S,)
    unlisted = np.setdiff1d(np.arange(S), soc[soc >= 0])
    assert not got[0][unlisted].any() and not got[1][unlisted].any()
    assert not np.any(got[0][soc[:, 0][soc[:, 0] >= 0]] == 1)  # pi[1] == 0
    if kind == "ints" or dtype == np.float64:
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        return
    for g, r in zip(got, ref):
        assert (g == r).mean() >= 0.999
    diff, gap, delta = twk.viterbi_boundary_agreement(
        torch.as_tensor(pi), torch.as_tensor(W), soc,
        [torch.as_tensor(x) for x in got], [torch.as_tensor(x) for x in ref])
    assert not bool((diff & (gap > delta)).any())


@pytest.mark.parametrize("chunk", ["1", "3", "8", "NS"])
@pytest.mark.parametrize("M", [2, 15, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_twin_states_keep_the_lowest(dtype, M, chunk):
    """K4's operators of the tie inputs (twin states a < b tie at every
    step): equal to JAX's states, and b is never taken over a."""
    a, b = M // 3, M - 1
    T, E, keys, valid, _, _ = tie_inputs(12, 13, 200, M, 89, a, b, dtype)
    W = np.array(jwk.viterbi_segment_ops(*map(jnp.asarray, (T, E, keys, valid))))
    pi = np.full(M, 1.0 / M, dtype)
    soc = np.full((3, 6), -1, np.int64)
    soc[0, :5], soc[1, :2], soc[2, :6] = np.arange(5), np.arange(5, 7), np.arange(7, 13)
    k = soc.shape[1] if chunk == "NS" else int(chunk)
    got = [g.numpy() for g in twk.viterbi_boundary_states_chunked_plain(
        torch.as_tensor(pi), torch.as_tensor(W), soc, k)]
    for g, r in zip(got, _jax_states(pi, W, soc)):
        np.testing.assert_array_equal(g, r)
        assert not np.any(g == b)


@functools.lru_cache(maxsize=None)
def _long():
    """One contig of 2000 segments of 32 windows at M = 16: the port's K4
    operators (f32), with the sequential f32 and f64 loops over them."""
    T, E, keys, valid = _k4_problem(13, 2000, 32, 16, np.float32)
    W = twk.viterbi_ops_plain(*map(torch.as_tensor, (T, E, keys, valid)))
    pi = torch.as_tensor(np.random.RandomState(13).dirichlet(np.ones(16)),
                         dtype=torch.float32)
    soc = np.arange(2000)[None]
    seq32 = twk.viterbi_boundary_states_plain(pi, W, soc)
    seq64 = twk.viterbi_boundary_states_plain(pi.double(), W.double(), soc)
    return pi, W, soc, seq32, seq64


@pytest.mark.parametrize("chunk", [None, 8, 64])
def test_chunked_twin_long_contig(chunk):
    """2000 slots in chunks of 8, 64 and the plan's 32: equal states or a
    path score within δ of the f32 and the f64 loop's, and no lower than the
    f32 loop's by more than δ."""
    pi, W, soc, seq32, seq64 = _long()
    if chunk is None:
        chunk = twk.boundary_plan(soc.shape[1])[0]
        assert chunk == 32
    got = twk.viterbi_boundary_states_chunked_plain(pi, W, soc, chunk)
    for want in (seq32, seq64):
        diff, gap, delta = twk.viterbi_boundary_agreement(pi, W, soc, got, want)
        assert not bool((diff & (gap > delta)).any())
    score, s32 = (float(twk.viterbi_boundary_path_score(pi, W, soc, *x)[0])
                  for x in (got, seq32))
    assert score >= s32 - float(delta[0])


def test_path_score_and_delta_by_hand():
    """Two contigs at M = 2: contig 0 lists segments 0 and 2, contig 1
    segment 1; a -1e30 entry counts in the score but not in δ."""
    W = torch.tensor([[[0.0, -1.5], [-2.0, -0.25]],
                      [[-1e30, 0.0], [-3.0, -4.0]],
                      [[-0.5, 0.0], [-8.0, -1.0]]])
    pi = torch.tensor([0.25, 0.75])
    soc = np.array([[0, 2], [1, -1]])
    entry = torch.tensor([1, 0, 0], dtype=torch.int32)
    exit_ = torch.tensor([0, 0, 1], dtype=torch.int32)
    got = twk.viterbi_boundary_path_score(pi, W, soc, entry, exit_)
    # contig 0: log 0.75 + W0[0][1] + W2[1][0]; contig 1: log 0.25 + W1[0][0]
    want = [np.log(0.75) - 1.5 - 8.0, np.log(0.25) + np.float64(np.float32(-1e30))]
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    delta = twk.viterbi_boundary_delta(W, soc)
    np.testing.assert_allclose(delta.numpy(), [2.0**-20 * (2.0 + 8.0), 2.0**-20 * 4.0],
                               rtol=1e-15)
