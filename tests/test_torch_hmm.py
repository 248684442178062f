"""The port's span kernel (smcpp_tpu_torch/ops/hmm.py) against the JAX
package's (smcpp_tpu/ops/hmm.py) and the brute-force forward-backward of
tests/test_hmm.py, on the CPU.

Inputs are made from a seed with NumPy and handed to both packages.
Bounds and why:

* float64: the same recursions, multiplied and summed in another order:
  the port against JAX at rtol 1e-10 (the log-likelihood, the E-step
  statistics, the row gammas) and MAP paths exactly equal; against the
  brute force the bounds of tests/test_hmm.py;
* the E-step's gradient (``SpanLoglik``, K6's boundary vectors and a
  recompute per batch) against plain autograd through every chunk and
  ``_scan_chunks``: rtol 1e-10 in float64, 1e-4 in float32 (the f32 scans
  round at every chunk in another order);
* float32 against float64: rtol 1e-4 on the log-likelihood (test_hmm.py's
  bound).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.ops import hmm as jhmm  # noqa: E402
from smcpp_tpu_torch.ops import hmm  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402
from test_hmm import brute_force  # noqa: E402

jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


@pytest.fixture
def problem():
    "tests/test_hmm.py's problem."
    rng = np.random.RandomState(0)
    M, n_keys = 4, 5
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.1, 1.0, (n_keys, M))
    spans = np.array([1, 5, 1, 1, 12, 3, 1, 37, 2, 1, 1, 6, 1, 1, 2, 1], np.int32)
    keys = np.array([0, 1, 2, 0, 1, 3, 4, 1, 0, 2, 3, 1, 0, 4, 1, 0], np.int32)
    return pi, T, E, spans, keys


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x, np.float64)


def test_forward_loglik(problem):
    pi, T, E, spans, keys = problem
    ll_bf, *_ = brute_force(pi, T, E, spans, keys)
    nbits = int(spans.max()).bit_length()
    ll = float(hmm.forward_loglik(*_t(pi, T, E, spans, keys), nbits, 8))
    ll_j = float(jhmm.forward_loglik(*_j(pi, T, E, spans, keys), nbits, 8))
    assert np.isclose(ll, ll_bf, rtol=1e-10)
    assert np.isclose(ll, ll_j, rtol=RTOL)


def test_forward_loglik_padding(problem):
    "span == 0 rows are exact no-ops."
    pi, T, E, spans, keys = problem
    spans_p = np.concatenate([spans, np.zeros(16, np.int32)])
    keys_p = np.concatenate([keys, np.zeros(16, np.int32)])
    nbits = int(spans.max()).bit_length()
    ll1 = float(hmm.forward_loglik(*_t(pi, T, E, spans, keys), nbits, 8))
    ll2 = float(hmm.forward_loglik(*_t(pi, T, E, spans_p, keys_p), nbits, 8))
    assert np.isclose(ll1, ll2, rtol=1e-12)


def test_estep_statistics(problem):
    pi, T, E, spans, keys = problem
    ll_bf, gamma0_bf, xisum_bf, gs_bf, _ = brute_force(pi, T, E, spans, keys)
    nbits = int(spans.max()).bit_length()
    ll, gamma0, xisum, gs = hmm.estep(*_t(pi, T, E, spans[None], keys[None]), nbits, 8)
    assert np.isclose(float(ll), ll_bf, rtol=1e-10)
    np.testing.assert_allclose(_np(gamma0), gamma0_bf, rtol=1e-8)
    np.testing.assert_allclose(_np(xisum), xisum_bf, rtol=1e-8)
    for k, v in gs_bf.items():
        np.testing.assert_allclose(_np(gs)[k], v, rtol=1e-8, atol=1e-12)
    assert np.allclose(_np(gs).sum(), sum(spans), rtol=1e-8)
    ref = jhmm.estep(*_j(pi, T, E, spans[None], keys[None]), nbits, 8)
    for g, r in zip((ll, gamma0, xisum, gs), ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=RTOL, atol=1e-14)


def test_estep_multi_contig(problem):
    "Statistics sum across contigs."
    pi, T, E, spans, keys = problem
    nbits = int(spans.max()).bit_length()
    one = hmm.estep(*_t(pi, T, E, spans[None], keys[None]), nbits, 8)
    two = hmm.estep(*_t(pi, T, E, np.stack([spans, spans]), np.stack([keys, keys])),
                    nbits, 8)
    assert np.isclose(float(two[0]), 2 * float(one[0]), rtol=1e-12)
    for a, b in zip(one[1:], two[1:]):
        np.testing.assert_allclose(_np(b), 2 * _np(a), rtol=1e-10)


def test_posterior_gammas(problem):
    pi, T, E, spans, keys = problem
    *_, gamma_full = brute_force(pi, T, E, spans, keys)
    nbits = int(spans.max()).bit_length()
    g = _np(hmm.posterior_gammas(*_t(pi, T, E, spans, keys), nbits, 8))
    pos = 1
    for l, s in enumerate(spans):
        np.testing.assert_allclose(g[l], gamma_full[pos:pos + s].sum(0),
                                   rtol=1e-7, atol=1e-10)
        pos += s
    g_j = np.asarray(jhmm.posterior_gammas(*_j(pi, T, E, spans, keys), nbits, 8))
    np.testing.assert_allclose(g, g_j, rtol=RTOL, atol=1e-14)


def test_float32_accuracy(problem):
    "The f32 path agrees with f64 to ~1e-4 relative."
    pi, T, E, spans, keys = problem
    nbits = int(spans.max()).bit_length()
    ll64 = float(hmm.forward_loglik(*_t(pi, T, E, spans, keys), nbits, 8))
    f32 = tuple(torch.as_tensor(x, dtype=torch.float32) for x in (pi, T, E))
    ll32 = float(hmm.forward_loglik(*f32, *_t(spans, keys), nbits, 8))
    assert np.isclose(ll32, ll64, rtol=1e-4)
    _, *stats = hmm.estep(*f32, *_t(spans[None], keys[None]), nbits, 8)
    _, *stats64 = hmm.estep(*_t(pi, T, E, spans[None], keys[None]), nbits, 8)
    for a, b in zip(stats, stats64):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-6)


def test_viterbi_brute_force():
    """MAP path against exhaustive base-resolution enumeration on a tiny
    chain: the base-level MAP path's states at row ends."""
    import itertools

    rng = np.random.RandomState(3)
    M, n_keys = 3, 3
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.1, 1.0, (n_keys, M))
    spans = np.array([2, 1, 3, 1, 2], np.int32)
    keys = np.array([0, 1, 2, 0, 1], np.int32)
    base_keys = np.repeat(keys, spans)
    B = base_keys.size
    ends = np.cumsum(spans) - 1

    best_lp, best_path = -np.inf, None
    for path in itertools.product(range(M), repeat=B + 1):
        lp = np.log(pi[path[0]])
        for b in range(B):
            lp += np.log(T[path[b], path[b + 1]])
            lp += np.log(E[base_keys[b], path[b + 1]])
        if lp > best_lp:
            best_lp, best_path = lp, path
    expect = np.array(best_path[1:])[ends]

    nbits = int(spans.max()).bit_length()
    got = hmm.viterbi_path(*_t(pi, T, E, spans, keys), nbits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhmm.viterbi_path(*_j(pi, T, E, spans, keys), nbits)))


# --- the E-step's autograd.Function against plain autograd -----------------

def _layout(case, rng, M=5, n_keys=7, chunk=8):
    """(pi, T, E, spans, keys) on a (C, L) layout: 'padded' three contigs,
    the second all padding and the third ending in an all-padding chunk;
    'one_contig' C = 1."""
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M) * 3, size=M) + np.eye(M)
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    C = 1 if case == "one_contig" else 3
    spans = rng.randint(1, 40, (C, 4 * chunk)).astype(np.int32)
    if case == "padded":
        spans[1] = 0
        spans[2, 2 * chunk - 3:] = 0
    keys = rng.randint(0, n_keys, spans.shape).astype(np.int32)
    keys[spans == 0] = 0
    return pi, T, E, spans, keys


@pytest.mark.parametrize("case", ["padded", "one_contig"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_span_loglik_gradient_matches_autograd(case, dtype, rtol):
    pi, T, E, spans, keys = _layout(case, np.random.RandomState(5))
    nbits = int(spans.max()).bit_length()
    x = tuple(torch.as_tensor(v, dtype=dtype) for v in (pi, T, E))
    sp, ky = _t(spans, keys)
    a = tuple(v.clone().requires_grad_(True) for v in x)
    ll_a = hmm.loglik(*a, sp, ky, nbits, 8)
    g_a = torch.autograd.grad(ll_a, a)
    b = tuple(v.clone().requires_grad_(True) for v in x)
    # a small budget: several batches of chunks in the backward
    ll_b = hmm.SpanLoglik.apply(*b, sp, ky, nbits, 8, 8 * 8 * 5 * 5 * 8 * 50)
    g_b = torch.autograd.grad(ll_b, b)
    assert ll_b.dtype == torch.float64
    np.testing.assert_allclose(float(ll_b), float(ll_a.detach()), rtol=min(rtol, 1e-6))
    for u, v in zip(g_b, g_a):
        assert u.dtype == dtype
        np.testing.assert_allclose(_np(u), _np(v), rtol=rtol,
                                   atol=rtol * float(v.abs().max()))


@pytest.mark.parametrize("case", ["padded", "one_contig"])
def test_estep_matches_jax(case):
    pi, T, E, spans, keys = _layout(case, np.random.RandomState(6))
    nbits = int(spans.max()).bit_length()
    got = hmm.estep(*_t(pi, T, E, spans, keys), nbits, 8)
    ref = jhmm.estep(*_j(pi, T, E, spans, keys), nbits, 8)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=RTOL, atol=1e-12)


def test_chunk_layout_marks_padding():
    "seg_has is false exactly on all-padding chunks; cvalid on empty contigs."
    _, _, _, spans, _ = _layout("padded", np.random.RandomState(7))
    table, seg_has = hmm._chunk_layout(torch.as_tensor(spans), 8)
    np.testing.assert_array_equal(table, np.arange(12).reshape(3, 4))
    np.testing.assert_array_equal(
        seg_has.numpy(), [True] * 4 + [False] * 4 + [True, True, False, False])
    cvalid = twk._contig_valid(table, seg_has)
    np.testing.assert_array_equal(cvalid.numpy(), [True, False, True])


def test_estep_runs_the_plain_scan_on_the_cpu(monkeypatch):
    "CPU tensors never reach the K6 wrapper, and nothing is launched."
    def no_kernel(*a, **k):
        raise AssertionError("the CUDA wrapper ran on CPU tensors")

    monkeypatch.setattr(twk, "boundary_scan_cuda", no_kernel)
    monkeypatch.setattr(twk, "viterbi_boundary_cuda", no_kernel)
    pi, T, E, spans, keys = _layout("padded", np.random.RandomState(8))
    before = (twk.BOUNDARY_SCAN.launches, twk.VITERBI_BOUNDARY.launches)
    args = (*_t(pi, T, E, spans, keys), int(spans.max()).bit_length())
    hmm.estep(*args, 8)
    hmm.decode_gammas(*args, 8)
    hmm.viterbi_paths(*args)
    assert (twk.BOUNDARY_SCAN.launches, twk.VITERBI_BOUNDARY.launches) == before


# --- the decode, the max-plus powers ---------------------------------------

@pytest.mark.parametrize("case", ["padded", "one_contig"])
def test_decode_gammas_matches_posterior_gammas(case):
    pi, T, E, spans, keys = _layout(case, np.random.RandomState(9))
    nbits = int(spans.max()).bit_length()
    g = _np(hmm.decode_gammas(*_t(pi, T, E, spans, keys), nbits, 8))
    for c in range(spans.shape[0]):
        ref = _np(hmm.posterior_gammas(*_t(pi, T, E, spans[c], keys[c]), nbits, 8))
        if spans[c].any():
            np.testing.assert_allclose(g[c], ref, rtol=1e-9, atol=1e-12)
        else:  # a padding contig decodes to zeros
            assert np.all(g[c] == 0)
    np.testing.assert_allclose(g.sum(2), spans, atol=1e-9)
    g_j = np.asarray(jhmm.decode_gammas(*_j(pi, T, E, spans, keys), nbits, 8))
    np.testing.assert_allclose(g, g_j, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("M", [1, 3, 6])
def test_mp_power_matches_repeated_matmul(M):
    rng = np.random.RandomState(M)
    A = torch.as_tensor(np.log(rng.uniform(0.01, 1.0, (5, M, M))))
    s = torch.as_tensor([0, 1, 2, 7, 13], dtype=torch.int32)
    got = hmm._mp_power(A, s, 4)
    for b in range(5):
        want = torch.where(torch.eye(M, dtype=torch.bool), 0.0, -torch.inf).double()
        for _ in range(int(s[b])):
            want = hmm._mp_matmul(want, A[b])
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=1e-12)
        ref = np.asarray(jhmm._mp_power(jnp.asarray(A[b].numpy()), jnp.int32(s[b]), 4))
        np.testing.assert_array_equal(got[b].numpy(), ref)


def test_viterbi_paths_match_jax_on_padded_layouts():
    "Every row, padding rows included, equals the reference's path."
    pi, T, E, spans, keys = _layout("padded", np.random.RandomState(10))
    nbits = int(spans.max()).bit_length()
    got = hmm.viterbi_paths(*_t(pi, T, E, spans, keys), nbits)
    ref = np.asarray(jhmm.viterbi_paths(*_j(pi, T, E, spans, keys), nbits))
    assert got.dtype == torch.int32 and got.shape == spans.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fill_padding_matches_the_plain_backtrace():
    """K7's route fills padding rows from the real rows' states: the exit
    of the last real row before, else the next real row's entry, else
    argmax pi; on the plain path's own states it reproduces the plain
    path on every row."""
    pi, T, E, spans, keys = _layout("padded", np.random.RandomState(11))
    spans[0, :3] = 0  # leading padding rows
    spans[0, 10:12] = 0  # padding in the middle
    keys[spans == 0] = 0
    nbits = int(spans.max()).bit_length()
    x = _t(pi, T, E, spans, keys)
    path = hmm.viterbi_paths_plain(*x, nbits).long()
    real = x[3] > 0
    # the entry state of a row is the previous row's exit (pi's argmax first)
    V0 = torch.log(x[0]).expand(spans.shape[0], -1)
    entry = torch.cat([torch.argmax(V0, 1)[:, None], path[:, :-1]], 1)
    scrambled = torch.where(real, path, -7)
    got = hmm._fill_padding(scrambled, torch.where(real, entry, -7), real, x[0])
    assert torch.equal(got, path)
