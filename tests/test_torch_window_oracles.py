"""The oracles of tests/test_window_kernel.py, held by the port's window
E-step (smcpp_tpu_torch/ops/window_kernel.py), on the CPU.

Each test takes the problem of the JAX test it ports (``make_problem``,
seeded NumPy) and holds the port's function to that test's oracle, with
its bound.  Where the JAX test's oracle is its AD window E-step
(``estep_windows``, ``loglik_windows``), which the port leaves out on
purpose, the port's direct E-step is held to the port's span kernel
(ops/hmm.py, the brute-force-checked row algorithm) at the bounds the JAX
test gives the window/span agreement (ll rtol 1e-10, statistics rtol
1e-7), and to the JAX AD E-step itself at the JAX test's own bound.  The
alpha-remat oracle (test_estep_direct_alpha_remat_matches) is held in f64
at rtol 1e-11 / atol 1e-14, its sharded form in tests/test_torch_parallel.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.ops import hmm as thmm  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_window_kernel import make_problem  # noqa: E402

sys.path.remove(HERE)

jax.config.update("jax_enable_x64", True)


def _pack(data, nk, seg_target):
    "pack_windows of the port, equal to JAX's (same segments)."
    key_id = {(k,): k for k in range(nk)}
    keys, valid, soc = twk.pack_windows(data, key_id, seg_target=seg_target)
    jk, jv, jsoc = jwk.pack_windows(data, key_id, seg_target=seg_target)
    assert np.array_equal(keys, jk) and np.array_equal(valid, jv)
    assert np.array_equal(soc, jsoc)
    return keys, valid, soc


def _spans(data):
    "The span kernel's packed rows of ``data`` (chunk 8), as the JAX tests pack them."
    C = len(data)
    Lmax = -(-max(len(d) for d in data) // 8) * 8
    spans = np.zeros((C, Lmax), np.int32)
    ks = np.zeros((C, Lmax), np.int32)
    for i, d in enumerate(data):
        spans[i, : len(d)] = d[:, 0]
        ks[i, : len(d)] = d[:, 1]
    return spans, ks, int(spans.max()).bit_length()


def _direct(pi, T, E, keys, valid, soc, dtype=torch.float64, **kw):
    return twk.estep_direct(*twk.from_numpy(pi, T, E, "cpu", dtype),
                            torch.as_tensor(keys), torch.as_tensor(valid), soc, **kw)


def _span_estep(pi, T, E, data):
    spans, ks, nbits = _spans(data)
    return thmm.estep(*twk.from_numpy(pi, T, E, "cpu", torch.float64),
                      torch.as_tensor(spans), torch.as_tensor(ks), nbits, 8)


def _span_ll(pi, T, E, data):
    spans, ks, nbits = _spans(data)
    return float(thmm.loglik(*twk.from_numpy(pi, T, E, "cpu", torch.float64),
                             torch.as_tensor(spans), torch.as_tensor(ks), nbits, 8))


def _jargs(pi, T, E, keys, valid, soc):
    return (jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys),
            jnp.asarray(valid), soc)


def _stats_close(got, want, rtol, atol=0.0, rtol_ll=None):
    assert np.isclose(float(got[0]), float(want[0]), rtol=rtol_ll or rtol, atol=0)
    for g, w in zip(got[1:], want[1:]):
        g = g.detach().double().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = w.detach().double().numpy() if torch.is_tensor(w) else np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_matches_span_kernel():
    """test_window_kernel.py:28: the window E-step's log-likelihood equals
    the span kernel's (rtol 1e-10), and JAX's window ll."""
    pi, T, E, data = make_problem()
    keys, valid, soc = _pack(data, E.shape[0], 16)
    ll_w = float(_direct(pi, T, E, keys, valid, soc)[0])
    assert np.isclose(ll_w, _span_ll(pi, T, E, data), rtol=1e-10)
    ll_j = float(jwk.loglik_windows(*_jargs(pi, T, E, keys, valid, soc)))
    assert np.isclose(ll_w, ll_j, rtol=1e-10)


def test_estep_stats_match():
    """test_window_kernel.py:57: the window E-step's statistics equal the
    span kernel's (ll rtol 1e-10, statistics rtol 1e-7)."""
    pi, T, E, data = make_problem(seed=1)
    keys, valid, soc = _pack(data, E.shape[0], 16)
    got = _direct(pi, T, E, keys, valid, soc)
    _stats_close(got, _span_estep(pi, T, E, data), 1e-7, rtol_ll=1e-10)
    _stats_close(got, jwk.estep_windows(*_jargs(pi, T, E, keys, valid, soc)),
                 1e-7, rtol_ll=1e-10)


def _rare_key_problem():
    "The rare-key-dense problem of test_window_kernel.py:82 and :176."
    rng = np.random.RandomState(7)
    M, nk = 8, 15
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = 10.0 ** rng.uniform(-8, 0, (nk, M))
    data = []
    for _ in range(3):
        rows = rng.randint(30, 70)
        d = np.c_[rng.randint(1, 12, rows), rng.randint(0, nk, rows)]
        data.append(d.astype(np.int64))
    return pi, T, E, data


def test_rare_key_dense_f32():
    """test_window_kernel.py:82: on rare-key-dense streams the f32 E-step is
    finite and within rtol 1e-3 of the f64 one, and the f64 ll equals the
    span kernel's (rtol 1e-9): the per-step rescaling keeps the window
    products off the floor."""
    pi, T, E, data = _rare_key_problem()
    keys, valid, soc = _pack(data, E.shape[0], 16)
    outs = {dt: _direct(pi, T, E, keys, valid, soc, dt, precision="highest")
            for dt in (torch.float32, torch.float64)}
    for out in outs.values():
        for o in out[1:]:
            assert torch.isfinite(o).all()
    assert np.isclose(float(outs[torch.float32][0]), float(outs[torch.float64][0]),
                      rtol=1e-3)
    assert np.isclose(float(outs[torch.float64][0]), _span_ll(pi, T, E, data),
                      rtol=1e-9)


def test_f32_consistency():
    """test_window_kernel.py:132: the f32 ll within rtol 2e-4 of the f64 ll
    at 'default' (bf16 carries) and within 2e-5 at the f32-carry rungs."""
    pi, T, E, data = make_problem(seed=2, C=2, rows=200)
    keys, valid, soc = _pack(data, E.shape[0], 64)
    ll64 = float(_direct(pi, T, E, keys, valid, soc)[0])
    ll32 = float(_direct(pi, T, E, keys, valid, soc, torch.float32,
                         precision="default")[0])
    assert np.isclose(ll32, ll64, rtol=2e-4)
    for p in ("tensorfloat32", "highest"):
        llp = float(_direct(pi, T, E, keys, valid, soc, torch.float32, precision=p)[0])
        assert np.isclose(llp, ll64, rtol=2e-5), p


@pytest.mark.parametrize("seed,C,rows,st", [(1, 3, 40, 16), (5, 1, 3, 16), (11, 2, 1, 8)])
def test_estep_direct_matches_span_kernel(seed, C, rows, st):
    """test_window_kernel.py:155 (estep_direct against the AD E-step) across
    multi-segment contigs, single-window contigs and segment padding: the
    port's direct E-step against its span kernel (ll rtol 1e-10, statistics
    rtol 1e-7) and against JAX's AD E-step at that test's bound (rtol 1e-12,
    atol 1e-15)."""
    pi, T, E, data = make_problem(seed=seed, C=C, rows=rows)
    keys, valid, soc = _pack(data, E.shape[0], st)
    got = _direct(pi, T, E, keys, valid, soc)
    _stats_close(got, _span_estep(pi, T, E, data), 1e-7, rtol_ll=1e-10)
    _stats_close(got, jwk.estep_windows(*_jargs(pi, T, E, keys, valid, soc)),
                 1e-12, atol=1e-15)


def test_estep_direct_rare_keys_f32():
    """test_window_kernel.py:176: the f32 direct E-step on rare-key-dense
    streams is finite, near the f64 one, and conserves its totals exactly
    (f64 accumulators): the pi-stat sums to the contig count, xisum and the
    per-key masses to the window count."""
    pi, T, E, data = _rare_key_problem()
    keys, valid, soc = _pack(data, E.shape[0], 16)
    n_windows = float(sum(d[:, 0].sum() for d in data))
    f64 = _direct(pi, T, E, keys, valid, soc)
    f32 = _direct(pi, T, E, keys, valid, soc, torch.float32)
    for o in f32[1:]:
        assert torch.isfinite(o).all()
    assert np.isclose(float(f32[0]), float(f64[0]), rtol=1e-3)
    np.testing.assert_allclose(float(f32[1].sum()), 3.0, rtol=1e-6)
    np.testing.assert_allclose(float(f32[2].sum()), n_windows, rtol=1e-6)
    np.testing.assert_allclose(float(f32[3].sum()), n_windows, rtol=1e-6)
    for a, d, tol in zip(f64[1:], f32[1:], (2e-2, 1e-2, 1e-2)):
        np.testing.assert_allclose(d.double().numpy(), a.numpy(), rtol=tol, atol=1e-8)


def test_stats_pass_gathers_what_the_emission_stream_gives():
    """test_window_kernel.py:218: the port's stats_pass gathers emission rows
    (it has no e_all stream); in f64 it equals JAX's with the stream and
    without it (alpha_end, xo, gsum at rtol 1e-12; u_start, which carries the
    stream's per-window scaling in JAX, against JAX's without it), and the
    boundary statistics from it equal JAX's from the stream."""
    pi, T, E, data = make_problem(seed=3)
    keys, valid, soc = _pack(data, E.shape[0], 16)
    Tj, Ej, kj, vj = (jnp.asarray(x) for x in (T, E, keys, valid))
    ops, logs, e_all = jwk.segment_operators(Tj, Ej, kj, vj, emit_e=True)
    _, A_in, Q_end, cvalid = jwk.contig_boundaries(jnp.asarray(pi), ops, logs, soc,
                                                   jnp.any(vj, axis=1))
    with_e = jwk.stats_pass(Tj, Ej, kj, vj, A_in, Q_end, e_all)
    without = jwk.stats_pass(Tj, Ej, kj, vj, A_in, Q_end, None)
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    got = twk.stats_pass(t(T), t(E), t(keys), t(valid), t(A_in), t(Q_end))
    for i in (0, 2, 3):
        for ref in (with_e, without):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                       rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(without[1]),
                               rtol=1e-12, atol=1e-15)
    xob, pist = twk.boundary_stats(t(pi), t(T), got[0], got[1], got[2], soc,
                                   t(cvalid))
    jxob, jpist = jwk.boundary_stats(jnp.asarray(pi), Tj, *with_e[:2],
                                     jnp.asarray(with_e[2], jnp.float64), soc, cvalid)
    np.testing.assert_allclose(xob.numpy(), np.asarray(jxob), rtol=1e-12)
    np.testing.assert_allclose(pist.numpy(), np.asarray(jpist), rtol=1e-12)


def test_estep_direct_many_keys(monkeypatch):
    """test_window_kernel.py:252: JAX's gather/scatter branch (past its
    one-hot limit, forced to 4 keys) against the port, which always gathers
    (rtol 1e-11, atol 1e-14); and the span kernel's statistics."""
    monkeypatch.setattr(jwk, "ONEHOT_MAX_KEYS", 4)
    pi, T, E, data = make_problem(seed=4)
    keys, valid, soc = _pack(data, E.shape[0], 16)
    got = _direct(pi, T, E, keys, valid, soc)
    _stats_close(got, jwk.estep_direct(*_jargs(pi, T, E, keys, valid, soc)),
                 1e-11, atol=1e-14, rtol_ll=1e-12)
    _stats_close(got, _span_estep(pi, T, E, data), 1e-7, rtol_ll=1e-10)


@pytest.mark.parametrize("e_stream", [True, False])
def test_estep_direct_no_stream(e_stream):
    """test_window_kernel.py:271: JAX's E-step with and without its emission
    stream against the port's (which has none), at rtol 1e-12 / atol 1e-15
    (ll 1e-13)."""
    pi, T, E, data = make_problem(seed=6)
    keys, valid, soc = _pack(data, E.shape[0], 16)
    got = _direct(pi, T, E, keys, valid, soc)
    ref = jwk.estep_direct(*_jargs(pi, T, E, keys, valid, soc), e_stream=e_stream)
    _stats_close(got, ref, 1e-12, atol=1e-15, rtol_ll=1e-13)


def test_estep_direct_alpha_remat_matches():
    """test_window_kernel.py:289: the alpha-remat E-step reproduces the
    stored-alpha statistics in f64 across block sizes (ll rtol 1e-12,
    statistics rtol 1e-11 / atol 1e-14), and JAX's remat E-step with and
    without its emission stream."""
    pi, T, E, data = make_problem(seed=9, C=3, rows=40)
    keys, valid, soc = _pack(data, E.shape[0], 16)
    base = _direct(pi, T, E, keys, valid, soc)
    L = keys.shape[1]
    for blk in sorted({twk.remat_block_size(L), twk.RESCALE_EVERY, L}):
        if L % blk:
            continue
        out = _direct(pi, T, E, keys, valid, soc, alpha_remat=blk)
        _stats_close(out, base, 1e-11, atol=1e-14, rtol_ll=1e-12)
        for estream in (True, False):
            ref = jwk.estep_direct(*_jargs(pi, T, E, keys, valid, soc),
                                   e_stream=estream, alpha_remat=blk)
            _stats_close(out, ref, 1e-11, atol=1e-14, rtol_ll=1e-12)
