"""The port's sharded E-step, decode and Viterbi (the window kernel's
functions with ``mesh=``, the span routes with parallel/mesh.py's
collectives after them) on 2 and 4 gloo ranks of CPU processes, against
the port's one process and against the JAX package's sharded functions on
a 2-device CPU mesh (the cases of tests/test_parallel.py, plus the
decodes).

One launch per world size runs every case (tests/_torch_dist_worker.py
``run_parallel``); every rank must return the same bits.  Bounds, f64 unless
named (tests/test_parallel.py's): ll rtol 1e-10 (1e-12 where nothing is
reassociated), statistics rtol 1e-8, window-decode rows (f32) rtol 1e-4,
MAP states equal; the manager runs the f32 E-step: ll rtol 1e-6, statistics
rtol 1e-4 / atol 1e-5, Q and its gradient on the same statistics rtol
1e-12 / 1e-10.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from smcpp_tpu.ops import hmm as jhmm  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu.parallel import mesh as jmesh  # noqa: E402
from smcpp_tpu_torch.ops import hmm as thmm  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_dist_worker as W  # noqa: E402

sys.path.remove(HERE)

jax.config.update("jax_enable_x64", True)
f64 = torch.float64


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    "Every rank's results of the parallel task; all ranks hold the same."
    out = W.launch("parallel", request.param,
                   tmp_path_factory.mktemp(f"par{request.param}"))
    for r in out[1:]:
        assert r.keys() == out[0].keys()
        for k in out[0]:
            np.testing.assert_array_equal(r[k], out[0][k], err_msg=k)
    return out[0]


def _jmesh():
    return jmesh.make_mesh(jax.devices()[:2])


def _jshard(mesh, *xs):
    sh = NamedSharding(mesh, P("data", None))
    return tuple(jax.device_put(jnp.asarray(x), sh) for x in xs)


def _stats_close(got, want, rtol_ll=1e-10, rtol=1e-8):
    assert np.isclose(float(got[0]), float(want[0]), rtol=rtol_ll, atol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol)


def _span_single(seed, M, nk, C, L):
    pi, T, E, spans, keys = W.span_problem(seed, M, nk, C, L)
    nbits = int(spans.max()).bit_length()
    tens = W._t(pi, T, E, dtype=f64) + W._t(spans, keys)
    return (pi, T, E, spans, keys, nbits), tens


def test_sharded_estep_matches_single_device(ranks):
    "The span E-step, contig-sharded: C = 8 contigs over the ranks."
    (pi, T, E, spans, keys, nbits), tens = _span_single(0, 8, 12, 8, 64)
    got = [ranks[f"span8_estep{i}"] for i in range(4)]
    one = thmm.estep(*tens, nbits, 16)
    _stats_close(got, [x.detach().numpy() for x in one])
    mesh = _jmesh()
    jx = jmesh.make_sharded_estep(mesh, nbits=nbits, chunk=16)(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        *jmesh.shard_batch(mesh, spans, keys))
    _stats_close(got, jx)


def test_sharded_padding_contigs(ranks):
    "C = 5 contigs padded with span-0 contigs to a multiple of the ranks."
    (pi, T, E, spans, keys, nbits), tens = _span_single(1, 4, 6, 5, 32)
    ll = float(thmm.estep(*tens, nbits, 16)[0])
    assert np.isclose(float(ranks["span5_estep0"]), ll, rtol=1e-12, atol=0)
    mesh = _jmesh()
    jll = jmesh.make_sharded_estep(mesh, nbits=nbits, chunk=16)(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        *jmesh.shard_batch(mesh, spans, keys))[0]
    assert np.isclose(float(ranks["span5_estep0"]), float(jll), rtol=1e-10, atol=0)


def test_sharded_span_decode_and_viterbi(ranks):
    "The row decode and the row Viterbi, contig-sharded."
    (pi, T, E, spans, keys, nbits), tens = _span_single(0, 8, 12, 8, 64)
    g1 = thmm.decode_gammas(*tens, nbits, 16).numpy()
    np.testing.assert_allclose(ranks["span8_decode"], g1, rtol=1e-10, atol=1e-12)
    p1 = thmm.viterbi_paths(*tens, nbits).numpy()
    np.testing.assert_array_equal(ranks["span8_viterbi"], p1)
    mesh = _jmesh()
    args = (jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            *jmesh.shard_batch(mesh, spans, keys))
    jg = np.asarray(jmesh.make_sharded_decode(mesh, nbits, 16)(*args))[:8]
    np.testing.assert_allclose(ranks["span8_decode"], jg, rtol=1e-8, atol=1e-10)
    jp = np.asarray(jmesh.make_sharded_viterbi(mesh, nbits)(*args))[:8]
    np.testing.assert_array_equal(ranks["span8_viterbi"], jp)


def _window(tag):
    seed, kw = W.WINDOW_CASES[tag]
    pi, T, E, keys, valid, soc, row_spans = W.window_problem(seed, **kw)
    tens = W._t(pi, T, E, dtype=f64) + W._t(keys, valid)
    return (pi, T, E, keys, valid, soc, row_spans), tens


def _jax_direct(prob, **kw):
    pi, T, E, keys, valid, soc, _ = prob
    mesh = _jmesh()
    k, v = jmesh.pad_segments(keys, valid, 2)
    return jmesh.make_sharded_direct_estep(mesh, soc, **kw)(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E), *_jshard(mesh, k, v))


def test_sharded_window_estep(ranks):
    """The sharded direct E-step on test_sharded_window_estep's problem,
    against the port's one process and JAX's sharded AD window E-step."""
    prob, tens = _window("window")
    pi, T, E, keys, valid, soc, _ = prob
    got = [ranks[f"window_estep{i}"] for i in range(4)]
    _stats_close(got, [x.numpy() for x in twk.estep_direct(*tens, soc)])
    mesh = _jmesh()
    k, v = jmesh.pad_segments(keys, valid, 2)
    jx = jmesh.make_sharded_window_estep(mesh, soc)(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E), *_jshard(mesh, k, v))
    _stats_close(got, jx)


@pytest.mark.parametrize("tag,e_stream", [("direct", True), ("no_stream", False)])
def test_sharded_direct_estep(ranks, tag, e_stream):
    """The sharded direct E-step (all-invalid padding segments included)
    against the port's one process and JAX's make_sharded_direct_estep, with
    and without JAX's emission stream."""
    prob, tens = _window(tag)
    got = [ranks[f"{tag}_estep{i}"] for i in range(4)]
    _stats_close(got, [x.numpy() for x in twk.estep_direct(*tens, prob[5])])
    _stats_close(got, _jax_direct(prob, e_stream=e_stream))


def test_sharded_direct_estep_alpha_remat(ranks):
    """Alpha remat through the sharded E-step (tests/test_window_kernel.py:
    test_sharded_direct_estep_alpha_remat): each rank's remat stats_pass on
    its block, against the port's one-process remat E-step, the sharded
    stored-stream E-step and JAX's sharded remat E-step."""
    prob, tens = _window("direct")
    B = twk.remat_block_size(prob[3].shape[1])
    got = [ranks[f"remat_estep{i}"] for i in range(4)]
    _stats_close(got, [x.numpy() for x in twk.estep_direct(*tens, prob[5],
                                                          alpha_remat=B)])
    _stats_close(got, [ranks[f"direct_estep{i}"] for i in range(4)], 1e-12, 1e-11)
    _stats_close(got, _jax_direct(prob, alpha_remat=B))


def test_sharded_window_decode(ranks):
    """Rows straddle the ranks' blocks: each rank's part by a prefix-sum
    difference, summed over the ranks."""
    prob, tens = _window("direct")
    pi, T, E, keys, valid, soc, row_spans = prob
    ends = torch.as_tensor(twk.pack_window_row_ends(row_spans, keys.shape[1], soc))
    ll1, g1 = twk.decode_gammas_windows(*tens, soc, ends)
    assert np.isclose(float(ranks["direct_decode_ll"]), float(ll1), rtol=1e-12)
    np.testing.assert_allclose(ranks["direct_decode"], g1.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ranks["direct_decode"].sum(1),
                               np.concatenate(row_spans), rtol=1e-5)
    mesh = _jmesh()
    rid, n_rows = jwk.pack_window_row_ids(row_spans, keys.shape[1], soc)
    k, v = jmesh.pad_segments(keys, valid, 2)
    rid = np.concatenate([rid, np.full((k.shape[0] - rid.shape[0], rid.shape[1]),
                                       n_rows, rid.dtype)])
    jll, jg = jmesh.make_sharded_window_decode(mesh, soc, n_rows)(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E), *_jshard(mesh, k, v, rid))
    assert np.isclose(float(ranks["direct_decode_ll"]), float(jll), rtol=1e-10)
    np.testing.assert_allclose(ranks["direct_decode"], np.asarray(jg),
                               rtol=1e-4, atol=1e-6)


def test_sharded_window_viterbi(ranks):
    "Each row's state picked by the rank holding its last window."
    prob, tens = _window("direct")
    pi, T, E, keys, valid, soc, row_spans = prob
    ends = twk.pack_window_row_ends(row_spans, keys.shape[1], soc)
    p1 = twk.viterbi_windows(*tens, soc, torch.as_tensor(ends)).numpy()
    np.testing.assert_array_equal(ranks["direct_viterbi"], p1)
    mesh = _jmesh()
    k, v = jmesh.pad_segments(keys, valid, 2)
    jp = jmesh.make_sharded_window_viterbi(mesh, soc)(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E), *_jshard(mesh, k, v),
        jnp.asarray(ends))
    np.testing.assert_array_equal(ranks["direct_viterbi"], np.asarray(jp))


@pytest.mark.parametrize("span_range", [(1, 12), (2000, 9000)],
                         ids=["window-kernel", "span-kernel"])
def test_manager_mesh_matches_single_device(ranks, span_range):
    """The manager on the ranks against the manager in one process, for both
    kernel choices: the E-step, Q and its gradient on the same statistics,
    the decoded rows and the MAP paths; the E-step's log-likelihood against
    JAX's manager on its 8-device mesh."""
    tag = "mgr_window" if span_range[0] == 1 else "mgr_span"
    n, data = W.manager_data(span_range)
    im = W.make_manager(data, n)
    assert im._mesh is None
    assert bool(ranks[f"{tag}_kernel"]) == im._use_windows == (span_range[0] == 1)
    ll1 = im.E_step()
    assert np.isclose(float(ranks[f"{tag}_ll"]), ll1, rtol=1e-6)
    stats = tuple(ranks[f"{tag}_stats{i}"] for i in range(3))
    for s, s1 in zip(stats, im._stats):
        np.testing.assert_allclose(s, s1, rtol=1e-4, atol=1e-5)
    im._stats = stats  # Q on the ranks' statistics
    q1, g1 = im.Q_and_grad()
    assert np.isclose(float(ranks[f"{tag}_q"]), q1, rtol=1e-12)
    np.testing.assert_allclose(ranks[f"{tag}_grad"], g1, rtol=1e-10)
    pi, T, E = (x.float().contiguous() for x in im.tensors())
    np.testing.assert_allclose(ranks[f"{tag}_gammas"],
                               np.concatenate(im._compute_gammas(pi, T, E)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ranks[f"{tag}_map"], np.concatenate(im.map_paths()))

    from smcpp_tpu.inference.manager import OnePopInferenceManager
    from smcpp_tpu.models import SMCModel

    jim = OnePopInferenceManager(n, data, W.HS, ("p",), 0.5)
    m = SMCModel(np.array([0.05, 0.3, 1.5]), 1e4, "piecewise")
    m.y[:] = 0.2
    jim.set_model(m)
    jim.theta = jim.rho = 1e-4
    assert jim._mesh is not None and jim._use_windows == im._use_windows
    assert np.isclose(float(ranks[f"{tag}_ll"]), jim.E_step(), rtol=1e-5)
