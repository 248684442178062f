"""K6's chunked boundary scan as plain PyTorch on the CPU: its twin
``contig_boundaries_chunked_plain``, its phase 1 ``chunk_products_plain``
and its plan ``boundary_plan``, against the JAX package.

Inputs are made from a seed with NumPy and handed to both packages.
Bounds:

* against ``smcpp_tpu.ops.window_kernel.contig_boundaries`` (the sequential
  scan): K6's tolerances on the card (tests/test_torch_cuda.py) in float32,
  rtol 1e-5 / atol 1e-7 on the boundary vectors and rtol 1e-6 on the f64
  log-likelihood (each chunk's start vectors are one f32 rounding from the
  exact scan's, then the same f32 loop runs over at most c slots); in
  float64 rtol 1e-10 / atol 1e-14 and 1e-12 (the same recursion,
  multiplied in another order);
* a long contig against the f64 sequential loop: rtol 1e-6 / atol 1e-7 on
  the vectors, 1e-8 on ll (the f32 loop itself lies about 6e-7 from it on
  these inputs);
* chunk products against ``smcpp_tpu.ops.hmm._tree_reduce``, each scaled
  to a largest entry of 1: rtol 1e-6 (f64 products in another order, from
  the same f32 operators).
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.ops import hmm as jhmm  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

jax.config.update("jax_enable_x64", True)

# dtype -> (rtol, atol) on the boundary vectors, rtol on ll
TOL = {np.float32: (1e-5, 1e-7, 1e-6), np.float64: (1e-10, 1e-14, 1e-12)}
S = 40
CASES = ["uneven", "no_valid", "unlisted", "one_contig"]


def _layout(case, rng):
    """seg_of_contig and seg_has for S segments: 'uneven' three contigs of
    uneven length with tail padding; 'no_valid' the same with every segment
    of the middle contig empty; 'unlisted' two contigs that leave four
    segments unlisted; 'one_contig' C = 1."""
    seg_has = np.ones(S, bool)
    if case == "one_contig":
        return np.arange(S, dtype=np.int64)[None], seg_has
    if case == "unlisted":
        listed = np.sort(rng.choice(S, S - 4, replace=False))
        soc = np.full((2, S), -1, np.int64)
        soc[0, :3] = listed[:3]
        soc[1, : len(listed) - 3] = listed[3:]
        return soc, seg_has
    cuts = np.linspace(0, S, 4).astype(int)
    soc = np.full((3, np.diff(cuts).max()), -1, np.int64)
    for c in range(3):
        soc[c, : cuts[c + 1] - cuts[c]] = np.arange(cuts[c], cuts[c + 1])
    if case == "no_valid":
        seg_has[soc[1][soc[1] >= 0]] = False
    return soc, seg_has


@functools.lru_cache(maxsize=None)
def _edge(case, M, dtype):
    "Random operators on one layout, and the JAX sequential scan's outputs."
    rng = np.random.RandomState(7)
    ops = rng.uniform(0.01, 1.0, (S, M, M)).astype(dtype)
    logs = rng.uniform(-40.0, -1.0, S).astype(dtype)
    pi = rng.dirichlet(np.ones(M)).astype(dtype)
    soc, seg_has = _layout(case, rng)
    ref = jwk.contig_boundaries(jnp.asarray(pi), jnp.asarray(ops),
                                jnp.asarray(logs), soc, jnp.asarray(seg_has))
    return pi, ops, logs, soc, seg_has, tuple(np.asarray(r) for r in ref)


@pytest.mark.parametrize("chunk", ["1", "3", "8", "NS", "2NS"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("M", [2, 15, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunked_scan_matches_jax(dtype, M, case, chunk):
    pi, ops, logs, soc, seg_has, ref = _edge(case, M, dtype)
    NS = soc.shape[1]
    k = {"NS": NS, "2NS": 2 * NS}.get(chunk) or int(chunk)
    ll, A_in, Q_end, cvalid = twk.contig_boundaries_chunked_plain(
        *map(torch.as_tensor, (pi, ops, logs)), soc, torch.as_tensor(seg_has), k)
    rtol, atol, ll_rtol = TOL[dtype]
    assert ll.dtype == torch.float64 and A_in.dtype == torch.from_numpy(ops).dtype
    np.testing.assert_allclose(float(ll), float(ref[0]), rtol=ll_rtol)
    np.testing.assert_allclose(A_in.double().numpy(), ref[1], rtol=rtol, atol=atol)
    np.testing.assert_allclose(Q_end.double().numpy(), ref[2], rtol=rtol, atol=atol)
    assert cvalid.tolist() == ref[3].tolist()
    unlisted = np.setdiff1d(np.arange(S), soc[soc >= 0])
    assert float(A_in[unlisted].abs().sum() + Q_end[unlisted].abs().sum()) == 0.0
    if case == "no_valid":
        assert cvalid.tolist() == [True, False, True]


@functools.lru_cache(maxsize=None)
def _long(kind):
    """One contig of 2000 segments of 64 windows at M = 16: the port's
    segment operators ('highest') of a random or a near-identity T (1e-3 off
    the diagonal), with the sequential f32 and f64 scans over them."""
    rng = np.random.RandomState(11)
    M, n, L, n_keys = 16, 2000, 64, 89
    D = rng.dirichlet(np.ones(M), size=M)
    T = (1 - 1e-3) * np.eye(M) + 1e-3 * D if kind == "near_identity" else D
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    keys = torch.as_tensor(rng.randint(0, n_keys, (n, L)).astype(np.int32))
    valid = torch.as_tensor(rng.rand(n, L) < 0.9)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    ops, logs = twk.segment_ops_plain(f32(T), f32(E), keys, valid, "highest")
    args = (f32(rng.dirichlet(np.ones(M))), ops, logs, np.arange(n)[None],
            torch.any(valid, 1))
    seq32 = twk.contig_boundaries_plain(*args)
    pi, ops, logs, soc, seg_has = args
    seq64 = twk.contig_boundaries_plain(pi.double(), ops.double(), logs.double(),
                                        soc, seg_has)
    return args, seq32, seq64


@pytest.mark.parametrize("chunk", [None, 8, 64])
@pytest.mark.parametrize("kind", ["random", "near_identity"])
def test_chunked_scan_long_contig(kind, chunk):
    """2000 slots in chunks of 8, 64 and the plan's 32: within K6's
    tolerances of the sequential f32 loop, and as near the f64 loop."""
    args, seq32, seq64 = _long(kind)
    if chunk is None:
        chunk = twk.boundary_plan(args[3].shape[1])[0]
        assert chunk == 32
    ll, A_in, Q_end, cvalid = twk.contig_boundaries_chunked_plain(*args, chunk)
    for (rtol, atol, ll_rtol), want in [((1e-5, 1e-7, 1e-6), seq32),
                                        ((1e-6, 1e-7, 1e-8), seq64)]:
        np.testing.assert_allclose(float(ll), float(want[0]), rtol=ll_rtol)
        for got, w in ((A_in, want[1]), (Q_end, want[2])):
            np.testing.assert_allclose(got.double().numpy(), w.double().numpy(),
                                       rtol=rtol, atol=atol)
    assert torch.equal(cvalid, seq32[3])


@pytest.mark.parametrize("tail", [0, 3])
@pytest.mark.parametrize("M", [2, 16])
@pytest.mark.parametrize("G", [2, 8, 32])
def test_chunk_products_match_tree_reduce(G, M, tail):
    """One chunk row of G slots, the last ``tail`` of them padded, against
    the JAX span kernel's ordered product (identities in the padded slots),
    each scaled to a largest entry of 1; the twin's largest entry lies in
    [1, 2)."""
    rng = np.random.RandomState(G + M + tail)
    ops = rng.uniform(0.01, 1.0, (G, M, M)).astype(np.float32)
    row = np.arange(G)
    row[G - tail:] = -1
    got = twk.chunk_products_plain(torch.as_tensor(ops), row[None])[0].numpy()
    As = np.where((row < 0)[:, None, None], np.eye(M), ops.astype(np.float64))
    want, _ = jhmm._tree_reduce(jnp.asarray(As), jnp.zeros(G))
    want = np.asarray(want)
    assert 1.0 <= np.abs(got).max() < 2.0
    np.testing.assert_allclose(got / np.abs(got).max(), want / np.abs(want).max(),
                               rtol=1e-6)


@pytest.mark.parametrize("NS,C,plan,rows", [
    (6104, 1, (64, 96), 96),    # the posterior contig
    (3907, 2, (64, 62), 124),   # the slice
    (306, 22, (16, 20), 440),   # C3
    (1, 1, (8, 1), 1),
    (7, 3, (8, 1), 3),
    (8, 2, (8, 1), 2),
    (10**6, 1, (128, 7813), 7813),
])
def test_boundary_plan(NS, C, plan, rows):
    assert twk.boundary_plan(NS) == plan
    socn = np.arange(C * NS, dtype=np.int32).reshape(C, NS)
    r, n_chunks = twk._chunk_rows(socn, plan[0])
    assert n_chunks == plan[1] and r.shape == (rows, plan[0])
    assert r.dtype == np.int32 and np.array_equal(r.reshape(C, -1)[:, :NS], socn)
    assert (r.reshape(C, -1)[:, NS:] == -1).all()
