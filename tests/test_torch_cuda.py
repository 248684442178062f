"""The port's CUDA kernels (K1 asc_sweep, K2 dsc_sweep, K2g dsc_sweep_gamma,
K3 segment_ops, K4 viterbi_ops, K5 viterbi_paths, K6 boundary_scan, K7
viterbi_boundary) against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  On the GPU
machine run them without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: at 'highest' both sides are exact-f32 recursions that differ
only in summation order (the kernels use FMA chains, torch its matmul), and
K2 accumulates xisum/gsum per segment in f64 where the plain version sums
over segments in f32 first: rtol 1e-5 (the bound of
tests/test_pallas_sweeps.py).  At 'default' the carries are rounded to bf16
at the same points on both sides, but an ulp-level f32 difference can flip
a bf16 rounding: a stored bf16 value may differ by one bf16 ulp (at most
2^-7 relative), and quantities computed from such carries are held at
rtol 1e-3.  K4 and K5 add and take maxima only, which round alike in any
order: they must equal their plain versions exactly, and so must K7.  K5
runs as two launches (``ViterbiPaths``: the forward sweep, then the
backtrace), held together and one at a time, on inputs with exact ties
(tests/_viterbi_ties.py), where its backpointer must be the lowest
maximizing state as in the plain version.  K2
and K2g sum their partials in an order fixed by (S, n_keys, M) (gsum in
64-bit fixed point, xisum in warp order), so two launches must agree bit
for bit.  K6 is an f32 recursion in another summation order: rtol 1e-5 /
atol 1e-7 on the boundary vectors (normalized to a sum or a maximum of 1),
rtol 1e-6 on the f64 log-likelihood, against the sequential loop
(``contig_boundaries_plain``).  K6 is a chunked scan (f64 chunk products
and chunk scan, then an f32 finish over each chunk), so against its chunked
twin (``contig_boundaries_chunked_plain``, the same phases in torch) it is
held closer: rtol 1e-6 / atol 1e-8 on the vectors, rtol 1e-9 on ll; its
phases 1 and 2 alone at rtol 1e-12 (f64 products) and 1e-6 (start vectors
rounded to f32).

K3 sums each step's exact products in f64 on the tensor cores and rounds
each sum once to f32; its plain version is the same loop summed in f64
(``segment_ops_plain(..., sum_dtype=torch.float64)``, ``_k3_plain``).  The
two round the same f32 value except where an exact sum lies within the f64
sums' rounding error of an f32 rounding boundary, so they agree bit for bit
in practice, and are held at the tolerances above: ops rtol 1e-5 with f32
carries and 1e-3 at 'default', logs rtol 1e-5.  (A sum formed in f32 in
another order than the plain loop's would miss 'default': a last-bit
difference flips a bf16 rounding, 2^-8 relative, about once in 2^16 sums.)
With f32 carries K3 also stays within rtol 1e-5 of the plain loop summed in
f32, the reference's summation, over segments of a few hundred windows.
Two launches are bit-identical.

K1 likewise forms each window's products a T on the f64 tensor cores (16
segments a warp, the segments as the tile's rows) and rounds each sum once
to f32; its plain version is ``asc_sweep_plain(..., sum_dtype=torch.float64)``
(``_k1_plain``), which it matches bit for bit in practice.  It is held to
that plain version at rtol 1e-5 (alpha_end, the f32 stream) and one bf16 ulp
(the bf16 stream at 'default'), the count of differing entries printed, and
still to the default plain version (f32 sums, the reference's) at the same
tolerances: K1's carry is f32 at every rung, so a flipped bf16 rounding of
the stream never feeds back into the recursion.
"""

import numpy as np
import pytest
import torch

from smcpp_tpu_torch.ops import window_kernel as wk

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0**-7  # one bf16 ulp, relative, at worst


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(seed, S, L, M, n_keys, dev):
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.9
    valid[-2:] = False
    A_in = rng.rand(S, M)
    Q_end = rng.rand(S, M)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    return (f(T), f(E), torch.as_tensor(keys, device=dev),
            torch.as_tensor(valid, device=dev), f(A_in), f(Q_end))


def _close(got, want, rtol, atol_frac):
    got, want = got.double().cpu(), want.double().cpu()
    atol = atol_frac * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def _k3_plain(T, E, keys, valid, precision):
    "K3's plain version: the window loop with f64 sums (module docstring)."
    return wk.segment_ops_plain(T, E, keys, valid, precision, sum_dtype=torch.float64)


def _check_k3(T, E, keys, valid, precision, rtol):
    """K3 against its plain version at the module's tolerances; two launches
    bit-identical."""
    ops, logs = wk.segment_ops_cuda(T, E, keys, valid, precision)
    ops2, logs2 = wk.segment_ops_cuda(T, E, keys, valid, precision)
    torch.cuda.synchronize()
    assert torch.equal(ops, ops2) and torch.equal(logs, logs2)
    ops_p, logs_p = _k3_plain(T, E, keys, valid, precision)
    _close(ops, ops_p, rtol, 1e-7)
    _close(logs, logs_p, 1e-5, 1e-6)
    return ops, logs


# M = 15 and 17 are the stage-2 M of estimate's defaults (balanced states
# and empirical TMRCA); 15 pads to 16 lanes with one masked lane.
MS = [2, 5, 15, 16, 17, 32]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("precision,rtol", [("highest", 1e-5), ("default", 1e-3)])
def test_segment_ops_matches_plain(dev, M, precision, rtol):
    T, E, keys, valid, _, _ = _problem(0, 40, 256, M, 89, dev)
    before = wk.SEGMENT_OPS.launches
    ops, logs = _check_k3(T, E, keys, valid, precision, rtol)
    assert wk.SEGMENT_OPS.launches == before + 2
    if precision == "highest":  # the reference's f32 summation
        ops_p, logs_p = wk.segment_ops_plain(T, E, keys, valid, precision)
        _close(ops, ops_p, rtol, 1e-7)
        _close(logs, logs_p, 1e-5, 1e-6)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("precision,rtol", [("highest", 1e-5), ("default", 1e-3)])
def test_segment_ops_long_segments(dev, M, precision, rtol):
    """S = 16 segments of L = 8192 windows (C3's L) with a near-identity T,
    as the fits have (diagonal about 0.98): 8192 dependent steps, each a
    chance for a rounding to drift or flip."""
    rng = np.random.RandomState(11)
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T = torch.as_tensor(T / T.sum(1, keepdims=True), dtype=torch.float32, device=dev)
    E = torch.as_tensor(rng.uniform(0.05, 1.0, (128, M)), dtype=torch.float32, device=dev)
    keys = torch.as_tensor(rng.randint(0, 128, (16, 8192)).astype(np.int32), device=dev)
    valid = rng.rand(16, 8192) < 0.95
    valid[-1, 4096:] = False
    _check_k3(T, E, keys, torch.as_tensor(valid, device=dev), precision, rtol)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("precision,rtol", [("highest", 1e-5), ("default", 1e-3)])
def test_sweeps_match_plain(dev, M, precision, rtol):
    T, E, keys, valid, A_in, Q_end = _problem(1, 40, 200, M, 89, dev)
    alphas, a_end = wk.asc_sweep_cuda(T, E, keys, valid, A_in, precision)
    alphas_p, a_end_p = wk.asc_sweep_plain(T, E, keys, valid, A_in, precision)
    assert alphas.dtype == alphas_p.dtype == wk.carry_dtype(precision, torch.float32)
    # the stream is stored in the carry dtype; the alpha carry itself is f32
    _close(alphas, alphas_p, BF16_ULP if precision == "default" else rtol, 1e-7)
    _close(a_end, a_end_p, 1e-5, 1e-7)
    # K2 on the same (plain) alpha stream, so only K2 differs
    u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas_p.contiguous(), Q_end)
    u_p, xo_p, gs_p = wk.dsc_sweep_plain(T, E, keys, valid, alphas_p, Q_end)
    torch.cuda.synchronize()
    _close(u, u_p, 1e-5, 1e-7)
    _close(xo, xo_p, 1e-5, 1e-8)
    _close(gs, gs_p, 1e-5, 1e-8)
    # conservation: every valid window's posterior sums to one
    assert abs(float(gs.sum()) - float(valid.sum())) < 1e-6 * float(valid.sum())


def test_large_key_table_uses_extended_shared_memory(dev):
    """500 keys at M = 32 put every kernel's shared memory over the 48 KB
    default, the opt-in path: K3 66 KB, K1 70 KB; K2's tables (192 KB) with
    its eight warps' f32 alpha buffers and u vectors (66 KB) pass a block's
    227 KB, so K2 takes the global-table route with 66 KB of shared memory.
    Tables past a block's shared memory: test_large_key_tables_match_plain."""
    T, E, keys, valid, A_in, Q_end = _problem(4, 24, 96, 32, 500, dev)
    _check_k3(T, E, keys, valid, "highest", 1e-5)
    alphas, a_end = wk.asc_sweep_cuda(T, E, keys, valid, A_in, "highest")
    alphas_p, a_end_p = wk.asc_sweep_plain(T, E, keys, valid, A_in, "highest")
    _close(alphas, alphas_p, 1e-5, 1e-7)
    u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas_p, Q_end)
    u_p, xo_p, gs_p = wk.dsc_sweep_plain(T, E, keys, valid, alphas_p, Q_end)
    torch.cuda.synchronize()
    _close(xo, xo_p, 1e-5, 1e-8)
    _close(gs, gs_p, 1e-5, 1e-8)


@pytest.mark.parametrize("n_keys", [1000, 2000])
@pytest.mark.parametrize("M", [16, 32])
@pytest.mark.parametrize("precision,rtol", [("highest", 1e-5), ("default", 1e-3)])
def test_large_key_tables_match_plain(dev, n_keys, M, precision, rtol):
    """Tables past a block's shared memory (K2 from 606 keys at M = 32, K1
    from 1415, K3 from about 1800): every kernel reads its emission rows
    from global memory and agrees with its plain version."""
    T, E, keys, valid, A_in, Q_end = _problem(6, 24, 96, M, n_keys, dev)
    _check_k3(T, E, keys, valid, precision, rtol)
    alphas, a_end = wk.asc_sweep_cuda(T, E, keys, valid, A_in, precision)
    alphas_p, a_end_p = wk.asc_sweep_plain(T, E, keys, valid, A_in, precision)
    _close(alphas, alphas_p, BF16_ULP if precision == "default" else rtol, 1e-7)
    _close(a_end, a_end_p, 1e-5, 1e-7)
    alphas_p = alphas_p.contiguous()
    u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas_p, Q_end)
    u_p, xo_p, gs_p = wk.dsc_sweep_plain(T, E, keys, valid, alphas_p, Q_end)
    _close(u, u_p, 1e-5, 1e-7)
    _close(xo, xo_p, 1e-5, 1e-8)
    _close(gs, gs_p, 1e-5, 1e-8)
    *_, gam = wk.dsc_sweep_gamma_cuda(T, E, keys, valid, alphas_p, Q_end)
    *_, gam_p = wk.dsc_sweep_plain(T, E, keys, valid, alphas_p, Q_end, True)
    _close(gam, gam_p, 1e-5, 1e-7)
    W = wk.viterbi_ops_cuda(T, E, keys, valid)
    assert torch.equal(W, wk.viterbi_ops_plain(T, E, keys, valid))
    entry, exit_ = _states(7, 24, M, dev)
    path = wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)
    torch.cuda.synchronize()
    assert torch.equal(path, wk.viterbi_paths_plain(T, E, keys, valid, entry, exit_))


def _states(seed, S, M, dev):
    rng = np.random.RandomState(seed)
    return tuple(
        torch.as_tensor(rng.randint(0, M, S).astype(np.int32), device=dev)
        for _ in range(2)
    )


@pytest.mark.parametrize("M", MS)
def test_dsc_sweep_gamma_matches_plain(dev, M):
    T, E, keys, valid, A_in, Q_end = _problem(8, 40, 200, M, 89, dev)
    alphas, _ = wk.asc_sweep_plain(T, E, keys, valid, A_in, "highest")
    before = wk.DSC_SWEEP_GAMMA.launches
    u, xo, gs, gam = wk.dsc_sweep_gamma_cuda(T, E, keys, valid, alphas, Q_end)
    torch.cuda.synchronize()
    assert wk.DSC_SWEEP_GAMMA.launches == before + 1
    u_p, xo_p, gs_p, gam_p = wk.dsc_sweep_plain(T, E, keys, valid, alphas, Q_end, True)
    assert gam.shape == (40, 200, M) and gam.dtype == torch.float32
    _close(gam, gam_p, 1e-5, 1e-7)
    _close(u, u_p, 1e-5, 1e-7)
    _close(gs, gs_p, 1e-5, 1e-8)
    # each valid window's posterior sums to one; invalid windows hold zero
    sums = gam.sum(-1)
    torch.testing.assert_close(sums[valid], torch.ones_like(sums[valid]),
                               rtol=0, atol=1e-5)
    assert float(gam[~valid].abs().max()) == 0.0


@pytest.mark.parametrize("M", MS)
def test_viterbi_ops_matches_plain(dev, M):
    T, E, keys, valid, _, _ = _problem(9, 40, 200, M, 89, dev)
    before = wk.VITERBI_OPS.launches
    W = wk.viterbi_ops_cuda(T, E, keys, valid)
    torch.cuda.synchronize()
    assert wk.VITERBI_OPS.launches == before + 1
    assert torch.equal(W, wk.viterbi_ops_plain(T, E, keys, valid))


@pytest.mark.parametrize("M", MS)
def test_viterbi_paths_matches_plain(dev, M):
    T, E, keys, valid, _, _ = _problem(10, 40, 200, M, 89, dev)
    entry, exit_ = _states(11, 40, M, dev)
    before = wk.VITERBI_PATHS.launches
    path = wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)
    torch.cuda.synchronize()
    assert wk.VITERBI_PATHS.launches == before + 1
    assert path.shape == (40, 200) and path.dtype == torch.int32
    assert torch.equal(path, wk.viterbi_paths_plain(T, E, keys, valid, entry, exit_))
    # a boundary state outside [0, M) would index past the backpointers
    exit_[3] = M
    with pytest.raises(ValueError, match="boundary states"):
        wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)


def _tie_problem(seed, S, L, M, n_keys, a, b, dev):
    "tests/_viterbi_ties.py's inputs on the card."
    from _viterbi_ties import tie_inputs

    T, E, keys, valid, entry, exit_ = tie_inputs(seed, S, L, M, n_keys, a, b)
    f = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return f(T), f(E), f(keys), f(valid), f(entry), f(exit_)


def _check_k5(T, E, keys, valid, entry, exit_):
    """K5 against viterbi_paths_plain, bit for bit, and its launches one at
    a time (ViterbiPaths.fwd, then .back) against the wrapper's call."""
    before = wk.VITERBI_PATHS.launches
    path = wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)
    torch.cuda.synchronize()
    assert wk.VITERBI_PATHS.launches == before + 1
    assert path.shape == keys.shape and path.dtype == torch.int32
    assert torch.equal(path, wk.viterbi_paths_plain(T, E, keys, valid, entry, exit_))
    k5 = wk.ViterbiPaths(T, E, keys, valid, entry, exit_)
    k5.fwd()
    torch.cuda.synchronize()
    assert torch.equal(k5.back(), path)
    assert wk.VITERBI_PATHS.launches == before + 1
    return path


@pytest.mark.parametrize("L", [7, 32, 33, 200])
@pytest.mark.parametrize("M", MS)
def test_viterbi_paths_ties_match_plain(dev, M, L):
    """Twin states a < b tie exactly at every valid window: the kernel takes
    a, as the plain version does, and is at b only where it is."""
    a, b = (0, 1) if M == 2 else (M // 3, M - 2)
    args = _tie_problem(M * 1000 + L, 13, L, M, 40, a, b, dev)
    path = _check_k5(*args)
    assert bool((path == a).any())


@pytest.mark.parametrize("L", [7, 32, 33, 200])
@pytest.mark.parametrize("M", MS)
def test_viterbi_paths_edge_shapes(dev, M, L):
    """S not a multiple of the 4 warps a block, L not a multiple of the 4
    windows a word or the 32 of a backtrace block, an all-invalid segment,
    and invalid runs across 32-window blocks."""
    T, E, keys, valid, _, _ = _problem(40 + M, 13, L, M, 89, dev)
    valid[3] = False
    valid[5, 20:70] = False
    valid[7, 30:34] = False
    valid[8, : L // 2] = False
    entry, exit_ = _states(41 + M, 13, M, dev)
    _check_k5(T, E, keys, valid, entry, exit_)


@pytest.mark.parametrize("n_keys,shared_table", [(1000, True), (2000, False)])
def test_viterbi_paths_table_routes(dev, n_keys, shared_table):
    """The emission table in shared memory (1000 keys at M = 32: 125 KB)
    and past a block's shared memory (2000 keys: 250 KB, read from global
    memory)."""
    M = 32
    assert wk.viterbi_paths_plan(24, 200, M, n_keys)["shared_table"] is shared_table
    T, E, keys, valid, _, _ = _problem(42, 24, 200, M, n_keys, dev)
    _check_k5(T, E, keys, valid, *_states(43, 24, M, dev))


def test_viterbi_paths_is_bitwise_repeatable(dev):
    T, E, keys, valid, _, _ = _problem(44, 37, 300, 32, 89, dev)
    entry, exit_ = _states(45, 37, 32, dev)
    a = wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)
    b = wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _decode_problem(seed, dev):
    "Two contigs of span-compressed rows packed to windows, with row ends."
    rng = np.random.RandomState(seed)
    M, n_keys = 16, 30
    data = []
    for n_rows in (700, 400):
        d = np.zeros((n_rows, 2), np.int64)
        d[:, 0] = rng.randint(1, 20, n_rows)
        d[:, 1] = rng.randint(0, n_keys, n_rows)
        data.append(d)
    key_id = {(k,): k for k in range(n_keys)}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16, min_seg_len=64)
    ends = wk.pack_window_row_ends([d[:, 0] for d in data], keys.shape[1], soc)
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M) * 5, size=M) + np.eye(M) * 5
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    cpu = (*wk.from_numpy(pi, T, E, "cpu"), torch.as_tensor(keys),
           torch.as_tensor(valid), soc, torch.as_tensor(ends))
    gpu = (*wk.from_numpy(pi, T, E, dev), torch.as_tensor(keys, device=dev),
           torch.as_tensor(valid, device=dev), soc, torch.as_tensor(ends, device=dev))
    return cpu, gpu, [d[:, 0] for d in data]


def test_decode_gammas_windows_cuda_matches_plain(dev):
    cpu, gpu, spans = _decode_problem(12, dev)
    ll, g = wk.decode_gammas_windows(*gpu)
    ll_p, g_p = wk.decode_gammas_windows(*cpu)
    _close(ll.reshape(1), ll_p.reshape(1), 1e-5, 0.0)
    # row masses are differences of f32 prefix sums that reach PREFIX_BLOCK
    # windows, summed in another order on the card (a parallel scan): each
    # carries a few f32 ulps of PREFIX_BLOCK, absolute
    atol = 4 * wk.PREFIX_BLOCK * 2.0**-24
    torch.testing.assert_close(g.cpu(), g_p, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(g.sum(1).cpu().numpy(), np.concatenate(spans),
                               rtol=1e-4)


def test_viterbi_windows_cuda_matches_plain(dev):
    cpu, gpu, _ = _decode_problem(13, dev)
    got = wk.viterbi_windows(*gpu).cpu()
    want = wk.viterbi_windows(*cpu)
    # log T and log E come from the card's and the CPU's logf: an ulp apart
    # at most, which can flip a near-tie
    assert float((got == want).double().mean()) >= 0.999
    with pytest.raises(NotImplementedError, match="B6"):
        wk.viterbi_windows(*gpu, block=8)


def test_estep_direct_cuda_matches_plain(dev):
    T, E, keys, valid, _, _ = _problem(2, 64, 512, 16, 89, dev)
    soc = np.arange(64).reshape(4, 16)
    pi = torch.full((16,), 1 / 16, dtype=torch.float32, device=dev)
    got = wk.estep_direct(pi, T, E, keys, valid, soc, precision="highest")
    want = wk.estep_direct(
        pi.cpu(), T.cpu(), E.cpu(), keys.cpu(), valid.cpu(), soc,
        precision="highest",
    )
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-8)


def test_unsupported_modes_raise_on_cuda(dev):
    T, E, keys, valid, A_in, Q_end = _problem(3, 8, 64, 16, 20, dev)
    with pytest.raises(NotImplementedError, match="B3"):
        wk.stats_pass(T, E, keys, valid, A_in, Q_end, alpha_remat=8)
    # the emit_gamma mode is ported: K1 then K2g
    got = wk.stats_pass(T, E, keys, valid, A_in, Q_end, precision="highest",
                        emit_gamma=True)
    want = wk.stats_pass(*(x.cpu() for x in (T, E, keys, valid, A_in, Q_end)),
                         precision="highest", emit_gamma=True)
    assert len(got) == 5 and got[4].shape == (8, 64, 16)
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-7)
    with pytest.raises(TypeError):
        wk.segment_ops_cuda(T.double(), E.double(), keys, valid, "highest")


# --- K1: 16 segments per warp on the f64 tensor cores (window_kernels.cu) --

def _k1_plain(T, E, keys, valid, A_in, precision):
    "K1's plain version: the ascending sweep with f64 sums (module docstring)."
    return wk.asc_sweep_plain(T, E, keys, valid, A_in, precision, sum_dtype=torch.float64)


def _check_k1(T, E, keys, valid, A_in, precision):
    """K1 against its plain version and the default plain version, at rtol
    1e-5 (alpha_end, the f32 stream) or one bf16 ulp (the bf16 stream); two
    launches bit-identical.  Prints the count of entries that differ from
    the plain version's bits."""
    before = wk.ASC_SWEEP.launches
    alphas, a_end = wk.asc_sweep_cuda(T, E, keys, valid, A_in, precision)
    alphas2, a_end2 = wk.asc_sweep_cuda(T, E, keys, valid, A_in, precision)
    torch.cuda.synchronize()
    assert wk.ASC_SWEEP.launches == before + 2
    assert torch.equal(alphas, alphas2) and torch.equal(a_end, a_end2)
    s_tol = BF16_ULP if precision == "default" else 1e-5
    for plain in (_k1_plain, wk.asc_sweep_plain):
        alphas_p, a_end_p = plain(T, E, keys, valid, A_in, precision)
        assert alphas.dtype == alphas_p.dtype
        _close(alphas, alphas_p, s_tol, 1e-7)
        _close(a_end, a_end_p, 1e-5, 1e-7)
        if plain is _k1_plain:
            print(f"asc_sweep: {int((alphas != alphas_p).sum())} of {alphas.numel()} "
                  f"stream entries and {int((a_end != a_end_p).sum())} of "
                  f"{a_end.numel()} alpha_end entries differ from the plain version's bits")
    return alphas, a_end


@pytest.mark.parametrize("S,L", [(5, 200), (16, 200), (40, 200), (21, 203)])
@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_asc_sweep_matches_f64_plain(dev, S, L, M, precision):
    """A partial warp of segments (5), a full one (16), two and a half (40);
    L = 200 is not a multiple of the 32-window chunk (the staged keys take
    the unaligned route), and at L = 203 the stream's rows start at every
    alignment."""
    T, E, keys, valid, A_in, _ = _problem(40, S, L, M, 89, dev)
    _check_k1(T, E, keys, valid, A_in, precision)


@pytest.mark.parametrize("M", [16, 32])
def test_asc_sweep_identity_T(dev, M):
    """T = I: each step's quotients are e a / max(e a) of the carry itself.
    Emissions over 2^-30 .. 1 drive entries far below their row's maximum,
    past the range of the kernel's one-reciprocal quotient (where the step
    divides with `/`), into subnormals and to zero; 48 segments leave no
    row of a warp empty."""
    rng = np.random.RandomState(46)
    T = torch.eye(M, dtype=torch.float32, device=dev)
    E = torch.as_tensor(np.exp2(-30 * rng.rand(64, M)), dtype=torch.float32, device=dev)
    keys = torch.as_tensor(rng.randint(0, 64, (48, 512)).astype(np.int32), device=dev)
    valid = torch.as_tensor(rng.rand(48, 512) < 0.95, device=dev)
    A_in = torch.as_tensor(rng.rand(48, M), dtype=torch.float32, device=dev)
    alphas, _ = _check_k1(T, E, keys, valid, A_in, "highest")
    a = alphas[alphas > 0]
    assert float(a.min()) < 2.0**-126 and int((alphas == 0).sum()) > 0


def test_asc_division_is_ieee(dev):
    """K1's quotients (one reciprocal per row, then one product corrected by
    its exact residual per entry) equal IEEE division bit for bit over every
    f32 significand of the divisor at five exponents, against dividends from
    2^-90 b to b (log-uniform) and just below b: every pair in the kernel's
    fast range agrees."""
    mant = 1.0 + np.arange(1 << 23, dtype=np.float64) * 2.0**-23
    rng = np.random.RandomState(47)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    for eb in (-40, -7, 0, 1, 99):
        b = mant * 2.0**eb
        for a in (b * np.exp2(-90 * rng.rand(b.size)), b * (1 - 2.0**-12 * rng.rand(b.size))):
            checked, bad = wk.asc_div_check(f(a), f(b))
            assert bad == 0 and checked >= b.size // 2


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_asc_sweep_long_segments(dev, M, precision):
    """16 segments of 8192 windows (C3's L) with a near-identity T: 8192
    dependent steps, each a chance for a rounding to drift or flip; L is a
    multiple of 16, so the keys and flags are staged with cp.async."""
    rng = np.random.RandomState(41)
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T = torch.as_tensor(T / T.sum(1, keepdims=True), dtype=torch.float32, device=dev)
    E = torch.as_tensor(rng.uniform(0.05, 1.0, (128, M)), dtype=torch.float32, device=dev)
    keys = torch.as_tensor(rng.randint(0, 128, (16, 8192)).astype(np.int32), device=dev)
    valid = rng.rand(16, 8192) < 0.95
    valid[-1, 4096:] = False
    A_in = torch.as_tensor(rng.rand(16, M), dtype=torch.float32, device=dev)
    _check_k1(T, E, keys, torch.as_tensor(valid, device=dev), A_in, precision)


@pytest.mark.parametrize("n_keys", [89, 1000, 2000])
@pytest.mark.parametrize("M", [15, 16, 32])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_asc_sweep_table_routes(dev, n_keys, M, precision):
    """The emission table in shared memory beside the staged keys, or past
    a block's 227 KB (2000 keys at M = 32) in global memory; 37 segments
    leave the last warp 5 rows; the grid has one block per warp."""
    T, E, keys, valid, A_in, _ = _problem(42, 37, 96, M, n_keys, dev)
    _check_k1(T, E, keys, valid, A_in, precision)
    plan = wk.asc_sweep_plan(37, M, n_keys, precision == "default")
    assert plan["warps_per_block"] * plan["blocks"] == 3
    assert plan["shared_table"] == int(not (n_keys == 2000 and M == 32))
    assert plan["spill_bytes"] == 0


def test_asc_sweep_invalid_runs_across_chunks(dev):
    """Runs of invalid windows over the 32-window chunk boundaries, whole
    invalid segments, and rows of one warp with different valid flags."""
    T, E, keys, valid, A_in, _ = _problem(43, 20, 256, 17, 89, dev)
    valid[:, 20:70] = False
    valid[::3, 180:] = False
    valid[5] = False
    valid[6, :100] = False
    _, a_end = _check_k1(T, E, keys, valid, A_in, "default")
    assert torch.equal(a_end[5], A_in[5])


# --- K2 / K2g: the one-warp-per-segment body (csrc/dsc_kernels.cu) -------

# key count whose tables (12 B x n_keys x M) pass a block's 227 KB, so the
# kernel takes the global-memory route for the emission and gsum tables
def _keys_past_smem(M):
    return max(2000, 232448 // (12 * M) + 1)


def _dsc_inputs(seed, S, L, M, n_keys, dev, precision="highest", p_valid=0.9):
    """Inputs of the descending sweep: the plain ascending sweep's alpha
    stream (carry dtype of ``precision``) on random T, E, keys and valid."""
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < p_valid
    A_in, Q_end = rng.rand(S, M), rng.rand(S, M)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    T, E, A_in, Q_end = f(T), f(E), f(A_in), f(Q_end)
    keys = torch.as_tensor(keys, device=dev)
    valid = torch.as_tensor(valid, device=dev)
    return T, E, keys, valid, A_in, Q_end, precision


def _check_dsc(T, E, keys, valid, A_in, Q_end, precision):
    """K2 and K2g against dsc_sweep_plain on the same alpha stream (rtol
    1e-5, the module's bound); K2g's u, xo and gsum equal K2's bit for bit;
    gsum sums to the number of valid windows (to 1e-6)."""
    alphas, _ = wk.asc_sweep_plain(T, E, keys, valid, A_in, precision)
    alphas = alphas.contiguous()
    u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end)
    u2, xo2, gs2, gam = wk.dsc_sweep_gamma_cuda(T, E, keys, valid, alphas, Q_end)
    u_p, xo_p, gs_p, gam_p = wk.dsc_sweep_plain(T, E, keys, valid, alphas, Q_end, True)
    torch.cuda.synchronize()
    _close(u, u_p, 1e-5, 1e-7)
    _close(xo, xo_p, 1e-5, 1e-8)
    _close(gs, gs_p, 1e-5, 1e-8)
    _close(gam, gam_p, 1e-5, 1e-7)
    for a, b in ((u, u2), (xo, xo2), (gs, gs2)):
        assert torch.equal(a, b)
    nv = float(valid.sum())
    assert abs(float(gs.sum()) - nv) <= 1e-6 * max(nv, 1.0)
    return gs


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("M", [2, 15, 16, 17, 32])
def test_dsc_sweep_table_routes_match_plain(dev, M, route):
    "89 keys keep the tables in shared memory; past 227 KB they go global."
    n_keys = 89 if route == "shared" else _keys_past_smem(M)
    _check_dsc(*_dsc_inputs(20, 40, 200, M, n_keys, dev))


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("M,precision", [(16, "default"), (32, "highest")])
def test_dsc_sweep_is_bitwise_repeatable(dev, M, precision, route):
    """Two launches give identical u, xo and gsum, and K2g's gamma: 70
    segments fill nine blocks whose warps add to one gsum table at once."""
    n_keys = 89 if route == "shared" else _keys_past_smem(M)
    T, E, keys, valid, A_in, Q_end, _ = _dsc_inputs(21, 70, 200, M, n_keys, dev)
    alphas, _ = wk.asc_sweep_plain(T, E, keys, valid, A_in, precision)
    alphas = alphas.contiguous()
    for fn in (wk.dsc_sweep_cuda, wk.dsc_sweep_gamma_cuda):
        a = fn(T, E, keys, valid, alphas, Q_end)
        b = fn(T, E, keys, valid, alphas, Q_end)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# (S, L): one segment; S not a multiple of the 8 warps of a block; L not a
# multiple of the 32-window chunk, and one short chunk; L = 13 at M = 5 makes
# the stream's chunks unaligned (13 x 5 x elt bytes), read with plain loads
@pytest.mark.parametrize("S,L", [(1, 200), (13, 200), (13, 8), (9, 13)])
@pytest.mark.parametrize("M", [5, 16, 32])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_dsc_sweep_edge_shapes_match_plain(dev, S, L, M, precision):
    _check_dsc(*_dsc_inputs(22, S, L, M, 89, dev, precision))


def test_dsc_sweep_one_key_everywhere(dev):
    """Every window of every segment has the same key: all the warps of a
    block add to one row of the gsum table at every step."""
    T, E, keys, valid, A_in, Q_end, prec = _dsc_inputs(23, 40, 200, 16, 89, dev)
    keys.fill_(7)
    gs = _check_dsc(T, E, keys, valid, A_in, Q_end, prec)
    assert float(gs[7].sum()) == pytest.approx(float(valid.sum()), rel=1e-6)
    assert float(gs.abs().sum() - gs[7].abs().sum()) == 0.0


@pytest.mark.parametrize("M", [15, 32])
def test_dsc_sweep_invalid_runs_across_chunks(dev, M):
    """Runs of invalid windows across the 32-window chunk boundaries: a run
    over l = 32 and 64, the top of every segment, one whole segment, and
    the first half of another."""
    T, E, keys, valid, A_in, Q_end, prec = _dsc_inputs(24, 24, 200, M, 89, dev)
    valid[:, 20:70] = False
    valid[::2, 180:] = False
    valid[5] = False
    valid[6, :100] = False
    _check_dsc(T, E, keys, valid, A_in, Q_end, prec)


# --- K6 / K7: the per-contig boundary scans (csrc/boundary_kernels.cu) -----

BOUNDARY_CASES = ["uneven", "no_valid", "unlisted", "one_contig"]


def _boundary_case(case, S, seed):
    """seg_of_contig (C, NS) and a mask on seg_has for S segments: 'uneven'
    three contigs of uneven length with tail padding; 'no_valid' the same
    with every segment of the middle contig empty; 'unlisted' two contigs
    that leave four segments unlisted; 'one_contig' C = 1."""
    rng = np.random.RandomState(seed)
    has = np.ones(S, bool)
    if case == "one_contig":
        return np.arange(S, dtype=np.int64)[None], has
    if case == "unlisted":
        listed = np.sort(rng.choice(S, S - 4, replace=False))
        soc = np.full((2, S), -1, np.int64)
        soc[0, :3] = listed[:3]
        soc[1, : len(listed) - 3] = listed[3:]
        return soc, has
    cuts = np.linspace(0, S, 4).astype(int)
    soc = np.full((3, np.diff(cuts).max()), -1, np.int64)
    for c in range(3):
        soc[c, : cuts[c + 1] - cuts[c]] = np.arange(cuts[c], cuts[c + 1])
    if case == "no_valid":
        has[soc[1][soc[1] >= 0]] = False
    return soc, has


def _boundary_inputs(seed, S, M, case, dev):
    "K3's operators of a random E-step, pi, and a contig layout."
    T, E, keys, valid, _, _ = _problem(seed, S, 64, M, 89, dev)
    ops, logs = wk.segment_ops_cuda(T, E, keys, valid, "highest")
    soc, has = _boundary_case(case, S, seed)
    seg_has = torch.any(valid, 1) & torch.as_tensor(has, device=dev)
    pi = torch.as_tensor(np.random.RandomState(seed).dirichlet(np.ones(M)),
                         dtype=torch.float32, device=dev)
    return pi, ops, logs, soc, seg_has


def _check_boundary_scan(pi, ops, logs, soc, seg_has):
    before = wk.BOUNDARY_SCAN.launches
    ll, A_in, Q_end, cvalid = wk.contig_boundaries(pi, ops, logs, soc, seg_has)
    torch.cuda.synchronize()
    assert wk.BOUNDARY_SCAN.launches == before + 1
    ll_p, A_p, Q_p, cv_p = wk.contig_boundaries_plain(pi, ops, logs, soc, seg_has)
    torch.testing.assert_close(A_in, A_p, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(Q_end, Q_p, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(ll, ll_p, rtol=1e-6, atol=0.0)
    assert ll.dtype == torch.float64 and torch.equal(cvalid, cv_p)
    return ll, A_in, Q_end, cvalid


@pytest.mark.parametrize("case", BOUNDARY_CASES)
@pytest.mark.parametrize("M", MS)
def test_boundary_scan_matches_plain(dev, M, case):
    _, A_in, Q_end, cvalid = _check_boundary_scan(
        *_boundary_inputs(30, 40, M, case, dev))
    soc = _boundary_case(case, 40, 30)[0]
    unlisted = np.setdiff1d(np.arange(40), soc[soc >= 0])
    assert float(A_in[unlisted].abs().sum() + Q_end[unlisted].abs().sum()) == 0.0
    if case == "no_valid":
        assert cvalid.tolist() == [True, False, True]


@pytest.mark.parametrize("M", [2, 16, 32])
def test_boundary_scan_one_segment(dev, M):
    "One contig of one segment: A_in is pi and Q_end is ones."
    pi, ops, logs, soc, seg_has = _boundary_inputs(33, 1, M, "one_contig", dev)
    _, A_in, Q_end, _ = _check_boundary_scan(pi, ops, logs, soc, seg_has)
    assert torch.equal(A_in[0], pi) and torch.equal(Q_end[0], torch.ones_like(pi))


def _check_chunked(pi, ops, logs, soc, seg_has, chunk):
    """K6 at chunk length ``chunk`` (None: boundary_plan's) against its
    chunked twin and the sequential loop (module docstring); one launch
    counted."""
    before = wk.BOUNDARY_SCAN.launches
    got = wk.boundary_scan_cuda(pi, ops, logs, soc, seg_has, chunk=chunk)
    torch.cuda.synchronize()
    assert wk.BOUNDARY_SCAN.launches == before + 1
    k = chunk or wk.boundary_plan(soc.shape[1])[0]
    twin = wk.contig_boundaries_chunked_plain(pi, ops, logs, soc, seg_has, k)
    seq = wk.contig_boundaries_plain(pi, ops, logs, soc, seg_has)
    for want, (rtol, atol, ll_rtol) in ((twin, (1e-6, 1e-8, 1e-9)),
                                        (seq, (1e-5, 1e-7, 1e-6))):
        torch.testing.assert_close(got[1], want[1], rtol=rtol, atol=atol)
        torch.testing.assert_close(got[2], want[2], rtol=rtol, atol=atol)
        torch.testing.assert_close(got[0], want[0], rtol=ll_rtol, atol=0.0)
        assert torch.equal(got[3], want[3])
    return got


@pytest.mark.parametrize("chunk", ["1", "3", "8", "NS", "2NS", "plan"])
@pytest.mark.parametrize("case", BOUNDARY_CASES)
@pytest.mark.parametrize("M", [2, 15, 16, 17, 32])
def test_boundary_scan_chunks_match_plain(dev, M, case, chunk):
    pi, ops, logs, soc, seg_has = _boundary_inputs(37, 40, M, case, dev)
    NS = soc.shape[1]
    k = {"NS": NS, "2NS": 2 * NS, "plan": None}[chunk] if chunk in (
        "NS", "2NS", "plan") else int(chunk)
    _check_chunked(pi, ops, logs, soc, seg_has, k)


@pytest.mark.parametrize("C,NS,M", [(1, 4096, 32), (22, 306, 16)])
def test_boundary_scan_long_contigs(dev, C, NS, M):
    """One contig of 4096 segments at M = 32, and C3's 22 contigs of 306
    segments at M = 16: the plan's chunk length and chunks of 8."""
    pi, ops, logs, _, seg_has = _boundary_inputs(38, C * NS, M, "one_contig", dev)
    soc = np.arange(C * NS, dtype=np.int64).reshape(C, NS)
    for chunk in (None, 8):
        _check_chunked(pi, ops, logs, soc, seg_has, chunk)


@pytest.mark.parametrize("M", [2, 15, 32])
def test_boundary_phases_match_their_twins(dev, M):
    """K6's phases 1 and 2 alone, at chunks of 3 over uneven contigs: the f64
    chunk products against chunk_products_plain, the f32 start vectors
    against the f64 chunk scan's."""
    pi, ops, logs, soc, seg_has = _boundary_inputs(40, 40, M, "uneven", dev)
    k6 = wk.BoundaryScan(pi, ops, logs, soc, seg_has, chunk=3)
    assert k6.n_chunks == 5
    k6.products()
    k6.chunk_scan()
    torch.cuda.synchronize()
    rows, n_chunks = wk._chunk_rows(np.asarray(soc), 3)
    prod = wk.chunk_products_plain(ops, rows)
    torch.testing.assert_close(k6.prod, prod, rtol=1e-12, atol=0.0)
    entry, exit_ = wk._chunk_scan_plain(pi, prod, soc.shape[0], n_chunks)
    torch.testing.assert_close(k6.start_a, entry.float(), rtol=1e-6, atol=0.0)
    torch.testing.assert_close(k6.start_q, exit_.float(), rtol=1e-6, atol=0.0)


def test_boundary_scan_chunked_is_bitwise_repeatable(dev):
    pi, ops, logs, soc, seg_has = _boundary_inputs(39, 300, 32, "uneven", dev)
    a = wk.boundary_scan_cuda(pi, ops, logs, soc, seg_has, chunk=8)
    b = wk.boundary_scan_cuda(pi, ops, logs, soc, seg_has, chunk=8)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _viterbi_boundary_inputs(seed, S, M, ops_kind, dev):
    """Max-plus operators: K4's on a random problem, or small integers with
    5% 'impossible' (-1e30) entries, which force ties; pi has a zero."""
    rng = np.random.RandomState(seed)
    if ops_kind == "k4":
        T, E, keys, valid, _, _ = _problem(seed, S, 64, M, 89, dev)
        W = wk.viterbi_ops_cuda(T, E, keys, valid)
    else:
        W = rng.randint(-3, 1, (S, M, M)).astype(np.float32)
        W[rng.rand(S, M, M) < 0.05] = -1e30
        W = torch.as_tensor(W, device=dev)
    pi = rng.dirichlet(np.ones(M))
    pi[1] = 0.0
    return torch.as_tensor(pi, dtype=torch.float32, device=dev), W


@pytest.mark.parametrize("ops_kind", ["ties", "k4"])
@pytest.mark.parametrize("case", ["uneven", "unlisted", "one_contig"])
@pytest.mark.parametrize("M", MS)
def test_viterbi_boundary_matches_plain(dev, M, case, ops_kind):
    pi, W = _viterbi_boundary_inputs(34, 40, M, ops_kind, dev)
    soc = _boundary_case(case, 40, 34)[0]
    before = wk.VITERBI_BOUNDARY.launches
    entry, exit_ = wk.viterbi_boundary_states(pi, W, soc)
    torch.cuda.synchronize()
    assert wk.VITERBI_BOUNDARY.launches == before + 1
    entry_p, exit_p = wk.viterbi_boundary_states_plain(pi, W, soc)
    assert entry.dtype == exit_.dtype == torch.int32
    assert torch.equal(entry, entry_p) and torch.equal(exit_, exit_p)
    assert not bool((entry[torch.as_tensor(soc[:, 0], device=dev)] == 1).any())


def test_boundary_kernels_are_bitwise_repeatable(dev):
    pi, ops, logs, soc, seg_has = _boundary_inputs(35, 70, 32, "uneven", dev)
    a = wk.boundary_scan_cuda(pi, ops, logs, soc, seg_has)
    b = wk.boundary_scan_cuda(pi, ops, logs, soc, seg_has)
    pi, W = _viterbi_boundary_inputs(35, 70, 32, "ties", dev)
    c = wk.viterbi_boundary_cuda(pi, W, soc)
    d = wk.viterbi_boundary_cuda(pi, W, soc)
    torch.cuda.synchronize()
    for x, y in zip(a + c, b + d):
        assert torch.equal(x, y)


def test_boundary_kernels_reject_what_they_do_not_take(dev):
    pi, ops, logs, soc, seg_has = _boundary_inputs(36, 12, 16, "uneven", dev)
    with pytest.raises(TypeError):
        wk.contig_boundaries(pi, ops.double(), logs, soc, seg_has)
    with pytest.raises(TypeError):
        wk.viterbi_boundary_states(pi, ops.double(), soc)
    big = torch.rand((12, 33, 33), device=dev)
    with pytest.raises(ValueError, match="2 <= M <= 32"):
        wk.contig_boundaries(torch.full((33,), 1 / 33, device=dev), big, logs,
                             soc, seg_has)
    with pytest.raises(ValueError, match="2 <= M <= 32"):
        wk.viterbi_boundary_states(torch.full((33,), 1 / 33, device=dev), big, soc)


# --- K7 as a chunked max-plus scan (ViterbiBoundary) ------------------------
#
# K7 must equal its chunked twin viterbi_boundary_states_chunked_plain bit
# for bit at every chunk length, two launches bit-identical.  Against the
# sequential loop it must give the same states, except in a contig whose
# path scores (viterbi_boundary_path_score) lie within δ
# (viterbi_boundary_delta) of each other; on inputs whose sums are exact
# (small integers, twin states) the states must be equal.

VB_CHUNKS = ["1", "3", "8", "plan", "NS", "2NS"]


def _vb_chunk(chunk, NS):
    "A VB_CHUNKS entry as viterbi_boundary_cuda's chunk (None: the plan's)."
    named = {"plan": None, "NS": NS, "2NS": 2 * NS}
    return named[chunk] if chunk in named else int(chunk)


def _vb_agree(pi, W, soc, got, want, exact):
    "Equal states, or (unless ``exact``) a near-tie in each differing contig."
    diff, gap, delta = wk.viterbi_boundary_agreement(pi, W, soc, got, want)
    assert not bool((diff & (exact | (gap > delta))).any())


def _check_vb(pi, W, soc, chunk, exact=False):
    """K7 at ``chunk`` (None: the plan's) against its twin, repeated, and
    against the sequential loop; one launch counted per call."""
    before = wk.VITERBI_BOUNDARY.launches
    got = wk.viterbi_boundary_cuda(pi, W, soc, chunk=chunk)
    again = wk.viterbi_boundary_cuda(pi, W, soc, chunk=chunk)
    torch.cuda.synchronize()
    assert wk.VITERBI_BOUNDARY.launches == before + 2
    k = chunk or wk.boundary_plan(np.asarray(soc).shape[1])[0]
    twin = wk.viterbi_boundary_states_chunked_plain(pi, W, soc, k)
    for g, a, t in zip(got, again, twin):
        assert g.dtype == torch.int32
        assert torch.equal(g, a) and torch.equal(g, t)
    _vb_agree(pi, W, soc, got, wk.viterbi_boundary_states_plain(pi, W, soc), exact)
    return got


@pytest.mark.parametrize("chunk", VB_CHUNKS)
@pytest.mark.parametrize("ops_kind", ["ties", "k4"])
@pytest.mark.parametrize("case", ["uneven", "unlisted", "one_contig"])
@pytest.mark.parametrize("M", [2, 15, 16, 17, 32])
def test_viterbi_boundary_chunks_match_twin(dev, M, case, ops_kind, chunk):
    pi, W = _viterbi_boundary_inputs(41, 40, M, ops_kind, dev)
    soc = _boundary_case(case, 40, 41)[0]
    entry, _ = _check_vb(pi, W, soc, _vb_chunk(chunk, soc.shape[1]),
                         exact=ops_kind == "ties")
    assert not bool((entry[torch.as_tensor(soc[:, 0], device=dev)] == 1).any())


@pytest.mark.parametrize("C,NS,M", [(1, 4096, 32), (22, 306, 16)])
def test_viterbi_boundary_long_contigs(dev, C, NS, M):
    """One contig of 4096 segments at M = 32, and C3's 22 contigs of 306
    segments at M = 16, on K4's operators: the plan's chunk length and
    chunks of 8."""
    pi, W = _viterbi_boundary_inputs(42, C * NS, M, "k4", dev)
    soc = np.arange(C * NS, dtype=np.int64).reshape(C, NS)
    for chunk in (None, 8):
        _check_vb(pi, W, soc, chunk)


@pytest.mark.parametrize("chunk", ["1", "3", "plan", "NS"])
@pytest.mark.parametrize("M", [2, 15, 16, 17, 32])
def test_viterbi_boundary_twin_states(dev, M, chunk):
    """K4's operators of tests/_viterbi_ties.py's inputs (twin states a <
    b tie at every step): equal to the sequential loop, and b is never a
    boundary state (ties keep the lowest state)."""
    a, b = M // 3, M - 1
    T, E, keys, valid, _, _ = _tie_problem(43, 13, 200, M, 89, a, b, dev)
    W = wk.viterbi_ops_cuda(T, E, keys, valid)
    pi = torch.full((M,), 1.0 / M, device=dev)
    soc = _boundary_case("uneven", 13, 43)[0]
    got = _check_vb(pi, W, soc, _vb_chunk(chunk, soc.shape[1]), exact=True)
    assert not any(bool((g == b).any()) for g in got)


@pytest.mark.parametrize("M", [2, 15, 32])
def test_viterbi_boundary_phases_match_twin(dev, M):
    """K7's launches one at a time, at chunks of 3 over uneven contigs: the
    f64 chunk products and the f32 entry vectors equal the twin's phases 1
    and 2, the row maps and each contig's exit state equal those of the
    twin's forward, and trace() gives the wrapper's states."""
    pi, W = _viterbi_boundary_inputs(44, 40, M, "k4", dev)
    soc = _boundary_case("uneven", 40, 44)[0]
    k7 = wk.ViterbiBoundary(pi, W, soc, chunk=3)
    assert k7.n_chunks == 5
    k7.products()
    k7.chunk_scan()
    k7.forward()
    torch.cuda.synchronize()
    rows, n_chunks = wk._chunk_rows(np.asarray(soc), 3)
    prod = wk.mp_chunk_products_plain(W, rows)
    assert torch.equal(k7.prod, prod)
    entry = wk.mp_chunk_scan_plain(wk._log_pi(pi, torch.float32), prod,
                                   soc.shape[0], n_chunks).float()
    assert torch.equal(k7.entry, entry)
    bp, V = wk._mp_rows_forward(W, rows, entry)
    assert torch.equal(k7.bp.long().view(bp.shape), bp)
    assert np.array_equal(k7.maps.long().cpu().numpy(), wk.mp_row_maps(bp))
    last = torch.argmax(V.view(soc.shape[0], n_chunks, M)[:, -1], 1)
    assert torch.equal(k7.cexit.long(), last)
    got = k7.trace()
    torch.cuda.synchronize()
    want = wk.viterbi_boundary_cuda(pi, W, soc, chunk=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_viterbi_boundary_rejects_what_it_does_not_take(dev):
    pi, W = _viterbi_boundary_inputs(45, 12, 16, "k4", dev)
    soc = _boundary_case("uneven", 12, 45)[0]
    with pytest.raises(ValueError, match="chunk must be at least 1"):
        wk.viterbi_boundary_cuda(pi, W, soc, chunk=0)


# --- K2's gsum check, repeated ---------------------------------------------

def test_dsc_sweep_gsum_check_holds_every_run(dev):
    """chip_smoke.py's K2 check on slice-like inputs (M = 15, 26 keys, a
    near-identity T, segments of 256 windows, the alpha stream of the
    'default' rung), 20 runs: K2 against the plain sweep with each
    window's per-key sums in f64 (``sum_dtype=float64``), whose value does
    not move with the order of index_add_'s atomics, at rtol 1e-5 / atol
    1e-8 of the largest entry, every run."""
    rng = np.random.RandomState(46)
    S, L, M, n_keys = 2048, 256, 15, 26
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T /= T.sum(1, keepdims=True)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    T, E = f(T), f(rng.uniform(0.05, 1.0, (n_keys, M)))
    keys = torch.as_tensor(rng.randint(0, n_keys, (S, L)).astype(np.int32), device=dev)
    valid = torch.as_tensor(rng.rand(S, L) < 0.98, device=dev)
    A_in, Q_end = f(rng.rand(S, M)), f(rng.rand(S, M))
    alphas, _ = wk.asc_sweep_plain(T, E, keys, valid, A_in, "default",
                                   sum_dtype=torch.float64)
    for _ in range(20):
        u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end)
        u_p, xo_p, gs_p = wk.dsc_sweep_plain(T, E, keys, valid, alphas, Q_end,
                                             sum_dtype=torch.float64)
        _close(u, u_p, 1e-5, 1e-7)
        _close(xo, xo_p, 1e-5, 1e-8)
        _close(gs, gs_p, 1e-5, 1e-8)


# --- the span kernel and the row-level decode (ops/hmm.py) ------------------

def _span_problem(seed, C, L, M, n_keys, dev, dtype=torch.float32, max_span=300):
    """(pi, T, E, spans, keys) on the card: C contigs of L rows (chunks of
    64), the second contig all padding when C > 2, the last one ending in
    padding rows and an all-padding chunk."""
    rng = np.random.RandomState(seed)
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M) * 4, size=M) + np.eye(M) * 8
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.02, 1.0, (n_keys, M))
    spans = rng.randint(1, max_span, (C, L)).astype(np.int32)
    if C > 2:
        spans[1] = 0
    spans[-1, L - 64 - 5:] = 0
    keys = rng.randint(0, n_keys, (C, L)).astype(np.int32)
    keys[spans == 0] = 0
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
    return (f(pi), f(T), f(E), torch.as_tensor(spans, device=dev),
            torch.as_tensor(keys, device=dev))


def _launches():
    return {k.name: k.launches for k in wk.KERNELS}


def _launched(before):
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


@pytest.mark.parametrize("M", [2, 15, 32])
@pytest.mark.parametrize("C", [1, 3])
def test_span_estep_runs_k6_once(dev, M, C):
    """hmm.estep on the card: one K6 launch over the chunk products (no
    loop over chunks), and its log-likelihood and gradient (the E-step
    statistics) against plain autograd through every chunk and the
    sequential scan on the card (rtol 1e-6 on ll, 1e-4 / atol 1e-6 of the
    largest entry on the statistics: f32 scans in another order)."""
    from smcpp_tpu_torch.ops import hmm

    pi, T, E, spans, keys = _span_problem(47, C, 256, M, 40, dev)
    nbits = int(spans.max()).bit_length()
    before = _launches()
    got = hmm.estep(pi, T, E, spans, keys, nbits, 64)
    torch.cuda.synchronize()
    assert _launched(before) == {"boundary_scan": 1}
    x = tuple(v.clone().requires_grad_(True) for v in (pi, T, E))
    ll = hmm.loglik(*x, spans, keys, nbits, 64)
    grads = torch.autograd.grad(ll, x)
    _close(got[0].reshape(1), ll.detach().reshape(1), 1e-6, 0.0)
    for g, v, gr in zip(got[1:], (pi, T, E), grads):
        _close(g, v * gr, 1e-4, 1e-6)


@pytest.mark.parametrize("M", [2, 15, 16, 17, 32])
def test_row_powers_k7_matches_twin(dev, M):
    """K7 on the row max-plus powers (f64, rounded to f32, in K7's layout)
    with the rows as segments and padding rows unlisted: bit for bit its
    chunked twin at the plan's chunk length; hmm.viterbi_paths on the card
    launches K7 once and agrees with the f64 sequential loop on the CPU on
    at least 99% of rows (f32 forward against f64: near-ties may flip)."""
    from smcpp_tpu_torch.ops import hmm

    pi, T, E, spans, keys = _span_problem(48, 3, 512, M, 40, dev, torch.float64)
    C, L = spans.shape
    nbits = int(spans.max()).bit_length()
    W = hmm.row_powers(T, E, spans, keys, nbits).transpose(1, 2).float().contiguous()
    sp = spans.cpu().numpy()
    table = np.where(sp > 0, np.arange(C * L).reshape(C, L), -1)
    got = wk.viterbi_boundary_cuda(pi, W, table)
    want = wk.viterbi_boundary_states_chunked_plain(
        pi, W, table, wk.boundary_plan(L)[0])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    before = _launches()
    path = hmm.viterbi_paths(pi, T, E, spans, keys, nbits)
    torch.cuda.synchronize()
    assert _launched(before) == {"viterbi_boundary": 1}
    ref = hmm.viterbi_paths(*(v.cpu() for v in (pi, T, E, spans, keys)), nbits)
    assert path.dtype == torch.int32 and path.shape == (C, L)
    assert float((path.cpu() == ref).double().mean()) >= 0.99


def test_viterbi_paths_at_one_state_is_zeros(dev):
    from smcpp_tpu_torch.ops import hmm

    pi, T, E, spans, keys = _span_problem(49, 2, 128, 1, 5, dev, torch.float64)
    before = _launches()
    path = hmm.viterbi_paths(pi, T, E, spans, keys, 9)
    assert _launched(before) == {}
    assert path.is_cuda and not bool(path.any())


def _row_manager(data, dev, M=5):
    from smcpp_tpu_torch.inference.estimation import balance_hidden_states
    from smcpp_tpu_torch.inference.manager import OnePopInferenceManager
    from smcpp_tpu_torch.models import SMCModel

    m = SMCModel([0.01, 3.0], 20000.0, "piecewise")
    m.y[:] = 0.0
    im = OnePopInferenceManager(2, [data], balance_hidden_states(m, M + 1),
                                ("pop1",), 0.5, device=dev)
    im.set_model(m)
    im.theta, im.rho, im.alpha = 1e-4, 1e-4, 1
    return im


def test_row_decode_matches_window_decode(dev, monkeypatch):
    """The manager past the 70% decode gate on the card: the row-level
    decode (one K6 launch, no window kernel) against the window decode of
    the same manager (rtol 2e-3 / atol 1e-3, tests/test_decode.py's bound),
    and the row-level Viterbi (one K7 launch) against the window Viterbi
    on at least 99% of rows."""
    rng = np.random.RandomState(50)
    data = np.zeros((300, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 40, 300)
    data[:, 1] = rng.randint(0, 3, 300)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, 300)
    im = _row_manager(data, dev)
    assert im._use_windows and im._window_decode_fits()
    im.save_gamma = True
    im.E_step()
    g_win = im.gammas[0]
    p_win = im.map_paths()[0]
    monkeypatch.setattr(im, "_hbm_budget", lambda frac=0.375: 1.0)
    pi, T, E = (x.float().contiguous() for x in im.tensors())
    before = _launches()
    g_row = im._compute_gammas(pi, T, E)[0]
    torch.cuda.synchronize()
    assert _launched(before) == {"boundary_scan": 1}
    np.testing.assert_allclose(g_row, g_win, rtol=2e-3, atol=1e-3)
    before = _launches()
    p_row = im.map_paths()[0]
    assert _launched(before) == {"viterbi_boundary": 1}
    assert (p_row == p_win).mean() >= 0.99


def test_span_kernel_manager_on_card(dev, monkeypatch):
    """The manager with the span kernel picked (forced through the cost
    model's window cost): its E-step launches K6 once (and no window
    kernel), its decode K6 once more and its MAP paths K7 once; the
    log-likelihood, the statistics and the row gammas agree with the same
    manager on the CPU (the plain scans) at rtol 1e-6, 1e-4 / atol 1e-6 of
    the largest entry, and 1e-4 plus 1e-4 of the row's span; the f64 paths
    on at least 99% of rows."""
    from smcpp_tpu_torch.inference.manager import OnePopInferenceManager

    orig = OnePopInferenceManager._init_kernel_choice

    def init(self, data_list, spans):
        self._total_bases = 1e12
        return orig(self, data_list, spans)

    monkeypatch.setattr(OnePopInferenceManager, "_init_kernel_choice", init)
    rng = np.random.RandomState(51)
    data = np.zeros((400, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 400, 400)
    data[:, 1] = rng.randint(0, 3, 400)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, 400)
    ims = [_row_manager(data, d) for d in (dev, torch.device("cpu"))]
    assert not ims[0]._use_windows
    for im in ims:
        im.save_gamma = True
    before = _launches()
    ims[0].E_step()
    torch.cuda.synchronize()
    assert _launched(before) == {"boundary_scan": 2}
    ims[1].E_step()
    np.testing.assert_allclose(ims[0].loglik(), ims[1].loglik(), rtol=1e-6)
    for a, b in zip(ims[0]._stats, ims[1]._stats):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * np.abs(b).max())
    g, g_p = ims[0].gammas[0], ims[1].gammas[0]
    assert np.all(np.abs(g - g_p) <= 1e-4 * np.abs(g_p) + 1e-4 * data[:, :1])
    before = _launches()
    p = ims[0].map_paths()[0]
    assert _launched(before) == {"viterbi_boundary": 1}
    assert (p == ims[1].map_paths()[0]).mean() >= 0.99
