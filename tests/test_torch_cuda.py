"""The port's CUDA kernels (K1 asc_sweep, K2 dsc_sweep, K3 segment_ops)
against their plain PyTorch versions, on the card.

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
rtol 1e-3.
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


# M = 15 and 17 are the stage-2 M of estimate's defaults (balanced states
# and empirical TMRCA); 15 pads to 16 lanes with one masked lane.
MS = [2, 5, 15, 16, 17, 32]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("precision,rtol", [("highest", 1e-5), ("default", 1e-3)])
def test_segment_ops_matches_plain(dev, M, precision, rtol):
    T, E, keys, valid, _, _ = _problem(0, 40, 256, M, 89, dev)
    before = wk.SEGMENT_OPS.launches
    ops, logs = wk.segment_ops_cuda(T, E, keys, valid, precision)
    torch.cuda.synchronize()
    assert wk.SEGMENT_OPS.launches == before + 1
    ops_p, logs_p = wk.segment_ops_plain(T, E, keys, valid, precision)
    _close(ops, ops_p, rtol, 1e-7)
    _close(logs, logs_p, 1e-5, 1e-6)


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
    default (K3 70 KB, K1 64 KB, K2 192 KB), the opt-in path; 1000 keys
    would need more than a block can have, and K2 refuses it."""
    T, E, keys, valid, A_in, Q_end = _problem(4, 24, 96, 32, 500, dev)
    ops, logs = wk.segment_ops_cuda(T, E, keys, valid, "highest")
    ops_p, logs_p = wk.segment_ops_plain(T, E, keys, valid, "highest")
    _close(ops, ops_p, 1e-5, 1e-7)
    alphas, a_end = wk.asc_sweep_cuda(T, E, keys, valid, A_in, "highest")
    alphas_p, a_end_p = wk.asc_sweep_plain(T, E, keys, valid, A_in, "highest")
    _close(alphas, alphas_p, 1e-5, 1e-7)
    u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas_p, Q_end)
    u_p, xo_p, gs_p = wk.dsc_sweep_plain(T, E, keys, valid, alphas_p, Q_end)
    torch.cuda.synchronize()
    _close(xo, xo_p, 1e-5, 1e-8)
    _close(gs, gs_p, 1e-5, 1e-8)
    T, E, keys, valid, A_in, Q_end = _problem(5, 4, 64, 32, 1000, dev)
    alphas, _ = wk.asc_sweep_cuda(T, E, keys, valid, A_in, "highest")
    with pytest.raises(ValueError, match="shared memory"):
        wk.dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end)


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
    with pytest.raises(NotImplementedError, match="B5"):
        wk.stats_pass(T, E, keys, valid, A_in, Q_end, emit_gamma=True)
    with pytest.raises(TypeError):
        wk.segment_ops_cuda(T.double(), E.double(), keys, valid, "highest")
