"""K8 (``remat_sweep``, csrc/remat_kernels.cu) on the CPU: the two facts its
design rests on, and its launch plan.

K8 recomputes each block of windows chunk by chunk: its producer sweeps a
block once from the block's snapshot to keep the f32 carry entering each
chunk of ``REMAT_CHUNK`` windows, then sweeps each chunk again from its
carry, the last chunk first.  That gives the block sweep's bits because K1's
step renormalises every window and so depends only on the carry it starts
from; ``remat_chunks_plain`` is that schedule in plain torch, held here to
the whole block's sweep bit for bit, with K1's own summation (f64 sums,
``sum_dtype=torch.float64``) and with the reference's (f32 sums), at both
carry dtypes, at the M the port runs and at blocks that are and are not
multiples of the chunk.  Inputs are made from a seed with NumPy.

``remat_plan`` is K8's shared-memory layout and grid as a pure function; the
kernel computes the same layout (tests/test_torch_cuda.py holds the two
equal on the card).  Here: every layout fits a block's 227 KB, the emission
table stays in shared memory through the two-population table (297 keys)
and moves to global memory past it, four blocks fit an SM at the genome's
shape, and the fixed-point gsum slices never overflow.
"""

import numpy as np
import pytest
import torch

from smcpp_tpu_torch.ops import window_kernel as wk

torch.set_num_threads(1)


def _block(seed, S, blk, M, n_keys=20):
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    keys = rng.randint(0, n_keys, (S, blk)).astype(np.int32)
    valid = rng.rand(S, blk) < 0.9
    valid[-1, blk // 3:] = False  # a ragged tail
    snap = rng.rand(S, M)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    return f(T), f(E), torch.as_tensor(keys), torch.as_tensor(valid), f(snap)


# blocks of 64 and 128 windows are multiples of the 32-window chunks K1
# stages; 40 and 24 are not (multiples of RESCALE_EVERY, as remat_block_size
# gives); K8's chunk is 8 windows (REMAT_CHUNK), and longer chunks leave a
# shorter last one (40 and 24 at 16) or one chunk a block (8 at 16)
@pytest.mark.parametrize("blk,chunk", [(64, 8), (128, 8), (40, 8), (24, 8), (8, 8),
                                       (40, 16), (24, 16), (8, 16), (64, 32)])
@pytest.mark.parametrize("M", [2, 15, 16, 17, 32])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_chunk_carries_give_the_block_sweep(precision, M, blk, chunk):
    T, E, keys, valid, snap = _block(70 + M, 6, blk, M)
    cdt = wk.carry_dtype(precision, torch.float32)
    snap = snap.to(cdt)  # the block's snapshot, rounded as the remat pass rounds it
    for sum_dtype in (torch.float64, None):
        whole, _ = wk.asc_sweep_plain(T, E, keys, valid, snap.float(), precision, sum_dtype)
        chunks = wk.remat_chunks_plain(T, E, keys, valid, snap, precision, chunk, sum_dtype)
        assert chunks.dtype == whole.dtype == cdt
        assert torch.equal(chunks, whole)


def test_chunks_are_swept_from_their_own_carries():
    """The schedule itself: the carry sweeps of chunks 0 and 1 of a 48-window
    block, then its three chunks from their carries, each 16 windows (the
    test above would also pass for a schedule that swept the whole block
    at once)."""
    T, E, keys, valid, snap = _block(5, 4, 48, 15)
    ref = wk.remat_chunks_plain(T, E, keys, valid, snap, "highest", 16)
    orig = wk.asc_sweep_plain
    calls = []

    def spy(T_, E_, k, v, a, *rest):
        calls.append(k.shape[1])
        return orig(T_, E_, k, v, a, *rest)

    wk.asc_sweep_plain = spy
    try:
        again = wk.remat_chunks_plain(T, E, keys, valid, snap, "highest", 16)
    finally:
        wk.asc_sweep_plain = orig
    assert torch.equal(again, ref)
    # two carry sweeps (chunks 0 and 1), then the three chunks from the last
    assert calls == [16, 16, 16, 16, 16]


@pytest.mark.parametrize("M", [2, 8, 15, 16, 17, 24, 32])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n_keys", [1, 26, 63, 128, 297])
def test_remat_plan_tables_fit_a_block(M, bf16, n_keys):
    p = wk.remat_plan(42083, 16384, M, n_keys, bf16, 128)
    assert p["shared_table"] and p["shared_bytes"] <= wk.SMEM_MAX
    assert p["blocks"] == -(-42083 // 16) and p["chunks_per_block"] == 128 // p["chunk"]
    assert p["gsum_group"] * p["gsum_parts"] >= p["blocks"]
    assert p["gsum_parts"] * n_keys * M * 8 <= wk.GSUM_PART_BYTES


@pytest.mark.parametrize("M", [2, 16, 17, 32])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n_keys", [1000, 5000])
def test_remat_plan_takes_the_global_table_route(M, bf16, n_keys):
    """The emission table (rows padded to MB + 8 floats) goes to global
    memory exactly where it would pass a block's shared memory; the gsum
    partials are in global memory at every size."""
    p = wk.remat_plan(42083, 16384, M, n_keys, bf16, 128)
    base = wk.remat_plan(16, 16384, M, 10**6, bf16, 128)["shared_bytes"]  # no table
    tables = n_keys * ((16 if M <= 16 else 32) + 8) * 4
    assert p["shared_table"] == (base + tables <= wk.SMEM_MAX)
    assert p["shared_bytes"] == base + (tables if p["shared_table"] else 0) <= wk.SMEM_MAX
    assert p["gsum_parts"] * n_keys * M * 8 <= wk.GSUM_PART_BYTES
    # each slice holds gsum_group x 16 segments' integers below 2^62
    assert p["gsum_group"] * 16 * 16384 << wk.GSUM_FRAC_BITS < 1 << 62
    if n_keys == 5000:
        assert not p["shared_table"]


def test_remat_plan_chunks_and_carries():
    p = wk.remat_plan(100, 1000, 32, 63, True, 40)
    assert (p["blocks"], p["chunks_per_block"]) == (7, 5)  # 5 chunks of 8 windows
    assert p["carry_floats"] == 7 * 2 * 5 * 32 * 16  # two blocks' carries a tile
    # four blocks an SM at the genome's shape: M = 32, 63 keys, both dtypes
    for bf16 in (True, False):
        assert 4 * (wk.remat_plan(42083, 16384, 32, 63, bf16, 128)["shared_bytes"]
                    + 1024) <= 228 * 1024
    assert wk.remat_plan(100, 64, 15, 63, False, 8)["chunks_per_block"] == 1
    with pytest.raises(ValueError, match="must divide"):
        wk.remat_plan(100, 1000, 32, 63, True, 48)
    with pytest.raises(ValueError, match="overflow"):
        wk.remat_plan(100, 1 << 20, 32, 63, True, 1 << 10)
