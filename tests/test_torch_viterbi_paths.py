"""K5's plain version (the port's viterbi_segment_paths on the CPU) against
smcpp_tpu's viterbi_segment_paths on inputs with exact ties, and K5's launch
plan (viterbi_paths_plan) at the shapes the port runs it at.

The tie inputs (tests/_viterbi_ties.py) make two states a < b twins, so
their candidates tie exactly at every valid window; both packages must take
the lower index there, as jnp.argmax and torch.max do, and the CUDA kernel
is held to the same rule bit for bit on the card (tests/test_torch_cuda.py).
Bounds: float64 paths exactly equal; float32 paths at least 99.9% equal
(the two packages' f32 logarithms may differ by an ulp, which can flip a
near-tie elsewhere, as tests/test_torch_posterior.py allows).  On both,
the port's path is at b only where the reference's is.  Inputs are made
from a seed with NumPy and handed to both packages.
"""

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


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("L", [7, 33, 200])
@pytest.mark.parametrize("M", [2, 8, 15, 32])
def test_viterbi_paths_ties_match_jax(M, L, dtype):
    a, b = (0, 1) if M == 2 else (M // 3, M - 2)
    args = tie_inputs(M * 1000 + L, 6, L, M, 40, a, b, dtype)
    ref = np.asarray(jwk.viterbi_segment_paths(*map(jnp.asarray, args))).T
    got = twk.viterbi_segment_paths(*map(torch.as_tensor, args)).numpy()
    assert got.shape == ref.shape == (6, L) and got.dtype == np.int32
    if dtype == np.float64:
        np.testing.assert_array_equal(got, ref)
    else:
        assert (got == ref).mean() >= 0.999
    # the twin b is never a backpointer once both twins are reachable: the
    # path is at b only where the reference's is (boundary states, runs of
    # invalid windows next to them)
    assert not np.any((got == b) & (ref != b))
    # and the inputs do exercise the tie: a is on the path somewhere
    assert np.any(got == a)


# (S, L, M, n_keys, the emission table in shared memory)
PLAN_CASES = {
    "posterior": (6104, 16384, 32, 63, True),
    "slice": (7814, 256, 15, 26, True),
    "1000 keys": (64, 512, 32, 1000, True),
    "2000 keys": (64, 512, 32, 2000, False),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_viterbi_paths_plan(case):
    S, L, M, n_keys, shared_table = PLAN_CASES[case]
    plan = twk.viterbi_paths_plan(S, L, M, n_keys)
    assert plan["grid"] * plan["block"] // 32 >= S > (plan["grid"] - 1) * plan["block"] // 32
    assert plan["shared_table"] is shared_table
    for k in ("fwd_shared_bytes", "back_shared_bytes"):
        assert 0 < plan[k] <= twk.SMEM_MAX == 227 * 1024
    MB = -(-M // 4) * 4
    rows = 2 * MB * 4 * twk.WARPS_PER_BLOCK
    assert plan["fwd_shared_bytes"] == rows + (n_keys * MB * 4 if shared_table else 0)
    # the scratch: S L M bytes, plus at most 3 windows of padding a segment
    shape, dtype = plan["scratch_shape"], plan["scratch_dtype"]
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    assert nbytes == plan["scratch_bytes"]
    assert S * L * M <= nbytes <= S * (L + 3) * M
    assert shape[0] == S and shape[2] == M and dtype == torch.int32
