"""The window kernels' table counters (smcpp_tpu_torch/ops/window_kernel.py):
``glob``, the launches that read the emission table from global memory, and
``smem_bytes``, the dynamic shared memory of the last launch, both taken
from the launcher's own record (csrc/common.cuh:launch_e, K1's and K8's
plans) through each library's ``smcpp_<library>_last_launch``.

The CPU tests hold ``_Kernel.took`` to a stand-in library; the ``cuda``
tests (skipped without a card) force tables past a block's shared memory
and read the routes the kernels took.  On the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_counters.py
"""

import types

import numpy as np
import pytest
import torch

from smcpp_tpu_torch.ops import _cuda
from smcpp_tpu_torch.ops import window_kernel as wk

TABLE_KERNELS = [wk.SEGMENT_OPS, wk.ASC_SWEEP, wk.DSC_SWEEP, wk.DSC_SWEEP_GAMMA,
                 wk.VITERBI_OPS, wk.VITERBI_PATHS, wk.ASC_SWEEP_REMAT, wk.REMAT_SWEEP,
                 wk.VITERBI_FWD_BLOCKED]


def _library(records):
    "A stand-in for ``_cuda.lib()``: each library's entry point writes its record."

    def entry(rec):
        def fn(out):
            out[0], out[1] = rec
            return 0
        return fn

    return types.SimpleNamespace(**{f"smcpp_{lib}_last_launch": entry(rec)
                                    for lib, rec in records.items()})


@pytest.mark.parametrize("route", ["smem", "glob"])
@pytest.mark.parametrize("kernel", TABLE_KERNELS, ids=lambda k: k.name)
def test_took_reads_its_own_librarys_record(kernel, route, monkeypatch):
    libs = {"window_kernels": (0, 111), "dsc_kernels": (0, 222),
            "viterbi_kernels": (0, 333), "remat_kernels": (0, 444)}
    own = kernel.source.rsplit("/", 1)[1].split(".")[0]
    libs[own] = (1, 64) if route == "glob" else (0, 150_000)
    monkeypatch.setattr(_cuda, "lib", lambda: _library(libs))
    monkeypatch.setattr(kernel, "glob", 5)
    monkeypatch.setattr(kernel, "smem_bytes", None)
    kernel.took()
    kernel.took()
    assert kernel.glob == (7 if route == "glob" else 5)
    assert kernel.smem_bytes == libs[own][1]


def test_kernels_without_a_table_keep_no_record():
    rest = set(wk.KERNELS) - set(TABLE_KERNELS)
    assert rest == {wk.BOUNDARY_SCAN, wk.VITERBI_BOUNDARY, wk.VITERBI_BACK_BLOCKED}
    for k in rest:
        assert k.glob == 0 and k.smem_bytes is None


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(seed, S, L, M, n_keys, dev):
    rng = np.random.RandomState(seed)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    T = f(rng.dirichlet(np.ones(M), size=M))
    E = f(rng.uniform(0.05, 1.0, (n_keys, M)))
    keys = torch.as_tensor(rng.randint(0, n_keys, (S, L)).astype(np.int32), device=dev)
    valid = torch.as_tensor(rng.rand(S, L) < 0.9, device=dev)
    states = [torch.as_tensor(rng.randint(0, M, S).astype(np.int32), device=dev)
              for _ in range(2)]
    return T, E, keys, valid, f(rng.rand(S, M)), f(rng.rand(S, M)), states


# (n_keys, the kernels that take k_glob at M = 32): K2 and K2g from 606
# keys (their f64 gsum table beside the f32 one), K1 from 1415, K4 from 1657
# (a tile of B a warp beside log T^T), K3 and K5 from about 1800
ROUTES = [(63, set()), (1197, {"dsc_sweep", "dsc_sweep_gamma"}),
          (2400, {"segment_ops", "asc_sweep", "dsc_sweep", "dsc_sweep_gamma",
                  "viterbi_ops", "viterbi_paths"})]


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,glob", ROUTES, ids=[str(n) for n, _ in ROUTES])
def test_counters_record_the_table_route(dev, n_keys, glob):
    S, L, M = 24, 96, 32
    T, E, keys, valid, A_in, Q_end, (entry, exit_) = _problem(3, S, L, M, n_keys, dev)
    kernels = [wk.SEGMENT_OPS, wk.ASC_SWEEP, wk.DSC_SWEEP, wk.DSC_SWEEP_GAMMA,
               wk.VITERBI_OPS, wk.VITERBI_PATHS]
    before = {k.name: (k.launches, k.glob) for k in kernels}
    wk.segment_ops_cuda(T, E, keys, valid, "highest")
    alphas, _ = wk.asc_sweep_cuda(T, E, keys, valid, A_in, "highest")
    wk.dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end)
    wk.dsc_sweep_gamma_cuda(T, E, keys, valid, alphas, Q_end)
    wk.viterbi_ops_cuda(T, E, keys, valid)
    wk.viterbi_paths_cuda(T, E, keys, valid, entry, exit_)
    torch.cuda.synchronize()
    for k in kernels:
        launches, g = before[k.name]
        assert k.launches == launches + 1
        assert k.glob == g + (k.name in glob), k.name
        assert k.smem_bytes is not None and k.smem_bytes >= 0
    plan = wk.asc_sweep_plan(S, M, n_keys, False)
    assert wk.ASC_SWEEP.smem_bytes == plan["shared_bytes"]
    assert plan["shared_table"] == ("asc_sweep" not in glob)
    k5 = wk.viterbi_paths_plan(S, L, M, n_keys)
    assert wk.VITERBI_PATHS.smem_bytes == k5["fwd_shared_bytes"]
    if "segment_ops" in glob:
        assert wk.SEGMENT_OPS.smem_bytes == 0  # its k_glob stages nothing
    else:
        assert wk.SEGMENT_OPS.smem_bytes == 4 * (n_keys * 32 + n_keys)
