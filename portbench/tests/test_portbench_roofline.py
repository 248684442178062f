"""The least work a layer's roofline reads is the work that any exact
route needs: it equals chip_smoke.py's count of the sequential sweep (K1's
M^2 a window) where every row is one window, and lies below what the
port's window kernels count (chip_smoke.py:bound) on every shape."""

import importlib
import os
import sys

import numpy as np
import pytest

from portbench.roofline import peaks, work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)


def windows(spans, S, L):
    "The rows' windows laid out as (S, L) keys and valid flags."
    nv = int(np.sum(spans))
    valid = np.zeros(S * L, bool)
    valid[:nv] = True
    return np.zeros((S, L), np.int32), valid.reshape(S, L)


def test_peaks_are_chip_smokes():
    cs = chip_smoke()
    assert peaks.FMA_PER_S == cs.F32_OPS_PER_S == cs.F64_TC_FMA_PER_S
    assert peaks.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    # chip_smoke rounds 64 x 132 x 1.98 GHz to a quarter of 67 TFLOP/s
    assert peaks.alu_per_s(1980) == pytest.approx(cs.F32_ALU_PER_S, rel=2e-3)


@pytest.mark.parametrize("M,S,L", [(15, 64, 256), (32, 16, 512), (16, 128, 64)])
def test_span_one_rows_count_k1s_sweep(M, S, L):
    cs = chip_smoke()
    spans = np.ones(S * L - 7, np.int64)
    keys, valid = windows(spans, S, L)
    nv = int(valid.sum())
    assert work.pass_work(spans, M) == nv * M * M  # K1's count (chip_smoke.bound)
    k1_ops_ms, _ = cs._roofline(0, 0, 0, nv * M * M)
    # one pass a window is K1's M^2 multiply-adds at the same rate
    assert work.pass_work(spans, M) / peaks.FMA_PER_S == pytest.approx(k1_ops_ms / 1e3,
                                                                      rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("M", [15, 32])
def test_least_work_below_the_kernels(seed, M):
    cs = chip_smoke()
    rng = np.random.default_rng(seed)
    spans = np.where(rng.random(4000) < 0.7, 1, rng.integers(1, 5000, 4000))
    L = 4096
    S = -(-int(spans.sum()) // L)
    keys, valid = windows(spans, S, L)
    E = np.zeros((40, M))
    vit = sum(cs.bound(k, E, keys, valid)[0] for k in ("viterbi_ops", "viterbi_paths"))
    assert work.viterbi_least_s(spans, M, 1980)[0] * 1e3 <= vit
    # long rows cost less than span M^2 by binary exponentiation
    assert work.pass_work(spans, M) < float(np.sum(spans)) * M * M
