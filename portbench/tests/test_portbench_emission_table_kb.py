"""portbench/metrics/emission_table_kb.posterior.py on synthetic counters,
without a card: the port's kernel registry replaced by stand-ins."""

import os
import types

import pytest

from portbench import harness
from smcpp_tpu_torch.ops import window_kernel as wk

SHAPE = {"n_keys": 1198, "M": 32}


def _read(kernels, shape=SHAPE, monkeypatch=None):
    monkeypatch.setattr(wk, "KERNELS", tuple(kernels))
    run = types.SimpleNamespace(window={"shape": shape} if shape else {})
    path = os.path.join(harness.HERE, "metrics", "emission_table_kb.posterior.py")
    return harness.load_module(path).read(run)


def k(launches, glob=0, smem_bytes=None):
    return types.SimpleNamespace(launches=launches, glob=glob, smem_bytes=smem_bytes)


def test_reads_the_largest_shared_table(monkeypatch):
    ks = [k(3, 0, 158_004), k(3, 0, 196_000), k(2, 0, 1_024), k(3, 0, None)]
    assert _read(ks, monkeypatch=monkeypatch) == pytest.approx(196.0)


def test_counts_a_global_table_at_its_own_bytes(monkeypatch):
    # K2g read its table from global memory: 4 x 1198 x 32 bytes, not its staging
    ks = [k(3, 3, 67_584), k(3, 0, 100_000)]
    assert _read(ks, monkeypatch=monkeypatch) == pytest.approx(4 * 1198 * 32 / 1000)


def test_skips_kernels_not_launched(monkeypatch):
    ks = [k(0, 0, 200_000), k(1, 0, 8_316)]
    assert _read(ks, monkeypatch=monkeypatch) == pytest.approx(8.316)


@pytest.mark.parametrize("kernels,shape", [
    ([types.SimpleNamespace(launches=3, glob=0)], SHAPE),   # a port without the counters
    ([k(0, 0, None), k(0, 0, None)], SHAPE),                # the CPU: nothing launched
    ([k(3, 0, 8_316)], None),                               # an untraced run: no shape
], ids=["no_counters", "no_launch", "no_shape"])
def test_reads_nothing_without_counters(kernels, shape, monkeypatch):
    assert _read(kernels, shape, monkeypatch) is None
