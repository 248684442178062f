"""portbench/metrics/viterbi_ops_products.posterior.py on synthetic
counters, without a card: the port's K4 face replaced by stand-ins."""

import os
import types

import pytest

from portbench import harness
from smcpp_tpu_torch.ops import window_kernel as wk


def _read(k4, monkeypatch):
    monkeypatch.setattr(wk, "VITERBI_OPS", k4)
    path = os.path.join(harness.HERE, "metrics", "viterbi_ops_products.posterior.py")
    return harness.load_module(path).read(types.SimpleNamespace(window={}))


def test_reads_products_per_window(monkeypatch):
    k4 = types.SimpleNamespace(launches=3, products=2_403_117, windows=101_991_189)
    assert _read(k4, monkeypatch) == pytest.approx(2_403_117 / 101_991_189)


def test_the_walk_reads_one(monkeypatch):
    k4 = types.SimpleNamespace(launches=2, products=4096, windows=4096)
    assert _read(k4, monkeypatch) == 1.0


@pytest.mark.parametrize("k4", [
    types.SimpleNamespace(launches=3, glob=0, smem_bytes=12_160),  # no counters (the parent)
    types.SimpleNamespace(launches=0, products=0, windows=0),      # no K4 launch (the CPU)
    types.SimpleNamespace(launches=1, products=0, windows=0),      # no valid window
], ids=["no_counters", "no_launch", "no_window"])
def test_reads_nothing_without_counts(k4, monkeypatch):
    assert _read(k4, monkeypatch) is None


def test_the_port_keeps_the_counters():
    "The real K4 face has both counters, zero before any launch on a card."
    assert wk.VITERBI_OPS.products >= 0 and wk.VITERBI_OPS.windows >= 0
