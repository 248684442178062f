"""On the card: a short run of each cell through ``portbench/run.py``, as
the benchmark's check runs it, comes out correct and prints the contract's
keys.  Run on a machine with a card:

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        "4000000001", "--seconds", "5", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]


def test_no_card_no_result(monkeypatch):
    "Without a card the run prints no result and exits with a code other than 0."
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2


def test_lone_benchmark_files_fail(tmp_path):
    "In a directory with only BENCHMARK.json and portbench/ a run fails."
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and not p.stdout.strip()
