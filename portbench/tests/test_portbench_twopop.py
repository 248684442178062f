"""The two-population posterior entry (``posterior2``) on a tiny cell on the
CPU: the real configuration with a small sample and genome
(tests/data/tiny2_n3_4.json, tests/data/posterior2.tiny.json), driven
through the harness as on the card.  A sound run is correct; a run whose
program decodes under a doubled split, and the controls (the reference's
masses with TF32 products and in bfloat16), are not."""

import json

import pytest

from portbench import control2, harness
from portbench.tests import cells

CELL, CONFIG, LIKE = "posterior2.tiny", "tiny2_n3_4", "posterior.twopop_n18_20.chr15"


def bench():
    "``cells.bench()`` with the tiny two-population cell beside the others."
    b = cells.bench()
    b["configs"].append({"name": CONFIG, "file": f"portbench/tests/data/{CONFIG}.json"})
    b["workloads"].append({"name": CELL, "config": CONFIG, "traffic": CELL, "chips": 1})
    for m in b["end_to_end"] + b["per_layer"]:
        if LIKE in m.get("workloads", []):
            m["workloads"].append(CELL)
    return b


def run(traced=False, seconds=1.0, seed=cells.SEED):
    line, err = harness.execute(CELL, seed, seconds, traced, "cpu", bench=bench(),
                                need_card=False, traffic_dir=cells.DATA)
    return json.loads(line), err


@pytest.mark.parametrize("traced", [False, True], ids=["timed", "traced"])
def test_tiny_twopop_cell(traced):
    out, err = run(traced)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    assert set(out["checks"]) == {"gamma_gap", "gamma_mean", "quantile_gap", "map_gap_nats"}
    if traced:
        assert {"decode_ms.posterior", "viterbi_ms.posterior"} <= set(out["metrics"])
        assert "emission_table_kb.posterior" not in out["metrics"]  # no card, no launch
    else:
        assert set(out["metrics"]) == {"posterior_mbp_s", "peak_gb", "setup_s"}
    assert err[-len(out["checks"]):] == [
        f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})" for k, v in out["checks"].items()]


def test_doubled_split_is_not_correct(monkeypatch):
    "The program decodes under the split model with its split doubled."
    from smcpp_tpu_torch.inference import manager

    inner = manager.TwoPopInferenceManager.set_model

    def set_model(self, model):
        model.split = 2 * model.split
        inner(self, model)

    monkeypatch.setattr(manager.TwoPopInferenceManager, "set_model", set_model)
    out, _ = run()
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("kind", ["tf32", "bf16"])
def test_control_is_not_correct(kind):
    out = control2.control(CELL, cells.SEED + 1, kind, "cpu", bench(), cells.DATA, seconds=1.0)
    assert any(not v <= lim for v, lim in out.values()), out


def test_program_readings_are_correct():
    out = control2.control(CELL, cells.SEED + 2, "program", "cpu", bench(), cells.DATA,
                           seconds=1.0)
    assert all(v <= lim for v, lim in out.values()), out
