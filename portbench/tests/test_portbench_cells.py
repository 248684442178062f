"""A tiny cell of each entry runs end to end on the CPU through the port's
plain paths, checks its outputs against the reference and prints the
contract's last line."""

import pytest

from portbench.tests import cells


@pytest.mark.parametrize("traced", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("cell", sorted(cells.TINY))
def test_tiny_cell(cell, traced):
    out, err = cells.run(cell, traced)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    want = {"fit.tiny": {"em_iteration_s", "peak_gb", "setup_s"},
            "posterior.tiny": {"posterior_mbp_s", "peak_gb", "setup_s"}}[cell]
    if traced:
        assert set(out["metrics"]).isdisjoint(want) and out["metrics"]
    else:
        assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert err[-len(out["checks"]):] == [
        f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})" for k, v in out["checks"].items()]
