"""The controls of each entry's check come out as not correct on a tiny
cell on the CPU (the reference's posterior masses and MAP path with TF32
products and in bfloat16, the fit at the program's own bfloat16-carry
rung), and the program's own readings, which the limits are set from,
come out correct."""

import os

import pytest

from portbench import control, harness
from portbench.tests import cells


@pytest.mark.parametrize("cell,kind", [("posterior.tiny", "tf32"), ("posterior.tiny", "bf16"),
                                       ("fit.tiny", "default_rung")])
def test_control_is_not_correct(cell, kind):
    out = control.control(cell, cells.SEED + 1, kind, "cpu", cells.bench(), cells.DATA,
                          seconds=1.0)
    assert control.fails(out), out


def test_program_readings_are_correct():
    out = control.control("posterior.tiny", cells.SEED + 2, "program", "cpu", cells.bench(),
                          cells.DATA, seconds=1.0)
    assert not control.fails(out), out
    lim = harness.load_json(os.path.join(cells.DATA, "posterior.tiny.json"))["limits"]
    assert set(out) == set(lim)


def test_tf32_rounds_products_alone():
    "Float32 products take TF32's 10-bit operands; float64 ones and the rest do not."
    import torch

    a = torch.full((2, 4, 4), 1 - 1e-4)
    b = torch.eye(4).expand(2, 4, 4)
    with control.tf32(True):
        assert torch.all((a @ b) == 1) and torch.all(torch.einsum("nij,njk->nik", a, b) == 1)
        assert torch.all((a.double() @ b.double()) < 1) and torch.all(a * 1 < 1)
    assert torch.all((a @ b) < 1)
