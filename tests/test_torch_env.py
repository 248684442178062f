"""The environment overrides of the JAX package, read the same way by the
port, on the CPU:

* SMCPP_TPU_ESTREAM_BYTES: an absolute byte budget for every window-stream
  gate, whatever fraction of the device the gate would take;
* SMCPP_TPU_MATMUL_PRECISION: the E-step rung when none is passed;
* SMCPP_TPU_CARRY: the storage dtype of the carries ('auto' follows the
  rung, 'float32' or 'bfloat16' pins it).

Under the same variables and the same data the two packages must make the
same gate decisions, run the same rung and store the carries in the same
dtype: the tolerance is equality.  The f32 E-step with pinned f32 carries is
held at the f32 bound of tests/test_torch_window_kernel.py (rtol 1e-5).
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.inference import estimation as jax_est  # noqa: E402
from smcpp_tpu.inference.manager import (  # noqa: E402
    OnePopInferenceManager as JaxManager,
)
from smcpp_tpu.models import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.inference import manager as torch_manager  # noqa: E402
from smcpp_tpu_torch.models import SMCModel as TorchModel  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(seed, n_rows=80):
    rng = np.random.RandomState(seed)
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 20, n_rows)
    data[:, 1] = rng.randint(0, 2, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    return data


def _managers(data_list, M=5):
    "The JAX manager and the port's (CPU) on the same data and hidden states."
    hs = None
    ims = []
    for Model, make in (
        (JaxModel, lambda hs: JaxManager(2, data_list, hs, ("pop1",), 0.5,
                                         devices=[jax.devices()[0]])),
        (TorchModel, lambda hs: torch_manager.OnePopInferenceManager(
            2, data_list, hs, ("pop1",), 0.5, device="cpu")),
    ):
        m = Model([0.01, 3.0], 20000.0, "piecewise")
        m.y[:] = 0.0
        if hs is None:
            hs = jax_est.balance_hidden_states(m, M + 1)
        im = make(hs)
        im.set_model(m)
        im.theta, im.rho, im.alpha = 1e-4, 1e-4, 1
        ims.append(im)
    return ims


def test_budget_override_is_absolute(monkeypatch):
    """Without the variable the budget is a fraction of the card's memory
    (6 GB on the CPU); with it, every fraction sees the same value."""
    monkeypatch.delenv("SMCPP_TPU_ESTREAM_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (0, 80e9))

    class _IM:
        _hbm_budget = torch_manager.OnePopInferenceManager._hbm_budget
        _device = torch.device("cuda")

    assert _IM()._hbm_budget() == 0.375 * 80e9
    assert _IM()._hbm_budget(0.70) == 0.70 * 80e9
    _IM._device = torch.device("cpu")
    assert _IM()._hbm_budget() == _IM()._hbm_budget(0.70) == 6e9
    monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", "123456.0")
    for dev in ("cpu", "cuda"):
        _IM._device = torch.device(dev)
        for frac in (0.375, 0.70, 1.0):
            assert _IM()._hbm_budget(frac) == 123456.0


def test_budget_gates_flip_at_boundary(monkeypatch):
    """The decode and Viterbi gates flip within 1% of the stream size (the
    port's copy of tests/test_decode.py:test_budget_gates_flip_at_boundary)."""
    (tim,) = _managers([_data(11)])[1:]
    assert tim._use_windows
    need = tim._window_stream_bytes(12)
    assert need > 0
    monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", str(need * 1.01))
    assert tim._window_decode_fits() and tim._window_viterbi_fits()
    monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", str(need * 0.99))
    assert not tim._window_decode_fits()
    assert tim._window_viterbi_fits()  # 2 B against 12 B per window-state
    monkeypatch.setenv(
        "SMCPP_TPU_ESTREAM_BYTES", str(tim._window_stream_bytes(2) * 0.99)
    )
    assert not tim._window_viterbi_fits()


def test_gate_decisions_match_jax(monkeypatch):
    jim, tim = _managers([_data(12), _data(13, 50)])
    assert jim._use_windows and tim._use_windows
    for b in (2, 12):
        assert tim._window_stream_bytes(b) == jim._window_stream_bytes(b)
    d12, d2 = tim._window_stream_bytes(12), tim._window_stream_bytes(2)
    for budget in (1.0, d2 * 0.99, d2 * 1.01, d12 * 0.99, d12 * 1.01, 1e15):
        monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", repr(budget))
        for frac in (0.375, 0.70):
            assert tim._hbm_budget(frac) == jim._hbm_budget(frac) == budget
        assert tim._window_decode_fits() == jim._window_decode_fits()
        assert tim._window_viterbi_fits() == jim._window_viterbi_fits()


def test_alpha_stream_gate_matches_jax(monkeypatch, caplog):
    """Over the budget both E-steps turn alpha remat on, with the same block
    and the same log line; within it neither does."""
    jim, tim = _managers([_data(14)])
    need = tim._window_stream_bytes(
        torch.finfo(twk.carry_dtype(tim.precision, torch.float32)).bits // 8
    )
    assert need == jim._window_stream_bytes(jim._alpha_carry_bytes())
    block = jwk.remat_block_size(tim._wkeys.shape[1])
    for budget, over in ((need * 1.01, False), (need * 0.99, True)):
        monkeypatch.setenv("SMCPP_TPU_ESTREAM_BYTES", repr(budget))
        for logger, im in (("smcpp_tpu.inference.manager", jim),
                           ("smcpp_tpu_torch.inference.manager", tim)):
            caplog.clear()
            with caplog.at_level(logging.INFO, logger=logger):
                im._build_estep_fn()
            assert ("alpha remat ON" in caplog.text) == over
            assert (f"alpha remat ON (block {block})" in caplog.text) == over
        assert tim._alpha_remat == (block if over else None)


@pytest.mark.parametrize(
    "precision", ["default", "bfloat16", "tensorfloat32", "float32", "highest"]
)
def test_matmul_precision_sets_the_rung(monkeypatch, precision):
    jim, tim = _managers([_data(15)])
    monkeypatch.setattr(jwk, "MATMUL_PRECISION", precision)
    monkeypatch.setattr(twk, "MATMUL_PRECISION", precision)
    assert tim.precision == jim.precision
    assert torch.finfo(
        twk.carry_dtype(tim.precision, torch.float32)
    ).bits // 8 == jim._alpha_carry_bytes()
    # an explicit rung wins over the variable on both sides
    jim._precision = tim._precision = "highest"
    assert tim.precision == jim.precision == "highest"


@pytest.mark.parametrize("carry", ["auto", "float32", "bfloat16"])
def test_carry_pins_the_storage(monkeypatch, carry):
    monkeypatch.setattr(jwk, "CARRY", carry)
    monkeypatch.setattr(twk, "CARRY", carry)
    for p in ("default", "tensorfloat32", "highest"):
        want = jwk._carry_dtype(p, jnp.float32)
        got = twk.carry_dtype(p, torch.float32)
        assert str(got).removeprefix("torch.") == np.dtype(want).name
        # f64 E-steps keep f64 carries on both sides
        assert twk.carry_dtype(p, torch.float64) == torch.float64


def test_carry_rejects_other_dtypes(monkeypatch):
    monkeypatch.setattr(twk, "CARRY", "float16")
    with pytest.raises(ValueError, match="SMCPP_TPU_CARRY"):
        twk.carry_dtype("default", torch.float32)


def test_estep_direct_with_f32_carry_matches_jax(monkeypatch):
    """At the 'default' rung with SMCPP_TPU_CARRY=float32 both packages
    store f32 carries: the statistics agree at the f32 bound, and differ
    from the bf16-carry run."""
    rng = np.random.RandomState(16)
    S, L, M, n_keys = 12, 128, 16, 60
    T = rng.dirichlet(np.ones(M), size=M).astype(np.float32)
    E = rng.uniform(0.05, 1.0, (n_keys, M)).astype(np.float32)
    pi = rng.dirichlet(np.ones(M)).astype(np.float32)
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.9
    soc = np.arange(S).reshape(3, 4)
    targs = (*twk.from_numpy(pi, T, E, "cpu"), torch.as_tensor(keys),
             torch.as_tensor(valid), soc)
    bf16 = twk.estep_direct(*targs, precision="default")
    monkeypatch.setattr(jwk, "CARRY", "float32")
    monkeypatch.setattr(twk, "CARRY", "float32")
    ref = jwk.estep_direct(*map(jnp.asarray, (pi, T, E, keys, valid)), soc,
                           precision="default")
    got = twk.estep_direct(*targs, precision="default")
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float64)
        np.testing.assert_allclose(g.double().numpy(), r, rtol=1e-5,
                                   atol=1e-8 * np.abs(r).max())
    assert not torch.equal(got[2], bf16[2])


def test_variables_are_read_at_import():
    "Both packages read the rung and the carry from a fresh process's environment."
    env = dict(os.environ, SMCPP_TPU_MATMUL_PRECISION="highest",
               SMCPP_TPU_CARRY="bfloat16", JAX_PLATFORMS="cpu")
    code = ("import smcpp_tpu_torch.ops.window_kernel as t, "
            "smcpp_tpu.ops.window_kernel as j; "
            "print(t.MATMUL_PRECISION, t.CARRY, j.MATMUL_PRECISION, j.CARRY)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    assert out.stdout.split() == ["highest", "bfloat16"] * 2
