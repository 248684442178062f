"""The port's joint CSFS (smcpp_tpu_torch/ops/jcsfs.py) and two-population
emission index against the JAX package, on the CPU.

* the four tests of tests/test_jcsfs.py against the port: the
  marginalization oracles at their rtol 1e-5 / atol 1e-8, the apart
  configuration's structure, shift/truncate;
* ``JointCSFS.compute`` against JAX's at rtol 1e-10 (both float64 host
  code; the port's one-population CSFS and below integrals are torch on the
  CPU, summed in another order: measured 4e-11 at worst), for (a1, a2) in
  {(2, 0), (1, 1)} and several (n1, n2);
* ``build_emission_index_2pop``: W, kind, parity and the key ids equal to
  JAX's exactly (the same host code).

The port's one-population CSFS at n = 0 and n = 1 is held to JAX's too: at
n = 1 a freshly built matrix cache held a reversed (negative-stride) view
that torch refused (ops/exact.py, repaired with this test).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from smcpp_tpu.ops import csfs as jcsfs_1  # noqa: E402
from smcpp_tpu.ops import emission as jem  # noqa: E402
from smcpp_tpu.ops import grid as jgrid  # noqa: E402
from smcpp_tpu.ops import jcsfs as jmod  # noqa: E402
from smcpp_tpu_torch.ops import csfs as tcsfs_1  # noqa: E402
from smcpp_tpu_torch.ops import emission as tem  # noqa: E402
from smcpp_tpu_torch.ops import exact as texact  # noqa: E402
from smcpp_tpu_torch.ops import jcsfs as tmod  # noqa: E402

jax.config.update("jax_enable_x64", True)

MODEL1 = (np.array([1.0, 4.0]), np.array([0.5, 1.0]))  # (a, s)
MODEL2 = (np.array([2.0, 4.0, 2.0]), np.array([0.1, 0.2, 0.3]))


def concat_models(m1, m2, split):
    "model2 below the split, model1 above (reference test_jcsfs.py:43-57)."
    ary = []
    for a, s in (m1, m2):
        cs = np.concatenate([[0.0], np.cumsum(s)])
        cs[-1] = np.inf
        ip = np.searchsorted(cs, split)
        cs2 = np.insert(cs, ip, split)
        sp = np.diff(cs2)
        ap = np.insert(a, ip, a[ip - 1])
        sp[-1] = 1.0
        ary.append((sp, ap, ip))
    s = np.concatenate([ary[1][0][: ary[1][2]], ary[0][0][ary[0][2] :]])
    a = np.concatenate([ary[1][1][: ary[1][2]], ary[0][1][ary[0][2] :]])
    return a, s


# --- the four tests of tests/test_jcsfs.py, against the port ---------------

def test_marginal_pop1():
    "Sum over pop-2 axes == one-pop CSFS of model1, per hidden interval."
    ts = np.array([0.0, 1.0, 2.0, np.inf])
    n1, n2 = 5, 8
    j = tmod.JointCSFS(n1, n2, 2, 0, ts, K=16)
    for split in [0.1, 0.5, 1.0, 1.5, 2.5]:
        jc = j.compute(MODEL1, MODEL2, split)
        full = tmod.csfs_raw(*MODEL1, ts, n1)
        for m in range(len(ts) - 1):
            A1 = full[m]
            A2 = jc[m].reshape(3, n1 + 1, 1, n2 + 1).sum(axis=(-1, -2))
            assert np.allclose(
                A1.flat[1:-1], A2.flat[1:-1], rtol=1e-5, atol=1e-8
            ), (split, m)


def test_marginal_pop2():
    "Sum over pop-1 axes == undistinguished SFS of the concatenated model."
    n1, n2 = 8, 10
    j = tmod.JointCSFS(n1, n2, 2, 0, [0.0, np.inf], K=16)
    for split in [0.1, 0.25, 0.5, 1.0, 2.0]:
        a_c, s_c = concat_models(MODEL1, MODEL2, split)
        csfs = tmod.csfs_raw(a_c, s_c, [0.0, np.inf], n2 - 2)[0]
        A1 = tmod.undistinguished_sfs(csfs)[: n2 - 1]
        jc = j.compute(MODEL1, MODEL2, split)[0]
        A2 = jc.reshape(3, n1 + 1, 1, n2 + 1).sum(axis=(0, 1, 2))[1:-1]
        assert np.allclose(A1, A2, rtol=1e-5, atol=1e-8), split


def test_apart_finite_and_structured():
    "a1 = a2 = 1 configuration: finite, nonnegative, zero corners."
    n1, n2 = 4, 5
    hs = [0.0, 0.3, 1.0, np.inf]
    j = tmod.JointCSFS(n1, n2, 1, 1, hs, K=50, seed=4)
    jc = j.compute(MODEL1, MODEL2, 0.4)
    assert np.all(np.isfinite(jc))
    assert np.all(jc >= 0)
    v = jc.reshape(len(hs) - 1, 2, n1 + 1, 2, n2 + 1)
    np.testing.assert_allclose(v[:, 0, 0, 0, 0], 0.0)
    np.testing.assert_allclose(v[:, 1, n1, 1, n2], 0.0)


def test_shift_truncate_params():
    a = np.array([1.0, 2.0, 3.0])
    s = np.array([0.5, 0.5, 1.0])
    ap, sp = tmod.shift_params(a, s, 0.75)
    # shifted model starts inside piece 1
    assert ap[0] == 2.0 and np.isclose(sp[0], 0.25)
    at, st = tmod.truncate_params(a, s, 0.75)
    assert at[-1] == 1e-8  # crash piece
    assert np.isclose(np.sum(st[:-1]), 0.75)
    for split in (0.0, 0.3, 0.75, 1.0, 5.0):
        for f in ("shift_params", "truncate_params"):
            for x, y in zip(getattr(tmod, f)(a, s, split),
                            getattr(jmod, f)(a, s, split)):
                np.testing.assert_array_equal(x, y)


# --- parity with JAX -------------------------------------------------------

@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)], ids=["together", "apart"])
@pytest.mark.parametrize("n1,n2", [(5, 8), (1, 1), (2, 1), (10, 8)])
def test_joint_csfs_matches_jax(a1, a2, n1, n2):
    hs = [0.0, 0.3, 1.0, np.inf]
    tj = tmod.JointCSFS(n1, n2, a1, a2, hs, K=10)
    jj = jmod.JointCSFS(n1, n2, a1, a2, hs, K=10)
    np.testing.assert_array_equal(tj.hyp1, jj.hyp1)
    np.testing.assert_array_equal(tj.hyp2, jj.hyp2)
    for split in (0.05, 0.5, 2.0):
        got = tj.compute(MODEL1, MODEL2, split)
        want = jj.compute(MODEL1, MODEL2, split)
        assert got.shape == want.shape == tj.shape
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_csfs_small_n_from_a_fresh_cache(n, tmp_path, monkeypatch):
    """The one-population CSFS at small n, with the matrix cache built
    afresh (not read from disk), equals JAX's."""
    monkeypatch.setattr(texact, "_DISK_CACHE_DIR", str(tmp_path))
    texact.cached_matrices.cache_clear()
    try:
        g = jgrid.make_time_grid(MODEL1[1], np.array([0.0, 0.7, np.inf]))
        got = tcsfs_1.conditioned_sfs(torch.as_tensor(MODEL1[0]), g, n)
        want = jcsfs_1.conditioned_sfs(MODEL1[0], g, n, xp=np)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    finally:
        texact.cached_matrices.cache_clear()


def _joint_keys(rng, n, na, rows=300):
    "Random joint keys (a1, b1, nb1, a2, b2, nb2), missing and reduced rows too."
    k = np.zeros((rows, 6), np.int64)
    for p in range(2):
        k[:, 3 * p] = rng.randint(-1, na[p] + 1, rows) if na[p] else -1
        k[:, 3 * p + 2] = rng.randint(0, n[p] + 1, rows)
        k[:, 3 * p + 1] = [rng.randint(0, nb + 1) for nb in k[:, 3 * p + 2]]
    reduced = rng.rand(rows) < 0.1
    k[reduced, 1:3] = 0
    k[reduced, 4:6] = 0
    return k


@pytest.mark.parametrize("na", [(2, 0), (1, 1)])
@pytest.mark.parametrize("pe", [0.5, 0.0])
def test_emission_index_2pop_matches_jax(na, pe):
    n = (4, 3)
    keys = _joint_keys(np.random.RandomState(3), n, na)
    got = tem.build_emission_index_2pop(keys, n, na, pe)
    want = jem.build_emission_index_2pop(keys, n, na, pe)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.W, want.W)
    np.testing.assert_array_equal(got.kind, want.kind)
    np.testing.assert_array_equal(got.parity, want.parity)
    assert got.key_id() == want.key_id()
    assert set(got.kind) >= {tem.KIND_CSFS}
