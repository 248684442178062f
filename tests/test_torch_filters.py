"""The port's data-pipeline kernels (smcpp_tpu_torch/data/filters.py and
_native.py) against the JAX package's, on the CPU: tests/test_filters.py's
seven tests, each with JAX's result on the same input beside the port's
(integer rows, so equal exactly; Watterson's estimate to the last bit).

The NumPy fallback is forced by making the port's native library raise
ImportError, as tests/test_torch_host.py does for the whole pipeline.
"""

import numpy as np
import pytest

from smcpp_tpu.contig import Contig as JaxContig
from smcpp_tpu.data import filters as jfilt
from smcpp_tpu_torch import _native as tnative
from smcpp_tpu_torch.contig import Contig
from smcpp_tpu_torch.data import filters as tfilt


def _no_native(monkeypatch):
    def no_lib():
        raise ImportError("forced NumPy fallback")

    monkeypatch.setattr(tnative, "_lib", no_lib)


def _jax_contig(c):
    return JaxContig(pid=c.pid, data=c.data.copy(), n=c.n, a=c.a)


def test_compress_merges_repeats():
    "test_bugs.py:test_bug3 of the reference"
    rows = [[1, 0, 0, 0], [2, 0, 0, 0]]
    got = tfilt.compress_repeated_obs(rows)
    np.testing.assert_equal(got, [[3, 0, 0, 0]])
    np.testing.assert_equal(got, jfilt.compress_repeated_obs(rows))


def test_compress_roundtrip():
    rng = np.random.RandomState(0)
    d = np.c_[
        rng.randint(1, 5, 50), rng.randint(0, 2, 50),
        rng.randint(0, 2, 50), np.full(50, 4),
    ].astype(np.int32)
    c = tfilt.compress_repeated_obs(d)
    assert c[:, 0].sum() == d[:, 0].sum()
    # no two adjacent rows identical
    assert np.all(np.any(c[1:, 1:] != c[:-1, 1:], axis=1))
    np.testing.assert_array_equal(c, jfilt.compress_repeated_obs(d))


def _rand_contig(rng, rows=200, n=6):
    d = np.c_[
        rng.randint(1, 2000, rows),
        rng.choice([-1, 0, 1, 2], rows, p=[0.1, 0.5, 0.3, 0.1]),
        rng.randint(0, n + 1, rows),
        np.full(rows, n),
    ].astype(np.int32)
    d[:, 2] = np.minimum(d[:, 2], d[:, 3])
    d[d[:, 1] == -1, 3] = rng.choice([0, n], (d[:, 1] == -1).sum())
    return Contig(pid=("p",), data=d, n=[n], a=[2])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_thin_preserves_total_span(native, monkeypatch):
    rng = np.random.RandomState(1)
    c = _rand_contig(rng)
    want = jfilt.thin_data(c.data, 137)
    if not native:
        _no_native(monkeypatch)
    out = tfilt.thin_data(c.data, 137)
    assert out[:, 0].sum() == c.data[:, 0].sum()
    # thinned (non-boundary) rows carry no undistinguished information
    boundary = out[:, 0] == 1
    assert np.all(out[~boundary, 3] == 0)
    np.testing.assert_array_equal(out, want)


def test_native_matches_python(monkeypatch):
    """thin, bin and the windowed counts: the port's native kernels against
    its NumPy loops, and both against JAX's."""
    rng = np.random.RandomState(2)
    cases = []
    for _ in range(5):
        c = _rand_contig(rng, rows=100)
        cases.append((c, int(rng.randint(2, 500)), int(rng.randint(50, 300))))

    def run():
        out = []
        for c, th, w in cases:
            c2 = Contig(pid=c.pid, data=c.data.copy(), n=c.n, a=c.a)
            out.append((tfilt.thin_data(c.data, th), tfilt.bin_observations(c2, w),
                        tfilt.windowed_mutation_counts(c, w)))
        return out

    native = run()
    # the native library is really used where the fallback is not
    c, th, _ = cases[0]
    np.testing.assert_array_equal(native[0][0], tnative.thin_data(c.data, th))
    _no_native(monkeypatch)
    numpy = run()
    for (c, th, w), a, b in zip(cases, native, numpy):
        want = (jfilt.thin_data(c.data, th),
                jfilt.bin_observations(_jax_contig(c), w),
                jfilt.windowed_mutation_counts(_jax_contig(c), w))
        for x, y, z in zip(a, b, want):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_realign():
    rng = np.random.RandomState(3)
    d = np.c_[rng.randint(1, 500, 60), rng.randint(0, 2, 60),
              np.zeros(60, int), np.full(60, 4)].astype(np.int32)
    out = tfilt.realign(d, 100)
    assert out[:, 0].sum() == d[:, 0].sum()
    # no row crosses a 100-boundary
    starts = np.concatenate([[0], np.cumsum(out[:, 0])[:-1]])
    ends = starts + out[:, 0]
    assert np.all(starts // 100 == (ends - 1) // 100)
    np.testing.assert_array_equal(out, jfilt.realign(d, 100))


def test_break_long_spans():
    d = np.array(
        [
            [500, 0, 0, 4],
            [200000, -1, 0, 0],
            [300, 1, 2, 4],
        ],
        dtype=np.int32,
    )
    c = Contig(pid=("p",), data=d, n=[4], a=[2])
    parts = tfilt.break_long_spans(c, 100000)
    assert len(parts) == 2
    assert len(parts[0]) == 501  # prepended missing row adds 1
    assert len(parts[1]) == 301
    want = jfilt.break_long_spans(_jax_contig(c), 100000)
    assert len(want) == len(parts)
    for p, w in zip(parts, want):
        assert isinstance(p, Contig) and p.pid == w.pid
        np.testing.assert_array_equal(p.data, w.data)


def test_watterson_constant():
    "Watterson's estimate on dense fake data is in a sane range."
    rng = np.random.RandomState(4)
    n = 6
    L = 10000
    theta = 0.01
    # P(seg) ~ theta * harmonic(n+1)
    seg = rng.random(L) < theta * np.log(n + 2)
    d = np.c_[
        np.ones(L, int), np.zeros(L, int), seg.astype(int), np.full(L, n)
    ].astype(np.int32)
    c = Contig(pid=("p",), data=d, n=[n], a=[2])
    wat = tfilt.Watterson()
    wat.run([c])
    assert 0.3 * theta < wat.theta_hat < 3 * theta
    jw = jfilt.Watterson()
    jw.run([_jax_contig(c)])
    assert wat.theta_hat == jw.theta_hat
