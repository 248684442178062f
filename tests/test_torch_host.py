"""The port's host-side (NumPy) layer against the JAX package: the modules
ported by copy must give byte-identical results.

Covers the .smc.gz format round trip, the data-filter pipeline (native and
NumPy paths), the emission index, the observation and window packing, the
time grid, the exact Moran matrices and hidden-state balancing.
"""

import gzip

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from smcpp_tpu import util as jutil  # noqa: E402
from smcpp_tpu.data import filters as jfilt  # noqa: E402
from smcpp_tpu.data import format as jfmt  # noqa: E402
from smcpp_tpu.data.simulate import simulate_contig as jsim  # noqa: E402
from smcpp_tpu.inference import estimation as jest  # noqa: E402
from smcpp_tpu.inference import manager as jman  # noqa: E402
from smcpp_tpu.models.model import SMCModel as JaxModel  # noqa: E402
from smcpp_tpu.ops import emission as jem  # noqa: E402
from smcpp_tpu.ops import exact as jexact  # noqa: E402
from smcpp_tpu.ops import grid as jgrid  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch import _native as tnative  # noqa: E402
from smcpp_tpu_torch import util as tutil  # noqa: E402
from smcpp_tpu_torch.data import filters as tfilt  # noqa: E402
from smcpp_tpu_torch.data import format as tfmt  # noqa: E402
from smcpp_tpu_torch.data.simulate import simulate_contig as tsim  # noqa: E402
from smcpp_tpu_torch.inference import estimation as test_  # noqa: E402
from smcpp_tpu_torch.inference import manager as tman  # noqa: E402
from smcpp_tpu_torch.models.model import SMCModel as TorchModel  # noqa: E402
from smcpp_tpu_torch.ops import emission as tem  # noqa: E402
from smcpp_tpu_torch.ops import exact as texact  # noqa: E402
from smcpp_tpu_torch.ops import grid as tgrid  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402


def _model(cls):
    m = cls([0.01, 0.1, 1.0, 5.0], 1e4, "piecewise")
    m.y[:] = np.log([1.0, 0.3, 1.0, 2.0])
    return m


@pytest.fixture(scope="module")
def contigs():
    "Two simulated contigs with a run of missing data spliced in."
    out = []
    for seed in range(2):
        d = jsim(_model(JaxModel), 2e-4, 2e-4, 600_000, 6, seed=seed)
        d = d.copy()
        d[10:14, 1] = -1
        d[10:14, 2:] = 0
        out.append(d)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory, contigs):
    root = tmp_path_factory.mktemp("fmt")
    out = {}
    for name, fmt in (("jax", jfmt), ("torch", tfmt)):
        fns = []
        for i, d in enumerate(contigs):
            fn = str(root / f"{name}{i}.smc.gz")
            fmt.write_contig(fn, d, ["pop1"], [[["s", 0], ["s", 1]]],
                             [[["u", j] for j in range(6)]])
            fns.append(fn)
        out[name] = fns
    return out


def test_format_round_trip_is_byte_identical(files):
    for fj, ft in zip(files["jax"], files["torch"]):
        with gzip.open(fj, "rb") as a, gzip.open(ft, "rb") as b:
            assert a.read() == b.read()
        cj, ct = jfmt.load_contig(fj), tfmt.load_contig(ft)
        assert cj.pid == ct.pid and cj.fn != ct.fn
        np.testing.assert_array_equal(ct.data, cj.data)
        np.testing.assert_array_equal(ct.n, cj.n)
        np.testing.assert_array_equal(ct.a, cj.a)
        assert tfmt.load_header(ft) == jfmt.load_header(fj)


def test_simulator_matches_jax():
    "The port's simulator draws the same data from the same seed."
    got = tsim(_model(TorchModel), 2e-4, 2e-4, 300_000, 6, seed=3)
    want = jsim(_model(JaxModel), 2e-4, 2e-4, 300_000, 6, seed=3)
    np.testing.assert_array_equal(got, want)


def _pipeline(filt, files):
    "The filters of Analysis, stage 1 then stage 2."
    p = filt.DataPipeline(files)
    p.add_filter(load_data=filt.LoadData())
    p.add_filter(filt.RecodeNonseg(cutoff=None))
    p.add_filter(filt.Compress())
    p.add_filter(filt.BreakLongSpans(cutoff=100000))
    p.add_filter(filt.DropSmallContigs(100000))
    p.add_filter(watterson=filt.Watterson())
    p.add_filter(mutation_counts=filt.CountMutations(w=400))
    stage1 = [c.data.copy() for c in p.results()]
    p.add_filter(filt.Thin(thinning=None))
    p.add_filter(filt.BinObservations(w=100))
    p.add_filter(filt.RecodeMonomorphic())
    p.add_filter(filt.Compress())
    p.add_filter(filt.Validate())
    p.add_filter(filt.DropUninformativeContigs())
    return p, stage1, [c.data for c in p.results()]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_filter_pipeline_matches(files, monkeypatch, native):
    if not native:
        def no_lib():
            raise ImportError("forced NumPy fallback")

        monkeypatch.setattr(tnative, "_lib", no_lib)
    pj, s1j, s2j = _pipeline(jfilt, files["jax"])
    pt, s1t, s2t = _pipeline(tfilt, files["torch"])
    assert len(s1j) == len(s1t) and len(s2j) == len(s2t)
    for a, b in zip(s1j + s2j, s1t + s2t):
        np.testing.assert_array_equal(b, a)
    assert pt["watterson"].theta_hat == pj["watterson"].theta_hat
    np.testing.assert_array_equal(pt["mutation_counts"].counts,
                                  pj["mutation_counts"].counts)


def test_native_library_builds_in_the_port_build_dir():
    import os

    from smcpp_tpu_torch.paths import BUILD_DIR

    lib = tnative._lib()
    assert os.path.dirname(lib._name) == BUILD_DIR


def test_row_kernels_match(contigs):
    d = contigs[0]
    np.testing.assert_array_equal(tfilt.realign(d, 100), jfilt.realign(d, 100))
    np.testing.assert_array_equal(
        tfilt.compress_repeated_obs(d), jfilt.compress_repeated_obs(d)
    )
    np.testing.assert_array_equal(tfilt.thin_data(d, 37), jfilt.thin_data(d, 37))


@pytest.fixture(scope="module")
def binned(files):
    _, _, data = _pipeline(jfilt, files["jax"])
    return data


def test_emission_index_matches(binned):
    keys = np.unique(np.concatenate([d[:, 1:] for d in binned]), axis=0)
    for pe in (0.0, 0.5):
        a = jem.build_emission_index(keys, 6, na=2, polarization_error=pe)
        b = tem.build_emission_index(keys, 6, na=2, polarization_error=pe)
        for f in ("keys", "W", "kind", "parity"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert b.key_id() == a.key_id()
    k = (1, 3, 6)
    assert tem.key_weights_1pop(k, 6, 2, 0.5) == jem.key_weights_1pop(k, 6, 2, 0.5)


def test_observation_and_window_packing_match(binned):
    keys = np.unique(np.concatenate([d[:, 1:] for d in binned]), axis=0)
    kid = jem.build_emission_index(keys, 6).key_id()
    for chunk in (16, 64):
        a = jman.pack_observations(binned, kid, chunk)
        b = tman.pack_observations(binned, kid, chunk)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        for x, y in zip(b[2], a[2]):
            np.testing.assert_array_equal(x, y)
    for kw in ({}, {"seg_target": 64}, {"seg_target": 8, "max_seg_len": 128}):
        a = jwk.pack_windows(binned, kid, **kw)
        b = twk.pack_windows(binned, kid, **kw)
        for x, y in zip(b, a):
            np.testing.assert_array_equal(x, y)
    for W in (10, 5_000, 10**6, 10**9):
        assert twk.window_segment_length(W) == jwk.window_segment_length(W)
    for L in (64, 256, 8192, 16384):
        assert twk.remat_block_size(L) == jwk.remat_block_size(L)
    win = jwk.decompress_to_windows(binned, kid)
    assert twk.cut_segments(win, 64)[1] == jwk.cut_segments(win, 64)[1]
    s = np.array([1, 5, 300, 7, 70000])
    assert tman._best_max_span([s]) == jman._best_max_span([s])
    for x, y in zip(tman._split_spans(s, np.arange(5), 63),
                    jman._split_spans(s, np.arange(5), 63)):
        np.testing.assert_array_equal(x, y)


def test_grid_exact_and_balancing_match():
    tm, jm = _model(TorchModel), _model(JaxModel)
    hs_t = test_.balance_hidden_states(tm, 17)
    hs_j = jest.balance_hidden_states(jm, 17)
    np.testing.assert_array_equal(hs_t, hs_j)
    gt, gj = tgrid.make_time_grid(tm.s, hs_t), jgrid.make_time_grid(jm.s, hs_j)
    for f in ("ts", "dt", "src", "hs_indices", "interval_of_piece", "piece_valid"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f))
    np.testing.assert_array_equal(gt.segment_matrix(), gj.segment_matrix())
    for n in (4, 10):
        mt, mj = texact.cached_matrices(n), jexact.cached_matrices(n)
        for f in ("X0", "X2", "M0", "M1", "Uinv0", "Uinv2"):
            np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
    assert test_.extract_pieces("32*1+16*2") == jest.extract_pieces("32*1+16*2")
    np.testing.assert_array_equal(
        test_.construct_time_points(1e-3, 10.0, [2, 3, 1], 0.0),
        jest.construct_time_points(1e-3, 10.0, [2, 3, 1], 0.0),
    )


def test_util_is_a_copy():
    for preset in ("sawtooth", "human"):
        for k, v in getattr(jutil, preset).items():
            np.testing.assert_array_equal(getattr(tutil, preset)[k], v)
    sfs = np.arange(3 * 7, dtype=float).reshape(3, 7)
    for folded in (False, True):
        np.testing.assert_array_equal(
            tutil.undistinguished_sfs(sfs, folded),
            jutil.undistinguished_sfs(sfs, folded),
        )
    h = jutil.human
    for x, y in zip(tutil.exp_piecewise_to_stepwise(h["a"], h["b"], h["s"]),
                    jutil.exp_piecewise_to_stepwise(h["a"], h["b"], h["s"])):
        np.testing.assert_array_equal(x, y)
