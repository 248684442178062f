"""The port's host-side (NumPy) layer against the JAX package: the modules
ported by copy must give byte-identical results.

Covers the .smc.gz format round trip, the data-filter pipeline (native and
NumPy paths), the emission index, the observation and window packing, the
time grid, the exact Moran matrices and hidden-state balancing, the copy of
bench.py's synthetic stream, and the host-side grid plan of the descending
sweep kernel (K2).
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
from smcpp_tpu_torch.data.simulate import synth_contig as tsynth  # noqa: E402
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



@pytest.mark.parametrize("case", ["zero_spans", "repeats", "joint", "empty"])
def test_write_contig_run_length_edges(case, tmp_path):
    """The port's one-pass writer gives the text of JAX's row-by-row
    RunLengthWriter: consecutive rows of one key summed, runs of span 0
    dropped (also between two rows of one key), one- and two-population
    rows, no rows."""
    rng = np.random.RandomState(4)
    ncol = 7 if case == "joint" else 4
    d = np.zeros((0 if case == "empty" else 500, ncol), np.int64)
    if len(d):
        d[:, 0] = rng.randint(0, 4 if case == "zero_spans" else 30, len(d))
        d[:, 1:] = rng.randint(0, 2 if case == "repeats" else 3, (len(d), ncol - 1))
    pids = ["a", "b"] if case == "joint" else ["a"]
    texts = []
    for fmt in (jfmt, tfmt):
        fn = str(tmp_path / f"{fmt.__name__}.smc.gz")
        fmt.write_contig(fn, d, pids, [[]] * len(pids), [[]] * len(pids))
        with gzip.open(fn, "rt") as f:
            texts.append(f.read())
    assert texts[1] == texts[0]

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


@pytest.mark.parametrize("seed", [0, 1])
def test_synth_contig_is_a_copy_of_bench(seed):
    "The port's synth_contig draws bench.py's rows from the same generator."
    import bench

    got = tsynth(np.random.default_rng(seed), 300_000, 128, 3)
    want = bench.synth_contig(np.random.default_rng(seed), 300_000, 128, 3)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert int(got[:, 0].sum()) == 300_000


# (S, n_keys, M): a single segment, S not a multiple of the warps per block,
# the C3 and posterior shapes, and key tables whose partials pass the budget
DSC_PLANS = [(1, 89, 2), (13, 89, 16), (6732, 128, 16), (6104, 63, 32),
             (7814, 26, 15), (6104, 2000, 32), (20000, 30000, 32)]


@pytest.mark.parametrize("S,n_keys,M", DSC_PLANS)
def test_dsc_plan_covers_segments_within_the_budget(S, n_keys, M):
    """K2's grid depends on (S, n_keys, M) only: not on L, not on the card
    (dsc_plan is a pure function of its arguments).  Every segment has a
    warp, no block is empty, the f64 gsum partials stay within
    GSUM_PART_BYTES, and a warp walks more than one segment only where the
    budget forces it."""
    plans = {twk.dsc_plan(S, L, n_keys, M) for L in (8, 200, 1024)}
    assert len(plans) == 1
    W, R, G = plans.pop()
    assert W == twk.DSC_WARPS and R >= 1
    assert (G - 1) * W * R < S <= G * W * R
    part = 8 * n_keys * M
    assert G * part <= max(twk.GSUM_PART_BYTES, part)
    if R > 1:
        assert -(-S // (W * (R - 1))) * part > twk.GSUM_PART_BYTES


def test_dsc_plan_budget_binds_for_large_key_tables():
    # 2000 keys x 32 states: 512 KB of partials per block, 512 blocks at most
    W, R, G = twk.dsc_plan(6104, 16384, 2000, 32)
    assert (W, R) == (8, 2) and G == 382
    assert twk.dsc_plan(6104, 16384, 63, 32) == (8, 1, 763)


def test_dsc_plan_fixed_point_headroom():
    """A block's 64-bit fixed-point gsum entry stays below (segments per
    block) x L x 2^GSUM_FRAC_BITS; the plan raises before that can reach
    2^62."""
    assert twk.GSUM_FRAC_BITS == 40
    twk.dsc_plan(8, 2**19 - 1, 63, 32)  # 8 segments per block, L < 2^19
    with pytest.raises(ValueError, match="fixed-point"):
        twk.dsc_plan(8, 2**19, 63, 32)
    # a key table so large that each warp walks many segments
    with pytest.raises(ValueError, match="fixed-point"):
        twk.dsc_plan(20000, 16384, 30000, 32)
