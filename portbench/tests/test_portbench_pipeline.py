"""The reference's data pipeline, written again in vectorised NumPy, gives
the rows the port's filters give, on random contigs with missing data,
homozygous-derived sites and long runs."""

import numpy as np
import pytest

from portbench.reference import pipeline


def random_rows(seed, n_rows, n):
    rng = np.random.default_rng(seed)
    span = np.where(rng.random(n_rows) < 0.5, 1, rng.integers(1, 3000, n_rows))
    a = rng.choice([-1, 0, 1, 2], n_rows, p=[0.05, 0.6, 0.3, 0.05])
    nb = np.where(rng.random(n_rows) < 0.1, rng.integers(0, n + 1, n_rows), n)
    b = rng.integers(0, nb + 1)
    rows = np.c_[span, a, b, nb].astype(np.int32)
    rows[rng.random(n_rows) < 0.02, 0] = 150_000  # long runs
    return rows


def contig(rows, n):
    from smcpp_tpu_torch.contig import Contig

    return Contig(pid=("pop1",), data=rows.copy(), n=[n], a=[2])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,w", [(7, 3), (2312, 100), (50, 100)])
def test_thin_bin_recode(seed, k, w):
    from smcpp_tpu_torch.data import filters as df

    n = 10
    rows = random_rows(seed, 3000, n)
    want = df.thin_data(rows, k)
    got = pipeline.thin(rows.astype(np.int64), k)
    assert np.array_equal(pipeline.compress(got), df.compress_repeated_obs(want))
    c = contig(want, n)
    binned = df.bin_observations(c, w)
    assert np.array_equal(pipeline.bin_windows(got, w), binned)
    c.data = binned.copy()
    df.RecodeMonomorphic().run_one(c)
    assert np.array_equal(pipeline.recode_monomorphic(binned), c.data)


@pytest.mark.parametrize("seed", [3, 4])
def test_stages_and_watterson(seed):
    from smcpp_tpu_torch.data import filters as df

    n = 10
    contigs = [random_rows(seed * 10 + i, 2000, n) for i in range(3)]
    contigs[1][100] = [200_000, -1, 0, 0]  # a fully missing run breaks the contig
    c = [contig(r, n) for r in contigs]
    c = [x for y in c for x in df.break_long_spans(df.Compress().run_one(y), 100_000)]
    c = df.DropSmallContigs(100_000).run(c)
    got = pipeline.stage1(contigs)
    assert len(got) == len(c)
    for x, y in zip(c, got):
        assert np.array_equal(x.data, y)
    wat = df.Watterson()
    wat.run(c)
    assert pipeline.watterson(got) == pytest.approx(wat.theta_hat, rel=1e-12)
    k = int(500 * np.log(2 + n))
    for x in c:
        df.Thin(thinning=k).run_one(x)
        df.BinObservations(w=100).run_one(x)
        df.RecodeMonomorphic().run_one(x)
        df.Compress().run_one(x)
    c = df.DropUninformativeContigs().run(c)
    got2 = pipeline.stage2(got, 100, k)
    assert len(got2) == len(c)
    for x, y in zip(c, got2):
        assert np.array_equal(x.data, y)
