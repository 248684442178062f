"""Data pipeline: composable filters over lists of Contigs.

Same filter inventory and semantics as the reference
(SMC++ smcpp/data_filter.py, smcpp/_estimation_tools.pyx,
smcpp/estimation_tools.py).  The inherently sequential row-walking kernels
(thin / bin / realign / windowed counts) are implemented as straightforward
NumPy loops here, with a C++ fast path in smcpp_tpu_torch/_native when
built (csrc/datakernels.cpp, shared with the JAX package).
"""

import logging
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from ..contig import Contig

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Row-level kernels
# ---------------------------------------------------------------------------

def compress_repeated_obs(dataset):
    """Run-length re-encode: merge consecutive rows whose observation
    columns agree, summing their spans (cf. estimation_tools.py:51-60).

    Each run is identified by the index of its first row; the merged span
    is the difference of the cumulative-span totals at run boundaries.
    """
    rows = np.asarray(dataset)
    if len(rows) == 0:
        return rows
    is_run_start = np.ones(len(rows), dtype=bool)
    is_run_start[1:] = (rows[1:, 1:] != rows[:-1, 1:]).any(axis=1)
    starts = np.flatnonzero(is_run_start)
    total = np.cumsum(rows[:, 0])
    run_totals = np.append(total[starts[1:] - 1], total[-1])
    out = rows[starts].copy()
    out[:, 0] = np.diff(run_totals, prepend=0)
    return out


def thin_data(data, thinning, offset=0):
    """Emit the full-SFS row only every ``thinning``-th site; elsewhere keep
    only the distinguished-pair genotype (zeroed when homozygous derived).

    Semantics match _estimation_tools.pyx:8-84, including its quirk that the
    "nonseg" replacement row for sa == 2 sites is all zeros.
    """
    data = np.asarray(data, dtype=np.int32)
    npop = (data.shape[1] - 1) // 3
    try:
        from .. import _native

        return _native.thin_data(data, int(thinning), int(offset))
    except ImportError:
        pass
    out = []
    i = offset
    for row in data:
        span = int(row[0])
        full = row[1:]
        thin = np.zeros_like(full)
        thin[0::3] = full[0::3]
        sa = full[0::3].sum()
        if sa == 2:
            thin[0::3] = 0
        nonseg = np.zeros_like(full)
        while span > 0:
            if i < thinning and i + span >= thinning:
                if thinning - i > 1:
                    out.append(np.r_[thinning - i - 1, thin])
                if sa == 2:
                    out.append(np.r_[1, nonseg])
                else:
                    out.append(np.r_[1, full])
                span -= thinning - i
                i = 0
            else:
                out.append(np.r_[span, thin])
                i += span
                break
    ret = np.array(out, dtype=np.int32)
    assert ret[:, 0].sum() == data[:, 0].sum()
    return ret


def bin_observations(contig, w):
    """Group sites into w-bp windows, keeping one representative row per
    window (the one with maximal sample size, or the first singleton het).
    All output rows have span 1 (in units of windows).
    _estimation_tools.pyx:113-172."""
    data = np.array(contig.data, dtype=np.int32, copy=True)
    na = np.asarray(contig.a)
    try:
        from .. import _native

        return _native.bin_observations(data, na.astype(np.int64), int(w))
    except ImportError:
        pass
    K = (data.shape[1] - 1) // 3
    out = np.zeros((len(contig) // w + 1, data.shape[1]), dtype=np.int32)

    def process_bin(i, j, k):
        max_ss, mq = -2, i
        for q in range(i, j + 1):
            if data[q, 0] == 0:
                continue
            ss, seg = 0, 0
            for aa in range(K):
                bb = 3 * aa
                ss += data[q, bb + 3] + na[aa] * (data[q, bb + 1] >= 0)
                seg += max(0, data[q, bb + 1])
            if ss > max_ss:
                mq, max_ss = q, ss
            if max_ss == 2 and seg == 1:
                mq = q
        out[k, 1:] = data[mq, 1:]

    i = j = k = seen = 0
    while j < data.shape[0]:
        span = data[j, 0]
        if seen + span > w:
            data[j, 0] = w - seen
            process_bin(i, j, k)
            data[j, 0] = span - (w - seen)
            seen = 0
            k += 1
            i = j
        else:
            j += 1
            seen += span
    process_bin(i, j - 1, k)
    out[:, 0] = 1
    return out[: k + 1]


def realign(data, w):
    "Split rows so no span crosses a w-boundary (_estimation_tools.pyx:176-209)."
    data = np.asarray(data, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(data[:, 0])[:-1]])
    ends = starts + data[:, 0]
    # number of interior w-boundaries strictly inside each row
    n_cuts = (ends - 1) // w - starts // w
    reps = 1 + n_cuts
    out = np.repeat(data, reps, axis=0)
    # recompute spans: for each row, pieces between successive boundaries
    idx = np.repeat(np.arange(len(data)), reps)
    # offset within the repeated block
    block_start = np.concatenate([[0], np.cumsum(reps)[:-1]])
    off = np.arange(len(out)) - block_start[idx]
    cut0 = (starts // w + 1) * w  # first boundary after row start
    piece_start = np.where(off == 0, starts[idx], cut0[idx] + (off - 1) * w)
    piece_end = np.minimum(cut0[idx] + off * w, ends[idx])
    out[:, 0] = piece_end - piece_start
    out = out[out[:, 0] > 0]
    assert out[:, 0].sum() == data[:, 0].sum()
    return out


def windowed_mutation_counts(contig, w):
    """Per w-window: (# non-missing sites, # distinguished-het sites),
    walking the contig *backwards* (_estimation_tools.pyx:212-255)."""
    data = np.asarray(contig.data)
    try:
        from .. import _native

        return _native.windowed_mutation_counts(
            np.ascontiguousarray(data[::-1], dtype=np.int32), int(w)
        )
    except ImportError:
        pass
    cd = data[::-1]
    L = data[:, 0].sum()
    n = (data.shape[1] - 1) // 3
    ret = np.zeros((L // w + 1, 2), dtype=np.int64)
    i_row = 0
    last = cd[0].copy()
    seen = nmiss = mut = 0
    j = 0
    while True:
        span = last[0]
        sp = min(span, w - seen)
        extra = seen + span - w
        seen += sp
        a = 0
        for k in range(n):
            v = last[1 + 3 * k]
            if v != -1:
                a += v
            else:
                a = -1
                break
        if a >= 0:
            mut += sp * (a % 2)
            nmiss += sp
        if extra > 0:
            last[0] = extra
            ret[j] = [nmiss, mut]
            j += 1
            nmiss = mut = seen = 0
        else:
            i_row += 1
            if i_row >= len(cd):
                break
            last = cd[i_row].copy()
    ret[j] = [nmiss, mut]
    return ret[: j + 1].T


def recode_nonseg(contig, cutoff):
    """Mark implausibly long homozygous-ancestral runs as missing data.

    A row is suspect when its span exceeds the cutoff and every population
    reports zero derived alleles in both the distinguished pair and the
    undistinguished sample.  With ``cutoff=None`` the row is left intact and
    a warning is logged (threshold 50 kb).  Same semantics as the
    reference's recode step (estimation_tools.py:88-114).
    """
    threshold = 50000 if cutoff is None else cutoff
    d = contig.data
    ancestral_pair = (d[:, 1::3] == 0).all(axis=1)
    no_derived = (d[:, 2::3] == 0).all(axis=1)
    suspect = (d[:, 0] > threshold) & ancestral_pair & no_derived
    if suspect.any():
        if cutoff is None:
            logger.warning(
                "Contig %s contains long homozygous runs (%s bp); consider "
                "masking (vcf2smc -m) or enabling the recode cutoff.",
                contig.fn,
                d[suspect, 0].tolist(),
            )
        else:
            d[suspect, 1::3] = -1
            d[suspect, 3::3] = 0
    return contig


def break_long_spans(contig, span_cutoff):
    """Split a contig wherever a fully-missing run of >= span_cutoff bp
    occurs, dropping the run itself.  Each resulting fragment is prefixed
    with a single missing site so the HMM restarts every fragment from the
    stationary distribution.  (Reference: estimation_tools.py:117-167.)
    """
    d = contig.data
    fully_missing = (d[:, 1::3] == -1).all(axis=1) & (d[:, 3::3] == 0).all(
        axis=1
    )
    breaks = np.flatnonzero(fully_missing & (d[:, 0] >= span_cutoff))
    lead = np.zeros((1, d.shape[1]), dtype=d.dtype)
    lead[0, 0] = 1
    lead[0, 1::3] = -1
    fragments = []
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks, [len(d)]])
    for lo, hi in zip(starts, stops):
        if hi > lo:
            fragments.append(
                Contig(
                    data=np.vstack([lead, d[lo:hi]]),
                    pid=contig.pid,
                    fn=contig.fn,
                    n=contig.n,
                    a=contig.a,
                )
            )
    return fragments


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

@dataclass
class DataPipeline:
    files: Sequence[str]
    _filters: OrderedDict = field(default_factory=OrderedDict)
    _results: List = None

    def __getitem__(self, key):
        self.run()
        return self._filters[key]

    def add_filter(self, *args, **kwargs):
        assert (len(args) == 0) != (len(kwargs) == 0)
        if kwargs:
            self._filters.update(kwargs)
        else:
            self._filters["filter%d" % len(self._filters)] = args[0]
        self._results = None

    def run(self):
        if self._results is not None:
            return self._results
        res = self.files
        for f in self._filters.values():
            logger.debug("pipeline: %s", type(f).__name__)
            res = f(res)
        self._results = res
        return res

    def results(self):
        yield from iter(self.run())


class Filter:
    def __call__(self, contigs):
        return self.run(contigs)


class PerContigFilter(Filter):
    def __call__(self, contigs):
        return [self.run_one(c) for c in contigs]


@dataclass
class LoadData(Filter):
    def __init__(self, cores=None):
        self.cores = cores

    def run(self, files):
        from . import format as fmt

        files = fmt.files_from_command_line_args(files)
        contigs = fmt.load_data(files, cores=self.cores)
        L = sum(c.data[:, 0].sum() for c in contigs)
        logger.info("%.2f Gb of data", L * 1e-9)
        pops = set(c.pid for c in contigs)
        unique_pops = list({x for p in pops for x in p})
        assert len(unique_pops) <= 2, (
            "Only one or two populations are supported; found: %r" % unique_pops
        )
        self.populations = tuple(unique_pops)
        for c in contigs:
            assert len(c.n) == len(c.a)
            assert np.sum(c.a) == 2
            assert c.data.shape[1] == 1 + 3 * len(c.n)
        return contigs


@dataclass
class Validate(PerContigFilter):
    "data_filter.py:125-159"

    def run_one(self, c):
        nonseg = (
            (
                np.all(c.data[:, 1::3] == c.a[None, :], axis=1)
                | np.all(c.data[:, 1::3] == -1, axis=1)
            )
            & np.all(c.data[:, 2::3] == c.data[:, 3::3], axis=1)
            & np.any(c.data[:, 3::3] > 0, axis=1)
        )
        if np.any(nonseg):
            logger.debug(
                "Sites where every individual is homozygous derived in %s", c.fn
            )
            a = c.data[nonseg, 1::3]
            a[a >= 0] = 0
            c.data[nonseg, 1::3] = a
            c.data[nonseg, 2::3] = 0
        bad = (
            (c.data[:, 0] <= 0)
            | np.any(c.data[:, 1::3] > c.a[None, :], axis=1)
            | np.any(c.data[:, 2::3] > c.data[:, 3::3], axis=1)
            | np.any(c.data[:, 3::3] > c.n[None, :], axis=1)
        )
        if np.any(bad):
            raise RuntimeError(
                f"File {c.fn} has invalid observations at rows {np.where(bad)[0]}"
            )
        return c


@dataclass
class Thin(PerContigFilter):
    thinning: int = None

    def run_one(self, c):
        thinning = self.thinning
        if thinning is None:
            thinning = int(500 * np.log(2 + c.n[0]))
        if thinning > 1:
            c.data = thin_data(c.data, thinning)
        return c


@dataclass
class BinObservations(PerContigFilter):
    w: int = 100

    def run_one(self, c):
        c.data = bin_observations(c, self.w)
        return c


@dataclass
class Realign(PerContigFilter):
    w: int = 100

    def run_one(self, c):
        c.data = realign(c.data, self.w)
        return c


@dataclass
class Chunk(Filter):
    "Fixed-size chunks for bootstrap resampling (data_filter.py:198-204)."

    w: int = 100

    def run(self, contigs):
        out = []
        for c in contigs:
            d = realign(c.data, self.w)
            inds = np.where(np.cumsum(d[:, 0]) % self.w == 0)[0]
            out.append(
                [x for x in np.split(d, 1 + inds) if x[:, 0].sum() == self.w]
            )
        return out


@dataclass
class CountMutations(Filter):
    w: int = 100

    def run(self, contigs):
        mc = []
        for c in contigs:
            nmiss, muts = windowed_mutation_counts(c, self.w)
            for m, nm in zip(muts, nmiss):
                if nm > 0.5 * self.w:
                    mc.append(m * self.w / nm)
        self.counts = np.array(mc, dtype=np.float64)
        return contigs


@dataclass
class RecodeNonseg(Filter):
    cutoff: int = None

    def run(self, contigs):
        return [recode_nonseg(c, self.cutoff) for c in contigs]


@dataclass
class Compress(PerContigFilter):
    def run_one(self, c):
        c.data = compress_repeated_obs(c.data)
        return c


@dataclass
class BreakLongSpans(Filter):
    cutoff: int = 100000

    def run(self, contigs):
        return [
            cc for c in contigs for cc in break_long_spans(c, self.cutoff)
        ]


@dataclass
class DropUninformativeContigs(Filter):
    def run(self, contigs):
        def n_var(c):
            d = c.data
            return (
                (d[:, 1::3].sum(axis=1) > 0) | (d[:, 2::3].sum(axis=1) > 0)
            ).sum()

        ret = [c for c in contigs if n_var(c) > 0]
        if len(ret) == 0:
            raise RuntimeError("No contigs have mutation data.")
        return ret


@dataclass
class DropSmallContigs(Filter):
    cutoff: int = 100000

    def run(self, contigs):
        ret = [c for c in contigs if len(c) > self.cutoff]
        if len(ret) == 0:
            raise RuntimeError("All contigs are too small.")
        return ret


@dataclass
class Watterson(Filter):
    "Watterson's theta estimator (data_filter.py:301-322)."

    def run(self, contigs):
        num = denom = 0.0
        for c in contigs:
            spans = c.data[:, 0]
            seg = np.any(c.data[:, 1::3] >= 1, axis=1) | np.any(
                c.data[:, 2::3] > 0, axis=1
            )
            num += spans[seg].sum()
            sample_sizes = c.data[:, 3::3].sum(axis=1) + (
                c.data[:, 1::3] >= 0
            ).sum(axis=1)
            nz = sample_sizes > 0
            ss = sample_sizes[nz]
            denom += (
                spans[nz] * (np.log(ss) + 0.5 / ss + 0.57721)
            ).sum()
        self.theta_hat = num / denom
        logger.debug("watterson: %f", self.theta_hat)
        return contigs


@dataclass
class RecodeMonomorphic(PerContigFilter):
    "Fold all-derived sites to all-ancestral (data_filter.py:326-336)."

    def run_one(self, c):
        w = np.all(c.data[:, 1::3] == c.a, axis=1) & np.all(
            c.data[:, 2::3] == c.data[:, 3::3], axis=1
        )
        c.data[w, 1::3] = 0
        c.data[w, 2::3] = 0
        return c


@dataclass
class Summarize(Filter):
    def run(self, contigs):
        for c in contigs:
            logger.debug("%s", c.data[:10])
        return contigs
