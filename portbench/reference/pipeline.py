"""The data pipeline of ``estimate`` and ``posterior``, written again in
vectorised NumPy from the semantics of the port's filters
(smcpp_tpu_torch/data/filters.py, SMC++ _estimation_tools.pyx): what a
contig's rows become before the HMM reads them.  One population; rows are
(span, a, b, nb)."""

import numpy as np

MISSING_SPAN_CUTOFF = 100_000  # BreakLongSpans
SMALL_CONTIG = 100_000  # DropSmallContigs


def compress(rows):
    "Merge consecutive rows whose observation columns agree (Compress)."
    rows = np.asarray(rows)
    if len(rows) == 0:
        return rows
    start = np.ones(len(rows), bool)
    start[1:] = (rows[1:, 1:] != rows[:-1, 1:]).any(1)
    idx = np.flatnonzero(start)
    total = np.cumsum(rows[:, 0].astype(np.int64))
    ends = np.append(total[idx[1:] - 1], total[-1])
    out = rows[idx].copy()
    out[:, 0] = np.diff(ends, prepend=0)
    return out


def break_long_spans(rows):
    """Fragments split at fully missing runs of at least 100 kbp, the run
    dropped, each fragment led by one missing base (BreakLongSpans)."""
    miss = (rows[:, 1] == -1) & (rows[:, 3] == 0)
    cut = np.flatnonzero(miss & (rows[:, 0] >= MISSING_SPAN_CUTOFF))
    lead = np.array([[1, -1, 0, 0]], rows.dtype)
    lo = np.r_[0, cut + 1]
    hi = np.r_[cut, len(rows)]
    return [np.vstack([lead, rows[a:b]]) for a, b in zip(lo, hi) if b > a]


def stage1(contigs):
    """The contigs the first stage of ``estimate`` fits (RecodeNonseg with no
    cutoff changes nothing; Compress, BreakLongSpans, DropSmallContigs)."""
    out = []
    for rows in contigs:
        out += break_long_spans(compress(rows))
    return [c for c in out if int(c[:, 0].sum()) > SMALL_CONTIG]


def watterson(contigs):
    "Watterson's estimate of theta per base (the Watterson filter)."
    num = den = 0.0
    for c in contigs:
        span = c[:, 0].astype(np.float64)
        num += span[(c[:, 1] >= 1) | (c[:, 2] > 0)].sum()
        ss = c[:, 3] + (c[:, 1] >= 0)
        nz = ss > 0
        s = ss[nz].astype(np.float64)
        den += (span[nz] * (np.log(s) + 0.5 / s + 0.57721)).sum()
    return num / den


def thin(rows, k):
    """Every k-th base (positions k-1, 2k-1, ...) keeps its full
    observation, or none at all where the distinguished pair is homozygous
    derived; every other base keeps the distinguished genotype alone (the
    Thin filter)."""
    rows = rows[rows[:, 0] > 0]
    span = rows[:, 0].astype(np.int64)
    starts = np.r_[0, np.cumsum(span)[:-1]]
    L = int(span.sum())
    P = np.arange(k - 1, L, k, dtype=np.int64)
    cuts = np.unique(np.concatenate([starts, P, P + 1, [L]]))
    cuts = cuts[cuts <= L]
    s0, ln = cuts[:-1], np.diff(cuts)
    r = np.searchsorted(starts, s0, side="right") - 1
    a = rows[r, 1]
    hom = a == 2
    mark = (s0 % k) == (k - 1)
    out = np.zeros((len(s0), 4), np.int64)
    out[:, 0] = ln
    out[:, 1] = np.where(hom, 0, a)
    full = mark & ~hom
    out[full, 2] = rows[r[full], 2]
    out[full, 3] = rows[r[full], 3]
    return out


def bin_windows(rows, w, na=2):
    """One row of span 1 for each w-base window (the BinObservations
    filter): the first row with the largest sample size nb + na [a >= 0]
    among the rows overlapping the window, except where that size is 2 (no
    undistinguished sample), where the last heterozygous row wins, or else
    the first row of size 2."""
    rows = rows[rows[:, 0] > 0]
    span = rows[:, 0].astype(np.int64)
    starts = np.r_[0, np.cumsum(span)[:-1]]
    ends = starts + span
    first, last = starts // w, (ends - 1) // w
    cnt = last - first + 1
    pr = np.repeat(np.arange(len(rows)), cnt)
    off = np.arange(len(pr)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    pw = first[pr] + off
    a = rows[pr, 1]
    ss = rows[pr, 3] + na * (a >= 0)
    nw = int(pw[-1]) + 1
    bounds = np.flatnonzero(np.r_[True, pw[1:] != pw[:-1]])
    idx = np.arange(len(pr))
    big = len(pr)
    wmax = np.maximum.reduceat(ss, bounds)
    at_max = ss == wmax[pw]
    first_max = np.minimum.reduceat(np.where(at_max, idx, big), bounds)
    last_het = np.maximum.reduceat(np.where(a == 1, idx, -1), bounds)
    pick = np.where((wmax == 2) & (last_het >= 0), last_het, first_max)
    assert len(bounds) == nw
    out = rows[pr[pick]].copy()
    out[:, 0] = 1
    return out


def recode_monomorphic(rows, na=2):
    "All-derived sites folded to all-ancestral (RecodeMonomorphic)."
    rows = rows.copy()
    mono = (rows[:, 1] == na) & (rows[:, 2] == rows[:, 3])
    rows[mono, 1] = 0
    rows[mono, 2] = 0
    return rows


def stage2(contigs, w, thinning):
    """Stage 1's contigs as the second stage of ``estimate`` fits them:
    Thin, BinObservations, RecodeMonomorphic, Compress, and the contigs with
    no variant dropped."""
    out = []
    for c in contigs:
        b = compress(recode_monomorphic(bin_windows(thin(c, thinning), w)))
        if ((b[:, 1] > 0) | (b[:, 2] > 0)).any():
            out.append(b)
    return out


def posterior_rows(rows):
    "A contig as ``posterior`` decodes it: one missing base put first."
    return np.vstack([np.array([[1, -1, 0, 0]], rows.dtype), rows])
