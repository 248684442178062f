"""SMC++ data-format reader/writer.

The text format is unchanged from the reference so datasets are
interchangeable: a ``# SMC++ {json}`` header followed by space-separated
rows ``span a b nb [a2 b2 nb2]``.  Reference:
SMC++ smcpp/estimation_tools.py:236-283 and commands/vcf2smc.py.
"""

import gzip
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..contig import Contig


def optional_gzip(fn, mode):
    return gzip.open(fn, mode) if str(fn).endswith(".gz") else open(fn, mode)


class RunLengthWriter:
    """Stream rows to a text file, coalescing consecutive rows that share
    the same observation columns into a single summed span.  O(1) memory,
    for the record-by-record vcf2smc path.  Produces the same run-length
    output format as the reference (smcpp/util.py run-length writer)."""

    def __init__(self, fileobj):
        self._file = fileobj
        self._span = 0
        self._key = None
        self.rows_written = 0

    def write(self, row):
        span, key = int(row[0]), tuple(row[1:])
        if key == self._key:
            self._span += span
        else:
            self._emit()
            self._span, self._key = span, key

    def _emit(self):
        if self._key is not None and self._span > 0:
            print(self._span, *self._key, file=self._file)
            self.rows_written += 1
        self._span, self._key = 0, None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._emit()
        return False


# historical alias
RepeatingWriter = RunLengthWriter


def write_contig(fn, data, pids, dist, undist, version="tpu-0.1.0"):
    """Write rows with run-length merging and the SMC++ JSON header: the text
    RunLengthWriter gives (consecutive rows of one key summed, runs of span
    0 dropped), merged and formatted with NumPy in one pass; a .gz file is
    compressed at gzip's default level 6."""
    data = np.asarray(data, dtype=np.int64)
    rows = data[:0]
    if len(data):
        key = data[:, 1:]
        new = np.ones(len(data), dtype=bool)
        new[1:] = np.any(key[1:] != key[:-1], axis=1)
        starts = np.flatnonzero(new)
        rows = np.c_[np.add.reduceat(data[:, 0], starts), key[starts]]
        rows = rows[rows[:, 0] > 0]
    header = json.dumps(
        {"version": version, "pids": list(pids), "undist": undist, "dist": dist}
    )
    opener = (gzip.open(fn, "wt", compresslevel=6) if str(fn).endswith(".gz")
              else open(fn, "w"))
    with opener as out:
        out.write("# SMC++ " + header + "\n")
        if len(rows):
            out.write("\n".join(map(" ".join, rows.astype(str).tolist())) + "\n")


def load_contig(fn):
    "Parse one SMC++ file into a Contig (estimation_tools.py:236-267)."
    with optional_gzip(fn, "rt") as f:
        first = f.readline().strip()
        if not first.startswith("# SMC++"):
            raise RuntimeError(f"{fn} is not in SMC++ format")
        attrs = json.loads(first[7:])
        if "pids" not in attrs:
            raise RuntimeError("Data format is too old. Re-run vcf2smc.")
        A = np.loadtxt(f, dtype=np.int32, ndmin=2)
    if len(A) == 0:
        raise RuntimeError(f"empty dataset: {fn}")
    a = [len(d) for d in attrs["dist"]]
    n = [len(u) for u in attrs["undist"]]
    pid = tuple(attrs["pids"])
    # put the population containing the distinguished pair first
    if len(a) == 2 and a[0] == 0 and a[1] == 2:
        n = n[::-1]
        a = a[::-1]
        pid = pid[::-1]
        A = A[:, [0, 4, 5, 6, 1, 2, 3]]
    return Contig(pid=pid, data=np.ascontiguousarray(A), n=n, a=a, fn=str(fn))


def load_header(fn):
    """Parse ONLY the ``# SMC++ {json}`` header line: (pid tuple, n, a).

    O(bytes-of-one-line) — lets every process in a multi-host job learn the
    population structure of ALL files while loading full data only for its
    own shard (parallel/hostlocal.py).  Applies the same
    distinguished-pair-first normalization as load_contig."""
    with optional_gzip(fn, "rt") as f:
        first = f.readline().strip()
    if not first.startswith("# SMC++"):
        raise RuntimeError(f"{fn} is not in SMC++ format")
    attrs = json.loads(first[7:])
    if "pids" not in attrs:
        raise RuntimeError("Data format is too old. Re-run vcf2smc.")
    a = [len(d) for d in attrs["dist"]]
    n = [len(u) for u in attrs["undist"]]
    pid = tuple(attrs["pids"])
    if len(a) == 2 and a[0] == 0 and a[1] == 2:
        n = n[::-1]
        a = a[::-1]
        pid = pid[::-1]
    return pid, n, a


def files_from_command_line_args(args):
    ret = []
    for f in args:
        if f[0] == "@":
            ret += [line.strip() for line in open(f[1:]) if line.strip()]
        else:
            ret.append(f)
    return sorted(set(ret))


def load_data(files, cores=None):
    "Parallel contig loading; ``cores`` caps the worker threads (--cores)."
    with ThreadPoolExecutor(max_workers=cores) as p:
        return list(p.map(load_contig, files))
