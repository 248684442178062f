"""Host-local data ingestion for multi-process jobs.

Port of smcpp_tpu/parallel/hostlocal.py.  Under the replicated driver every
process loads, filters and packs the whole dataset; here each process
ingests only its own contiguous shard of the input files and assembles the
global picture from

* header-only reads of every file (population structure, sample sizes:
  data/format.py:load_header), so the model set-up needs no collective;
* a few small set-up collectives over the gloo host group (Mesh.host_group)
  for what the fit needs globally: Watterson's theta, the windowed mutation
  counts, the emission-key union, the span and key totals;
* each rank packing its own contigs into its block of the global segment
  rows (``pack_windows_local``), with global segment ids in seg_of_contig:
  no host ever holds another host's observations.

Every process must run the same collectives in the same order.  Every
helper here runs unconditionally on every rank (an empty shard contributes
zero-length arrays); callers never gate a collective on local data.

Files are assigned in contiguous blocks (``np.array_split`` order), so rank
order is file order: concatenating any per-contig quantity over the ranks
gives the order a single process would see (the empirical-TMRCA mixture
fit is order-sensitive).
"""

import logging
import os
import types

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def active(mesh):
    """True when ``mesh`` is a live group and host-local ingestion is not
    turned off (SMCPP_TPU_REPLICATED_DATA=1; the CLI's --replicated-data)."""
    if os.environ.get("SMCPP_TPU_REPLICATED_DATA") == "1":
        return False
    return mesh is not None and mesh.size > 1


def shard_files(files, mesh):
    "This rank's contiguous shard of the (globally ordered) file list."
    parts = np.array_split(np.asarray(files, dtype=object), mesh.size)
    return [str(f) for f in parts[mesh.rank]]


def shard_ingestion(all_files, mesh):
    """The headers of ALL files and this rank's contiguous file shard: the
    shared entry of every host-local command (estimate and split through
    BaseAnalysis, posterior directly)."""
    from ..data import format as fmt

    headers = [fmt.load_header(str(f)) for f in all_files]
    local = shard_files(all_files, mesh)
    logger.info(
        "host-local ingestion: process %d/%d loads %d of %d files",
        mesh.rank, mesh.size, len(local), len(all_files),
    )
    return headers, local


# ---------------------------------------------------------------------------
# Set-up collectives over the gloo host group.  all_gather needs equal
# shapes on every rank, so variable-length contributions are padded to the
# global maximum (one extra gather for the lengths).
# ---------------------------------------------------------------------------

def _all_gather_host(mesh, t):
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.host_group)
    return parts


def _gather_stacked(x, mesh):
    """(P, ...) stack of every rank's equal-shaped array, as NumPy.

    Every gather is preceded by a fixed-size fingerprint gather asserting
    that all ranks contribute the same shape and dtype: gloo delivers
    corrupt bytes instead of failing on a mismatch (np.bincount returns
    int64 on an empty shard where the others send float64), so a mismatch
    must be caught before the payload.  The payload travels as its bytes."""
    x = np.ascontiguousarray(x)
    fp = np.zeros(8, np.int64)
    fp[0] = x.ndim
    fp[1] = x.dtype.num
    fp[2:2 + min(x.ndim, 6)] = x.shape[:6]
    fps = np.stack([p.numpy() for p in _all_gather_host(mesh, torch.from_numpy(fp))])
    if not (fps == fps[0]).all():
        raise RuntimeError(
            "host-local collective mismatch: processes contributed "
            f"different shapes/dtypes; fingerprints {fps.tolist()} "
            f"(this process: shape={x.shape}, dtype={x.dtype})"
        )
    raw = torch.from_numpy(x.reshape(-1).view(np.uint8).copy())
    parts = _all_gather_host(mesh, raw)
    return np.stack([p.numpy().view(x.dtype).reshape(x.shape) for p in parts])


def allreduce_sum(x, mesh):
    "Global sum of a scalar or array contributed by every rank (rank order)."
    return _gather_stacked(x, mesh).sum(axis=0)


def allreduce_max(x, mesh):
    "Global max of a scalar or array contributed by every rank."
    return _gather_stacked(x, mesh).max(axis=0)


def allgather_concat(a, mesh, ncols=None):
    """Concatenate every rank's (n_p, ...) array along axis 0 in rank order.
    Row counts may differ; trailing dims must agree where nonempty (``ncols``
    pins the trailing dim for ranks with 0 rows)."""
    a = np.asarray(a)
    squeeze = a.ndim == 1
    if squeeze:
        a = a[:, None]
    if ncols is None:
        ncols = 1 if squeeze else int(
            allreduce_max(np.int64(a.shape[1] if a.size else 0), mesh))
    if a.shape[0] == 0:
        a = a.reshape(0, ncols)
    if a.shape[1] != ncols:
        raise ValueError(f"allgather_concat: {a.shape[1]} columns, expected {ncols}")
    counts = _gather_stacked(np.int64(a.shape[0]), mesh)
    nmax = int(counts.max())
    if a.shape[0] < nmax:
        a = np.concatenate([a, np.zeros((nmax - a.shape[0], ncols), a.dtype)])
    g = _gather_stacked(a, mesh)  # (P, nmax, ncols)
    out = np.concatenate([g[p, :int(counts[p])] for p in range(g.shape[0])])
    return out[:, 0] if squeeze else out


def global_unique_rows(rows, mesh, ncols=None):
    "Global np.unique(axis=0) of every rank's (n_p, w) int rows."
    return np.unique(allgather_concat(rows, mesh, ncols=ncols), axis=0)


# ---------------------------------------------------------------------------
# Window packing: local contigs -> this rank's block of the global rows
# ---------------------------------------------------------------------------

def pack_windows_local(data_list, key_id, mesh, pad_key=0, seg_target=8192,
                       min_seg_len=64, max_seg_len=16384):
    """Pack THIS rank's contigs into its block of the global segment rows.

    Returns (keys, valid, seg_of_contig, local): keys, valid (block, L) are
    this rank's rows (every rank's block has the size of the largest local
    shard, at least 1; all-invalid padding rows fill it), seg_of_contig the
    gathered (C_global, NS) table with GLOBAL segment ids, the same on every
    rank; ``local`` carries the block's first row, its size, L and each
    local contig's segment ids, for ``decode_row_placement``.

    A single process's ops/window_kernel.py:pack_windows gives the same
    segments up to their row order and the padding rows."""
    from ..ops import window_kernel as wk

    win = wk.decompress_to_windows(data_list, key_id)
    W = int(allreduce_sum(np.int64(sum(len(w) for w in win)), mesh))
    L = wk.window_segment_length(W, seg_target, min_seg_len, max_seg_len)
    segs, seg_ids = wk.cut_segments(win, L)
    block = max(int(allreduce_max(np.int64(len(segs)), mesh)), 1)
    lo, _ = mesh.block(block)

    keys = np.full((block, L), pad_key, dtype=np.int32)
    valid = np.zeros((block, L), dtype=bool)
    for i, seg in enumerate(segs):
        keys[i, :len(seg)] = seg
        valid[i, :len(seg)] = True

    NS = max(int(allreduce_max(np.int64(max(map(len, seg_ids), default=0)), mesh)), 1)
    soc = np.full((len(seg_ids), NS), -1, dtype=np.int64)
    for c, ids in enumerate(seg_ids):
        soc[c, :len(ids)] = lo + np.asarray(ids, dtype=np.int64)
    soc = allgather_concat(soc, mesh, ncols=NS)
    logger.info(
        "host-local window packing: process %d/%d packed %d contigs / %d "
        "segments (L=%d) into rows %d..%d of the (%d, %d) global arrays",
        mesh.rank, mesh.size, len(seg_ids), len(segs), L, lo, lo + block - 1,
        block * mesh.size, L,
    )
    local = types.SimpleNamespace(lo=lo, block=block, L=L, seg_ids=seg_ids)
    return keys, valid, soc, local


def decode_row_placement(spans_list, local, mesh):
    """Row numbering for the window decodes when each rank packed only its
    own contigs (``pack_windows_local``).  Rows are numbered rank-major,
    which is global file order.  Returns (n_rows, row_offset, ends):

    * n_rows: the global number of compressed rows;
    * row_offset: the first global row of THIS rank's contigs;
    * ends: (n_rows,) int64, each row's last window as a global flat
      (segment-major) index, strictly increasing, the same on every rank."""
    counts = _gather_stacked(np.int64(sum(len(s) for s in spans_list)), mesh)
    off = int(counts[:mesh.rank].sum())
    ends = []
    for c, spans in enumerate(spans_list):
        segs = local.lo + np.asarray(local.seg_ids[c], dtype=np.int64)
        w_end = np.cumsum(np.asarray(spans, dtype=np.int64)) - 1
        ends.append(segs[w_end // local.L] * local.L + w_end % local.L)
    ends_l = np.concatenate(ends) if ends else np.zeros(0, np.int64)
    ends = allgather_concat(ends_l.astype(np.int64), mesh, ncols=1)
    return int(counts.sum()), off, ends
