"""The port's mesh: one rank of a torch.distributed group, one device.

Port of smcpp_tpu/parallel/mesh.py.  JAX shards arrays over a ``('data',)``
device mesh and lets XLA insert the collectives; here each rank holds its
contiguous block of rows and the sharded functions call the collectives
below themselves, in the same order on every rank.

The window kernel shards the SEGMENT axis (sequence parallelism: one long
contig's segments spread over every rank, as equal-length segments balance
the load): ``estep_direct``, ``decode_gammas_windows`` and
``viterbi_windows`` (ops/window_kernel.py) take the mesh, run the
per-segment passes on the rank's block (K3, K1, K2, K2g, K4, K5) and the
per-contig scans over segment operators replicated after an ``all_gather``
(K6, K7).  The span kernel shards the CONTIG axis: the manager runs
``hmm.estep``, ``hmm.decode_gammas`` or ``hmm.viterbi_paths`` on the rank's
contigs and reduces or gathers what they return.

Statistics reduce with ``all_reduce`` in float64, so one rank and N ranks
differ only in the order of the sums, and every rank receives the same
bits.  Only ``all_reduce``, ``broadcast`` and the list form of
``all_gather`` are used: gloo takes CUDA tensors for these three, so one
code path serves NCCL and gloo.  Each collective is the identity when the
mesh is None (a single process), so one code path serves both.

Every collective runs unconditionally: a rank whose block holds only
padding rows (all-invalid segments, span-0 contigs) contributes them like
any other.
"""

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """One rank's view of the job: the world ``group`` (NCCL or gloo), the
    gloo ``host_group`` for host-side collectives, this process's ``rank`` in
    [0, ``size``) and its ``device``."""

    def __init__(self, group, host_group, rank, size, device):
        self.group = group
        self.host_group = host_group
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)

    def __repr__(self):
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device})"

    def block(self, n_local):
        """[lo, hi) global rows of this rank's block of ``n_local`` rows (every
        rank holds a block of the same size)."""
        return self.rank * n_local, (self.rank + 1) * n_local

    def handshake(self):
        """One all_reduce on each group, so that a backend that cannot start
        (NCCL with two ranks on one card) fails here, at set-up."""
        x = torch.ones(1, device=self.device)
        dist.all_reduce(x, group=self.group)
        h = torch.ones(1)
        dist.all_reduce(h, group=self.host_group)
        if float(x) != self.size or float(h) != self.size:
            raise RuntimeError(
                f"process group handshake: {float(x)}, {float(h)} != {self.size}"
            )


# ---------------------------------------------------------------------------
# Collectives on the rank's device
# ---------------------------------------------------------------------------

def gather_rows(mesh, x):
    """Every rank's block of rows, concatenated in rank order (the list form
    of all_gather; every block has the same shape).  ``x`` itself when
    ``mesh`` is None."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def reduce_sum(mesh, x):
    """The sum of ``x`` over the ranks, on every rank (a new tensor); ``x``
    itself when ``mesh`` is None."""
    if mesh is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=mesh.group)
    return y


def broadcast(mesh, x, src=0):
    "Rank ``src``'s ``x`` on every rank (in place; returns x)."
    dist.broadcast(x, src, group=mesh.group)
    return x


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def pad_rows(x, n):
    "Pad axis 0 of a host array with zero rows to a multiple of n."
    pad = (-x.shape[0]) % n
    if pad == 0 and x.shape[0] > 0:
        return x
    pad = pad or n
    return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])


def pad_segments(keys, valid, n):
    """Pad the segment axis to a multiple of n (at least n rows).  Padding
    segments are all-invalid: identity operators with log scale 0, never
    listed in seg_of_contig."""
    return pad_rows(keys, n), pad_rows(valid, n)


def local_block(mesh, x):
    "This rank's contiguous block of the rows of a padded host array."
    n = x.shape[0] // mesh.size
    lo, hi = mesh.block(n)
    return x[lo:hi]


def block_start(mesh, n_local):
    "The first global row of this rank's block of ``n_local`` rows (0 alone)."
    return 0 if mesh is None else mesh.block(n_local)[0]
