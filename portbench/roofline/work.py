"""The least work of the HMM's passes over a cell's rows, whatever
implements them.

A row of span s applies one (M, M) operator s times.  One pass over it
costs at least the smaller of s matrix-vector products (s M^2 multiply-adds,
the sequential recursion) and bitlen(s) matrix products (bitlen(s) M^3,
binary exponentiation, as the port's row-level routes do), and nothing
less is known that is exact.  The window kernels do more than that: K4's
segment products alone are M^3 a window.  So a share of this count can
only fall short of 100%, never pass it, whichever route a later change
takes.

The Viterbi: one max-plus forward pass, an add (FMA pipe) and a max (ALU
pipe) a candidate, so bound by the ALU pipe; it reads each row once and
writes one int32 state a row.
"""

import numpy as np

from . import peaks


def pass_work(spans, M):
    "Least multiply-adds (or max-plus candidates) of one pass over the rows."
    s = np.asarray(spans, np.int64)
    s = s[s > 0]
    bits = np.floor(np.log2(s)).astype(np.int64) + 1
    return float(np.minimum(s * M * M, bits * M**3).sum())


def viterbi_least_s(spans, M, sm_clock_mhz):
    "(seconds, 'operations' or 'bytes') of the Viterbi's least work."
    cand = pass_work(spans, M)
    t_ops = max(cand / peaks.FMA_PER_S, cand / peaks.alu_per_s(sm_clock_mhz))
    t_bytes = (12 * len(spans)) / peaks.HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
