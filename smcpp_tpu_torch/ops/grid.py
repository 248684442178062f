"""Static time-grid construction (host side).

The piecewise-constant coalescent rate function eta(t) is defined by static
piece widths ``s`` and traced per-piece population sizes ``a``.  Hidden-state
boundaries are spliced into the time grid with the same tolerance rules the
reference uses (SMC++ src/piecewise_constant_rate_function.cpp:58-81),
but on the *host* at setup time.  The result is a set of static index maps so
that every model-dependent quantity downstream is a fixed-shape, jit-friendly
function of the traced size vector ``a`` alone.
"""

from dataclasses import dataclass, field

import numpy as np

from .. import defaults


@dataclass(frozen=True)
class TimeGrid:
    """Static description of the augmented time discretization.

    Attributes
    ----------
    ts : (K+1,) float64 — grid times, ts[0] == 0, ts[K] == inf.
    dt : (K,) float64 — piece widths; the last width is ``defaults.BIG_T``
        (a finite stand-in for infinity; see defaults.py).
    src : (K,) int64 — index into the *model* piece array from which each
        augmented piece inherits its population size.
    hs_indices : (M+1,) int64 — index into ``ts`` of each hidden-state
        boundary (the last one points at the infinite grid point K).
    hidden_states : (M+1,) float64 — hidden-state boundaries (coalescent units).
    """

    ts: np.ndarray
    dt: np.ndarray
    src: np.ndarray
    hs_indices: np.ndarray
    hidden_states: np.ndarray

    @property
    def K(self) -> int:
        return len(self.dt)

    @property
    def M(self) -> int:
        "Number of hidden intervals."
        return len(self.hs_indices) - 1

    # which hidden interval each piece belongs to (piece m in [hs[h], hs[h+1]))
    interval_of_piece: np.ndarray = field(init=False, default=None)
    piece_valid: np.ndarray = field(init=False, default=None)

    def __post_init__(self):
        h_of_m = np.searchsorted(self.hs_indices, np.arange(self.K), side="right") - 1
        # Pieces before the first / after the last hidden-state boundary do not
        # belong to any hidden interval (possible when hs[0] > 0).
        valid = (h_of_m >= 0) & (h_of_m < self.M)
        object.__setattr__(self, "interval_of_piece", np.clip(h_of_m, 0, self.M - 1))
        object.__setattr__(self, "piece_valid", valid)

    def segment_matrix(self) -> np.ndarray:
        "Static (M, K) 0/1 matrix summing pieces into their hidden interval."
        seg = np.zeros((self.M, self.K), dtype=self.dt.dtype)
        idx = np.arange(self.K)[self.piece_valid]
        seg[self.interval_of_piece[self.piece_valid], idx] = 1.0
        return seg

    def astype(self, dtype) -> "TimeGrid":
        """Grid with float fields cast to ``dtype`` (for reduced-precision
        setup programs, e.g. the TPU f32 M-step objective).

        For float32 the terminal "infinite" width is re-clamped from
        ``defaults.BIG_T`` (1e250, f32-overflow) to 1e25: still large enough
        that exp(-ada * BIG_T) == 0.0 exactly for any ada >= 1e-22, while
        intermediate products like rate * R_terminal (~1e3 * 1e28) stay far
        below f32 max."""
        dtype = np.dtype(dtype)
        if dtype == self.dt.dtype:
            return self
        dt = self.dt.copy()
        if dtype == np.float32:
            dt[-1] = min(defaults.BIG_T, 1e25)
        dt = dt.astype(dtype)
        return TimeGrid(
            ts=self.ts.astype(dtype),
            dt=dt,
            src=self.src,
            hs_indices=self.hs_indices,
            hidden_states=self.hidden_states.astype(dtype),
        )


def make_time_grid(s, hidden_states) -> TimeGrid:
    """Build the augmented grid from model piece widths and hidden states.

    Mirrors the splice logic of the reference constructor
    (piecewise_constant_rate_function.cpp:58-81): a hidden state lands on an
    existing grid point if within 1e-8, otherwise a new grid point is inserted
    and the enclosing piece is subdivided (both halves keep the same size).
    """
    s = np.asarray(s, dtype=np.float64)
    K0 = len(s)
    ts = [0.0]
    for k in range(K0):
        ts.append(ts[-1] + s[k])
    ts[K0] = np.inf
    ts = list(ts)
    src = list(range(K0))

    hs = np.asarray(hidden_states, dtype=np.float64)
    hs_indices = []
    for h in hs:
        if np.isinf(h):
            hs_indices.append(len(ts) - 1)
            continue
        # upper_bound(ts, h) - 1
        ip = int(np.searchsorted(ts, h, side="right")) - 1
        if abs(ts[ip] - h) < 1e-8:
            hs_indices.append(ip)
        elif ip + 1 < len(ts) and abs(ts[ip + 1] - h) < 1e-8:
            hs_indices.append(ip + 1)
        else:
            ts.insert(ip + 1, h)
            src.insert(ip + 1, src[ip])
            hs_indices.append(ip + 1)

    ts = np.asarray(ts, dtype=np.float64)
    src = np.asarray(src, dtype=np.int64)
    dt = np.diff(ts)
    dt[-1] = defaults.BIG_T
    return TimeGrid(
        ts=ts,
        dt=dt,
        src=src,
        hs_indices=np.asarray(hs_indices, dtype=np.int64),
        hidden_states=hs,
    )
