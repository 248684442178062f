"""The static arrays of the Q family as tensors, built once and kept.

Every array the Q family (ops/ratefunc.py, transition.py, csfs.py,
emission.py and the model's spline) reads that does not depend on the size
vector ``a``: the grid's widths, times, masks and index maps, the segment
matrix, the CSFS rate vectors, the Moran matrices, the emission index's
weights and kinds, the spline's evaluation plan.  ``QConsts`` holds them
for one (grid, dtype, device), each made on first use and kept.

The one-population manager keeps one per grid and dtype, made whole at once
(``prime``), so that a Q evaluation copies nothing from the host but its
inputs and can be captured as a CUDA graph (inference/qgraph.py).  An op
called without one makes a fresh one for the call, which copies what that
call reads, as the ops always did (the split objective's grids, whose
widths are tensors of the split time, go that way).

Each array is the one the ops built inline before, converted the same way
(``torch.as_tensor`` of the same NumPy expression, in the working dtype),
so both routes give the same bits.
"""

import functools

import numpy as np
import torch

from . import exact


def nC2(v):
    v = np.asarray(v)
    return v * (v - 1) // 2


def device_arrays(arrays, dtype, device):
    """NumPy arrays as tensors on ``device``: floats in ``dtype``, integers
    and booleans as they are (int64 index maps, masks)."""
    out = {}
    for name, x in arrays.items():
        x = np.ascontiguousarray(x)
        kind = {} if x.dtype.kind in "biu" else {"dtype": dtype}
        out[name] = torch.as_tensor(x, device=device, **kind)
    return out


def _memo(f):
    "Memoise a method with hashable arguments on the instance."

    @functools.wraps(f)
    def get(self, *args):
        key = (f.__name__,) + args
        v = self._memo.get(key)
        if v is None:
            v = self._memo[key] = f(self, *args)
        return v

    return get


class _NS:
    "A few named tensors."

    def __init__(self, **kw):
        self.__dict__.update(kw)


class QConsts:
    """The static arrays of one grid (and of n, the emission index and the
    spline) as tensors of ``dtype`` on ``device``."""

    # the grid's arrays, every one ``prime`` makes
    GRID = ("src", "dt", "zero_piece", "hs", "hs_lo", "hs_hi", "hs_mid",
            "hs_lo2", "piece_h", "seg", "t0", "t1", "ts", "pe_zero", "pe_dt",
            "pe_last", "absorbing", "eye3", "upper", "lower")

    def __init__(self, grid, dtype, device):
        self.grid, self.dtype, self.device = grid, dtype, torch.device(device)
        self._memo = {}

    def _f(self, x):
        "A float array (or a tensor, such as a traced width) in the dtype."
        if torch.is_tensor(x):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.ascontiguousarray(x), dtype=self.dtype,
                               device=self.device)

    def _i(self, x):
        "An index map or a mask, as it is."
        return torch.as_tensor(x, device=self.device)

    def prime(self, n, idx=None, model=None):
        """Make every array a one-population Q evaluation of sample size
        ``n`` reads (with the emission index ``idx`` and ``model``'s spline,
        where given)."""
        for name in self.GRID:
            getattr(self, name)
        self.below(n)
        self.above(n)
        self.moran(n)
        self.first((3, n + 1))
        if idx is not None:
            self.emission(idx)
        if model is not None:
            self.spline(model)
        return self

    # -- the grid (ratefunc) --------------------------------------------------
    @functools.cached_property
    def src(self):
        return self._i(self.grid.src)

    @functools.cached_property
    def dt(self):
        return self._f(self.grid.dt)

    @functools.cached_property
    def zero_piece(self):
        "(K,) pieces of zero width."
        return self._i(self.grid.dt <= 0.0)

    @functools.cached_property
    def hs(self):
        return self._i(self.grid.hs_indices)

    @functools.cached_property
    def hs_lo(self):
        return self._i(self.grid.hs_indices[:-1])

    @functools.cached_property
    def hs_hi(self):
        return self._i(self.grid.hs_indices[1:])

    @functools.cached_property
    def hs_mid(self):
        return self._i(self.grid.hs_indices[1:-1])

    @functools.cached_property
    def hs_lo2(self):
        return self._i(self.grid.hs_indices[:-2])

    @functools.cached_property
    def piece_h(self):
        "The hidden interval of each piece."
        return self._i(self.grid.interval_of_piece)

    @functools.cached_property
    def seg(self):
        return self._f(self.grid.segment_matrix())

    @functools.cached_property
    def t0(self):
        return self._f(self.grid.hidden_states[:-1])

    @functools.cached_property
    def t1(self):
        hs = self.grid.hidden_states
        return self._f(np.where(np.isinf(hs[1:]), 0.0, hs[1:]))

    @functools.cached_property
    def ts(self):
        return self._f(self.grid.ts)

    # -- the grid (transition) ------------------------------------------------
    def _is_last(self):
        is_last = np.zeros(self.grid.K, dtype=bool)
        is_last[-1] = True
        return is_last

    @functools.cached_property
    def pe_zero(self):
        "(K,) zero-width pieces but the terminal one."
        return self._i(~self._is_last() & (self.grid.dt <= 0.0))

    @functools.cached_property
    def pe_dt(self):
        "(K,) widths with the terminal one masked to 1."
        return self._f(np.where(self._is_last(), 1.0, self.grid.dt))

    @functools.cached_property
    def pe_last(self):
        return self._i(self._is_last())[:, None, None]

    @functools.cached_property
    def absorbing(self):
        return self._f(np.array([[0.0, 0.0, 1.0]] * 3))

    @functools.cached_property
    def eye3(self):
        return self._f(np.eye(3))

    @functools.cached_property
    def upper(self):
        "(M, M) k > j, hidden intervals 1..M."
        j = np.arange(1, self.grid.M + 1)
        return self._i(j[None, :] > j[:, None])

    @functools.cached_property
    def lower(self):
        m = np.arange(self.grid.M)
        return self._i(m[None, :] < m[:, None])

    # -- n: the CSFS's rate vectors and Moran matrices -------------------------
    def _rates(self, rates):
        "Single-integral rates (R, 1), their zero-safe copy and zero mask."
        r = np.asarray(rates, dtype=np.float64)[:, None]
        return _NS(rate=self._f(r), safe=self._f(np.where(r == 0, 1.0, r)),
                   zero=self._i(r == 0))

    @_memo
    def below(self, n):
        "tjj_below's rates C(j,2)-1, j = 2..n+2."
        return self._rates(nC2(np.arange(2, n + 3)) - 1)

    @_memo
    def above(self, n):
        "tjj_above's eigen-rates and their masks (JJ, J, 1)."
        l1n = nC2(np.arange(2, n + 3)).astype(np.float64)[:, None, None]
        rn = nC2(np.arange(2, n + 2)).astype(np.float64)[None, :, None]
        rp = l1n - rn
        return _NS(
            l1=self._f(l1n), r=self._f(rn), eq=self._i(l1n == rn),
            denom=self._f(np.where(l1n - rn == 0, 1.0, l1n - rn)),
            abs_lr=self._f(np.where(l1n == rn, 1.0, np.abs(l1n - rn))),
            lt=self._i(rn < l1n), rp_pos=self._i(rp > 0),
            rp_zero=self._i(rp == 0),
            single=self._rates(nC2(np.arange(2, n + 2))),
        )

    @_memo
    def moran(self, n):
        mc = exact.cached_matrices(n)
        return _NS(**{k: self._f(getattr(mc, k))
                      for k in ("M0", "M1", "X0", "X2", "Uinv0", "Uinv2")})

    @_memo
    def first(self, shape):
        "A mask of ``shape`` true at [0, 0] alone (incorporate_theta)."
        m = np.zeros(shape, dtype=bool)
        m[0, 0] = True
        return self._i(m)

    # -- the emission index and the spline ------------------------------------
    def emission(self, idx):
        "W, the key kinds (n_keys, 1) and the dinucleotide parities."
        key = ("emission", id(idx))
        if key not in self._memo:
            self._memo[key] = (idx, _NS(
                W=self._f(idx.W),
                parity=torch.as_tensor(idx.parity, device=self.device,
                                       dtype=torch.long),
                kind=self._i(idx.kind)[:, None]))
        return self._memo[key][1]

    def spline(self, model):
        "The model's spline constants at its piece ends (SMCModel)."
        key = ("spline", id(model))
        if key not in self._memo:
            self._memo[key] = (model, device_arrays(
                model.spline_constants(), self.dtype, self.device))
        return self._memo[key][1]
