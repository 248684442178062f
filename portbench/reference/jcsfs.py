"""Frozen copy of smcpp_tpu_torch/ops/jcsfs.py, the plain PyTorch and NumPy
code the benchmark's reference recomputes the port's two-population set-up
with.  Later changes to the port do not reach it.  Of its two cases only
the distinguished pair together in population 1 (a1 = 2, a2 = 0), the
configurations' layout, is kept.  The Moran rate matrices are the bands of
the reference's own ``exact._modified_moran_rate_matrix`` (exact halves, so
the same float matrices as the port's), decomposed as the port does.

This is the eager host route: population 1 below the split, for a pair that
coalesces above it, takes the CSFS of a two-sided interval of 1e-6 about the
split (``_below_at_split``).  The port's ``tensors()`` takes the traced route
(smcpp_tpu_torch/ops/jcsfs_traced.py), which takes the exact eps -> 0 limit
there; the two routes' E differ by up to about 1e-6, relative (ROADMAP.md,
"Recorded divergences"), far inside the limits of the cells' check.  The
original docstring follows.

Joint CSFS for two populations with a clean split.

Port of smcpp_tpu/ops/jcsfs.py: host-side float64, NumPy for the matrix
algebra, with the one-population CSFS and the below integrals from the
port's torch functions evaluated on CPU float64 tensors.  Matrix-algebra
form of the reference's JCSFS (SMC++ src/jcsfs.cpp, documented twin
smcpp/jcsfs.py).  The quadruple loops of the reference collapse to matmul
chains
  ret[i] = Mn1[i]^T @ G_i @ Mn2,   G_i[np1, np2] = hyp * sfs[np1 + np2].
"""

from functools import lru_cache

import numpy as np
import torch
from scipy.stats import hypergeom

from . import csfs as csfs_mod
from . import exact, ratefunc
from . import grid as grid_mod
from .ratefunc import HostRateFunction


def shift_params(a, s, shift):
    "Shift the model back ``shift`` units in time."
    a = np.asarray(a, dtype=np.float64)
    s = np.asarray(s, dtype=np.float64)
    cs = np.concatenate([[0.0], np.cumsum(s)])
    cs[-1] = np.inf
    ip = int(np.searchsorted(cs, shift, side="right")) - 1
    sp = s[ip:].copy()
    sp[0] = cs[ip + 1] - shift
    sp[-1] = 1.0
    return a[ip:].copy(), sp


def truncate_params(a, s, trunc):
    "Truncate the model at time ``trunc`` (population crash afterwards)."
    a = np.asarray(a, dtype=np.float64)
    s = np.asarray(s, dtype=np.float64)
    cs = np.concatenate([[0.0], np.cumsum(s)])
    cs[-1] = np.inf
    ip = int(np.searchsorted(cs, trunc, side="right")) - 1
    sp = s[: ip + 1].copy()
    sp[ip] = trunc - cs[ip]
    ap = a[: ip + 1].copy()
    return np.append(ap, 1e-8), np.append(sp, 1.0)


def _f64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def csfs_raw(a, s, hidden_states, n):
    "One-population CSFS of raw (a, s) parameters: (M, 3, n + 1)."
    g = grid_mod.make_time_grid(s, np.asarray(hidden_states, dtype=np.float64))
    with torch.no_grad():
        return csfs_mod.conditioned_sfs(_f64(a), g, n).numpy()


def undistinguished_sfs(csfs):
    "(3, n + 1) CSFS -> (n + 1,) marginal over total derived count 1..n + 1."
    n = csfs.shape[1] - 1
    ret = np.zeros(n + 1)
    for a_ in range(3):
        for b in range(n + 1):
            k = a_ + b
            if 1 <= k < n + 2:
                ret[k - 1] += csfs[a_, b]
    return ret


def rate_matrix(N, a, na):
    """The Moran rate matrix of N lineages, ``a`` of ``na`` distinguished
    ones derived (a = na = 0: the plain Moran model), as floats from the
    exact bands of ``exact._modified_moran_rate_matrix``."""
    sub, dia, sup = exact._modified_moran_rate_matrix(N, a, na)
    ret = np.diag([float(x) for x in dia])
    ret[np.arange(1, N + 1), np.arange(N)] = [float(x) for x in sub[1:]]
    ret[np.arange(N), np.arange(1, N + 1)] = [float(x) for x in sup[:-1]]
    return ret


class MoranExpm:
    "exp(M t) through the (real-cast) eigendecomposition, as the port does."

    def __init__(self, M):
        D, U = np.linalg.eig(M)
        self.U = U.real
        self.Uinv = np.linalg.inv(U).real
        self.D = D.real

    def expm(self, t):
        return (self.U * np.exp(self.D * float(t))[None, :]) @ self.Uinv


@lru_cache(maxsize=None)
def _moran(N):
    return MoranExpm(rate_matrix(N, 0, 0))


@lru_cache(maxsize=None)
def _modified(N, a, na):
    return MoranExpm(rate_matrix(N, a, na))


def _conditional_coal_quadrature(a, s, t1, t2, K):
    """Gauss-Legendre nodes and weights for E[f(T) | T in (t1, t2)] under
    the coalescent of (a, s), through U = exp(-R(T)), uniform on its
    interval: (ts, weights), the weights summing to 1."""
    eta = HostRateFunction(a, s)
    hi = np.exp(-eta.R(t1))
    lo = 0.0 if np.isinf(t2) else np.exp(-eta.R(t2))
    u, w = np.polynomial.legendre.leggauss(K)
    u = 0.5 * (u + 1.0)
    x = -np.log(lo + u * (hi - lo))
    return np.atleast_1d(eta.Rinv(x)), 0.5 * w


class JointCSFS:
    """Emission branch lengths J[m] of shape (3, (n1 + 1)(n2 + 1)) for each
    hidden interval m, the distinguished pair in population 1."""

    def __init__(self, n1, n2, hidden_states, K=10):
        self.n1, self.n2 = n1, n2
        self.hs = np.asarray(hidden_states, dtype=np.float64)
        self.M = len(self.hs) - 1
        self.K = K
        self.S2 = np.arange(n1 + 2) / (n1 + 1.0)
        self.S0 = 1.0 - self.S2
        self.Sn1 = np.arange(1, n1 + 2) / (n1 + 2.0)
        self.hyp1 = np.zeros((n1 + 1, n1 + n2 + 1))
        for nseg in range(n1 + n2 + 1):
            for np1 in range(max(nseg - n2, 0), min(nseg, n1) + 1):
                self.hyp1[np1, nseg] = hypergeom.pmf(np1, n1 + n2, nseg, n1)
        self.hyp2 = np.zeros((n1 + 2, n1 + n2))
        for nseg in range(1, n1 + n2 + 1):
            for np1 in range(max(nseg - n2, 0), min(nseg, n1 + 1) + 1):
                self.hyp2[np1, nseg - 1] = hypergeom.pmf(np1, n1 + n2 + 1, nseg, n1 + 1)

    @property
    def shape(self):
        return (self.M, 3, (self.n1 + 1) * (self.n2 + 1))

    def _j_view(self, J, m):
        "Row block m as (a1 + 1, n1 + 1, a2 + 1, n2 + 1)."
        return J[m].reshape(3, self.n1 + 1, 1, self.n2 + 1)

    def compute(self, params1, params2, split):
        """params1, params2: the marginals' (a, s) stepwise values (population
        2's the splice of ``tensors2.SplitModel.pop2``).  Returns (M, 3,
        (n1 + 1)(n2 + 1)) branch lengths, floored at 1e-20, the
        nonsegregating corners 0 (jcsfs.cpp:218-244)."""
        J = np.maximum(self._compute_together(params1, params2, split), 1e-20)
        for m in range(self.M):
            v = self._j_view(J, m)
            v[0, 0, 0, 0] = 0.0
            v[2, self.n1, 0, self.n2] = 0.0
        return J

    def _compute_together(self, params1, params2, split):
        n1, n2 = self.n1, self.n2
        a1p, s1p = params1
        a2p, s2p = params2
        eta1 = HostRateFunction(a1p, s1p)
        Rts1 = eta1.R(split)
        Rts2 = HostRateFunction(a2p, s2p).R(split)
        eMn1 = [_modified(n1, 0, 2).expm(Rts1), _modified(n1, 1, 2).expm(Rts1)]
        eMn1.append(eMn1[0][::-1, ::-1])
        eMn2 = _moran(n2).expm(Rts2)
        J = np.zeros(self.shape)
        for m in range(self.M):
            t1, t2 = self.hs[m], self.hs[m + 1]
            v = self._j_view(J, m)
            if t2 <= split:
                self._tau_below(v, params1, split, t1, t2, 1.0, Rts1, eMn2)
            elif t1 >= split:
                self._tau_above(v, params1, split, t1, t2, 1.0, eMn1, eMn2)
            else:
                eR1t1 = np.exp(-eta1.R(t1))
                eR1t2 = 0.0 if np.isinf(t2) else np.exp(-eta1.R(t2))
                w = (np.exp(-Rts1) - eR1t2) / (eR1t1 - eR1t2)
                self._tau_below(v, params1, split, t1, split, 1.0 - w, Rts1, eMn2)
                self._tau_above(v, params1, split, split, t2, w, eMn1, eMn2)
            # population 2 below the split (jcsfs.cpp:403-418)
            if n2 == 1:
                v[0, 0, 0, 1] += split
            elif n2 > 1:
                at, st = truncate_params(a2p, s2p, split)
                rsfs2 = undistinguished_sfs(csfs_raw(at, st, [0.0, np.inf], n2 - 2)[0])[: n2 - 1]
                v[0, 0, 0, 1:n2] += rsfs2
                v[0, 0, 0, n2] += split - (np.arange(1, n2) / n2) @ rsfs2
        return J

    def _tau_below(self, v, params1, split, t1, t2, weight, Rts1, eMn2):
        "jcsfs.cpp:89-164: the distinguished pair coalesces below the split."
        n1, n2, K = self.n1, self.n2, self.K
        a1p, s1p = params1
        at, st = truncate_params(a1p, s1p, split)
        trunc_csfs = csfs_raw(at, st, [t1, t2], n1)[0]
        v[:, :, 0, 0] += weight * np.maximum(trunc_csfs, 0.0)
        Et = self.Sn1 @ undistinguished_sfs(trunc_csfs)
        # the reference assigns (split - Et) to the (2, n1) cell in place of
        # the truncated CSFS's value; the second term undoes that value
        v[2, n1, 0, 0] += weight * (split - Et) - weight * np.maximum(trunc_csfs[2, n1], 0.0)
        ash, ssh = shift_params(a1p, s1p, split)
        sfs_above = undistinguished_sfs(csfs_raw(ash, ssh, [0.0, np.inf], n1 + n2 - 1)[0])
        Mn1p1 = _moran(n1 + 1)
        Mn10 = _modified(n1, 0, 2)
        Mn12 = _modified(n1, 2, 2)
        eMn10_avg = np.zeros((n1 + 2, n1 + 1))
        eMn12_avg = np.zeros_like(eMn10_avg)
        ts, ws = _conditional_coal_quadrature(a1p, s1p, t1, t2, K)
        eta1 = HostRateFunction(a1p, s1p)
        for t, wq in zip(ts, ws):
            Rt = eta1.R(t)
            A = Mn1p1.expm(Rts1 - Rt)
            eMn10_avg += wq * ((A * self.S0[None, :])[:, :-1] @ Mn10.expm(Rt))
            eMn12_avg += wq * ((A * self.S2[None, :])[:, 1:] @ Mn12.expm(Rt))
        G = np.zeros((n1 + 2, n2 + 1))
        for np1 in range(n1 + 2):
            for np2 in range(n2 + 1):
                nseg = np1 + np2
                if 1 <= nseg <= n1 + n2:
                    G[np1, np2] = self.hyp2[np1, nseg - 1] * sfs_above[nseg - 1]
        v[0, :, 0, :] += weight * (eMn10_avg.T @ G @ eMn2)
        v[2, :, 0, :] += weight * (eMn12_avg.T @ G @ eMn2)

    def _tau_above(self, v, params1, split, t1, t2, weight, eMn1, eMn2):
        "jcsfs.cpp:166-216: the distinguished pair coalesces above the split."
        n1, n2 = self.n1, self.n2
        a1p, s1p = params1
        ash, ssh = shift_params(a1p, s1p, split)
        rsfs = csfs_raw(ash, ssh, [t1 - split, t2 - split], n1 + n2)[0]
        for i in range(3):
            G = np.zeros((n1 + 1, n2 + 1))
            for np1 in range(n1 + 1):
                for np2 in range(n2 + 1):
                    G[np1, np2] = self.hyp1[np1, np1 + np2] * rsfs[i, np1 + np2]
            v[i, :, 0, :] += weight * (eMn1[i].T @ G @ eMn2)
        v[:, :, 0, 0] += weight * np.maximum(self._below_at_split(a1p, s1p, split), 0.0)

    def _below_at_split(self, a1p, s1p, split):
        "compute_below for coalescence in (split - 1e-6, split + 1e-6)."
        g = grid_mod.make_time_grid(np.asarray(s1p, dtype=np.float64),
                                    np.array([split - 1e-6, split + 1e-6]))
        mc = exact.cached_matrices(self.n1)
        with torch.no_grad():
            tb = ratefunc.tjj_below(_f64(a1p), g, self.n1).numpy()
        out = np.zeros((3, self.n1 + 1))
        out[0, 1:] = tb[0] @ mc.M0
        out[1, :] = tb[0] @ mc.M1
        return out
