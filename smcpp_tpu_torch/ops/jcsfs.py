"""Joint CSFS for two populations with a clean split.

Port of smcpp_tpu/ops/jcsfs.py: host-side float64, NumPy for the matrix
algebra, with the one-population CSFS and the below integrals from the
port's torch functions evaluated on CPU float64 tensors.  Matrix-algebra
form of the reference's JCSFS (SMC++ src/jcsfs.cpp, documented twin
smcpp/jcsfs.py).  The
split workflow optimizes only the scalar split time by bounded search
(TwoPopulationOptimizer has no coordinates), so this path needs no autodiff;
the quadruple loops of the reference collapse to matmul chains
  ret[i] = Mn1[i]^T @ G_i @ Mn2,   G_i[np1, np2] = hyp * sfs[np1 + np2].
"""

import logging
from functools import lru_cache

import numpy as np
import torch
from scipy.stats import hypergeom

from . import csfs as csfs_mod
from . import exact, ratefunc
from . import grid as grid_mod
from .ratefunc import HostRateFunction

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# raw-parameter utilities (reference src/common.cpp:62-96)
# ---------------------------------------------------------------------------

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
    ap = a[ip:].copy()
    return ap, sp


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
    sp = np.append(sp, 1.0)
    ap = np.append(ap, 1e-8)
    return ap, sp


def csfs_raw(a, s, hidden_states, n):
    """One-pop CSFS for raw (a, s) params: (M, 3, n+1) NumPy array."""
    g = grid_mod.make_time_grid(s, np.asarray(hidden_states, dtype=np.float64))
    with torch.no_grad():
        out = csfs_mod.conditioned_sfs(_f64(a), g, n)
    return out.numpy()


def _f64(a):
    "A CPU float64 tensor of the per-piece sizes ``a``."
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def undistinguished_sfs(csfs):
    "(3, n+1) CSFS -> (n+1,) marginal over total derived count 1..n+1."
    n = csfs.shape[1] - 1
    ret = np.zeros(n + 1)
    for a_ in range(3):
        for b in range(n + 1):
            k = a_ + b
            if 1 <= k < n + 2:
                ret[k - 1] += csfs[a_, b]
    return ret


# ---------------------------------------------------------------------------
# float Moran eigensystems (reference smcpp/moran_eigensystem.py and the
# jcsfs_eigensystem struct, include/jcsfs.h:39-60)
# ---------------------------------------------------------------------------

def moran_rate_matrix(N):
    ret = np.zeros([N + 1, N + 1])
    k = np.arange(N)
    ret[np.arange(N), np.arange(1, N + 1)] = 0.5 * k * (N - k)
    k = np.arange(1, N + 1)
    ret[np.arange(1, N + 1), np.arange(N)] = 0.5 * k * (N - k)
    np.fill_diagonal(ret, -ret.sum(axis=1))
    return ret


def modified_moran_rate_matrix(N, a, na):
    ret = np.zeros([N + 1, N + 1])
    k = np.arange(N)
    ret[np.arange(N), np.arange(1, N + 1)] = a * (N - k) + 0.5 * k * (N - k)
    k = np.arange(1, N + 1)
    ret[np.arange(1, N + 1), np.arange(N)] = (na - a) * k + 0.5 * k * (N - k)
    np.fill_diagonal(ret, 0)
    np.fill_diagonal(ret, -ret.sum(axis=1))
    return ret


class MoranExpm:
    "exp(M t) via the (real-cast) eigendecomposition, as the reference does."

    def __init__(self, M):
        D, U = np.linalg.eig(M)
        self.U = U.real
        self.Uinv = np.linalg.inv(U).real
        self.D = D.real

    def expm(self, t):
        return (self.U * np.exp(self.D * float(t))[None, :]) @ self.Uinv


@lru_cache(maxsize=None)
def _moran(N):
    return MoranExpm(moran_rate_matrix(N))


@lru_cache(maxsize=None)
def _modified(N, a, na):
    return MoranExpm(modified_moran_rate_matrix(N, a, na))


def _conditional_coal_quadrature(a, s, t1, t2, K):
    """Gauss-Legendre nodes/weights for E[f(T) | T in (t1, t2)] under the
    coalescent of (a, s).

    The conditional density of U = exp(-R(T)) is uniform on
    (exp(-R(t2)), exp(-R(t1))), so the conditional expectation is a plain
    unit-interval integral of the smooth map u -> f(Rinv(-log u)) — a
    K-node Gauss-Legendre rule converges spectrally, replacing the
    reference's Monte-Carlo time draws (jcsfs.cpp:117-135) with a
    deterministic transport.  Returns (ts, weights), sum(weights) == 1."""
    eta = HostRateFunction(a, s)
    hi = np.exp(-eta.R(t1))
    lo = 0.0 if np.isinf(t2) else np.exp(-eta.R(t2))
    u, w = np.polynomial.legendre.leggauss(K)
    u = 0.5 * (u + 1.0)  # open nodes in (0, 1): endpoints never evaluated
    x = -np.log(lo + u * (hi - lo))
    return np.atleast_1d(eta.Rinv(x)), 0.5 * w


class JointCSFS:
    """Emission tensor J[m] of shape (a1+1, (n1+1)(a2+1)(n2+1)) per hidden
    interval, for a clean-split two-population model."""

    def __init__(self, n1, n2, a1, a2, hidden_states, K=10, seed=1):
        assert a1 + a2 == 2 and a1 in (1, 2) and a2 in (0, 1)
        self.n1, self.n2, self.a1, self.a2 = n1, n2, a1, a2
        self.hs = np.asarray(hidden_states, dtype=np.float64)
        self.M = len(self.hs) - 1
        self.K = K  # quadrature nodes for the conditional-time transports
        del seed  # retained for API compatibility; quadrature needs no RNG
        self.S2 = np.arange(n1 + 2) / (n1 + 1.0)
        self.S0 = 1.0 - self.S2
        self.Sn1 = np.arange(1, n1 + 2) / (n1 + 2.0)
        # hypergeometric sampling kernels
        self.hyp1 = np.zeros((n1 + 1, n1 + n2 + 1))
        for nseg in range(n1 + n2 + 1):
            for np1 in range(max(nseg - n2, 0), min(nseg, n1) + 1):
                self.hyp1[np1, nseg] = hypergeom.pmf(np1, n1 + n2, nseg, n1)
        self.hyp2 = np.zeros((n1 + 2, n1 + n2))
        for nseg in range(1, n1 + n2 + 1):
            for np1 in range(max(nseg - n2, 0), min(nseg, n1 + 1) + 1):
                self.hyp2[np1, nseg - 1] = hypergeom.pmf(
                    np1, n1 + n2 + 1, nseg, n1 + 1
                )

    @property
    def shape(self):
        return (
            self.M,
            self.a1 + 1,
            (self.n1 + 1) * (self.a2 + 1) * (self.n2 + 1),
        )

    def _j_view(self, J, m):
        "Reshape row block m to (a1+1, n1+1, a2+1, n2+1)."
        return J[m].reshape(
            self.a1 + 1, self.n1 + 1, self.a2 + 1, self.n2 + 1
        )

    def compute(self, params1, params2, split):
        """params1/params2: (a, s) stepwise values of the marginal models.

        Returns (M, a1+1, (n1+1)(a2+1)(n2+1)) emission branch lengths.
        """
        if self.a1 == 2:
            J = self._compute_together(params1, params2, split)
        else:
            J = self._compute_apart(params1, params2, split)
        # floors + zero out nonsegregating corners (jcsfs.cpp:218-244)
        J = np.maximum(J, 1e-20)
        for m in range(self.M):
            v = self._j_view(J, m)
            v[0, 0, 0, 0] = 0.0
            v[self.a1, self.n1, self.a2, self.n2] = 0.0
        return J

    # ------------------------------------------------------------------
    def _compute_together(self, params1, params2, split):
        n1, n2 = self.n1, self.n2
        a1p, s1p = params1
        a2p, s2p = params2
        eta1 = HostRateFunction(a1p, s1p)
        eta2 = HostRateFunction(a2p, s2p)
        Rts1 = eta1.R(split)
        Rts2 = eta2.R(split)
        eMn1 = [
            _modified(n1, 0, 2).expm(Rts1),
            _modified(n1, 1, 2).expm(Rts1),
        ]
        eMn1.append(eMn1[0][::-1, ::-1])
        eMn2 = _moran(n2).expm(Rts2)

        J = np.zeros(self.shape)
        for m in range(self.M):
            t1, t2 = self.hs[m], self.hs[m + 1]
            v = self._j_view(J, m)
            if t2 <= split:
                self._tau_below(v, params1, split, t1, t2, 1.0, Rts1, eMn2)
            elif t1 >= split:
                self._tau_above(
                    v, params1, split, t1, t2, 1.0, eMn1, eMn2
                )
            else:
                eR1t1 = np.exp(-eta1.R(t1))
                eR1t2 = 0.0 if np.isinf(t2) else np.exp(-eta1.R(t2))
                w = (np.exp(-Rts1) - eR1t2) / (eR1t1 - eR1t2)
                self._tau_below(
                    v, params1, split, t1, split, 1.0 - w, Rts1, eMn2
                )
                self._tau_above(
                    v, params1, split, split, t2, w, eMn1, eMn2
                )
            # pop 2, below split (jcsfs.cpp:403-418)
            if n2 == 1:
                v[0, 0, 0, 1] += split
            elif n2 > 1:
                at, st = truncate_params(a2p, s2p, split)
                rsfs2 = undistinguished_sfs(
                    csfs_raw(at, st, [0.0, np.inf], n2 - 2)[0]
                )[: n2 - 1]
                v[0, 0, 0, 1:n2] += rsfs2
                Sn2 = np.arange(1, n2) / n2
                v[0, 0, 0, n2] += split - Sn2 @ rsfs2
        return J

    def _tau_below(self, v, params1, split, t1, t2, weight, Rts1, eMn2):
        "jcsfs.cpp:89-164: distinguished pair coalesces below the split."
        n1, n2, K = self.n1, self.n2, self.K
        a1p, s1p = params1
        at, st = truncate_params(a1p, s1p, split)
        trunc_csfs = csfs_raw(at, st, [t1, t2], n1)[0]
        v[:, :, 0, 0] += weight * np.maximum(trunc_csfs, 0.0)
        trunc_sfs = undistinguished_sfs(trunc_csfs)
        Et = self.Sn1 @ trunc_sfs
        v[2, n1, 0, 0] += weight * (split - Et) - weight * np.maximum(
            trunc_csfs[2, n1], 0.0
        )
        # note: the reference *assigns* (split - Et) to the (2, n1) cell
        # rather than adding, overwriting the truncated-CSFS value; the
        # correction term above reproduces that.

        # above the split: SFS on n1+n2+1 lineages, Moran'd down
        ash, ssh = shift_params(a1p, s1p, split)
        sfs_above = undistinguished_sfs(
            csfs_raw(ash, ssh, [0.0, np.inf], n1 + n2 - 1)[0]
        )  # (n1+n2,)
        # quadrature-averaged transports over the conditional coalescence
        # time (deterministic; the reference draws Monte-Carlo times here,
        # jcsfs.cpp:117-135)
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
            B = Mn10.expm(Rt)
            C = Mn12.expm(Rt)
            eMn10_avg += wq * ((A * self.S0[None, :])[:, :-1] @ B)
            eMn12_avg += wq * ((A * self.S2[None, :])[:, 1:] @ C)
        # G[np1, np2] = hyp2[np1, nseg-1] * sfs_above[nseg-1], nseg = np1+np2
        G = np.zeros((n1 + 2, n2 + 1))
        for np1 in range(n1 + 2):
            for np2 in range(n2 + 1):
                nseg = np1 + np2
                if 1 <= nseg <= n1 + n2:
                    G[np1, np2] = self.hyp2[np1, nseg - 1] * sfs_above[nseg - 1]
        v[0, :, 0, :] += weight * (eMn10_avg.T @ G @ eMn2)
        v[2, :, 0, :] += weight * (eMn12_avg.T @ G @ eMn2)

    def _tau_above(self, v, params1, split, t1, t2, weight, eMn1, eMn2):
        "jcsfs.cpp:166-216: distinguished pair coalesces above the split."
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
        # pop 1, below split: CSFS conditioned on coalescence ~at the split
        sfs_below = self._below_at_split(a1p, s1p, split)
        v[:, :, 0, 0] += weight * np.maximum(sfs_below, 0.0)

    def _below_at_split(self, a1p, s1p, split):
        "compute_below for coalescence in (split - eps, split + eps)."
        g = grid_mod.make_time_grid(
            np.asarray(s1p, dtype=np.float64),
            np.array([split - 1e-6, split + 1e-6]),
        )
        mc = exact.cached_matrices(self.n1)
        with torch.no_grad():
            tb = ratefunc.tjj_below(_f64(a1p), g, self.n1).numpy()
        out = np.zeros((3, self.n1 + 1))
        out[0, 1:] = tb[0] @ mc.M0
        out[1, :] = tb[0] @ mc.M1
        return out

    # ------------------------------------------------------------------
    def _compute_apart(self, params1, params2, split):
        "jcsfs.cpp:257-367: distinguished lineages in different populations."
        n1, n2 = self.n1, self.n2
        a1p, s1p = params1
        a2p, s2p = params2
        J = np.zeros(self.shape)
        # shifted CSFS hidden states: only intervals above the split matter
        times = [0.0]
        for m in range(1, self.M):
            if self.hs[m] > split:
                times.append(self.hs[m] - split)
        times.append(np.inf)
        ash, ssh = shift_params(a1p, s1p, split)
        csfs_at_split = csfs_raw(ash, ssh, times, n1 + n2)
        Rts1 = HostRateFunction(a1p, s1p).R(split)
        Rts2 = HostRateFunction(a2p, s2p).R(split)
        T10 = _modified(n1, 0, 1).expm(Rts1)
        T11 = _modified(n1, 1, 1).expm(Rts1)
        T20 = _modified(n2, 0, 1).expm(Rts2)
        T21 = _modified(n2, 1, 1).expm(Rts2)
        i = 0
        for m in range(self.M):
            t2 = self.hs[m + 1]
            if t2 <= split:
                continue  # the distinguished pair cannot coalesce below
            cs = csfs_at_split[i]
            i += 1
            v = self._j_view(J, m)
            for row, (Ma, Mb, fac) in {
                (1, 1): (T11, T21, 1.0),
                (1, 0): (T11, T20, 0.5),
                (0, 1): (T10, T21, 0.5),
                (0, 0): (T10, T20, 1.0),
            }.items():
                csrow = {(1, 1): 2, (1, 0): 1, (0, 1): 1, (0, 0): 0}[row]
                G = np.zeros((n1 + 1, n2 + 1))
                for np1 in range(n1 + 1):
                    for np2 in range(n2 + 1):
                        G[np1, np2] = (
                            self.hyp1[np1, np1 + np2] * cs[csrow, np1 + np2]
                        )
                v[row[0], :, row[1], :] += fac * (Ma.T @ G @ Mb)
        if split == 0.0:
            return J
        # truncated below-split SFS per population (same for every m)
        for first, (ap, sp, ni) in enumerate([(a1p, s1p, n1), (a2p, s2p, n2)]):
            is_pop1 = first == 0
            at, st = truncate_params(ap, sp, split)
            if ni > 0:
                rsfs = undistinguished_sfs(
                    csfs_raw(at, st, [0.0, np.inf], ni - 1)[0]
                )[:ni]
            else:
                rsfs = np.zeros(0)
            for m in range(self.M):
                v = self._j_view(J, m)
                for k in range(1, ni + 1):
                    fac = k / (ni + 1.0)
                    x1 = (1.0 - fac) * rsfs[k - 1]
                    x2 = fac * rsfs[k - 1]
                    if is_pop1:
                        v[0, k, 0, 0] += x1
                        v[1, k - 1, 0, 0] += x2
                    else:
                        v[0, 0, 0, k] += x1
                        v[0, 0, 1, k - 1] += x2
                remain = 0.0
                if ni > 0:
                    remain = np.arange(1, ni + 1) @ rsfs / (ni + 1.0)
                if is_pop1:
                    v[1, ni, 0, 0] += split - remain
                else:
                    v[0, 0, 1, ni] += split - remain
        return J
