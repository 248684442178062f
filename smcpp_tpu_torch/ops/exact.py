"""Exact rational Moran eigensystem and combinatorial matrix cache (host side).

These quantities depend only on the sample size ``n`` — never on model
parameters — so they are computed once per ``n`` in exact rational arithmetic
(Python ``fractions.Fraction`` replaces the reference's GMP ``mpq_class``),
converted to float64 and cached on disk.  Reference:
SMC++ src/moran_eigensystem.cpp and SMC++ src/matrix_cache.cpp.
"""

import os
from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache
from math import comb

import numpy as np

from ..paths import BUILD_DIR

F0 = Fraction(0)
F1 = Fraction(1)


def _modified_moran_rate_matrix(N, a, na):
    """Tridiagonal rate matrix of the Moran model with ``a`` of ``na``
    distinguished lineages carrying the derived allele, as (sub, diag, sup)
    bands of Fractions.  Reference: moran_eigensystem.cpp:31-52."""
    sub = [F0] * (N + 1)  # sub[i] = M[i, i-1]
    sup = [F0] * (N + 1)  # sup[i] = M[i, i+1]
    dia = [F0] * (N + 1)
    for i in range(N + 1):
        sm = F0
        if i > 0:
            b = (na - a) * i + Fraction(i * (N - i), 2)
            sub[i] = b
            sm += b
        if i < N:
            b = a * (N - i) + Fraction(i * (N - i), 2)
            sup[i] = b
            sm += b
        dia[i] = -sm
    return sub, dia, sup


def _solve_tridiag_null(sub, dia, sup, shift, lo=0):
    """Back-substitution solve for the null vector of (M - shift*I) restricted
    to rows/cols [lo, N]: ret[N] = 1, ret[i] = (row i+1 . ret) / -M[i+1, i].

    Reference: moran_eigensystem.cpp:54-64 (rows of a tridiagonal matrix).
    """
    N = len(dia) - 1
    ret = [F0] * (N + 1)
    ret[N] = F1
    for i in range(N - 1, lo - 1, -1):
        # row i+1 of (M - shift I): sub[i+1] at col i, dia[i+1]-shift at i+1,
        # sup[i+1] at col i+2
        acc = (dia[i + 1] - shift) * ret[i + 1]
        if i + 2 <= N:
            acc += sup[i + 1] * ret[i + 2]
        # note ret[i] is the unknown multiplying sub[i+1]
        ret[i] = acc / -(sub[i + 1])
    return ret


@dataclass(frozen=True)
class MoranEigensystem:
    "Exact eigendecomposition of the (0,2)-modified Moran rate matrix, size n."
    U: np.ndarray  # (n+1, n+1) float64
    Uinv: np.ndarray  # (n+1, n+1) float64
    D: np.ndarray  # (n+1,) eigenvalues -(k(k-1)/2 - 1), k = 2..n+2


@lru_cache(maxsize=2)
def _moran_eigensystem_exact(n: int):
    """Exact eigenvectors for the known eigenvalues -(k(k-1)/2 - 1), as
    rational (Fraction) row lists plus the float eigenvalue vector.

    Reference: moran_eigensystem.cpp:67-96.  The transpose solve for Uinv
    swaps the sub/sup bands; the first column of Uinv is completed from the
    first row equation of (M^T - rate I).
    """
    sub, dia, sup = _modified_moran_rate_matrix(n, 0, 2)
    # transpose bands: Mt[i, i-1] = M[i-1, i] = sup[i-1]; Mt[i, i+1] = sub[i+1]
    subT = [F0] + [sup[i - 1] for i in range(1, n + 1)]
    supT = [sub[i + 1] for i in range(n)] + [F0]

    U = [[F0] * (n + 1) for _ in range(n + 1)]
    Uinv = [[F0] * (n + 1) for _ in range(n + 1)]
    D = np.zeros(n + 1)
    Uinv[0][0] = F1
    for k in range(2, n + 3):
        rate = Fraction(-(k * (k - 1) // 2 - 1))
        D[k - 2] = float(rate)
        col = _solve_tridiag_null(sub, dia, sup, rate)
        for i in range(n + 1):
            U[i][k - 2] = col[i]
        if k > 2:
            row = _solve_tridiag_null(subT, dia, supT, rate, lo=1)
            # first entry from row 0 of (Mt - rate I): ret(k-2,0) =
            # -Uinv(k-2,1) * A(0,1) / A(0,0)
            a01 = supT[0]
            a00 = dia[0] - rate
            row[0] = -row[1] * a01 / a00
            Uinv[k - 2] = row

    # normalize: U <- U * diag(1 / diag(Uinv @ U))
    for k in range(n + 1):
        d = sum(Uinv[k][i] * U[i][k] for i in range(n + 1))
        inv = F1 / d
        for i in range(n + 1):
            U[i][k] *= inv
    return U, Uinv, D


@lru_cache(maxsize=None)
def moran_eigensystem(n: int) -> MoranEigensystem:
    U, Uinv, D = _moran_eigensystem_exact(n)
    return MoranEigensystem(
        U=_frac_array(U, np.float64), Uinv=_frac_array(Uinv, np.float64), D=D
    )


@lru_cache(maxsize=None)
def stable_eigensystem(n: int) -> MoranEigensystem:
    """Numerically stable eigensystem of the irreducible Moran block.

    The (0,2)-modified Moran generator has block structure Q = [[0, 0],
    [c, T]]: state 0 is absorbing (sup[0] = a*(N-0) = 0), and the block T
    over states 1..n is a birth-death tridiagonal with positive sub/sup
    bands.  Such a T is symmetrizable — S = D T D^{-1} is symmetric for
    the diagonal D with (d_{i+1}/d_i)^2 = sup_i / sub_{i+1} — so its
    eigenbasis can be computed as an ORTHONORMAL basis V of S via LAPACK
    (scipy.linalg.eigh_tridiagonal) and mapped back: right eigenvectors
    U = D^{-1} V, left eigenvectors Uinv = V^T D, automatically
    biorthonormal (Uinv @ U = I).  D is polynomially bounded in n
    (measured cond ~1.7e4 at n=200), so unlike the exact rational
    normalization — whose Uinv grows to ~1e44 by n=150 and destroys the
    f64 CSFS contraction past n~60, the same wall the reference fights
    with sorted compensated summation (conditioned_sfs.cpp:41-83) — both
    factors here stay O(n): the spectral CSFS contraction is accurate to
    ~1e-13 at n=200 (tests/test_csfs.py::test_csfs_large_n_envelope).

    Returns U, Uinv of shape (n, n) over states 1..n and eigenvalues
    D[k-3] = -(k(k-1)/2 - 1) for k = 3..n+2 (the lambda = 0 eigenpair of
    the absorbing state never contributes to columns >= 1 and is dropped).
    """
    import scipy.linalg

    if n == 0:
        z = np.zeros((0, 0))
        return MoranEigensystem(U=z, Uinv=z, D=np.zeros(0))
    sub, dia, sup = _modified_moran_rate_matrix(n, 0, 2)
    d = np.array([float(dia[i]) for i in range(1, n + 1)])
    e_sup = np.array([float(sup[i]) for i in range(1, n)])  # T[i, i+1]
    e_sub = np.array([float(sub[i]) for i in range(2, n + 1)])  # T[i+1, i]
    logr = 0.5 * (np.log(e_sup) - np.log(e_sub))
    logd = np.concatenate([[0.0], np.cumsum(logr)])
    logd -= logd.mean()  # scale-free: center to keep delta near 1
    delta = np.exp(logd)
    if n == 1:
        w, V = d.copy(), np.ones((1, 1))
    else:
        w, V = scipy.linalg.eigh_tridiagonal(d, np.sqrt(e_sup * e_sub))
    # ascending w -> reorder to k = 3..n+2 (lambda descending: -2, -5, ...)
    w = w[::-1]
    V = V[:, ::-1]
    return MoranEigensystem(
        U=V / delta[:, None], Uinv=(V * delta[:, None]).T, D=w
    )


# ---------------------------------------------------------------------------
# Combinatorial matrices (Polanski-Kimmel weights, lineage-size pmfs,
# below-coefficients recurrence).  Reference: matrix_cache.cpp:112-282.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _Wnbj(n: int, b: int, j: int) -> Fraction:
    "Polanski-Kimmel weights W_{n,b,j} (matrix_cache.cpp:148-171)."
    if j == 2:
        return Fraction(6, n + 1)
    if j == 3:
        if n == 2 * b:
            return F0
        return Fraction(30 * (n - 2 * b), (n + 1) * (n + 2))
    jj = j - 2
    c1 = Fraction(-(1 + jj) * (3 + 2 * jj) * (n - jj), jj * (2 * jj - 1) * (n + jj + 1))
    c2 = Fraction((3 + 2 * jj) * (n - 2 * b), jj * (n + jj + 1))
    return _Wnbj(n, b, jj) * c1 + _Wnbj(n, b, jj + 1) * c2


def _pnkb_dist(n, m, l1):
    "P(distinguished lineage subtends l1 | k=m undistinguished left)."
    return Fraction(comb(n + 2 - l1, m + 1), comb(n + 3, m + 3)) * l1


def _pnkb_undist(n, m, l3):
    "P(undistinguished lineage subtends l3 | k=m undistinguished left)."
    return Fraction(comb(n + 3 - l3, m + 2), comb(n + 3, m + 3))


def _below_coeffs(n):
    "Triangular recurrence for the below-coefficients (matrix_cache.cpp:115-146)."
    mlast = None
    for nn in range(2, n + 3):
        mnew = [[F0] * (nn - 1) for _ in range(n + 1)]
        mnew[nn - 2][nn - 2] = F1
        for k in range(nn - 1, 1, -1):
            denom = (nn + 1) * (nn - 2) - (k + 1) * (k - 2)
            c1 = Fraction((nn + 1) * (nn - 2), denom)
            for i in range(n + 1):
                mnew[i][k - 2] = mlast[i][k - 2] * c1
        for k in range(nn - 1, 1, -1):
            denom = (nn + 1) * (nn - 2) - (k + 1) * (k - 2)
            c2 = Fraction((k + 2) * (k - 1), denom)
            for i in range(n + 1):
                mnew[i][k - 2] -= mnew[i][k - 1] * c2
        mlast = mnew
    return mlast  # (n+1) x (n+1) Fractions


def _frac_array(rows, dtype=np.float64):
    return np.array([[float(x) for x in row] for row in rows], dtype=dtype)


@dataclass(frozen=True)
class MatrixCache:
    """Constant matrices linking the tjj integrals to the CSFS, in the
    stable (symmetrized) eigenbasis of the irreducible Moran block.

    The CSFS "above" contraction is X @ C @ Uinv per hidden interval,
    where C carries the model-dependent integrals over eigen index
    k = 3..n+2; "below" is tjj_below @ M0 / M1.  All factors here are
    O(n)-bounded (the cancellations are resolved exactly at build time),
    so the f64 contraction keeps ~machine precision at any n."""

    X0: np.ndarray  # (n, n)   rows j = 2..n+1, cols eigen k = 3..n+2
    X2: np.ndarray  # (n, n)
    M0: np.ndarray  # (n+1, n)
    M1: np.ndarray  # (n+1, n+1)
    Uinv0: np.ndarray  # (n, n) eigen k -> output states 1..n
    Uinv2: np.ndarray  # (n, n) eigen k -> output states b = 0..n-1


_DISK_CACHE_DIR = os.environ.get(
    "SMCPP_TPU_TORCH_CACHE", os.path.join(BUILD_DIR, "cache")
)


def _exact_below_matrices(n):
    """M0 (n+1, n) and M1 (n+1, n+1) with the triple product carried in
    exact rational arithmetic.

    The below-coefficients ``bc`` grow to ~1e28 by n=100 with alternating
    signs, but the PRODUCTS bc @ diag @ P are O(1)-bounded — the reference's
    float64 product (matrix_cache.cpp:258-276) therefore carries absolute
    error ~|bc|max * eps (~1e13 at n=100).  The diagonal factors are exact
    integers: lsp * (1 - 2/lsp) = lsp - 2 and lsp * (2/lsp) = 2."""
    bc = _below_coeffs(n)
    P_undist = [
        [
            _pnkb_undist(n, k, b) if (k >= 1 and 1 <= b <= n - k + 1) else F0
            for b in range(1, n + 1)
        ]
        for k in range(n + 1)
    ]
    P_dist = [
        [
            _pnkb_dist(n, k, b) if 1 <= b <= n - k + 1 else F0
            for b in range(1, n + 2)
        ]
        for k in range(n + 1)
    ]
    M0 = np.zeros((n + 1, n))
    M1 = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        row = bc[i]
        sc0 = [row[k] * k for k in range(n + 1)]  # lsp[k] - 2 == k
        sc1 = [row[k] * 2 for k in range(n + 1)]
        for b in range(n):
            M0[i, b] = float(
                sum(sc0[k] * P_undist[k][b] for k in range(n + 1) if P_undist[k][b])
            )
        for b in range(n + 1):
            M1[i, b] = float(
                sum(sc1[k] * P_dist[k][b] for k in range(n + 1) if P_dist[k][b])
            )
    return M0, M1


@lru_cache(maxsize=None)
def cached_matrices(n: int) -> MatrixCache:
    """The dense constant matrices linking tjj integrals to the CSFS.

    Reference: matrix_cache.cpp:212-282 — but assembled so that every
    factor is O(n)-bounded: the below products exactly in rationals, the
    above weights against the symmetrized (orthonormal-up-to-D) eigenbasis
    instead of the explosively-normalized exact one.  Persisted to an .npz
    keyed by n."""
    path = os.path.join(_DISK_CACHE_DIR, f"matrices2_{n}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return MatrixCache(**{k: z[k] for k in z.files})

    mse = stable_eigensystem(n)
    D_sub_above = np.arange(1, n + 1) / (n + 1.0)  # (n,)

    Wnbj = np.zeros((n, n))
    for b in range(1, n + 1):
        for j in range(2, n + 2):
            Wnbj[b - 1, j - 2] = float(_Wnbj(n + 1, b, j))

    # X0: above weights for row a'=0 — states 1..n carry (1 - b/(n+1));
    # X2: row a'=2 is the mirror model, i.e. the same T eigenbasis read at
    # flipped states with weight b/(n+1) (the reference expresses this via
    # U.reverse(), matrix_cache.cpp:262).
    X0 = Wnbj.T @ ((1.0 - D_sub_above)[:, None] * mse.U)
    X2 = Wnbj.T @ (D_sub_above[:, None] * mse.U[::-1, :])

    M0, M1 = _exact_below_matrices(n)

    mc = MatrixCache(
        X0=X0, X2=X2, M0=M0, M1=M1, Uinv0=mse.Uinv, Uinv2=mse.Uinv[:, ::-1]
    )
    try:
        os.makedirs(_DISK_CACHE_DIR, exist_ok=True)
        # np.savez appends ".npz" unless the name already ends with it, so
        # the temp name must end in ".npz" or os.replace never finds it.
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(
            tmp, X0=X0, X2=X2, M0=M0, M1=M1, Uinv0=mc.Uinv0, Uinv2=mc.Uinv2
        )
        os.replace(tmp, path)
    except OSError:
        pass
    return mc
