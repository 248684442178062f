"""The port's window E-step (plain PyTorch versions of K1-K3 and the glue
around them) against smcpp_tpu.ops.window_kernel, on the CPU.

Inputs are made from a seed with NumPy and handed to both packages.
Bounds:

* float64: 1e-12 (the same recursions, summed in another order);
* float32 at 'highest': rtol 1e-5 / atol 1e-8 of the largest entry (the
  bound of tests/test_pallas_sweeps.py), against both the XLA sweeps and the
  Pallas sweeps run in interpret mode;
* float32 at 'default' (bf16 carries on both sides, rounded at the same
  points): rtol 1e-4.  A one-ulp f32 difference before a bf16 rounding can
  flip it; the measured differences are at the f32 level (about 1e-7).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smcpp_tpu.ops import pallas_sweeps as jps  # noqa: E402
from smcpp_tpu.ops import window_kernel as jwk  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as twk  # noqa: E402

jax.config.update("jax_enable_x64", True)

BOUNDS = {  # (precision, dtype) -> (rtol, atol as a fraction of the max)
    ("highest", np.float64): (1e-12, 1e-14),
    ("highest", np.float32): (1e-5, 1e-8),
    ("default", np.float32): (1e-4, 1e-8),
}


def _problem(seed, S, L, M, n_keys, dtype):
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M).astype(dtype)
    E = rng.uniform(0.05, 1.0, (n_keys, M)).astype(dtype)
    pi = rng.dirichlet(np.ones(M)).astype(dtype)
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.9
    valid[-2:, L // 3:] = False  # ragged contig tails
    A_in = rng.rand(S, M).astype(dtype)
    Q_end = rng.rand(S, M).astype(dtype)
    return pi, T, E, keys, valid, A_in, Q_end


def _close(got, want, rtol, atol_frac):
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_frac * max(np.abs(want).max(), 1e-300)
    )


CASES = [
    ("highest", np.float64, 16),
    ("highest", np.float32, 16),
    ("highest", np.float32, 17),
    ("default", np.float32, 16),
    ("default", np.float32, 17),
]


@pytest.mark.parametrize("precision,dtype,M", CASES)
def test_segment_operators(precision, dtype, M):
    _, T, E, keys, valid, _, _ = _problem(0, 12, 256, M, 89, dtype)
    ops_j, logs_j = jwk.segment_operators(
        jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys), jnp.asarray(valid),
        precision=precision,
    )
    ops_t, logs_t = twk.segment_operators(
        torch.as_tensor(T), torch.as_tensor(E), torch.as_tensor(keys),
        torch.as_tensor(valid), precision=precision,
    )
    assert ops_t.dtype == torch.from_numpy(T).dtype
    rtol, atol = BOUNDS[(precision, dtype)]
    _close(ops_t, ops_j, rtol, atol)
    _close(logs_t, logs_j, rtol, atol)


@pytest.mark.parametrize("precision,dtype,M", CASES)
def test_stats_pass(precision, dtype, M):
    _, T, E, keys, valid, A_in, Q_end = _problem(1, 10, 200, M, 89, dtype)
    ref = jwk.stats_pass(
        *map(jnp.asarray, (T, E, keys, valid, A_in, Q_end)), None,
        precision=precision,
    )
    got = twk.stats_pass(
        *map(torch.as_tensor, (T, E, keys, valid, A_in, Q_end)),
        precision=precision,
    )
    rtol, atol = BOUNDS[(precision, dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)
    # conservation: each valid window's posterior sums to one
    gsum = got[3]
    assert gsum.dtype == torch.float64
    assert abs(float(gsum.sum()) - valid.sum()) < 1e-6 * valid.sum()


def test_stats_pass_matches_pallas_interpret():
    """The port's sweeps against the Pallas TPU kernels (P1, P2) run in
    interpret mode, as tests/test_pallas_sweeps.py runs them."""
    _, T, E, keys, valid, A_in, Q_end = _problem(2, 8, 256, 16, 89, np.float32)
    ref = jps.sweeps(
        jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys.T),
        jnp.asarray(valid.T), jnp.asarray(A_in), jnp.asarray(Q_end),
        alpha_dtype=jnp.float32, precision="highest", interpret=True,
    )
    got = twk.stats_pass(
        *map(torch.as_tensor, (T, E, keys, valid, A_in, Q_end)),
        precision="highest",
    )
    for g, r in zip(got, ref):
        _close(g, r, 1e-5, 1e-8)


def _soc(S, C):
    "seg_of_contig for S segments over C contigs of uneven length."
    cuts = np.linspace(0, S, C + 1).astype(int)
    ns = np.diff(cuts)
    soc = np.full((C, ns.max()), -1, np.int64)
    for c in range(C):
        soc[c, : ns[c]] = np.arange(cuts[c], cuts[c + 1])
    return soc


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_contig_boundaries(dtype):
    pi, T, E, keys, valid, _, _ = _problem(3, 14, 64, 16, 40, dtype)
    ops, logs = jwk.segment_operators(*map(jnp.asarray, (T, E, keys, valid)),
                                      precision="highest")
    soc = _soc(14, 3)
    seg_has = valid.any(1)
    ref = jwk.contig_boundaries(jnp.asarray(pi), ops, logs, soc,
                                jnp.asarray(seg_has))
    got = twk.contig_boundaries(
        torch.as_tensor(pi), torch.as_tensor(np.array(ops)),
        torch.as_tensor(np.array(logs)), soc, torch.as_tensor(seg_has),
    )
    rtol, atol = BOUNDS[("highest", dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)


@pytest.mark.parametrize("precision,dtype,M", CASES)
def test_estep_direct(precision, dtype, M):
    pi, T, E, keys, valid, _, _ = _problem(4, 15, 128, M, 60, dtype)
    soc = _soc(15, 4)
    ref = jwk.estep_direct(*map(jnp.asarray, (pi, T, E, keys, valid)), soc,
                           precision=precision)
    pi_t, T_t, E_t = twk.from_numpy(pi, T, E, "cpu", torch.from_numpy(T).dtype)
    got = twk.estep_direct(pi_t, T_t, E_t, torch.as_tensor(keys),
                           torch.as_tensor(valid), soc, precision=precision)
    rtol, atol = BOUNDS[(precision, dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)
    assert abs(float(got[3].sum()) - valid.sum()) < 1e-6 * valid.sum()


def test_estep_direct_large_key_table():
    """700 keys at M = 32: past the reference's one-hot limit (384 keys,
    where it gathers and streams e_all) and past the 605 keys whose K2
    tables fit a block's shared memory on the card."""
    pi, T, E, keys, valid, _, _ = _problem(6, 9, 64, 32, 700, np.float32)
    soc = _soc(9, 2)
    ref = jwk.estep_direct(*map(jnp.asarray, (pi, T, E, keys, valid)), soc,
                           precision="highest")
    pi_t, T_t, E_t = twk.from_numpy(pi, T, E, "cpu")
    got = twk.estep_direct(pi_t, T_t, E_t, torch.as_tensor(keys),
                           torch.as_tensor(valid), soc, precision="highest")
    rtol, atol = BOUNDS[("highest", np.float32)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)
    assert abs(float(got[3].sum()) - valid.sum()) < 1e-6 * valid.sum()


def test_unported_modes_raise():
    _, T, E, keys, valid, A_in, Q_end = map(
        torch.as_tensor, _problem(5, 4, 64, 16, 20, np.float32)
    )
    with pytest.raises(NotImplementedError, match="B3"):
        twk.stats_pass(T, E, keys, valid, A_in, Q_end, e_all=E)
    with pytest.raises(NotImplementedError, match="B3"):
        twk.stats_pass(T, E, keys, valid, A_in, Q_end, alpha_remat=8)
    # the emit_gamma mode is ported: the stream is (S, L, M), one posterior
    # per window that sums to 1 where the window is valid
    *_, gam = twk.stats_pass(T, E, keys, valid, A_in, Q_end, emit_gamma=True)
    assert gam.shape == (4, 64, 16) and gam.dtype == torch.float32
    sums = gam.sum(-1)
    torch.testing.assert_close(sums[valid], torch.ones_like(sums[valid]))


@pytest.mark.parametrize("precision,dtype,M", CASES)
def test_segment_ops_plain_f64_sums(precision, dtype, M):
    """The plain loop with each step's products summed in f64 and rounded
    once (K3's summation on the card, the plain version it is held to)
    agrees with the reference at the same bounds; with f64 inputs it is the
    loop itself."""
    _, T, E, keys, valid, _, _ = _problem(0, 12, 256, M, 89, dtype)
    ref = jwk.segment_operators(*map(jnp.asarray, (T, E, keys, valid)),
                                precision=precision)
    args = (*map(torch.as_tensor, (T, E, keys, valid)), precision)
    got = twk.segment_ops_plain(*args, sum_dtype=torch.float64)
    assert got[0].dtype == got[1].dtype == torch.from_numpy(T).dtype
    rtol, atol = BOUNDS[(precision, dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)
    if dtype == np.float64:
        for g, w in zip(got, twk.segment_ops_plain(*args)):
            assert torch.equal(g, w)


def _round_f32(x):
    "The Fraction ``x`` rounded to the nearest float32 (ties to even)."
    from fractions import Fraction

    c = np.float32(float(x))
    best = None
    for y in (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(y)) - x)
        key = (d, int(np.array(y).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, y)
    return best[1]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("M", [16, 32])
def test_f64_sums_are_correctly_rounded(precision, M):
    """Two windows from the identity with unit emissions: the first step's
    carry is T^T (rounded to the carry dtype), the second's each entry's
    exact sum of M products rounded once to f32 (then to the carry dtype) --
    the f32 value K3 forms from its f64 tensor-core sums, whatever their
    order."""
    from fractions import Fraction

    rng = np.random.RandomState(23 + M)
    T = torch.as_tensor(rng.dirichlet(np.ones(M), size=M), dtype=torch.float32)
    E = torch.ones((1, M), dtype=torch.float32)
    keys = torch.zeros((1, 2), dtype=torch.int32)
    valid = torch.ones((1, 2), dtype=torch.bool)
    cdt = twk.carry_dtype(precision, torch.float32)
    X1 = twk.segment_ops_plain(T, E, keys[:, :1], valid[:, :1], precision,
                               sum_dtype=torch.float64)[0][0]
    assert torch.equal(X1, T.T.to(cdt).float())
    got = twk.segment_ops_plain(T, E, keys, valid, precision,
                                sum_dtype=torch.float64)[0][0]
    Tf = [[Fraction(float(v)) for v in row] for row in T.tolist()]
    Xf = [[Fraction(float(v)) for v in row] for row in X1.tolist()]
    want = np.array([[_round_f32(sum(Tf[j][i] * Xf[j][k] for j in range(M)))
                      for k in range(M)] for i in range(M)], np.float32)
    want = torch.as_tensor(want).clamp(min=twk.FLOOR).to(cdt).float()
    assert torch.equal(got, want)


def _split_bf16x3(x):
    "hi, mid, lo in bf16 (8 significand bits each) with hi + mid + lo == x."
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _ops_default(T, E, keys, valid, step_sum):
    """segment_ops_plain's loop at 'default', with each step's sum T^T X
    formed by ``step_sum(X)``; returns ops."""
    S, L = keys.shape
    X = torch.eye(T.shape[0]).expand(S, -1, -1).to(torch.bfloat16)
    for l in range(L):
        eT = E[keys[:, l]]
        eT = eT / torch.clamp(torch.amax(eT, 1), min=torch.finfo(torch.float32).tiny)[:, None]
        Y = torch.clamp(step_sum(X.float()) * eT[:, :, None], min=twk.FLOOR)
        X = torch.where(valid[:, l, None, None], Y, X.float()).to(torch.bfloat16)
        if (l + 1) % twk.RESCALE_EVERY == 0:
            mx = torch.clamp(X.float().abs().amax((1, 2)), min=torch.finfo(torch.float32).tiny)
            X = (X.float() / mx[:, None, None]).to(torch.bfloat16)
    return X.float()


@pytest.mark.parametrize("M", [16, 32])
def test_default_rung_depends_on_the_summation(M):
    """Why K3's plain version is the loop summed in f64.  At 'default' the
    carry is rounded to bf16 after every step, so a last-bit difference in
    a step's f32 sum flips a rounding now and then (2^-8 relative, past the
    1e-3 tolerance of ops).  Over 256 windows, two summations each accurate
    to f32 miss that tolerance against the f32-summed loop: K3's (f64 sums,
    one rounding) and a bf16 tensor-core design's (T split into three exact
    bf16 parts; X T_hi accumulated in f32 apart from X T_mid + X T_lo, then
    added: exact products, so the best such a design can do).  K3's agrees
    with its plain version bit for bit; at 'highest' all agree within
    1e-5."""
    _, T, E, keys, valid, _, _ = map(torch.as_tensor, _problem(0, 40, 256, M, 89, np.float32))
    parts = [p.float() for p in _split_bf16x3(T)]
    assert torch.equal(parts[0] + parts[1] + parts[2], T)
    Tt = T.T
    ref = twk.segment_ops_plain(T, E, keys, valid, "default")[0]
    f32 = _ops_default(T, E, keys, valid, lambda X: torch.matmul(Tt, X))
    assert torch.equal(f32, ref)  # the loop above is segment_ops_plain's
    f64 = _ops_default(T, E, keys, valid,
                       lambda X: torch.matmul(Tt.double(), X.double()).float())
    assert torch.equal(f64, twk.segment_ops_plain(T, E, keys, valid, "default",
                                                  sum_dtype=torch.float64)[0])
    hi, mid, lo = (p.T for p in parts)
    split = _ops_default(T, E, keys, valid, lambda X: torch.matmul(hi, X)
                         + (torch.matmul(lo, X) + torch.matmul(mid, X)))

    def misses(got, want, rtol):
        atol = 1e-7 * float(want.abs().max())
        return int(((got - want).abs() > atol + rtol * want.abs()).sum())

    assert misses(f64, ref, 1e-3) > 0 and misses(split, ref, 1e-3) > 0
    high = [twk.segment_ops_plain(T, E, keys, valid, "highest", sum_dtype=d)[0]
            for d in (None, torch.float64)]
    assert misses(high[1], high[0], 1e-5) == 0


def _k3_tile_maps(MB):
    """K3's register maps (csrc/window_kernels.cu) for the m16n8k16 f64 tile,
    per warp w of the segment's MB // 16 and lane (g, t): the (row k,
    column j) of X^T each A register of k16-tile Q holds, the (row j, column
    i) of T each B register of n-tile n holds, and the (row k, column i) of
    Y^T = X^T T each accumulator register holds; with the tile's physical
    positions (the PTX fragment layout) alongside."""
    a, b, d = {}, {}, {}
    for w in range(MB // 16):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            kb = 16 * w + g
            jq = lambda q: 8 * (q >> 1) + 2 * t + (q & 1)  # noqa: E731
            for Q in range(MB // 16):
                for r in range(8):
                    a[w, Q, g + 8 * (r & 1), t + 4 * (r >> 1)] = (
                        kb + 8 * (r & 1), jq(4 * Q + (r >> 1)))
                for n in range(MB // 8):
                    for r in range(4):
                        b[w, Q, n, t + 4 * r, g] = (jq(4 * Q + r), 8 * n + g)
            for n in range(MB // 8):
                for r in range(4):
                    d[w, n, lane, r] = (g + 8 * (r >> 1), 2 * t + (r & 1),
                                        kb + 8 * (r >> 1), 8 * n + 2 * t + (r & 1))
    return a, b, d


@pytest.mark.parametrize("MB", [16, 32])
def test_k3_fragments_reuse_the_accumulator(MB):
    """The permuted contraction index of K3's tiles: every physical A and B
    position is filled once, the tiles' products are Y^T = X^T T, and the
    entries of X^T a lane holds in its accumulator are exactly those it
    feeds the next step's A (no shuffles)."""
    a, b, d = _k3_tile_maps(MB)
    NW, NQ, NN = MB // 16, MB // 16, MB // 8
    assert len(a) == NW * NQ * 16 * 16 and len(b) == NW * NQ * NN * 16 * 8
    rng = np.random.RandomState(24)
    Xt, T = rng.rand(MB, MB), rng.rand(MB, MB)
    for w in range(NW):
        for n in range(NN):
            D = np.zeros((16, 8))
            for Q in range(NQ):
                A = np.zeros((16, 16))
                B = np.zeros((16, 8))
                for row in range(16):
                    for col in range(16):
                        A[row, col] = Xt[a[w, Q, row, col]]
                    for col in range(8):
                        B[row, col] = T[b[w, Q, n, row, col]]
                D += A @ B
            for lane in range(32):
                for r in range(4):
                    row, col, k, i = d[w, n, lane, r]
                    np.testing.assert_allclose(D[row, col], (Xt @ T)[k, i], rtol=1e-12)
    for w in range(NW):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            held = {(k, i) for (w_, n, ln, r), (_, _, k, i) in d.items()
                    if w_ == w and ln == lane}
            fed = {a[w, Q, g + 8 * (r & 1), t + 4 * (r >> 1)]
                   for Q in range(NQ) for r in range(8)}
            assert held == fed and len(held) == 4 * NN


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("M", [2, 15, 16, 17, 32])
def test_asc_sweep_plain_f64_sums(M, precision):
    """K1's plain version on the card, the ascending sweep with each
    window's products a T summed in f64 and rounded once, against the
    default plain version (f32 sums, the reference's): alpha_end and an f32
    stream within rtol 1e-5, a bf16 stream within one bf16 ulp; and the
    default plain version still against the JAX sweep."""
    _, T, E, keys, valid, A_in, _ = map(
        torch.as_tensor, _problem(9, 12, 256, M, 89, np.float32))
    got = twk.asc_sweep_plain(T, E, keys, valid, A_in, precision, sum_dtype=torch.float64)
    want = twk.asc_sweep_plain(T, E, keys, valid, A_in, precision)
    assert got[0].dtype == want[0].dtype == twk.carry_dtype(precision, torch.float32)
    assert got[1].dtype == torch.float32
    _close(got[0], want[0].double(), 2.0**-7 if precision == "default" else 1e-5, 1e-8)
    _close(got[1], want[1].double(), 1e-5, 1e-8)
    ref = jwk.stats_pass(*map(jnp.asarray, (T.numpy(), E.numpy(), keys.numpy(),
                                            valid.numpy(), A_in.numpy(), A_in.numpy())),
                         None, precision=precision)
    rtol, atol = BOUNDS[(precision, np.float32)]
    _close(want[1], ref[0], rtol, atol)  # alpha_end


@pytest.mark.parametrize("M", [2, 15, 32])
def test_dsc_sweep_plain_f64_sums(M):
    """K2's plain version on the card, the descending sweep with each
    window's per-key sums formed in f64, against the default plain version
    (f32 sums, the reference's, which the JAX sweep is held to): u_start
    and xo equal (the sums only feed gsum), gsum within rtol 1e-5 (the
    bound chip_smoke holds K2 to), and the f64 sums nearer gsum summed
    from f64 inputs."""
    _, T, E, keys, valid, A_in, Q_end = map(
        torch.as_tensor, _problem(10, 12, 256, M, 89, np.float32))
    alphas, _ = twk.asc_sweep_plain(T, E, keys, valid, A_in, "highest")
    got = twk.dsc_sweep_plain(T, E, keys, valid, alphas, Q_end, sum_dtype=torch.float64)
    want = twk.dsc_sweep_plain(T, E, keys, valid, alphas, Q_end)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2].dtype == torch.float64
    _close(got[2], want[2], 1e-5, 1e-8)
    x = twk.dsc_sweep_plain(T.double(), E.double(), keys, valid, alphas.double(),
                            Q_end.double())[2]
    assert float((got[2] - x).abs().max()) <= float((want[2] - x).abs().max())


def test_f64_sums_track_the_exact_sweep():
    """Why K1 is held to the f32-summed sweep only where that sweep has not
    drifted: with a near-identity T (a fit's, diagonal about 0.9998) the
    f32-summed loop's rounding accumulates over 512 windows past rtol 1e-5
    of the f64-summed loop (K1's summation), which stays several times
    nearer the sweep computed in f64 throughout."""
    rng = np.random.RandomState(1)
    S, L, M, nk = 64, 512, 15, 26
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 5000
    T = torch.as_tensor(T / T.sum(1, keepdims=True), dtype=torch.float32)
    E = torch.as_tensor(rng.uniform(0.05, 1.0, (nk, M)), dtype=torch.float32)
    keys = torch.as_tensor(rng.randint(0, nk, (S, L)).astype(np.int32))
    valid = torch.as_tensor(rng.rand(S, L) < 0.95)
    A_in = torch.as_tensor(rng.rand(S, M), dtype=torch.float32)
    f32 = twk.asc_sweep_plain(T, E, keys, valid, A_in, "highest")
    f64 = twk.asc_sweep_plain(T, E, keys, valid, A_in, "highest", sum_dtype=torch.float64)
    exact = twk.asc_sweep_plain(T.double(), E.double(), keys, valid, A_in.double(), "highest")

    def dist(x, ref):
        return float(((x.double() - ref).abs() / (ref.abs() + 1e-7)).max())

    for k in (0, 1):  # the stream, alpha_end
        assert dist(f64[k], exact[k]) < dist(f32[k], exact[k]) / 2
    assert dist(f64[1], f32[1].double()) > 1e-5


def _k1_tile_maps(MB):
    """K1's register maps (csrc/window_kernels.cu) for the m16n8k16 f64 tile,
    per lane (g, t) of the warp that owns 16 segments (the tile's rows): the
    (row s, column j) of the carry X each A register of k16-tile Q holds, the
    (row j, column i) of T each B register of n-tile n holds, and the (row s,
    column i) of Y = X T each accumulator register holds; with the tile's
    physical positions (the PTX fragment layout) alongside."""
    a, b, d = {}, {}, {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        jq = lambda q: 8 * (q >> 1) + 2 * t + (q & 1)  # noqa: E731
        for Q in range(MB // 16):
            for r in range(8):
                a[Q, g + 8 * (r & 1), t + 4 * (r >> 1)] = (g + 8 * (r & 1), jq(4 * Q + (r >> 1)))
            for n in range(MB // 8):
                for r in range(4):
                    b[Q, n, t + 4 * r, g] = (jq(4 * Q + r), 8 * n + g)
        for n in range(MB // 8):
            for r in range(4):
                d[n, lane, r] = (g + 8 * (r >> 1), 2 * t + (r & 1),
                                 g + 8 * (r >> 1), 8 * n + 2 * t + (r & 1))
    return a, b, d


@pytest.mark.parametrize("MB", [16, 32])
def test_k1_fragments_reuse_the_accumulator(MB):
    """K1's tiles, the rows read as 16 segments: every physical A and B
    position is filled once, the tiles' products are Y = X T, the entries a
    lane holds in its accumulator are exactly those it feeds the next step's
    A (no shuffles), and lanes xor 1 and xor 2 (the row maximum's butterfly)
    together hold every column of the lane's two rows."""
    a, b, d = _k1_tile_maps(MB)
    NQ, NN = MB // 16, MB // 8
    assert len(a) == NQ * 16 * 16 and len(b) == NQ * NN * 16 * 8
    rng = np.random.RandomState(25)
    X, T = rng.rand(16, MB), rng.rand(MB, MB)
    for n in range(NN):
        D = np.zeros((16, 8))
        for Q in range(NQ):
            A = np.array([[X[a[Q, row, col]] for col in range(16)] for row in range(16)])
            B = np.array([[T[b[Q, n, row, col]] for col in range(8)] for row in range(16)])
            D += A @ B
        for lane in range(32):
            for r in range(4):
                row, col, s, i = d[n, lane, r]
                np.testing.assert_allclose(D[row, col], (X @ T)[s, i], rtol=1e-12)
    held = {lane: {(s, i) for (n, ln, r), (_, _, s, i) in d.items() if ln == lane}
            for lane in range(32)}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        fed = {a[Q, g + 8 * (r & 1), t + 4 * (r >> 1)] for Q in range(NQ) for r in range(8)}
        assert held[lane] == fed and len(fed) == 4 * NN
        group = held[lane] | held[lane ^ 1] | held[lane ^ 2] | held[lane ^ 3]
        butterfly = {ln for x in (lane, lane ^ 1) for ln in (x, x ^ 2)}
        assert butterfly == {lane, lane ^ 1, lane ^ 2, lane ^ 3}
        assert group == {(s, i) for s in (g, g + 8) for i in range(MB)}


def test_check_key_range():
    twk.check_key_range(np.array([[0, 3], [19, 2]], np.int32), 20)
    twk.check_key_range(np.zeros((0, 8), np.int32), 1)
    for bad in ([[0, 20]], [[-1, 0]]):
        with pytest.raises(ValueError, match="out of range"):
            twk.check_key_range(np.array(bad, np.int32), 20)


def test_carry_dtype_follows_the_ladder():
    assert twk.carry_dtype("default", torch.float32) == torch.bfloat16
    assert twk.carry_dtype("tensorfloat32", torch.float32) == torch.float32
    assert twk.carry_dtype("highest", torch.float32) == torch.float32
    assert twk.carry_dtype("default", torch.float64) == torch.float64
    for p in ("default", "tensorfloat32", "highest"):
        assert np.dtype(jwk._carry_dtype(p, jnp.float32)).itemsize == (
            torch.finfo(twk.carry_dtype(p, torch.float32)).bits // 8
        )


# --- contig_boundaries (K6's plain version) on edge shapes -----------------

def _boundary_case(case, S, rng):
    """seg_of_contig and seg_has for S segments: 'uneven' three contigs of
    uneven length with tail padding; 'no_valid' the same with every segment
    of the middle contig empty (cvalid false, no ll term); 'unlisted' two
    contigs that leave some segments unlisted (their rows stay zero);
    'one_contig' C = 1."""
    seg_has = np.ones(S, bool)
    if case == "one_contig":
        return np.arange(S, dtype=np.int64)[None], seg_has
    if case == "unlisted":
        listed = np.sort(rng.choice(S, S - 4, replace=False))
        soc = np.full((2, S), -1, np.int64)
        soc[0, : 3] = listed[:3]
        soc[1, : len(listed) - 3] = listed[3:]
        return soc, seg_has
    soc = _soc(S, 3)
    if case == "no_valid":
        seg_has[soc[1][soc[1] >= 0]] = False
    return soc, seg_has


def _boundary_ops(seed, S, M, dtype):
    rng = np.random.RandomState(seed)
    ops = rng.uniform(0.01, 1.0, (S, M, M)).astype(dtype)
    logs = rng.uniform(-40.0, -1.0, S).astype(dtype)
    pi = rng.dirichlet(np.ones(M)).astype(dtype)
    return pi, ops, logs, rng


BOUNDARY_CASES = ["uneven", "no_valid", "unlisted", "one_contig"]


@pytest.mark.parametrize("case", BOUNDARY_CASES)
@pytest.mark.parametrize("M", [2, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_contig_boundaries_edge_shapes(case, M, dtype):
    pi, ops, logs, rng = _boundary_ops(7, 13, M, dtype)
    soc, seg_has = _boundary_case(case, 13, rng)
    ref = jwk.contig_boundaries(jnp.asarray(pi), jnp.asarray(ops),
                                jnp.asarray(logs), soc, jnp.asarray(seg_has))
    got = twk.contig_boundaries_plain(*map(torch.as_tensor, (pi, ops, logs)),
                                      soc, torch.as_tensor(seg_has))
    rtol, atol = BOUNDS[("highest", dtype)]
    for g, r in zip(got, ref):
        _close(g, r, rtol, atol)
    ll, A_in, Q_end, cvalid = got
    assert ll.dtype == torch.float64 and A_in.shape == Q_end.shape == (13, M)
    listed = np.unique(soc[soc >= 0])
    unlisted = np.setdiff1d(np.arange(13), listed)
    assert float(A_in[unlisted].abs().sum() + Q_end[unlisted].abs().sum()) == 0.0
    if case == "no_valid":
        assert cvalid.tolist() == [True, False, True]
        # the empty contig adds no ll term: the other two alone give ll
        keep = soc[[0, 2]]
        ll2 = twk.contig_boundaries_plain(*map(torch.as_tensor, (pi, ops, logs)),
                                          keep, torch.as_tensor(seg_has))[0]
        assert float(ll) == float(ll2)


def test_contig_boundaries_dispatches_plain_on_cpu(monkeypatch):
    """A CPU tensor runs the plain loop; the kernel's wrapper is never
    called (it would raise here: no card)."""
    def no_kernel(*a):
        raise AssertionError("the CUDA wrapper ran on CPU tensors")

    monkeypatch.setattr(twk, "boundary_scan_cuda", no_kernel)
    pi, ops, logs, rng = _boundary_ops(8, 9, 5, np.float32)
    soc, seg_has = _boundary_case("uneven", 9, rng)
    args = (*map(torch.as_tensor, (pi, ops, logs)), soc, torch.as_tensor(seg_has))
    before = twk.BOUNDARY_SCAN.launches
    for g, w in zip(twk.contig_boundaries(*args), twk.contig_boundaries_plain(*args)):
        assert torch.equal(g, w)
    assert twk.BOUNDARY_SCAN.launches == before
