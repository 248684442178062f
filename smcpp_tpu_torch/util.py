"""Misc utilities and demographic presets (mirrors smcpp/util.py)."""

import numpy as np


def cumsum0(ary):
    return np.concatenate([[0], np.cumsum(ary)])


# The MSMC "sawtooth" demographic history (Schiffels & Durbin 2014,
# supplemental section 7), discretized to exponential-growth epochs.  The
# published constants are the six (time, growth-rate) change points; the
# start/end sizes below are the closed-form epoch endpoints
# a_{k+1} = a_k * exp(g_k * (t_k - t_{k+1})), precomputed once and committed
# as a literal table (times in coalescent units, already doubled to the
# diploid convention; N0 = 14312).  Reference exposes the same preset as
# smcpp/util.py:19-41.
sawtooth = {
    "a": np.array([
        5.0, 5.0, 0.500002043581199, 5.004960812339331,
        0.5006182646008216, 5.006159250799454, 0.5006155104069533,
    ]),
    "b": np.array([
        5.0, 0.500002043581199, 5.004960812339331, 0.5006182646008216,
        5.006159250799454, 0.5006155104069533, 0.596236,
    ]),
    "s": np.array([
        0.001164524, 0.003493576, 0.01398028, 0.05589122,
        0.2235884, 0.894354, 0.2,
    ]),
    "N0": 14312,
}

human = {
    "a": np.array([10.0, 0.5, 1.0, 4.0]),
    "b": np.array([1.0, 0.5, 1.0, 4.0]),
    "s": np.array([10000.0, 60000.0, 130000.0, 1.0]) / 20000.0 / 29.0,
    "N0": 10000.0,
}


def undistinguished_sfs(sfs, folded=False):
    "Marginalize an (a+1, n+1) CSFS onto total derived count (util.py:55-70)."
    sfs = np.asarray(sfs)
    a = sfs.shape[0] - 1
    n = sfs.shape[1] - 1
    usfs = np.zeros([n + a] + list(sfs.shape[2:]), dtype=sfs.dtype)
    for i in range(a + 1):
        for j in range(n + 1):
            if 0 <= i + j < n + a:
                usfs[i + j] = usfs[i + j] + sfs[i, j]
    if folded:
        ret = [usfs[0]]
        for i in range(1, -(-(n + a) // 2)):
            inds = list({i, n + a - i})
            ret.append(usfs[inds].sum(axis=0))
        usfs = np.array(ret, dtype=sfs.dtype)
    return usfs


def exp_piecewise_to_stepwise(a, b, s, pieces_per_epoch=40):
    "Discretize exponential-growth epochs to piecewise-constant (model.py:98-115)."
    ap, sp = [], []
    for aa, bb, ss, cs in zip(a, b, s, cumsum0(s)[:-1]):
        if aa == bb:
            ap.append(aa)
            sp.append(ss)
        else:
            s0 = cs if cs > 0 else 1e-5
            s1 = s0 + ss
            t = np.linspace(s0, s1, pieces_per_epoch)
            sp += np.diff(t).tolist()
            ap += (aa * (bb / aa) ** ((t[:-1] - s0) / (s1 - s0))).tolist()
    return np.array(ap), np.array(sp)
