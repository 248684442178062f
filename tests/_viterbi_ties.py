"""Viterbi inputs on which two states tie exactly at every valid window
(NumPy only; shared by tests/test_torch_viterbi_paths.py and
tests/test_torch_cuda.py)."""

import numpy as np


def tie_inputs(seed, S, L, M, n_keys, a, b, dtype=np.float32):
    """(T, E, keys, valid, seg_entry, seg_exit) as NumPy arrays, with twin
    states a < b: rows a and b of T are equal, so are columns a and b of T
    and of E (whose twin columns are large, so the twins lie on most
    paths).  So log T[a][i] == log T[b][i] for every i, and V[a] == V[b]
    from the first valid window on: the candidates a and b tie exactly at
    every later valid window, and the lowest-index rule must take a.
    valid has a run of invalid windows across the boundary of windows 32
    and 64, and the last segment is invalid throughout; the boundary states
    include b."""
    if not 0 <= a < b < M:
        raise ValueError(f"twins must satisfy 0 <= a < b < M, got {a}, {b}, M = {M}")
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M) * 3, size=M) + np.eye(M) * 2
    T /= T.sum(1, keepdims=True)
    T[b] = T[a]
    col = 0.5 * (T[:, a] + T[:, b])
    T[:, a] = col
    T[:, b] = col
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    E[:, a] = E[:, b] = rng.uniform(0.9, 1.0, n_keys)  # the twins are likely
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.9
    valid[0, 25:70] = False
    valid[-1] = False
    entry = rng.randint(0, M, S).astype(np.int32)
    exit_ = rng.randint(0, M, S).astype(np.int32)
    entry[::3] = b
    exit_[1::3] = b
    return T.astype(dtype), E.astype(dtype), keys, valid, entry, exit_
