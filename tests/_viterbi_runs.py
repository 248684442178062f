"""Viterbi inputs with runs of equal keys (NumPy only; shared by
tests/test_torch_viterbi_ops_runs.py and tests/test_torch_cuda.py)."""

import numpy as np

KINDS = ("mixed", "one_key", "alternating", "chunks", "zeros")


def _runs(rng, L, lengths, n_keys):
    "One segment's keys: runs of the given lengths, each key unlike the last."
    row, key = [], -1
    for r in lengths:
        key = (key + 1 + rng.randint(n_keys - 1)) % n_keys
        row += [key] * int(r)
    return np.array(row[:L], np.int32)


def run_inputs(seed, S, L, M, n_keys, kind, dtype=np.float32):
    """(T, E, keys, valid) as NumPy arrays, n_keys >= 2:

    * 'mixed': runs of 1-3 windows (walked) and of 7-300 (around and past
      the cut-off; powers), 3% of the windows invalid, the last segment's
      last third invalid (a ragged contig tail);
    * 'one_key': one key a whole segment, every window valid (r = L);
    * 'alternating': two keys in turn, so no run is longer than 1;
    * 'chunks': runs of 31, 33, 64, 95 and 8 windows, which cross the
      kernel's 32-window chunks, and one invalid window inside a run;
    * 'zeros': 'mixed' with zero entries in T and E (impossible
      transitions and emissions: log 0 = -inf)."""
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M) + np.eye(M)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    if kind == "zeros":
        T[rng.rand(M, M) < 0.2] = 0.0
        T[np.arange(M), np.arange(M)] = 1.0
        E[rng.rand(n_keys, M) < 0.2] = 0.0
        E[:, 0] = 1.0
    T /= T.sum(1, keepdims=True)
    valid = np.ones((S, L), bool)
    if kind == "one_key":
        keys = np.repeat(rng.randint(0, n_keys, (S, 1)), L, 1).astype(np.int32)
    elif kind == "alternating":
        keys = np.where(np.arange(L) % 2 == 0, 0, 1)[None].repeat(S, 0).astype(np.int32)
        keys = (keys + rng.randint(0, n_keys - 1, (S, 1))).astype(np.int32) % n_keys
    elif kind == "chunks":
        pattern = [31, 33, 64, 95, 8]
        keys = np.stack([_runs(rng, L, pattern * (L // 231 + 1), n_keys) for _ in range(S)])
        valid[:, min(31 + 33 + 20, L - 1)] = False  # inside the run of 64
    else:
        def lengths():
            short = rng.randint(1, 4, 4 * L)
            long = rng.randint(7, 301, 4 * L)
            return np.where(rng.rand(4 * L) < 0.5, short, long)

        keys = np.stack([_runs(rng, L, lengths(), n_keys) for _ in range(S)])
        valid = rng.rand(S, L) >= 0.03
        valid[-1, 2 * L // 3:] = False
    return T.astype(dtype), E.astype(dtype), keys, valid
