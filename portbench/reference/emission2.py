"""Frozen copy of the two-population half of smcpp_tpu_torch/ops/emission.py
(keys (a1, b1, nb1, a2, b2, nb2)), the plain NumPy code the benchmark's
reference builds the joint emission index with.  Later changes to the port
do not reach it; the one-population half it builds on is ``emission.py``.
The assembly of E from the index is ``emission.emission_matrix``, which
takes either index."""

import numpy as np

from .emission import (
    KIND_CSFS,
    KIND_DINUC,
    KIND_MISS,
    EmissionIndex,
    _bin_key_1pop,
    _marginalize_key_1pop,
)


def _is_monomorphic_joint(key, na):
    "All populations at (a == na, b == nb) (inference_manager.cpp:288-297)."
    for p in range(len(na)):
        a, b, nb = key[3 * p : 3 * p + 3]
        if a != na[p] or b != nb:
            return False
    return True


def _convert_monomorphic_joint(key, na):
    if not _is_monomorphic_joint(key, na):
        return key
    out = []
    for p in range(len(na)):
        out += [0, 0, key[3 * p + 2]]
    return tuple(out)


def _folded_joint(key, na):
    out = []
    for p in range(len(na)):
        a, b, nb = key[3 * p : 3 * p + 3]
        out += [na[p] - a, nb - b, nb]
    return tuple(out)


def key_weights_2pop(key, n, na, polarization_error):
    """{(a1, b1, a2, b2) -> w} for one joint observation key: the product
    over populations (bin_key.h:66-85, marginalize_key.h:53-79), then the
    joint monomorphic conversion, the polarization folding and the
    renormalisation of construct_bins."""
    per_pop = []
    for p in range(2):
        a, b, nb = (int(x) for x in key[3 * p : 3 * p + 3])
        sub = {}
        for k1 in _bin_key_1pop(a, b, nb, na[p]):
            for kk, w in _marginalize_key_1pop(*k1, n[p]).items():
                sub[kk] = sub.get(kk, 0.0) + w
        per_pop.append(sub)
    m = {}
    pe = polarization_error
    for kl, wl in per_pop[0].items():
        for kr, wr in per_pop[1].items():
            w = wl * wr
            mbk = _convert_monomorphic_joint(kl + kr, na)
            m[mbk] = m.get(mbk, 0.0) + (1.0 - pe) * w
            fk = _folded_joint(mbk, na)
            m[fk] = m.get(fk, 0.0) + pe * w
    m2 = {k: v for k, v in m.items() if v > 0 and not _is_monomorphic_joint(k, na)}
    s = sum(m2.values())
    if s <= 0:
        raise RuntimeError(f"joint key {key} has no probability mass")
    out = {}
    for (a1, b1, _, a2, b2, _2), v in m2.items():
        out[(a1, b1, a2, b2)] = out.get((a1, b1, a2, b2), 0.0) + v / s
    return out


def build_emission_index_2pop(keys, n, na, polarization_error=0.5):
    """The EmissionIndex of two-population keys; W maps onto the flattened
    joint CSFS (a1 + 1, (n1 + 1)(a2 + 1)(n2 + 1)) at a1 D + b1 (a2 + 1)(n2
    + 1) + a2 (n2 + 1) + b2 (include/jcsfs.h tensorRef)."""
    keys = np.asarray(sorted(set(map(tuple, keys))), dtype=np.int32)
    nk = len(keys)
    n1, n2 = n
    D = (n1 + 1) * (na[1] + 1) * (n2 + 1)
    W = np.zeros((nk, (na[0] + 1) * D))
    kind = np.zeros(nk, dtype=np.int32)
    parity = np.zeros(nk, dtype=np.int32)
    for i, key in enumerate(keys):
        a_vals = [int(key[0]), int(key[3])]
        reduced = int(key[2]) == 0 and int(key[5]) == 0
        miss = all(a_vals[p] == -1 for p in range(2) if na[p] > 0)
        if reduced and (miss or min(a_vals) >= 0):
            if miss:
                kind[i] = KIND_MISS
            else:
                kind[i] = KIND_DINUC
                parity[i] = sum(a_vals) % 2
        else:
            kind[i] = KIND_CSFS
            for (a1, b1, a2, b2), w in key_weights_2pop(
                tuple(int(x) for x in key), n, na, polarization_error
            ).items():
                W[i, a1 * D + b1 * (na[1] + 1) * (n2 + 1) + a2 * (n2 + 1) + b2] += w
    return EmissionIndex(keys=keys, W=W, kind=kind, parity=parity, n=n, na=na)
