"""Observation-key discovery and emission assembly (one population).

Port of smcpp_tpu/ops/emission.py: the host-side index half is a copy (NumPy
and scipy), the device half is torch.

Host side (data-dependent, once per dataset): discover the distinct
observation keys (a, b, nb) per population, and build for each key the fixed
probability weights onto CSFS entries — missing-data expansion, hypergeometric
marginalization onto the full sample size, monomorphic conversion and
polarization-error folding.  Reference:
SMC++ src/inference_manager.cpp:329-386 (construct_bins),
include/bin_key.h, include/marginalize_key.h.

Device side (differentiable, per M-step evaluation): assemble the dense
(n_keys, M) emission matrix from the theta-incorporated CSFS tensor, the
dinucleotide e2 emissions and the constant missing rows.  Reference:
inference_manager.cpp:389-482 (recompute_emission_probs).
"""

from dataclasses import dataclass

import numpy as np
import torch
from scipy.stats import hypergeom

from .. import defaults


def _marginalize_key_1pop(a, b, nb, n):
    """Distribute (a, b, nb) onto full-sample keys (a, n1, n) with
    hypergeometric weights (marginalize_key.h:19-51)."""
    out = {}
    for n1 in range(b, n + b - nb + 1):
        n2 = n - n1
        w = hypergeom.pmf(b, n1 + n2, n1, nb)
        if w > 0:
            out[(a, n1, n)] = out.get((a, n1, n), 0.0) + float(w)
    return out


def _bin_key_1pop(a, b, nb, na):
    "Missing-a expansion (bin_key.h:34-64; cutoff = 1.0 disables b-binning)."
    if a == -1:
        return [(aa, b, nb) for aa in range(na + 1)]
    return [(a, b, nb)]


def _is_monomorphic(key, na):
    a, b, nb = key
    return a == na and b == nb


def _convert_monomorphic(key, na):
    a, b, nb = key
    if _is_monomorphic(key, na):
        return (0, 0, nb)
    return key


def _folded_key(key, na):
    a, b, nb = key
    return (na - a, nb - b, nb)


def key_weights_1pop(key, n, na, polarization_error):
    """Probability weights {(a', b') -> w} for one observation key.

    Follows construct_bins (inference_manager.cpp:329-386): bin -> marginalize
    -> convert monomorphic -> polarization mixture -> drop monomorphic ->
    normalize -> collapse to (a, b) map keys.
    """
    a, b, nb = key
    m = {}
    for k in _bin_key_1pop(a, b, nb, na):
        probs = _marginalize_key_1pop(*k, n)
        for kk, p in probs.items():
            mbk = _convert_monomorphic(kk, na)
            m[mbk] = m.get(mbk, 0.0) + (1.0 - polarization_error) * p
            fk = _folded_key(mbk, na)
            m[fk] = m.get(fk, 0.0) + polarization_error * p
    m2 = {
        k: v for k, v in m.items() if v > 0 and not _is_monomorphic(k, na)
    }
    s = sum(m2.values())
    if s <= 0:
        raise RuntimeError(f"key {key} has no probability mass")
    out = {}
    for (aa, bb, _), v in m2.items():
        out[(aa, bb)] = out.get((aa, bb), 0.0) + v / s
    return out


@dataclass(frozen=True)
class EmissionIndex:
    """Static per-dataset emission structure (one population).

    keys : (n_keys, 3) int — the distinct (a, b, nb) rows; row index is the
        key id used in the compressed observation arrays.
    W : (n_keys, 3*(n+1)) float64 — weights onto the flattened CSFS
        (row-major (a', b')); zero rows for the special-cased keys.
    kind : (n_keys,) int — 0 = CSFS-binned, 1 = missing (e == 1),
        2 = dinucleotide/e2 with parity ``parity``.
    parity : (n_keys,) int — a % 2 for kind-2 keys.
    """

    keys: np.ndarray
    W: np.ndarray
    kind: np.ndarray
    parity: np.ndarray
    n: int
    na: int

    @property
    def n_keys(self):
        return len(self.keys)

    def key_id(self):
        "dict mapping (a, b, nb) -> row index"
        return {tuple(k): i for i, k in enumerate(self.keys)}


KIND_CSFS, KIND_MISS, KIND_DINUC = 0, 1, 2


def build_emission_index(keys, n, na=2, polarization_error=0.5):
    """Build the EmissionIndex for a sorted list of distinct 1-pop keys.

    Key classification mirrors recompute_emission_probs
    (inference_manager.cpp:436-460): nb == 0 keys are "reduced": missing if
    a == -1, else dinucleotide (e2 with parity a % 2); everything else goes
    through the CSFS bins.
    """
    keys = np.asarray(sorted(set(map(tuple, keys))), dtype=np.int32)
    nk = len(keys)
    W = np.zeros((nk, 3 * (n + 1)))
    kind = np.zeros(nk, dtype=np.int32)
    parity = np.zeros(nk, dtype=np.int32)
    for i, (a, b, nb) in enumerate(keys):
        if nb == 0:
            if a == -1:
                kind[i] = KIND_MISS
            else:
                kind[i] = KIND_DINUC
                parity[i] = a % 2
        else:
            kind[i] = KIND_CSFS
            for (aa, bb), w in key_weights_1pop(
                (int(a), int(b), int(nb)), n, na, polarization_error
            ).items():
                W[i, aa * (n + 1) + bb] += w
    return EmissionIndex(keys=keys, W=W, kind=kind, parity=parity, n=n, na=na)


def emission_matrix(idx: EmissionIndex, csfs_theta, e2):
    """Differentiable assembly of the (..., n_keys, M) emission matrix.

    csfs_theta: (..., M, 3, n+1) theta-incorporated CSFS; e2: (..., M, 2)
    dinucleotide emissions.  Reference: inference_manager.cpp:436-480.
    """
    flat = csfs_theta.reshape(csfs_theta.shape[:-2] + (-1,))  # (..., M, F)
    W = torch.as_tensor(idx.W, dtype=flat.dtype, device=flat.device)
    binned = torch.einsum("kf,...mf->...km", W, flat)
    parity = torch.as_tensor(idx.parity, device=flat.device, dtype=torch.long)
    dinuc = e2[..., parity].transpose(-1, -2)  # (..., n_keys, M)
    kind = torch.as_tensor(idx.kind, device=flat.device)[:, None]
    return torch.where(
        kind == KIND_MISS,
        1.0,
        torch.where(kind == KIND_DINUC, dinuc, binned),
    )


def e2_matrix(avg_coal_times, theta, alpha):
    """Dinucleotide (binned-window) 2-state emissions (..., M, 2):
    e2[m, 0] = exp(-2 alpha theta E[T|m]), e2[m, 1] = 1 - e2[m, 0]; NaN
    average coalescence times get the probability floor.  Reference:
    inference_manager.cpp:409-431."""
    bad = torch.isnan(avg_coal_times)
    act = torch.where(bad, 0.0, avg_coal_times)
    log_e2 = -2.0 * alpha * theta * act
    small = defaults.pi_floor
    return torch.stack(
        [
            torch.where(bad, small, torch.exp(log_e2)),
            torch.where(bad, small, -torch.expm1(log_e2)),
        ],
        -1,
    )
