"""Contig container (mirrors SMC++ smcpp/contig.py)."""

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass
class Contig:
    pid: Tuple
    data: np.ndarray  # (L, 1 + 3 * npop) int32: span, (a, b, nb) per pop
    n: np.ndarray  # undistinguished sample size per pop
    a: np.ndarray  # distinguished lineage count per pop
    fn: str = None

    def __post_init__(self):
        self.n = np.atleast_1d(np.asarray(self.n))
        self.a = np.atleast_1d(np.asarray(self.a))

    @property
    def npop(self):
        return len(self.pid)

    @property
    def key(self):
        return (tuple(self.pid), tuple(self.n), tuple(self.a))

    def __len__(self):
        return int(self.data[:, 0].sum())
