"""ctypes bindings for the native data kernels (csrc/datakernels.cpp, the
source the JAX package also builds).

The shared library is compiled with g++ on first use into the port's own
build directory (paths.BUILD_DIR), keyed by a hash of the source.  Without a
toolchain every entry point raises ImportError, and data/filters.py falls back
to its NumPy loops.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from .paths import BUILD_DIR

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "datakernels.cpp",
)
_LIB = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _lib():
    "Build (once per source hash) and load the library."
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SRC):
        raise ImportError("native kernels source not found")
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"datakernels-{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp,
                 _SRC],
                check=True, capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            raise ImportError(f"could not build native kernels: {e}") from e
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.thin_data.restype = ctypes.c_long
    lib.thin_data.argtypes = [
        _i32p, ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        _i32p, ctypes.c_long,
    ]
    lib.bin_observations.restype = ctypes.c_long
    lib.bin_observations.argtypes = [
        _i32p, ctypes.c_long, ctypes.c_long, _i64p, ctypes.c_long,
        _i32p, ctypes.c_long,
    ]
    lib.windowed_mutation_counts.restype = ctypes.c_long
    lib.windowed_mutation_counts.argtypes = [
        _i32p, ctypes.c_long, ctypes.c_long, ctypes.c_long, _i64p,
        ctypes.c_long,
    ]
    _LIB = lib
    return lib


def thin_data(data, thinning, offset=0):
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.int32)
    rows, cols = data.shape
    cap = int(2 * np.ceil(data[offset:, 0] / thinning).sum() + rows + 2)
    out = np.empty((cap, cols), dtype=np.int32)
    r = lib.thin_data(data, rows, cols, thinning, offset, out, cap)
    if r < 0:
        raise RuntimeError(f"thin_data failed ({r})")
    ret = out[:r].copy()
    assert ret[:, 0].sum() == data[:, 0].sum()
    return ret


def bin_observations(data, na, w):
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.int32)
    rows, cols = data.shape
    total = int(data[:, 0].sum())
    cap = total // w + 2
    out = np.zeros((cap, cols), dtype=np.int32)
    na = np.ascontiguousarray(na, dtype=np.int64)
    r = lib.bin_observations(data, rows, cols, na, w, out, cap)
    if r < 0:
        raise RuntimeError(f"bin_observations failed ({r})")
    return out[:r].copy()


def windowed_mutation_counts(data_rev, w):
    lib = _lib()
    data_rev = np.ascontiguousarray(data_rev, dtype=np.int32)
    rows, cols = data_rev.shape
    total = int(data_rev[:, 0].sum())
    cap = total // w + 2
    out = np.zeros((cap, 2), dtype=np.int64)
    r = lib.windowed_mutation_counts(data_rev, rows, cols, w, out, cap)
    if r < 0:
        raise RuntimeError(f"windowed_mutation_counts failed ({r})")
    return out[:r].T.copy()
