"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes.  The build runs at first use,
into ``paths.BUILD_DIR``, keyed by a hash of the sources and the flags, so a
fresh checkout builds everything it needs on its first CUDA call and nothing
is built when this module is imported.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..paths import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process (None: cached)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "smcpp_segment_ops": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "smcpp_asc_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "smcpp_dsc_sweep": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ],
}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the "
            "CUDA kernels of smcpp_tpu_torch are built from source at first use"
        )
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path():
    "Path of the shared library for the current sources and flags."
    h = hashlib.sha256()
    for f in _sources():
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + b"\0" + fh.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"window_kernels-{h.hexdigest()[:16]}.so")


def build(verbose=False):
    """Compile the kernels if the library for the current sources is
    missing; returns its path.  ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory and spills per kernel) and prints the compiler output."""
    global build_seconds
    so = library_path()
    if os.path.exists(so) and not verbose:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *_sources()]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    if verbose:
        print(res.stdout + res.stderr)
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def lib():
    "The loaded kernel library (built on first call)."
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(code, name):
    "Raise if a C entry point returned a CUDA error code."
    if code != 0:
        import torch

        msg = ""
        try:
            msg = torch.cuda.cudart().cudaGetErrorString(code)
        except (AttributeError, RuntimeError, TypeError):
            pass
        raise RuntimeError(f"CUDA kernel {name} failed: error {code} {msg}")
