"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ctypes.  The nvcc processes
run in parallel.  The build runs at first use, into ``paths.BUILD_DIR``,
each library keyed by a hash of its source, the shared headers and the
flags, so a fresh checkout builds everything it needs on its first CUDA call
and nothing is built when this module is imported.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types

from ..paths import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process (None: cached)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points by source file
_SIGNATURES = {
    "window_kernels.cu": {
        "smcpp_segment_ops": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
        "smcpp_asc_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        "smcpp_asc_sweep_plan": [_I, _I, _I, _I, _P],
        "smcpp_asc_div_check": [_P, _P, _I, _P, _P],
        "smcpp_window_kernels_last_launch": [_P],
    },
    "dsc_kernels.cu": {
        "smcpp_dsc_sweep": [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            _P, _P, _P, _P, _P,
        ],
        "smcpp_dsc_kernels_last_launch": [_P],
    },
    "remat_kernels.cu": {
        "smcpp_remat_sweep": [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
        ],
        "smcpp_remat_sweep_plan": [_I, _I, _I, _I, _P],
        "smcpp_remat_kernels_last_launch": [_P],
    },
    "viterbi_kernels.cu": {
        "smcpp_viterbi_ops": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
        "smcpp_viterbi_paths_fwd": [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        ],
        "smcpp_viterbi_paths_back": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
        "smcpp_viterbi_kernels_last_launch": [_P],
    },
    "boundary_kernels.cu": {
        "smcpp_boundary_products": [_P, _P, _I, _I, _I, _I, _P, _P],
        "smcpp_boundary_chunk_scan": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
        "smcpp_boundary_finish": [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
        ],
        "smcpp_viterbi_boundary_forward": [
            _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
        ],
        "smcpp_viterbi_boundary_trace": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    },
}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the "
            "CUDA kernels of smcpp_tpu_torch are built from source at first use"
        )
    return path


def _headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path(source):
    "Path of the shared library built from csrc/``source``."
    h = hashlib.sha256()
    for f in [os.path.join(CSRC, source), *_headers()]:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + b"\0" + fh.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def library_paths():
    return [library_path(src) for src in _SIGNATURES]


def build(verbose=False):
    """Compile every library whose source changed, one nvcc per source, all
    started together; returns the library paths.  ``verbose`` rebuilds with
    ``-Xptxas -v`` (registers, shared memory and spills per kernel) and
    prints the compiler output."""
    global build_seconds
    todo = [
        (src, so) for src, so in zip(_SIGNATURES, library_paths())
        if verbose or not os.path.exists(so)
    ]
    if not todo:
        return library_paths()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, so in todo:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, so, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src}: nvcc failed ({p.returncode}):\n{out}")
            continue
        if verbose:
            print(f"== {src}\n{out}")
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return library_paths()


def lib():
    "The loaded kernel entry points, as attributes (built on first call)."
    global _lib
    with _lock:
        if _lib is None:
            build()
            fns = {}
            for src, sigs in _SIGNATURES.items():
                handle = ctypes.CDLL(library_path(src))
                for name, argtypes in sigs.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
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
