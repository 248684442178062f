"""smcpp_tpu_torch — the PyTorch/CUDA port of smcpp_tpu.

Same method (SMC++, Terhorst, Kamm & Song, Nature Genetics 2017), same data
format, model JSON and CLI, written for one NVIDIA GPU: the window E-step runs
as hand-written CUDA kernels (ops/window_kernel.py, csrc/window_kernels.cu)
and the float64 M-step objective is plain PyTorch with autograd.  This package
imports torch and never jax.
"""

from .version import __version__  # noqa: F401
