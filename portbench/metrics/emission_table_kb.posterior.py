"""The emission table's footprint in a decode's window kernels, in KB (1000
bytes): the largest dynamic shared memory over the kernels with a table that
the run launched (the port's counters ``<KERNEL>.smem_bytes`` and
``<KERNEL>.glob``, smcpp_tpu_torch/ops/window_kernel.py, taken from the
launcher's own choice), a kernel that read its table from global memory
(k_glob) counted at the table's own bytes, n_keys x M float32.  None where
the port keeps no such counters or launched no kernel with a table (the CPU)."""


def read(run):
    try:
        from smcpp_tpu_torch.ops import window_kernel as wk
    except ImportError:
        return None
    sh = run.window.get("shape")
    ks = [k for k in wk.KERNELS if k.launches and getattr(k, "smem_bytes", None) is not None]
    if sh is None or not ks:
        return None
    table = 4 * sh["n_keys"] * sh["M"]
    return max(table if k.glob else k.smem_bytes for k in ks) / 1000.0
