"""K4's max-plus operator products per valid window it covered, over the
run's launches (the port's device counters ``VITERBI_OPS.products`` and
``.windows``, smcpp_tpu_torch/ops/window_kernel.py, read after the window).
The window walk is 1.0; a run of equal keys applied as a binary power costs
bitlen(r) - 1 + popcount(r) products for r windows.  None where the port
keeps no such counters or launched no K4 (the CPU)."""


def read(run):
    try:
        from smcpp_tpu_torch.ops import window_kernel as wk
    except ImportError:
        return None
    k = getattr(wk, "VITERBI_OPS", None)
    if k is None or not k.launches:
        return None
    products, windows = getattr(k, "products", None), getattr(k, "windows", None)
    if products is None or not windows:
        return None
    return products / windows
