"""The runs of equal keys that K4 (viterbi_ops) finds in benchmark cells'
packed windows, on one NVIDIA GPU.

    python3 tools/k4_run_share.py --seed N CELL [CELL ...]

Sets each posterior cell up as the benchmark does (portbench's entry: data
from the seed, the manager, a warm decode), then reads the manager's packed
windows (``_wkeys``, ``_wvalid``) and prints one JSON line a cell: the
valid windows, the runs, the runs of at least ``VITERBI_RUN_MIN`` windows
(applied as powers) and the share of the valid windows they hold, their
mean length, and the operator products a valid window of the run plan
(``viterbi_ops_counts``: what ``viterbi_ops_products.posterior`` reads).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("cells", nargs="+")
    a = p.parse_args(argv)
    import torch

    from portbench import harness
    from smcpp_tpu_torch.ops import window_kernel as wk

    for name in a.cells:
        cell, cfg, traffic, _ = harness.find_cell(name)
        entry = harness.load_module(os.path.join(harness.HERE, "entries",
                                                 traffic["entry"] + ".py"))
        run = harness.Run(cell, cfg, traffic, a.seed, 0.0, False, torch.device("cuda"))
        st = run.state = entry.setup(run)
        _, _, length = wk.viterbi_runs(st.im._wkeys, st.im._wvalid)
        long = length[length >= wk.VITERBI_RUN_MIN]
        products, windows = wk.viterbi_ops_counts(st.im._wkeys, st.im._wvalid)
        print(json.dumps({
            "cell": name, "valid_windows": windows, "runs": int(len(length)),
            "long_runs": int(len(long)), "long_share": float(long.sum() / windows),
            "long_mean": float(long.mean()) if len(long) else None,
            "products_a_window": products / windows,
        }), flush=True)
        entry.release(run)
        del st
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
