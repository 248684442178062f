"""Run one cell of the benchmark of smcpp_tpu_torch once, on the card of
this machine, and print its result as the last line of standard output.

    python3 portbench/run.py --workload fit.human_n100 --seed 7 --seconds 30 --trace 0

``--trace 0`` measures the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (synchronised spans around the layers, torch.profiler on
the device).  Without a card, with fewer cards than the cell asks for, or
where the run loaded JAX or the JAX package, it prints no result and exits
with code 2.  The numbers compared against the reference are printed last
on standard error, each beside its limit.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from portbench import harness

    try:
        line, err = harness.execute(a.workload, a.seed, a.seconds, bool(a.trace))
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for s in err:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
