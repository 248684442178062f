"""Controls of the two-population posterior cells' check (entry
``posterior2``), and the sound readings their limits are set from, as
``control.py`` has them for ``posterior``:

* ``tf32``: the reference put in the program's place, its masses in float32
  with TF32 matrix products (``control.tf32``), its MAP path in float32;
* ``bf16``: the same in bfloat16;
* ``program_tf32``: the program run as the cell runs it, with TF32 matrix
  products;
* ``program``: the program as the cell runs it, a sound run.

A control has to come out as not correct.  The benchmark's runs never run
any of these; they run on the card, several seeds in one process, at the
cell's own size, with a short window:

    python3 portbench/control2.py --workload posterior.twopop_n18_20.chr15 --kind bf16 --seeds 11 12 13

and print one JSON line a seed with each number the check compares and
its limit."""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KINDS = ("tf32", "bf16", "program_tf32", "program")


def control(workload, seed, kind="tf32", device_name="cuda", bench=None, traffic_dir=None,
            seconds=8.0):
    "{number: (value, limit)} of one kind on one seed."
    import torch

    from portbench import control as ctl
    from portbench import harness
    from portbench.gen import simulate2

    if kind not in KINDS:
        raise ValueError(f"no control {kind!r} for entry 'posterior2'")
    cell, cfg, traffic, bench = harness.find_cell(workload, bench, traffic_dir)
    entry = harness.load_module(os.path.join(harness.HERE, "entries", traffic["entry"] + ".py"))
    if kind in ("tf32", "bf16"):
        run = harness.Run(cell, cfg, traffic, seed, seconds, False, torch.device(device_name))
        st = entry.p1.State()
        st.bp = [int(cfg["genome_bp"][c]) for c in traffic["contigs"]]
        st.contigs = simulate2.genome(cfg, st.bp, seed, run.device)
        run.state = st
        ref = entry.reference(run)
        low_dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        with ctl.tf32(kind == "tf32"):
            low = entry.reference(run, dtype=low_dtype)
            path = ref["R"].viterbi_path(*(x.to(low_dtype) for x in
                                           (ref["pi"], ref["T"], ref["E"])))
        worst = entry.compare(run, ref, entry.p1.control_outputs(run, low, path))
    else:
        with ctl.tf32(kind == "program_tf32"):
            out, _ = harness.execute(workload, seed, seconds, False, device_name, bench=bench,
                                     need_card=device_name == "cuda",
                                     traffic_dir=traffic_dir)
        worst = {k: v["value"] for k, v in json.loads(out)["checks"].items()}
    lim = traffic["limits"]
    return {k: (float(v), lim[k]) for k, v in worst.items()}


def main(argv=None):
    from portbench.control import fails

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--kind", default="tf32", choices=KINDS)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    for s in a.seeds:
        out = control(a.workload, s, a.kind, seconds=a.seconds)
        print(json.dumps({"seed": s, "kind": a.kind, "fails": fails(out),
                          "numbers": {k: (v if math.isfinite(v) else str(v), lim)
                                      for k, (v, lim) in out.items()}}), flush=True)


if __name__ == "__main__":
    main()
