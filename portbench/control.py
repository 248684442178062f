"""Controls of a cell's check, and the sound readings its limits are set
from, compared with the float64 reference by the same numbers as a run.

Each kind is computed one step below the precision the configuration
states, or is the program as the cell runs it:

* ``tf32`` (posterior): the reference put in the program's place, its
  masses in float32 with TF32 matrix products (the step below the stated
  float32 with TF32 off; the operands rounded to TF32 by ``tf32`` below),
  its MAP path in float32 (a max-plus pass has no product TF32 reaches);
* ``bf16`` (posterior): the same in bfloat16;
* ``program_tf32`` (posterior): the program run as the cell runs it, with
  TF32 matrix products (``tf32`` below): the row-level decode's products
  are torch float32 ones; the hand-written kernels are out of TF32's reach;
* ``default_rung`` (fit): the program with its own lower path switched on,
  the E-step's bfloat16 carries (``--precision default``, the rung below
  the stated ``highest``);
* ``program``: the program as the cell runs it, a sound run.

A control has to come out as not correct.  The benchmark's runs never run
any of these; they run on the card, several seeds in one process, at the
cell's own size, with a short window:

    python3 portbench/control.py --workload posterior.human_n20.chr1 --kind tf32 --seeds 11 12 13

and print one JSON line a seed with each number the check compares and
its limit."""

import argparse
import copy
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KINDS = {"posterior": ("tf32", "bf16", "program_tf32", "program"),
         "fit": ("default_rung", "program")}


def control(workload, seed, kind=None, device_name="cuda", bench=None, traffic_dir=None,
            seconds=8.0):
    """{number: (value, limit)} of one kind on one seed; ``kind`` defaults
    to the entry's first."""
    import torch

    from portbench import harness

    cell, cfg, traffic, bench = harness.find_cell(workload, bench, traffic_dir)
    kind = kind or KINDS[traffic["entry"]][0]
    if kind not in KINDS[traffic["entry"]]:
        raise ValueError(f"no control {kind!r} for entry {traffic['entry']!r}")
    lim = traffic["limits"]
    entry = harness.load_module(os.path.join(harness.HERE, "entries", traffic["entry"] + ".py"))
    if kind in ("tf32", "bf16"):
        from portbench.gen import simulate

        run = harness.Run(cell, cfg, traffic, seed, seconds, False, torch.device(device_name))
        st = entry.State()
        st.bp = [int(cfg["genome_bp"][c]) for c in traffic["contigs"]]
        st.contigs = simulate.genome(cfg, st.bp, seed, run.device)
        run.state = st
        ref = entry.reference(run)
        low_dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        with tf32(kind == "tf32"):
            low = entry.reference(run, dtype=low_dtype)
            path = ref["R"].viterbi_path(*(x.to(low_dtype) for x in
                                           (ref["pi"], ref["T"], ref["E"])))
        worst = entry.compare(run, ref, entry.control_outputs(run, low, path))
    else:
        if kind == "default_rung":
            cfg = copy.deepcopy(cfg)
            cfg["estimate"]["precision"] = "default"
        else:
            cfg = None
        with tf32(kind == "program_tf32"):
            out, _ = harness.execute(workload, seed, seconds, False, device_name, bench=bench,
                                     need_card=device_name == "cuda",
                                     traffic_dir=traffic_dir, cfg=cfg)
        worst = {k: v["value"] for k, v in json.loads(out)["checks"].items()}
    return {k: (float(v), lim[k]) for k, v in worst.items()}


def round_tf32(x):
    """A float32 tensor with its mantissa rounded to TF32's 10 bits (to
    nearest, ties away from zero); the gradient passes as through the
    identity.  Other dtypes pass unchanged."""
    import torch

    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    xd = x.detach().contiguous()
    r = ((xd.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - xd) if x.requires_grad else r


class tf32:
    """Where ``on``, every float32 matrix product while the block runs (``@``,
    ``torch.matmul``, ``torch.bmm``, ``torch.einsum``) takes its operands
    rounded to TF32, as the card's TF32 tensor cores take them, and cuBLAS
    may use TF32 besides.  The rounding stands for TF32 also where cuBLAS
    would keep a small product in float32.  Float64 products (the
    reference's) are out of its reach."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        import torch

        self.prev = torch.get_float32_matmul_precision()
        self.saved = (torch.Tensor.__matmul__, torch.matmul, torch.bmm, torch.einsum)
        if not self.on:
            return
        torch.set_float32_matmul_precision("high")
        mm, matmul, bmm, einsum = self.saved
        torch.Tensor.__matmul__ = lambda a, b: mm(round_tf32(a), round_tf32(b))
        torch.matmul = lambda a, b, **kw: matmul(round_tf32(a), round_tf32(b), **kw)
        torch.bmm = lambda a, b, **kw: bmm(round_tf32(a), round_tf32(b), **kw)

        def einsum_tf32(eq, *ops):
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = tuple(ops[0])
            return einsum(eq, *(round_tf32(o) for o in ops))

        torch.einsum = einsum_tf32

    def __exit__(self, *exc):
        import torch

        (torch.Tensor.__matmul__, torch.matmul, torch.bmm, torch.einsum) = self.saved
        torch.set_float32_matmul_precision(self.prev)


def fails(numbers):
    "Whether any number lies over its limit (a number that is NaN fails)."
    return any(not (v <= lim) for v, lim in numbers.values())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--kind", default=None)
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
