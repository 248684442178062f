"""Where the f32 M-step (manager ``_use_fast_mstep``, ``_tensors32``) pays on
the card, by the number of lineages n.

    python3 tools/mstep_crossover.py [N ...]

For each n (default 20 50 100 200) simulates one contig of 10 Mbp at n
undistinguished lineages from chip_smoke's slice truth (seed 130 + n) and
fits it with ``estimate --em-iterations 1 --device cuda`` (the CLI in this
process), so that the manager holds fitted statistics.  On those statistics
it then times, in turns (f64, f32, f32, f64) after a warm-up of each, with
the gate closed or opened by hand (``chip_smoke.fast_mstep_gate``):

  batch   one coarse Q batch of the optimizer's prefetch shape (24 rows a
          knot), host milliseconds and, under torch.profiler, its kernels
          and their device milliseconds (``chip_smoke.mstep_crossover``);
  mstep   one steady-state M-step (the optimizer's unified M-step, every run
          from the same model, rho and trust radii), host milliseconds, its
          Q batches and candidates.

Needs a card and nvcc (the E-step's kernels are built from source, as
chip_smoke builds them); prints one line a width and kind, each with the
card's name and power limit.
"""

import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

BP = 10_000_000
PAIRS = 3


def fitted(workdir, n):
    "The analysis of a one-iteration fit of one contig at n lineages."
    from smcpp_tpu_torch.commands import main as cli

    f = cs.simulate(workdir, f"n{n}", BP, 130 + n, n=n)
    return cli.main(["estimate", "--device", "cuda", "--em-iterations", "1",
                     "-o", os.path.join(workdir, f"out{n}"), "1.25e-8", f])


def mstep_runs(analysis, pairs):
    """Host ms of the unified M-step in f64 and f32, in turns, each from the
    same state; with the Q batches (coarse, exact) and candidates of the
    last run of each."""
    import torch

    from smcpp_tpu_torch.inference import manager as mg

    opt = analysis._optimizer
    model = analysis.model
    state = (model.y.copy(), analysis.rho, dict(opt._radius))
    calls = []
    orig = mg.OnePopInferenceManager.Q_batch

    def counted(self, ys=None, rhos=None, theta=None, alpha=None, fast_ok=False):
        calls.append((bool(fast_ok), len(ys) if ys is not None else len(rhos)))
        return orig(self, ys, rhos, theta, alpha, fast_ok)

    def one(fast):
        model.y, analysis.rho = state[0].copy(), state[1]
        opt._radius = dict(state[2])
        opt._mstep_count, opt._force_sequential = 1, False
        calls.clear()
        with cs.fast_mstep_gate(0 if fast else float("inf")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            handled = opt._unified_mstep()
            torch.cuda.synchronize()
        if not handled:
            raise RuntimeError("the unified M-step did not run")
        return (time.perf_counter() - t) * 1e3, list(calls)

    mg.OnePopInferenceManager.Q_batch = counted
    try:
        runs = {False: [], True: []}
        last = {}
        for fast in (False, True):
            one(fast)
        for _ in range(pairs):
            for fast in (False, True, True, False):
                ms, c = one(fast)
                runs[fast].append(ms)
                last[fast] = c
    finally:
        mg.OnePopInferenceManager.Q_batch = orig
        model.y, analysis.rho = state[0].copy(), state[1]
        opt._radius = dict(state[2])
    return runs, last


def describe(c):
    coarse = [r for f, r in c if f]
    exact = [r for f, r in c if not f]
    return (f"{len(coarse)} coarse ({sum(coarse)} candidates), "
            f"{len(exact)} exact ({sum(exact)})")


def main(ns):
    cs.card()
    cs.build()
    for n in ns:
        with tempfile.TemporaryDirectory() as w:
            t0 = time.perf_counter()
            a = fitted(w, n)
            im = a._ims[("pop1",)]
            cs.log(f"n = {n}: fit {time.perf_counter() - t0:.1f} s; K = "
                   f"{im._grid.K}, M = {im._grid.M}, {im.em_idx.n_keys} keys")
            t64, t32 = cs.mstep_crossover(f"n = {n}", im, pairs=PAIRS)
            runs, last = mstep_runs(a, PAIRS)
            m64, m32 = (float(np.median(runs[f])) for f in (False, True))
            cs.log(f"  one steady-state M-step, host clock, median of "
                   f"{2 * PAIRS} in turns: f64 {m64:.2f} ms "
                   f"({describe(last[False])}), f32 {m32:.2f} ms "
                   f"({describe(last[True])}): {m64 / m32:.2f}x; runs f64 "
                   f"{[round(x, 2) for x in runs[False]]}, f32 "
                   f"{[round(x, 2) for x in runs[True]]} [{cs.CARD}]")
            del a, im


if __name__ == "__main__":
    main([int(x) for x in sys.argv[1:]] or [20, 50, 100, 200])
