"""Faults planted in the port under a run, one for each fault a cell can
have: a step that returns its state unchanged, half of the batch left out
with the mean taken over the rest, an answer altered where it is produced.
(One card: there is no exchange between cards to leave out.)  Each takes
an object with pytest's ``monkeypatch.setattr`` and plants its fault
through it.  The tests run them on tiny cells; on the card

    python3 portbench/faults.py --workload fit.human_n100 --fault fit_half_batch --seeds 1 2 3

runs a cell with one planted and prints its result lines.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fit_state_unchanged(monkeypatch):
    "Every M-step returns the parameters it was given."
    from smcpp_tpu_torch.inference import optimizer

    monkeypatch.setattr(optimizer.SMCPPOptimizer, "_unified_mstep", lambda self: True)


def fit_half_batch(monkeypatch):
    """The E-step reads the first half of the windows' segments and takes
    the rest to be like them (its statistics doubled)."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    inner = wk.estep_direct

    def estep_direct(pi, T, E, keys, valid, soc, **kw):
        v = valid.clone()
        v[v.shape[0] // 2:] = False
        return tuple(2 * x for x in inner(pi, T, E, keys, v, soc, **kw))

    monkeypatch.setattr(wk, "estep_direct", estep_direct)


def fit_answer_altered(monkeypatch):
    "The E-step's log-likelihood is altered where it is produced."
    from smcpp_tpu_torch.inference import manager

    inner = manager._InferenceManager.E_step

    def E_step(self):
        inner(self)
        self._ll *= 1.001
        return self._ll

    monkeypatch.setattr(manager._InferenceManager, "E_step", E_step)


def posterior_map_altered(monkeypatch):
    "One row's MAP state is altered where it is produced."
    from smcpp_tpu_torch.inference import manager

    inner = manager._InferenceManager.map_paths

    def map_paths(self):
        paths = inner(self)
        M = len(self.hidden_states) - 1
        paths[0][5] = (paths[0][5] + M // 2) % M
        return paths

    monkeypatch.setattr(manager._InferenceManager, "map_paths", map_paths)


def posterior_gamma_altered(monkeypatch):
    "One row's posterior masses are altered where they are produced."
    from smcpp_tpu_torch.inference import manager

    inner = manager._InferenceManager._compute_gammas

    def compute_gammas(self, *a):
        g = inner(self, *a)
        g[0][3] = np.roll(g[0][3], 1)
        return g

    monkeypatch.setattr(manager._InferenceManager, "_compute_gammas", compute_gammas)


def posterior_half_batch(monkeypatch):
    """The decode computes the first half of each contig's rows and gives
    the rest their mean."""
    from smcpp_tpu_torch.inference import manager

    inner = manager._InferenceManager._compute_gammas

    def compute_gammas(self, *a):
        out = []
        for g in inner(self, *a):
            h = len(g) // 2
            g = g.copy()
            g[h:] = g[:h].mean(0)
            out.append(g)
        return out

    monkeypatch.setattr(manager._InferenceManager, "_compute_gammas", compute_gammas)


FAULTS = [("fit.tiny", fit_state_unchanged), ("fit.tiny", fit_half_batch),
          ("fit.tiny", fit_answer_altered), ("posterior.tiny", posterior_map_altered),
          ("posterior.tiny", posterior_gamma_altered), ("posterior.tiny", posterior_half_batch)]




class Patch:
    "monkeypatch.setattr's face, undone by ``undo``."

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=[f.__name__ for _, f in FAULTS])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    from portbench import harness

    fault = {f.__name__: f for _, f in FAULTS}[a.fault]
    for s in a.seeds:
        patch = Patch()
        fault(patch)
        try:
            line, _ = harness.execute(a.workload, s, a.seconds, False)
        finally:
            patch.undo()
        print(line, flush=True)


if __name__ == "__main__":
    main()
