"""Entry 'posterior2': what ``smc++ posterior --map --intervals q1,q2,...``
runs on joint data of two populations after loading it
(smcpp_tpu_torch/commands/posterior.py), on one two-population manager
built in set-up (``make_manager((n1, n2), (2, 0), ...)``, the true split
model): the E-step with the posterior masses saved, the masses normalised
per row, the MAP path and the quantiles, each by ``entries/posterior.py``'s
``decode``, under the same benchmark spans (``estep``, ``decode``,
``viterbi``, ``quantiles``).  The window decodes the traffic's contigs
again and again and ends with the first decode that ends after
``--seconds``.

Traffic keys: those of ``posterior``, the entry named ``posterior2``."""

import os
import shutil
import tempfile

import numpy as np
import torch

from portbench.gen import simulate2
from portbench.harness import load_module
from portbench.reference import hmm as ref_hmm
from portbench.reference import tensors as ref_tensors
from portbench.reference import tensors2

# a copy of the one-population entry of this entry's own: its decode, window, timing
# and comparison serve here, its ``shapes`` replaced by the joint rows' (below)
p1 = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "posterior.py"))
POLARIZATION_ERROR = p1.POLARIZATION_ERROR
decode, window, end_to_end, release, compare = (
    p1.decode, p1.window, p1.end_to_end, p1.release, p1.compare)


def truth_json(cfg):
    "The model file's model a user would pass: the configuration's split truth."
    t = cfg["truth"]

    def marginal(p):
        return {"class": "SMCModel", "knots": list(map(float, t[p]["knots"])), "N0": t["N0"],
                "spline_class": "Piecewise", "y": [float(v) for v in np.log(t[p]["sizes"])],
                "pid": p}

    return {"class": "SMCTwoPopulationModel", "model1": marginal("pop1"),
            "model2": marginal("pop2"), "split": float(t["split"])}


def setup(run):
    from smcpp_tpu_torch.data import format as fmt
    from smcpp_tpu_torch.inference import estimation
    from smcpp_tpu_torch.inference.manager import make_manager
    from smcpp_tpu_torch.models import model_from_dict

    cfg, tr = run.cfg, run.traffic
    st = p1.State()
    st.bp = [int(cfg["genome_bp"][c]) for c in tr["contigs"]]
    with run.part("generate"):
        st.contigs = simulate2.genome(cfg, st.bp, run.seed, run.device)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        with run.part("write"):
            files = simulate2.write_all(tmp, st.contigs, cfg["n1"], cfg["n2"])
        with run.part("load"):
            m = model_from_dict(truth_json(cfg))
            contigs = fmt.load_data(files)
            st.hidden_states = estimation.balance_hidden_states(
                m.distinguished_model, tr["M"] + 1)
            st.obs = [np.insert(c.data, 0, [[1] + [-1, 0, 0] * 2], 0) for c in contigs]
            c0 = contigs[0]
            st.im = make_manager(c0.n, c0.a, st.obs, st.hidden_states, tuple(c0.pid),
                                 POLARIZATION_ERROR, device=run.device.type)
            st.im.set_model(m)
            st.im.theta, st.im.rho, st.im.alpha = cfg["theta"], cfg["rho"], 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if run.traced:
        inner = st.im._compute_gammas

        def compute_gammas(*a):
            with run.span("decode"):
                return inner(*a)

        st.im._compute_gammas = compute_gammas
    with run.part("warm"):
        decode(run, st)
    return st


def shapes(run):
    "Rows (span, key columns) of each contig as the reference derives them."
    lead = np.array([[1, -1, 0, 0, -1, 0, 0]], np.int64)  # posterior's first row
    rows = [np.vstack([lead, c]) for c in run.state.contigs]
    cfg = run.cfg
    return rows, tensors2.emission_index(rows, (cfg["n1"], cfg["n2"]), POLARIZATION_ERROR)


p1.shapes = shapes  # what the window's traced run reads the rows' shape from


def check(run):
    """The decodes of the window held to the reference, in float64 on the
    run's device, by ``posterior``'s numbers (``compare``), TF32 off."""
    with no_tf32():
        ref = reference(run)
        worst = compare(run, ref, run.window["outputs"])
    lim = run.traffic["limits"]
    return [(k, v, lim[k]) for k, v in worst.items()], 0


def reference(run, dtype=torch.float64):
    """What the reference works out from the data and the split model: the
    rows, the hidden states, pi, T and E (the host joint CSFS) and every
    row's normalised posterior masses.  ``dtype`` below float64 gives the
    control's masses."""
    cfg, tr = run.cfg, run.traffic
    rows, idx = shapes(run)
    sm = tensors2.SplitModel.of(cfg["truth"])
    hs = ref_tensors.balance_hidden_states(sm.model1, tr["M"] + 1)
    pi, T, E = (x.to(dtype) for x in tensors2.tensors(
        sm, hs, idx, cfg["theta"], cfg["rho"], 1, run.device))
    keys = [ref_tensors.keys_of(idx, r) for r in rows]
    sp, ky = ref_hmm.pack([(r[:, 0], k) for r, k in zip(rows, keys)])
    R = ref_hmm.Rows(sp, ky, run.device, budget=ref_hmm.free_budget(run.device))
    g = R.gammas(pi, T, E)
    g = (g / g.sum(-1, keepdim=True).clamp(min=torch.finfo(g.dtype).tiny)).float().cpu().numpy()
    return {"rows": rows, "hs": hs, "R": R, "pi": pi, "T": T, "E": E, "g": g, "sp": sp}


class no_tf32:
    "TF32 off for float32 matrix products while the block runs."

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev
