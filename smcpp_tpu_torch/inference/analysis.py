"""Analysis drivers: data pipeline + model + inference managers + EM.

Port of ``BaseAnalysis`` and ``Analysis`` of smcpp_tpu/inference/analysis.py.
Mirrors SMC++ smcpp/analysis/{base,analysis}.py, including the two-stage
initialization: a constant warm start with one hidden interval, then the
spline model with empirical-TMRCA hidden states.

Under a process group (parallel/distributed.py) every rank runs this driver;
the managers shard the E-step over the group and reduce its statistics, so
every rank fits the same model.  After each M-step rank 0's parameters are
broadcast (``broadcast_parameters``): the M-step runs f64 autograd on each
rank's device, and two ranks whose optimizer paths parted by one ulp would
otherwise feed two models to the next E-step.  By default each rank loads
only its own shard of the files (host-local ingestion,
parallel/hostlocal.py); ``--replicated-data`` loads every file on every
rank.
"""

import json
import logging

import numpy as np
import torch

from .. import defaults
from ..data import filters as df
from ..data import format as fmt
from ..models import SMCModel
from ..parallel import distributed, hostlocal
from ..parallel import mesh as mesh_mod
from . import estimation
from .manager import make_manager, resolve_device
from .optimizer import SMCPPOptimizer

logger = logging.getLogger(__name__)


class BaseAnalysis:
    def __init__(self, files, args):
        self._args = args
        self._device = resolve_device(getattr(args, "device", "cuda"))
        self._mesh = distributed.current()
        self._N0 = 0.5e-4 / args.mu  # so that theta == 1e-4 (base.py:26-28)
        self._theta = 2.0 * self._N0 * args.mu
        if getattr(args, "r", None) is not None:
            self._rho = 2 * self._N0 * args.r
        else:
            self._rho = self._theta
        self._penalty = 0.0
        self._niter = args.em_iterations
        if getattr(args, "unfold", False):
            args.polarization_error = 0.0

        self._hostlocal = hostlocal.active(self._mesh) and not getattr(
            args, "replicated_data", False
        )
        self._headers = None
        if self._hostlocal:
            # the one-line headers of ALL files (population structure, sample
            # sizes), the data of this rank's contiguous shard only
            self._headers, files = hostlocal.shard_ingestion(
                fmt.files_from_command_line_args(files), self._mesh
            )
        local = self._mesh if self._hostlocal else None

        pipe = self._pipeline = df.DataPipeline(files)
        pipe.add_filter(load_data=df.LoadData(cores=getattr(args, "cores", None)))
        pipe.add_filter(df.RecodeNonseg(cutoff=getattr(args, "nonseg_cutoff", None)))
        pipe.add_filter(df.Compress())
        pipe.add_filter(df.BreakLongSpans(cutoff=100000))
        pipe.add_filter(df.DropSmallContigs(100000, mesh=local))
        pipe.add_filter(watterson=df.Watterson(mesh=local))
        pipe.add_filter(
            mutation_counts=df.CountMutations(
                w=int(2e-3 * self._N0 / self._rho), mesh=local
            )
        )

    # ------------------------------------------------------------------
    @property
    def populations(self):
        if self._headers is not None:
            # from the headers, in first-appearance (global file) order: the
            # same on every rank, whatever its shard holds
            pops = []
            for pid, _n, _a in self._headers:
                pops += [x for x in pid if x not in pops]
            return tuple(pops)
        return self._pipeline["load_data"].populations

    @property
    def npop(self):
        return len(self.populations)

    @property
    def contigs(self):
        return list(self._pipeline.results())

    # ------------------------------------------------------------------
    def _init_inference_manager(self, polarization_error, hs):
        """One manager per population tuple, one- or two-population
        (``make_manager``); the joint contigs of a pid must share their
        distinguished layout."""
        d = {}
        max_n = {}
        a_by_pid = {}
        # under host-local ingestion the pids, sample-size maxima and
        # distinguished layouts come from every file's header first: a rank's
        # shard may miss a pid, yet every rank must build the same managers
        # in the same order (their set-up collectives must line up)
        for pid, n, a in self._headers or ():
            d.setdefault(pid, [])
            cur = max_n.setdefault(pid, np.zeros(len(n), dtype=int))
            max_n[pid] = np.maximum(cur, n)
            a_by_pid.setdefault(pid, set()).add(tuple(a))
        for c in self.contigs:
            d.setdefault(c.pid, []).append(c)
            cur = max_n.setdefault(c.pid, np.zeros(len(c.n), dtype=int))
            max_n[c.pid] = np.maximum(cur, c.n)
            a_by_pid.setdefault(c.pid, set()).add(tuple(c.a))
        self._ims = {}
        prec = getattr(self._args, "precision", None)
        for pid in d:
            a = None  # a one-population manager takes a = 2
            if len(pid) == 2:
                if len(a_by_pid[pid]) != 1:
                    raise RuntimeError(
                        f"the joint contigs of {pid} place the distinguished "
                        f"lineages differently: {sorted(a_by_pid[pid])}"
                    )
                (a,) = a_by_pid[pid]
            im = make_manager(max_n[pid], a, [c.data for c in d[pid]], hs, pid,
                              polarization_error, device=self._device,
                              precision=prec, local_data=self._hostlocal)
            im.set_model(self._model)
            im.theta = self._theta
            im.rho = self._rho
            im.alpha = self._alpha = 1
            self._ims[pid] = im

    # ------------------------------------------------------------------
    def Q(self, y=None, theta=None, rho=None, alpha=None):
        yv = self._model.y if y is None else np.asarray(y)
        qq = sum(
            im.Q(y=yv, theta=theta, rho=rho, alpha=alpha)
            for im in self._ims.values()
        )
        reg = self._penalty * float(self._reg_batch(yv[None, :])[0])
        return qq - reg

    @property
    def has_fast_batch(self):
        "All managers expose batched Q."
        return all(
            getattr(im, "supports_qbatch", False) for im in self._ims.values()
        )

    def Q_batch(self, ys=None, rhos=None, coarse=False):
        """Penalized Q at a batch of candidate y rows / rho values; one
        batched evaluation per manager (see manager.Q_batch)."""
        tot = None
        for im in self._ims.values():
            v = im.Q_batch(ys=ys, rhos=rhos, fast_ok=coarse)
            tot = v if tot is None else tot + v
        if self._penalty and ys is not None:
            tot = tot - self._penalty * self._reg_batch(np.asarray(ys))
        return tot

    def _reg_batch(self, ys):
        "Roughness penalty of each row of ``ys`` (B, K), on the device."
        yt = torch.as_tensor(np.asarray(ys, np.float64), device=self._device)
        with torch.no_grad():
            return self._model.regularizer_fn(yt).cpu().numpy()

    def Q_and_grad(self, y=None):
        yv = self._model.y if y is None else np.asarray(y)
        q, g = 0.0, np.zeros_like(yv)
        for im in self._ims.values():
            qi, gi = im.Q_and_grad(y=yv)
            q += qi
            g += gi
        if self._penalty:
            yt = torch.as_tensor(
                np.asarray(yv, np.float64), device=self._device
            ).requires_grad_(True)
            rv = self._model.regularizer_fn(yt)
            (rg,) = torch.autograd.grad(rv, yt)
            q -= self._penalty * float(rv.detach())
            g -= self._penalty * rg.cpu().numpy()
        return q, g

    def E_step(self):
        for im in self._ims.values():
            im.E_step()

    def raise_precision(self):
        """Climb the E-step precision ladder on every manager
        (manager.PRECISION_LADDER); True if any manager had headroom."""
        raised = [im.raise_precision() for im in self._ims.values()]
        return any(r is not None for r in raised)

    def loglik(self, reg=True):
        ll = sum(im.loglik() for im in self._ims.values())
        if reg and self._penalty:
            ll -= self._penalty * self._regularizer_value()
        return ll

    def _regularizer_value(self):
        return float(self._reg_batch(np.asarray(self._model.y)[None, :])[0])

    # -- parameter plumbing (base.py:147-175)
    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, m):
        self._model = m
        for im in self._ims.values():
            im.set_model(m)

    @property
    def alpha(self):
        return self._alpha

    @alpha.setter
    def alpha(self, a):
        self._alpha = a
        for im in self._ims.values():
            im.alpha = a

    @property
    def rho(self):
        return self._rho

    @rho.setter
    def rho(self, r):
        self._rho = r
        for im in self._ims.values():
            im.rho = r

    @property
    def theta(self):
        return self._theta

    @theta.setter
    def theta(self, t):
        self._theta = t
        for im in self._ims.values():
            im.theta = t

    def run(self, niter=None):
        self._optimizer.run(niter or self._niter)

    def _broadcast(self, x):
        "Rank 0's values of the float array ``x`` (x itself alone)."
        if self._mesh is None:
            return x
        t = torch.as_tensor(np.asarray(x, np.float64), device=self._mesh.device)
        return mesh_mod.broadcast(self._mesh, t).cpu().numpy()

    def broadcast_parameters(self):
        """Every rank takes rank 0's fitted parameters (y and rho), after each
        M-step."""
        if self._mesh is None:
            return
        v = self._broadcast(np.r_[self._model.y, self._rho])
        self._model.y[:] = v[:-1]
        self.rho = float(v[-1])

    def dump(self, filename):
        d = {"theta": self._theta, "rho": self._rho, "alpha": self._alpha}
        d["model"] = self.model.to_dict()
        d["hidden_states"] = {
            pid[0] if isinstance(pid, tuple) else pid: list(map(float, self.hidden_states))
            for pid in self._ims
        }
        with open(filename + ".json", "w") as f:
            json.dump(d, f, sort_keys=True, indent=4)


class Analysis(BaseAnalysis):
    "One-population estimation with two-stage initialization (analysis.py)."

    def __init__(self, files, args):
        super().__init__(files, args)
        if self.npop != 1:
            raise RuntimeError("Use 'split' to estimate two-population models")

        NeN0 = self._pipeline["watterson"].theta_hat / (2.0 * args.mu * self._N0)
        m = SMCModel([1.0], self._N0, "piecewise", None)
        m.y[:] = np.log(NeN0)
        hs = estimation.balance_hidden_states(m, 2 + args.knots)
        if getattr(args, "timepoints", None) is not None:
            t1, tK = [x / 2 / self._N0 for x in args.timepoints]
        else:
            t1 = tK = None
        self.hidden_states = hs
        self._init_knots(hs, t1, tK)

        # ---- stage 1: constant model, trivial hidden states, 1 EM iteration
        self._init_model(args.spline)
        self.hidden_states = np.array([0.0, np.inf])
        self._init_inference_manager(args.polarization_error, self.hidden_states)
        self.alpha = 1
        self._model.y[:] = np.log(NeN0)
        self._model.randomize()
        self._init_optimizer(args, single=False, learn_rho=False, outdir=None)
        self._init_regularization(args)
        self.run(1)

        # ---- stage 2: thin/bin pipeline, empirical-TMRCA hidden states
        pipe = self._pipeline
        pipe.add_filter(df.Thin(thinning=getattr(args, "thinning", None)))
        pipe.add_filter(df.BinObservations(w=args.w))
        pipe.add_filter(df.RecodeMonomorphic())
        pipe.add_filter(df.Compress())
        pipe.add_filter(df.Validate())
        pipe.add_filter(df.DropUninformativeContigs(
            mesh=self._mesh if self._hostlocal else None))
        pipe.add_filter(df.Summarize())
        try:
            self._empirical_tmrca(2 * args.knots)
            hs = np.r_[0.0, self._etmrca_quantiles, np.inf]
            self.hidden_state_path = "empirical"
        except Exception as e:  # mirror reference fallback (analysis.py:67-73)
            logger.warning("Empirical TMRCA failed (%s); using balanced states", e)
            hs = estimation.balance_hidden_states(m, 2 * args.knots)
            self.hidden_state_path = "balanced"
        # every rank decodes on rank 0's states (the mixture fit runs on
        # each rank)
        hs = self._broadcast(hs)
        logger.info(
            "stage-2 hidden states: %s (M = %d)", self.hidden_state_path,
            len(hs) - 1,
        )
        self.hidden_states = hs
        self._init_knots(hs, t1, tK)
        old = self._model
        self._init_model(args.spline)
        self._model.set_knot_values(old(self._knots))
        self._init_inference_manager(args.polarization_error, self.hidden_states)
        self.alpha = args.w
        self._init_optimizer(
            args,
            single=not getattr(args, "multi", False),
            learn_rho=getattr(args, "r", None) is None,
            outdir=getattr(args, "outdir", None),
        )
        self._init_regularization(args)

    def _init_model(self, spline_class):
        self._model = SMCModel(
            self._knots, self._N0, spline_class, self.populations[0]
        )

    def _init_knots(self, hs, t1, tK):
        "analysis.py:104-116"
        self._knots = hs[1:-1:2]
        mult = np.mean(self._knots[1:] / self._knots[:-1])
        k0 = self._knots[0]
        t = t1 or k0
        a = []
        while t < k0:
            a = np.r_[a, t]
            t *= mult
        self._knots = np.r_[a, self._knots]
        if tK is not None and tK > self._knots[-1]:
            self._knots = np.r_[self._knots, tK]

    def _init_optimizer(self, args, single, learn_rho, outdir):
        self._optimizer = SMCPPOptimizer(
            self,
            algorithm=getattr(args, "algorithm", "L-BFGS-B"),
            xtol=getattr(args, "xtol", defaults.xtol),
            ftol=getattr(args, "ftol", defaults.ftol),
            single=single,
            learn_rho=learn_rho,
            outdir=outdir,
            base=getattr(args, "base", "model"),
        )

    def _init_regularization(self, args):
        if getattr(args, "lambda_", None):
            self._penalty = args.lambda_
        else:
            self.E_step()
            self._penalty = abs(self.Q()) * (
                10 ** -getattr(args, "regularization_penalty",
                               defaults.regularization_penalty)
            )
        logger.debug("Regularization penalty: lambda=%g", self._penalty)

    def _empirical_tmrca(self, k):
        "GMM quantiles of windowed mutation counts (analysis.py:136-152)."
        import scipy.stats.mstats
        import sklearn.mixture

        w = self._pipeline["mutation_counts"].w
        X = self._pipeline["mutation_counts"].counts
        gmm = sklearn.mixture.GaussianMixture(n_components=k).fit(X[:, None])
        Y = gmm.sample(n_samples=100000)[0]
        p = np.logspace(np.log10(0.01), np.log10(0.99), k)
        q = scipy.stats.mstats.mquantiles(Y[Y > 0], p) / (2 * self._theta * w)
        self._etmrca_quantiles = q
