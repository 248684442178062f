"""smc++ cv: cross-validated estimation (mirrors commands/cv.py).

The contigs are split into ``--folds`` folds; for each fold and each
regularization penalty of the sweep a model is fitted on the other folds
and scored by the held-out fold's log-likelihood.  A fold marks itself done
(``fold{i}/.done``), so a second run resumes without refitting it; the
mean of the folds' best models is written to ``model.final.json``.

Under a process group ``cv`` stays on the replicated driver: its folds are
contig subsets chosen after loading, which host-local file shards do not
map onto, so every process loads the full dataset (the E-step still shards
over the group)."""

import argparse
import contextlib
import gc
import json
import logging
import os
import shutil
import sys
from pathlib import Path

import numpy as np

from ..inference.analysis import Analysis
from ..models import model as model_mod
from . import command

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def mark_completed(path):
    p = Path(path, ".done")
    yield p
    p.touch()


class Cv(command.EstimationCommand, command.ConsoleCommand):
    "Perform cross-validated estimation procedure"

    def __init__(self, parser):
        super().__init__(parser)
        command.add_model_parameters(parser)
        command.add_pop_parameters(parser)
        parser.add_argument("--initial-model", help=argparse.SUPPRESS)
        parser.add_argument("--folds", type=int, default=2,
                            help="number of folds for cross-validation")
        parser.add_argument("--fold", type=int,
                            help="run a specific fold only")
        parser.add_argument("--rp-values",
                            type=lambda v: [int(x) for x in v.split(",")],
                            default=list(range(2, 10)),
                            help=argparse.SUPPRESS)
        parser.add_argument("data", nargs="+", help="data file(s) in SMC++ format")

    def main(self, args):
        command.EstimationCommand.main(self, args)
        args.replicated_data = True
        L = len(args.data)
        if not (2 <= args.folds <= L):
            sys.exit("--folds should be between 2 and the number of contigs")
        if args.fold is not None and not (0 <= args.fold < args.folds):
            sys.exit("--fold should be between 0 and --folds")
        folds = np.array_split(np.arange(L), args.folds)
        basedir = args.outdir
        best_models = [None] * len(folds)

        def fold_path(i):
            return os.path.join(basedir, f"fold{i}")

        def fit_folds():
            """Fit and score each fold not yet done; returns the last
            best model's record."""
            d = None
            for i, fold in enumerate(folds):
                if args.fold is not None and args.fold != i:
                    continue
                fp = fold_path(i)
                with mark_completed(fp) as p:
                    if p.exists():
                        with open(os.path.join(fp, "model.best.json")) as f:
                            d = json.load(f)
                            best_models[i] = model_mod.SMCModel.from_dict(d["model"])
                        continue
                    args.outdir = fp
                    os.makedirs(args.outdir, exist_ok=True)
                    test = Analysis(
                        [args.data[j] for j in range(L) if j in fold], args
                    )
                    best = float("-inf")
                    for j in args.rp_values:
                        args.regularization_penalty = j
                        train = Analysis(
                            [args.data[k] for k in range(L) if k not in fold], args
                        )
                        train.run()
                        test.model = train.model
                        test.E_step()
                        tl = test.loglik(False)
                        logger.info("rp=%d train=%f test=%f", j,
                                    train.loglik(True), tl)
                        if tl > best:
                            best = tl
                            best_models[i] = train.model
                            f = os.path.join(args.outdir, "model.best.json")
                            shutil.copyfile(
                                os.path.join(args.outdir, "model.final.json"), f
                            )
                            with open(f) as fh:
                                d = json.load(fh)
                    # an analysis and its optimizer refer to each other: collect
                    # them now, so that one fold's device tensors are freed
                    # before the next fold's are allocated
                    del test, train
                    gc.collect()
            return d

        d = command.run_profiled(fit_folds, args)

        if args.fold is not None:
            sys.exit(0)
        missing = [
            i for i in range(args.folds)
            if not Path(fold_path(i), ".done").exists()
        ]
        if missing:
            logger.error("Folds not completed: %s", missing)
            sys.exit(0)
        mavg = model_mod.aggregate(*best_models)
        d.update({"model": mavg.to_dict()})
        with open(os.path.join(basedir, "model.final.json"), "w") as f:
            json.dump(d, f, sort_keys=True, indent=4)
