"""smc++ plot: plot fitted size histories from model JSON files.

Port of smcpp_tpu/commands/plot.py, with the same flags.  Flag surface
and rendering semantics mirror SMC++ (smcpp/commands/plot.py): model
JSONs are drawn as path-rendered stepwise samples by default,
``-s/--step-function`` switches to step rendering, the y axis is
log-scaled unless
``--linear``, ``-t/--offsets`` shifts each model's x axis (aDNA), the
builtin names ``human``/``sawtooth`` plot the preset demographies, and
the second population of a two-pop model is truncated at the split time
with a vertical line marking it.

Intentional divergence from the reference: when both ``-t`` offsets and a
two-pop model are given, the split vline is shifted by that model's offset
(the reference leaves vlines unshifted, which would misplace the split
marker relative to the offset curves).
"""

import json
import logging
import os
import sys

import numpy as np

from .. import plotting, util
from . import command

logger = logging.getLogger(__name__)


class Plot(command.Command, command.ConsoleCommand):
    "Plot size history from fitted model(s)"

    def __init__(self, parser):
        import argparse

        command.Command.__init__(self, parser)
        parser.add_argument("-g", type=float,
                            help="years per generation (x axis in years)")
        parser.add_argument("-s", "--step-function", action="store_true",
                            help="plot the piecewise-constant "
                                 "representation with step rendering")
        parser.add_argument("--linear", action="store_true",
                            help="plot y on a linear axis (default: log)")
        # historical spelling of the (now-default) log y axis
        parser.add_argument("--logy", action="store_true",
                            help=argparse.SUPPRESS)
        parser.add_argument("-c", "--csv", action="store_true",
                            help="also write a CSV of the plotted values")
        parser.add_argument("-t", "--offsets", type=float, nargs="+",
                            default=None,
                            help="list of offsets, one per <model>, to "
                                 "shift x axes (mainly for aDNA)")
        parser.add_argument("-x", "--xlim", type=float, nargs=2, default=None)
        parser.add_argument("-y", "--ylim", type=float, nargs=2, default=None)
        parser.add_argument("-k", "--knots", action="store_true",
                            help="also plot the spline knots")
        parser.add_argument("pdf", metavar="plot.(pdf|png|jpeg)")
        parser.add_argument("model", nargs="+",
                            metavar="model.final.json|human|sawtooth")

    def main(self, args):
        command.Command.main(self, args)
        offsets = args.offsets or []
        if offsets and len(offsets) != len(args.model):
            sys.exit("Please specify one offset per model")
        psfs = []
        vlines = []
        for i, fn in enumerate(args.model):
            off = offsets[i] if offsets else 0.0
            if fn in ("human", "sawtooth"):
                d = dict(getattr(util, fn))
                d["g"] = args.g
                d["off"] = off
                psfs.append((fn, d))
                continue
            if not os.path.exists(fn):
                sys.exit("File not found: %s" % fn)
            d = json.load(open(fn))
            for label, series in plotting.model_to_plot_dict(
                d, step=args.step_function
            ):
                series["g"] = args.g
                series["off"] = off
                if "vline" in series:
                    vlines.append(
                        series.pop("vline")
                        * 2.0 * series["N0"] * (args.g or 1)
                        + off
                    )
                psfs.append((label or fn, series))
        xlabel = "Years" if args.g else "Generations"
        fig, data = plotting.plot_psfs(
            psfs, args.xlim, args.ylim, xlabel,
            knots=args.knots, logy=not args.linear, vlines=vlines,
        )
        fig.savefig(args.pdf)
        if args.csv:
            import csv

            base = args.pdf.rsplit(".", 1)[0]
            with open(base + ".csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["label", "x", "y", "plot_type", "plot_num"])
                for row in data[1:]:
                    label, x, y, pt, pn = row
                    for xx, yy in zip(x, y):
                        w.writerow([label, xx, yy, pt, pn])
