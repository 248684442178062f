"""smc++ estimate: fit one-population size history."""

import logging
import os

import torch

from ..inference.analysis import Analysis
from . import command

logger = logging.getLogger(__name__)


class Estimate(command.EstimationCommand, command.ConsoleCommand):
    "Estimate size history for one population"

    def __init__(self, parser):
        command.EstimationCommand.__init__(self, parser)
        command.add_pop_parameters(parser)
        command.add_model_parameters(parser)
        parser.add_argument("data", nargs="+", help="data file(s) in SMC++ format")

    def main(self, args):
        command.EstimationCommand.main(self, args)
        if not (1e-11 <= args.mu <= 1e-5):
            logger.warning("Mutation rate %g — is this correct?", args.mu)
        analysis = Analysis(args.data, args)
        if args.profile_dir:
            run_profiled(analysis, args.profile_dir,
                         torch.device(args.device).type == "cuda")
        else:
            analysis.run()
        return analysis


def run_profiled(analysis, profile_dir, cuda):
    """``analysis.run()`` under torch.profiler, host activity and, on a card,
    device activity; the Chrome trace goes to ``profile_dir``/trace.json."""
    tp = torch.profiler
    os.makedirs(profile_dir, exist_ok=True)
    activities = [tp.ProfilerActivity.CPU]
    if cuda:
        activities.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=activities) as prof:
        analysis.run()
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
