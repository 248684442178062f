"""smc++ split: refine two-population models (split-time estimation)."""

import json
import logging

from . import command

logger = logging.getLogger(__name__)


class Split(command.EstimationCommand, command.ConsoleCommand):
    "Estimate split time in two-population model"

    def __init__(self, parser):
        super().__init__(parser)
        parser.add_argument("pop1", metavar="model1.final.json",
                            help="marginal fit for population 1")
        parser.add_argument("pop2", metavar="model2.final.json",
                            help="marginal fit for population 2")
        parser.add_argument("data", nargs="+", metavar="data.smc[.gz]",
                            help="joint-population data files")

    def main(self, args):
        """Run the split search and write ``model.final.json``; returns the
        analysis."""
        command.EstimationCommand.main(self, args)
        from ..inference.split import SplitAnalysis

        with open(args.pop1) as f:
            j = json.load(f)
        args.mu = j["theta"] / 2 / j["model"]["N0"]
        analysis = SplitAnalysis(args.data, args)
        command.run_profiled(lambda: analysis.run(niter=1), args)
        return analysis
