"""smc++ estimate: fit one-population size history."""

import logging

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
        analysis.run()
        return analysis
