"""smc++ simulate: simulate data under a fitted model.

Two engines:
- ``msprime`` (the reference's approach, commands/simulate.py): coalescent
  simulation with recombination, VCF output.  Requires msprime.
- ``hmm``: the framework's own generative process (hidden TMRCA path +
  CSFS emissions, data/simulate.py), writing SMC++-format data directly.
  Used for parameter-recovery validation and available everywhere.
"""

import json
import logging
import sys

from ..models import model_from_dict
from . import command

logger = logging.getLogger(__name__)


class Simulate(command.Command, command.ConsoleCommand):
    "Simulate from a fitted model"

    def __init__(self, parser):
        command.Command.__init__(self, parser)
        parser.add_argument("model", metavar="model.final.json")
        parser.add_argument("n", type=int, help="diploid sample size")
        parser.add_argument("length", type=float, help="sequence length")
        parser.add_argument("output",
                            metavar="output.vcf[.gz] | output.smc[.gz]")
        parser.add_argument("--contig-id", default="1")
        parser.add_argument("-r", type=float, default=1e-8,
                            help="recombination rate")
        parser.add_argument("-u", type=float, default=1.25e-8,
                            help="mutation rate")
        parser.add_argument("--engine", choices=["msprime", "hmm"],
                            default="msprime",
                            help="msprime: coalescent simulation to VCF; "
                                 "hmm: the model's own generative HMM to "
                                 "SMC++ format (no msprime needed)")

    def main(self, args):
        command.Command.main(self, args)
        j = json.load(open(args.model))
        m = model_from_dict(j["model"])
        if args.engine == "hmm":
            from ..data.simulate import write_simulated

            dm = m.distinguished_model
            theta = 2 * dm.N0 * args.u
            rho = 2 * dm.N0 * args.r
            n_undist = 2 * args.n - 2
            write_simulated(
                args.output, dm, theta, rho, int(args.length), n_undist,
                seed=args.seed, pid=dm.pid or "pop1",
            )
            logger.info("wrote %s (SMC++ format)", args.output)
            return
        try:
            import msprime as msp
        except ImportError:
            sys.exit(
                "msprime is not installed; use --engine hmm for the "
                "built-in generative simulator"
            )
        events = m.to_msp()
        npop = getattr(m, "NPOP", 1)
        pop_configs = [
            msp.PopulationConfiguration(sample_size=2 * args.n)
            for _ in range(npop)
        ]
        ts = msp.simulate(
            population_configurations=pop_configs,
            demographic_events=events,
            length=args.length,
            recombination_rate=args.r,
            mutation_rate=args.u,
        )
        opener = __import__("gzip").open if args.output.endswith(".gz") else open
        with opener(args.output, "wt") as f:
            ts.write_vcf(f, ploidy=2, contig_id=args.contig_id)
