"""smc++ chunk: resample fixed-size chunks for bootstrapping."""

import logging

import numpy as np

from ..data import filters as df
from ..data import format as fmt
from . import command

logger = logging.getLogger(__name__)


class Chunk(command.Command, command.ConsoleCommand):
    "Chunk up data sets for bootstrap resampling"

    def __init__(self, parser):
        command.Command.__init__(self, parser)
        parser.add_argument("-w", type=int, default=int(5e6),
                            help="chunk size (bp)")
        parser.add_argument("n", type=int, help="number of chunks to draw")
        parser.add_argument("out_pattern",
                            help="output pattern, e.g. out/chunk.{}.smc.gz")
        parser.add_argument("data", nargs="+", metavar="data.smc[.gz]")

    def main(self, args):
        command.Command.main(self, args)
        files = fmt.files_from_command_line_args(args.data)
        contigs = fmt.load_data(files)
        chunks = []
        for c in contigs:
            d = df.realign(c.data, args.w)
            inds = np.where(np.cumsum(d[:, 0]) % args.w == 0)[0]
            chunks += [
                (c, x)
                for x in np.split(d, 1 + inds)
                if x[:, 0].sum() == args.w
            ]
        if not chunks:
            raise RuntimeError("no full-size chunks available")
        rng = np.random.RandomState(args.seed)
        for i in range(args.n):
            c, x = chunks[rng.randint(len(chunks))]
            # reconstruct dist/undist structure for the header
            dist = [[["sample", k] for k in range(a)] for a in c.a]
            undist = [[["sample_u", k] for k in range(n)] for n in c.n]
            fmt.write_contig(
                args.out_pattern.format(i), x, list(c.pid), dist, undist
            )
