"""smc++ vcf2smc: convert a VCF contig to the SMC++ data format."""

import argparse
import logging

from ..data.vcf import SampleList, vcf2smc
from . import command

logger = logging.getLogger(__name__)


def sample_list(x):
    try:
        x1, x2 = x.split(":")
        return SampleList(x1, x2.split(","))
    except Exception:
        raise argparse.ArgumentTypeError(
            f"{x!r} should be <pop_id>:<sample1>,<sample2>,..."
        )


class Vcf2Smc(command.Command, command.ConsoleCommand):
    "Convert VCF to SMC++ format"

    def __init__(self, parser):
        command.Command.__init__(self, parser)
        parser.add_argument("-d", nargs=2, metavar="sample_id",
                            help="identity of the distinguished lineages")
        parser.add_argument("--length", "-l", type=int,
                            help="contig length (default: VCF header)")
        parser.add_argument("--ignore-missing", default=False, action="store_true",
                            help="ignore samples missing from the data")
        parser.add_argument("--missing-cutoff", "-c", metavar="c", type=int,
                            default=None,
                            help="treat homozygous runs longer than c bp as missing")
        parser.add_argument("--mask", "-m", help="BED-formatted mask of missing regions")
        parser.add_argument("--drop-first-last", action="store_true")
        parser.add_argument("vcf", metavar="vcf[.gz]", help="VCF file")
        parser.add_argument("out", metavar="out[.gz]", help="output SMC++ file")
        parser.add_argument("contig", help="contig to parse")
        parser.add_argument("pop1", type=sample_list,
                            help="<pop_id>:<sample1>,<sample2>,...")
        parser.add_argument("pop2", type=sample_list, nargs="?",
                            default=SampleList(None, []))

    def main(self, args):
        command.Command.main(self, args)
        if args.missing_cutoff and args.mask:
            raise RuntimeError("--missing-cutoff and --mask are mutually exclusive")
        for attr in ("pop1", "pop2"):
            pid, ary = getattr(args, attr)
            if len(ary) == 1 and ary[0].startswith("@"):
                setattr(args, attr, SampleList(
                    pid, open(ary[0][1:]).read().strip().split("\n")))
        vcf2smc(
            args.vcf, args.out, args.contig, args.pop1, args.pop2,
            distinguished=args.d, length=args.length,
            missing_cutoff=args.missing_cutoff, mask=args.mask,
            drop_first_last=args.drop_first_last,
            ignore_missing=args.ignore_missing,
        )
