"""Shared argparse groups (mirrors SMC++ smcpp/commands/command.py)."""

import argparse
import logging
import os
import sys
import time

import numpy as np

from .. import defaults


def check_positive(value):
    iv = int(value)
    if iv <= 0:
        raise argparse.ArgumentTypeError(f"{value} is not a positive int")
    return iv


class ConsoleCommand:
    def __init__(self, parser):
        pass


class Command:
    def __init__(self, parser):
        parser.add_argument(
            "-v", "--verbose", action="count", default=0,
            help="increase debugging output",
        )
        parser.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
        parser.add_argument(
            "--cores", type=int, default=None,
            help="number of worker threads for host-side preprocessing",
        )
        parser.add_argument(
            "--device", default="cuda",
            help="torch device for the E-step kernels and the M-step "
                 "objective (default: cuda; 'cpu' runs the plain PyTorch "
                 "versions of the kernels)",
        )
        parser.add_argument(
            "--precision", default=None,
            choices=["default", "tensorfloat32", "highest"],
            help="E-step precision rung (default: bf16 carries, raised "
                 "automatically if the likelihood ever decreases; 'highest' "
                 "= f32 carries)",
        )
        dist = parser.add_argument_group(
            "multi-process execution (launch one process per device, on each "
            "host; or launch with torchrun, whose environment needs none of "
            "these flags)"
        )
        dist.add_argument(
            "--coordinator", default=None, metavar="HOST:PORT",
            help="torch.distributed rendezvous address (process 0's host)",
        )
        dist.add_argument(
            "--num-processes", type=check_positive, default=None,
            metavar="N", help="total number of processes in the job",
        )
        dist.add_argument(
            "--process-id", type=int, default=None, metavar="I",
            help="this process's rank in [0, N)",
        )
        dist.add_argument(
            "--replicated-data", action="store_true",
            help="load the FULL dataset on every process instead of the "
                 "default host-local ingestion (each process loads and "
                 "filters only its own contiguous shard of the input "
                 "files)",
        )

    def main(self, args):
        from ..parallel import distributed

        np.random.seed(args.seed)
        level = [logging.INFO, logging.DEBUG][min(args.verbose, 1)]
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
        distributed.maybe_initialize_from_args(args)


class EstimationCommand(Command):
    def __init__(self, parser):
        super().__init__(parser)
        add_common_estimation_args(parser)

    def main(self, args):
        if not os.path.isdir(args.outdir):
            os.makedirs(args.outdir)
        super().main(args)
        fh = logging.FileHandler(os.path.join(args.outdir, ".debug.txt"), "a")
        fh.setLevel(logging.DEBUG)
        logging.getLogger().addHandler(fh)
        logging.getLogger(__name__).debug(sys.argv)


def run_profiled(work, args):
    """``work()``, the command's work; with ``--profile-dir``, under
    torch.profiler (host activity and, on a card, the device's), its Chrome
    trace written to ``profile_dir``/trace.json with the program's spans
    (smcpp_tpu_torch/trace.py) added as events on the threads that ran
    them.  Returns what ``work`` returns."""
    if not args.profile_dir:
        return work()
    import torch

    from .. import trace

    tp = torch.profiler
    os.makedirs(args.profile_dir, exist_ok=True)
    activities = [tp.ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=activities) as prof:
        t0 = time.time_ns()
        out = work()
        t1 = time.time_ns()
    path = os.path.join(args.profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    trace.add_to_chrome_trace(path, trace.records(t0, t1))
    trace.clear()
    logging.getLogger(__name__).info("profiler trace written to %s", path)
    return out


def add_common_estimation_args(parser):
    parser.add_argument("-o", "--outdir", help="output directory", default=".")
    parser.add_argument("--base", default="model",
                        help="base name for output files ({base}.final.json, ...)")
    parser.add_argument("--timepoints", type=float, default=None, nargs=2,
                        help="start and end time of model (generations)")
    data = parser.add_argument_group("data parameters")
    data.add_argument("--length-cutoff", help=argparse.SUPPRESS, type=int, default=None)
    data.add_argument("--nonseg-cutoff", "-c", type=int,
                      help="recode nonsegregating spans > cutoff as missing")
    data.add_argument("--thinning", type=check_positive, default=None, metavar="k",
                      help="only emit full SFS every <k>th site")
    data.add_argument("-w", default=100, type=int,
                      help="window size for 0/1 block coding (default 100)")
    optimizer = parser.add_argument_group("optimization parameters")
    optimizer.add_argument("--no-initialize", action="store_true", default=False,
                           help=argparse.SUPPRESS)
    optimizer.add_argument("--em-iterations", type=int, default=20,
                           help="number of EM steps")
    optimizer.add_argument("--algorithm", choices=["Powell", "L-BFGS-B", "TNC"],
                           default="L-BFGS-B", help="optimization algorithm")
    optimizer.add_argument("--multi", default=False, action="store_true",
                           help="update multiple blocks of coordinates at once")
    optimizer.add_argument("--ftol", type=float, default=defaults.ftol,
                           help="relative loglik tolerance for EM termination")
    optimizer.add_argument("--xtol", type=float, default=defaults.xtol,
                           help="x tolerance for the optimizer")
    optimizer.add_argument("--Nmax", type=float,
                           default=defaults.maximum_population_size,
                           help="upper bound on scaled population size")
    optimizer.add_argument("--Nmin", type=float,
                           default=defaults.minimum_population_size,
                           help="lower bound on scaled population size")
    optimizer.add_argument("--regularization-penalty", "-rp", type=float,
                           default=defaults.regularization_penalty,
                           help="regularization penalty")
    optimizer.add_argument("--lambda", dest="lambda_", type=float,
                           help=argparse.SUPPRESS)
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler Chrome trace of the run "
                             "here (trace.json)")
    add_hmm_args(parser)


def add_hmm_args(parser):
    pol = parser.add_mutually_exclusive_group(required=False)
    pol.add_argument("--unfold", action="store_true", default=False,
                     help="use unfolded SFS (alias for -p 0.0)")
    pol.add_argument("--polarization-error", "-p", metavar="p", type=float,
                     default=0.5,
                     help="uncertainty parameter for polarized SFS")


def add_model_parameters(parser):
    model = parser.add_argument_group("model parameters")
    model.add_argument("--knots", type=int, default=defaults.knots,
                       help="number of spline knots")
    model.add_argument("--spline",
                       choices=["cubic", "pchip", "piecewise", "akima", "bspline"],
                       default=defaults.spline, help="model representation")
    return model


def add_pop_parameters(parser):
    pop = parser.add_argument_group("population-genetic parameters")
    pop.add_argument("mu", type=float,
                     help="mutation rate per base pair per generation")
    pop.add_argument("-r", type=float,
                     help="recombination rate per bp per generation "
                          "(default: estimate from data)")
    return pop
