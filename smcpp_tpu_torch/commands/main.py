"""Console entry point: subcommand registry (mirrors smcpp/frontend/console.py).

The port has every subcommand of the JAX package: ``vcf2smc``, ``estimate``,
``cv``, ``split``, ``posterior``, ``chunk``, ``simulate``, ``plot``,
``version`` and ``cite``.  ``plot`` imports matplotlib only when it draws."""

import argparse

from ..parallel import distributed


def main(argv=None):
    from . import (  # noqa: F401
        chunk, cite, cv, estimate, plot, posterior, simulate, split,
        vcf2smc, version,
    )
    from .command import ConsoleCommand

    parser = argparse.ArgumentParser(prog="smc++")
    subparsers = parser.add_subparsers(dest="command", required=True)
    cmds = {}
    for cls in ConsoleCommand.__subclasses__():
        name = cls.__name__.lower()
        p = subparsers.add_parser(name, help=(cls.__doc__ or "").strip())
        cmds[name] = cls(p)
    args = parser.parse_args(argv)
    out = cmds[args.command].main(args)
    # a multi-process job (parallel/distributed.py) leaves its group
    # together; a single process has none
    distributed.shutdown(barrier=True)
    return out


if __name__ == "__main__":
    main()
