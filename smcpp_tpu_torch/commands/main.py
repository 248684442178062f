"""Console entry point: subcommand registry (mirrors smcpp/frontend/console.py).

The port registers ``estimate``, ``version`` and ``cite``; the other
commands of the JAX package are not ported yet (ROADMAP A1, A5, A7, A9)."""

import argparse


def main(argv=None):
    from . import cite, estimate, version  # noqa: F401
    from .command import ConsoleCommand

    parser = argparse.ArgumentParser(prog="smc++")
    subparsers = parser.add_subparsers(dest="command", required=True)
    cmds = {}
    for cls in ConsoleCommand.__subclasses__():
        name = cls.__name__.lower()
        p = subparsers.add_parser(name, help=(cls.__doc__ or "").strip())
        cmds[name] = cls(p)
    args = parser.parse_args(argv)
    return cmds[args.command].main(args)


if __name__ == "__main__":
    main()
