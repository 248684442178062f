"""smc++ version."""

from ..version import version
from . import command


class Version(command.ConsoleCommand):
    "Print version information"

    def main(self, args):
        print("smcpp_tpu_torch " + version)
