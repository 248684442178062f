"""smc++ cite: print citation information."""

from . import command

CITATION = """\
If you use this software, please cite the underlying method:

  Terhorst J, Kamm JA, Song YS. Robust and scalable inference of population
  history from hundreds of unphased whole genomes.
  Nature Genetics. 2017 Feb;49(2):303-309.

BibTeX:

@article{terhorst2017robust,
  title={Robust and scalable inference of population history from hundreds
         of unphased whole genomes},
  author={Terhorst, Jonathan and Kamm, John A and Song, Yun S},
  journal={Nature Genetics},
  volume={49},
  number={2},
  pages={303--309},
  year={2017},
  publisher={Nature Publishing Group}
}
"""


class Cite(command.ConsoleCommand):
    "Print citation information"

    def main(self, args):
        print(CITATION)
