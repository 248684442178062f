"""The MAP path's share of its roofline: the least time of one max-plus
pass over the cell's rows (roofline/work.py, bound by the ALU pipe at the
card's SM clock) over the ``map_paths`` span, in percent."""

from portbench.roofline import work


def read(run):
    s, sh = run.spans.get("viterbi"), run.window.get("shape")
    if not s or sh is None or not run.card:
        return None
    t, _ = work.viterbi_least_s(sh["spans"], sh["M"], run.card["sm_clock_mhz"])
    return 100.0 * t / (sum(s) / len(s))
