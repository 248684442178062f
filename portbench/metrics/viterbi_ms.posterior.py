"""Milliseconds of the MAP path: the synchronised span around the
manager's ``map_paths``, the mean over the window's decodes."""


def read(run):
    s = run.spans.get("viterbi")
    return 1e3 * sum(s) / len(s) if s else None
