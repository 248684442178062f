"""Milliseconds of the posterior decode proper: the synchronised span
around the manager's ``_compute_gammas`` (the window decode, or the row
route past its gate), the mean over the window's decodes."""


def read(run):
    s = run.spans.get("decode")
    return 1e3 * sum(s) / len(s) if s else None
