"""Contigs written in the SMC++ text format, the form in which the port's
commands read their data: a ``# SMC++ {json}`` header, then one
``span a b nb`` row a line."""

import json
import os

import numpy as np


def write(path, rows, n, pid="pop1"):
    "One population's contig: the distinguished pair and n undistinguished."
    header = {"version": "portbench", "pids": [pid],
              "dist": [[["d", 0], ["d", 1]]],
              "undist": [[["u", i] for i in range(n)]]}
    rows = np.asarray(rows, np.int64)
    with open(path, "w") as f:
        f.write("# SMC++ " + json.dumps(header) + "\n")
        f.write("".join([f"{s} {a} {b} {nb}\n" for s, a, b, nb in rows.tolist()]))
    return path


def write_all(directory, contigs, n):
    "Files c000.smc, c001.smc, ... in the contigs' order."
    return [write(os.path.join(directory, f"c{i:03d}.smc"), c, n)
            for i, c in enumerate(contigs)]
