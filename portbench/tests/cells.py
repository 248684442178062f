"""Tiny cells of each entry for the CPU tests: the real configurations
with a small sample and genome (tests/data), run through the harness on the
CPU with the port's plain paths."""

import copy
import json
import os

from portbench import harness

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TINY = {"posterior.tiny": ("tiny_n6", "posterior.human_n20.chr15"),
        "fit.tiny": ("tiny_n8", "fit.human_n100")}
SEED = 2**31 + 7  # more than 32 signed bits hold


def bench():
    "BENCHMARK.json with the tiny cells beside the real ones."
    b = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    b = copy.deepcopy(b)
    for cell, (conf, like) in TINY.items():
        b["configs"].append({"name": conf, "file": f"portbench/tests/data/{conf}.json"})
        b["workloads"].append({"name": cell, "config": conf, "traffic": cell, "chips": 1})
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    return b


def run(cell, traced=False, seconds=2.0, seed=SEED):
    "The result line of one run of a tiny cell on the CPU, parsed."
    line, err = harness.execute(cell, seed, seconds, traced, "cpu", bench=bench(),
                                need_card=False, traffic_dir=DATA)
    return json.loads(line), err
