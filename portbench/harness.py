"""The benchmark's run of one cell: find the cell's files by name, build its
state, measure a window, read the per-layer metrics, check the outputs
against the reference, and print the one result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the deployment (sample, model, rates, genome);
* ``traffic/<traffic>.json``: the mix, data read by the entry it names;
* ``entries/<entry>.py``: the code that drives one kind of traffic through
  the port's entry points (``setup``, ``window``, ``end_to_end``,
  ``release``, ``check``);
* ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.
"""

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "smcpp_tpu")


class Refused(Exception):
    "A run that must print no result and exit with a code other than 0."


def process_start():
    "The wall-clock time (time.time()) at which this process started."
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    "A module from its file, under a name made from the file's path."
    name = "portbench_" + os.path.relpath(path, HERE).replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name, bench=None, traffic_dir=None):
    """(workload entry, configuration dict, traffic dict, benchmark dict) of
    the cell ``name``, each file found by its name."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(traffic_dir or os.path.join(HERE, "traffic"),
                                     cell["traffic"] + ".json"))
    return cell, cfg, traffic, bench


def metrics_of(bench, cell_name, kind):
    """The cell's metrics of one kind ('end_to_end' or 'per_layer'): those
    that list the cell, or list no cells and move a metric the cell
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in names else [])]


def card():
    """The card's name, power limit and maximum SM clock from nvidia-smi,
    and torch's device name; a run without a card is refused."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    name, power, clock = ([s.strip() for s in smi[0].split(",")] + ["", "", ""])[:3]
    return {"kind": torch.cuda.get_device_name(0), "smi_name": name,
            "power_limit_w": power, "sm_clock_mhz": clock,
            "count": torch.cuda.device_count()}


class Run:
    """One run of one cell: what the entry, the metric readers and the check
    share.  ``span`` times a layer in the traced run (the device
    synchronised at both ends, and the range named in the profiler's
    trace); in the untimed run it costs nothing.  ``part`` times a part of
    set-up, in every run."""

    def __init__(self, cell, cfg, traffic, seed, seconds, traced, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device = device
        self.spans = {}
        self.counters = {}
        self.parts = {}
        self.window = {}
        self.trace = None
        self.state = None
        self.card = None
        self._open = {}

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name):
        if not self.traced:
            yield
            return
        import torch

        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench." + name):
            yield
            self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def open_span(self, name):
        """Start a span that ``close_span`` ends, for a layer that has no
        single call to wrap (traced run only)."""
        if self.traced and name not in self._open:
            import torch

            self.sync()
            rf = torch.profiler.record_function("portbench." + name)
            rf.__enter__()
            self._open[name] = (rf, time.perf_counter())

    def close_span(self, name):
        if name in self._open:
            self.sync()
            rf, t0 = self._open.pop(name)
            rf.__exit__(None, None, None)
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def count(self, name, k=1):
        self.counters[name] = self.counters.get(name, 0) + k

    @contextlib.contextmanager
    def part(self, name):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t0


class Trace:
    """torch.profiler over a part of the traced window: the device's busy
    time (the union of the intervals in which an operation ran on it), the
    operations that took most time, and the idle gaps by the benchmark span
    that was open on the host."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None

    def start(self):
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self):
        import torch

        if self.t1 is None:
            torch.cuda.synchronize()
            self.t1 = time.time_ns()
            self.prof.stop()

    @staticmethod
    def _ns(e, what):
        f = getattr(e, what + "_ns", None)
        return f() if f is not None else getattr(e, what + "_us")() * 1000

    def read(self):
        """(busy_s, window_s, device_ops, idle_gaps) of the traced part."""
        events = self.prof.profiler.kineto_results.events()
        dev, spans = [], []
        for e in events:
            t = str(e.device_type())
            if t.endswith("CUDA") and not e.name().startswith("portbench."):
                s = self._ns(e, "start")
                dev.append((s, s + self._ns(e, "duration"), e.name()))
            elif not t.endswith("CUDA") and e.name().startswith("portbench."):
                s = self._ns(e, "start")
                spans.append((s, s + self._ns(e, "duration"), e.name()[10:]))
        lo, hi = self.t0, self.t1
        dev = [(max(s, lo), min(t, hi), n) for s, t, n in dev if t > lo and s < hi]
        by_name = {}
        for s, t, n in dev:
            by_name[n] = by_name.get(n, 0) + (t - s)
        merged = []
        for s, t, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged)
        gaps, prev = {}, lo
        for s, t in merged + [[hi, hi]]:
            if s > prev:
                mid = (prev + s) / 2
                open_ = [sp for sp in spans if sp[0] <= mid < sp[1]]
                name = min(open_, key=lambda sp: sp[1] - sp[0])[2] if open_ else "harness"
                gaps[name] = gaps.get(name, 0) + (s - prev)
            prev = max(prev, t)
        top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return busy / 1e9, (hi - lo) / 1e9, top(by_name), top(gaps)


def forbidden_modules():
    "Loaded modules whose top-level name is one no run may load."
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(run, ok, attempted, failed, metrics, device, breakdown, checks):
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup_parts_s"] = run.parts
    out["window"] = {k: v for k, v in run.window.items()
                     if k in ("units", "fits", "fit_s", "seconds")}
    # a check that could not be computed (no gain to compare, a layout that
    # differs) reads inf: written as a string, so the line stays JSON
    out["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                     for n, v, lim in checks}
    return json.dumps(out)


def execute(workload, seed, seconds, traced, device_name="cuda", bench=None,
            need_card=True, traffic_dir=None, cfg=None):
    """Run one cell once; returns (result line, stderr lines).  Raises
    Refused where no result may be printed.  ``cfg`` in place of the
    configuration's file serves the control alone."""
    import torch

    started = process_start()
    cell, cfg_file, traffic, bench = find_cell(workload, bench, traffic_dir)
    cfg = cfg or cfg_file
    dev = None
    if need_card:
        dev = card()
        if dev["count"] < cell["chips"]:
            raise Refused(f"{dev['count']} cards, the cell asks for {cell['chips']}")
    entry = load_module(os.path.join(HERE, "entries", traffic["entry"] + ".py"))
    run = Run(cell, cfg, traffic, seed, seconds, traced, torch.device(device_name))
    run.card = dev
    run.state = entry.setup(run)
    run.spans, run.counters = {}, {}
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if traced and cuda:
        run.trace = Trace()
    setup_s = time.time() - started
    entry.window(run)  # fills run.window: start, end, units, ...
    if run.trace is not None:
        run.trace.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = entry.end_to_end(run)
    e2e["peak_gb"] = peak / 1e9
    e2e["setup_s"] = setup_s
    metrics, breakdown, device = {}, None, {
        "platform": "gpu" if cuda else "cpu",
        "kind": dev["kind"] if dev else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(peak),
    }
    if traced:
        if run.trace is not None:
            busy, window_s, ops, gaps = run.trace.read()
            device["busy_s"], device["window_s"] = busy, window_s
            run.window["busy_s"], run.window["trace_s"] = busy, window_s
            breakdown = {"device_ops": ops, "idle_gaps": gaps}
        for m in metrics_of(bench, workload, "per_layer"):
            v = load_module(os.path.join(HERE, "metrics", m["name"] + ".py")).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    entry.release(run)
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = entry.check(run)
    ok = failed == 0 and all(v <= lim for _, v, lim in checks)  # NaN fails too
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules loaded that no run may load: {bad}")
    err = [f"setup part {k}: {v:.3f} s" for k, v in run.parts.items()]
    err += [f"check {n}: {v:.6g} (limit {lim:.6g})" for n, v, lim in checks]
    line = result_line(run, ok, run.window["units"], failed, metrics, device,
                       breakdown, checks)
    return line, err
