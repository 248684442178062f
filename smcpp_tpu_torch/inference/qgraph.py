"""The one-population Q programs as captured CUDA graphs, one a batch shape.

A Q evaluation (manager ``Q_batch``, ``q_rho_batch``, ``tensors()``) is a
fixed program of about 700 small kernels for a given grid, n, dtype and
row count: its constants are resident (ops/qconst.py) and nothing in it
depends on the data.  Run eagerly, the host dispatches it op by op while
the card waits.  ``QGraphs`` captures each program once as a
``torch.cuda.CUDAGraph`` and replays it:

* a key names the program, its dtype and rows, and every Python float the
  capture bakes into kernel arguments (theta, alpha); a key runs eagerly
  the first time it is seen, is captured the second time and replays from
  then on, so a shape seen once never pays a capture;
* the inputs (candidate y rows, rhos) go through a pinned host buffer into
  static device buffers before each replay; the outputs are the graph's
  own, which the caller reads (or copies) at once, before the next replay;
* every graph of one ``QGraphs`` shares one memory pool, and its static
  inputs lie outside it; at most ``cap`` graphs are kept, the least
  recently used dropped first; ``clear()`` drops them all (a new grid or
  model: the arrays the graphs read are gone);
* eager runs, captures and replays all go on one stream of the Q
  programs' own, one a device for the process (``run``).

On the CPU nothing is captured.  ``captures``, ``replays`` and ``eager``
count the calls that captured, replayed and ran eagerly (a capture replays
too), as manager._Program counts launches; ``capture_s`` is the host time
the captures took.  Spans (smcpp_tpu_torch/trace.py): ``q.capture`` around
a capture, ``q.graph`` around a replay.
"""

import collections
import time

import numpy as np
import torch

from .. import trace

# the Q programs' stream of each device (``QGraphs.run``), shared by every
# manager of the process on purpose: cuBLAS keeps a 32 MiB workspace for
# each stream it has run on, so a stream a manager would cost one each
_STREAMS = {}


def _stream(device):
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


class _Graph:
    "One captured program: its pinned and static inputs, graph and outputs."

    def __init__(self, inputs, device):
        self.host = [torch.empty(np.shape(x), dtype=torch.float64, pin_memory=True)
                     for x in inputs]
        self.dev = [torch.empty(np.shape(x), dtype=torch.float64, device=device)
                    for x in inputs]
        self.copied = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        self.out = None

    def load(self, inputs):
        "The inputs into the static buffers, through the pinned ones."
        self.copied.synchronize()  # the last load has left the pinned buffers
        for h, d, x in zip(self.host, self.dev, inputs):
            h.numpy()[...] = x
            d.copy_(h, non_blocking=True)
        self.copied.record()

    def replay(self, inputs):
        self.load(inputs)
        self.graph.replay()
        return self.out


class QGraphs:
    """A manager's captured Q programs (module docstring)."""

    CAP = 32

    def __init__(self, device, cap=CAP):
        self.device = torch.device(device)
        self.capture_on = self.device.type == "cuda"
        self.cap = cap
        self._graphs = collections.OrderedDict()
        self._seen = collections.OrderedDict()
        self._pool = None
        self.captures = self.replays = self.eager = 0
        self.capture_s = 0.0

    def __len__(self):
        return len(self._graphs)

    def clear(self):
        """Drop every graph and every key seen.  The pool goes with them: a
        pool whose graphs are all gone takes no new capture."""
        self._graphs.clear()
        self._seen.clear()
        self._pool = None

    def run(self, key, fn, inputs, copy=False):
        """``fn(*tensors)`` at the host arrays ``inputs`` (f64, on the
        device): a tensor or a tuple of tensors.  A replay's outputs are
        the graph's, valid until its next replay; ``copy`` returns copies.

        On a GPU every run, eager, captured or replayed, goes on the Q
        programs' stream, ordered after the caller's and before what the
        caller does next: a capture needs a stream other than the default,
        and one stream for every run keeps one cuBLAS workspace for them
        all."""
        if self.device.type != "cuda":
            out, replayed = self._run(key, fn, inputs)
        else:
            cur = torch.cuda.current_stream(self.device)
            side = _stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out, replayed = self._run(key, fn, inputs)
            cur.wait_stream(side)
            if not replayed:  # made on this stream, used on the caller's
                for x in out if isinstance(out, tuple) else (out,):
                    x.record_stream(cur)
        if copy and replayed:
            return tuple(x.clone() for x in out) if isinstance(out, tuple) else out.clone()
        return out

    def _run(self, key, fn, inputs):
        "(outputs, whether they are a graph's)."
        g = self._graphs.get(key)
        if g is None:
            if not self.capture_on or key not in self._seen:
                self._see(key)
                self.eager += 1
                return fn(*(torch.as_tensor(np.asarray(x, np.float64), device=self.device)
                            for x in inputs)), False
            del self._seen[key]
            t = time.perf_counter()
            with trace.span("q.capture"):
                g = self._capture(fn, inputs)
            self.capture_s += time.perf_counter() - t
            self.captures += 1
            self._graphs[key] = g
            while len(self._graphs) > self.cap:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        with trace.span("q.graph"):
            out = g.replay(inputs)
        self.replays += 1
        return out, True

    def _see(self, key):
        self._seen[key] = None
        self._seen.move_to_end(key)
        while len(self._seen) > 4 * self.cap:
            self._seen.popitem(last=False)

    def _capture(self, fn, inputs):
        """Capture ``fn`` on static inputs holding ``inputs``, on the
        current stream (``run``'s own), into the shared pool (a new one
        after ``clear``).  The key ran eagerly on the same stream before,
        so whatever its kernels set up on first use exists already."""
        g = _Graph(inputs, self.device)
        g.load(inputs)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        g.graph.capture_begin(self._pool, capture_error_mode="thread_local")
        try:
            g.out = fn(*g.dev)
        finally:
            g.graph.capture_end()
        return g
