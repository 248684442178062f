"""Rank process for tests/test_torch_parallel.py and
tests/test_torch_distributed.py: joins a gloo group of CPU ranks through
smcpp_tpu_torch.parallel.distributed, runs the sharded E-step, decode and
Viterbi (the window functions under a mesh; the span functions with the
collectives of smcpp_tpu_torch.parallel.mesh after them, as the manager
calls them) on seeded problems, and writes what it got to
<out>/rank<r>.npz.

    python _torch_dist_worker.py <task> <rank> <world> <init_method> <out>

The problems (``*_problem``) are the inputs of tests/test_parallel.py and
tests/_distributed_worker.py, made from the same seeds; the test process
builds them again for the one-process and JAX oracles.
"""

import faulthandler
import os
import signal
import sys
import time

import numpy as np

HS = np.r_[0.0, np.logspace(-1.2, 0.6, 7), np.inf]


def span_problem(seed, M, nk, C, L):
    "Random span-kernel inputs (test_parallel.py:18-25), f64."
    rng = np.random.RandomState(seed)
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.1, 1.0, (nk, M))
    spans = rng.geometric(0.3, size=(C, L)).astype(np.int32)
    keys = rng.randint(0, nk, size=(C, L)).astype(np.int32)
    return pi, T, E, spans, keys


def window_problem(seed, n_contigs=5, max_span=20, rows=(20, 60), seg_target=32):
    """Random window-kernel inputs (test_parallel.py:121-139), f64: returns
    (pi, T, E, keys, valid, seg_of_contig, row spans per contig)."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    rng = np.random.RandomState(seed)
    nk = 9
    data = []
    for _ in range(n_contigs):
        r = rng.randint(*rows)
        data.append(np.c_[rng.randint(1, max_span, r),
                          rng.randint(0, nk, r)].astype(np.int64))
    key_id = {(k,): k for k in range(nk)}
    M = 4
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.1, 1.0, (nk, M))
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=seg_target)
    return pi, T, E, keys, valid, soc, [d[:, 0] for d in data]


# the window problems of test_parallel.py's window cases (seeds 2, 3, 5)
WINDOW_CASES = {"window": (2, {}), "direct": (3, {}),
                "no_stream": (5, dict(n_contigs=3, max_span=10, rows=(30, 31),
                                      seg_target=16))}


def manager_data(span_range):
    "The contigs of test_parallel.py:_synth_contigs (seed 7, n = 4)."
    rng = np.random.RandomState(7)
    n, data = 4, []
    for _ in range(3):
        rows = rng.randint(30, 70)
        sp = rng.randint(*span_range, rows)
        a = rng.randint(0, 3, rows)
        b = rng.randint(0, n + 1, rows)
        data.append(np.c_[sp, a, b, np.full(rows, n)].astype(np.int64))
    return n, data


def make_manager(data, n, mesh=None):
    "The port's manager of test_parallel.py:_make_im, on the CPU."
    from smcpp_tpu_torch.inference.manager import OnePopInferenceManager
    from smcpp_tpu_torch.models import SMCModel

    im = OnePopInferenceManager(n, data, HS, ("p",), 0.5, device="cpu",
                                mesh=mesh)
    m = SMCModel(np.array([0.05, 0.3, 1.5]), 1e4, "piecewise")
    m.y[:] = 0.2
    im.set_model(m)
    im.theta = 1e-4
    im.rho = 1e-4
    return im


def _t(*xs, dtype=None):
    import torch

    return tuple(torch.as_tensor(np.asarray(x), dtype=dtype) for x in xs)


def _np(x):
    return x.detach().cpu().numpy()


def run_parallel(mesh):
    "Every sharded E-step, decode and Viterbi on the seeded problems."
    import torch

    from smcpp_tpu_torch.ops import hmm
    from smcpp_tpu_torch.ops import window_kernel as wk
    from smcpp_tpu_torch.parallel import mesh as mm

    f64 = torch.float64
    out = {}
    for tag, (seed, M, nk, C, L) in {"span8": (0, 8, 12, 8, 64),
                                     "span5": (1, 4, 6, 5, 32)}.items():
        pi, T, E, spans, keys = span_problem(seed, M, nk, C, L)
        nbits = int(spans.max()).bit_length()
        sp, ky = _t(*(mm.local_block(mesh, mm.pad_rows(x, mesh.size))
                      for x in (spans, keys)))
        args = (*_t(pi, T, E, dtype=f64), sp, ky, nbits)
        for i, x in enumerate(hmm.estep(*args, 16)):
            out[f"{tag}_estep{i}"] = _np(mm.reduce_sum(mesh, x.to(f64)))
        out[f"{tag}_decode"] = _np(mm.gather_rows(
            mesh, hmm.decode_gammas(*args, 16)))[:C]
        out[f"{tag}_viterbi"] = _np(mm.gather_rows(
            mesh, hmm.viterbi_paths(*args)))[:C]
    for tag, (seed, kw) in WINDOW_CASES.items():
        pi, T, E, keys, valid, soc, row_spans = window_problem(seed, **kw)
        kl, vl = _t(*(mm.local_block(mesh, x)
                      for x in mm.pad_segments(keys, valid, mesh.size)))
        tens = _t(pi, T, E, dtype=f64)
        for i, x in enumerate(wk.estep_direct(*tens, kl, vl, soc, mesh=mesh)):
            out[f"{tag}_estep{i}"] = _np(x)
        ends = torch.as_tensor(wk.pack_window_row_ends(row_spans, keys.shape[1], soc))
        ll, g = wk.decode_gammas_windows(*tens, kl, vl, soc, ends, mesh=mesh)
        out[f"{tag}_decode_ll"], out[f"{tag}_decode"] = _np(ll), _np(g)
        out[f"{tag}_viterbi"] = _np(wk.viterbi_windows(
            *tens, kl, vl, soc, ends, mesh=mesh))
        if tag == "direct":  # alpha remat through the sharded E-step
            B = wk.remat_block_size(keys.shape[1])
            for i, x in enumerate(wk.estep_direct(*tens, kl, vl, soc, alpha_remat=B,
                                                  mesh=mesh)):
                out[f"remat_estep{i}"] = _np(x)
    for tag, rng_ in (("mgr_window", (1, 12)), ("mgr_span", (2000, 9000))):
        n, data = manager_data(rng_)
        im = make_manager(data, n, mesh)
        out[f"{tag}_kernel"] = np.int64(im._use_windows)
        out[f"{tag}_ll"] = np.float64(im.E_step())
        for i, s in enumerate(im._stats):
            out[f"{tag}_stats{i}"] = s
        q, g = im.Q_and_grad()
        out[f"{tag}_q"], out[f"{tag}_grad"] = np.float64(q), g
        pi, T, E = im.tensors()
        out[f"{tag}_gammas"] = np.concatenate(
            im._compute_gammas(*(x.float().contiguous() for x in (pi, T, E))))
        out[f"{tag}_map"] = np.concatenate(im.map_paths())
    return out


def run_window_estep(mesh):
    """tests/_distributed_worker.py's case: each rank places only its block
    of the segment rows of the seed-2 problem (f64)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk
    from smcpp_tpu_torch.parallel import mesh as mm

    pi, T, E, keys, valid, soc, _ = window_problem(2)
    keys, valid = mm.pad_segments(keys, valid, mesh.size)
    kl, vl = _t(mm.local_block(mesh, keys), mm.local_block(mesh, valid))
    ll, g0, xi, gs = wk.estep_direct(
        *_t(pi, T, E, dtype=torch.float64), kl, vl, soc, mesh=mesh)
    return dict(ll=_np(ll), gamma0=_np(g0), xisum=_np(xi), gamma_sums=_np(gs),
                n_local=np.int64(kl.shape[0]))


def run_fingerprint(mesh):
    "Ranks contribute different dtypes: the guard must raise on every rank."
    from smcpp_tpu_torch.parallel import hostlocal

    x = np.zeros(3, np.float64 if mesh.rank == 0 else np.int64)
    try:
        hostlocal.allreduce_sum(x, mesh)
    except RuntimeError as e:
        return dict(caught=np.int64("mismatch" in str(e)))
    return dict(caught=np.int64(0))


def run_dryrun(mesh):
    """A dry run of the multi-rank path: one sharded E-step through the
    manager (window kernel), then Q_and_grad on its statistics."""
    n, data = manager_data((1, 12))
    im = make_manager(data, n, mesh)
    ll = im.E_step()
    q, g = im.Q_and_grad()
    return dict(ll=np.float64(ll), q=np.float64(q), grad=g,
                xisum=im._stats[1], n_local=np.int64(im._wkeys.shape[0]))


def card_problem():
    """A window problem at card-test widths (f32, M = 16, 40 keys, 6 contigs
    of about 8,000 windows, 64-window segments), as CPU tensors: (pi, T, E,
    keys, valid, seg_of_contig, row spans per contig)."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    rng = np.random.RandomState(11)
    nk, M = 40, 16
    data = []
    for _ in range(6):
        r = rng.randint(600, 900)
        data.append(np.c_[rng.randint(1, 20, r), rng.randint(0, nk, r)])
    keys, valid, soc = wk.pack_windows(data, {(k,): k for k in range(nk)},
                                       seg_target=512)
    T = 0.9 * np.eye(M) + 0.1 * rng.dirichlet(np.ones(M), size=M)
    pi = rng.dirichlet(np.ones(M))
    E = rng.uniform(0.05, 1.0, (nk, M))
    return (*_t(pi, T, E, dtype=_f32()), *_t(keys, valid), soc,
            [d[:, 0] for d in data])


def _f32():
    import torch

    return torch.float32


def run_card(mesh):
    """The sharded direct E-step at 'highest' and the window decode on the
    card (ranks sharing cuda:0 under gloo)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk
    from smcpp_tpu_torch.parallel import mesh as mm

    pi, T, E, keys, valid, soc, row_spans = card_problem()
    ends = wk.pack_window_row_ends(row_spans, keys.shape[1], soc)
    keys, valid = mm.pad_segments(keys.numpy(), valid.numpy(), mesh.size)
    kl, vl = (torch.as_tensor(mm.local_block(mesh, x), device=mesh.device)
              for x in (keys, valid))
    pi, T, E = (x.to(mesh.device) for x in (pi, T, E))
    before = {k.name: k.launches for k in wk.KERNELS}
    out = {f"estep{i}": _np(x) for i, x in enumerate(wk.estep_direct(
        pi, T, E, kl, vl, soc, precision="highest", mesh=mesh))}
    ll, g = wk.decode_gammas_windows(
        pi, T, E, kl, vl, soc, torch.as_tensor(ends, device=mesh.device),
        mesh=mesh)
    out.update(decode_ll=_np(ll), decode=_np(g), n_local=np.int64(kl.shape[0]))
    for k in wk.KERNELS:
        out[f"launches_{k.name}"] = np.int64(k.launches - before[k.name])
    return out


TASKS = {"parallel": run_parallel, "window_estep": run_window_estep,
         "fingerprint": run_fingerprint, "dryrun": run_dryrun, "card": run_card}


def main():
    task, rank, world, init, out = sys.argv[1:6]
    faulthandler.register(signal.SIGTERM, all_threads=True)
    import torch

    torch.set_num_threads(1)
    from smcpp_tpu_torch.parallel import distributed

    mesh = distributed.initialize(
        num_processes=int(world), process_id=int(rank), init_method=init,
        device="cuda" if task == "card" else "cpu")
    res = TASKS[task](mesh)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    distributed.shutdown(barrier=True)


def free_port():
    """A port the OS reports free (bound to port 0, then released), for a
    TCP rendezvous; run_on_port retries when another process takes it
    before rank 0's store binds it."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_all(cmds, timeout=120, env=None):
    """Run the commands (one per rank) at once with the repository on the
    path and single-threaded math; returns their outputs.  When one fails,
    or at the timeout, the others are stopped (their faulthandler prints
    where each waits), and the call fails with the logs."""
    import subprocess
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    e = dict(os.environ, PYTHONPATH=os.path.dirname(here), OMP_NUM_THREADS="1",
             **(env or {}))
    outs = [tempfile.TemporaryFile() for _ in cmds]
    procs = [subprocess.Popen(c, env=e, stdout=f, stderr=subprocess.STDOUT)
             for c, f in zip(cmds, outs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode for p in procs):
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.returncode]
        timed_out = not failed and any(p.poll() is None for p in procs)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = []
    for f in outs:
        f.seek(0)
        logs.append(f.read().decode(errors="replace"))
        f.close()
    if timed_out or failed:
        why = (f"ranks timed out after {timeout} s" if timed_out
               else f"rank {failed[0]} failed ({procs[failed[0]].returncode})")
        raise AssertionError(why + ":\n" + "\n".join(
            f"--- rank {r}:\n{log[-4000:]}" for r, log in enumerate(logs)))
    return logs


def launch(task, world, outdir, timeout=120, env=None):
    """Run ``task`` on ``world`` gloo ranks of this script (from the test
    process, with ``env`` added to the environment), joined through a file
    in ``outdir``; returns each rank's npz as a dict, in rank order."""
    import uuid

    outdir = os.path.abspath(outdir)
    os.makedirs(outdir, exist_ok=True)
    init = "file://" + os.path.join(outdir, f"rendezvous-{uuid.uuid4().hex}")
    run_all([[sys.executable, os.path.abspath(__file__), task, str(r),
              str(world), init, outdir] for r in range(world)],
            timeout, env)
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(world)]


def run_on_port(cmds, timeout=120, env=None, tries=3):
    """run_all(cmds(port)) on a free port, again on another port when the
    rendezvous could not bind it (EADDRINUSE: another process took it)."""
    for i in range(tries):
        try:
            return run_all(cmds(free_port()), timeout, env)
        except AssertionError as e:
            if "EADDRINUSE" not in str(e) or i == tries - 1:
                raise


def cli_ranks(argv, world, timeout=120, env=None):
    """The port's CLI (``argv`` a function of the rank) on ``world``
    processes joined by --coordinator / --num-processes / --process-id;
    returns their logs."""
    return run_on_port(lambda port: [
        [sys.executable, "-m", "smcpp_tpu_torch.commands.main", *argv(r),
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
         "--process-id", str(r)] for r in range(world)], timeout, env)


if __name__ == "__main__":
    main()
