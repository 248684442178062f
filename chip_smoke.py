"""Smoke run of the PyTorch/CUDA port (smcpp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the CUDA kernels from smcpp_tpu_torch/csrc with nvcc (sm_90a);
3. each kernel (K1 asc_sweep, K2 dsc_sweep, K3 segment_ops) against its
   plain PyTorch version on the card, f32 at 'highest' and 'default', on
   synthetic inputs at a small shape (S=64, L=512, M=15, 16 and 17, 89
   keys), with kernel and plain times;
4. the main path: simulate 2 contigs x 100 Mbp with n=20 (port's
   data/simulate.py, seeded), then ``smcpp_tpu_torch.commands.main estimate
   --em-iterations 2 --device cuda`` at the default knots, spline and w;
   checks model.final.json and that every kernel was launched; then each
   kernel against its plain version again, at both rungs, on the fitted
   manager's own inputs (its packed windows, f32 T and E and the boundary
   vectors they give: the shape, M and key count the fit launched the
   kernels at), with kernel and plain times;
5. ``estep_direct`` alone at the bench.py C3 shape (22 x 2.5e6 windows,
   M=16, 128 keys; median of 3 runs), in Gbp/s.

The line before the last is the kernels' JSON record (launches from the
main path's run; errors and times from the phase-4 comparison at the rung
the fit ended on); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
CUDA device is present.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# tolerances of tests/test_torch_cuda.py
HIGHEST_RTOL = 1e-5  # exact-f32 recursions in another summation order
DEFAULT_RTOL = 1e-3  # bf16 carries: a rounding may flip by one bf16 ulp
BF16_ULP = 2.0**-7


def log(*a):
    print(*a, flush=True)


def card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log("torch device:", torch.cuda.get_device_name(0), "| torch",
        torch.__version__, "cuda", torch.version.cuda)
    return smi


def build():
    from smcpp_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 0:.1f} s) "
        f"-> {_cuda.library_path()}")


def cuda_ms(fn, reps):
    "Mean milliseconds of fn() on the card, timed with CUDA events."
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def problem(seed, S, L, M, n_keys):
    import torch

    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.95
    valid[-1, L // 2:] = False
    A_in = rng.rand(S, M)
    Q_end = rng.rand(S, M)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa: E731
    return (f(T), f(E), torch.as_tensor(keys, device="cuda"),
            torch.as_tensor(valid, device="cuda"), f(A_in), f(Q_end))


def check_close(name, got, want, rtol, atol):
    import torch

    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs err {err:.3g}, {int(bad.sum())} elements over "
            f"rtol={rtol:g} atol={atol:.3g})"
        )
    return err


def compare(tag, T, E, keys, valid, A_in, Q_end, prec, reps):
    """Each kernel against its plain version on one input set at one rung;
    raises on a miss.  Returns {kernel name: (max abs err, kernel ms, plain
    ms)}."""
    from smcpp_tpu_torch.ops import window_kernel as wk

    rtol = HIGHEST_RTOL if prec == "highest" else DEFAULT_RTOL
    # K3
    ops, logs = wk.segment_ops_cuda(T, E, keys, valid, prec)
    ops_p, logs_p = wk.segment_ops_plain(T, E, keys, valid, prec)
    e3 = check_close(f"segment_ops [{tag}] ops", ops, ops_p, rtol,
                     1e-7 * float(ops_p.abs().max()))
    check_close(f"segment_ops [{tag}] logs", logs, logs_p, 1e-5,
                1e-6 * float(logs_p.abs().max()))
    t3 = cuda_ms(lambda: wk.segment_ops_cuda(T, E, keys, valid, prec), reps)
    t3p = cuda_ms(lambda: wk.segment_ops_plain(T, E, keys, valid, prec), 1)
    # K1
    al, ae = wk.asc_sweep_cuda(T, E, keys, valid, A_in, prec)
    al_p, ae_p = wk.asc_sweep_plain(T, E, keys, valid, A_in, prec)
    e1 = check_close(f"asc_sweep [{tag}] alpha_end", ae, ae_p,
                     HIGHEST_RTOL, 1e-7)
    check_close(f"asc_sweep [{tag}] alphas", al, al_p,
                BF16_ULP if prec == "default" else HIGHEST_RTOL, 1e-7)
    t1 = cuda_ms(lambda: wk.asc_sweep_cuda(T, E, keys, valid, A_in, prec), reps)
    t1p = cuda_ms(lambda: wk.asc_sweep_plain(T, E, keys, valid, A_in, prec), 1)
    # K2 on the same (plain) stream, so only K2 differs
    al_p = al_p.contiguous()
    u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, al_p, Q_end)
    u_p, xo_p, gs_p = wk.dsc_sweep_plain(T, E, keys, valid, al_p, Q_end)
    check_close(f"dsc_sweep [{tag}] u_start", u, u_p, HIGHEST_RTOL, 1e-7)
    check_close(f"dsc_sweep [{tag}] xo", xo, xo_p, HIGHEST_RTOL,
                1e-8 * float(xo_p.abs().max()))
    e2 = check_close(f"dsc_sweep [{tag}] gsum", gs, gs_p, HIGHEST_RTOL,
                     1e-8 * float(gs_p.abs().max()))
    nv = float(valid.sum())
    if abs(float(gs.sum()) - nv) > 1e-6 * nv:
        raise AssertionError(f"dsc_sweep [{tag}]: sum(gsum) != valid windows")
    t2 = cuda_ms(lambda: wk.dsc_sweep_cuda(T, E, keys, valid, al_p, Q_end), reps)
    t2p = cuda_ms(lambda: wk.dsc_sweep_plain(T, E, keys, valid, al_p, Q_end), 1)
    log(f"[{tag}] ms kernel/plain: segment_ops {t3:.3f}/{t3p:.1f} "
        f"asc_sweep {t1:.3f}/{t1p:.1f} dsc_sweep {t2:.3f}/{t2p:.1f}; "
        f"max abs err {e3:.2e} {e1:.2e} {e2:.2e}")
    return {
        "segment_ops": (e3, t3, t3p),
        "asc_sweep": (e1, t1, t1p),
        "dsc_sweep": (e2, t2, t2p),
    }


def compare_small():
    "Every kernel against its plain version on synthetic inputs, both rungs."
    from smcpp_tpu_torch.ops import window_kernel as wk

    for S, L, M, nk in [(64, 512, 15, 89), (64, 512, 16, 89), (64, 512, 17, 89)]:
        T, E, keys, valid, A_in, Q_end = problem(SEED, S, L, M, nk)
        wk.check_key_range(keys.cpu().numpy(), nk)
        for prec in ("highest", "default"):
            compare(f"small S={S} L={L} M={M} keys={nk} {prec}",
                    T, E, keys, valid, A_in, Q_end, prec, 3)
    log("kernel comparisons (small): all within tolerance")


def compare_main_path(im):
    """Every kernel against its plain version on the fitted manager's own
    inputs: its packed window keys and valid mask, its f32 T and E, and the
    boundary vectors contig_boundaries gives them.  Both rungs; returns the
    records at the rung the fit ended on ('tensorfloat32' stores what
    'highest' stores)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    pi, T, E = (x.float().contiguous() for x in im.tensors())
    keys, valid, soc = im._wkeys, im._wvalid, im._soc
    S, L = keys.shape
    fit_rung = "default" if im.precision == "default" else "highest"
    records = {}
    for prec in ("highest", "default"):
        ops, logs = wk.segment_ops_plain(T, E, keys, valid, prec)
        _, A_in, Q_end, _ = wk.contig_boundaries(pi, ops, logs, soc,
                                                 torch.any(valid, 1))
        rec = compare(
            f"main path S={S} L={L} M={T.shape[0]} keys={E.shape[0]} {prec}",
            T, E, keys, valid, A_in.contiguous(), Q_end.contiguous(), prec, 5)
        if prec == fit_rung:
            records = rec
    log(f"kernel comparisons (main path): all within tolerance; records at "
        f"'{fit_rung}' (the fit ended on {im.precision!r})")
    return records


def main_path(workdir):
    """Simulate the slice's data and run estimate through the CLI entry
    point; returns (launches, kernel records from compare_main_path)."""
    import torch

    from smcpp_tpu_torch.commands import main as cli
    from smcpp_tpu_torch.data.simulate import write_simulated
    from smcpp_tpu_torch.inference import analysis as an
    from smcpp_tpu_torch.inference import manager as mg
    from smcpp_tpu_torch.models.model import SMCModel
    from smcpp_tpu_torch.ops import window_kernel as wk

    L_bp, n, mu = 100_000_000, 20, 1.25e-8
    truth = SMCModel([0.01, 0.1, 1.0, 5.0], 1e4, "piecewise")
    truth.y[:] = np.log([1.0, 0.3, 1.0, 2.0])
    t0 = time.perf_counter()
    files = []
    for i in range(2):
        fn = os.path.join(workdir, f"contig{i}.smc.gz")
        write_simulated(fn, truth, 2.5e-4, 2.5e-4, L=L_bp, n=n, seed=SEED + i,
                        pid="pop1")
        files.append(fn)
    log(f"simulated 2 contigs x {L_bp / 1e6:.0f} Mbp, n={n}: "
        f"{time.perf_counter() - t0:.1f} s")

    # timing hooks: E-step durations and the stage-2 start
    events = []
    orig_estep = mg.OnePopInferenceManager.E_step
    orig_init_im = an.BaseAnalysis._init_inference_manager

    def timed_estep(self):
        t = time.perf_counter()
        out = orig_estep(self)
        torch.cuda.synchronize()
        events.append(("estep", len(self.hidden_states) - 1, t, time.perf_counter()))
        return out

    def timed_init_im(self, pe, hs):
        events.append(("manager", len(hs) - 1, time.perf_counter(), None))
        return orig_init_im(self, pe, hs)

    mg.OnePopInferenceManager.E_step = timed_estep
    an.BaseAnalysis._init_inference_manager = timed_init_im
    out = os.path.join(workdir, "out")
    for k in wk.KERNELS:
        k.launches = 0
    t_start = time.perf_counter()
    try:
        analysis = cli.main([
            "estimate", "--device", "cuda", "--em-iterations", "2",
            "-o", out, str(mu), *files,
        ])
    finally:
        mg.OnePopInferenceManager.E_step = orig_estep
        an.BaseAnalysis._init_inference_manager = orig_init_im
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k.name: k.launches for k in wk.KERNELS}

    with open(os.path.join(out, "model.final.json")) as f:
        d = json.load(f)
    y = np.asarray(d["model"]["y"], float)
    if not (np.all(np.isfinite(y)) and np.isfinite(d["rho"]) and d["rho"] > 0):
        raise AssertionError(f"model.final.json is not finite: {d}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    stage2_start = [e[2] for e in events if e[0] == "manager" and e[1] > 1][0]
    est2 = [(e[2], e[3]) for e in events if e[0] == "estep" and e[1] > 1]
    # the first stage-2 E-step sets the regularization penalty; then each EM
    # iteration is one E-step followed by its M-step
    iters = []
    for i, (a, b) in enumerate(est2[1:], 1):
        nxt = est2[i + 1][0] if i + 1 < len(est2) else t_end
        iters.append((b - a, nxt - b))
    M = len(analysis.hidden_states) - 1
    log(f"estimate: stage 1 {stage2_start - t_start:.2f} s, stage 2 "
        f"{t_end - stage2_start:.2f} s, total {t_end - t_start:.2f} s; "
        f"hidden states: {analysis.hidden_state_path} (M={M}); "
        f"S x L = {tuple(analysis._ims[('pop1',)]._wkeys.shape)}")
    for i, (e, m) in enumerate(iters):
        log(f"  EM iteration {i}: E-step {e:.3f} s, M-step {m:.3f} s")
    log(f"  final loglik {analysis.loglik():.6f}, rho {d['rho']:.6g}, "
        f"y {np.round(y, 4).tolist()}")
    log(f"  kernel launches on the main path: {launches}")
    im = analysis._ims[("pop1",)]
    t0 = time.perf_counter()
    pi, T, E = im.tensors()
    torch.cuda.synchronize()
    log(f"  f64 (pi, T, E) setup on the device: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    pi, T, E = (x.float().contiguous() for x in (pi, T, E))
    estep_breakdown("slice", pi, T, E, im._wkeys, im._wvalid, im._soc)
    return launches, compare_main_path(im)


def estep_breakdown(label, pi, T, E, keys, valid, soc, precision="default"):
    """Milliseconds of each phase of estep_direct (CUDA events around each
    call, after one warm-up run)."""
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    def phases():
        ops, logs = wk.segment_operators(T, E, keys, valid, precision)
        yield "segment_ops (K3)"
        ll, A_in, Q_end, cvalid = wk.contig_boundaries(
            pi, ops, logs, soc, torch.any(valid, 1))
        yield "contig_boundaries"
        alphas, a_end = wk.asc_sweep_cuda(T, E, keys, valid, A_in.contiguous(),
                                          precision)
        yield "asc_sweep (K1)"
        u, xo, gs = wk.dsc_sweep_cuda(T, E, keys, valid, alphas, Q_end.contiguous())
        yield "dsc_sweep (K2)"
        wk.boundary_stats(pi, T, a_end, u, xo, soc, cvalid)
        yield "boundary_stats"

    for _ in phases():
        pass
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    names = []
    for name in phases():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        names.append(name)
    torch.cuda.synchronize()
    parts = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    log(f"E-step breakdown [{label}, S x L = {tuple(keys.shape)}, "
        f"M = {T.shape[0]}, {E.shape[0]} keys]: total {sum(parts):.2f} ms; "
        + ", ".join(f"{n} {t:.2f}" for n, t in zip(names, parts)))


def c3_throughput():
    "estep_direct at the bench.py C3 shape, median of 3 timed runs."
    import torch

    from bench import synth_contig
    from smcpp_tpu_torch.ops import window_kernel as wk

    rng = np.random.default_rng(0)
    C, WINDOWS, W, M, n_keys = 22, 2_500_000, 100, 16, 128
    raw = [synth_contig(rng, WINDOWS, n_keys, 3) for _ in range(C)]
    key_id = {(k,): k for k in range(n_keys)}
    keys, valid, soc = wk.pack_windows(raw, key_id, seg_target=8192,
                                       max_seg_len=16384)
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    pi_d, T_d, E_d = wk.from_numpy(pi, T, E, "cuda")
    kd = torch.as_tensor(keys, device="cuda")
    vd = torch.as_tensor(valid, device="cuda")
    out = wk.estep_direct(pi_d, T_d, E_d, kd, vd, soc)
    if not np.isfinite(float(out[0])):
        raise AssertionError("C3 E-step log-likelihood is not finite")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wk.estep_direct(pi_d, T_d, E_d, kd, vd, soc)
        float(out[0])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    estep_breakdown("C3", pi_d, T_d, E_d, kd, vd, soc)
    log(f"C3 E-step: S x L = {keys.shape}, {dt * 1e3:.1f} ms (median of 3), "
        f"{C * WINDOWS * W / dt / 1e9:.2f} Gbp/s, peak mem "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def main():
    card()
    import torch

    build()
    compare_small()
    with tempfile.TemporaryDirectory() as workdir:
        launches, records = main_path(workdir)
    c3_throughput()
    from smcpp_tpu_torch.ops import window_kernel as wk

    kernels = []
    for k in wk.KERNELS:
        err, ms, plain_ms = records[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
