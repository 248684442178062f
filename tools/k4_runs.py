"""K4 (viterbi_ops) on runs of equal keys of one length, on one NVIDIA GPU:
the current kernel with other cut-offs beside an earlier source's K4, to
choose the cut-off (RUN_MIN in csrc/viterbi_kernels.cu) and to time the
window walk against the earlier kernel.

    python3 tools/k4_runs.py [OLD_SOURCE]

Builds smcpp_tpu_torch/csrc/viterbi_kernels.cu with nvcc for sm_90a three
times: as it is ("current"), with RUN_MIN = 2 (every run of two windows or
more as a power: "powers") and with RUN_MIN past every run (the walk alone:
"walk"); and OLD_SOURCE, where given, an earlier viterbi_kernels.cu whose
smcpp_viterbi_ops takes no counters ("old").  Then, at S x L = 6104 x 2048,
M = 32, 63 keys, every window valid, inputs drawn from a seed, times each on
keys whose runs all have r windows, for each r of RS, and on random keys
(runs of one window, the walk), in the order of the variants and back, the
mean of REPS launches with CUDA events a turn.  "walk" and "old" must give
equal operators, and "current" its plain twin's (the first 4 segments).
Prints the card's name and power limit, then one JSON line a row: r, the
products a window the cut-off of each variant needs, and the milliseconds.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

S, L, M, N_KEYS, SEED, REPS = 6104, 2048, 32, 63, 0, 5
RS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16, 24, 32, 64, 256]
CUT = "constexpr int RUN_MIN = "


def build(old, out_dir):
    "{variant: ctypes entry point}, every nvcc started together."
    from smcpp_tpu_torch.ops import _cuda

    src = os.path.join(_cuda.CSRC, "viterbi_kernels.cu")
    text = open(src).read()
    line = next(ln for ln in text.splitlines() if ln.startswith(CUT))
    bodies = {"current": text,
              "powers": text.replace(line, CUT + "2;"),
              "walk": text.replace(line, CUT + "0x7fffffff;")}
    if old:
        bodies["old"] = open(old).read()
    procs = {}
    for name, body in bodies.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(body)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [_cuda._nvcc(), *_cuda.ARCH_FLAGS, *_cuda.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", _cuda.CSRC, "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines()
                if "viterbi_ops" in ln or ("registers" in ln and "Used" in ln)]
        print(f"{name}: " + " | ".join(regs[:6]), flush=True)
        fn = ctypes.CDLL(so).smcpp_viterbi_ops
        fn.argtypes = [P] * 4 + [I] * 4 + [P] * (2 if name == "old" else 3)
        fn.restype = I
        fns[name] = fn
    return fns


def products(r, cut):
    "Operator products for a run of r windows under the cut-off ``cut``."
    return r if r < cut else r.bit_length() - 1 + bin(r).count("1")


def main(old=None):
    import numpy as np
    import torch

    from smcpp_tpu_torch.ops import window_kernel as wk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    fns = build(old, tempfile.mkdtemp())
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    T = torch.as_tensor(rng.dirichlet(np.ones(M), size=M) + np.eye(M) * 50,
                        dtype=torch.float32, device=dev)
    T /= T.sum(1, keepdim=True)
    E = torch.as_tensor(rng.uniform(0.05, 1.0, (N_KEYS, M)), dtype=torch.float32, device=dev)
    logT, logE = torch.log(T).contiguous(), torch.log(E).contiguous()
    valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(name, keys, out):
        args = [logT.data_ptr(), logE.data_ptr(), keys.data_ptr(), valid.data_ptr(),
                S, L, M, N_KEYS, out.data_ptr()]
        args += [stream] if name == "old" else [counts.data_ptr(), stream]
        if fns[name](*args):
            raise SystemExit(f"{name}: launch failed")

    def ms(name, keys, out):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(REPS):
            launch(name, keys, out)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    names = list(fns)
    l = torch.arange(L, device=dev)
    for r in ["random"] + RS:
        if r == "random":
            keys = torch.randint(0, N_KEYS, (S, L), dtype=torch.int32, device=dev,
                                 generator=torch.Generator(dev).manual_seed(SEED))
        else:
            pair = torch.arange(S, device=dev)[:, None] % (N_KEYS - 1)
            keys = (pair + (l[None] // r) % 2).int().contiguous()
        outs = {n: torch.empty((S, M, M), dtype=torch.float32, device=dev) for n in names}
        for n in names:
            launch(n, keys, outs[n])
        torch.cuda.synchronize()
        if "old" in outs and not torch.equal(outs["old"], outs["walk"]):
            raise SystemExit(f"r = {r}: the walk differs from the old kernel")
        twin = wk.viterbi_ops_runs_plain(T, E, keys[:4], valid[:4])
        if not torch.equal(outs["current"][:4], twin):
            raise SystemExit(f"r = {r}: the current kernel differs from its twin")
        t = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                t[n].append(ms(n, keys, outs[n]))
        plan = {} if r == "random" else {
            n: products(r, cut) / r
            for n, cut in (("current", wk.VITERBI_RUN_MIN), ("powers", 2), ("walk", 1 << 31))}
        print(json.dumps({"r": r, "products_a_window": plan,
                          "ms": {n: sum(v) / len(v) for n, v in t.items()}}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:2])
