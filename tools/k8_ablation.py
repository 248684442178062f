"""What K8 (remat_sweep, smcpp_tpu_torch/csrc/remat_kernels.cu) waits on.

    python3 tools/k8_ablation.py [S]

Builds variants of K8's source, each with one part of the work taken out,
with nvcc into build/k8_ablation/ (one nvcc per variant, in parallel), and
times each on the same synthetic inputs at the posterior's shape (S x L =
6104 x 16384 by default, M = 32, 63 keys, block 128, keys mostly one key, as
in ``chip_smoke.k8_alone``) at both rungs, with CUDA events, in turns.  The
variants' outputs are wrong by design; only their times mean anything:

  full          K8 as it is
  no_gsum       the consumer skips gsum's run sums and atomics
  no_xisum      the consumer skips xisum's product
  no_stats      both
  producer_only the consumer skips every step (it still waits for each chunk)
  consumer_only the producer skips K1's step (it still writes the keys and
                its stale carry into the ring)
  no_swap       every block's first warp is its producer, whatever its warp
                slot (K8 swaps the roles by slot to share each
                sub-partition's tensor cores between a producer and a
                consumer)

Needs a card and nvcc; prints one line a variant and rung.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from smcpp_tpu_torch.ops import _cuda  # noqa: E402
from smcpp_tpu_torch.ops import window_kernel as wk  # noqa: E402

SRC = os.path.join(_cuda.CSRC, "remat_kernels.cu")
OUT = os.path.join(HERE, "build", "k8_ablation")

# (start, end) snippets of the source: the text from start up to (not
# including) end is dropped
GSUM = ("      // gsum: lane j", "      __syncwarp();  // the buffers are rewritten")
XISUM = ("      // xisum += (a / Z)^T u_old", "      // gsum: lane j")
STEP = ("      double acc[NN][4];  // acc[n][2m + c] = Y[g + 8m][8n + 2t + c]",
        "      if (to_ring) Ring<NN, BF16>::put(slot, tt, lane, X);")
VARIANTS = {
    "full": [],
    "no_gsum": [GSUM],
    "no_xisum": [XISUM],
    "no_stats": [XISUM, GSUM],
    "consumer_only": [STEP],
}
# every block's first warp the producer, whatever its warp slot
NO_SWAP = ("    s_swap = (slot >> 2) & 1;\n", "    s_swap = 0;\n")
# the consumer's step loop emptied: every chunk still waited for and released
IDLE = ("    for (int w = n_win - 1; w >= 0; --w) {\n",
        "    for (int w = n_win - 1; w >= 0; --w) {\n      if (n_win > 0) continue;\n")


def variant_source(name):
    src = open(SRC).read()
    if name in ("producer_only", "no_swap"):
        old, new = IDLE if name == "producer_only" else NO_SWAP
        assert old in src
        return src.replace(old, new)
    for start, end in VARIANTS[name]:
        i, j = src.index(start), src.index(end)
        assert i < j, (name, start)
        src = src[:i] + src[j:]
    return src


def build(names):
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name in names:
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        so = os.path.join(OUT, f"{name}.so")
        cmd = [_cuda._nvcc(), *_cuda.ARCH_FLAGS, *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC,
               "-o", so, cu]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(so).smcpp_remat_sweep
        fn.argtypes = _cuda._SIGNATURES["remat_kernels.cu"]["smcpp_remat_sweep"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def inputs(S, L, M, n_keys, seed=0):
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    keys[rng.rand(S, L) < 0.95] = 0
    valid = rng.rand(S, L) < 0.95
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")  # noqa: E731
    return (f(T), f(E), torch.as_tensor(keys, device="cuda"),
            torch.as_tensor(valid, device="cuda"), f(rng.rand(S, M)), f(rng.rand(S, M)))


def main():
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 6104
    L, M, n_keys, block = 16384, 32, 63, 128
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    names = list(VARIANTS) + ["producer_only", "no_swap"]
    libs = build(names)
    T, E, keys, valid, A_in, Q_end = inputs(S, L, M, n_keys)
    for prec in ("default", "highest"):
        r = wk.AlphaRemat(T, E, keys, valid, A_in, Q_end, prec, block)
        r.snap()
        bf16 = int(r.cdt == torch.bfloat16)

        def launch(name):
            r.gsum_part.zero_()
            code = libs[name](
                T.data_ptr(), E.data_ptr(), keys.data_ptr(), valid.data_ptr(),
                r.snaps.data_ptr(), Q_end.data_ptr(), S, L, M, n_keys, bf16, block,
                r.plan["gsum_group"], r.carries.data_ptr(), r.u_start.data_ptr(),
                r.xo_part.data_ptr(), r.gsum_part.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"{name}: error {code}")

        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for name in order:
                launch(name)
                torch.cuda.synchronize()
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                for _ in range(3):
                    launch(name)
                b.record()
                torch.cuda.synchronize()
                times[name].append(a.elapsed_time(b) / 3)
        for name in names:
            print(f"K8 ablation S x L = {S} x {L}, M = {M}, {n_keys} keys, block {block}, "
                  f"{prec!r}: {name} " + " / ".join(f"{t:.2f}" for t in times[name])
                  + " ms", flush=True)
        del r


if __name__ == "__main__":
    main()
