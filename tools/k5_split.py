"""K5 (viterbi_paths) of an earlier csrc/viterbi_kernels.cu, with and
without its backtrace, beside the current K5's two launches, on one NVIDIA
GPU.

    python3 tools/k5_split.py OLD_SOURCE

OLD_SOURCE is an earlier version of smcpp_tpu_torch/csrc/viterbi_kernels.cu
whose K5 was one launch, ``smcpp_viterbi_paths`` (the forward sweep, then
lane 0 walking the backpointers back through device memory), for example
from ``git archive`` of that commit.  The script builds it twice with nvcc
for sm_90a, as it is and with lane 0's walk cut out (its forward alone),
and times both beside the current ``ViterbiPaths`` (``fwd()``, ``back()``
and the two together) at the posterior's shape (S x L = 6104 x 16384,
M = 32, 63 keys, 95% valid windows, inputs drawn from a seed), in the order
old, new, new, old, each the mean of ``REPS`` launches with CUDA events.
The old and the new path must be equal.  Prints the card's name and power
limit, then one JSON line: the milliseconds, and each forward's window loop
at M = 32 as compiled (``cuobjdump -sass``: instructions a window, by
opcode).
"""

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

S, L, M, N_KEYS, SEED, REPS = 6104, 16384, 32, 63, 0, 5
WALK = "  if (lane == 0) {\n    int state = seg_exit[s];"


def build_old(src, out_dir):
    "The old source as it is and without lane 0's walk: {variant: ctypes fn}."
    from smcpp_tpu_torch.ops import _cuda

    text = open(src).read()
    if text.count(WALK) != 1:
        raise SystemExit(f"{src}: no single one-launch K5 backtrace to cut")
    os.makedirs(out_dir, exist_ok=True)
    variants = {"old": text, "old_fwd": text.replace(WALK, WALK.replace("lane == 0", "false"))}
    procs = {}
    for name, body in variants.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(body)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [_cuda._nvcc(), *_cuda.ARCH_FLAGS, *_cuda.NVCC_FLAGS,
               "-I", _cuda.CSRC, "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        fn = ctypes.CDLL(so).smcpp_viterbi_paths
        fn.argtypes = [P] * 6 + [I] * 4 + [P] * 3
        fn.restype = I
        fns[name] = fn
    return fns


def loop_mix(so, kernel):
    """Opcode counts of the window loop of ``kernel`` (a name fragment of
    its M = 32, shared-table instantiation) in the library ``so``: the
    shortest backward branch's span of those that hold the most FSETP (the
    maximum over j)."""
    from smcpp_tpu_torch.ops import _cuda

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    body = [f for f in re.split(r"\n\s*Function : ", sass) if kernel in f.split("\n", 1)[0]][0]
    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);", body):
        ins.append((int(m.group(1), 16), m.group(3).split(".")[0], m.group(4)))
    loops = []
    for off, op, rest in ins:
        tgt = re.match(r"\s*(0x[0-9a-f]+)", rest)
        if op == "BRA" and tgt and int(tgt.group(1), 16) < off:
            span = [o for a, o, _ in ins if int(tgt.group(1), 16) <= a <= off]
            loops.append((span.count("FSETP"), -len(span), span))
    span = max(loops)[2]
    return {"instructions": len(span), "by_opcode": dict(collections.Counter(span).most_common())}


def main():
    import torch

    import chip_smoke as c
    from smcpp_tpu_torch.ops import _cuda, window_kernel as wk

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    c.card()
    fns = build_old(sys.argv[1], os.path.join(HERE, "build", "k5_split"))
    T, E, keys, valid, _, _ = c.problem(SEED, S, L, M, N_KEYS)
    entry, exit_ = c.states(SEED, S, M)
    logT, logE = torch.log(T).contiguous(), torch.log(E).contiguous()
    bp = torch.empty((S, L, M), dtype=torch.int8, device="cuda")
    old_path = torch.empty((S, L), dtype=torch.int32, device="cuda")
    st = torch.cuda.current_stream().cuda_stream

    def old(name):
        def run():
            code = fns[name](logT.data_ptr(), logE.data_ptr(), keys.data_ptr(),
                             valid.data_ptr(), entry.data_ptr(), exit_.data_ptr(),
                             S, L, M, N_KEYS, bp.data_ptr(), old_path.data_ptr(), st)
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")
        return run

    old("old")()
    k5 = wk.ViterbiPaths(T, E, keys, valid, entry, exit_)
    k5.fwd()
    new_path = k5.back()
    torch.cuda.synchronize()
    if not torch.equal(old_path, new_path):
        raise SystemExit(f"old and new paths differ in {int((old_path != new_path).sum())} entries")

    def new():
        k5.fwd()
        k5.back()

    t = {}
    for rnd, side in enumerate(("old", "new", "new", "old")):
        if side == "old":
            t[f"old_{rnd}"] = c.cuda_ms(old("old"), REPS)
            t[f"old_fwd_{rnd}"] = c.cuda_ms(old("old_fwd"), REPS)
        else:
            t[f"new_{rnd}"] = c.cuda_ms(new, REPS)
            t[f"new_fwd_{rnd}"] = c.cuda_ms(k5.fwd, REPS)
            t[f"new_back_{rnd}"] = c.cuda_ms(k5.back, REPS)
    mix = {"old": loop_mix(os.path.join(HERE, "build", "k5_split", "old.so"),
                           "viterbi_paths_kernelILi32ELb1E"),
           "new": loop_mix(_cuda.library_path("viterbi_kernels.cu"),
                           "viterbi_fwd_kernelILi32ELb1E")}
    print(json.dumps({"shape": [S, L, M, N_KEYS], "plan": {
        k: str(v) for k, v in wk.viterbi_paths_plan(S, L, M, N_KEYS).items()},
        "ms": t, "window_loop": mix}), flush=True)


if __name__ == "__main__":
    main()
