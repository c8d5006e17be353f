"""Where K3's and K15's time goes: the phases of one launch, timed on the card.

    python3 scripts/k3_timeline.py

Builds instrumented copies of scenelib2_torch/kernels/csrc/ekf_update.cu (K3)
and ekf_update_dense.cu (K15) in a temporary directory: the kernels and
update_cluster.cuh mark their phase boundaries with UPD_MARK(k, thread), a
no-op unless defined; here it is defined before the includes so that the
given thread of each CTA reads %globaltimer there and stores it in a device
array. Runs K3 through its wrapper on seeded inputs at D = 109 (std) and
D = 373 (hires), NSEL 10, with mixed matches, and K15 on the D = 109 case's
H, nu, R as the JAX step's XLA branch assembles them (ekf_update.dense_inputs);
prints the card's name and power limit and, per case, the median over
REPEATS launches of each phase's duration in microseconds, CTA 0's phases
first, then each CTA's end. The instrumented kernels compute what K3 and
K15 compute (the script checks their outputs against the plain versions)
but run slightly slower.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPEATS = 9
SEED = 12
N_MARKS = 16

PHASES = {  # (label, from mark, to mark) on CTA 0; the mark of each CTA's end
    "K3": ((("H, nu, R", 0, 1), ("P H' at H's rows", 1, 2), ("S", 2, 3), ("L^-1 (warp 0)", 3, 4),
            ("P H' at every row (warps 1-15)", 3, 5), ("both done", 3, 6), ("S^-1", 6, 7), ("W", 7, 8),
            ("x', W S", 8, 9), ("strips, cols", 9, 10), ("rowsb, publish", 10, 11), ("cluster.sync", 11, 12),
            ("copy in", 12, 13), ("tiles", 13, 14)), 14),
    "K15": ((("stage P's rows, H' (each CTA)", 0, 1), ("P H' rows to CTA 0, cluster.sync", 1, 2), ("S", 2, 3),
             ("L^-1", 3, 4), ("S^-1", 6, 7), ("W", 7, 8),
             ("x', W S", 8, 9), ("strips, cols", 9, 10), ("rowsb, publish", 10, 11), ("cluster.sync", 11, 12),
             ("copy in", 12, 13), ("tiles, counts", 13, 14), ("second cluster.sync", 14, 15)), 15),
}
DEBUG = '''#include <cooperative_groups.h>
__device__ unsigned long long upd_marks[8 * 16];
extern "C" int upd_marks_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, upd_marks, sizeof(upd_marks));
}
#define UPD_MARK(k, thread)                                                                  \\
  if (threadIdx.x == (thread)) {                                                             \\
    unsigned long long g_;                                                                   \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));                                   \\
    upd_marks[(int)cooperative_groups::this_cluster().block_rank() * 16 + (k)] = g_;         \\
  }
'''


def instrumented_build(name: str, tmp: str, defines: tuple) -> ctypes.CDLL:
    """csrc/<name>.cu with UPD_MARK defined, built into tmp and loaded."""
    from scenelib2_torch.kernels import _build

    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        text = f.read()
    if "UPD_MARK(" not in text:
        raise SystemExit(f"k3_timeline: {name}.cu marks no phase boundary")
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as f:
        f.write(DEBUG + text)
    lib_path = os.path.join(tmp, f"lib{name}_timeline.so")
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *_build.define_flags(defines), "-o", lib_path, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(lib_path)
    lib.upd_marks_read.argtypes = [ctypes.c_void_p]
    lib.upd_marks_read.restype = ctypes.c_int
    return lib


def report(label: str, kernel: str, launch, read) -> None:
    import numpy as np
    import torch

    runs = []
    for _ in range(REPEATS):
        launch()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (8 * N_MARKS))()
        read(ctypes.addressof(buf))
        runs.append(np.array(buf[:], dtype=np.int64).reshape(8, N_MARKS))
    phases, end = PHASES[kernel]
    print(f"{label} (median of {REPEATS} launches, us)")
    for name, a, b in phases:
        us = statistics.median((r[0, b] - r[0, a]) / 1e3 for r in runs)
        print(f"  {name:<34} {us:8.2f}")
    ends = [statistics.median((r[k, end] - r[0, 0]) / 1e3 for r in runs) for k in range(8)]
    print("  each CTA's end, from CTA 0's start: " + ", ".join(f"{e:.2f}" for e in ends))


def main() -> int:
    import numpy as np
    import torch

    from scenelib2_torch.config import Params
    from scenelib2_torch.kernels import _build, chol_inv, ekf_update
    from scenelib2_torch.kernels.measure import NOUT, O_H, O_HX, O_HY, O_RD

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    tmp = tempfile.mkdtemp()
    try:
        for fn in os.listdir(_build.CSRC):
            if fn.endswith(".cuh"):
                shutil.copy(os.path.join(_build.CSRC, fn), tmp)
        p = Params()
        M = 2 * p.n_features_to_select
        defines = chol_inv.reg_defines(M)  # the build K3's and K15's wrappers ask for
        libs = {n: instrumented_build(n, tmp, defines) for n in (ekf_update.NAME, ekf_update.NAME_DENSE)}
        for n, lib in libs.items():
            _build._libs[(n, defines)] = lib      # the wrappers now launch the instrumented kernels
        dev = torch.device("cuda")
        rng = np.random.default_rng(SEED)
        uc = ekf_update.UpdateConsts.from_params(p)
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        for MF in (16, 60):
            D, NSEL = 13 + 6 * MF, p.n_features_to_select
            A = rng.normal(size=(D, D))
            P = A @ A.T / D * 1e-3 + np.eye(D) * 1e-4
            x = rng.normal(size=D) * 0.1
            x[3:7] = rng.normal(size=4)
            x[3:7] /= np.linalg.norm(x[3:7]) * (1.0 + 1e-3)
            sel = np.zeros((NOUT, NSEL), np.float32)
            sel[O_HX : O_HX + 14] = rng.normal(size=(14, NSEL))
            sel[O_HY : O_HY + 6] = rng.normal(size=(6, NSEL))
            sel[O_RD] = rng.uniform(1.0, 2.0, NSEL)
            h = rng.uniform(20, 200, (NSEL, 2))
            sel[O_H : O_H + 2] = h.T
            top = rng.choice(MF, NSEL, replace=False).astype(np.int32)
            active = np.zeros(MF, bool)
            active[top] = True
            zeros = np.zeros(MF, np.int32)
            args = (torch.tensor(x, **f32), torch.tensor(P, **f32), torch.tensor(sel, **f32),
                    torch.tensor(h + rng.normal(0, 1.0, (NSEL, 2)), **f32),
                    torch.tensor(np.arange(NSEL) % 3 != 1, device=dev), torch.tensor(13 + 6 * top, **i32),
                    torch.tensor(zeros, **i32), torch.tensor(zeros, **i32), torch.zeros(MF, dtype=torch.bool, device=dev),
                    torch.tensor(active, device=dev), torch.tensor(np.where(active, rng.permutation(MF), -1), **i32),
                    torch.ones(NSEL, dtype=torch.bool, device=dev), torch.tensor(top, **i32))
            got = ekf_update.joint_update(*args, uc)
            want = ekf_update.joint_update_plain(*args, uc)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                print(f"D {D}: the instrumented K3 differs from the plain version", file=sys.stderr)
                return 1
            report(f"K3 D = {D}, M = {M}", "K3", lambda: ekf_update.joint_update(*args, uc),
                   libs[ekf_update.NAME].upd_marks_read)
            if D > ekf_update.DENSE_MAX:
                continue
            a15 = (args[0], args[1], *ekf_update.dense_inputs(D, *args[2:6]), args[4].any(),
                   ekf_update.keep_of_kill(want[5]))
            got = ekf_update.joint_update_dense(*a15)
            want15 = ekf_update.joint_update_dense_plain(*a15)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want15)):
                print(f"D {D}: the instrumented K15 differs from the plain version", file=sys.stderr)
                return 1
            report(f"K15 D = {D}, M = {M} (K3's case, H dense)", "K15",
                   lambda: ekf_update.joint_update_dense(*a15), libs[ekf_update.NAME_DENSE].upd_marks_read)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
