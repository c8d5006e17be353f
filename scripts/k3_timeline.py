"""Where K3's time goes: the phases of one launch, timed on the card.

    python3 scripts/k3_timeline.py

Builds an instrumented copy of scenelib2_torch/kernels/csrc/ekf_update.cu in
a temporary directory: thread 0 of each CTA (thread 32 of CTA 0 for the
warps that form P H' while warp 0 factorises) reads %globaltimer at the
phase boundaries named below and stores it in a device array. Runs K3
through its wrapper on seeded inputs at D = 109 (std) and D = 373 (hires),
NSEL 10, with mixed matches; prints the card's name and power limit and, per
D, the median over REPEATS launches of each phase's duration in
microseconds, CTA 0's phases first, then each CTA's end. The instrumented
kernel computes what K3 computes (the script checks its outputs against the
plain version) but runs slightly slower.
"""

from __future__ import annotations

import ctypes
import dataclasses
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

# (text in ekf_update.cu, mark, where the timestamp goes), in kernel order
MARKS = (
    ("  if (rank < n_tiles) k3_fetch(P, D, nT, rank, r0, lane, pa, pb);\n", 0, "after"),
    ("    __syncthreads();\n    if (any_s) {\n", 1, "after"),
    ("      __syncthreads();\n      // ---- S = H P H' + R", 2, "mid"),
    ("      __syncthreads();\n      // ---- X = L^-1", 3, "mid"),
    ("        chol_linv_reg_any(A, X, M);\n", 4, "after"),
    ("      __syncthreads();\n      if (!split) {", 5, "before32"),
    ("      if (!split) {\n        chol_linv_block", 6, "before"),
    ("      __syncthreads();\n      // ---- W = P H' S^-1", 7, "mid"),
    ("      __syncthreads();\n      // ---- x' = x + W nu", 8, "mid"),
    ("      __syncthreads();\n      // ---- the quaternion-norm Jacobian", 9, "mid"),
    ("      __syncthreads();\n      // ---- rowsb[r][d]", 10, "mid"),
    ("    __threadfence();\n  } else if (rank == 1) {", 11, "before"),
    ("    __threadfence();\n  }\n\n  // ================= phase 2", 11, "before"),
    ("  cluster.sync();\n", 12, "after"),
    ("  __syncthreads();\n  if (rank == 0)\n    for (int d = tid; d < D; d += nt) xo[d]", 13, "mid"),
)
PHASES = (  # (label, from mark, to mark) on CTA 0
    ("H, nu, R", 0, 1), ("P H' at H's rows", 1, 2), ("S", 2, 3), ("L^-1 (warp 0)", 3, 4),
    ("P H' at every row (warps 1-15)", 3, 5), ("both done", 3, 6), ("S^-1", 6, 7), ("W", 7, 8),
    ("x', W S", 8, 9), ("strips, cols", 9, 10), ("rowsb, publish", 10, 11), ("cluster.sync", 11, 12),
    ("copy in", 12, 13), ("tiles", 13, 14),
)
DEBUG = '''__device__ unsigned long long k3_marks[8 * 16];
extern "C" int k3_marks_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, k3_marks, sizeof(k3_marks));
}
#define K3_MARK(k, thread)                                                     \\
  if (threadIdx.x == (thread)) {                                               \\
    unsigned long long g_;                                                     \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));                     \\
    k3_marks[(int)cluster.block_rank() * 16 + (k)] = g_;                       \\
  }
'''


def instrumented_source(src: str) -> str:
    for anchor, k, where in MARKS:
        if src.count(anchor) != 1:
            raise SystemExit(f"k3_timeline: ekf_update.cu no longer has the phase boundary {anchor!r}")
        if where == "after":
            src = src.replace(anchor, anchor + f"  K3_MARK({k}, 0);\n")
        elif where == "before":
            src = src.replace(anchor, f"    K3_MARK({k}, 0);\n" + anchor)
        elif where == "before32":
            src = src.replace(anchor, f"      K3_MARK({k}, 32);\n" + anchor)
        else:
            first, rest = anchor.split("\n", 1)
            src = src.replace(anchor, first + f"\n  K3_MARK({k}, 0);\n" + rest)
    end = "    __syncthreads();\n  }\n}\n\n// floats of the workspace"
    if src.count(end) != 1:
        raise SystemExit("k3_timeline: ekf_update.cu no longer ends its tile loop as expected")
    src = src.replace(end, "    __syncthreads();\n  }\n  K3_MARK(14, 0);\n}\n\n// floats of the workspace")
    return src.replace("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + DEBUG)


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
        src = os.path.join(tmp, "ekf_update.cu")
        with open(os.path.join(_build.CSRC, "ekf_update.cu")) as f:
            text = instrumented_source(f.read())
        with open(src, "w") as f:
            f.write(text)
        lib_path = os.path.join(tmp, "libk3_timeline.so")
        p = Params()
        defines = chol_inv.reg_defines(2 * p.n_features_to_select)  # the build K3's wrapper asks for
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *_build.define_flags(defines), "-o", lib_path,
                            src], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(lib_path)
        _build._libs[(ekf_update.NAME, defines)] = lib      # the wrapper now launches the instrumented kernel
        read = lib.k3_marks_read
        read.argtypes = [ctypes.c_void_p]
        read.restype = ctypes.c_int
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
                print(f"D {D}: the instrumented kernel differs from the plain version", file=sys.stderr)
                return 1
            runs = []
            for _ in range(REPEATS):
                ekf_update.joint_update(*args, uc)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * (8 * N_MARKS))()
                read(ctypes.addressof(buf))
                runs.append(np.array(buf[:], dtype=np.int64).reshape(8, N_MARKS))
            print(f"D = {D}, M = {2 * NSEL} (median of {REPEATS} launches, us)")
            for label, a, b in PHASES:
                us = statistics.median((r[0, b] - r[0, a]) / 1e3 for r in runs)
                print(f"  {label:<34} {us:8.2f}")
            ends = [statistics.median((r[k, 14] - r[0, 0]) / 1e3 for r in runs) for k in range(8)]
            print("  each CTA's end, from CTA 0's start: " + ", ".join(f"{e:.2f}" for e in ends))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
