"""Where K4's, K11's and K13's time goes: the phases of one launch, timed on the card.

    python3 scripts/sb_timeline.py [TREE]

TREE is the root of a checkout of this repo (default: the script's own; unpack
another commit with `git archive` into a directory that .gitignore lists).
Builds instrumented copies of TREE's scenelib2_torch/kernels/csrc/
search_bayes.cu and particle_search.cu in a temporary directory: thread 0 of
each block reads %globaltimer at the phase boundaries and stores it in a
device array. The kernels mark their boundaries with SB_MARK(k) (and
SB_MARK_ALL(k), once every thread is there; no-ops unless this script
defines them); a source without them, the single-block kernels of earlier
commits, gets its marks inserted at the texts of PLAIN_ANCHORS. Runs K4,
K11 and K13 through TREE's wrappers on the seeded inputs of
scripts/ab_particle_kernels.py: K4 std (100 particles, 320x240, 16 slots),
K4 hires (200, 640x480, 60 slots), K11 and K13 over 64 blocks of 100
particles and over 16 blocks of 200 at 640x480. Checks the instrumented kernel's outputs
against the plain version, then prints the card's name and power limit and,
per case, the median over REPEATS launches of each phase on block 0 (from
the previous mark that block stamped, in microseconds), the median over
blocks where there are many, and each block's end from the earliest start.
The instrumented kernel computes what the kernel computes but runs
slightly slower.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

REPEATS = 9
N_MARKS = 16
MAX_BLOCKS = 1024
CASES = ("K4 std NP 100", "K4 hires NP 200", "K11 64 blocks NP 100", "K11 16 blocks NP 200 640x480",
         "K13 64 blocks NP 100", "K13 16 blocks NP 200 640x480")

# the phase that ends at each mark
LABELS = {
    1: "prologue", 2: "particle chain", 3: "union box, region (read box)",
    4: "scores (cluster barrier)", 15: "read box staged", 5: "search (cluster barrier; K13: the block's end)",
    6: "sum total",
    7: "sum n_alive (pass 1: total, n_alive)", 8: "sum total2 (pass 2)", 9: "sum n_alive_f", 10: "sum mean",
    11: "sum exp2", 12: "sum n_over (pass 3: the four)", 13: "tail's outputs", 14: "pass-through, end",
}

# (file, text, mark, where) for a source without SB_MARK: the mark goes
# before the text, after it, or after its first line ("mid")
PLAIN_ANCHORS = (
    ("search_bayes.cu", "  // ---- 1. prologue, particle chain", 0, "before"),
    ("search_bayes.cu", "    if (t < 128) patch[t] = patch_row[t];\n    __syncthreads();\n  }\n", 1, "after"),
    ("search_bayes.cu", "  __syncthreads();\n\n  // ---- 2. union box", 2, "mid"),
    ("search_bayes.cu", "  __syncthreads();\n  const int v_lo = scan[0]", 3, "mid"),
    ("search_bayes.cu", "      ws[v * W + u] = penalized_score(frame, patch, v, u, p);\n    }\n    __syncthreads();\n",
     4, "after"),
    ("search_bayes.cu", "  __syncthreads();\n\n  // ---- 5. Bayes tail", 5, "mid"),
    ("bayes_tail.cuh", "  const float total = tree_sum<NC>(v, nc, buf, width);\n", 6, "after"),
    ("bayes_tail.cuh", "  const float n_alive = tree_sum<NC>(v, nc, buf, width);\n", 7, "after"),
    ("bayes_tail.cuh", "  const float total2 = tree_sum<NC>(prob_k, nc, buf, width);\n", 8, "after"),
    ("bayes_tail.cuh", "  const float n_alive_f = tree_sum<NC>(v, nc, buf, width);\n", 9, "after"),
    ("bayes_tail.cuh", "  const float mean = tree_sum<NC>(v, nc, buf, width);\n", 10, "after"),
    ("bayes_tail.cuh", "  const float exp2 = tree_sum<NC>(v, nc, buf, width);\n", 11, "after"),
    ("bayes_tail.cuh", "  const float n_over = tree_sum<NC>(v, nc, buf, width);\n", 12, "after"),
    ("search_bayes.cu", "  if (!PRE) {\n    // every other row passes through", 13, "before"),
    ("search_bayes.cu", "    nover_o[blk] = res.n_over;\n  }\n}\n", 14, "end"),
    ("particle_search.cu", "  for (int q = warp; q < p.P; q += n_warps) {\n", 0, "before"),
    ("particle_search.cu", "      key_o[(size_t)blk * p.P + q] = nan ? -1 : key;\n    }\n  }\n}\n", 5, "end"),
)
KERNEL_SOURCES = ("search_bayes.cu", "particle_search.cu")

DEBUG = '''__device__ unsigned long long sb_marks[%d * %d];
extern "C" int sb_marks_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, sb_marks, sizeof(sb_marks));
}
extern "C" int sb_marks_clear() {
  static unsigned long long z[%d * %d];
  return (int)cudaMemcpyToSymbol(sb_marks, z, sizeof(z));
}
#define SB_MARK(k)                                                             \\
  do {                                                                         \\
    if (threadIdx.x == 0) {                                                    \\
      unsigned long long g_;                                                   \\
      asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g_));                  \\
      sb_marks[blockIdx.x * %d + (k)] = g_;                                    \\
    }                                                                          \\
  } while (0)
#define SB_MARK_ALL(k) \\
  do {                 \\
    __syncthreads();   \\
    SB_MARK(k);        \\
  } while (0)
''' % (MAX_BLOCKS, N_MARKS, MAX_BLOCKS, N_MARKS, N_MARKS)


def instrumented(tree_csrc: str, out_dir: str, kernel: str) -> str:
    """Copy `kernel` (a .cu of KERNEL_SOURCES) and the headers into out_dir
    with the marks on; returns the path of the copy of `kernel`."""
    texts = {}
    for fn in os.listdir(tree_csrc):
        if fn.endswith(".cuh") or fn == kernel:
            with open(os.path.join(tree_csrc, fn)) as f:
                texts[fn] = f.read()
    if "SB_MARK(" not in texts[kernel]:
        for fn, anchor, k, where in PLAIN_ANCHORS:
            if fn != kernel and not (fn.endswith(".cuh") and kernel == "search_bayes.cu"):
                continue
            if texts[fn].count(anchor) != 1:
                raise SystemExit(f"sb_timeline: {fn} has no single phase boundary {anchor!r}")
            mark = f"  SB_MARK({k});\n"
            if where == "before":
                rep = mark + anchor
            elif where == "after":
                rep = anchor + mark
            elif where == "mid":
                first, rest = anchor.split("\n", 1)
                rep = first + "\n" + mark + rest
            else:  # the block's last statement: every thread done
                rep = anchor[: -len("}\n")] + "  __syncthreads();\n" + mark + "}\n"
            texts[fn] = texts[fn].replace(anchor, rep)
    # the macro before any include, so the headers see it too
    texts[kernel] = "#include <cuda_runtime.h>\n" + DEBUG + texts[kernel]
    for fn, text in texts.items():
        with open(os.path.join(out_dir, fn), "w") as f:
            f.write(text)
    return os.path.join(out_dir, kernel)


def same_bits(a, b) -> bool:
    """Equal bit for bit, any NaN equal to any NaN."""
    import torch

    if a.dtype != torch.float32:
        return torch.equal(a, b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


def report(name: str, runs, n_blocks: int) -> None:
    """Block 0's phases, the other blocks' medians, the blocks' ends."""
    import numpy as np

    print(f"{name} (median of {len(runs)} launches, us)")
    stamped = sorted({k for r in runs for k in range(N_MARKS) if r[0, k] != 0})
    order = sorted(stamped, key=lambda k: statistics.median(int(r[0, k]) for r in runs))
    for a, b in zip(order, order[1:]):
        us0 = statistics.median((int(r[0, b]) - int(r[0, a])) / 1e3 for r in runs)
        line = f"  {LABELS.get(b, f'mark {b}'):<38} {us0:8.2f}"
        if n_blocks > 1:
            per = [statistics.median((int(r[i, b]) - int(r[i, a])) / 1e3 for r in runs)
                   for i in range(n_blocks) if all(r[i, a] and r[i, b] for r in runs)]
            if per:
                line += f"   blocks: median {statistics.median(per):8.2f}, max {max(per):8.2f}"
        print(line)
    starts = [np.min(r[:n_blocks][r[:n_blocks] > 0]) for r in runs]
    ends = [[(int(r[i].max()) - int(s)) / 1e3 for i in range(n_blocks)] for r, s in zip(runs, starts)]
    med = [statistics.median(e[i] for e in ends) for i in range(n_blocks)]
    if n_blocks <= 16:
        print("  each block's end, from the first start: " + ", ".join(f"{e:.2f}" for e in med))
    else:
        print(f"  blocks' ends, from the first start: median {statistics.median(med):.2f}, max {max(med):.2f}")


def main() -> int:
    import numpy as np
    import torch

    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else REPO)
    sys.path.insert(0, tree)
    from scenelib2_torch.kernels import _build, particle_search, search_bayes

    import ab_particle_kernels

    if not os.path.abspath(search_bayes.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {search_bayes.__file__}, not the package of {tree}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    print(f"tree: {tree}")
    tmp = tempfile.mkdtemp()
    try:
        libs = {}
        for kernel, mod in zip(KERNEL_SOURCES, (search_bayes, particle_search)):
            out = os.path.join(tmp, kernel[:-3])
            os.makedirs(out)
            src = instrumented(_build.CSRC, out, kernel)
            lib_path = os.path.join(out, "libsb_timeline.so")
            r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src], capture_output=True,
                               text=True)
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            lib = ctypes.CDLL(lib_path)
            _build._libs[(mod.NAME, ())] = lib    # the wrappers now launch the instrumented kernels
            lib.sb_marks_read.argtypes = [ctypes.c_void_p]
            lib.sb_marks_read.restype = lib.sb_marks_clear.restype = ctypes.c_int
            libs[mod.NAME] = lib
        cases = {name: fn for name, _sym, fn in ab_particle_kernels._cases(torch.device("cuda"))}
        for name in CASES:
            fn = cases[name]
            lib = libs[particle_search.NAME if name.startswith("K13") else search_bayes.NAME]
            read, clear = lib.sb_marks_read, lib.sb_marks_clear
            got = fn()
            args = fn.__defaults__[0]
            plain = (search_bayes.search_bayes_plain if name.startswith("K4") else
                     particle_search.particle_search_plain if name.startswith("K13") else
                     search_bayes.search_bayes_maps_plain)
            want = plain(*args)
            torch.cuda.synchronize()
            if not all(same_bits(g, w) for g, w in zip(got, want)):
                print(f"{name}: the instrumented kernel differs from the plain version", file=sys.stderr)
                return 1
            runs = []
            for _ in range(REPEATS):
                clear()
                fn()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * (MAX_BLOCKS * N_MARKS))()
                read(ctypes.addressof(buf))
                runs.append(np.array(buf[:], dtype=np.uint64).astype(np.int64).reshape(MAX_BLOCKS, N_MARKS))
            report(name, runs, int((runs[0].max(axis=1) > 0).sum()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
