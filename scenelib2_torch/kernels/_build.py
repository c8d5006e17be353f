"""Build and load the hand-written CUDA kernels on first use.

Each source under ``csrc/`` has a plain C entry point and is compiled by
``nvcc`` into its own shared library, which is loaded with ``ctypes``. Every
library is named after the hash of its source and flags, so an edited source
is rebuilt and an unchanged one is loaded from the build directory
(``scenelib2_torch/_build/``, listed in .gitignore). All missing libraries
are compiled in parallel, one ``nvcc`` process per source.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math``, and
``-fmad=false`` so that each float operation rounds exactly as the plain
PyTorch version's separate tensor operations do (no fused multiply-add
contraction); decisions downstream of the kernels compare floats.

Nothing here runs at import: the package imports on a machine without
``nvcc``, and only a CUDA launch reaches the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("predict_measure", "search", "ekf_update", "propose", "shi_tomasi", "search_bayes",
           "measure", "score_map", "particle_predict", "chol_inv", "bayes", "particle_search")
# the kernels that count launches: one per library, K11 (the second entry
# point of search_bayes.cu) and K8 (the second entry point of search.cu)
KERNELS = SOURCES + ("search_bayes_maps", "search_windows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# launches of each kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else
launches: dict[str, int] = {n: 0 for n in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for n in launches:
        launches[n] = 0


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use and need the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every missing library, all nvcc processes at once; returns
    {name: library path}. Raises with nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n, p in paths.items() if not os.path.exists(p)]
    if todo:
        nvcc = find_nvcc()
        procs = {}
        for n in todo:
            tmp = paths[n] + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[n] = (proc, tmp)
        errors = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{out}")
                continue
            if verbose and out:
                print(f"[nvcc {n}.cu]\n{out}")
            os.replace(tmp, paths[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all()[name])
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: list):
    """C entry point `symbol` of csrc/<name>.cu returning an int error code.
    argtypes must name c_void_p for every pointer and the stream: an
    undeclared argument is passed as a 32-bit C int."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_tensor(t, name: str, dtype, shape) -> None:
    """What a kernel takes: a contiguous CUDA tensor of this dtype and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError after
    the launch): a refused launch never runs and a later synchronize does
    not report it."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
