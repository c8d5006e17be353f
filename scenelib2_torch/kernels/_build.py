"""Build and load the hand-written CUDA kernels on first use.

Each source under ``csrc/`` has a plain C entry point and is compiled by
``nvcc`` into its own shared library, which is loaded with ``ctypes``. Every
library is named after the hash of its source, flags and defines, so an
edited source is rebuilt and an unchanged one is loaded from the build
directory (``scenelib2_torch/_build/``, listed in .gitignore). All missing
libraries are compiled in parallel, one ``nvcc`` process per library.

A source may also be built with defines that fix a size when compiled (a
variant: ``chol_inv.reg_defines`` gives K14 and K3 their register form at the
M of the caller's matrices); each variant is a library of its own, built on
first use beside the plain build of every source.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math``, and
``-fmad=false`` so that each float operation rounds exactly as the plain
PyTorch version's separate tensor operations do (no fused multiply-add
contraction); decisions downstream of the kernels compare floats.

Nothing here runs at import: the package imports on a machine without
``nvcc``, and only a CUDA launch reaches the build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("predict_measure", "search", "ekf_update", "propose", "shi_tomasi", "search_bayes",
           "measure", "score_map", "particle_predict", "chol_inv", "bayes", "particle_search",
           "particle_kform", "ekf_update_dense", "multi_ellipse", "ray_insert")
# the kernels that count launches: one per library, K11 (the second entry
# point of search_bayes.cu) and K8 (the second entry point of search.cu)
KERNELS = SOURCES + ("search_bayes_maps", "search_windows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# calls of each kernel's wrapper since the last reset_launches(): a wrapper
# adds one where it launches its kernel and nowhere else. A launch captured
# into a CUDA graph counts once, at the capture, and never at the graph's
# replays (runtime/replay.py), so this counts a replayed step's kernels not
# at all
launches: dict[str, int] = {n: 0 for n in KERNELS}

_libs: dict[tuple, ctypes.CDLL] = {}   # (name, defines) -> the loaded library
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


def define_flags(defines: tuple = ()) -> list[str]:
    """nvcc's -D flags for defines ((name, value), ...)."""
    return [f"-D{k}={v}" for k, v in defines]


def _lib_path(name: str, defines: tuple = ()) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join((*NVCC_FLAGS, *define_flags(defines))).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(verbose: bool = False, variants=()) -> dict[tuple, str]:
    """Compile every missing library (each source as it is, and each
    (name, defines) of variants), all nvcc processes at once; returns
    {(name, defines): library path}. Raises with nvcc's output if a build
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    keys = dict.fromkeys([(n, ()) for n in SOURCES] + [(n, tuple(d)) for n, d in variants])
    paths = {k: _lib_path(*k) for k in keys}
    todo = [k for k, p in paths.items() if not os.path.exists(p)]
    if todo:
        nvcc = find_nvcc()
        procs = {}
        for k in todo:
            n, defines = k
            tmp = paths[k] + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, *define_flags(defines), "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[k] = (proc, tmp)
        errors = []
        for k, (proc, tmp) in procs.items():
            n, defines = k
            label = " ".join([f"{n}.cu", *define_flags(defines)])
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {label}:\n{out}")
                continue
            if verbose and out:
                print(f"[nvcc {label}]\n{out}")
            os.replace(tmp, paths[k])
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (built with defines), building
    on first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(build_all(variants=(key,))[key])
            _libs[key] = lib
        return lib


def function(name: str, symbol: str, argtypes: list, defines: tuple = ()):
    """C entry point `symbol` of csrc/<name>.cu (built with defines)
    returning an int error code. argtypes must name c_void_p for every
    pointer and the stream: an undeclared argument is passed as a 32-bit C
    int."""
    fn = getattr(load(name, defines), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def n_sms(dev) -> int:
    """The streaming multiprocessors of CUDA device `dev` (a torch.device),
    for the wrappers that size their grids by it."""
    import torch

    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


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
