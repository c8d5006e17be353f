"""A/B of K2 (the NSSD elliptical search) and K8 (the same on gathered windows) between source trees on one card.

    python3 scripts/ab_search_kernels.py TREE_A TREE_B TREE_B TREE_A
    python3 scripts/ab_search_kernels.py --clusters TREE
    python3 scripts/ab_search_kernels.py --wrapper TREE

Each TREE is the root of a checkout of this repo (`.` for the working tree;
unpack another commit with `git archive` into a directory that .gitignore
lists). For each TREE, in the order given, a subprocess imports that tree's
scenelib2_torch, builds its kernels there and reports, on the same seeded
inputs, each kernel's device time and a sha256 of its outputs
(scripts/ab_kernels.py). The cases are the shapes the main paths give the
kernels: K2 on one 320x240 frame (std, 10 features) and one 640x480 frame
(hires, radius 48), K2 over 64 lanes x 10 features at 320x240 (batch64,
sb0) and 16 lanes x 10 at 640x480 (batch-hires), K8 over 64 lanes x 10
(bp0). The inputs are those of chip_smoke.py's search_edge_scene of kind
"random": every feature has a seeded S^-1 of deviations 1-10.7 px (3-sigma
half-heights 3-32 px, the replays' range) and a patch cut within 4 px of
its centre. Each case's name carries its admitted share: the cells that
the geometry admits (search.candidate_geometry) over all window cells.
Every redesign keeps its plain twin bit for bit, so all trees must give
equal outputs; the script fails if they do not. Prints the card's name and
power limit, one JSON line per tree, and the median device time of each
case per distinct tree. With --clusters, times every case of TREE at each
cluster size (CTAs a feature: search.cluster_size's choice, then 1, 2, 4
and 8 forced), failing if any output differs from the choice's. With
--wrapper, prints the host microseconds a call of K8's wrapper over
64 x 10 lanes and of each of its parts take (perf_counter over 400 calls,
median of 5).
"""

from __future__ import annotations

import functools
import os
import sys

import ab_kernels

SEED = 80
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))    # the script's checkout


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py of the script's checkout, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _scene(rng, dev, n_lanes: int, c, K: int = 10):
    """K2's arguments over lanes (frame [n_lanes, H, W], the rest
    [n_lanes, K, ...]) and K8's ([n_lanes, K, ...]) for n_lanes random u8
    frames, from chip_smoke.py's search_edge_scene (its "random" kind), and
    the admitted share of their windows' cells. Call it after the tree's
    scenelib2_torch is imported: chip_smoke.py puts its own root first on
    sys.path."""
    from scenelib2_torch.kernels.search import candidate_geometry

    k2, k8 = _smoke().search_edge_scene(rng, c, dev, n_lanes, K, ("random",))
    u0, v0, uc, vc, abc = k2[2:7]
    admit = candidate_geometry(u0.reshape(-1), v0.reshape(-1), uc.reshape(-1), vc.reshape(-1),
                               abc.reshape(-1, 3), c)[0]
    return k2, k8, float(admit.float().mean())


def _cases(dev):
    """(name, kernel symbol, fn) of every timed case; fn() returns the
    kernel's outputs."""
    import dataclasses

    import numpy as np

    from scenelib2_torch.config import Params
    from scenelib2_torch.kernels import search

    rng = np.random.default_rng(SEED)
    std = search.SearchConsts.from_params(Params())
    hires = dataclasses.replace(std, H=480, W=640, win_radius=48)
    out = []
    for label, c, n_lanes in (("K2 std", std, 1), ("K2 hires", hires, 1), ("K2 64 x 10 lanes", std, 64),
                              ("K2 16 x 10 hires lanes", hires, 16)):
        k2, _k8, share = _scene(rng, dev, n_lanes, c)
        if n_lanes == 1:
            k2 = tuple(t[0] for t in k2)
        out.append((f"{label} (admitted {share:.4f})", "k2_kernel", lambda k2=k2, c=c: search.search(*k2, c)))
    _k2, k8, share = _scene(rng, dev, 64, std)
    out.append((f"K8 64 x 10 lanes (admitted {share:.4f})", "k8_kernel",
                lambda: search.search_windows(*k8, std)))
    return out


def _clusters(tree: str) -> int:
    """Every case of `tree` at each cluster size, in this process."""
    import subprocess

    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from scenelib2_torch.kernels import search

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    cases = _cases(torch.device("cuda"))
    choice = search.cluster_size
    chosen = {}

    def recorded(K, n_sms):
        chosen["size"] = choice(K, n_sms)
        return chosen["size"]

    digests = {}
    for forced in (None, 1, 2, 4, 8):
        search.cluster_size = recorded if forced is None else (lambda K, n_sms, f=forced: f)
        for name, sym, fn in cases:
            d = ab_kernels._digest(fn())
            if digests.setdefault(name, d) != d:
                print(f"{name}: outputs at cluster size {forced} differ", file=sys.stderr)
                return 1
            size = f"choice {chosen['size']}" if forced is None else f"forced {forced}"
            print(f"{name:<42} {size:<9} {ab_kernels._device_ms(fn, sym) * 1e3:9.3f} us", flush=True)
    return 0


def _host_us(fn, n: int = 400, batches: int = 5) -> float:
    """Median over batches of the host microseconds per call of fn (the
    card is faster than these host paths, so the launch queue never fills)."""
    import statistics
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(batches):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        res.append((time.perf_counter() - t) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(res)


def _wrapper(tree: str) -> int:
    """Host time of K8's wrapper (search.search_windows) over 64 x 10 lanes
    and of each of its parts, in this process."""
    import ctypes
    import subprocess

    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from scenelib2_torch.config import Params
    from scenelib2_torch.kernels import _build, search

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    import numpy as np

    dev = torch.device("cuda")
    c = search.SearchConsts.from_params(Params())
    _k2, k8, _share = _scene(np.random.default_rng(SEED), dev, 64, c)
    flat = [t.reshape(-1, *t.shape[2:]) for t in k8]
    K = flat[2].shape[0]
    B = c.boxsize
    shapes = ((K, c.side_v + B - 1, c.side_u + B - 1), (K, B, B), (K,), (K,), (K, 2), (K, 3), (K,))
    fn = _build.function(search.NAME, "k8_search_windows", search._ARGTYPES_K8)
    outs = search._outputs(K, dev)
    prm = search._params(c, K, 1, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def checks():
        for t, shp in zip(flat, shapes):
            _build.check_tensor(t, "t", t.dtype, shp)

    def call():
        return fn(*(t.data_ptr() for t in flat), *(t.data_ptr() for t in outs), K, ctypes.byref(prm), stream)

    parts = (
        ("search_windows (the whole wrapper)", lambda: search.search_windows(*k8, c)),
        ("lane reshapes (7)", lambda: [t.reshape(-1, *t.shape[2:]) for t in k8]),
        ("tensor checks (7)", checks),
        ("output allocations (5)", lambda: search._outputs(K, dev)),
        ("params struct (cluster size)", lambda: search._params(c, K, 1, dev)),
        ("current stream", lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("ctypes call (12 data_ptr, the launch)", call),
    )
    for name, f in parts:
        print(f"{name:<40} {_host_us(f):9.3f} us", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--clusters"]:
        sys.exit(_clusters(sys.argv[2]))
    if sys.argv[1:2] == ["--wrapper"]:
        sys.exit(_wrapper(sys.argv[2]))
    sys.exit(ab_kernels.run(sys.argv[1:], os.path.abspath(__file__), _cases))
