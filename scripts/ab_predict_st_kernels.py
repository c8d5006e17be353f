"""A/B of K1 (fused predict + measure + select) and K6 (the Shi-Tomasi pick) between source trees on one card.

    python3 scripts/ab_predict_st_kernels.py TREE_A TREE_B TREE_B TREE_A
    python3 scripts/ab_predict_st_kernels.py --grid TREE

Each TREE is the root of a checkout of this repo (`.` for the working tree;
unpack another commit with `git archive` into a directory that .gitignore
lists). For each TREE, in the order given, a subprocess imports that tree's
scenelib2_torch, builds its kernels there and reports, on the same seeded
inputs, each kernel's device time and a sha256 of its outputs
(scripts/ab_kernels.py). The cases are the shapes the main paths give the
kernels: K1 at the std map (D = 109, 320x240) and at hires (D = 373,
640x480), from chip_smoke.py's k1_random_scene (10% of the active slots
partial); K6 on one 320x240 frame (the single stream), over 64 lanes of
320x240 (batch64, sb0) and over 16 lanes of 640x480 (batch-hires), an
80 x 60 region of cells on seeded noise. Every redesign keeps its plain twin
bit for bit, so all trees must give equal outputs; the script fails if they
do not. Prints the card's name and power limit, one JSON line per tree, and
the median device time of each case per distinct tree. With --grid, times
every case of TREE at each grid shape: K1 at 1, 2, 4 and 8 float4 units a
copy thread (predict_measure.UNITS_PER_THREAD, which sets the copy CTAs)
and K6 at 1, 2, 4 and 8 CTAs a lane (shi_tomasi.cluster_size forced),
failing if any output differs from the wrapper's own choice.
"""

from __future__ import annotations

import functools
import os
import sys

import ab_kernels

SEED = 90
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))    # the script's checkout


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py of the script's checkout, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _cases(dev):
    """(name, kernel symbol, fn) of every timed case; fn() returns the
    kernel's outputs. Call it after the tree's scenelib2_torch is imported:
    chip_smoke.py puts its own root first on sys.path."""
    import dataclasses

    import numpy as np
    import torch

    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.synthetic import HIRES_PARAMS
    from scenelib2_torch.kernels import predict_measure, shi_tomasi
    from scenelib2_torch.kernels.measure import MeasureConsts

    rng = np.random.default_rng(SEED)
    std = Params()
    hires = dataclasses.replace(std, **HIRES_PARAMS)
    out = []
    for label, p in (("K1 std (D 109)", std), ("K1 hires (D 373)", hires)):
        a1 = _smoke().k1_random_scene(rng, p, dev)
        kw = dict(nsel=p.n_features_to_select, maxp=1, dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha,
                  consts=MeasureConsts.from_params(p))
        out.append((label, "k1_kernel", lambda a1=a1, kw=kw: predict_measure.predict_measure(*a1, **kw)))
    kw6 = dict(boxsize=std.boxsize, region_w=std.init_search_width, region_h=std.init_search_height)
    i32 = dict(dtype=torch.int32, device=dev)
    for label, n, (H, W) in (("K6 single 320x240", None, (240, 320)), ("K6 64 lanes 320x240", 64, (240, 320)),
                             ("K6 16 lanes 640x480", 16, (480, 640))):
        shp = () if n is None else (n,)
        frame = torch.tensor(rng.integers(0, 256, (*shp, H, W), dtype=np.uint8), device=dev)
        us = torch.tensor(rng.integers(6, W - 90, shp), **i32)
        vs = torch.tensor(rng.integers(6, H - 70, shp), **i32)
        a6 = (frame, us, vs, us + kw6["region_w"], vs + kw6["region_h"])
        out.append((label, "k6_kernel", lambda a6=a6: shi_tomasi.shi_tomasi(*a6, **kw6)))
    return out


def _grid(tree: str) -> int:
    """Every case of `tree` at each grid shape, in this process."""
    import subprocess

    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from scenelib2_torch.kernels import _build, predict_measure, shi_tomasi

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    cases = _cases(torch.device("cuda"))
    units, choice = predict_measure.UNITS_PER_THREAD, shi_tomasi.cluster_size
    chosen = {}

    def recorded(n_lanes, n_sms):
        chosen["k6"] = choice(n_lanes, n_sms)
        return chosen["k6"]

    digests = {}
    for forced in (None, 1, 2, 4, 8):
        predict_measure.UNITS_PER_THREAD = units if forced is None else forced
        shi_tomasi.cluster_size = recorded if forced is None else (lambda n_lanes, n_sms, f=forced: f)
        for name, sym, fn in cases:
            d = ab_kernels._digest(fn())
            if digests.setdefault(name, d) != d:
                print(f"{name}: outputs at grid {forced} differ", file=sys.stderr)
                return 1
            if name.startswith("K1"):
                D = fn()[2].shape[0]
                n_copy = predict_measure.copy_ctas(D, _build.n_sms(torch.device("cuda")))
                shape = f"{predict_measure.UNITS_PER_THREAD} units/thread, {n_copy} copy CTAs"
                shape = ("choice: " if forced is None else "forced: ") + shape
            else:
                shape = f"choice {chosen['k6']} CTAs/lane" if forced is None else f"forced {forced} CTAs/lane"
            print(f"{name:<24} {shape:<40} {ab_kernels._device_ms(fn, sym) * 1e3:9.3f} us", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid"]:
        sys.exit(_grid(sys.argv[2]))
    sys.exit(ab_kernels.run(sys.argv[1:], os.path.abspath(__file__), _cases))
