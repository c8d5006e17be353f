"""What the A/B scripts of kernels between source trees share
(scripts/ab_particle_kernels.py, scripts/ab_update_kernels.py,
scripts/ab_search_kernels.py, scripts/ab_predict_st_kernels.py,
scripts/ab_propose_measure_kernels.py).

A script gives run() its list of trees and a cases(dev) function that
returns (name, kernel symbol, fn) for every timed case, fn() returning the
kernel's outputs. For each tree, in the order given, a subprocess (the
script itself with --one TREE) imports that tree's scenelib2_torch, builds
its kernels there and reports each case's device time (the median over
REPEATS traced loops of N_CALLS calls, torch.profiler, the kernel's own
device time per launch seen; with the symbol None, the device time of every
kernel the call launches, per call, and their number), the wall time of a
call (the median over REPEATS loops of N_CALLS calls back to back, one
synchronisation at the end: the wrapper's host time where the host sets the
pace) and a sha256 of its outputs. A tree may lack a case (a shape its
kernel refuses). Prints the card's name and power limit, one JSON line per
tree and the median device and wall time of each case per distinct tree;
fails if any output differs between the trees that have the case.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

N_CALLS = 50
REPEATS = 5
TRIES = 3      # traced loops in which the profiler saw no launch of the kernel, at most


def _digest(outs) -> str:
    import torch

    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().to("cpu").reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _traced(fn, sym: str | None) -> list[tuple[float, int]]:
    """(device ms, launches) of the kernels whose name holds sym (every
    kernel for None) in each of REPEATS traced loops of N_CALLS calls. A
    loop in which the profiler recorded no launch of the kernel (it happens
    now and then after many traced loops in one process) is traced again,
    at most TRIES times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    res = []
    for _ in range(REPEATS):
        for _try in range(TRIES):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(N_CALLS):
                    fn()
                torch.cuda.synchronize()
            total, count = 0.0, 0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and (sym is None or sym in e.key):
                    us = getattr(e, "self_device_time_total", None)
                    total += (us if us is not None else e.self_cuda_time_total) / 1e3
                    count += e.count
            if count:
                break
        if count == 0:
            seen = sorted({e.key[:40] for e in prof.key_averages()})[:8]
            raise SystemExit(f"{sym}: the profiler saw no launch in {TRIES} traced loops (it saw {seen})")
        res.append((total, count))
    return res


def _device_ms(fn, sym: str) -> float:
    """Median over the traced loops of the kernel's device time per launch."""
    return statistics.median(total / count for total, count in _traced(fn, sym))


def _call_ms(fn) -> tuple[float, float]:
    """Median over the traced loops of the device time of every kernel a
    call launches, per call; and the kernels a call launches."""
    res = _traced(fn, None)
    return statistics.median(total / N_CALLS for total, _c in res), res[-1][1] / N_CALLS


def _wall_ms(fn) -> float:
    """Median over REPEATS loops of the wall time of a call, N_CALLS calls
    back to back and one synchronisation at the end."""
    import torch

    res = []
    for _ in range(REPEATS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_CALLS):
            fn()
        torch.cuda.synchronize()
        res.append((time.perf_counter() - t0) / N_CALLS * 1e3)
    return statistics.median(res)


def one_tree(tree: str, cases) -> dict:
    """Time every case with the scenelib2_torch of `tree` (run in its own process)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import scenelib2_torch

    if not os.path.abspath(scenelib2_torch.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise SystemExit(f"imported {scenelib2_torch.__file__}, not the package of {tree}")
    dev = torch.device("cuda")
    rec = {"tree": tree}
    for name, sym, fn in cases(dev):
        outs = fn()
        torch.cuda.synchronize()
        if sym is None:
            ms, kernels = _call_ms(fn)
            rec[name] = {"ms": ms, "kernels": kernels, "digest": _digest(outs)}
        else:
            rec[name] = {"ms": _device_ms(fn, sym), "digest": _digest(outs)}
        rec[name]["wall_ms"] = _wall_ms(fn)
    return rec


def _compare(trees: list[str], script: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no card")
    recs = []
    for tree in trees:
        res = subprocess.run([sys.executable, script, "--one", tree], capture_output=True,
                             text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        recs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(recs[-1]), flush=True)
    names = list(dict.fromkeys(k for r in recs for k in r if k != "tree"))
    bad = [n for n in names if len({r[n]["digest"] for r in recs if n in r}) != 1]
    for tree in dict.fromkeys(trees):
        for n in names:
            got = [r[n] for r in recs if r["tree"] == tree and n in r]
            if not got:
                continue
            ms = statistics.median(g["ms"] for g in got)
            wall = statistics.median(g["wall_ms"] for g in got)
            per = f"  ({got[0]['kernels']:.0f} kernels a call)" if "kernels" in got[0] else ""
            print(f"{tree:>24}  {n:<26} {ms * 1e3:9.3f} us, wall {wall * 1e3:9.3f} us{per}")
    if bad:
        print(f"outputs differ between trees: {bad}", file=sys.stderr)
        return 1
    return 0


def run(argv: list[str], script: str, cases) -> int:
    """The script's entry point: `--one TREE` times one tree (the
    subprocess), else argv lists the trees to compare."""
    if argv[:1] == ["--one"]:
        print(json.dumps(one_tree(argv[1], cases)))
        return 0
    return _compare(argv, script)
