"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, one stream or one metric is a
file found by its name in BENCHMARK.json:

  configs/<config>.json    the deployment's settings and the port's route
  traffic/<traffic>.json   the stream: entry point, frames, lanes, sampling
  limits/<workload>.json   the limits of the comparison that decides correct
  metrics/<metric>.py      read(ctx) -> number or None, for every metric

A run: set-up (inputs rendered on the device from the seed, the system
built, one warm pass that captures every graph and builds and loads every
kernel; setup_s ends there), a settling stretch (passes for SETTLE_S
seconds, outside set-up and the window, so that the window finds the card's
steady pace), the window (passes back to back until `seconds` have gone,
the last one finished), and after it the reference and the comparison.
With trace on, the first pass that starts after half the window runs under
torch.profiler (the device's activities: the per-layer metrics read its
busy time against its own wall time), and the next one too (with the
host's activities: the breakdown reads it).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import compare, systems, trace, work
from perfbench.reference.replay import replay_many

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "scenelib2_tpu")
SETTLE_S = 10.0     # a fresh process runs the same graphs up to 13% slower for its first seconds (PERF.md)


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, stream, limits
    and the metrics it reports."""

    def __init__(self, workload: str, bench: dict | None = None):
        if bench is None:
            with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
                bench = json.load(f)
        w = next((w for w in bench["workloads"] if w["name"] == workload), None)
        if w is None:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.name, self.chips = w["name"], w["chips"]
        entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        with open(os.path.join(ROOT, entry["file"])) as f:
            self.config = json.load(f)
        self.traffic = _json("traffic", f"{w['traffic']}.json")
        self.limits = _json("limits", f"{self.name}.json")["limits"]

        def mine(m):
            return "workloads" not in m or self.name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def reader(name: str):
    """The read(ctx) of metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_caches() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    base = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        ref_workers: int | None = None, settle_s: float = SETTLE_S) -> tuple[dict, list]:
    """One run. Returns (the result line's object, the lines of the
    comparison for standard error). t_start: the process's start on
    time.perf_counter's clock."""
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with tempfile.TemporaryDirectory() as workdir:      # the known patches' files, which reset() reads
        return _run(cell, seed, seconds, traced, device, t_start, ref_workers, settle_s, workdir, on_card, sync)


def _run(cell, seed, seconds, traced, device, t_start, ref_workers, settle_s, workdir, on_card, sync):
    system = systems.SYSTEMS[cell.traffic["entry"]](cell.config, cell.traffic, seed, device, workdir)
    system.warm()
    sync()
    setup_s = time.perf_counter() - t_start
    capture_s = sum(g.capture_s for g in system.graphs())
    system.warm(settle_s)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gc.collect()

    frames, tr, tr_host, ends, traced_at, traced_units = 0, None, None, [], -1, 0
    t0 = time.perf_counter()
    while True:
        if traced and tr is None and time.perf_counter() - t0 >= seconds / 2:
            n, tr = trace.profile(lambda: system.run_pass(spans=True), "bench.traced_pass", host=False)
            n_host, tr_host = trace.profile(lambda: system.run_pass(spans=True), "bench.traced_pass", host=True)
            traced_at, traced_units, n = len(ends), n, n + n_host
        else:
            n = system.run_pass()
        frames += n
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    passes = np.diff([t0] + ends)
    plain = [p for i, p in enumerate(passes) if i != traced_at]      # the passes the profiler left alone
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    system.finish()

    ctx = dict(frames=frames, window_s=window_s, setup_s=setup_s, capture_s=capture_s,
               traced_units=traced_units, call_walls=system.call_walls, trace=tr, entry=cell.traffic["entry"])
    if tr is not None:
        least_s = sum(work.stretch_least_s(cell.config["settings"], start, outs)[0]
                      for start, outs in system.traced_work())
        ctx.update(least_s=least_s, traced_steps=system.n_steps)
    names = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in names:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the comparison, once the window has closed and the system is freed
    pose, dec = system.records()
    jobs = system.reference_jobs()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    workers = ref_workers if ref_workers is not None else cell.traffic.get("reference_workers", 1)
    refs = replay_many(jobs, workers)
    got = compare.numbers(pose, dec, refs, cell.limits["pose_gap_median"])
    ok, shown = compare.verdict(got, cell.limits)
    lines = [f"passes {len(passes)}: seconds min {passes.min():.4f} median {np.median(passes):.4f} "
             f"max {passes.max():.4f}; window {window_s:.4f} s, set-up {setup_s:.3f} s"]
    if tr is not None and plain:
        # the profiler's own cost: the traced pass's wall against the untraced passes' median
        lines.append(f"traced pass {tr.window_s:.4f} s, busy {tr.busy_s:.4f} s; profiler slowdown "
                     f"{tr.window_s / float(np.median(plain)):.3f}x the untraced passes' median")
    lines.append(f"frames compared {got['frames_compared']}, in records over the limit {got['frames_failed']}; "
                 f"shown, not compared: widest pose gap {got['pose_gap_widest']!r}, frames whose decisions "
                 f"differ {got['frames_off']}")
    lines += [f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in shown.items()]      # the last lines
    result = dict(correct=bool(ok), attempted=int(frames), failed=int(got["frames_failed"]), metrics=metrics,
                  device=device_info(cell, on_card, peak, tr))
    if tr is not None:
        result["breakdown"] = tr_host.breakdown()
    result["compared"] = shown
    return result, lines


def device_info(cell: Cell, on_card: bool, peak: int, tr) -> dict:
    d = dict(platform="gpu" if on_card else "cpu",
             kind=torch.cuda.get_device_name(0) if on_card else "cpu",
             count=cell.chips, memory_peak_bytes=int(peak))
    if tr is not None:
        d.update(busy_s=tr.busy_s, window_s=tr.window_s)
    return d


def control(cell: Cell, seeds: list, device) -> list:
    """The control's numbers on each seed: the reference with every stored
    number held in bfloat16, in the system's place, on the cell's inputs
    and against the reference."""
    out = []
    for seed in seeds:
        with tempfile.TemporaryDirectory() as workdir:
            system = systems.SYSTEMS[cell.traffic["entry"]](cell.config, cell.traffic, seed, device, workdir)
            jobs, cjobs = system.reference_jobs(), system.reference_jobs(control=True)
            del system
        workers = cell.traffic.get("reference_workers", 1)
        refs, ctrl = replay_many(jobs, workers), replay_many(cjobs, workers)
        pose = np.stack([c["pose"] for c in ctrl])
        dec = np.stack([c["decisions"] for c in ctrl])
        out.append(dict(seed=seed, **compare.numbers(pose, dec, refs)))
    return out
