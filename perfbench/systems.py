"""The system under test, set up from a cell's configuration and stream,
and driven through the entry point its traffic names.

Three entry points of scenelib2_torch, as their users call them:

- run_sequence: a whole sequence a call (MonoSLAM.run_sequence: frames
  uploaded, CUDA-graph replay, the outputs fetched), reset() before each;
- go_one_step: one frame a call (MonoSLAM.go_one_step: the frame uploaded,
  one replay of the one-step graph, the pose fetched), reset() before each
  sequence;
- run_batch: every lane's sequence in one call (parallel.mesh.run_batch on
  the batched step), from the lanes' initial states each time.

Each keeps what the comparison reads of every pass (pose and decisions,
[passes, T, 7] each, of the lanes the cell samples) and, for one pass
marked as traced, its whole outputs (the work count reads them). They read
the entry points' returns and last_output's fields only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from perfbench import scene
from perfbench.reference.replay import DECISIONS

def port_params(config: dict, batch: bool = False):
    """scenelib2_torch's Params of a configuration file."""
    from scenelib2_torch.config import Params

    names = {f.name for f in dataclasses.fields(Params)}
    values = {k: v for k, v in {**config["settings"], **config["port"]["params"]}.items() if k in names}
    return Params(**values, **({"batch_mode": True} if batch else {}))


def compact(outs, lanes=None) -> tuple[np.ndarray, np.ndarray]:
    """(pose [..., 7], decisions [..., 7] int64) of StepOutputs on the CPU,
    lanes picked from the second dimension where given."""
    pose = torch.cat([outs.r, outs.q], dim=-1).double().numpy()
    dec = torch.stack([getattr(outs, k).to(torch.int64) for k in DECISIONS], dim=-1).numpy()
    if lanes is not None:
        pose, dec = pose[:, lanes], dec[:, lanes]
    return pose, dec


def work_frames(outs, lane=None) -> list:
    """The per-frame outputs that perfbench.work reads, one dict a frame
    (of one lane where given)."""
    keys = ("n_selected", "n_matched", "n_active", "n_partial", "did_init", "did_convert", "sel_mask",
            "sel_h", "sel_S", "par_mask", "par_h", "par_sinv", "par_alive")
    arrs = {k: getattr(outs, k).numpy() for k in keys}
    T = arrs["n_matched"].shape[0]
    return [{k: (a[t] if lane is None else a[t, lane]) for k, a in arrs.items()} for t in range(T)]


class _Base:
    """Common bookkeeping: the kept records and the traced pass's outputs."""

    def __init__(self):
        self.poses, self.decs = [], []
        self.traced_outs = None

    def records(self) -> tuple[np.ndarray, np.ndarray]:
        return np.stack(self.poses), np.stack(self.decs)


class SingleStream(_Base):
    """One camera: MonoSLAM on the configuration, driven through
    run_sequence or go_one_step."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: str):
        super().__init__()
        from scenelib2_torch.config import KnownFeature, SlamConfig
        from scenelib2_torch.io.pgm import write_pgm
        from scenelib2_torch.runtime.slam import MonoSLAM

        s = self.settings = config["settings"]
        self.entry = traffic["entry"]
        self.mapping = traffic["mapping"]
        self.path = traffic.get("path", "orbit")             # a name of scene.PATHS
        frames, rs, qs, patches, points = scene.stream(seed, s, traffic["frames"], s["boxsize"], device,
                                                       path=self.path)
        self.frames = frames[1:].cpu().numpy()            # the user's frames, in host memory
        self.n_steps = len(self.frames)
        self.xv0, self.pxx0 = scene.initial_filter(rs[0], qs[0], s)
        xp = tuple(np.concatenate([rs[0], qs[0]]))
        self.known = [(y, np.asarray(xp), p) for y, p in zip(points, patches)]
        kfs = []
        for k, (y, _xp, p) in enumerate(self.known):
            path = os.path.join(workdir, f"known_patch{k}.pgm")
            write_pgm(path, p)
            kfs.append(KnownFeature(y=tuple(y), xp_org=xp, patch_path=path))
        cfg = SlamConfig(params=port_params(config), xv0=self.xv0, pxx0=self.pxx0, known_features=tuple(kfs))
        self.slam = MonoSLAM(cfg, device=device, precision=config["port"]["precision"])
        self.call_walls = []
        self._kept = []            # (pose, decisions) of each kept pass of calls, on the device
        self._traced = []          # the traced pass's calls' outputs

    def reference_jobs(self, control: bool = False) -> list:
        return [dict(settings=self.settings, frames=self.frames, xv0=self.xv0, pxx0=self.pxx0,
                     known=self.known, rng_seed=0, mapping=self.mapping, control=control)]

    def warm(self, seconds: float = 0.0) -> None:
        """Passes as the window makes them, their records dropped: one, or
        as many as start within `seconds`."""
        _warm(self, seconds)
        self._kept.clear()
        self.call_walls.clear()

    def graphs(self) -> list:
        """The facade's CUDA graphs (runtime/replay.py StepGraph), for
        capture_s only: the facade keeps them in a private cache, and a
        facade without it reports no capture."""
        return list(getattr(self.slam, "_graphs", {}).values())

    def run_pass(self, keep: bool = True, spans: bool = False) -> int:
        """One sequence through the entry point; returns the frames done."""
        span = _span if spans else _no_span
        with span("bench.reset"):
            self.slam.reset()
        if self.entry == "run_sequence":
            with span("bench.run_sequence"):
                outs = self.slam.run_sequence(self.frames, enable_mapping=self.mapping)
            if keep:
                pose, dec = compact(outs)
                self.poses.append(pose)
                self.decs.append(dec)
            if spans:
                self.traced_outs = outs
            return self.n_steps
        # Each call's pose and decisions are copied into the pass's buffers on the device and
        # its outputs let go: the window holds no call's outputs, so neither the allocator nor
        # the collector has more to do in its last pass than in its first.
        dev = self.slam.device
        pose = torch.empty(self.n_steps, 7, dtype=torch.float64, device=dev)
        dec = torch.empty(self.n_steps, len(DECISIONS), dtype=torch.int64, device=dev)
        traced = []
        for t, f in enumerate(self.frames):
            with span("bench.call"):
                t0 = time.perf_counter()
                self.slam.go_one_step(f, enable_mapping=self.mapping)
                self.call_walls.append(time.perf_counter() - t0)
            out = self.slam.last_output
            torch.cat([out.r, out.q], dim=-1, out=pose[t])
            torch.stack([getattr(out, k) for k in DECISIONS], out=dec[t])
            if spans:
                traced.append(out)
        if keep:
            self._kept.append((pose, dec))
        if spans:
            self._traced = traced
        return self.n_steps

    def finish(self) -> None:
        """The kept passes' records, and the traced pass's outputs, fetched
        once the window has closed."""
        for pose, dec in self._kept:
            self.poses.append(pose.cpu().numpy())
            self.decs.append(dec.cpu().numpy())
        self._kept.clear()
        if self._traced:
            out0 = self._traced[0]
            self.traced_outs = type(out0)(*(torch.stack([getattr(o, k) for o in self._traced]).cpu()
                                            for k in out0._fields))
            self._traced = []

    def traced_work(self) -> list:
        """[(the map entering the pass: (features, partial ones), the
        traced pass's frames)]."""
        return [((len(self.known), 0), work_frames(self.traced_outs))]


class Batch(_Base):
    """Lanes of one configuration in the batched step, driven through
    run_batch."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir: str):
        super().__init__()
        from scenelib2_torch.parallel.mesh import make_batched_step, stack_states
        from scenelib2_torch.runtime import state as st

        s = self.settings = config["settings"]
        if traffic.get("path", "orbit") != "orbit":
            raise ValueError(f"camera path {traffic['path']!r}: the lanes of a batch follow the orbit only")
        self.mapping = traffic["mapping"]
        n_lanes = traffic["textures"] * traffic["offsets"]
        frames, r0, q0, patches = scene.lane_streams(seed, s, traffic["frames"], traffic["textures"],
                                                     traffic["offsets"], s["boxsize"], device)
        self.frames = frames.cpu().numpy()                # [T, B, H, W], in host memory
        self.n_steps, self.n_lanes = self.frames.shape[:2]
        self.xv0, self.pxx0 = scene.initial_filter(r0, q0, s)
        xp = np.concatenate([r0, q0])
        self.known = [[(y, xp, p) for y, p in zip(scene.KNOWN_POINTS, lane_p)] for lane_p in patches]
        self.params = port_params(config, batch=True)
        dtype = torch.float64 if config["port"]["precision"] == "f64" else torch.float32
        states = []
        for lane in range(n_lanes):
            state = st.init_state(self.params, self.xv0, self.pxx0, seed=lane, device=device, dtype=dtype)
            for y, x, p in self.known[lane]:
                state = st.add_known_feature(state, y, x, p)
            states.append(state)
        self.states0 = stack_states(states)
        self.step = make_batched_step(self.params, device=device, batch_sb=True,
                                      precision=config["port"]["precision"])
        rng = np.random.default_rng(seed)
        block, per = traffic["sample"]["block"], traffic["sample"]["per_block"]
        self.lanes = sorted(int(b + x) for b in range(0, n_lanes, block)
                            for x in rng.choice(min(block, n_lanes - b), per, replace=False))
        self.call_walls = []

    def reference_jobs(self, control: bool = False) -> list:
        return [dict(settings=self.settings, frames=np.ascontiguousarray(self.frames[:, b]), xv0=self.xv0,
                     pxx0=self.pxx0, known=self.known[b], rng_seed=b, mapping=self.mapping, control=control)
                for b in self.lanes]

    def warm(self, seconds: float = 0.0) -> None:
        _warm(self, seconds)

    def graphs(self) -> list:
        return list(self.step.graphs.values()) if hasattr(self.step, "graphs") else []

    def run_pass(self, keep: bool = True, spans: bool = False) -> int:
        from scenelib2_torch.parallel.mesh import run_batch

        span = _span if spans else _no_span
        with span("bench.run_batch"):
            _states, outs = run_batch(self.step, self.states0, self.frames, self.mapping, self.params)
        if keep:
            pose, dec = compact(outs, self.lanes)
            self.poses.append(pose)
            self.decs.append(dec)
        if spans:
            self.traced_outs = outs
        return self.n_steps * self.n_lanes

    def finish(self) -> None:
        pass

    def records(self) -> tuple[np.ndarray, np.ndarray]:
        """[passes x sampled lanes, T, 7] each, lane by lane within a pass."""
        pose = np.concatenate([p.transpose(1, 0, 2) for p in self.poses])
        dec = np.concatenate([d.transpose(1, 0, 2) for d in self.decs])
        return pose, dec

    def traced_work(self) -> list:
        return [((len(self.known[b]), 0), work_frames(self.traced_outs, b)) for b in range(self.n_lanes)]


def _warm(system, seconds: float) -> None:
    until = time.perf_counter() + seconds
    system.run_pass(keep=False)
    while time.perf_counter() < until:
        system.run_pass(keep=False)


@contextlib.contextmanager
def _no_span(_name):
    yield


def _span(name):
    return torch.profiler.record_function(name)


SYSTEMS = {"run_sequence": SingleStream, "go_one_step": SingleStream, "run_batch": Batch}
