"""MonoSLAM facade around the per-frame step.

Port of scenelib2_tpu/runtime/slam.py. Mirrors the reference's public
surface (monoslam.h:76-156):
  Init (constructor)        config load, camera, known features, srand48(0)
  GoOneStep                 one frame with or without mapping (on a CUDA
                            device one replay of a one-step CUDA graph,
                            runtime/replay.py: the counterpart of the
                            reference's one jitted dispatch)
  InitialiseAutoFeature     manual auto-init (no speed or count gates)
  InitialiseFeature         manual init at a picked pixel
  AddNewKnownFeature        a feature with known position, zero covariance
  mark/toggle/delete_feature, SavePatch, print_robot_state
  trajectory_store_         the last 1000 camera positions
plus run_sequence over a whole frame stack (CUDA-graph replay on the card,
the counterpart of the reference's compiled scan) and whole-state
checkpoints in the JAX package's file layout, so that either package reads
the other's files.

The facade's state surgery (reset, the manual inits, deletion, loading a
checkpoint) runs as tensor ops on the facade's device, outside any graph;
the next go_one_step copies the state it finds into the graph's inputs.

The entry points carry runtime/telemetry.py's spans (slam.go_one_step,
slam.run_sequence, slam.upload, slam.unpack, slam.fetch, slam.reset; the
graph replay's beneath them) and count their parts in `counters`, the
sequence's telemetry.SequenceRecord: construction and each reset() start
one. graphs() lists the telemetry.GraphRecord of each graph the facade
keeps.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from scenelib2_torch.config import Params, SlamConfig, load_config
from scenelib2_torch.convert import state_from_jax, state_to_numpy
from scenelib2_torch.core.camera import CameraParams
from scenelib2_torch.device import resolve_device, resolve_dtype
from scenelib2_torch.io.pgm import read_pgm, write_pgm
from scenelib2_torch.runtime import replay, telemetry
from scenelib2_torch.runtime import state as st
from scenelib2_torch.runtime import step as step_mod
from scenelib2_torch.runtime.state import SlamState

TRAJECTORY_LEN = 1000   # trajectory_store keeps the last this many positions


class MonoSLAM:
    def __init__(self, config: str | SlamConfig, seed: int = 0, device=None,
                 precision: str = "f32", **param_overrides):
        if isinstance(config, str):
            config = load_config(config, **param_overrides)
        elif param_overrides:
            config = dataclasses.replace(
                config, params=dataclasses.replace(config.params, **param_overrides)
            )
        self.config = config
        self.params: Params = config.params
        self.cam = CameraParams.from_params(self.params)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(precision)
        self._step = step_mod.make_step(self.params, self.device, precision)
        self.counters = telemetry.new_sequence()
        self.state: SlamState = st.init_from_config(
            config, seed=seed, device=self.device, dtype=self.dtype)
        self.trajectory_store: list[np.ndarray] = []
        self.marked_feature_label = -1
        self.selected_labels: set[int] = set()
        self.last_output: step_mod.StepOutputs | None = None
        # the CUDA graphs of go_one_step and run_sequence, one per (route,
        # enable_mapping, steps, state shapes, frame shape), at most
        # replay.MAX_GRAPHS; kept across reset() and the loads
        self._graphs: dict = {}
        self._lam0 = torch.as_tensor(st.lambda_grid(self.params), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------ API

    def go_one_step(self, frame, save_trajectory: bool = True,
                    enable_mapping: bool = True) -> bool:
        """One SLAM step (reference GoOneStep, monoslam.cpp:108-180);
        enable_mapping=False skips auto-initialisation (the reference app's
        "Enable Mapping" box).

        On a CUDA device the step is one replay of the one-step CUDA graph
        that run_sequence also replays (replay.replay_one: captured on the
        first call for each enable_mapping, then replayed), and last_output
        holds that step's outputs on the device. On the CPU the step is
        called, as _go_one_step_eager does everywhere."""
        rec = self.counters
        with rec.span("slam.go_one_step"):
            t0 = telemetry.now()
            if self.device.type != "cuda":
                self._go_one_step_eager(frame, save_trajectory, enable_mapping)
            else:
                self._go_one_step_graph(frame, save_trajectory, enable_mapping)
            rec.frames += 1
            rec.stop("call", t0)
        return True

    GoOneStep = go_one_step

    def _go_one_step_graph(self, frame, save_trajectory: bool, enable_mapping: bool) -> bool:
        rec = self.counters
        self.state, row = replay.replay_one(self._step, self._graphs, self.state, self._to_device(frame),
                                            enable_mapping, rec)
        p = self.params
        t0 = rec.start("slam.unpack")
        self.last_output = step_mod.unpack_outputs(
            row, p.n_features_to_select, max(1, p.max_features_to_init_at_once), p.n_particles)
        rec.stop(None, t0)
        if save_trajectory:
            self._record(self._fetch(self.last_output.r).numpy())
        return True

    def _go_one_step_eager(self, frame, save_trajectory: bool = True,
                           enable_mapping: bool = True) -> bool:
        """go_one_step with the step called from Python, on any device: the
        reference that the graph replay is held to. The step is a slam.step
        span and its time a launch in the counters."""
        rec = self.counters
        frame = self._to_device(frame)
        t0 = rec.start("slam.step")
        self.state, out = self._step(self.state, frame, enable_mapping)
        rec.stop_launch(1, t0)
        self.last_output = out
        if save_trajectory:
            self._record(self._fetch(out.r).numpy())
        return True

    def _record(self, r: np.ndarray) -> None:
        self.trajectory_store.append(r)
        if len(self.trajectory_store) > TRAJECTORY_LEN:
            self.trajectory_store.pop(0)

    def reset(self, seed: int = 0) -> None:
        """Reinitialise the filter from the config (keeps the graphs) and
        start a new sequence's counters."""
        self.counters = telemetry.new_sequence()
        with telemetry.span("slam.reset"):
            self.state = st.init_from_config(self.config, seed=seed, device=self.device, dtype=self.dtype)
        self.trajectory_store = []
        self.marked_feature_label = -1

    def run_sequence(self, frames, enable_mapping: bool = True,
                     chunk: int = 0) -> step_mod.StepOutputs:
        """Replay a [T,H,W] u8 frame stack; returns StepOutputs with a leading
        time axis (CPU tensors). The frames go to the device once and the
        host waits once, at the end.

        On a CUDA device the steps replay CUDA graphs (runtime/replay.py),
        as the reference's run_sequence replays its compiled scan: one graph
        of chunk steps (replay.REPLAY_BLOCK where chunk is 0) replayed once
        for each full block of frames, and a one-step graph for the frames
        past the last full block. Each graph is captured on its first use,
        so the first call on a route pays for the capture of at most two
        graphs, whatever the number of frames; this object keeps at most
        replay.MAX_GRAPHS of them. On the CPU the step is called on every
        frame, and chunk only groups the frames: the outputs are the same."""
        rec = self.counters
        with rec.span("slam.run_sequence"):
            t0 = telemetry.now()
            outs = self._replay(frames, enable_mapping, chunk, graphs=self.device.type == "cuda")
            rec.stop("sequence", t0)
        return outs

    def _run_sequence_eager(self, frames, enable_mapping: bool = True) -> step_mod.StepOutputs:
        """run_sequence with the step called from Python on every frame, on
        any device: the reference that the graph replay is held to."""
        return self._replay(frames, enable_mapping, 0, graphs=False)

    def _replay(self, frames, enable_mapping: bool, chunk: int, graphs: bool) -> step_mod.StepOutputs:
        rec = self.counters
        seq = self._to_device(frames)
        rec.frames += seq.shape[0]
        replay.chunk_plan(seq.shape[0], chunk)   # refuses a bad chunk on every device
        p = self.params
        nsel = p.n_features_to_select
        maxp = max(1, p.max_features_to_init_at_once)
        npart = p.n_particles
        flat = torch.empty((seq.shape[0], step_mod.packed_size(nsel, maxp, npart)),
                           dtype=self.dtype, device=self.device)
        if graphs:
            self.state = replay.replay_steps(self._step, self._graphs, self.state, seq, enable_mapping,
                                             chunk, flat, rec)
        else:
            self.state = replay.eager_steps(self._step, self.state, seq, enable_mapping, flat, rec)
        outs = step_mod.unpack_outputs(self._fetch(flat), nsel, maxp, npart)
        self.last_output = step_mod.StepOutputs(*(a[-1] for a in outs))
        self.trajectory_store.extend(list(outs.r.numpy()))
        self.trajectory_store = self.trajectory_store[-TRAJECTORY_LEN:]
        return outs

    def _to_device(self, frames) -> torch.Tensor:
        """u8 frame(s) from numpy or a tensor, contiguous on this device
        (slam.upload, counted as upload)."""
        rec = self.counters
        t0 = rec.start("slam.upload")
        if isinstance(frames, torch.Tensor):
            out = frames.to(device=self.device, dtype=torch.uint8).contiguous()
        else:
            out = torch.as_tensor(np.ascontiguousarray(frames, np.uint8)).to(self.device)
        rec.stop("upload", t0)
        return out

    def _fetch(self, t: torch.Tensor) -> torch.Tensor:
        """t on the host (slam.fetch, counted as wait): the host waits there
        for the device's work that t needs."""
        rec = self.counters
        t0 = rec.start("slam.fetch")
        out = t.cpu()
        rec.stop("wait", t0)
        return out

    def graphs(self) -> list[dict]:
        """The telemetry.GraphRecord of each CUDA graph the facade keeps
        (route, mapping, steps, kernel nodes by stage a step, copy nodes,
        capture seconds, replays), least recently used first."""
        return [g.record.as_dict() for g in self._graphs.values()]

    # ------------------------------------------------- manual initialisation

    def initialise_auto_feature(self, frame) -> bool:
        """Manual auto-init (reference InitialiseAutoFeature,
        monoslam.cpp:1526-1532): the region proposal (K5), the Shi-Tomasi
        pick (K6) and the ray insertion with no speed, visibility or
        partial-count gate. Returns whether a feature was proposed (JAX's
        did: a full map refuses the insertion but not the answer)."""
        self.state, did = self._step.initialise_auto(self.state, self._to_device(frame))
        return bool(did)

    InitialiseAutoFeature = initialise_auto_feature

    def initialise_feature(self, frame, uu: int, vv: int) -> bool:
        """Manual feature init at a picked pixel (reference InitialiseFeature,
        monoslam.cpp:1211-1235: copy_into_patch at (uu, vv) + partial ray
        insertion with the uniform lambda particle grid). The reference's GUI
        sets (uu, vv) from a mouse click (pangolin_util.cpp:57-81)."""
        B = self.params.boxsize
        half = (B - 1) // 2
        W, H = self.params.cam_width, self.params.cam_height
        uu, vv = int(uu), int(vv)
        if not (half <= uu < W - half and half <= vv < H - half):
            return False
        frame = self._to_device(frame)
        patch = frame[vv - half : vv + half + 1, uu - half : uu + half + 1]
        n_before = int(self.state.active.sum())
        z = torch.tensor([float(uu), float(vv)], dtype=self.state.x.dtype, device=self.device)
        self.state = st.add_partial_feature(self.state, self.cam, z, patch, self._lam0,
                                            torch.ones((), dtype=torch.bool, device=self.device))
        return int(self.state.active.sum()) > n_before

    InitialiseFeature = initialise_feature

    def add_new_known_feature(self, y, xp_org, patch) -> None:
        """Reference AddNewKnownFeature (monoslam.cpp:1278-1291); patch is an
        11x11 u8 array or the path of a PGM file."""
        if isinstance(patch, str):
            patch = read_pgm(patch)
        self.state = st.add_known_feature(self.state, y, xp_org, patch)

    AddNewKnownFeature = add_new_known_feature

    # ------------------------------------------------- feature bookkeeping

    def _slot_of_label(self, label: int) -> int | None:
        hits = np.flatnonzero(self.state.active.cpu().numpy() & (self.state.label.cpu().numpy() == label))
        return int(hits[0]) if len(hits) else None

    def mark_feature_by_lab(self, label: int) -> None:
        """Reference mark_feature_by_lab (monoslam.cpp:742-766), including
        its quirk: the existence search runs only for lab > 0, so ANY
        non-positive label (0, -2, ...) is accepted whenever the feature
        list is non-empty, and -1 ("no selection") is always accepted."""
        label = int(label)
        if label > 0:
            if self._slot_of_label(label) is None:
                return
        elif label != -1 and not bool(self.state.active.any()):
            return
        self.marked_feature_label = label

    def toggle_feature_lab(self, label: int) -> bool:
        """Manual (de)selection bookkeeping (reference monoslam.cpp:710-724).
        As in the reference, auto-selection clears the selected set at the
        start of every GoOneStep, so manual toggles only matter for
        inspection flows between steps."""
        if self._slot_of_label(label) is None:
            return False
        if label in self.selected_labels:
            self.selected_labels.discard(label)
        else:
            self.selected_labels.add(label)
        return True

    def delete_feature(self, label: int | None = None) -> bool:
        """Delete the marked (or given-label) feature (monoslam.cpp:770-812)."""
        if label is None:
            label = self.marked_feature_label
        slot = self._slot_of_label(label)
        if slot is None:
            return False
        kill = torch.arange(self.params.max_features, device=self.device) == slot
        self.state = st.delete_mask(self.state, kill)
        self.marked_feature_label = -1
        return True

    def save_patch(self, path: str = "patch.pgm") -> bool:
        """Reference SavePatch (monoslam.cpp:1551-1572)."""
        slot = self._slot_of_label(self.marked_feature_label)
        if slot is None:
            return False
        write_pgm(path, self.state.patches[slot].cpu().numpy())
        return True

    SavePatch = save_patch

    # ------------------------------------------------------- introspection

    @property
    def xv(self) -> np.ndarray:
        return self.state.x[:13].cpu().numpy()

    @property
    def pxx(self) -> np.ndarray:
        return self.state.P[:13, :13].cpu().numpy()

    def print_robot_state(self) -> str:
        s = f"[Robot state]\n{self.xv}\n[Robot covariance]\n{self.pxx}"
        print(s)
        return s

    def feature_table(self) -> list[dict]:
        active = self.state.active.cpu().numpy()
        full = self.state.full.cpu().numpy()
        label = self.state.label.cpu().numpy()
        att = self.state.attempts.cpu().numpy()
        suc = self.state.successes.cpu().numpy()
        x = self.state.x.cpu().numpy()
        out = []
        for i in np.flatnonzero(active):
            off = st.slot_offset(int(i))
            out.append(dict(
                slot=int(i), label=int(label[i]), fully_initialised=bool(full[i]),
                y=x[off : off + (3 if full[i] else 6)].copy(),
                attempts=int(att[i]), successes=int(suc[i]),
            ))
        return out

    def trajectory(self) -> np.ndarray:
        return np.asarray(self.trajectory_store)

    # ------------------------------------------------------------- state I/O

    def load_state(self, state: SlamState) -> None:
        """Adopt a state (e.g. from convert.state_from_jax) after checking its
        shapes against this configuration."""
        for name, want, got in zip(SlamState._fields, self.state, state):
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"state field '{name}' has shape {tuple(got.shape)} but this "
                    f"configuration expects {tuple(want.shape)}"
                )
        self.state = SlamState(*(g.to(device=self.device, dtype=w.dtype)
                                 for w, g in zip(self.state, state)))

    def save_checkpoint(self, path: str) -> None:
        """Whole-state checkpoint in the JAX package's layout: an npz of
        state_<field> arrays with the JAX package's dtypes (written as
        np.savez_compressed writes `path`), and `path`.json with the params
        and the marked label."""
        arrays = {f"state_{k}": v for k, v in state_to_numpy(self.state).items()}
        np.savez_compressed(path, **arrays)
        meta = dict(params=self.params.__dict__, marked=self.marked_feature_label)
        with open(path + ".json", "w") as f:
            json.dump(meta, f, default=float)

    def load_checkpoint(self, path: str) -> None:
        """Load a checkpoint that either package wrote, with the JAX loader's
        rules: a file without `sched` or `patch_rows` (older writers) gets
        them (all False; derived from the patches); unknown or missing
        fields and a shape this configuration cannot hold raise ValueError;
        a dtype that differs is cast (an f64 file from JAX's parity mode
        loads into the f32 port)."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as data:
            fields = {k[len("state_"):]: data[k] for k in data.files}
        tmpl = self.state._asdict()
        unknown = sorted(set(fields) - set(tmpl))
        if unknown:
            raise ValueError(
                f"checkpoint {path!r} has unknown state fields {unknown} "
                "(written by a newer version?)"
            )
        # state_from_jax supplies these two for older writers
        missing = sorted(set(tmpl) - set(fields) - {"sched", "patch_rows"})
        if missing:
            raise ValueError(f"checkpoint {path!r} is missing state fields {missing}")
        p = self.params
        for k, got in fields.items():
            want = tmpl[k]
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint field '{k}' has shape {tuple(got.shape)} but "
                    f"this configuration (max_features={p.max_features}, "
                    f"n_particles={p.n_particles}, "
                    f"max_features_to_init_at_once={p.max_features_to_init_at_once}) expects "
                    f"{tuple(want.shape)} — was the checkpoint written with a "
                    "different capacity config?"
                )
        self.load_state(state_from_jax(fields, self.device, self.dtype))

    # the loader of the JAX package's files is the same loader
    load_jax_checkpoint = load_checkpoint
