"""MonoSLAM facade around the per-frame step.

Port of scenelib2_tpu/runtime/slam.py. Mirrors the reference's public
surface (monoslam.h:76-156): the constructor (config, camera, known
features), GoOneStep with or without mapping (auto-initialisation and the
partial-feature particle stage), the trajectory record, plus run_sequence
over a whole frame stack (on a CUDA device as CUDA-graph replay,
runtime/replay.py: the counterpart of the reference's compiled scan) and
loading a JAX checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scenelib2_torch.config import Params, SlamConfig, load_config
from scenelib2_torch.convert import state_from_jax
from scenelib2_torch.device import resolve_device, resolve_dtype
from scenelib2_torch.runtime import replay
from scenelib2_torch.runtime import state as st
from scenelib2_torch.runtime import step as step_mod
from scenelib2_torch.runtime.state import SlamState

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
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(precision)
        self._step = step_mod.make_step(self.params, self.device, precision)
        self.state: SlamState = st.init_from_config(
            config, seed=seed, device=self.device, dtype=self.dtype)
        self.trajectory_store: list[np.ndarray] = []
        self.last_output: step_mod.StepOutputs | None = None
        # run_sequence's CUDA graphs, one per (route, enable_mapping, steps,
        # state shapes, frame shape), at most replay.MAX_GRAPHS; kept across
        # reset() and load_state()
        self._graphs: dict = {}

    # ------------------------------------------------------------------ API

    def go_one_step(self, frame, save_trajectory: bool = True,
                    enable_mapping: bool = True) -> bool:
        """One SLAM step (reference GoOneStep, monoslam.cpp:108-180);
        enable_mapping=False skips auto-initialisation (the reference app's
        "Enable Mapping" box)."""
        self.state, out = self._step(self.state, self._to_device(frame), enable_mapping)
        self.last_output = out
        if save_trajectory:
            self.trajectory_store.append(out.r.cpu().numpy())
            if len(self.trajectory_store) > 1000:
                self.trajectory_store.pop(0)
        return True

    GoOneStep = go_one_step

    def reset(self, seed: int = 0) -> None:
        """Reinitialise the filter from the config."""
        self.state = st.init_from_config(self.config, seed=seed, device=self.device, dtype=self.dtype)
        self.trajectory_store = []

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
        return self._replay(frames, enable_mapping, chunk, graphs=self.device.type == "cuda")

    def _run_sequence_eager(self, frames, enable_mapping: bool = True) -> step_mod.StepOutputs:
        """run_sequence with the step called from Python on every frame, on
        any device: the reference that the graph replay is held to."""
        return self._replay(frames, enable_mapping, 0, graphs=False)

    def _replay(self, frames, enable_mapping: bool, chunk: int, graphs: bool) -> step_mod.StepOutputs:
        seq = self._to_device(frames)
        replay.chunk_plan(seq.shape[0], chunk)   # refuses a bad chunk on every device
        p = self.params
        nsel = p.n_features_to_select
        maxp = max(1, p.max_features_to_init_at_once)
        npart = p.n_particles
        flat = torch.empty((seq.shape[0], step_mod.packed_size(nsel, maxp, npart)),
                           dtype=self.dtype, device=self.device)
        if graphs:
            self.state = replay.replay_steps(self._step, self._graphs, self.state, seq, enable_mapping,
                                             chunk, flat)
        else:
            self.state = replay.eager_steps(self._step, self.state, seq, enable_mapping, flat)
        outs = step_mod.unpack_outputs(flat.cpu(), nsel, maxp, npart)
        self.last_output = step_mod.StepOutputs(*(a[-1] for a in outs))
        self.trajectory_store.extend(list(outs.r.numpy()))
        self.trajectory_store = self.trajectory_store[-1000:]
        return outs

    def _to_device(self, frames) -> torch.Tensor:
        """u8 frame(s) from numpy or a tensor, contiguous on this device."""
        if isinstance(frames, torch.Tensor):
            return frames.to(device=self.device, dtype=torch.uint8).contiguous()
        return torch.as_tensor(np.ascontiguousarray(frames, np.uint8)).to(self.device)

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

    def load_jax_checkpoint(self, path: str) -> None:
        """Load the npz that scenelib2_tpu's MonoSLAM.save_checkpoint writes."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as data:
            arrays = {k: data[k] for k in data.files}
        self.load_state(state_from_jax(arrays, self.device, self.dtype))

    # ------------------------------------------------------- introspection

    @property
    def xv(self) -> np.ndarray:
        return self.state.x[:13].cpu().numpy()

    @property
    def pxx(self) -> np.ndarray:
        return self.state.P[:13, :13].cpu().numpy()

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
