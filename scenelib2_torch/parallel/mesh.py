"""Batch parallelism on one GPU: B independent sequences in one step.

Port of the batch half of scenelib2_tpu/parallel/mesh.py
(``make_batched_step``, ``replicate_states``). The JAX package vmaps its
step over the lanes and shards the lane axis over a device mesh; a ctypes
kernel cannot be vmapped, so here the lanes are a real leading dimension of
every state field and every kernel's grid carries the lane
(runtime/step.py::make_batch_step). On one card there is no mesh: sharding
the lane axis over several devices, and the sharded-covariance EKF of the
JAX file, are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scenelib2_torch.config import Params
from scenelib2_torch.rng import pack_state, srand48
from scenelib2_torch.runtime import step as step_mod
from scenelib2_torch.runtime.state import SlamState


def make_batched_step(params: Params, device=None, batch_sb: bool | None = None):
    """step(states_b, frames_b, enable_mapping) -> (states_b', outs_b): the
    whole per-frame step for all lanes at once. Every field of states_b has
    a leading lane dimension, frames_b is [B, H, W] u8, and every field of
    outs_b (StepOutputs) has the lane dimension too. device None means CUDA
    (raises without a GPU). The JAX batch route follows params.batch_pallas
    and, with batch_pallas=True, batch_sb (None: the environment variable
    SCENELIB2_BATCH_SB, read now): runtime.step.batch_route."""
    return step_mod.make_batch_step(dataclasses.replace(params, batch_mode=True), device,
                                    batch_sb=batch_sb)


def stack_states(states) -> SlamState:
    """Lane-stack single states (all of one configuration and device)."""
    return SlamState(*(torch.stack(ts) for ts in zip(*states)))


def lane_state(states_b: SlamState, lane: int) -> SlamState:
    """One lane of a stacked state, as a single-stream state."""
    return SlamState(*(t[lane] for t in states_b))


def lane_seeds(batch: int, device) -> torch.Tensor:
    """[B, 3] drand48 limb states, lane i seeded with srand48(i)."""
    return torch.as_tensor(
        np.stack([pack_state(srand48(i)) for i in range(batch)]).astype(np.int32), device=device)


def replicate_states(state: SlamState, batch: int) -> SlamState:
    """B copies of a state, each lane with its own random stream srand48(lane)."""
    stacked = SlamState(*(t.expand(batch, *t.shape).clone() for t in state))
    return stacked._replace(rng=lane_seeds(batch, state.x.device))


def run_batch(step, states_b: SlamState, frames, enable_mapping: bool, params: Params):
    """Replay frames [T, B, H, W] u8 through `step` (from make_batched_step).
    Every step writes its packed outputs into one preallocated [T, B, K]
    tensor on the state's device and the host waits once, at the end.
    Returns (final states_b, StepOutputs with leading [T, B] dimensions on
    the CPU)."""
    dev = states_b.x.device
    if isinstance(frames, torch.Tensor):
        seq = frames.to(device=dev, dtype=torch.uint8).contiguous()
    else:
        seq = torch.as_tensor(np.ascontiguousarray(frames, np.uint8)).to(dev)
    nsel = params.n_features_to_select
    maxp = max(1, params.max_features_to_init_at_once)
    npart = params.n_particles
    T, Bn = seq.shape[:2]
    flat = torch.empty((T, Bn, step_mod.packed_size(nsel, maxp, npart)),
                       dtype=states_b.x.dtype, device=dev)
    for t in range(T):
        states_b, out = step(states_b, seq[t], enable_mapping)
        flat[t] = step_mod.pack_outputs(out)
    return states_b, step_mod.unpack_outputs(flat.cpu(), nsel, maxp, npart)


__all__ = ["make_batched_step", "stack_states", "lane_state", "lane_seeds", "replicate_states",
           "run_batch"]
