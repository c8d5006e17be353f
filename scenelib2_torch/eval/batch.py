"""The 64-lane batch replay: lanes, reference fingerprints, per-lane check.

The lane recipe is the JAX package's bench_batch64
(scenelib2_tpu/eval/benchmark.py:188-219): lane i replays scene texture
i % n_textures (generate_dataset(seed=7 + texture)) with a phase offset of
i // n_textures frames, starts from that texture's own config (its pose and
its four known-feature patches, cropped from its own frame 0) and draws from
its own random stream srand48(i). So the lanes diverge in matches, in the
timing of their initialisations and in their maps.

scenelib2_torch/data/expected_fingerprint_batch64.json holds one decisions
fingerprint per lane (eval/fingerprint.py), made by the JAX batch step on its
default route. The two other routes (runtime.step.batch_route:
batch_pallas=False, and SCENELIB2_BATCH_SB=0) decide as the default route
(their JAX runs gave the default route's file again), so they read that file.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from scenelib2_torch.config import load_config
from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
from scenelib2_torch.eval.synthetic import generate_dataset
from scenelib2_torch.parallel.mesh import lane_seeds, stack_states
from scenelib2_torch.runtime import state as st
from scenelib2_torch.runtime.step import StepOutputs

EXPECTED = "expected_fingerprint_batch64"
EXPECTED_OF_ROUTE = {"default": EXPECTED, "sb0": EXPECTED, "bp0": EXPECTED}


def make_lanes(out_dir: str, batch: int = 64, n_textures: int = 32, n_frames: int = 64,
               max_features: int = 16, *, device, dtype, lanes=None):
    """(params, states_b, frames [T, B, H, W] u8 numpy) of the batch replay:
    T = n_frames - 1 frames a lane. `lanes` picks a subset of the `batch`
    lanes (their indices; each keeps its texture, offset and seed). Renders
    the textures it needs into out_dir."""
    lanes = list(range(batch)) if lanes is None else list(lanes)
    offsets = max(1, batch // n_textures)
    tex_frames, tex_cfgs = {}, {}
    for tex in sorted({lane % n_textures for lane in lanes}):
        frames, _rs, _qs, cfg_path = generate_dataset(
            os.path.join(out_dir, f"b64t{tex}"), n_frames=n_frames + offsets, seed=7 + tex)
        tex_frames[tex] = frames
        tex_cfgs[tex] = load_config(cfg_path)
    params = dataclasses.replace(next(iter(tex_cfgs.values())).params,
                                 max_features=max_features, batch_mode=True)
    states, fb = [], []
    for lane in lanes:
        tex, off = lane % n_textures, lane // n_textures
        cfg = dataclasses.replace(tex_cfgs[tex], params=params)
        states.append(st.init_from_config(cfg, device=device, dtype=dtype))
        fb.append(tex_frames[tex][1 + off : n_frames + off])
    states_b = stack_states(states)
    seeds = lane_seeds(batch, device)[np.asarray(lanes)]
    return params, states_b._replace(rng=seeds), np.ascontiguousarray(np.stack(fb, axis=1))


def lane_fingerprints(outs: StepOutputs) -> list[dict]:
    """One decisions fingerprint per lane of outputs with [T, B] leading
    dimensions."""
    T, Bn = outs.n_matched.shape
    return [decisions_fingerprint(StepOutputs(*(a[:, b] for a in outs)), T) for b in range(Bn)]


def check_lanes(got: list[dict], lanes=None, route: str = "default") -> list[str]:
    """Compare per-lane fingerprints with the committed ones of the JAX
    batch route `route`; returns one line per differing lane (empty when all
    agree)."""
    want = load_expected(EXPECTED_OF_ROUTE[route])["lanes"]
    lanes = list(range(len(got))) if lanes is None else list(lanes)
    bad = []
    for fp, lane in zip(got, lanes):
        if fp != want[lane]:
            bad.append(f"lane {lane}: got {fp} want {want[lane]}")
    return bad
