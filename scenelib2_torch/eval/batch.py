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

The lanes can also run at BASELINE config 3 (config="hires":
eval/synthetic.py HIRES_PARAMS, 640x480, max_features 60, 200 particles):
each texture is rendered at that calibration with the same seeds.
scenelib2_torch/data/expected_fingerprint_batch_hires.json holds 16 such
lanes (8 textures x 2 offsets, 39 frames a lane) from the JAX batch step on
its default route (scripts/gen_batch64_fingerprint.py --config hires).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from scenelib2_torch.config import Params, load_config
from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
from scenelib2_torch.eval.synthetic import HIRES_OVERRIDES, HIRES_PARAMS, generate_dataset
from scenelib2_torch.parallel.mesh import lane_seeds, stack_states
from scenelib2_torch.runtime import state as st
from scenelib2_torch.runtime.step import StepOutputs

EXPECTED = "expected_fingerprint_batch64"
# configuration -> (the dataset's Params, the step's overrides, the committed lanes file)
CONFIGS = {
    "std": (None, dict(max_features=16), EXPECTED),
    "hires": (HIRES_PARAMS, HIRES_OVERRIDES, "expected_fingerprint_batch_hires"),
}


def make_lanes(out_dir: str, batch: int = 64, n_textures: int = 32, n_frames: int = 64, *, device, dtype,
               lanes=None, config: str = "std"):
    """(params, states_b, frames [T, B, H, W] u8 numpy) of the batch replay
    at the configuration `config` (CONFIGS): T = n_frames - 1 frames a lane.
    `lanes` picks a subset of the `batch` lanes (their indices; each keeps
    its texture, offset and seed). Renders the textures it needs into
    out_dir, or reads them back where an earlier call rendered them there
    (each texture's frames.npy beside its config and patches)."""
    dataset, overrides, _file = CONFIGS[config]
    lanes = list(range(batch)) if lanes is None else list(lanes)
    offsets = max(1, batch // n_textures)
    tex_frames, tex_cfgs = {}, {}
    for tex in sorted({lane % n_textures for lane in lanes}):
        tdir = os.path.join(out_dir, f"b{config}t{tex}")
        fpath, cfg_path = os.path.join(tdir, "frames.npy"), os.path.join(tdir, "synthetic.cfg")
        cached = os.path.exists(fpath) and os.path.exists(cfg_path)
        if cached and np.load(fpath, mmap_mode="r").shape[0] == n_frames + offsets:
            frames = np.load(fpath)
        else:
            frames, _rs, _qs, cfg_path = generate_dataset(
                tdir, n_frames=n_frames + offsets, seed=7 + tex,
                params=None if dataset is None else Params(**dataset))
            np.save(fpath, frames)
        tex_frames[tex] = frames
        tex_cfgs[tex] = load_config(cfg_path)
    params = dataclasses.replace(next(iter(tex_cfgs.values())).params, **overrides, batch_mode=True)
    states, fb = [], []
    for lane in lanes:
        tex, off = lane % n_textures, lane // n_textures
        cfg = dataclasses.replace(tex_cfgs[tex], params=params)
        states.append(st.init_from_config(cfg, device=device, dtype=dtype))
        fb.append(tex_frames[tex][1 + off : n_frames + off])
    states_b = stack_states(states)
    seeds = lane_seeds(batch, device)[np.asarray(lanes)]
    return params, states_b._replace(rng=seeds), np.ascontiguousarray(np.stack(fb, axis=1))


def lanes_cache_dir(root: str) -> str:
    """The directory under root where bench_batch64 (eval/benchmark.py)
    renders its lanes, so that a later make_lanes there reads them."""
    from scenelib2_torch.eval.synthetic import DATASET_VERSION

    return os.path.join(root, f"scenelib2_torch_lanes_v{DATASET_VERSION}")


def lane_fingerprints(outs: StepOutputs) -> list[dict]:
    """One decisions fingerprint per lane of outputs with [T, B] leading
    dimensions."""
    T, Bn = outs.n_matched.shape
    return [decisions_fingerprint(StepOutputs(*(a[:, b] for a in outs)), T) for b in range(Bn)]


def check_lanes(got: list[dict], lanes=None, route: str = "default", config: str = "std") -> list[str]:
    """Compare per-lane fingerprints with the committed ones at the
    configuration `config` (every JAX batch route reproduces one file per
    configuration; `route` names the route in the lines); returns one line
    per differing lane (empty when all agree)."""
    want = load_expected(CONFIGS[config][2])["lanes"]
    lanes = list(range(len(got))) if lanes is None else list(lanes)
    bad = []
    for fp, lane in zip(got, lanes):
        if fp != want[lane]:
            bad.append(f"lane {lane} ({route} route, {config}): got {fp} want {want[lane]}")
    return bad
