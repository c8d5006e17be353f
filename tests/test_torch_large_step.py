"""The port's hires replay on the CPU reproduces its committed fingerprint,
made from the JAX f32 step by scripts/gen_largemap_fingerprints.py: BASELINE
config 3 (scenelib2_tpu/eval/benchmark.py:145-167), the 119 frames after
frame 0 of the 120-frame 640x480 seed-7 sequence, max_features 60 (D = 373,
the fused route), search radius 48, particle radius 52, 200 particles:
expected_fingerprint_hires.json. The port's generator renders the hires
frames, patches and config as the JAX package's does. (The split route's
replay, expected_fingerprint_mf100.json, is in tests/test_torch_routes.py.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params
from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
from scenelib2_torch.eval.synthetic import (
    DATASET_VERSION,
    HIRES_OVERRIDES,
    HIRES_PARAMS,
    generate_dataset,
)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(outs, name, n_frames):
    want = load_expected(name)
    assert want["dataset_version"] == DATASET_VERSION
    got = decisions_fingerprint(outs, n_frames)
    assert {k: want[k] for k in got} == got
    assert np.isfinite(outs.xv.numpy()).all()


def test_hires_cpu_replay_reproduces_expected_fingerprint(tmp_path):
    frames, _, _, cfg = generate_dataset(str(tmp_path), n_frames=120, seed=7, params=Params(**HIRES_PARAMS))
    slam = MonoSLAM(cfg, device="cpu", **HIRES_OVERRIDES)
    assert slam.params.n_particles == 200 and (slam.params.cam_width, slam.params.cam_height) == (640, 480)
    _check(slam.run_sequence(frames[1:], enable_mapping=True), "expected_fingerprint_hires", 119)


def test_hires_frames_byte_equal_to_jax(tmp_path):
    from scenelib2_tpu.config import Params as JParams
    from scenelib2_tpu.eval.synthetic import generate_dataset as jax_generate

    frames = generate_dataset(str(tmp_path / "port"), n_frames=4, seed=7, params=Params(**HIRES_PARAMS))[0]
    jframes = jax_generate(str(tmp_path / "jax"), n_frames=4, seed=7, params=JParams(**HIRES_PARAMS))[0]
    assert frames.shape == (4, 480, 640) and frames.tobytes() == jframes.tobytes()
    for k in range(4):
        with open(tmp_path / "port" / f"known_patch{k}.pgm", "rb") as a, \
                open(tmp_path / "jax" / f"known_patch{k}.pgm", "rb") as b:
            assert a.read() == b.read()
    # the config files differ only in their header line and their directory
    with open(tmp_path / "port" / "synthetic.cfg") as a, open(tmp_path / "jax" / "synthetic.cfg") as b:
        pa, pb = (f.read().replace(str(tmp_path / d), "").splitlines()[1:] for f, d in ((a, "port"), (b, "jax")))
    assert pa == pb
