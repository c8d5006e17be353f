"""The port's hires configuration against the JAX f32 step, frame by frame.

BASELINE config 3 (scenelib2_tpu/eval/benchmark.py:145-167): 640x480,
max_features 60 (D = 373: the fused route, K1 at TD = 384, K3 at D = 373),
search radius 48 (107 x 107 search windows), particle radius 52, 200
particles (K4's padded row of 256 lanes); stage 8 is selected by
lax.cond(making_any, heavy, light) as D > 128. The first 16 frames of the
hires sequence, mapping on: inits at output indices 3, 5, 7, 11, 14 (each a
`light` frame) and the first conversion at 10.

The JAX step runs once in a subprocess (tests/test_torch_split_step_jax.py
says how, and what is compared at which tolerance).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.eval.synthetic import HIRES_OVERRIDES, HIRES_PARAMS
from tests.test_torch_split_step_jax import assert_same_run, run_jax_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hires_matches_the_jax_step_frame_by_frame(tmp_path):
    want = run_jax_step(tmp_path, 16, HIRES_PARAMS, HIRES_OVERRIDES)
    np.testing.assert_array_equal(np.flatnonzero(want["did_init"]), [3, 5, 7, 11, 14])
    np.testing.assert_array_equal(np.flatnonzero(want["did_convert"]), [10])
    light = (want["n_partial"] > 0) & ~want["par_mask"].any(-1)
    assert light[[3, 5, 7, 11, 14]].all()
    assert want["par_alive"].shape[-1] == 200
    slam = MonoSLAM(str(tmp_path / "synthetic.cfg"), device="cpu", **HIRES_OVERRIDES)
    assert slam.params.n_particles == 200
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert_same_run(got, want, "hires")
