"""The single stream at max_features_to_init_at_once = 2 against the JAX f32
fast step at bench_autoinit's max_features 24 (D = 157: the fused route,
stage 8 under JAX's lax.cond(making_any, heavy, light), a select in the
port).

The JAX step runs once, in a subprocess (SCENELIB2_X64=0, use_pallas=True,
interpret-mode kernels: ~60-75 s on one core), over the first 40 frames of
the std sequence with mapping on; output indices 11-14 and 18-21 search both
partial slots. The port's CPU replay of those frames decides as JAX does,
frame by frame (tests/torch_maxp_jax.py); where no partial feature is
measurable JAX takes `light`, whose particle rows are zeros, and the port's
are zeros there too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from tests.test_torch_split_step_jax import run_jax_step
from tests.torch_maxp_jax import MAXP2, assert_same_maxp_run, both_searched

N_FRAMES = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_maxp2_mf24_matches_the_jax_step_frame_by_frame(tmp_path):
    want = run_jax_step(tmp_path, N_FRAMES, None, dict(max_features=24, **MAXP2))
    np.testing.assert_array_equal(both_searched(want)[:8], [11, 12, 13, 14, 18, 19, 20, 21])
    light = ~want["par_mask"].any(-1)
    assert light.any() and (want["par_h"][light] == 0).all() and (want["par_sinv"][light] == 0).all()
    slam = MonoSLAM(str(tmp_path / "synthetic.cfg"), max_features=24, device="cpu", **MAXP2)
    assert slam._step.route == "fused"
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert_same_maxp_run(got, want, "max_features 24, maxp 2")
    assert (got.par_h.numpy()[light] == 0).all() and (got.par_sinv.numpy()[light] == 0).all()
