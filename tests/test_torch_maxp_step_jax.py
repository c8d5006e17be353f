"""The single stream at max_features_to_init_at_once = 2 (two partial
features at a time) against the JAX f32 fast step, at the std configuration
(max_features 16, D = 109: the fused route, stage 8 every frame).

The JAX step runs once, in a subprocess (SCENELIB2_X64=0, use_pallas=True,
interpret-mode kernels: ~60-75 s on one core, almost all of it the compile),
over the first 40 frames of the std sequence with mapping on, and saves its
checkpoint after frame 12, when it holds two partial features. Output
indices 11-14 and 18-21 search both partial slots.

  (b) the port's CPU replay of those frames decides as JAX does, frame by
      frame (tests/torch_maxp_jax.py: decisions, selection sets, init box,
      partial slots and masks exactly; r and xv within 1e-4);
  (e) the port loads the JAX checkpoint with its two partial features and
      continues over frames 13..40 identically;
  (f) the port's CPU replay of the 239 std frames reproduces
      expected_fingerprint_maxp2.json (made by
      scripts/gen_largemap_fingerprints.py --maxp 2 --configs std).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
from scenelib2_torch.eval.synthetic import DATASET_VERSION, generate_dataset
from tests.test_torch_split_step_jax import run_jax_step
from tests.torch_maxp_jax import MAXP2, assert_same_maxp_run, both_searched

N_FRAMES = 40
CKPT_AT = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_maxp2")
    want = run_jax_step(out, N_FRAMES, None, dict(max_features=16, **MAXP2), checkpoint_at=CKPT_AT)
    return out, want


def test_maxp2_std_matches_the_jax_step_frame_by_frame(jax_run):
    out, want = jax_run
    np.testing.assert_array_equal(both_searched(want)[:8], [11, 12, 13, 14, 18, 19, 20, 21])
    assert int(want["n_partial"].max()) == 2 and want["did_convert"].any()
    slam = MonoSLAM(str(out / "synthetic.cfg"), max_features=16, device="cpu", **MAXP2)
    assert slam._step.route == "fused"
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert got.par_slot.shape == (N_FRAMES, 2) and got.par_h.shape == (N_FRAMES, 2, 100, 2)
    assert_same_maxp_run(got, want, "std maxp2")


def test_jax_checkpoint_with_two_partial_features_continues_identically(jax_run):
    out, want = jax_run
    slam = MonoSLAM(str(out / "synthetic.cfg"), max_features=16, device="cpu", **MAXP2)
    slam.load_jax_checkpoint(str(out / "jax_ckpt.npz"))
    assert int((slam.state.active & ~slam.state.full).sum()) == 2
    assert int(slam.state.frame_no) == CKPT_AT
    got = slam.run_sequence(want["frames"][CKPT_AT + 1 :], enable_mapping=True)
    tail = {k: v[CKPT_AT:] for k, v in want.items() if k != "frames"}
    assert len(both_searched(tail)) > 0
    assert_same_maxp_run(got, tail, "after the checkpoint")


def test_cpu_replay_reproduces_the_maxp2_fingerprint(tmp_path):
    frames, _rs, _qs, cfg = generate_dataset(str(tmp_path), n_frames=240, seed=7)
    slam = MonoSLAM(cfg, max_features=16, device="cpu", **MAXP2)
    outs = slam.run_sequence(frames[1:], enable_mapping=True)
    want = load_expected("expected_fingerprint_maxp2")
    assert want["dataset_version"] == DATASET_VERSION
    got = decisions_fingerprint(outs, len(frames) - 1)
    assert {k: want[k] for k in got} == got
    # MAXP 2 is another replay than MAXP 1: more matches and conversions
    assert got["matched_sum"] > load_expected("expected_fingerprint")["matched_sum"]
    assert len(both_searched(outs)) == 37
