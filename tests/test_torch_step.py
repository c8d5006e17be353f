"""The port's step (stages 1-6, mapping off) against the JAX package.

  (a) frame by frame against the JAX f32 step: tests/test_torch_step_jax.py
      (a file of its own, since compiling the JAX step takes half a minute);
  (b) the port's CPU replay of the 239-frame std sequence reproduces
      scenelib2_torch/data/expected_fingerprint_nomap.json (generated from
      the JAX package);
  (c) the port's synthetic generator renders the same bytes as the JAX one;
  (d) mapping is refused until its slices are ported.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
from scenelib2_torch.eval.synthetic import DATASET_VERSION, generate_dataset
from scenelib2_torch.runtime.step import make_step, pack_outputs, packed_size, unpack_outputs



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is hundreds of tiny tensor ops per frame: intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def std_sequence(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("std240"))
    frames, _rs, _qs, cfg = generate_dataset(d, n_frames=240, seed=7)
    return frames, cfg


def test_cpu_replay_reproduces_expected_fingerprint(std_sequence):
    frames, cfg = std_sequence
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    outs = slam.run_sequence(frames[1:], enable_mapping=False)
    want = load_expected()
    assert want["dataset_version"] == DATASET_VERSION
    got = decisions_fingerprint(outs, len(frames) - 1)
    assert {k: want[k] for k in got} == got
    assert np.isfinite(outs.r.numpy()).all()
    # the per-step facade agrees with the replay
    slam.reset()
    for t in range(1, 6):
        slam.go_one_step(frames[t], enable_mapping=False)
    np.testing.assert_array_equal(slam.trajectory()[-1], outs.r[4].numpy())
    assert slam.xv.shape == (13,) and slam.pxx.shape == (13, 13)
    table = slam.feature_table()
    assert [f["label"] for f in table] == [0, 1, 2, 3]
    assert all(f["fully_initialised"] and f["y"].shape == (3,) for f in table)


def test_synthetic_frames_byte_equal_to_jax(std_sequence, tmp_path):
    from scenelib2_tpu.eval.synthetic import generate_dataset as jax_generate

    frames, _cfg = std_sequence
    jframes = jax_generate(str(tmp_path), n_frames=240, seed=7)[0]
    assert frames.dtype == jframes.dtype == np.uint8
    assert frames.tobytes() == jframes.tobytes()
    for k in range(4):
        with open(os.path.join(os.path.dirname(_cfg), f"known_patch{k}.pgm"), "rb") as a, \
                open(tmp_path / f"known_patch{k}.pgm", "rb") as b:
            assert a.read() == b.read()


def test_mapping_is_refused(std_sequence):
    frames, cfg = std_sequence
    slam = MonoSLAM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        slam.go_one_step(frames[1], enable_mapping=True)
    with pytest.raises(NotImplementedError, match="slice"):
        slam.run_sequence(frames[1:3], enable_mapping=True)
    with pytest.raises(NotImplementedError):
        make_step(slam.params, device="cpu", precision="f64")


def test_pack_unpack_round_trip(std_sequence):
    frames, cfg = std_sequence
    slam = MonoSLAM(cfg, device="cpu")
    p = slam.params
    step = make_step(p, device="cpu")
    state, out = step(slam.state, torch.as_tensor(frames[1]))
    flat = pack_outputs(out)
    assert flat.shape == (packed_size(p.n_features_to_select, 1, p.n_particles),)
    back = unpack_outputs(flat, p.n_features_to_select, 1, p.n_particles)
    for name, a, b in zip(out._fields, out, back):
        np.testing.assert_array_equal(a.numpy(), b.numpy().astype(a.numpy().dtype), err_msg=name)
    assert int(state.frame_no) == 1
