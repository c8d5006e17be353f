"""The port's step (stages 1-8) against the JAX package.

  (a) frame by frame against the JAX f32 step: tests/test_torch_step_jax.py
      (mapping off) and tests/test_torch_mapping_step_jax.py (mapping on,
      and a JAX checkpoint holding a partial feature), files of their own
      since compiling the JAX step takes half a minute;
  (b) the port's CPU replays of the 239-frame std sequence reproduce the
      committed fingerprints (copies of the JAX package's):
      scenelib2_torch/data/expected_fingerprint_nomap.json with mapping off
      and scenelib2_torch/data/expected_fingerprint.json with mapping on;
  (c) the port's synthetic generator renders the same bytes as the JAX one;
  (d) what is not ported yet (a partial capacity above one) is refused,
      and the f64 step builds;
  (e) the port's batch step on the CPU reproduces the committed per-lane
      fingerprints scenelib2_torch/data/expected_fingerprint_batch64.json
      (made by the JAX batch step, scripts/gen_batch64_fingerprint.py) for
      its first 8 lanes, and a lane of a batch run equals the same lane
      stepped alone, bit for bit: lanes do not leak into each other; lane 0
      (the std sequence) decides as the single-stream step does, with
      mapping on and off, though the two take different kernels.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.eval.batch import EXPECTED, check_lanes, lane_fingerprints, make_lanes
from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected, selection_set
from scenelib2_torch.parallel.mesh import lane_state, make_batched_step, run_batch, stack_states
from scenelib2_torch.eval.synthetic import DATASET_VERSION, generate_dataset
from scenelib2_torch.runtime import step as step_mod
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
    want = load_expected("expected_fingerprint_nomap")
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


def test_cpu_replay_with_mapping_reproduces_expected_fingerprint(std_sequence):
    frames, cfg = std_sequence
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    outs = slam.run_sequence(frames[1:], enable_mapping=True)
    want = load_expected("expected_fingerprint")
    assert want["dataset_version"] == DATASET_VERSION
    got = decisions_fingerprint(outs, len(frames) - 1)
    assert {k: want[k] for k in got} == got
    assert np.isfinite(outs.r.numpy()).all()
    # the per-step facade (the JAX package's default, mapping on) agrees
    # with the replay through the first conversion (index 20) and the
    # third init (index 22)
    slam.reset()
    for t in range(1, 24):
        slam.go_one_step(frames[t])
    np.testing.assert_array_equal(slam.trajectory()[-1], outs.r[22].numpy())
    assert bool(slam.last_output.did_init) and bool(outs.did_init[22])
    table = slam.feature_table()
    assert any(not f["fully_initialised"] and f["y"].shape == (6,) for f in table)
    assert sum(f["fully_initialised"] for f in table) > 4


def test_unported_modes_are_refused_and_nomap_never_inits(std_sequence, monkeypatch):
    """Mapping runs now, and so does a partial-feature capacity above one
    (the single stream then runs the batch default route's stage 8, K9,
    K10 and K11, on its state as one lane): the facade builds it on the
    fused route. The f64 step builds: with the default use_pallas=True it
    is JAX's hybrid route.
    Mapping off never initialises and never runs stage 7 (K5, K6, K17); its
    whole replay is held to the nomap fingerprint by
    test_cpu_replay_reproduces_expected_fingerprint."""
    frames, cfg = std_sequence
    assert make_step(MonoSLAM(cfg, device="cpu").params, device="cpu", precision="f64").route == "k2-f64"
    slam2 = MonoSLAM(cfg, device="cpu", max_features_to_init_at_once=2)
    assert slam2._step.route == "fused" and slam2.params.max_features_to_init_at_once == 2

    def stage7(*a, **k):
        raise AssertionError("stage 7 ran with mapping off")

    monkeypatch.setattr(step_mod, "propose_region", stage7)
    monkeypatch.setattr(step_mod, "shi_tomasi", stage7)
    monkeypatch.setattr(step_mod, "ray_insert", stage7)
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    outs = slam.run_sequence(frames[1:31], enable_mapping=False)     # mapping on inits at 9
    assert not outs.did_init.any() and not outs.n_partial.any()
    assert (outs.n_active == 4).all() and (outs.init_box == 0).all()


def test_pack_unpack_round_trip(std_sequence):
    frames, cfg = std_sequence
    slam = MonoSLAM(cfg, device="cpu")
    p = slam.params
    step = make_step(p, device="cpu")
    state, out = step(slam.state, torch.as_tensor(frames[1]), True)
    flat = pack_outputs(out)
    assert flat.shape == (packed_size(p.n_features_to_select, 1, p.n_particles),)
    back = unpack_outputs(flat, p.n_features_to_select, 1, p.n_particles)
    for name, a, b in zip(out._fields, out, back):
        np.testing.assert_array_equal(a.numpy(), b.numpy().astype(a.numpy().dtype), err_msg=name)
    assert int(state.frame_no) == 1


N_BATCH_LANES = 8


@pytest.fixture(scope="module")
def batch_run(tmp_path_factory):
    """The first 8 of the 64 batch lanes (textures 0..7, offset 0), replayed
    over all 63 frames by the port's batch step on the CPU."""
    params, states, frames = make_lanes(str(tmp_path_factory.mktemp("b64")), device="cpu",
                                        dtype=torch.float32, lanes=range(N_BATCH_LANES))
    step = make_batched_step(params, device="cpu")
    final, outs = run_batch(step, states, frames, True, params)
    return params, states, frames, step, final, outs


def test_cpu_batch_replay_reproduces_expected_per_lane_fingerprints(batch_run):
    params, _states, frames, _step, final, outs = batch_run
    want = load_expected(EXPECTED)
    assert want["dataset_version"] == DATASET_VERSION
    assert (want["batch"], want["n_textures"], want["n_frames"]) == (64, 32, frames.shape[0])
    assert want["max_features"] == params.max_features == 16 and len(want["lanes"]) == 64
    got = lane_fingerprints(outs)
    assert check_lanes(got, range(N_BATCH_LANES)) == []
    assert np.isfinite(outs.r.numpy()).all() and outs.r.shape == (63, N_BATCH_LANES, 3)
    assert (final.frame_no == 63).all()
    # the committed lanes are not in lockstep
    assert len({fp["decisions_sha256"] for fp in want["lanes"]}) >= 16
    assert len({fp["active_end"] for fp in want["lanes"]}) > 1
    assert len({fp["decisions_sha256"] for fp in got}) == N_BATCH_LANES


def test_a_lane_of_a_batch_run_equals_the_same_lane_stepped_alone(batch_run):
    params, states, frames, step, _final, outs = batch_run
    n = 30                                # past the first inits and conversions
    assert outs.did_init[:n, 3].any() and outs.did_convert[:n, 3].any()
    alone, outs1 = run_batch(step, stack_states([lane_state(states, 3)]), frames[:n, 3:4], True, params)
    for name, a, b in zip(outs._fields, outs, outs1):
        assert torch.equal(a[:n, 3], b[:, 0]), name
    # and in another order beside other lanes
    mixed, outs2 = run_batch(step, stack_states([lane_state(states, b) for b in (5, 3)]),
                             frames[:n][:, [5, 3]], True, params)
    for name, a, b in zip(outs._fields, outs, outs2):
        assert torch.equal(a[:n, 3], b[:, 1]) and torch.equal(a[:n, 5], b[:, 0]), name
    for a, b in zip(lane_state(mixed, 1), lane_state(alone, 0)):
        assert torch.equal(a, b)


def test_batch_lane_0_decides_as_the_single_stream_step(batch_run, std_sequence):
    """Lane 0 of the batch lanes replays the std sequence (texture seed 7, no
    phase offset) from the std start state. The batch step (K7, K9-K11, the
    tensor-op update and proposal chain) and the single-stream step (K1, K3,
    K4, K5) round differently, but every decision over the 63 frames is the
    same, with mapping on and with mapping off (where the batch step, too,
    skips stage 7 and never initialises)."""
    params, states, frames, step, _final, outs = batch_run
    std_frames, cfg = std_sequence
    T = frames.shape[0]
    assert std_frames[1 : T + 1].tobytes() == frames[:, 0].tobytes()
    two = stack_states([lane_state(states, 0), lane_state(states, 1)])
    _s, outs_off = run_batch(step, two, frames[:, :2], False, params)
    assert not outs_off.did_init.any() and (outs_off.n_active == 4).all()
    assert (outs_off.init_box == 0).all() and (outs_off.n_partial == 0).all()
    for mapping, batch_outs in ((True, outs), (False, outs_off)):
        single = MonoSLAM(cfg, max_features=16, device="cpu").run_sequence(
            std_frames[1 : T + 1], enable_mapping=mapping)
        lane0 = step_mod.StepOutputs(*(a[:, 0] for a in batch_outs))
        for name in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
                     "did_convert", "n_overflow"):
            assert torch.equal(getattr(lane0, name), getattr(single, name)), (mapping, name)
        np.testing.assert_array_equal(selection_set(lane0), selection_set(single))
        np.testing.assert_allclose(lane0.r.numpy(), single.r.numpy(), rtol=0, atol=1e-4)
