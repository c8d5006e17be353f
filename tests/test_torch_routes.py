"""The single-stream step takes the JAX step's route for each state size.

JAX (scenelib2_tpu/runtime/step.py:207-211, 430-432, 649-652, 707-708;
pallas_measure.py:283) by D = 13 + 6 max_features:
  - D <= 384: the fused route, K1 then K2 then K3;
  - 384 < D <= 781 (62 <= MF <= 128): the split route, K7, K2, and the
    dense update whose S is inverted by K14; never K1 or K3;
  - stage 8 (K4) runs every frame up to D = 128 and is selected by
    lax.cond(making_any, heavy, light) above it;
  - MF > 128 has no fast route (K7 and K5 hold at most 128 slots) and is
    refused.
The wrappers are counted at the step's call sites on the CPU (the plain
versions stand in for the kernels). The split route's CPU replay of the
239-frame std sequence at max_features 100 (D = 613) reproduces
expected_fingerprint_mf100.json, made from the JAX f32 step by
scripts/gen_largemap_fingerprints.py (equal to the std mapping-on
fingerprint: the map never holds more than 13 features, in the lowest
slots, so the run decides as the 16-slot one).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params
from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
from scenelib2_torch.eval.synthetic import DATASET_VERSION, generate_dataset
from scenelib2_torch.runtime.step import make_step

WRAPPERS = ("predict_measure", "measure_select", "search", "joint_update", "chol_inv", "propose_region",
            "shi_tomasi", "search_bayes", "score_map", "particle_predict", "search_bayes_maps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _count_calls(counts: dict):
    import scenelib2_torch.core.ekf as ekf_mod
    import scenelib2_torch.runtime.step as step_mod

    mods = {n: ekf_mod if n == "chol_inv" else step_mod for n in WRAPPERS}
    orig = {n: getattr(mods[n], n) for n in WRAPPERS}

    def wrap(n):
        def call(*a, **k):
            counts[n] += 1
            return orig[n](*a, **k)
        return call

    for n in WRAPPERS:
        setattr(mods[n], n, wrap(n))
    try:
        yield
    finally:
        for n in WRAPPERS:
            setattr(mods[n], n, orig[n])


@pytest.fixture(scope="module")
def std_frames(tmp_path_factory):
    frames, _, _, cfg = generate_dataset(str(tmp_path_factory.mktemp("std")), n_frames=4, seed=7)
    return frames, cfg


@pytest.mark.parametrize("mf,route", [(16, "fused"), (61, "fused"), (62, "split"), (64, "split"),
                                      (128, "split")])
def test_route_by_state_dimension(mf, route, std_frames):
    frames, cfg = std_frames
    D = 13 + 6 * mf
    assert (D <= 384) == (route == "fused")
    slam = MonoSLAM(cfg, max_features=mf, device="cpu")
    counts = dict.fromkeys(WRAPPERS, 0)
    with _count_calls(counts):
        outs = slam.run_sequence(frames[1:4], enable_mapping=True)
    assert bool(torch.isfinite(outs.xv).all())
    once = {"fused": ("predict_measure", "search", "joint_update"),
            "split": ("measure_select", "search", "chol_inv")}[route]
    for n in WRAPPERS:
        want = 3 if n in once + ("propose_region", "shi_tomasi", "search_bayes") else 0
        assert counts[n] == want, (mf, n, counts)


def test_max_features_above_128_is_refused():
    with pytest.raises(NotImplementedError, match="128"):
        make_step(dataclasses.replace(Params(), max_features=129), device="cpu")
    make_step(dataclasses.replace(Params(), max_features=128), device="cpu")


def test_stage8_light_branch_above_d128(std_frames):
    """Above D = 128 a frame with no measurable partial feature takes JAX's
    `light` results: no particle rows, nothing converted or killed, prob and
    palive untouched; only the match attempts count up. At D <= 128 the
    heavy branch runs on the same state and kills the partial feature whose
    attempts are spent (its sell-by test runs whether or not it is
    measurable)."""
    frames, cfg = std_frames
    for mf in (16, 21):
        slam = MonoSLAM(cfg, max_features=mf, device="cpu")
        s = slam.state
        # one partial feature in slot 5, inserted this frame (match_attempts
        # 0: not measurable), with its attempts spent
        full = s.full.clone()
        full[5] = False
        active = s.active.clone()
        active[5] = True
        prob = s.prob.clone()
        prob[5] = 1.0 / prob.shape[1]
        palive = s.palive.clone()
        palive[5] = True
        ma = s.match_attempts.clone()
        ma[5] = 0
        lam = s.lam.clone()
        lam[5] = torch.linspace(0.5, 5.0, lam.shape[1])
        x = s.x.clone()
        x[13 + 6 * 5 : 19 + 6 * 5] = torch.tensor([0.0, 0.0, -0.5, 0.0, 0.0, 1.0])
        P = s.P.clone()
        for i in range(13 + 30, 19 + 30):
            P[i, i] = 1e-4
        slam.state = s._replace(full=full, active=active, prob=prob, palive=palive,
                                match_attempts=ma, lam=lam, x=x, P=P,
                                label=s.label.clone().index_fill_(0, torch.tensor([5]), 9))
        p = dataclasses.replace(slam.params, erase_partial_after_attempts=-1)
        step = make_step(p, device="cpu")
        state, out = step(slam.state, torch.as_tensor(frames[1]), False)
        if mf == 16:
            assert not bool(state.active[5])          # heavy: sold by
        else:
            assert bool(state.active[5]) and not bool(state.full[5])    # light
            assert int(state.match_attempts[5]) == 1
            assert torch.equal(state.prob[5], prob[5]) and torch.equal(state.palive[5], palive[5])
            assert not bool(out.par_alive.any()) and not bool(out.did_convert)
            assert not bool(out.par_h.any()) and not bool(out.par_sinv.any())
            assert int(out.n_overflow) == 0


def test_mf100_cpu_replay_reproduces_expected_fingerprint(tmp_path):
    frames, _, _, cfg = generate_dataset(str(tmp_path), n_frames=240, seed=7)
    slam = MonoSLAM(cfg, max_features=100, device="cpu")
    assert slam.state.x.shape == (613,)
    outs = slam.run_sequence(frames[1:], enable_mapping=True)
    want = load_expected("expected_fingerprint_mf100")
    assert want["dataset_version"] == DATASET_VERSION
    got = decisions_fingerprint(outs, 239)
    assert {k: want[k] for k in got} == got
    assert np.isfinite(outs.xv.numpy()).all()
