"""The port's copy of the NumPy reference oracle and its run_parity_eval.

scenelib2_torch/eval/oracle_monoslam.py and oracle_improc.py are the
repository's tests/oracle_*.py with their imports changed (the port's
drand48 and its own oracle_improc): over 12 frames of tests/test_parity.py's
160x120 scene both give the same trajectory, per-frame stats, feature
tables and drand48 state, bit for bit.

run_parity_eval (the JAX package's eval/metrics.py:40-112 on the port) runs
the f64 parity route, use_pallas=False whatever the params say, on the
device asked for, and at test_parity.py's params over 12 frames meets the
repository's bars: decision agreement 1.0, drand48 in lockstep with the
oracle, trajectory RMSE <= 1e-3 (docs/PARITY.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from scenelib2_torch.eval import metrics
from scenelib2_torch.eval import oracle_monoslam as port_oracle
from scenelib2_torch.eval import synthetic
from scenelib2_torch.rng import srand48
from scenelib2_torch.runtime import step as step_mod
from tests import oracle_monoslam as test_oracle
from tests.test_parity import KNOWN, PARAMS as JPARAMS

N_FRAMES = 13


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params():
    from scenelib2_torch.config import Params

    return Params(**{f.name: getattr(JPARAMS, f.name) for f in dataclasses.fields(Params)})


def _run_oracle(mod, p):
    rng = np.random.default_rng(11)
    tex = synthetic.make_texture(rng, size=1024)
    scale = 0.6 / p.cam_fku
    rs, qs = synthetic.default_trajectory(N_FRAMES, p.delta_t)
    frames = np.stack([synthetic.render_frame(p, tex, rs[i], qs[i], scale) for i in range(N_FRAMES)])
    xv0 = np.zeros(13)
    xv0[:3], xv0[3:7], xv0[9], xv0[12] = rs[0], qs[0], -0.02, 0.01
    pxx0 = np.zeros((13, 13))
    for i in (0, 1, 2, 7, 8, 9, 10, 11, 12):
        pxx0[i, i] = 0.0004
    half = (p.boxsize - 1) // 2
    oracle = mod.OracleMonoSLAM(mod.Cam(p.cam_width, p.cam_height, p.cam_fku, p.cam_fkv, p.cam_u0, p.cam_v0,
                                        p.cam_kd1, p.cam_sd), p, xv0, pxx0, seed=0)
    for y in KNOWN:
        h = synthetic.project_point(p, y, rs[0], qs[0])
        uu, vv = int(round(h[0])), int(round(h[1]))
        oracle.feats.append(mod.Feat(
            y=np.asarray(y, float).copy(), pxy=np.zeros((13, 3)), pyy=np.zeros((3, 3)),
            cross=[np.zeros((3, 3)) for _ in range(len(oracle.feats))],
            patch=frames[0][vv - half : vv + half + 1, uu - half : uu + half + 1].copy(),
            xp_org=np.concatenate([rs[0], qs[0]]), label=oracle.next_label, fully=True))
        oracle.next_label += 1
    stats = [oracle.go_one_step(frames[i], True) for i in range(1, N_FRAMES)]
    return oracle, stats


def test_the_port_oracle_copy_runs_as_the_tests_oracle():
    p = _port_params()
    got, got_stats = _run_oracle(port_oracle, p)
    want, want_stats = _run_oracle(test_oracle, p)
    assert got_stats == want_stats
    np.testing.assert_array_equal(np.asarray(got.trajectory), np.asarray(want.trajectory))
    np.testing.assert_array_equal(got.xv, want.xv)
    assert got.rng.state() == want.rng.state()
    assert [(f.label, f.fully) for f in got.feats] == [(f.label, f.fully) for f in want.feats]
    # the frames match features and the init proposals draw from the stream
    assert any(s["n_matched"] > 0 for s in got_stats) and got.rng.state() != srand48(0)


def test_run_parity_eval_on_the_cpu_meets_the_parity_bars(monkeypatch):
    routes = []
    real = step_mod.make_step
    monkeypatch.setattr(step_mod, "make_step", lambda *a, **k: routes.append(real(*a, **k)) or routes[-1])
    # the params ask for the kernel route: the evaluation runs the parity route all the same
    res = metrics.run_parity_eval(n_frames=N_FRAMES, params=dataclasses.replace(_port_params(), use_pallas=True),
                                  device="cpu")
    assert [s.route for s in routes] == ["xla-f64"]
    assert res["decision_agreement"] == 1.0
    assert res["drand48_in_lockstep"] is True
    assert res["rmse_vs_oracle"] <= 1e-3
    assert res["ate_vs_ground_truth"]["n"] == N_FRAMES - 1
