"""The port's single-stream pure-XLA route (use_pallas=False) against the
JAX f32 step with use_pallas=False, frame by frame.

The first 30 frames of the std synthetic sequence (320x240, max_features
16, 100 particles), mapping on: four auto-inits (output indices 9, 15, 22,
28), particle searches on the frames between and two ray -> point
conversions (20, 27). The JAX step runs once in a subprocess
(tests/test_torch_split_step_jax.py::run_jax_step: SCENELIB2_X64=0, one
compute thread; its stage 3 is correlate.elliptical_search_batch, stage 4
inverts S with pallas_chol_inv_lower, stage 8 runs under
lax.cond(making_any, heavy, light) with the union-box particle search and
the XLA Bayes chain). The port's replay must give identical per-frame
decision fields, selection sets, init boxes and particle-search slots and
masks; the particle rows are zero exactly where JAX's are and elsewhere
agree to 1e-3 of each field's largest entry; r and xv agree within 1e-4
(run_jax_step's module says why).

The route inverts S by K14 (the twin on the CPU) once a frame and by no
other path, and a manual auto-init on the route is JAX's
_auto_initialise(..., want_init=True) on its XLA chain.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.core import ekf
from tests.test_torch_split_step_jax import assert_same_run, run_jax_step

N_FRAMES = 30
XLA = dict(max_features=16, use_pallas=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_xla")
    return out, run_jax_step(out, N_FRAMES, None, XLA)


def test_xla_route_matches_the_jax_step_frame_by_frame(jax_run, monkeypatch):
    out, want = jax_run
    np.testing.assert_array_equal(np.flatnonzero(want["did_init"]), [9, 15, 22, 28])
    np.testing.assert_array_equal(np.flatnonzero(want["did_convert"]), [20, 27])
    assert want["par_mask"].any()
    calls = []
    real = ekf.chol_inv
    monkeypatch.setattr(ekf, "chol_inv", lambda S: calls.append(tuple(S.shape)) or real(S))
    slam = MonoSLAM(str(out / "synthetic.cfg"), device="cpu", **XLA)
    assert slam._step.route == "xla"
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert_same_run(got, want, "xla route")
    assert calls == [(1, 20, 20)] * N_FRAMES          # K14: one 2 NSEL x 2 NSEL S a frame


def test_xla_route_go_one_step_and_manual_init_follow_the_replay(jax_run):
    """go_one_step frame by frame equals the replay bit for bit, and the
    facade's manual auto-init runs stage 7 of the route with no gate."""
    out, want = jax_run
    slam = MonoSLAM(str(out / "synthetic.cfg"), device="cpu", **XLA)
    ref = MonoSLAM(str(out / "synthetic.cfg"), device="cpu", **XLA)
    outs = ref.run_sequence(want["frames"][1:13], enable_mapping=True)
    for t in range(12):
        slam.go_one_step(want["frames"][1 + t])
        for name, a in slam.last_output._asdict().items():
            assert torch.equal(a, getattr(outs, name)[t]), (t, name)
    n_before = int(slam.state.active.sum())
    assert slam.initialise_auto_feature(want["frames"][13])
    assert int(slam.state.active.sum()) == n_before + 1
    assert int((slam.state.active & ~slam.state.full).sum()) >= 1
