"""The port's single-stream f64 step (precision="f64") against the JAX
package's step in its f64 parity mode (x64 on), frame by frame, on both of
JAX's f64 routes, and the f64 checkpoints.

The first 30 frames of the std synthetic sequence (320x240, max_features
16, 100 particles), mapping on: four auto-inits (output indices 9, 15, 22,
28), particle searches on the frames between and two ray -> point
conversions (20, 27). The JAX step runs once a route in a subprocess with
x64 on (tests/test_torch_split_step_jax.py::run_jax_step with x64=True:
the JAX package's default process, one compute thread, the search kernel
of use_pallas=True in interpret mode). Compared (assert_same_run):
decisions, selection sets, init boxes and particle slots and masks
exactly, r and xv within 1e-8, the particle rows zero where JAX's are and
elsewhere within 1e-8 of each field's largest entry. The two steps differ
only in the order of a few sums (XLA's dot products and its fused
multiply-adds against the port's left-to-right mm_seq), ~1e-14 apart.

  use_pallas=False  the parity route "xla-f64": no kernel wrapper is
                    called, K14 (f32 only, as JAX's pallas_chol_inv_lower)
                    included
  use_pallas=True   JAX's hybrid route "k2-f64": K2 (its plain twin on the
                    CPU; JAX's kernel in interpret mode) once a frame on
                    f32 casts of S^-1, no other kernel wrapper

go_one_step and a manual initialise_auto_feature follow the replay on both.
A JAX x64 checkpoint (after frame 12 of the parity route) loads into an f64
MonoSLAM with no cast, and the next step equals JAX's; the port's f64
save/load round trip is bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.core import ekf
from scenelib2_torch.runtime import step as step_mod
from tests.test_torch_split_step_jax import assert_same_run, run_jax_step

N_FRAMES = 30
F64_TOL = 1e-8
CKPT_AT = 12
ROUTES = {"xla-f64": False, "k2-f64": True}
# every kernel wrapper that the step module calls
WRAPPERS = ("predict_measure", "measure_select", "search", "search_windows", "joint_update",
            "propose_region", "shi_tomasi", "search_bayes", "search_bayes_maps", "score_map",
            "particle_predict", "particle_search", "bayes_update")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = {}
    for route, use_pallas in ROUTES.items():
        out = tmp_path_factory.mktemp(f"jax_{route}")
        runs[route] = out, run_jax_step(out, N_FRAMES, None, dict(max_features=16, use_pallas=use_pallas),
                                        x64=True, checkpoint_at=CKPT_AT if not use_pallas else 0)
    return runs


def _slam(out, route):
    return MonoSLAM(str(out / "synthetic.cfg"), device="cpu", precision="f64", max_features=16,
                    use_pallas=ROUTES[route])


def _count_wrappers(monkeypatch):
    calls = {name: 0 for name in WRAPPERS + ("chol_inv",)}

    def counting(name, real):
        def f(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return f

    for name in WRAPPERS:
        monkeypatch.setattr(step_mod, name, counting(name, getattr(step_mod, name)))
    monkeypatch.setattr(ekf, "chol_inv", counting("chol_inv", ekf.chol_inv))
    return calls


@pytest.mark.parametrize("route", list(ROUTES))
def test_f64_route_matches_the_jax_x64_step_frame_by_frame(route, jax_runs, monkeypatch):
    out, want = jax_runs[route]
    np.testing.assert_array_equal(np.flatnonzero(want["did_init"]), [9, 15, 22, 28])
    np.testing.assert_array_equal(np.flatnonzero(want["did_convert"]), [20, 27])
    assert want["par_mask"].any()
    calls = _count_wrappers(monkeypatch)
    slam = _slam(out, route)
    assert slam._step.route == route and slam.state.x.dtype == torch.float64
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert got.r.dtype == torch.float64 and want["r"].dtype == np.float64
    assert_same_run(got, want, route, step_tol=F64_TOL, rows_rtol=F64_TOL)
    assert calls["chol_inv"] == 0
    assert calls == {name: (N_FRAMES if route == "k2-f64" and name == "search" else 0) for name in calls}


@pytest.mark.parametrize("route", list(ROUTES))
def test_f64_go_one_step_and_manual_init_follow_the_replay(route, jax_runs):
    """go_one_step frame by frame equals the replay bit for bit, and the
    facade's manual auto-init runs stage 7 of the f64 step with no gate."""
    out, want = jax_runs[route]
    slam, ref = _slam(out, route), _slam(out, route)
    outs = ref.run_sequence(want["frames"][1:13], enable_mapping=True)
    for t in range(12):
        slam.go_one_step(want["frames"][1 + t])
        for name, a in slam.last_output._asdict().items():
            assert torch.equal(a, getattr(outs, name)[t]), (t, name)
    n_before = int(slam.state.active.sum())
    assert slam.initialise_auto_feature(want["frames"][13])
    assert int(slam.state.active.sum()) == n_before + 1
    assert int((slam.state.active & ~slam.state.full).sum()) >= 1
    assert slam.state.x.dtype == torch.float64 and slam.state.lam.dtype == torch.float64


def test_jax_x64_checkpoint_loads_with_no_cast_and_steps_as_jax(jax_runs, tmp_path):
    out, want = jax_runs["xla-f64"]
    slam = _slam(out, "xla-f64")
    slam.load_checkpoint(str(out / "jax_ckpt.npz"))
    with np.load(out / "jax_ckpt.npz") as z:
        assert z["state_x"].dtype == np.float64
        np.testing.assert_array_equal(slam.state.x.numpy(), z["state_x"])
        np.testing.assert_array_equal(slam.state.P.numpy(), z["state_P"])
        np.testing.assert_array_equal(slam.state.lam.numpy(), z["state_lam"])
    got = slam.run_sequence(want["frames"][CKPT_AT + 1 : CKPT_AT + 4], enable_mapping=True)
    part = {k: v[CKPT_AT : CKPT_AT + 3] for k, v in want.items() if k != "frames"}
    assert_same_run(got, part, "after the JAX checkpoint", step_tol=F64_TOL, rows_rtol=F64_TOL)
    np.testing.assert_allclose(got.r.numpy(), part["r"], rtol=0, atol=F64_TOL)


def test_f64_checkpoint_round_trip_is_bit_for_bit(jax_runs, tmp_path):
    out, want = jax_runs["xla-f64"]
    a = _slam(out, "xla-f64")
    a.run_sequence(want["frames"][1:17], enable_mapping=True)
    path = str(tmp_path / "ckpt")
    a.save_checkpoint(path)
    b = _slam(out, "xla-f64")
    b.load_checkpoint(path)
    for name, x, y in zip(a.state._fields, a.state, b.state):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    oa = a.run_sequence(want["frames"][17:20], enable_mapping=True)
    ob = b.run_sequence(want["frames"][17:20], enable_mapping=True)
    for name, x, y in zip(oa._fields, oa, ob):
        assert torch.equal(x, y), name
