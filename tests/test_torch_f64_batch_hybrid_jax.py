"""The port's f64 batch step on JAX's two hybrid batch routes against the
vmapped JAX step in its f64 parity mode (x64 on), lane by lane and frame by
frame (tests/torch_batch_jax.py says what is compared; r and q within
1e-8). Everything but stage 3 runs in f64 tensor operations on both:

  "k2-f64"  batch_pallas=True: K2 (its plain twin on the CPU; JAX's
            pallas_elliptical_search_fused in interpret mode under the lane
            vmap) on f32 casts of S^-1
  "k8-f64"  batch_pallas=False: K8 on gathered windows, with f32 casts of
            S^-1 and of the centres floor(h + 0.5)

2 lanes (one texture, two phase offsets) x 14 frames each: an init, a
particle search and a conversion.
"""

from __future__ import annotations

import pytest
import torch

from scenelib2_torch.runtime import step as step_mod
from tests.torch_batch_jax import assert_port_equals_jax, run_jax_lanes

N_LANES, N_TEXTURES, N_FRAMES = 2, 1, 14
# the JAX batch route -> (the port's f64 route, its stage-3 wrapper)
ROUTES = {"default": ("k2-f64", "search"), "bp0": ("k8-f64", "search_windows")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", list(ROUTES))
def test_port_f64_hybrid_batch_route_equals_jax_lane_by_lane(route, tmp_path_factory, tmp_path, monkeypatch):
    name, wrapper = ROUTES[route]
    calls = []
    real = getattr(step_mod, wrapper)
    monkeypatch.setattr(step_mod, wrapper, lambda *a: calls.append(a[-2].shape) or real(*a))
    built = []
    real_build = step_mod._lane_step
    monkeypatch.setattr(step_mod, "_lane_step", lambda *a, **k: built.append(real_build(*a, **k)) or built[-1])
    want, state0 = run_jax_lanes(tmp_path_factory.mktemp(f"jax_{route}_f64"), N_LANES, N_TEXTURES, N_FRAMES,
                                 route, precision="f64")
    got = assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES, route,
                                 precision="f64")
    assert [s.route for s in built] == [name]
    # one launch a frame for both lanes (sel_mask [B, NSEL])
    assert calls == [torch.Size([N_LANES, 10])] * N_FRAMES
    assert want["did_init"].any() and want["par_mask"].any()
    assert got.r.dtype == torch.float64
