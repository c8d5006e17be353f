"""What the port refuses, and what it no longer refuses: make_step,
make_batch_step and make_batched_step return a step for use_pallas=False,
the port's use_pallas default, and top-k over more selections than slots
refused where JAX's lax.top_k refuses it."""

from __future__ import annotations

import dataclasses
import os

import pytest

import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params, load_config
from scenelib2_torch.core import ekf
from scenelib2_torch.parallel.mesh import make_batched_step
from scenelib2_torch.runtime.step import (
    make_batch_step,
    make_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

P = Params()


@pytest.mark.parametrize("builder", ["make_step", "make_batch_step", "make_batched_step"])
def test_each_builder_returns_a_step_for_use_pallas_false(builder):
    """The pure-XLA route is ported: every builder returns its step (route
    "xla"), with batch_pallas either way."""
    build = {"make_step": make_step, "make_batch_step": make_batch_step,
             "make_batched_step": make_batched_step}[builder]
    for bp in (True, False):
        step = build(dataclasses.replace(P, use_pallas=False, batch_pallas=bp), device="cpu")
        assert callable(step) and step.route == "xla"


def test_use_pallas_defaults_to_the_kernel_route(monkeypatch):
    """The port keeps use_pallas=True as its default, where JAX's Params say
    False: JAX ties False to its f64 parity mode, and every JAX bench and the
    selftest pass use_pallas=True in f32. So precision="f64" alone lands on
    JAX's hybrid route (K2 in an f64 step), and the entry points that stand
    for JAX's parity process pass use_pallas=False themselves
    (tests/test_torch_f64_routes.py). A config file without the key takes
    the default too. use_pallas=False on the CPU runs the XLA route, with
    K14's plain twin inverting S once a step."""
    assert Params().use_pallas is True
    cfg = os.path.join(REPO, "data", "SceneLib2.cfg")
    assert load_config(cfg).params.use_pallas is True
    assert MonoSLAM(cfg, device="cpu")._step.route == "fused"
    calls = []
    real = ekf.chol_inv
    monkeypatch.setattr(ekf, "chol_inv", lambda S: calls.append(S.device.type) or real(S))
    slam = MonoSLAM(cfg, device="cpu", use_pallas=False)
    assert slam._step.route == "xla" and slam.params.use_pallas is False
    slam.go_one_step(torch.zeros((P.cam_height, P.cam_width), dtype=torch.uint8))
    assert calls == ["cpu"]


@pytest.mark.parametrize("use_pallas", [True, False])
def test_more_selections_than_slots_is_refused_where_jax_takes_top_k(use_pallas):
    """The JAX step's split, batch and pure-XLA routes select with
    lax.top_k(score, n_features_to_select), which refuses more selections
    than slots; the port refused nothing and counted slot 0 again for each
    missing slot."""
    p = dataclasses.replace(P, max_features=8, n_features_to_select=10, use_pallas=use_pallas)
    with pytest.raises(ValueError, match="exceeds max_features"):
        make_batched_step(p, device="cpu")
    if not use_pallas:
        with pytest.raises(ValueError, match="exceeds max_features"):
            make_step(p, device="cpu")
