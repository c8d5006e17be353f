"""The bench suite's single-stream cells on the CPU (the plain twins):
bench_autoinit at max_features 24 and bench_hires at JAX's bench_hires
configuration (radii 32 / 32) reproduce the committed
expected_fingerprint_autoinit.json and expected_fingerprint_hires_bench.json
(made by scripts/gen_largemap_fingerprints.py from the JAX package) with the
JAX bench's metric names; bench_hires_r48, the same dataset at the radii 48
/ 52, reports under a metric name of its own against
expected_fingerprint_hires.json; and timed_replay's replays from one
pristine state give the same outputs as run_sequence."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import scenelib2_torch
from scenelib2_torch import MonoSLAM
from scenelib2_torch.eval import benchmark
from scenelib2_torch.eval.fingerprint import decisions_fingerprint, load_expected
from scenelib2_torch.eval.selftest import std_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_autoinit_reproduces_its_fingerprint():
    r = benchmark.bench_autoinit(device="cpu", repeats=1)
    assert r["metric"] == "fps_autoinit_320x240" and r["unit"] == "frames/sec" and r["value"] > 0
    assert r["card"] == "cpu" and r["frames"] == 239
    want = {k: v for k, v in load_expected(r["fingerprint_file"]).items() if k != "dataset_version"}
    assert r["fingerprint_file"] == "expected_fingerprint_autoinit"
    assert r["fingerprint"] == want
    assert (r["inits"], r["conversions"], r["final_map"]) == (want["inits"], want["convs"], want["active_end"])


def test_timed_replay_equals_run_sequence():
    frames, cfg = std_dataset(240)
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    seq = slam._to_device(frames[1:41])
    _dt, outs = benchmark.timed_replay(slam, seq, repeats=2)
    slam.reset()
    ref = slam.run_sequence(seq)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    assert decisions_fingerprint(outs, 40) == decisions_fingerprint(ref, 40)


@pytest.fixture
def built(monkeypatch):
    """The Params of every MonoSLAM that a bench builds."""
    seen = []

    class Recording(MonoSLAM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self.params)

    monkeypatch.setattr(scenelib2_torch, "MonoSLAM", Recording)
    return seen


def test_bench_hires_runs_jax_bench_hires_configuration(built):
    r = benchmark.bench_hires(device="cpu", repeats=1)
    assert r["metric"] == "fps_640x480_60feat" and r["frames"] == 119
    (p,) = built
    assert (p.cam_width, p.cam_height, p.max_features, p.n_particles) == (640, 480, 60, 200)
    assert (p.search_win_radius, p.particle_win_radius) == (32, 32)      # the cfg carries no radii
    assert r["fingerprint_file"] == "expected_fingerprint_hires_bench"
    want = {k: v for k, v in load_expected(r["fingerprint_file"]).items() if k != "dataset_version"}
    assert r["fingerprint"] == want
    assert r["final_map"] == want["active_end"]


def test_bench_hires_r48_has_a_metric_of_its_own(built, monkeypatch):
    monkeypatch.setattr(benchmark, "_single", lambda slam, frames, repeats, fp_file: (
        1.0, SimpleNamespace(n_active=torch.zeros(1, dtype=torch.int32)), dict(frames=119, fingerprint_file=fp_file)))
    r = benchmark.bench_hires_r48(device="cpu", repeats=1)
    assert r["metric"] == "fps_640x480_60feat_r48"
    assert r["fingerprint_file"] == "expected_fingerprint_hires"
    (p,) = built
    assert (p.search_win_radius, p.particle_win_radius, p.max_features) == (48, 52, 60)
    assert load_expected("expected_fingerprint_hires") != load_expected("expected_fingerprint_hires_bench")
