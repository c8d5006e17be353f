"""The bench suite's single-stream cells on the CPU (the plain twins):
bench_autoinit at max_features 24 reproduces the committed
expected_fingerprint_autoinit.json (made by scripts/gen_largemap_fingerprints.py
from the JAX package) with the JAX bench's metric names, and timed_replay's
replays from one pristine state give the same outputs as run_sequence."""

from __future__ import annotations

import pytest
import torch

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
