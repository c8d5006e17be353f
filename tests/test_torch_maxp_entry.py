"""The entry points at max_features_to_init_at_once = 2, on the CPU: a cfg
file that sets params.max_features_to_init_at_once = 2 through `cli run`
and `cli print-state`, go_one_step against run_sequence, and the manual
initialise_auto_feature beside two partial features.

The std sequence's first 24 frames hold two partial features from output
index 10 on and search both slots at 11-14 and 18-21 (the JAX step's run:
tests/test_torch_maxp_step_jax.py); its 239 frames reproduce
expected_fingerprint_maxp2.json there.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM, cli
from scenelib2_torch.config import load_config
from scenelib2_torch.eval.synthetic import generate_dataset
from scenelib2_torch.io.pgm import write_pgm
from scenelib2_torch.runtime.step import pack_outputs
from tests.torch_maxp_jax import MAXP2, both_searched

N_FRAMES = 24
KEY = "params.max_features_to_init_at_once"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def maxp_cfg(tmp_path_factory):
    """(frames, the generated cfg, a copy of it beside it with the key set to 2)."""
    d = tmp_path_factory.mktemp("maxp_ds")
    frames, _rs, _qs, cfg = generate_dataset(str(d), n_frames=N_FRAMES + 1)
    with open(cfg) as f:
        text = f.read()
    assert f"{KEY} = 1;" in text
    cfg2 = os.path.join(os.path.dirname(cfg), "maxp2.cfg")
    with open(cfg2, "w") as f:
        f.write(text.replace(f"{KEY} = 1;", f"{KEY} = 2;"))
    return frames, cfg, cfg2


def test_a_cfg_with_the_key_runs_through_cli_run_and_print_state(maxp_cfg, tmp_path, capsys):
    frames, _cfg, cfg2 = maxp_cfg
    assert load_config(cfg2).params.max_features_to_init_at_once == 2
    seq = tmp_path / "seq"
    os.makedirs(seq)
    for i, f in enumerate(frames):
        write_pgm(str(seq / f"frame_{i:04d}.pgm"), f)
    out = tmp_path / "run"
    cli.main(["run", "--config", cfg2, "--seq", str(seq), "--out", str(out), "--mapping", "--checkpoint", "--cpu"])
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    want = MonoSLAM(cfg2, max_features=16, device="cpu").run_sequence(frames[1:], enable_mapping=True)
    for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init", "did_convert"):
        np.testing.assert_array_equal([r[k] for r in recs], getattr(want, k).numpy(), err_msg=k)
    assert max(r["n_partial"] for r in recs) == 2 and len(both_searched(want)) > 0
    capsys.readouterr()
    cli.main(["print-state", "--config", cfg2, "--checkpoint", str(out / "final_state.npz"), "--cpu"])
    printed = capsys.readouterr().out
    assert "[Robot state]" in printed
    partial_rows = [line for line in printed.splitlines() if "'fully_initialised': False" in line]
    assert len(partial_rows) == int(want.n_partial[-1])


def test_go_one_step_equals_run_sequence_at_maxp2(maxp_cfg):
    frames, cfg, _cfg2 = maxp_cfg
    seq = MonoSLAM(cfg, max_features=16, device="cpu", **MAXP2)
    outs = seq.run_sequence(frames[1:], enable_mapping=True)
    one = MonoSLAM(cfg, max_features=16, device="cpu", **MAXP2)
    rows = []
    for t in range(1, N_FRAMES + 1):
        one.go_one_step(frames[t])
        rows.append(pack_outputs(one.last_output))
    assert torch.equal(torch.stack(rows), pack_outputs(outs))
    for a, b in zip(one.state, seq.state):
        assert torch.equal(a, b)


def test_manual_auto_init_beside_two_partial_features(maxp_cfg):
    """initialise_auto_feature has no partial-count gate (JAX's
    _auto_initialise(..., want_init=True)): beside two partial features it
    adds a third; stage 8 then takes the two lowest partial slots (K1's
    rule), searching those measured before, and the step's own gate
    (n_partial < 2) stays closed."""
    frames, cfg, _cfg2 = maxp_cfg
    slam = MonoSLAM(cfg, max_features=16, device="cpu", **MAXP2)
    slam.run_sequence(frames[1:19], enable_mapping=True)
    assert int(slam.last_output.n_partial) == 2
    assert slam.initialise_auto_feature(frames[19])
    partial = (slam.state.active & ~slam.state.full).nonzero().flatten().tolist()
    assert len(partial) == 3
    measured = (slam.state.match_attempts[partial[:2]] != 0).numpy()
    assert measured.any()
    outs = slam.run_sequence(frames[19:], enable_mapping=True)
    assert outs.par_slot.shape[-1] == 2
    np.testing.assert_array_equal(outs.par_slot[0].numpy(), partial[:2])
    np.testing.assert_array_equal(outs.par_mask[0].numpy(), measured)
    assert not bool(outs.did_init[0])
    assert torch.isfinite(outs.r).all()
