"""The port's command line against the JAX package's.

One subprocess runs the JAX side in f32 fast mode (SCENELIB2_X64=0):
`python -m scenelib2_tpu.cli run --mapping --checkpoint` on a 6-frame PGM
directory of the std synthetic sequence, `print-state` on the port's
checkpoint, and run_sequence of the first 20 frames of the std sequence,
whose decisions_fingerprint becomes the selftest's expected file. Then:

  - `python -m scenelib2_torch.cli run --cpu` on the same directory writes
    the same metrics.jsonl decision fields frame by frame, the trajectory
    within STEP_TOL, a checkpoint, and a torch.profiler trace with
    --profile;
  - `print-state --cpu` prints what JAX's print-state prints for the same
    checkpoint;
  - `visualize` and `ar --cpu` write their PNGs (matplotlib's Agg);
  - `selftest --cpu --frames 20` returns 0 against the JAX expected file, 1
    with one field changed, 2 with no file;
  - `bench stress500` is refused by name, and run_all lists every bench
    that is not ported as such.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scenelib2_torch import cli
from scenelib2_torch.eval import benchmark
from scenelib2_torch.io.pgm import write_pgm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 1e-4
N_RUN = 7           # frames in the PGM directory (the first is skipped: 6 steps)
N_SELFTEST = 20     # the selftest's sequence (19 frames replayed)
DECISIONS = ("frame", "n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init",
             "did_convert")

_JAX_RUNNER = r"""
import os, sys, json, subprocess
os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
from scenelib2_tpu.cli import main
from scenelib2_tpu.eval.selftest import decisions_fingerprint
from scenelib2_tpu.eval.synthetic import DATASET_VERSION, generate_dataset
from scenelib2_tpu.runtime.slam import MonoSLAM

work, cfg, seq, port_ckpt, n_self = sys.argv[1:6]
main(['run', '--config', cfg, '--seq', seq, '--out', os.path.join(work, 'jax_run'), '--mapping',
      '--checkpoint'])
main(['print-state', '--config', cfg, '--checkpoint', port_ckpt])
n = int(n_self)
frames, _, _, scfg = generate_dataset(os.path.join(work, 'self'), n_frames=n)
outs = MonoSLAM(scfg, max_features=16, use_pallas=True).run_sequence(frames[1:], enable_mapping=True)
fp = decisions_fingerprint(jax.tree_util.tree_map(np.asarray, outs), n - 1)
fp['dataset_version'] = DATASET_VERSION
with open(os.path.join(work, 'expected.json'), 'w') as f:
    json.dump(fp, f, indent=1, sort_keys=True)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from scenelib2_torch.eval.synthetic import generate_dataset

    work = tmp_path_factory.mktemp("cli")
    frames, _rs, _qs, cfg = generate_dataset(str(work / "ds"), n_frames=N_RUN)
    seq = work / "seq"
    os.makedirs(seq)
    for i, f in enumerate(frames):
        write_pgm(str(seq / f"frame_{i:04d}.pgm"), f)
    cli.main(["run", "--config", cfg, "--seq", str(seq), "--out", str(work / "port_run"), "--mapping",
              "--checkpoint", "--profile", "--cpu"])
    port_ckpt = str(work / "port_run" / "final_state.npz")
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run([sys.executable, "-c", _JAX_RUNNER, str(work), cfg, str(seq), port_ckpt,
                          str(N_SELFTEST)], capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return work, cfg, seq, port_ckpt, res.stdout


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_matches_jax_cli_run(runs):
    work, *_ = runs
    got, want = _metrics(work / "port_run"), _metrics(work / "jax_run")
    assert len(got) == len(want) == N_RUN - 1
    for g, w in zip(got, want):
        assert {k: g[k] for k in DECISIONS} == {k: w[k] for k in DECISIONS}
        np.testing.assert_allclose(g["r"], w["r"], rtol=0, atol=STEP_TOL)
    gt = np.load(work / "port_run" / "trajectory.npz")["r"]
    wt = np.load(work / "jax_run" / "trajectory.npz")["r"]
    assert gt.shape == wt.shape == (N_RUN - 1, 3)
    np.testing.assert_allclose(gt, wt, rtol=0, atol=STEP_TOL)
    assert os.path.exists(work / "port_run" / "final_state.npz.json")
    assert os.path.getsize(work / "port_run" / "profile" / "trace.json") > 0


def test_print_state_matches_jax(runs, capsys):
    _work, cfg, _seq, port_ckpt, jax_stdout = runs
    capsys.readouterr()
    cli.main(["print-state", "--config", cfg, "--checkpoint", port_ckpt, "--cpu"])
    got = capsys.readouterr().out
    assert got.startswith("[Robot state]") and "[Robot covariance]" in got
    assert got in jax_stdout


def test_visualize_and_ar_write_pngs(runs, tmp_path, capsys):
    import matplotlib

    matplotlib.use("Agg")
    work, cfg, seq, *_ = runs
    out = str(tmp_path / "run.png")
    cli.main(["visualize", "--run", str(work / "port_run"), "--out", out, "--cpu"])
    assert os.path.getsize(out) > 0
    cli.main(["ar", "--config", cfg, "--seq", str(seq), "--out", str(tmp_path / "ar"), "--mapping",
              "--every", "2", "--cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ar_frames"] == 3 and os.path.getsize(rec["map"]) > 0
    assert sorted(os.listdir(tmp_path / "ar")) == ["ar_0000.png", "ar_0002.png", "ar_0004.png", "map3d.png"]


def _selftest(expected) -> int:
    with pytest.raises(SystemExit) as e:
        cli.main(["selftest", "--cpu", "--frames", str(N_SELFTEST), "--expected", str(expected)])
    return e.value.code


def test_selftest_exit_codes_against_a_jax_expected_file(runs, tmp_path):
    work, *_ = runs
    with open(work / "expected.json") as f:
        want = json.load(f)
    assert want["n_frames"] == N_SELFTEST - 1 and want["matched_sum"] > 0
    assert _selftest(work / "expected.json") == 0
    bad = dict(want, matched_sum=want["matched_sum"] + 1)
    with open(tmp_path / "bad.json", "w") as f:
        json.dump(bad, f)
    assert _selftest(tmp_path / "bad.json") == 1
    assert _selftest(tmp_path / "missing.json") == 2


def test_selftest_update_needs_a_path(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["selftest", "--cpu", "--update"])
    assert e.value.code == 2


def test_bench_refuses_an_unported_bench_by_name():
    with pytest.raises(SystemExit, match="not ported"):
        cli.main(["bench", "stress500", "--cpu"])
    with pytest.raises(NotImplementedError, match="ekf_update_ms_100feat"):
        benchmark.run_all(["ekf100"], device="cpu")


def test_run_all_lists_unported_benches(monkeypatch, capsys):
    ported = [n for n in benchmark.ALL_BENCHES if n not in benchmark.NOT_PORTED]
    assert ported == ["testseq", "autoinit", "hires", "batch64"]
    for n in ported:
        monkeypatch.setitem(benchmark.ALL_BENCHES, n, lambda device=None, n=n: dict(metric=n, device=device))
    results = benchmark.run_all(device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines == results and len(lines) == len(benchmark.ALL_BENCHES)
    assert [r["metric"] for r in lines[:4]] == ported
    for r in lines[4:]:
        assert r["ported"] is False and r["metric"] == benchmark.NOT_PORTED[r["bench"]]
    assert {r["bench"] for r in lines[4:]} == set(benchmark.NOT_PORTED)
