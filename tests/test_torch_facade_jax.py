"""The port's MonoSLAM facade against the JAX package's, call by call.

One script of facade calls runs through JAX's MonoSLAM (f32 fast mode, in a
subprocess with SCENELIB2_X64=0: fast mode is fixed when JAX initialises,
and this test process runs JAX with x64) and through the port's
MonoSLAM(device="cpu"), on tests/test_facade.py's small configuration
(160x120, max_features 8, 16 particles, NSEL 4) and the same synthetic
frames (with tests/test_viz_interactive.py's smaller init region, so
that proposals find room):

  10 steps, initialise_feature at a textured pixel, initialise_auto_feature
  (the map then holds max_init partial features, so the step's gate would
  close), mark_feature_by_lab + delete_feature, add_new_known_feature, 10
  steps, save_checkpoint, 5 steps, load_checkpoint, 5 steps, reset, 5
  steps;

and, each on a fresh facade: initialise_auto_feature before any step (speed
0 and every known feature visible: the step's gate would close), and with
no free slot (the map filled by add_new_known_feature); initialise_feature
at a border pixel; save_patch of a marked feature; print_robot_state of one
state (the JAX run's final checkpoint, loaded by the port).

After every call the slot bookkeeping (active, full, label, patches,
attempts, successes) and the drand48 limbs are identical, as are every
call's return value and every step's decisions (the counters and the
selection set); x and P agree within STEP_TOL (the f32 step tolerance of
tests/test_torch_step_jax.py). save_patch writes the same bytes and
print_robot_state prints the same text.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.eval.fingerprint import DECISION_FIELDS, selection_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 1e-4
N_FRAMES = 26
EXACT = ("active", "full", "label", "patches", "attempts", "successes", "rng")

# the script both packages run: only facade calls and numpy
SCRIPT = r"""
import numpy as np

# tests/test_viz_interactive.py's init region and separation: with the
# stock region scaled to 160x120 every proposal clashes with a feature
PARAMS_OVERRIDES = dict(max_features=8, n_particles=16, n_features_to_select=4,
                        n_features_to_keep_visible=6, min_particles=4, init_search_width=24,
                        init_search_height=18, feature_separation_min=5)
SMALL = dict(cam_width=160, cam_height=120, cam_fku=98.0, cam_fkv=98.0, cam_u0=80.0, cam_v0=60.0,
             **PARAMS_OVERRIDES)


def to_np(a):
    if hasattr(a, 'detach'):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def snap(slam, tag, ret=None, out=False):
    rec = dict(tag=tag, ret=ret, **{k: to_np(v) for k, v in slam.state._asdict().items()},
               marked=slam.marked_feature_label)
    if out:
        rec['out'] = {k: to_np(v) for k, v in slam.last_output._asdict().items()}
    return rec


def drive(make, frames, rs, qs, work):
    recs = []
    slam = make()
    f = 1

    def steps(n, tag):
        nonlocal f
        for _ in range(n):
            slam.go_one_step(frames[f])
            recs.append(snap(slam, f'{tag} frame {f}', out=True))
            f += 1

    steps(10, 'steps 1')
    recs.append(snap(slam, 'initialise_feature', slam.initialise_feature(frames[10], 80, 60)))
    recs.append(snap(slam, 'initialise_auto_feature (max_init partials)',
                     slam.initialise_auto_feature(frames[10])))
    slam.mark_feature_by_lab(1)
    recs.append(snap(slam, 'mark_feature_by_lab'))
    recs.append(snap(slam, 'delete_feature', slam.delete_feature()))
    xp = np.concatenate([rs[10], qs[10]])
    slam.add_new_known_feature(np.array([0.05, -0.02, 0.0]), xp, frames[10][50:61, 70:81])
    recs.append(snap(slam, 'add_new_known_feature'))
    steps(10, 'steps 2')
    slam.save_checkpoint(work + '/ckpt.npz')
    steps(5, 'steps 3')
    slam.load_checkpoint(work + '/ckpt.npz')
    recs.append(snap(slam, 'load_checkpoint'))
    f -= 5
    steps(5, 'steps 3 again')
    slam.mark_feature_by_lab(0)
    slam.reset()
    recs.append(snap(slam, 'reset'))
    f = 1
    steps(5, 'after reset')
    slam.save_checkpoint(work + '/final.npz')

    fresh = make()
    recs.append(snap(fresh, 'initialise_auto_feature (no step yet)', fresh.initialise_auto_feature(frames[1])))
    recs.append(snap(fresh, 'initialise_feature (border)', fresh.initialise_feature(frames[1], 2, 2)))
    full = make()
    for k in range(4):
        full.add_new_known_feature(np.array([0.02 * k, 0.01, 0.0]), xp, frames[1][40:51, 60 + k:71 + k])
    recs.append(snap(full, 'map full'))
    recs.append(snap(full, 'initialise_auto_feature (no free slot)', full.initialise_auto_feature(frames[3])))
    full.mark_feature_by_lab(6)
    recs.append(snap(full, 'save_patch', full.save_patch(work + '/patch.pgm')))
    return recs
"""

_JAX_RUNNER = r"""
import os, sys, pickle
os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
from scenelib2_tpu.config import Params
from scenelib2_tpu.eval.synthetic import generate_dataset
from scenelib2_tpu.runtime.slam import MonoSLAM

work, n = sys.argv[1], int(sys.argv[2])
exec(sys.argv[3])
frames, rs, qs, cfg = generate_dataset(work, n_frames=n, params=Params(**SMALL))
recs = drive(lambda: MonoSLAM(cfg, use_pallas=True, **PARAMS_OVERRIDES), frames, rs, qs, work)
slam = MonoSLAM(cfg, use_pallas=True, **PARAMS_OVERRIDES)
slam.load_checkpoint(work + '/final.npz')
text = slam.print_robot_state()
with open(os.path.join(work, 'jax_recs.pkl'), 'wb') as f:
    pickle.dump(dict(recs=recs, frames=frames, rs=rs, qs=qs, text=text), f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jwork = tmp_path_factory.mktemp("jax_facade")
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run([sys.executable, "-c", _JAX_RUNNER, str(jwork), str(N_FRAMES), SCRIPT],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(jwork / "jax_recs.pkl", "rb") as f:
        want = pickle.load(f)
    twork = tmp_path_factory.mktemp("torch_facade")
    ns: dict = {}
    exec(SCRIPT, ns)
    cfg = str(jwork / "synthetic.cfg")
    got = ns["drive"](lambda: MonoSLAM(cfg, device="cpu", **ns["PARAMS_OVERRIDES"]),
                      want["frames"], want["rs"], want["qs"], str(twork))
    return want, got, jwork, twork, cfg, ns


def _same_record(g: dict, w: dict):
    tag = w["tag"]
    assert g["tag"] == tag
    assert g["ret"] == w["ret"], (tag, g["ret"], w["ret"])
    assert g["marked"] == w["marked"], tag
    for k in EXACT:
        np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype), err_msg=f"{tag}: {k}")
    for k in ("x", "P"):
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=STEP_TOL, err_msg=f"{tag}: {k}")
    if "out" in w:
        go, wo = SimpleNamespace(**{k: v[None] for k, v in g["out"].items()}), \
            SimpleNamespace(**{k: v[None] for k, v in w["out"].items()})
        for name in DECISION_FIELDS:
            assert int(getattr(go, name)[0]) == int(getattr(wo, name)[0]), (tag, name)
        np.testing.assert_array_equal(selection_set(go), selection_set(wo), err_msg=tag)


def test_facade_script_matches_jax_call_by_call(runs):
    want, got, *_ = runs
    assert [r["tag"] for r in got] == [r["tag"] for r in want["recs"]]
    for g, w in zip(got, want["recs"]):
        _same_record(g, w)


def test_script_exercises_what_it_claims(runs):
    """The comparison is not vacuous: the manual inits add a partial feature,
    delete_feature frees the marked slot, the map gets full, and the steps
    after load_checkpoint repeat the steps after save_checkpoint."""
    want, _got, *_ = runs
    by = {r["tag"]: r for r in want["recs"]}
    assert by["initialise_feature"]["ret"] is True
    assert not by["initialise_feature (border)"]["ret"]
    assert by["delete_feature"]["ret"] is True and 1 not in by["delete_feature"]["label"]
    assert by["map full"]["active"].all()
    # the manual auto-init proposes where the step's gate would close, and
    # inserts a partial feature; with no free slot it answers as JAX does and
    # leaves the state alone
    for case, before in (("initialise_auto_feature (max_init partials)", "initialise_feature"),
                         ("initialise_auto_feature (no step yet)", None)):
        assert by[case]["ret"] is True, case
        n0 = 4 if before is None else int(by[before]["active"].sum())
        assert int(by[case]["active"].sum()) == n0 + 1, case
    nofree = by["initialise_auto_feature (no free slot)"]
    for k in EXACT + ("x", "P"):
        if k != "rng":
            np.testing.assert_array_equal(nofree[k], by["map full"][k], err_msg=k)
    assert by["reset"]["marked"] == -1
    for t in range(21, 26):
        a, b = by[f"steps 3 frame {t}"], by[f"steps 3 again frame {t}"]
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["rng"], b["rng"])


@pytest.mark.parametrize("case", ["initialise_auto_feature (no step yet)",
                                  "initialise_auto_feature (max_init partials)",
                                  "initialise_auto_feature (no free slot)"])
def test_initialise_auto_feature_answers_as_jax(runs, case):
    want, got, *_ = runs
    g = next(r for r in got if r["tag"] == case)
    w = next(r for r in want["recs"] if r["tag"] == case)
    assert isinstance(g["ret"], bool) and g["ret"] == w["ret"]
    _same_record(g, w)


def test_save_patch_writes_the_same_bytes(runs):
    _want, _got, jwork, twork, *_ = runs
    with open(jwork / "patch.pgm", "rb") as a, open(twork / "patch.pgm", "rb") as b:
        assert a.read() == b.read()


def test_print_robot_state_prints_the_same_text(runs, capsys):
    want, _got, jwork, _twork, cfg, ns = runs
    slam = MonoSLAM(cfg, device="cpu", **ns["PARAMS_OVERRIDES"])
    slam.load_checkpoint(str(jwork / "final.npz"))
    text = slam.print_robot_state()
    assert text == want["text"]
    assert text in capsys.readouterr().out


def test_reference_style_aliases(runs):
    *_, cfg, ns = runs
    slam = MonoSLAM(cfg, device="cpu", **ns["PARAMS_OVERRIDES"])
    assert slam.GoOneStep == slam.go_one_step
    assert slam.InitialiseAutoFeature == slam.initialise_auto_feature
    assert slam.InitialiseFeature == slam.initialise_feature
    assert slam.AddNewKnownFeature == slam.add_new_known_feature
    assert slam.SavePatch == slam.save_patch
    assert MonoSLAM.load_jax_checkpoint is MonoSLAM.load_checkpoint


def test_mark_feature_lab_quirk(runs):
    """monoslam.cpp:742-766: lab <= 0 skips the existence search — any
    non-positive label is marked while the list is non-empty."""
    *_, cfg, ns = runs
    s = MonoSLAM(cfg, device="cpu", **ns["PARAMS_OVERRIDES"])
    s.mark_feature_by_lab(0)
    assert s.marked_feature_label == 0
    s.mark_feature_by_lab(-7)
    assert s.marked_feature_label == -7
    s.mark_feature_by_lab(999)
    assert s.marked_feature_label == -7
    s.mark_feature_by_lab(-1)
    assert s.marked_feature_label == -1
    assert s.toggle_feature_lab(2) and 2 in s.selected_labels
    assert s.toggle_feature_lab(2) and 2 not in s.selected_labels
    assert not s.toggle_feature_lab(999)
