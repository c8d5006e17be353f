"""The port's batch step on the CPU against the JAX batch step, lane by lane
and frame by frame.

The JAX side is jax.jit(jax.vmap(make_step(batch_mode=True, use_pallas=True),
in_axes=(0, 0, None))) in fast (f32) mode, run once in a subprocess
(SCENELIB2_X64=0 is fixed when JAX initialises; this process runs JAX with
x64), its Pallas kernels in interpret mode: about a minute on one core, most
of it the compile. The lanes are the bench_batch64 recipe at 8 lanes: 4 scene
textures x 2 one-frame phase offsets, each lane with its own known-feature
patches and its own random stream srand48(lane), max_features 16, mapping
on, 24 frames.

Both sides start from the same stacked state (the JAX lanes go through
convert.state_from_jax; the port's own eval.batch.make_lanes must build the
same). Every decision field, the selection as a (slot, matched) set, the
init box, the particle-search flags and the final slot flags are equal per
lane and frame; r and q agree within 1e-4. The lanes really diverge: at
least 4 distinct decision histories among the 8.

XLA's CPU compiler contracts a*b + c into a fused multiply-add, which the
TPU's vector unit, the CUDA kernels (-fmad=false) and the port's tensor ops
do not: under the lane vmap this turns the Shi-Tomasi discriminant
(A + C)^2 - 4 (A C - B^2) of a cell with A ~ C, B = 0 negative, its
eigenvalue NaN and the whole region's pick void
(scripts/batch64_near_ties.py). The JAX run here is therefore pinned to an
instruction set without FMA (--xla_cpu_max_isa=AVX), as the run that gave
lane 59 of the committed batch fingerprints is
(scripts/gen_batch64_fingerprint.py).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scenelib2_torch.convert import state_from_jax, state_to_numpy
from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.eval.fingerprint import DECISION_FIELDS, selection_set
from scenelib2_torch.parallel.mesh import make_batched_step, run_batch
from scenelib2_torch.runtime.step import StepOutputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LANES, N_TEXTURES, N_FRAMES = 8, 4, 24
STEP_TOL = 1e-4
EXACT_FIELDS = ("init_box", "par_mask", "par_alive", "sel_mask")
JAX_XLA_FLAGS = "--xla_cpu_max_isa=AVX"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_RUNNER = r"""
import os, sys
os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
sys.path.insert(0, os.path.join(sys.argv[1], 'scripts'))
from gen_batch64_fingerprint import lanes
from scenelib2_tpu.runtime import step as step_mod

out_dir, batch, textures, n = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
params, states, fb = lanes(batch, textures, n + 1)
assert params.batch_mode and params.use_pallas and params.batch_pallas
np.savez(os.path.join(out_dir, 'jax_state0.npz'),
         **{k: np.asarray(v) for k, v in states._asdict().items()})
vstep = jax.jit(jax.vmap(step_mod.make_step(params), in_axes=(0, 0, None)))
rec = []
for t in range(n):
    states, o = vstep(states, fb[t], True)
    rec.append({k: np.asarray(v) for k, v in o._asdict().items()})
np.savez(os.path.join(out_dir, 'jax_outs.npz'), frames=np.asarray(fb),
         final_active=np.asarray(states.active), final_full=np.asarray(states.full),
         **{k: np.stack([r[k] for r in rec]) for k in rec[0]})
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_batch")
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["PYTHONPATH"] = REPO
    env["TMPDIR"] = str(out)            # the JAX package caches its rendered datasets there
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + JAX_XLA_FLAGS
                        + " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1").strip()
    res = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, REPO, str(out), str(N_LANES), str(N_TEXTURES), str(N_FRAMES)],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out / "jax_outs.npz") as z:
        want = {k: z[k] for k in z.files}
    with np.load(out / "jax_state0.npz") as z:
        state0 = {k: z[k] for k in z.files}
    return out, want, state0


def _lane(outs, b):
    if isinstance(outs, dict):
        return SimpleNamespace(**{k: v[:, b] for k, v in outs.items() if k in StepOutputs._fields})
    return StepOutputs(*(a[:, b] for a in outs))


def _history(lane_outs) -> str:
    h = hashlib.sha256()
    for name in DECISION_FIELDS:
        h.update(np.asarray(getattr(lane_outs, name)).astype(np.int64).tobytes())
    h.update(selection_set(lane_outs).tobytes())
    return h.hexdigest()


def test_port_batch_step_equals_jax_vmapped_step_lane_by_lane(jax_run, tmp_path):
    _out, want, state0 = jax_run
    frames = want["frames"]                                         # [T, B, H, W]
    assert frames.shape[:2] == (N_FRAMES, N_LANES)

    # the port builds the same lanes from its own generator and config reader
    params, own, own_frames = make_lanes(str(tmp_path), N_LANES, N_TEXTURES, N_FRAMES + 1,
                                         device="cpu", dtype=torch.float32)
    assert own_frames.tobytes() == frames.tobytes()
    states = state_from_jax(state0, "cpu", torch.float32)
    for k, v in state_to_numpy(own).items():
        np.testing.assert_array_equal(v, state_to_numpy(states)[k], err_msg=k)
    assert params.batch_mode and params.max_features == 16

    step = make_batched_step(params, device="cpu")
    final, got = run_batch(step, states, frames, True, params)
    for b in range(N_LANES):
        g, w = _lane(got, b), _lane(want, b)
        for name in DECISION_FIELDS:
            np.testing.assert_array_equal(getattr(g, name).numpy().astype(np.int64),
                                          getattr(w, name).astype(np.int64), err_msg=f"lane {b}: {name}")
        np.testing.assert_array_equal(selection_set(g), selection_set(w), err_msg=f"lane {b}")
        for name in EXACT_FIELDS:
            np.testing.assert_array_equal(getattr(g, name).numpy(), getattr(w, name),
                                          err_msg=f"lane {b}: {name}")
        for k in ("r", "q"):
            np.testing.assert_allclose(getattr(g, k).numpy(), getattr(w, k), rtol=0, atol=STEP_TOL,
                                       err_msg=f"lane {b}: {k}")
    np.testing.assert_array_equal(final.active.numpy(), want["final_active"])
    np.testing.assert_array_equal(final.full.numpy(), want["final_full"])
    np.testing.assert_array_equal(final.frame_no.numpy(), np.full(N_LANES, N_FRAMES))

    # the lanes diverge, in the reference as in the port
    assert len({_history(_lane(want, b)) for b in range(N_LANES)}) >= 4
    assert want["did_init"].any() and want["did_convert"].any()
    assert len(set(want["n_active"][-1].tolist())) > 1
    # a lane with no partial feature steps beside a lane with a live ray
    n_partial_before = np.concatenate([np.zeros((1, N_LANES), np.int64), want["n_partial"][:-1]])
    assert ((n_partial_before == 0).any(axis=1) & (n_partial_before > 0).any(axis=1)).any()
