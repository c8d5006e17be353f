"""Shared by the tests that hold the port's batch step against the JAX batch
step lane by lane and frame by frame (tests/test_torch_batch*_step_jax.py).

The JAX side is jax.jit(jax.vmap(make_step(batch_mode=True, use_pallas=True),
in_axes=(0, 0, None))) in fast (f32) mode on one JAX batch route
(scripts/gen_batch64_fingerprint.py ROUTES), run once in a subprocess
(SCENELIB2_X64=0 is fixed when JAX initialises; a test process runs JAX with
x64), its Pallas kernels in interpret mode. The lanes are the bench_batch64
recipe: scene textures x 2 one-frame phase offsets, each lane with its own
known-feature patches and its own random stream srand48(lane),
max_features 16, mapping on.

Both sides start from the same stacked state (the JAX lanes go through
convert.state_from_jax; the port's own eval.batch.make_lanes must build the
same). Every decision field, the selection as a (slot, matched) set, the
init box, the particle-search flags and the final slot flags are equal per
lane and frame; r and q agree within 1e-4.

XLA's CPU compiler contracts a*b + c into a fused multiply-add, which the
TPU's vector unit, the CUDA kernels (-fmad=false) and the port's tensor ops
do not: under the lane vmap this turns the Shi-Tomasi discriminant
(A + C)^2 - 4 (A C - B^2) of a cell with A ~ C, B = 0 negative, its
eigenvalue NaN and the whole region's pick void
(scripts/batch64_near_ties.py). The JAX run is therefore pinned to an
instruction set without FMA (--xla_cpu_max_isa=AVX), as the run that gave
lane 59 of the committed batch fingerprints is.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import torch

from scenelib2_torch.convert import state_from_jax, state_to_numpy
from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.eval.fingerprint import DECISION_FIELDS, selection_set
from scenelib2_torch.parallel.mesh import make_batched_step, run_batch
from scenelib2_torch.runtime.step import StepOutputs, batch_route

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 1e-4
EXACT_FIELDS = ("init_box", "par_mask", "par_alive", "sel_mask")
JAX_XLA_FLAGS = "--xla_cpu_max_isa=AVX"

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

out_dir, batch, textures, n, route = (sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
                                      sys.argv[6])
params, states, fb = lanes(batch, textures, n + 1, route)
assert params.batch_mode and params.use_pallas and params.batch_pallas == (route != 'bp0')
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


def run_jax_lanes(out, n_lanes: int, n_textures: int, n_frames: int, route: str = "default"):
    """Run the JAX batch step on `route` in a subprocess writing into the
    directory `out`; returns (outputs {field: [T, B, ...]} with frames,
    final_active, final_full; the stacked initial state {field: array})."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_ENABLE_X64", "SCENELIB2_BATCH_SB")}
    env["PYTHONPATH"] = REPO
    env["TMPDIR"] = str(out)            # the JAX package caches its rendered datasets there
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + JAX_XLA_FLAGS
                        + " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1").strip()
    res = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, REPO, str(out), str(n_lanes), str(n_textures), str(n_frames),
         route],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(os.path.join(out, "jax_outs.npz")) as z:
        want = {k: z[k] for k in z.files}
    with np.load(os.path.join(out, "jax_state0.npz")) as z:
        state0 = {k: z[k] for k in z.files}
    return want, state0


def lane(outs, b):
    if isinstance(outs, dict):
        return SimpleNamespace(**{k: v[:, b] for k, v in outs.items() if k in StepOutputs._fields})
    return StepOutputs(*(a[:, b] for a in outs))


def history(lane_outs) -> str:
    h = hashlib.sha256()
    for name in DECISION_FIELDS:
        h.update(np.asarray(getattr(lane_outs, name)).astype(np.int64).tobytes())
    h.update(selection_set(lane_outs).tobytes())
    return h.hexdigest()


def assert_port_equals_jax(want, state0, tmp_path, n_lanes: int, n_textures: int, n_frames: int,
                           route: str = "default"):
    """Replay the port's batch step on `route` (CPU) from the JAX lanes'
    state and hold it to the JAX outputs; returns the port's outputs."""
    frames = want["frames"]                                         # [T, B, H, W]
    assert frames.shape[:2] == (n_frames, n_lanes)

    # the port builds the same lanes from its own generator and config reader
    params, own, own_frames = make_lanes(str(tmp_path), n_lanes, n_textures, n_frames + 1,
                                         device="cpu", dtype=torch.float32)
    assert own_frames.tobytes() == frames.tobytes()
    states = state_from_jax(state0, "cpu", torch.float32)
    for k, v in state_to_numpy(own).items():
        np.testing.assert_array_equal(v, state_to_numpy(states)[k], err_msg=k)
    assert params.batch_mode and params.max_features == 16

    if route == "bp0":
        params = dataclasses.replace(params, batch_pallas=False)
    step = make_batched_step(params, device="cpu", batch_sb=False if route == "sb0" else None)
    assert batch_route(params, False if route == "sb0" else None) == route
    final, got = run_batch(step, states, frames, True, params)
    for b in range(n_lanes):
        g, w = lane(got, b), lane(want, b)
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
    np.testing.assert_array_equal(final.frame_no.numpy(), np.full(n_lanes, n_frames))
    return got
