"""The single stream at max_features_to_init_at_once = 2 on
tests/test_fast_mode.py's small MAXP-2 configuration (160x120, max_features
8, 16 particles, NSEL 4: D = 61, the fused route with stage 8 every frame)
against the JAX f32 fast step, frame by frame.

As test_fast_mode has it (4 features to keep visible, the 80 x 60 init
region of a 320x240 frame) the map never grows: four known features stay
visible and a region of 80 x 60 leaves no room at 160x120, so no partial
feature is ever made. Here the two map-growth settings are scaled to the
frame, 6 features to keep visible and a 40 x 30 init region, so that the
30 frames hold inits, two partial features searched together (output
indices 15-20) and conversions.

The JAX side is test_fast_mode_pallas_maxp2_runs's scene (texture of seed
3, four known features at the corners of a 16 x 10 cm rectangle) over 30
frames of the default trajectory, stepped by jax.jit(make_step(params)) in a
subprocess (SCENELIB2_X64=0, interpret-mode kernels, ~40-60 s on one core);
it saves its initial state and every frame's outputs. The port starts from
that state (convert.state_from_jax) and steps make_step(params,
device="cpu") over the same frames: decisions, selection sets, init boxes,
partial slots and masks exactly, the alive particles' rows within 1e-3 of
their field's largest entry, r and xv within 1e-4 (tests/torch_maxp_jax.py).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scenelib2_torch.config import Params
from scenelib2_torch.convert import state_from_jax
from scenelib2_torch.runtime.step import make_step
from tests.torch_maxp_jax import assert_same_maxp_run, both_searched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 30
PARAMS = dict(cam_width=160, cam_height=120, cam_fku=98.0, cam_fkv=98.0, cam_u0=80.0, cam_v0=60.0,
              max_features=8, n_particles=16, n_features_to_select=4,
              min_particles=4, use_pallas=True, max_features_to_init_at_once=2,
              n_features_to_keep_visible=6, init_search_width=40, init_search_height=30)

_JAX_RUNNER = r"""
import json, os, sys
os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp
import numpy as np
import scenelib2_tpu
from scenelib2_tpu.config import Params
from scenelib2_tpu.eval import synthetic
from scenelib2_tpu.runtime import state as st, step as step_mod

out_dir, n, kw = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
params = Params(**kw)
rng = np.random.default_rng(3)
tex = synthetic.make_texture(rng, size=1024)
scale = 0.6 / params.cam_fku
rs, qs = synthetic.default_trajectory(n + 1, params.delta_t)
frames = np.stack([synthetic.render_frame(params, tex, rs[i], qs[i], scale) for i in range(n + 1)])
xv0 = np.zeros(13); xv0[:3] = rs[0]; xv0[3:7] = qs[0]; xv0[12] = 0.01
pxx0 = np.zeros((13, 13))
for i in (0, 1, 2, 7, 8, 9, 10, 11, 12): pxx0[i, i] = 0.0004
s = st.init_state(params, xv0, pxx0)
half = (params.boxsize - 1) // 2
for y in [[0.08, 0.05, 0], [-0.08, 0.05, 0], [0.08, -0.05, 0], [-0.08, -0.05, 0]]:
    h = synthetic.project_point(params, np.asarray(y), rs[0], qs[0])
    uu, vv = int(round(h[0])), int(round(h[1]))
    s = st.add_known_feature(s, y, np.concatenate([rs[0], qs[0]]),
                             frames[0][vv - half:vv + half + 1, uu - half:uu + half + 1])
np.savez(os.path.join(out_dir, 'jax_state0.npz'), **{k: np.asarray(v) for k, v in s._asdict().items()})
step = jax.jit(step_mod.make_step(params))
rec = []
for i in range(1, n + 1):
    s, o = step(s, jnp.asarray(frames[i]), True)
    rec.append({k: np.asarray(v) for k, v in o._asdict().items()})
np.savez(os.path.join(out_dir, 'jax_outs.npz'), frames=frames,
         **{k: np.stack([r[k] for r in rec]) for k in rec[0]})
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fast_mode_maxp2_configuration_matches_the_jax_step_frame_by_frame(tmp_path):
    import json

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_ENABLE_X64", "SCENELIB2_X64")}
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run([sys.executable, "-c", _JAX_RUNNER, str(tmp_path), str(N_FRAMES), json.dumps(PARAMS)],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(tmp_path / "jax_outs.npz") as z:
        want = {k: z[k] for k in z.files}
    with np.load(tmp_path / "jax_state0.npz") as z:
        state = state_from_jax({k: z[k] for k in z.files}, "cpu", torch.float32)
    assert want["did_init"].any() and want["did_convert"].any()
    assert want["par_slot"].shape == (N_FRAMES, 2) and len(both_searched(want)) >= 4
    step = make_step(Params(**PARAMS), device="cpu")
    assert step.route == "fused"
    outs = []
    for t in range(N_FRAMES):
        state, o = step(state, torch.as_tensor(want["frames"][t + 1]), True)
        outs.append(o)
    got = type(outs[0])(*(torch.stack(f) for f in zip(*outs)))
    assert_same_maxp_run(got, want, "fast-mode maxp2 configuration")
