"""Trajectory evaluation (a port of scenelib2_tpu/eval/metrics.py).

trajectory_rmse and ate_stats are numpy and hold any two position tracks
(the port's against the synthetic renderer's exact trajectory, or against
the JAX package's). run_parity_eval is the JAX module's end-to-end parity
measurement: the f64 step against the NumPy reference oracle, the port's
own copy of it (eval/oracle_monoslam.py).
"""

from __future__ import annotations

import numpy as np


def trajectory_rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE between two [T,3] position tracks."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    n = min(len(a), len(b))
    d = a[:n] - b[:n]
    return float(np.sqrt((d * d).sum(axis=1).mean()))


def ate_stats(est: np.ndarray, gt: np.ndarray) -> dict:
    """Absolute trajectory error stats (no alignment — world frames agree)."""
    est = np.asarray(est, float)
    gt = np.asarray(gt, float)
    n = min(len(est), len(gt))
    err = np.linalg.norm(est[:n] - gt[:n], axis=1)
    return dict(
        rmse=float(np.sqrt((err**2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        final=float(err[-1]),
        n=n,
    )


def run_parity_eval(n_frames: int = 40, seed: int = 7, params=None, device=None) -> dict:
    """End-to-end parity measurement (JAX eval/metrics.py:40-112): the f64
    step against the NumPy oracle on a fresh synthetic sequence, both with
    mapping enabled. The step runs the JAX package's parity mode,
    precision="f64" with use_pallas=False (whatever `params` says), on
    resolve_device(device): CUDA unless device names another. Returns the
    trajectory RMSE against the oracle, the share of frames whose visible
    and matched counts agree, the error against the renderer's trajectory
    and whether the step's drand48 stream ends where the oracle's does.
    Slow (the oracle is pure Python): evaluation tooling."""
    import dataclasses

    import torch

    from scenelib2_torch.config import Params
    from scenelib2_torch.device import resolve_device
    from scenelib2_torch.eval import synthetic
    from scenelib2_torch.eval.oracle_monoslam import Cam, Feat, OracleMonoSLAM
    from scenelib2_torch.rng import unpack_state
    from scenelib2_torch.runtime import state as st
    from scenelib2_torch.runtime import step as step_mod

    params = dataclasses.replace(params or Params(max_features=16), use_pallas=False)
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    tex = synthetic.make_texture(rng)
    scale = 0.6 / params.cam_fku
    rs, qs = synthetic.default_trajectory(n_frames, params.delta_t)
    frames = np.stack(
        [synthetic.render_frame(params, tex, rs[i], qs[i], scale) for i in range(n_frames)]
    )
    xv0 = np.zeros(13)
    xv0[:3] = rs[0]
    xv0[3:7] = qs[0]
    xv0[9] = -0.02
    xv0[12] = 0.01
    pxx0 = np.zeros((13, 13))
    for i in (0, 1, 2, 7, 8, 9, 10, 11, 12):
        pxx0[i, i] = 0.0004
    half = (params.boxsize - 1) // 2
    feats = []
    for y in synthetic.KNOWN_POINTS:
        h = synthetic.project_point(params, y, rs[0], qs[0])
        uu, vv = int(round(h[0])), int(round(h[1]))
        feats.append(
            (y, np.concatenate([rs[0], qs[0]]), frames[0][vv - half : vv + half + 1, uu - half : uu + half + 1])
        )

    cam = Cam(params.cam_width, params.cam_height, params.cam_fku, params.cam_fkv,
              params.cam_u0, params.cam_v0, params.cam_kd1, params.cam_sd)
    oracle = OracleMonoSLAM(cam, params, xv0, pxx0, seed=0)
    for y, xp_org, patch in feats:
        oracle.feats.append(
            Feat(y=np.asarray(y, float).copy(), pxy=np.zeros((13, 3)), pyy=np.zeros((3, 3)),
                 cross=[np.zeros((3, 3)) for _ in range(len(oracle.feats))],
                 patch=patch.copy(), xp_org=np.asarray(xp_org, float).copy(),
                 label=oracle.next_label, fully=True)
        )
        oracle.next_label += 1
    ostats = [oracle.go_one_step(frames[i], True) for i in range(1, n_frames)]

    s = st.init_state(params, xv0, pxx0, device=device, dtype=torch.float64)
    for y, xp_org, patch in feats:
        s = st.add_known_feature(s, y, xp_org, patch)
    step = step_mod.make_step(params, device, "f64")
    seq = torch.as_tensor(frames).to(device)
    rows = []
    for i in range(1, n_frames):
        s, o = step(s, seq[i], True)
        rows.append((o.r, o.n_visible, o.n_matched))
    # one fetch at the end: the loop makes no host synchronisation
    jtraj = torch.stack([r[0] for r in rows]).cpu().numpy()
    n_vis = torch.stack([r[1] for r in rows]).cpu().numpy()
    n_mat = torch.stack([r[2] for r in rows]).cpu().numpy()
    agree = sum(int(st_o["n_visible"] == int(n_vis[i]) and st_o["n_matched"] == int(n_mat[i]))
                for i, st_o in enumerate(ostats))
    otraj = np.asarray(oracle.trajectory)
    return dict(
        rmse_vs_oracle=trajectory_rmse(jtraj, otraj),
        decision_agreement=agree / (n_frames - 1),
        ate_vs_ground_truth=ate_stats(jtraj, rs[1:n_frames]),
        drand48_in_lockstep=bool(unpack_state(s.rng.cpu().numpy()) == oracle.rng.state()),
    )
