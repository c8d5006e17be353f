"""The reference over a benchmark stream: one camera, or lanes of a batch.

Each stream starts from the filter of its configuration (the first pose,
its prior, the four known features with their patches and zero
covariance) and its own drand48 stream, and is given the frames the system
under test was given. The records are what the comparison reads: the pose
and the decisions of every frame.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from perfbench.reference import monoslam as ms

DECISIONS = ("n_visible", "n_selected", "n_matched", "n_active", "n_partial", "did_init", "did_convert")


def bfloat16(a) -> np.ndarray:
    """a rounded to bfloat16 (8 significant bits, to nearest, ties to
    even), as float64."""
    a = np.asarray(a, np.float64)
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return u.view(np.float32).astype(np.float64).reshape(a.shape)


def replay(settings: dict, frames: np.ndarray, xv0, pxx0, known, rng_seed: int = 0, mapping: bool = True,
           control: bool = False) -> dict:
    """The reference over frames [T, H, W] u8 from the filter (xv0, pxx0)
    with the known features `known` [(y, xp_org, patch)] and drand48 stream
    srand48(rng_seed). control: every stored number held in bfloat16.
    Returns {"pose": [T, 7] (r, q), "decisions": [T, 7] int64 (DECISIONS)}."""
    p = ms.Params.of(settings)
    cam = ms.Cam(p.cam_width, p.cam_height, p.cam_fku, p.cam_fkv, p.cam_u0, p.cam_v0, p.cam_kd1, p.cam_sd)
    o = ms.OracleMonoSLAM(cam, p, xv0, pxx0, seed=rng_seed, quantize=bfloat16 if control else None)
    for y, xp_org, patch in known:
        o.feats.append(ms.Feat(y=np.asarray(y, float).copy(), pxy=np.zeros((13, 3)), pyy=np.zeros((3, 3)),
                               cross=[np.zeros((3, 3)) for _ in o.feats], patch=np.asarray(patch).copy(),
                               xp_org=np.asarray(xp_org, float).copy(), label=o.next_label, fully=True))
        o.next_label += 1
    pose = np.zeros((len(frames), 7))
    dec = np.zeros((len(frames), len(DECISIONS)), np.int64)
    with np.errstate(all="ignore"):
        for t, frame in enumerate(frames):
            rec = o.go_one_step(frame, mapping)
            pose[t, :3], pose[t, 3:] = rec["r"], rec["q"]
            dec[t] = [int(rec[k]) for k in DECISIONS]
    return dict(pose=pose, decisions=dec)


def _replay_job(kw: dict) -> dict:
    return replay(**kw)


def replay_many(jobs: list, workers: int) -> list:
    """replay(**job) for each job, in up to `workers` processes (spawned,
    each ended before this returns); in this process where workers <= 1."""
    if workers <= 1 or len(jobs) <= 1:
        return [replay(**kw) for kw in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(jobs), os.cpu_count() or 1)) as pool:
        out = pool.map(_replay_job, jobs)
        pool.close()
        pool.join()
    return out
