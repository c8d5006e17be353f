"""Trajectory evaluation (a port of scenelib2_tpu/eval/metrics.py).

trajectory_rmse and ate_stats are numpy and hold any two position tracks
(the port's against the synthetic renderer's exact trajectory, or against
the JAX package's). run_parity_eval, the JAX module's end-to-end parity
measurement against the NumPy oracle of the tests, drives the f64 step,
which the port does not run yet: it raises.
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


def run_parity_eval(n_frames: int = 40, seed: int = 7, params=None) -> dict:
    """The JAX package's parity measurement runs its f64 step against the
    NumPy reference oracle; the f64 step is not ported."""
    from scenelib2_torch.runtime.step import ROADMAP_F64, roadmap_item

    raise NotImplementedError(
        "run_parity_eval drives the f64 parity step against the NumPy oracle; the f64 step is "
        f"not ported yet ({roadmap_item(ROADMAP_F64)})")
