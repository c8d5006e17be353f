"""The comparison that decides `correct`: what the timed path produced
against the reference, frame by frame.

Each record is one pass of a stream (or of one sampled lane) that the
window completed; each is held against the reference of its stream. One
number is compared, with the limit its cell's file under limits/ gives:

- pose_gap_median: for each record, the median over its frames of the
  widest gap of a pose entry (r in metres, the quaternion), a NaN counting
  as infinite; the largest over the records.

The median, and not the widest gap, because the port's f32 step and the
f64 reference part where a decision lies within f32 rounding of its
threshold (PERF.md): the two then follow two sound paths some millimetres
apart for the rest of a pass, as far apart as the bfloat16 control's
widest gap, while the control departs on every frame. The widest gap and
the frames whose decisions (visible, selected and matched counts, the map's
size and its partial features, a proposal, a conversion) differ are shown
beside it, not compared. A record the window did not complete is not
compared; a window that completed no pass fails.
"""

from __future__ import annotations

import numpy as np


def numbers(pose: np.ndarray, dec: np.ndarray, refs: list, limit: float | None = None) -> dict:
    """pose, dec [R, T, 7]: record i is held against refs[i % len(refs)]
    ({"pose", "decisions"} [T, 7]). frames_failed counts the frames of the
    records whose median gap is over `limit` (all, where limit is None)."""
    medians, widest, off, n, failed = [], [], 0, 0, 0
    for i in range(len(pose)):
        ref = refs[i % len(refs)]
        g = np.abs(pose[i] - ref["pose"])
        g = np.where(np.isnan(g), np.inf, g).max(axis=-1)
        medians.append(float(np.median(g)))
        widest.append(float(g.max()))
        off += int(np.any(dec[i] != ref["decisions"], axis=1).sum())
        n += len(dec[i])
        if limit is None or not medians[-1] <= limit:
            failed += len(dec[i])
    return dict(pose_gap_median=max(medians) if medians else float("inf"),
                pose_gap_widest=max(widest) if widest else float("inf"),
                frames_off=off, frames_compared=n, frames_failed=failed if n else 1)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": values[k], "limit": limits[k]} for k in sorted(limits)}
    return all(values[k] <= limits[k] for k in limits), shown
