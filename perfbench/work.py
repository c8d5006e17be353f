"""The least work of a MonoSLAM frame, counted per stage from its shapes and
its decisions, and the least time it needs on one H100.

Every count is a function of the configuration's shapes (camera size, patch
side, particles a ray) and of what the frame's outputs report (the map's
size entering the frame, the features selected and matched and their
innovation covariances, the particles searched and their ellipses, whether a
ray was proposed or became a point), never of how the port computes them: a
change that fuses two stages or splits one into more launches leaves the
count unchanged. It counts what the algorithm needs:

- the live part of the state only: 13 camera numbers, 3 a point, 6 a ray
  (the covariance of D = 13 + 6 max_features is the configuration's
  capacity, most of it empty);
- each number of state read once and each written once, 4 bytes (f32),
  the symmetric covariance as its upper triangle; each frame pixel a
  search reads, 1 byte, once a stage;
- operations as multiply and add, 2 a multiply-add; a correlation
  candidate 2 B^2 (the cross sum with the patch; the window sums are
  shared by every candidate, and left out), plus 20 for the score;
  a Shi-Tomasi centre 10 operations a pixel of its region (two gradients,
  three products, running sums) and 15 for the eigenvalue.

The least time of a stretch of frames is the larger of its bytes over the
memory rate and its operations over the f32 rate (PEAK_BYTES_S,
PEAK_F32_S: NVIDIA's published H100 SXM peaks at 700 W, dense, outside
the tensor cores), over the whole stretch: stages that overlap could share
the time. The counts follow chip_smoke.py's bound (bytes / 3.35 TB/s
against f32 operations / 67 TFLOP/s) and the kernels' bytes_and_flops,
rewritten per stage.
"""

from __future__ import annotations

import math

import numpy as np

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
F32 = 4
CAM = 13


def _live_dim(n_active, n_partial):
    return CAM + 3 * (n_active - n_partial) + 6 * n_partial


def ellipse_cells(centre, S_inv, no_sigma: float, radius: int, W: int, H: int, half: int):
    """The candidate cells of one search: the 3-sigma ellipse of S_inv
    around the rounded centre, inside its window of side 2 radius + 1 and
    at valid patch centres. Returns (number of cells, (u_lo, u_hi, v_lo,
    v_hi) of their bounding box or None)."""
    a, b, c = S_inv[0, 0], S_inv[0, 1], S_inv[1, 1]
    if not (np.isfinite(centre).all() and np.isfinite(S_inv).all()) or a * c - b * b <= 0:
        return 0, None
    hw = int(min(no_sigma / math.sqrt(a - b * b / c), radius))
    hh = int(min(no_sigma / math.sqrt(c - b * b / a), radius))
    uc, vc = int(math.floor(centre[0] + 0.5)), int(math.floor(centre[1] + 0.5))
    u = np.arange(max(uc - hw, half), min(uc + hw, W - 1 - half) + 1) - uc
    v = np.arange(max(vc - hh, half), min(vc + hh, H - 1 - half) + 1) - vc
    if u.size == 0 or v.size == 0:
        return 0, None
    uu, vv = u[None, :].astype(float), v[:, None].astype(float)
    inside = a * uu * uu + 2 * b * uu * vv + c * vv * vv < no_sigma * no_sigma
    n = int(inside.sum())
    if n == 0:
        return 0, None
    rows, cols = np.nonzero(inside)
    return n, (uc + u[cols].min(), uc + u[cols].max() + 1, vc + v[rows].min(), vc + v[rows].max() + 1)


def frame_work(cfg: dict, prev: tuple, out: dict) -> dict:
    """{stage: (bytes, operations)} of one frame. cfg holds the
    configuration's settings; prev = (n_active, n_partial) entering the
    frame; out holds the frame's outputs as NumPy arrays: n_selected,
    n_matched, n_active, n_partial, did_init, did_convert, sel_mask [NSEL],
    sel_h [NSEL, 2], sel_S [NSEL, 2, 2], par_mask [MAXP], par_h [MAXP, NP,
    2], par_sinv [MAXP, NP, 2, 2], par_alive [MAXP, NP]."""
    B = cfg["boxsize"]
    half = (B - 1) // 2
    W, H = cfg["cam_width"], cfg["cam_height"]
    ns = cfg["no_sigma"]
    cand_ops = 2 * B * B + 20
    n_act, n_par = prev
    n_full = n_act - n_par
    D = _live_dim(n_act, n_par)
    w = {}
    # predict: F on the camera's rows of P (13 x D, read and written), Q
    w["predict"] = (2 * CAM * D * F32 + 2 * CAM * F32,
                    2 * CAM * CAM * D + 2 * CAM * CAM * CAM + 200)
    # measurement prediction and selection: a full feature's projection,
    # Jacobians and S = H P H' + R from Pxx, its Pxy block and Pyy
    w["measure"] = ((CAM * CAM + n_full * (CAM * 3 + 9 + 3)) * F32,
                    n_full * (2 * (2 * 7 * 7 + 2 * 7 * 2) + 2 * (2 * 7 * 3 + 2 * 3 * 2)
                              + 2 * (2 * 3 * 3 + 2 * 3 * 2) + 150) + n_full * 8)
    # search: each selected feature's ellipse in its window
    sb = so = 0
    for k in np.flatnonzero(out["sel_mask"]):
        S = out["sel_S"][k].astype(np.float64)
        det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
        if not det > 0:
            continue
        Sinv = np.array([[S[1, 1], -S[0, 1]], [-S[1, 0], S[0, 0]]]) / det
        n, box = ellipse_cells(out["sel_h"][k].astype(np.float64), Sinv, ns, cfg["search_win_radius"],
                               W, H, half)
        if box is not None:
            sb += (box[1] - box[0] + B - 1) * (box[3] - box[2] + B - 1) + B * B
            so += n * cand_ops
    w["search"] = (sb, so)
    # update: M = 2 matched rows of H (10 non-zeros each: camera pose and
    # the point), P H', S, its inverse, W, and P - W S W' on the upper
    # triangle; x and P read and written once
    M = 2 * int(out["n_matched"])
    if M:
        w["update"] = ((2 * D + D * (D + 1)) * F32 + M * (2 + 10) * F32,
                       2 * D * M * 10 + 2 * M * M * 10 + M ** 3 + 2 * D * M * M + D * (D + 1) * M)
    # particles: every live partial ray's particles (projection, S, S^-1
    # and the Bayes weight) and the union of their ellipses
    pb = po = 0
    NP = out["par_alive"].shape[-1]
    for j in np.flatnonzero(out["par_mask"]):
        alive = np.flatnonzero(out["par_alive"][j])
        if alive.size == 0:
            continue
        po += alive.size * 400
        pb += (CAM * 6 + 36 + 2 * NP) * F32 * 2
        cells = np.zeros((H, W), bool)
        for i in alive:
            n, box = ellipse_cells(np.trunc(out["par_h"][j, i].astype(np.float64)) + 0.0,
                                   out["par_sinv"][j, i].astype(np.float64), ns, cfg["particle_win_radius"],
                                   W, H, half)
            if box is not None:
                cells[box[2] : box[3], box[0] : box[1]] = True
        n_union = int(cells.sum())
        if n_union:
            rows, cols = np.nonzero(cells)
            pb += (cols.max() - cols.min() + B) * (rows.max() - rows.min() + B) + B * B
            po += n_union * cand_ops
    if po:
        w["particles"] = (pb, po)
    # init: the Shi-Tomasi scan of the init region and the new ray's rows
    # of P (J = d ray / d camera, 6 x 13, against every live row)
    if bool(out["did_init"]):
        RW, RH = cfg["init_search_width"], cfg["init_search_height"]
        w["init"] = ((RW + B + 1) * (RH + B + 1) + (6 * (D + 6) + 6) * F32,
                     (RW + B + 1) * (RH + B + 1) * 10 + RW * RH * 15 + 2 * 6 * CAM * D + 2 * 6 * CAM * 6)
    # conversion: a ray's 6 rows of P become 3 (T = [I, lambda I], 3 x 6)
    if bool(out["did_convert"]):
        w["convert"] = ((6 + 3) * D * F32, 2 * 3 * 6 * D + 2 * 3 * 6 * 6)
    return w


def stretch_least_s(cfg: dict, start: tuple, outs: list) -> tuple[float, dict]:
    """(least seconds of a stretch of frames, {stage: [bytes, operations]})
    for outs, one dict a frame (frame_work's `out`) in order, from a map of
    start = (n_active, n_partial)."""
    tot = {}
    prev = start
    for out in outs:
        for stage, (b, f) in frame_work(cfg, prev, out).items():
            t = tot.setdefault(stage, [0, 0])
            t[0] += b
            t[1] += f
        prev = (int(out["n_active"]), int(out["n_partial"]))
    nb = sum(v[0] for v in tot.values())
    nf = sum(v[1] for v in tot.values())
    return max(nb / PEAK_BYTES_S, nf / PEAK_F32_S), tot
