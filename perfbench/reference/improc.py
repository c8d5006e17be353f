"""The reference's image processing, in NumPy over whole windows.

Literal semantics of SceneLib2's
  - correlate2_warning          (improc/improc.cpp:55-134)
  - elliptical_search           (monoslam.cpp:401-477)
  - SearchMultipleOverlappingEllipses::search
                                (search_multiple_overlapping_ellipses.cpp:106-196)
  - find_best_patch_inside_region (monoslam.cpp:1070-1205)
each computed over all of its candidates at once instead of one candidate
at a time. The integer sums are exact (int64, or float64 multiples of 1/4
far below 2^53), the double formulas are the reference's, operation for
operation and elementwise, and each scan's rule for ties is kept: the last
minimum in (u outer, v inner) order for the searches, the first maximum in
(v outer, u inner) order for the Shi-Tomasi scan.

The window caps of the configuration (its search_win_radius and
particle_win_radius) drop the candidates that lie outside the fixed-size
window a search reads: the window of side 2R + 1 around the rounded centre,
moved inside the image.
"""

from __future__ import annotations

import math

import numpy as np


def _box_sum(a: np.ndarray, b: int) -> np.ndarray:
    """Sums of every b x b window of a (top-left at each output cell)."""
    c = np.zeros((a.shape[0] + 1, a.shape[1] + 1), a.dtype)
    c[1:, 1:] = a.cumsum(0).cumsum(1)
    return c[b:, b:] - c[:-b, b:] - c[b:, :-b] + c[:-b, :-b]


def nssd_region(image: np.ndarray, patch: np.ndarray, u_lo: int, u_hi: int, v_lo: int, v_hi: int):
    """(corr, sd_patch, sd_image) of correlate2 at every patch centre in
    rows [v_lo, v_hi) x columns [u_lo, u_hi); the centres must be valid
    (the whole patch inside the image)."""
    b = patch.shape[0]
    half = (b - 1) // 2
    win = image[v_lo - half : v_hi + half, u_lo - half : u_hi + half].astype(np.int64)
    p = patch.astype(np.int64)
    nv, nu = v_hi - v_lo, u_hi - u_lo
    sg1 = _box_sum(win, b).astype(np.float64)
    sg1sq = _box_sum(win * win, b).astype(np.float64)
    cross = np.zeros((nv, nu), np.int64)
    for dy in range(b):
        for dx in range(b):
            cross += p[dy, dx] * win[dy : dy + nv, dx : dx + nu]
    sg0g1 = cross.astype(np.float64)
    n = float(b * b)
    sg0 = float(p.sum())
    sg0sq = float((p * p).sum())
    g0bar = sg0 / n
    g1bar = sg1 / n
    varg0 = sg0sq / n - g0bar * g0bar
    varg1 = sg1sq / n - g1bar * g1bar
    sd0 = math.sqrt(varg0)
    with np.errstate(invalid="ignore"):
        sd1 = np.sqrt(varg1)
    if sd0 == 0.0:
        return np.where(sd1 == 0.0, 0.0, 1.0), sd0, sd1
    with np.errstate(divide="ignore", invalid="ignore"):
        k = g0bar / sd0 - g1bar / sd1
        C = (sg0sq / varg0 + sg1sq / varg1 + n * (k * k) - sg0g1 * 2.0 / (sd0 * sd1)
             - sg0 * 2.0 * k / sd0 + sg1 * 2.0 * k / sd1)
        corr = C / n
    return np.where(sd1 == 0.0, 1.0, corr), sd0, sd1


def _half_extents(sinv, centre, no_sigma):
    """The 3-sigma box's integer half extents, or None where they or the
    centre are not finite numbers (a search that finds nothing: only a
    filter whose numbers have broken down asks for it)."""
    with np.errstate(all="ignore"):
        hw = no_sigma / np.sqrt(np.float64(sinv[0, 0] - sinv[0, 1] ** 2 / sinv[1, 1]))
        hh = no_sigma / np.sqrt(np.float64(sinv[1, 1] - sinv[0, 1] ** 2 / sinv[0, 0]))
    if not (np.isfinite(hw) and np.isfinite(hh) and np.all(np.isfinite(centre))):
        return None
    return int(hw), int(hh)


def _ellipse(sinv, urel, vrel, no_sigma):
    return (sinv[0, 0] * urel * urel + 2 * sinv[0, 1] * urel * vrel + sinv[1, 1] * vrel * vrel
            < no_sigma * no_sigma)


def _last_min(corr: np.ndarray, ok: np.ndarray):
    """Index (row, col) of the last minimum of corr over ok in (col outer,
    row inner) order, or None."""
    if not ok.any():
        return None
    vals = np.where(ok, corr, np.inf)
    best = vals.min()
    hits = np.argwhere(ok & (vals == best))            # rows are (v, u)
    order = np.lexsort((hits[:, 0], hits[:, 1]))       # u outer, v inner
    return tuple(hits[order[-1]])


def _search_range(centre_int: int, half_ext: int, half: int, extent: int, b: int):
    """The reference's clamped [start, finish] of urel (or vrel)."""
    start, finish = -half_ext, half_ext
    if centre_int + start - half < 0:
        start = half - centre_int
    if centre_int + finish - half > extent - b:
        finish = extent - b - centre_int + half
    return start, finish


def elliptical_search(image, patch, centre, sinv, boxsize=11, no_sigma=3.0, corr_thresh2=0.40,
                      sigma_thresh=10.0, win_radius=None):
    """Single-feature search. Returns (found, u, v, best)."""
    B = boxsize
    half = (B - 1) // 2
    Hh, W = image.shape
    ext = _half_extents(sinv, centre, no_sigma)
    if ext is None:
        return False, 0, 0, 1e6
    halfwidth, halfheight = ext
    ucentre = int(centre[0] + 0.5)
    vcentre = int(centre[1] + 0.5)
    us, uf = _search_range(ucentre, halfwidth, half, W, B)
    vs, vf = _search_range(vcentre, halfheight, half, Hh, B)
    if win_radius is not None:
        side_u = min(2 * win_radius + 1, W - B + 1)
        side_v = min(2 * win_radius + 1, Hh - B + 1)
        u0 = min(max(math.floor(centre[0] + 0.5) - win_radius, half), W - side_u - half)
        v0 = min(max(math.floor(centre[1] + 0.5) - win_radius, half), Hh - side_v - half)
        us, uf = max(us, u0 - ucentre), min(uf, u0 + side_u - 1 - ucentre)
        vs, vf = max(vs, v0 - vcentre), min(vf, v0 + side_v - 1 - vcentre)
    if us > uf or vs > vf:
        return False, 0, 0, 1e6
    urel = np.arange(us, uf + 1, dtype=np.float64)[None, :]
    vrel = np.arange(vs, vf + 1, dtype=np.float64)[:, None]
    corr, sdp, sdi = nssd_region(image, patch, ucentre + us, ucentre + uf + 1, vcentre + vs,
                                 vcentre + vf + 1)
    ok = _ellipse(sinv, urel, vrel, no_sigma) & (corr <= 1e6)
    if sdp < sigma_thresh:
        ok &= False
    ok &= ~(sdi < sigma_thresh)
    at = _last_min(corr, ok)
    if at is None:
        return False, 0, 0, 1e6
    best = float(corr[at])
    return best <= corr_thresh2, int(ucentre + us + at[1]), int(vcentre + vs + at[0]), best


def multi_ellipse_search(image, patch, centres, sinvs, boxsize=11, no_sigma=3.0, corr_thresh2=0.40,
                         sigma_thresh=10.0, penalty=5.0, win_radius=None):
    """Particle-cloud search with the reference's shared correlation cache
    (a penalised score a cell). Returns a list of (found, u, v) an ellipse."""
    B = boxsize
    half = (B - 1) // 2
    Hh, W = image.shape
    boxes = []
    for centre, sinv in zip(centres, sinvs):
        ext = _half_extents(sinv, centre, no_sigma)
        if ext is None:
            boxes.append((0, 0, 0, -1, 0, -1))
            continue
        halfwidth, halfheight = ext
        ucentre, vcentre = int(centre[0]), int(centre[1])
        us, uf = _search_range(ucentre, halfwidth, half, W, B)
        vs, vf = _search_range(vcentre, halfheight, half, Hh, B)
        if win_radius is not None:
            side_u, side_v = min(2 * win_radius + 1, W), min(2 * win_radius + 1, Hh)
            u0 = min(max(math.trunc(centre[0]) - win_radius, 0), W - side_u)
            v0 = min(max(math.trunc(centre[1]) - win_radius, 0), Hh - side_v)
            us, uf = max(us, u0 - ucentre), min(uf, u0 + side_u - 1 - ucentre)
            vs, vf = max(vs, v0 - vcentre), min(vf, v0 + side_v - 1 - vcentre)
        boxes.append((ucentre, vcentre, us, uf, vs, vf))
    live = [bx for bx in boxes if bx[2] <= bx[3] and bx[4] <= bx[5]]
    if live:
        u_lo = min(bx[0] + bx[2] for bx in live)
        u_hi = max(bx[0] + bx[3] for bx in live) + 1
        v_lo = min(bx[1] + bx[4] for bx in live)
        v_hi = max(bx[1] + bx[5] for bx in live) + 1
        score, _sdp, sdi = nssd_region(image, patch, u_lo, u_hi, v_lo, v_hi)
        score = np.where(sdi < sigma_thresh, score + penalty, score)
    out = []
    for (ucentre, vcentre, us, uf, vs, vf), sinv in zip(boxes, sinvs):
        if us > uf or vs > vf:
            out.append((False, 0, 0))
            continue
        urel = np.arange(us, uf + 1, dtype=np.float64)[None, :]
        vrel = np.arange(vs, vf + 1, dtype=np.float64)[:, None]
        corr = score[vcentre + vs - v_lo : vcentre + vf + 1 - v_lo, ucentre + us - u_lo : ucentre + uf + 1 - u_lo]
        ok = _ellipse(sinv, urel, vrel, no_sigma) & (corr <= 1e6)
        at = _last_min(corr, ok)
        if at is None:
            out.append((False, 0, 0))
            continue
        out.append((float(corr[at]) <= corr_thresh2, int(ucentre + us + at[1]), int(vcentre + vs + at[0])))
    return out


def find_best_patch(image, boxsize, ustart, vstart, ufinish, vfinish):
    """Shi-Tomasi scan. Returns (ubest, vbest, evbest)."""
    B = boxsize
    half = (B - 1) // 2
    Hh, W = image.shape
    ustart = max(ustart, half + 1)
    ufinish = min(ufinish, W - half - 1)
    vstart = max(vstart, half + 1)
    vfinish = min(vfinish, Hh - half - 1)
    if vstart >= vfinish or ustart >= ufinish:
        return ustart, vstart, 0.0
    img = image.astype(np.float64)
    # gradients at every pixel of the patches the region's centres read
    r0, r1 = vstart - half, vfinish + half            # rows [r0, r1)
    c0, c1 = ustart - half, ufinish + half
    gx = (img[r0:r1, c0 + 1 : c1 + 1] - img[r0:r1, c0 - 1 : c1 - 1]) / 2.0
    gy = (img[r0 + 1 : r1 + 1, c0:c1] - img[r0 - 1 : r1 - 1, c0:c1]) / 2.0
    A = _box_sum(gx * gx, B)
    C = _box_sum(gy * gy, B)
    Bq = _box_sum(gx * gy, B)
    with np.errstate(invalid="ignore"):
        BB = np.sqrt((A + C) * (A + C) - 4 * (A * C - Bq * Bq))
    ev2 = (A + C - BB) / 2.0
    ev2 = np.where(np.isnan(ev2), -np.inf, ev2)
    best = ev2.max()
    if not best > 0.0:
        return ustart, vstart, 0.0
    v, u = np.argwhere(ev2 == best)[0]                 # first in (v outer, u inner) order
    return int(ustart + u), int(vstart + v), float(best)
