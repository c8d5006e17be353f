"""NumPy oracle for the reference's image-processing semantics.

Literal-semantics (not literal-code) reimplementations of:
  - correlate2_warning       (improc/improc.cpp:55-134)
  - elliptical_search        (monoslam.cpp:401-477)
  - SearchMultipleOverlappingEllipses::search
                             (search_multiple_overlapping_ellipses.cpp:106-196)
  - find_best_patch_inside_region (monoslam.cpp:1070-1205)

Used as the ground truth the JAX kernels must match bit-for-bit (same
integer sums, same double formula, same scan orders and tie-breaks).

The port's own copy of the repository's tests/oracle_improc.py, which its
copy of the MonoSLAM oracle (eval/oracle_monoslam.py) imports.
"""

from __future__ import annotations

import math

import numpy as np


def correlate2(patch: np.ndarray, image: np.ndarray, x1: int, y1: int):
    """NSSD between the full patch and the image window with top-left (x1,y1).

    Returns (corr, sd_patch, sd_image) exactly as the reference (including
    the 0/1 special cases for zero variance).
    """
    b = patch.shape[0]
    win = image[y1 : y1 + b, x1 : x1 + b].astype(np.int64)
    p = patch.astype(np.int64)
    n = float(b * b)
    sg0 = float(p.sum())
    sg1 = float(win.sum())
    sg0g1 = float((p * win).sum())
    sg0sq = float((p * p).sum())
    sg1sq = float((win * win).sum())
    g0bar = sg0 / n
    g1bar = sg1 / n
    varg0 = sg0sq / n - g0bar * g0bar
    varg1 = sg1sq / n - g1bar * g1bar
    sd0 = math.sqrt(varg0)
    sd1 = math.sqrt(varg1)
    if sd0 == 0.0:
        return (0.0 if sd1 == 0.0 else 1.0), sd0, sd1
    if sd1 == 0.0:
        return 1.0, sd0, sd1
    k = g0bar / sd0 - g1bar / sd1
    C = (
        sg0sq / varg0
        + sg1sq / varg1
        + n * (k * k)
        - sg0g1 * 2.0 / (sd0 * sd1)
        - sg0 * 2.0 * k / sd0
        + sg1 * 2.0 * k / sd1
    )
    return C / n, sd0, sd1


def elliptical_search(image, patch, centre, sinv, boxsize=11, no_sigma=3.0,
                      corr_thresh2=0.40, sigma_thresh=10.0):
    """Reference single-feature search. Returns (found, u, v, best)."""
    B = boxsize
    half = (B - 1) // 2
    Hh, W = image.shape
    halfwidth = int(no_sigma / math.sqrt(sinv[0, 0] - sinv[0, 1] ** 2 / sinv[1, 1]))
    halfheight = int(no_sigma / math.sqrt(sinv[1, 1] - sinv[0, 1] ** 2 / sinv[0, 0]))
    ucentre = int(centre[0] + 0.5)
    vcentre = int(centre[1] + 0.5)
    urelstart, urelfinish = -halfwidth, halfwidth
    vrelstart, vrelfinish = -halfheight, halfheight
    if ucentre + urelstart - half < 0:
        urelstart = half - ucentre
    if ucentre + urelfinish - half > W - B:
        urelfinish = W - B - ucentre + half
    if vcentre + vrelstart - half < 0:
        vrelstart = half - vcentre
    if vcentre + vrelfinish - half > Hh - B:
        vrelfinish = Hh - B - vcentre + half
    corrmax = 1e6
    ub = vb = 0
    for urel in range(urelstart, urelfinish + 1):
        for vrel in range(vrelstart, vrelfinish + 1):
            if (
                sinv[0, 0] * urel * urel
                + 2 * sinv[0, 1] * urel * vrel
                + sinv[1, 1] * vrel * vrel
                < no_sigma * no_sigma
            ):
                corr, sdp, sdi = correlate2(
                    patch, image, ucentre + urel - half, vcentre + vrel - half
                )
                if corr <= corrmax:
                    if sdp < sigma_thresh or sdi < sigma_thresh:
                        pass
                    else:
                        corrmax = corr
                        ub = urel + ucentre
                        vb = vrel + vcentre
    return corrmax <= corr_thresh2, ub, vb, corrmax


def multi_ellipse_search(image, patch, centres, sinvs, boxsize=11, no_sigma=3.0,
                         corr_thresh2=0.40, sigma_thresh=10.0, penalty=5.0):
    """Reference particle-cloud search with a shared correlation cache.

    Returns lists (found, u, v) per ellipse.
    """
    B = boxsize
    half = (B - 1) // 2
    Hh, W = image.shape
    cache = np.full((Hh, W), -1.0)
    out = []
    for centre, sinv in zip(centres, sinvs):
        halfwidth = int(no_sigma / math.sqrt(sinv[0, 0] - sinv[0, 1] ** 2 / sinv[1, 1]))
        halfheight = int(no_sigma / math.sqrt(sinv[1, 1] - sinv[0, 1] ** 2 / sinv[0, 0]))
        ucentre = int(centre[0])
        vcentre = int(centre[1])
        urelstart, urelfinish = -halfwidth, halfwidth
        vrelstart, vrelfinish = -halfheight, halfheight
        if ucentre + urelstart - half < 0:
            urelstart = half - ucentre
        if ucentre + urelfinish - half > W - B:
            urelfinish = W - B - ucentre + half
        if vcentre + vrelstart - half < 0:
            vrelstart = half - vcentre
        if vcentre + vrelfinish - half > Hh - B:
            vrelfinish = Hh - B - vcentre + half
        corrmax = 1e6
        ub = vb = 0
        for urel in range(urelstart, urelfinish + 1):
            for vrel in range(vrelstart, vrelfinish + 1):
                if (
                    sinv[0, 0] * urel * urel
                    + 2 * sinv[0, 1] * urel * vrel
                    + sinv[1, 1] * vrel * vrel
                    < no_sigma * no_sigma
                ):
                    vv, uu = vcentre + vrel, ucentre + urel
                    if cache[vv, uu] != -1.0:
                        corr = cache[vv, uu]
                    else:
                        corr, sdp, sdi = correlate2(patch, image, uu - half, vv - half)
                        if sdi < sigma_thresh:
                            corr += penalty
                        cache[vv, uu] = corr
                    if corr <= corrmax:
                        corrmax = corr
                        ub, vb = uu, vv
        out.append((corrmax <= corr_thresh2, ub, vb))
    return out


def find_best_patch(image, boxsize, ustart, vstart, ufinish, vfinish):
    """Shi-Tomasi scan (monoslam.cpp:1070-1205). Returns (ubest, vbest, evbest)."""
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
    evbest = 0.0
    ubest, vbest = ustart, vstart
    for v in range(vstart, vfinish):
        for u in range(ustart, ufinish):
            gx = (img[v - half : v + half + 1, u - half + 1 : u + half + 2]
                  - img[v - half : v + half + 1, u - half - 1 : u + half]) / 2.0
            gy = (img[v - half + 1 : v + half + 2, u - half : u + half + 1]
                  - img[v - half - 1 : v + half, u - half : u + half + 1]) / 2.0
            A = float((gx * gx).sum())
            C = float((gy * gy).sum())
            Bq = float((gx * gy).sum())
            BB = math.sqrt((A + C) * (A + C) - 4 * (A * C - Bq * Bq))
            ev2 = (A + C - BB) / 2.0
            if ev2 > evbest:
                evbest = ev2
                ubest, vbest = u, v
    return ubest, vbest, evbest
