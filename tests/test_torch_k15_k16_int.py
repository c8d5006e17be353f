"""The premises of K15's and K16's designs, held on the CPU through Python
mirrors of the kernels' integer, ordering and sizing steps, kept here
(uc_tile, k15_tail, k15_layout, k16_cut, k16_geom, k16_walk, k16_search;
a change to the kernel's step changes its mirror here):

(a) K15's tiles (csrc/update_cluster.cuh uc_tile: 32 x 32 tiles of the
    upper triangle, row-major, CTA rank taking rank, rank + 8, ...) cover
    every upper tile once and every entry of the D x D matrix once, at
    D = 7..128;
(b) K15's tail (the keep mask, the first pass's P/2 + P'/2 with each
    column's non-finite entries counted tile by tile, and, where a count is
    not zero, the second pass with the transposition rule), mirrored in
    float32 numpy, equals joint_update_dense_plain's P_del / 2 +
    transpose_by_identity(P_del) / 2 bit for bit (NaN equal to NaN) on
    seeded matrices with NaN and inf on the diagonal, in kept and deleted
    rows, in the same tile as their mirror and in another;
(c) K15's sizing (csrc/ekf_update_dense.cu k15_layout and k15_form: the
    M x M arrays in shared memory where they fit, else in the workspace)
    fits an H100's opt-in shared memory at every D in [7, 128] and M in
    [1, 128], keeps the configurations' M in shared memory, and its
    workspace holds what the form it picks writes there;
(d) K16's walked rectangle (csrc/multi_ellipse.cu k16_geom: the window,
    the band and u < W, cut by the box only where the cut is exact, k16_cut)
    holds every cell multi_ellipse_search_plain admits, the row walk of 32
    lanes with one carry visits each of its cells once, and the mirrored
    search (the per-cell box and ellipse tests, one 64-bit key a cell, the
    NaN flag, the 1e6 of the band's other cells) gives the plain version's
    (found, u, v, overflow) bit for bit: wrapped centres (+-2^31, NaN), inf
    and NaN half-extents, centres off the frame, band edges, dead particles;
(e) K16's read box (the bounding box of every particle's rectangle, dead
    ones included) holds every admitted cell;
(f) the 64-bit key (nssd.cuh::score_key) orders the cells as the plain
    version does (the least value, -0 equal to +0, then the largest u*H +
    v) and decodes into (u, v) as its floor division and remainder do.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from scenelib2_torch.kernels import multi_ellipse
from scenelib2_torch.kernels.ekf_update import transpose_by_identity
from scenelib2_torch.kernels.multi_ellipse import _K16Params, band_shape, multi_ellipse_search_plain
from scenelib2_torch.kernels.search_bayes import MAX_CLUSTER
from tests.test_torch_k13_k14_int import cvt_rzi, f32_sqrt, key_score, score_key, wrap

F32 = np.float32
CSRC = os.path.join(os.path.dirname(multi_ellipse.__file__), "csrc")
NONE = 2**64 - 1   # the key of no admitted cell
OPTIN = 232448   # an H100's opt-in shared memory a block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
K15_STATIC = 512  # k15_kernel's static shared memory: cnt[K15_MAX] int32


def _define(fn: str, name: str) -> int:
    with open(os.path.join(CSRC, fn)) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


K15_T = _define("ekf_update_dense.cu", "K15_T")
K15_MAX = _define("ekf_update_dense.cu", "K15_MAX")
UC_THREADS = _define("update_cluster.cuh", "UC_THREADS")
UC_CLUSTER = _define("update_cluster.cuh", "UC_CLUSTER")
K16_UNROLL = _define("multi_ellipse.cu", "K16_UNROLL")
K16_EXACT = _define("multi_ellipse.cu", "K16_EXACT")
MISS = F32(1e6)


# ---------------------------------------------------------------- mirrors of K15's steps


def uc_tile(t: int, nT: int) -> tuple[int, int]:
    """update_cluster.cuh uc_tile: tile t of the upper triangle, row-major."""
    i = 0
    while t >= nT - i:
        t -= nT - i
        i += 1
    return i, i + t


def k15_tiles(D: int, T: int = K15_T) -> list[list[tuple[int, int]]]:
    """Each CTA rank's tiles (I, J) in uc_tiles' order."""
    nT = -(-D // T)
    n_tiles = nT * (nT + 1) // 2
    return [[uc_tile(t, nT) for t in range(rank, n_tiles, UC_CLUSTER)] for rank in range(UC_CLUSTER)]


def k15_tail(P_sel: np.ndarray, keep: np.ndarray, T: int = K15_T) -> tuple[np.ndarray, bool]:
    """K15's phase 3 from P_sel (the updated or prior P) and the keep flags:
    the first pass (P/2 + P'/2 with P' the transpose, each column's
    non-finite entries counted, a off the diagonal into column j, b into
    column i), then, where a count is not zero, the pass with the rule.
    Returns (P out, whether the second pass ran)."""
    D = P_sel.shape[0]
    Dp = -(-D // T) * T
    kf = np.zeros(Dp, F32)
    kf[:D] = keep.astype(F32)
    Pp = np.zeros((Dp, Dp), F32)
    Pp[:D, :D] = P_sel
    out = np.full((D, D), F32(-7.0), F32)
    cnt = np.zeros(Dp, np.int64)
    half = F32(0.5)

    def pass_(mode: int):
        for tiles in k15_tiles(D, T):
            for I, J in tiles:
                i = I * T + np.arange(T)
                j = J * T + np.arange(T)
                diag = I == J
                with np.errstate(invalid="ignore", over="ignore"):
                    k2 = kf[i][:, None] * kf[j][None, :]
                    a = Pp[np.ix_(i, j)] * k2           # [r][c]: P[i][j] masked
                    b = Pp[np.ix_(j, i)].T * k2         # [r][c]: P[j][i] masked
                    if mode == 2:
                        tb = np.where((cnt[i][:, None] - ~np.isfinite(b)) > 0, F32(np.nan), b)
                        ta = np.where((cnt[j][None, :] - ~np.isfinite(a)) > 0, F32(np.nan), a)
                        oij, oji = a * half + tb * half, b * half + ta * half
                    else:
                        oij, oji = a * half + b * half, b * half + a * half
                inside = (i[:, None] < D) & (j[None, :] < D)
                if mode == 1:
                    for r, c in zip(*np.nonzero(inside & ~np.isfinite(a))):
                        cnt[j[c]] += 1
                    if not diag:
                        for r, c in zip(*np.nonzero(inside & ~np.isfinite(b))):
                            cnt[i[r]] += 1
                for r, c in zip(*np.nonzero(inside)):
                    out[i[r], j[c]] = oij[r, c]
                    if not diag:
                        out[j[c], i[r]] = oji[r, c]

    pass_(1)
    again = bool(cnt.any())
    if again:
        pass_(2)
    return out, again


def k15_layout(D: int, M: int, form: int) -> dict:
    """ekf_update_dense.cu k15_layout: offsets and sizes (floats)."""
    Dp = -(-D // K15_T) * K15_T
    Mp = -(-M // 4) * 4
    RPC = Dp // UC_CLUSTER
    pub = 2 * M * Dp + 8 * Dp                      # update_cluster.cuh uc_pub(Dp, M).end
    Ht = -(-(RPC * (Dp + 1)) // 4) * 4
    PHn = Ht + D * Mp
    stage = PHn + Dp * Mp
    o = max(pub, stage)
    L = dict(Dp=Dp, Mp=Mp, RPC=RPC, pub=pub, Ht=Ht, PHn=PHn, stage=stage)
    L["keep"] = o
    o += Dp
    L["xu"] = o
    o += Dp
    L["nu"] = o
    o += Mp
    L["R"] = o
    o += max(M * Dp, 2 * K15_T * (K15_T + 1))
    w = pub
    L["cnt"] = w
    w += Dp
    mm = 2 * M * Mp + 3 * M * M
    L["mm"] = o if form == 0 else w
    if form == 0:
        o += mm
    else:
        w += mm
    L["n_smem"], L["n_ws"] = o, w
    return L


def k15_form(D: int, M: int) -> int:
    """k15_form: the first form whose shared memory the device allows, -1 if none."""
    for form in (0, 1):
        if 4 * k15_layout(D, M, form)["n_smem"] <= OPTIN - K15_STATIC:
            return form
    return -1


# ---------------------------------------------------------------- mirrors of K16's steps


def k16_cut(lo: int, hi: int, centre: int, half) -> tuple[int, int]:
    """multi_ellipse.cu k16_cut."""
    if hi <= lo:
        return lo, hi
    if not half >= 0:
        return lo, lo
    dlo, dhi = lo - centre, hi - 1 - centre
    if dlo < -K16_EXACT or dhi > K16_EXACT or half >= F32(K16_EXACT):
        return lo, hi
    h = int(half)
    a, b = max(lo, centre - h), min(hi, centre + h + 1)
    return a, max(a, b)


def k16_geom(hu, hv, a, b, c, k: dict):
    """multi_ellipse.cu k16_geom: (uc, vc, r0, r1, c0, c1, hw, hh)."""
    uc, vc = cvt_rzi(np.trunc(F32(hu))), cvt_rzi(np.trunc(F32(hv)))
    a, b, c, ns = F32(a), F32(b), F32(c), F32(k["no_sigma"])
    with np.errstate(all="ignore"):
        hw = np.floor(ns / f32_sqrt(a - (b * b) / c))
        hh = np.floor(ns / f32_sqrt(c - (b * b) / a))
    H, W, su, sv = k["H"], k["W"], k["side_u"], k["side_v"]
    u0 = min(max(wrap(uc - su // 2), 0), W - su)
    v0 = min(max(wrap(vc - sv // 2), 0), H - sv)
    va = min(v0 // 8 * 8, k["pad_h"] - k["band_v"])
    ua = min(u0 // 128 * 128, k["pad_w"] - 256)
    r0, r1 = max(v0, va), min(v0 + sv, va + k["band_v"])
    c0, c1 = max(u0, ua), min(u0 + su, ua + 256, W)
    c0, c1 = k16_cut(c0, c1, uc, hw)
    r0, r1 = k16_cut(r0, r1, vc, hh)
    return uc, vc, r0, r1, c0, c1, hw, hh


def k16_walk(r0, r1, c0, c1) -> np.ndarray:
    """k16_search's row walk: the cells (v, u) each lane reads for a test,
    lane l from cell l, 32 cells a step with one carry, K16_UNROLL steps an
    iteration; [n, 2]."""
    ncol = c1 - c0
    ncell = (r1 - r0) * ncol if c1 > c0 and r1 > r0 else 0
    if ncell == 0:
        return np.zeros((0, 2), np.int64)
    r = [wl // ncol for wl in range(32)]
    cc = [wl - r[wl] * ncol for wl in range(32)]
    dr, dc = 32 // ncol, 32 - (32 // ncol) * ncol
    out = []
    for e0 in range(0, ncell, K16_UNROLL * 32):
        for j in range(K16_UNROLL):
            for wl in range(32):
                if e0 + wl + 32 * j < ncell:
                    out.append((r0 + r[wl], c0 + cc[wl]))
                cc[wl] += dc
                r[wl] += dr
                if cc[wl] >= ncol:
                    cc[wl] -= ncol
                    r[wl] += 1
    return np.array(out, np.int64)


def k16_admitted(g, a, b, c, k: dict) -> np.ndarray:
    """The cells of the walked rectangle that pass the per-cell box and
    ellipse tests (bool [H, W])."""
    uc, vc, r0, r1, c0, c1, hw, hh = g
    adm = np.zeros((k["H"], k["W"]), bool)
    if not (c1 > c0 and r1 > r0):
        return adm
    vv, uu = np.meshgrid(np.arange(r0, r1), np.arange(c0, c1), indexing="ij")
    urel = np.vectorize(lambda u: F32(wrap(int(u) - uc)))(uu).astype(F32)
    vrel = np.vectorize(lambda v: F32(wrap(int(v) - vc)))(vv).astype(F32)
    a, b2, c = F32(a), F32(2.0) * F32(b), F32(c)
    ns2 = F32(k["no_sigma"] * k["no_sigma"])
    with np.errstate(all="ignore"):
        box = (np.abs(urel) <= hw) & (np.abs(vrel) <= hh)
        ell = (((a * urel) * urel + (b2 * urel) * vrel) + (c * vrel) * vrel) < ns2
    adm[r0:r1, c0:c1] = box & ell
    return adm


def k16_search(mp, g, adm, alive: bool, k: dict):
    """k16_search's result for one particle: (found, u, v, over); the
    unsigned minimum of the admitted cells' keys is order-free, so the
    lanes' partition and the warp's reduction leave the same key."""
    H = k["H"]
    key, nan = NONE, False
    for v, u in zip(*np.nonzero(adm)):
        val = mp[v, u]
        if np.isnan(val):
            nan = True
        else:
            key = min(key, score_key(val, int(u) * H + int(v)))
    best, kb = F32(np.nan), -1
    if not nan:
        best = F32(np.inf) if key == NONE else key_score(key)
        kb = -1 if key == NONE else (~key & 0xFFFFFFFF)
        if not best <= MISS:
            best, kb = MISS, -1
    hw, hh = g[6], g[7]
    over = alive and bool(hw > F32(k["side_u"] // 2) or hh > F32(k["side_v"] // 2))
    found = alive and bool(best <= F32(k["corr_thresh2"]))
    return found, (kb // H if kb >= 0 else -1), (kb % H if kb >= 0 else H - 1), over


def _consts(H, W, R, thr=0.4):
    side_u, side_v, pad_h, pad_w, band_v = band_shape(R, H, W)
    return dict(H=H, W=W, side_u=side_u, side_v=side_v, pad_h=pad_h, pad_w=pad_w, band_v=band_v, no_sigma=3.0,
                corr_thresh2=thr, R=R)


# ---------------------------------------------------------------- (a) K15's tiles


@pytest.mark.parametrize("D", list(range(7, K15_MAX + 1)))
def test_k15_tiles_cover_the_matrix_once(D):
    T = K15_T
    nT = -(-D // T)
    seen = [t for tiles in k15_tiles(D) for t in tiles]
    assert sorted(seen) == [(I, J) for I in range(nT) for J in range(I, nT)]
    cover = np.zeros((nT * T, nT * T), np.int64)
    for I, J in seen:
        cover[I * T : I * T + T, J * T : J * T + T] += 1
        if I != J:
            cover[J * T : J * T + T, I * T : I * T + T] += 1
    assert (cover == 1).all()
    assert len(seen) <= UC_CLUSTER * 2            # at most two tiles a CTA at D <= 128
    assert UcTileShape(T).rows * (UC_THREADS // 32) == T and UcTileShape(T).cols * 32 == T


class UcTileShape:
    """update_cluster.cuh UcTile<T>: RPT rows a warp's thread, CPT columns."""

    def __init__(self, T: int):
        self.rows, self.cols = T // (UC_THREADS // 32), T // 32


# ---------------------------------------------------------------- (b) K15's tail


def _tail_case(case: str, rng, D=109):
    A = rng.normal(size=(D, D))
    P = (A @ A.T / D * 1e-3 + np.eye(D) * 1e-4).astype(F32)
    P = P + rng.normal(size=(D, D)).astype(F32) * F32(1e-7)   # not symmetric: P' != P'^T
    keep = np.ones(D, bool)
    keep[103:109] = False                                     # the last slot deleted
    kept, dead = 20, 104
    place = {
        "finite": [],
        "diag_kept": [(kept, kept)],
        "kept_same_tile": [(kept, 25)],
        "kept_other_tile": [(kept, 90)],
        "kept_mirror_other_tile": [(90, kept)],
        "deleted_same_tile": [(dead, 105)],
        "deleted_other_tile": [(dead, 5)],
        "deleted_column": [(5, dead)],
        "diag_deleted": [(dead, dead)],
        "column_twice": [(kept, 60), (90, 60)],
        "pair": [(kept, 90), (90, kept)],
        "many": [(kept, 25), (90, 3), (dead, dead), (64, 64), (3, 100)],
    }[case.split(":")[0]]
    val = {"nan": np.nan, "inf": np.inf, "ninf": -np.inf}[case.split(":")[1]] if ":" in case else None
    for i, j in place:
        P[i, j] = val
    return P, keep


TAIL_CASES = ["finite"] + [f"{p}:{v}" for p in (
    "diag_kept", "kept_same_tile", "kept_other_tile", "kept_mirror_other_tile", "deleted_same_tile",
    "deleted_other_tile", "deleted_column", "diag_deleted", "column_twice", "pair", "many") for v in ("nan", "inf")]


@pytest.mark.parametrize("case", TAIL_CASES + ["many:ninf"])
def test_k15_tail_equals_transpose_by_identity(case):
    rng = np.random.default_rng(TAIL_CASES.index(case) if case in TAIL_CASES else 99)
    P, keep = _tail_case(case, rng)
    got, again = k15_tail(P, keep)
    kt = torch.tensor(keep).to(torch.float32)
    Pd = torch.tensor(P) * (kt[:, None] * kt[None, :])
    want = (Pd * 0.5 + transpose_by_identity(Pd) * 0.5).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (case, np.argwhere(~same)[:4])
    assert again == (case != "finite")     # the rule's pass runs exactly where a count is not zero
    if case != "finite" and not case.startswith("diag"):
        assert np.isnan(want).sum() > 1    # the NaN spreads along a row


@pytest.mark.parametrize("D", [7, 13, 33, 64, 65, 128])
def test_k15_tail_at_other_sizes(D):
    rng = np.random.default_rng(D)
    P = rng.normal(size=(D, D)).astype(F32)
    keep = rng.uniform(size=D) > 0.2
    P[D // 2, D - 1] = np.nan
    P[D - 1, 0] = np.inf
    P[0, 0] = -np.inf
    got, again = k15_tail(P, keep)
    kt = torch.tensor(keep).to(torch.float32)
    Pd = torch.tensor(P) * (kt[:, None] * kt[None, :])
    want = (Pd * 0.5 + transpose_by_identity(Pd) * 0.5).numpy()
    assert again
    assert ((got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))).all()


# ---------------------------------------------------------------- (c) K15's sizing


def test_k15_sizing_fits_at_every_shape():
    for D in range(7, K15_MAX + 1):
        for M in range(1, K15_MAX + 1):
            form = k15_form(D, M)
            assert form in (0, 1), (D, M)
            L = k15_layout(D, M, form)
            assert 4 * L["n_smem"] + K15_STATIC <= OPTIN, (D, M, form)
            # every array 16-byte aligned; the stage and the published arrays lie below keep
            for key in ("Ht", "PHn", "keep", "xu", "nu", "R", "cnt", "mm"):
                assert L[key] % 4 == 0, (D, M, key)
            assert L["stage"] <= L["keep"] and L["pub"] <= L["keep"]
            assert (L["Mp"] // 4) * L["RPC"] <= UC_THREADS      # P H' at a CTA's rows: one task a thread
            assert L["R"] + max(M * L["Dp"], 2 * K15_T * (K15_T + 1)) <= L["n_smem"]
            # the workspace the wrapper allocates (the form-1 size) holds this form's
            assert L["n_ws"] <= k15_layout(D, M, 1)["n_ws"]
    assert k15_form(109, 20) == 0 and k15_form(128, 32) == 0      # the configurations' M: shared memory
    assert k15_form(128, 128) == 1                                 # the five M x M arrays alone: 320 KB


def test_k15_sizes_are_the_kernels():
    """The mirror's constants and the kernel's: the tile side, the bound on
    D and M, the loads in flight and the layout's fields in order."""
    from scenelib2_torch.kernels.ekf_update import DENSE_MAX

    assert K15_MAX == DENSE_MAX == 128 and K15_T == 32
    with open(os.path.join(CSRC, "ekf_update_dense.cu")) as f:
        src = f.read()
    assert "__shared__ int cnt[K15_MAX];" in src   # K15_STATIC
    body = re.search(r"inline K15Layout k15_layout\(.*?\n\}", src, re.S).group(0)
    assert [m for m in re.findall(r"L\.(\w+) = ", body)] == [
        "Dp", "Mp", "RPC", "Ps", "Ht", "PHn", "keep", "xu", "nu", "R", "cnt", "S", "Sinv", "A", "U", "X", "n_smem",
        "n_ws"]


# ---------------------------------------------------------------- (d) K16's walk and search


def _k16_inputs(case: str, rng):
    """(maps [F, H, W], h [F, P, 2], sinv [F, P, 2, 2], alive [F, P], consts)."""
    H, W, R, P = {"band_edges": (240, 320, 110, 12), "whole": (240, 320, 115, 8),
                  "wide_640": (480, 640, 32, 10)}.get(case, (60, 80, 12, 24))
    k = _consts(H, W, R)
    F = 2
    maps = rng.uniform(0.05, 1.5, (F, H, W)).astype(F32)
    h = np.stack([rng.uniform(-8, W + 8, (F, P)), rng.uniform(-8, H + 8, (F, P))], -1).astype(F32)
    s = rng.uniform(0.5, 6.0, (F, P, 2))
    rho = rng.uniform(-0.8, 0.8, (F, P))
    S = np.zeros((F, P, 2, 2))
    S[..., 0, 0], S[..., 1, 1] = s[..., 0] ** 2, s[..., 1] ** 2
    S[..., 0, 1] = S[..., 1, 0] = rho * s[..., 0] * s[..., 1]
    sinv = np.linalg.inv(S).astype(F32)
    alive = rng.uniform(size=(F, P)) > 0.25
    if case == "wrapped":
        h[0, 0] = (2.0**31, 2.0**31)
        h[0, 1] = (-(2.0**31), -(2.0**31))
        h[0, 2] = (np.nan, 30.0)
        h[0, 3] = (40.0, np.nan)
        h[0, 4] = (2147483520.0, -2147483520.0)
        sinv[0, 4] = ((1e-12, 0.0), (0.0, 1e-12))     # half-extents near 2^21: the box wraps
        h[0, 5] = (-2147483520.0, 30.0)
        sinv[0, 5] = ((1e-30, 0.0), (0.0, 1e-30))     # half-extents near 2^31
        h[1, :] = (3e12, -3e12)
    elif case == "half_extents":
        sinv[0, 0] = ((np.inf, 0.0), (0.0, 0.04))     # sqrt(inf): half 0
        sinv[0, 1] = ((0.0, 0.0), (0.0, 0.04))        # 3 / sqrt(0): half inf (b b / c = 0)
        sinv[0, 2] = ((np.nan, 0.01), (0.01, 0.04))   # NaN half-extents
        sinv[0, 3] = ((1.0, 2.0), (2.0, 1.0))         # a - b^2 / c < 0: NaN
        sinv[0, 4] = ((0.05, 0.0), (0.0, -np.inf))    # c = -inf: NaN / 0 half
        sinv[0, 5] = ((-0.0, 0.0), (0.0, 0.04))       # 3 / sqrt(-0): -inf half
        sinv[0, 6] = ((1e-30, 0.0), (0.0, 1e-30))     # half-extents far above the window
        sinv[0, 7] = ((400.0, 0.0), (0.0, 400.0))     # half 0: the centre alone
        sinv[1, ::2] = ((1e-8, 0.0), (0.0, 1e-8))     # every window cell admitted
        maps[1, 10:20, 10:30] = MISS                  # cells at exactly 1e6: ties with the band's 1e6
        maps[1, 30, 40] = np.inf
    elif case == "off_frame":
        h[0, ::2] = np.stack([rng.uniform(-400, -20, h[0, ::2].shape[0]),
                              rng.uniform(H + 20, H + 400, h[0, ::2].shape[0])], -1)
        h[1, ::2, 0] = W + 50.0
        sinv[:, 1::3] = ((1e-5, 0.0), (0.0, 1e-5))    # wide ellipses reaching back in
    elif case == "band_edges":
        h[:, :, 0] = rng.uniform(120, 215, (F, P)).astype(F32)  # windows past the 256-column band
        h[:, :, 1] = rng.uniform(100, 140, (F, P)).astype(F32)
        sinv[:, ::2] = ((1e-5, 0.0), (0.0, 1e-5))
    elif case == "whole":
        sinv[:, ::2] = ((1e-6, 0.0), (0.0, 1e-6))
    elif case == "nan_map":
        maps[0, 20:40, 30:50] = np.nan
        maps[1, :, :] = F32(0.7)                      # ties everywhere: the largest u*H + v
    return maps, h, sinv, alive, k


K16_CASES = ("seeded", "wrapped", "half_extents", "off_frame", "band_edges", "whole", "wide_640", "nan_map")


def _plain_masks(maps, h, sinv, alive, k, monkeypatch):
    """The plain version's results and its admitted cells [F, P, H, W],
    taken from its own mask_fn (correlate.window_search, spied on)."""
    seen = {}
    real = multi_ellipse.window_search

    def spy(m, u0, v0, side_v, side_u, mask_fn):
        uu = u0[..., None, None] + torch.arange(side_u)
        vv = v0[..., None, None] + torch.arange(side_v)[:, None]
        seen["mask"], seen["uu"], seen["vv"] = mask_fn(uu, vv), uu, vv
        return real(m, u0, v0, side_v, side_u, mask_fn)

    monkeypatch.setattr(multi_ellipse, "window_search", spy)
    out = multi_ellipse_search_plain(torch.tensor(maps), torch.tensor(h), torch.tensor(sinv), torch.tensor(alive),
                                     win_radius=k["R"], no_sigma=k["no_sigma"], corr_thresh2=k["corr_thresh2"])
    F, P = alive.shape
    full = np.zeros((F, P, k["H"], k["W"]), bool)
    mask, uu, vv = seen["mask"][0].numpy(), seen["uu"][0].numpy(), seen["vv"][0].numpy()
    for f in range(F):
        for q in range(P):
            vs, us = np.nonzero(mask[f, q])
            full[f, q, vv[f, q, vs, 0], uu[f, q, 0, us]] = True
    return [o.numpy() for o in out], full


@pytest.mark.parametrize("case", K16_CASES)
def test_k16_walk_holds_exactly_the_admitted_cells(case, monkeypatch):
    rng = np.random.default_rng(300 + K16_CASES.index(case))
    maps, h, sinv, alive, k = _k16_inputs(case, rng)
    want, masks = _plain_masks(maps, h, sinv, alive, k, monkeypatch)
    F, P = alive.shape
    got = np.zeros((4, F, P), np.int64)
    for f in range(F):
        for q in range(P):
            a, b, c = sinv[f, q, 0, 0], sinv[f, q, 0, 1], sinv[f, q, 1, 1]
            g = k16_geom(h[f, q, 0], h[f, q, 1], a, b, c, k)
            adm = k16_admitted(g, a, b, c, k)
            np.testing.assert_array_equal(adm, masks[f, q], err_msg=f"{case} slot {f} particle {q}")
            _uc, _vc, r0, r1, c0, c1, _hw, _hh = g
            if c1 > c0 and r1 > r0:
                assert 0 <= r0 < r1 <= k["H"] and 0 <= c0 < c1 <= k["W"]
            got[:, f, q] = k16_search(maps[f], g, adm, bool(alive[f, q]), k)
    for name, g_, w in zip(("found", "u", "v", "over"), got, want):
        np.testing.assert_array_equal(g_, w.astype(np.int64), err_msg=f"{case}: {name}")


@pytest.mark.parametrize("case", ["seeded", "wrapped", "half_extents", "off_frame"])
def test_k16_row_walk_visits_each_cell_once(case):
    rng = np.random.default_rng(400 + K16_CASES.index(case))
    _maps, h, sinv, _alive, k = _k16_inputs(case, rng)
    for q in range(h.shape[1]):
        g = k16_geom(h[0, q, 0], h[0, q, 1], sinv[0, q, 0, 0], sinv[0, q, 0, 1], sinv[0, q, 1, 1], k)
        _uc, _vc, r0, r1, c0, c1, _hw, _hh = g
        cells = k16_walk(r0, r1, c0, c1)
        want = [(v, u) for v in range(r0, r1) for u in range(c0, c1)] if (c1 > c0 and r1 > r0) else []
        assert sorted(map(tuple, cells.tolist())) == want


def test_k16_cut_is_exact_where_it_cuts():
    """Where k16_cut narrows a range, the cells it drops fail |f32(wrap(u -
    centre))| <= half and the ones it keeps pass; elsewhere it keeps the
    range (or empties it for a NaN or negative half)."""
    cases = [(0, 320, 100, F32(7.0)), (0, 320, -5, F32(3.0)), (0, 320, 400, F32(90.0)), (5, 70, 30, F32(0.0)),
             (0, 320, 30, F32(np.inf)), (0, 320, 30, F32(np.nan)), (0, 320, 30, F32(-np.inf)),
             (0, 320, 2**31 - 1, F32(5.0)), (0, 320, -(2**31), F32(2.0**31)), (0, 320, 2**24 + 10, F32(20.0)),
             (0, 320, 30, F32(2.0**24)), (100, 100, 30, F32(5.0)), (0, 640, -(2**24) + 100, F32(300.0))]
    for lo, hi, centre, half in cases:
        a, b = k16_cut(lo, hi, centre, half)
        assert lo <= a and b <= hi
        with np.errstate(invalid="ignore"):
            passes = [u for u in range(lo, hi) if abs(F32(wrap(u - centre))) <= half]
        assert set(passes) <= set(range(a, b)), (lo, hi, centre, half)
        if (a, b) != (lo, hi) and b > a:
            assert passes == list(range(a, b))


# ---------------------------------------------------------------- (e) K16's read box


@pytest.mark.parametrize("case", K16_CASES)
def test_k16_read_box_holds_every_admitted_cell(case, monkeypatch):
    rng = np.random.default_rng(500 + K16_CASES.index(case))
    maps, h, sinv, alive, k = _k16_inputs(case, rng)
    _want, masks = _plain_masks(maps, h, sinv, alive, k, monkeypatch)
    for f in range(h.shape[0]):
        geos = [k16_geom(h[f, q, 0], h[f, q, 1], sinv[f, q, 0, 0], sinv[f, q, 0, 1], sinv[f, q, 1, 1], k)
                for q in range(h.shape[1])]
        some = [g for g in geos if g[3] > g[2] and g[5] > g[4]]    # dead particles' rectangles too
        box = np.zeros((k["H"], k["W"]), bool)
        if some:
            box[min(g[2] for g in some) : max(g[3] for g in some), min(g[4] for g in some) : max(g[5] for g in some)] = True
        assert not (masks[f].any(0) & ~box).any(), case


# ---------------------------------------------------------------- (f) the key


@pytest.mark.parametrize("H, W", [(240, 320), (480, 640), (16, 24)])
def test_k16_key_orders_and_decodes_as_the_plain_version(H, W):
    rng = np.random.default_rng(H)
    pool = np.array([0.0, -0.0, 0.25, -3.5, 1e6, np.inf, -np.inf, 2e6, 0.5], F32)
    for trial in range(300):
        # the unsigned minimum of the keys: the plain version's minimum, then
        # the largest u*H + v among the cells equal to it (-0 equal to +0)
        n = int(rng.integers(1, 12))
        vals = rng.choice(pool, n) if trial % 2 else rng.choice(pool[:4], n)
        uvs = rng.choice(W * H, n, replace=False)
        kmin = min(score_key(vals[i], int(uvs[i])) for i in range(n))
        best = vals.min()
        assert key_score(kmin) == best
        assert (~kmin & 0xFFFFFFFF) == max(int(uvs[i]) for i in range(n) if vals[i] == best), (vals, uvs)
    cells = [(0, 0), (W - 1, H - 1), (W - 1, 0), (0, H - 1)] + [
        (int(rng.integers(0, W)), int(rng.integers(0, H))) for _ in range(40)]
    for u, v in cells:
        t = torch.tensor([u * H + v], dtype=torch.int64)
        assert (int(torch.div(t, H, rounding_mode="floor")), int(torch.remainder(t, H))) == (u, v)
    t = torch.tensor([-1], dtype=torch.int64)   # no key: (-1, H - 1)
    assert (int(torch.div(t, H, rounding_mode="floor")), int(torch.remainder(t, H))) == (-1, H - 1)


def test_k16_params_struct_is_the_kernels():
    """multi_ellipse.py's parameter struct has csrc/multi_ellipse.cu's
    K16Params fields in order (the launcher writes stage)."""
    with open(os.path.join(CSRC, "multi_ellipse.cu")) as f:
        struct = re.search(r"struct K16Params \{(.*?)\};", f.read(), re.S).group(1)
    fields = re.findall(r"(\w+)[,;]", re.sub(r"//[^\n]*", "", struct))
    assert fields == [n for n, _t in _K16Params._fields_]
    assert _define("multi_ellipse.cu", "K16_MAX_CLUSTER") == MAX_CLUSTER
    assert multi_ellipse.THREADS % 32 == 0 and multi_ellipse.THREADS <= _define("multi_ellipse.cu", "K16_MAX_THREADS")
    # two CTAs of THREADS an SM at most: 4 a slot over 64 slots, 8 over 16 and fewer, on 132 SMs
    assert [multi_ellipse.ctas_a_slot(n, 132) for n in (1, 16, 33, 34, 64, 132, 1000)] == [8, 8, 8, 4, 4, 2, 1]
