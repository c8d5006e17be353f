"""The premises of K13's and K14's designs and of the K2 / K8 / K6 staging,
held on the CPU through Python mirrors of the kernels' integer and ordering
steps, kept here (k13_geom, k13_search, chol_linv_reg, k2_passes,
k6_stages; a change to the kernel's step changes its mirror here):

(a) K13's in-kernel geometry (csrc/particle_search.cu k13_geom: trunc and
    floor converted as cvt.rzi.s32.f32 converts, NaN -> 0 and saturating,
    every sum wrapping as int32) equals particle_search.region_geometry
    exactly: seeded clouds; S^-1 with c = 0, a negative determinant, +-inf
    and NaN; centres at +-2^31 and NaN; half-extents above R;
(b) K13's search (the row walk of 32 lanes with one carry, one 64-bit key
    a cell, the NaN flag, a cell at 1e6 tying the 1e6 of the window's
    other cells, the whole-map rule, (u, v) by floor division) gives
    particle_search_plain's (found, u, v, overflow) bit for bit: ties,
    perfect matches, NaN cells, cells at and above 1e6, empty regions, dead
    particles, regions whose bounds lie 2^31 apart and a window that is
    the whole map;
(c) every cell a live particle's region holds lies in the staged read box;
(d) the register form of the warp factorisation (csrc/chol_linv.cuh
    chol_linv_reg: lane l's column, the other columns' entries by shuffle,
    row j of X right after step j), mirrored in float32 numpy, equals
    chol_inv.chol_linv bit for bit at M = 1..32 on SPD, near-singular and
    non-SPD (NaN, inf) matrices, and K3 and K14 ask for it at every M <= 32,
    the configurations' M = 2 NSEL among them;
(e) K2's passes over a CTA's centre rows (csrc/search.cu search_feature)
    and K6's stages over a CTA's band (csrc/shi_tomasi.cu) cover every row
    exactly once within the stage the launcher sizes (k2_stage, k6_stage:
    mirrors of k2_launch's and k6_shi_tomasi's sizing), at the search radii
    104, 110 and the whole frame and the regions 100, 200 and the whole
    frame, with an H100's opt-in shared memory; the configurations' windows
    take the one-pass and one-stage forms.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import pytest
import torch

from scenelib2_torch.kernels import _build, ekf_update
from scenelib2_torch.kernels import particle_search as k13
from scenelib2_torch.kernels.chol_inv import REG_MAX_M, chol_inv, chol_linv, reg_defines
from scenelib2_torch.kernels.particle_search import ParticleSearchConsts, particle_search_plain, region_geometry
from scenelib2_torch.kernels.search import SearchConsts, cluster_size
from scenelib2_torch.kernels.shi_tomasi import region_geometry as st_region

F32 = np.float32
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
MISS = F32(1e6)
CSRC = os.path.join(os.path.dirname(k13.__file__), "csrc")
OPTIN = 232448   # an H100's opt-in shared memory a block (cudaDevAttrMaxSharedMemoryPerBlockOptin)


def _define(fn: str, name: str) -> int:
    with open(os.path.join(CSRC, fn)) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


UNROLL = _define("particle_search.cu", "K13_UNROLL")
K6_CHUNK = _define("shi_tomasi.cu", "K6_CHUNK")
K6_ONE_WV = _define("shi_tomasi.cu", "K6_ONE_WV")
K6_ONE_WU = _define("shi_tomasi.cu", "K6_ONE_WU")
K6_ONE_VS = _define("shi_tomasi.cu", "K6_ONE_VS")
K2_STATIC = 152   # k2_kernel's static shared memory (pq, psum, kmin), rounded up
K6_STATIC = 160   # k6_kernel's static shared memory (red, kblock, nan_block), rounded up


# ---------------------------------------------------------------- mirrors of the kernels' steps


def f32_sqrt(x):
    """The square root of the plain version's device: PyTorch's CPU f32
    sqrt, which is not always the correctly rounded one numpy takes (the
    card's sqrtf is; there kernel and plain version both take it)."""
    return F32(torch.sqrt(torch.tensor(F32(x))).item())


def cvt_rzi(x) -> int:
    """cvt.rzi.s32.f32 (__float2int_rz): toward zero, NaN -> 0, saturating."""
    x = float(x)
    if math.isnan(x):
        return 0
    if x >= 2.0**31:
        return I32_MAX
    if x <= -(2.0**31):
        return I32_MIN
    return int(math.trunc(x))


def wrap(x: int) -> int:
    """An integer reduced to int32 with two's-complement wrap-around (the
    kernel's unsigned sums)."""
    return ((x - I32_MIN) & 0xFFFFFFFF) + I32_MIN


def k13_geom(hu, hv, a, b, c, k: ParticleSearchConsts):
    """particle_search.cu k13_geom: (uc, vc, v_lo, v_hi, u_lo, u_hi, over)."""
    R = k.win_radius
    uc, vc = cvt_rzi(np.trunc(F32(hu))), cvt_rzi(np.trunc(F32(hv)))
    a, b, c, ns = F32(a), F32(b), F32(c), F32(k.no_sigma)
    with np.errstate(all="ignore"):
        hw = cvt_rzi(np.floor(ns / f32_sqrt(a - (b * b) / c)))
        hh = cvt_rzi(np.floor(ns / f32_sqrt(c - (b * b) / a)))
    u0 = min(max(wrap(uc - R), 0), k.W - k.side_u)
    v0 = min(max(wrap(vc - R), 0), k.H - k.side_v)
    return (uc, vc, max(v0, wrap(vc - hh)), min(v0 + k.side_v, wrap(wrap(vc + hh) + 1)),
            max(u0, wrap(uc - hw)), min(u0 + k.side_u, wrap(wrap(uc + hw) + 1)), hw > R or hh > R)


def score_key(val, uv: int) -> int:
    """nssd.cuh::score_key: the order-preserving bits of val (-0 as +0) above
    the complement of uv."""
    b = int(np.array([F32(0.0) if val == 0 else F32(val)], F32).view(np.uint32)[0])
    hi = (~b & 0xFFFFFFFF) if b & 0x80000000 else (b | 0x80000000)
    return (hi << 32) | (~uv & 0xFFFFFFFF)


def key_score(key: int):
    hi = key >> 32
    b = (hi & 0x7FFFFFFF) if hi & 0x80000000 else (~hi & 0xFFFFFFFF)
    return np.array([b], np.uint32).view(F32)[0]


NONE = 2**64 - 1


def k13_search(mp, g, a, b, c, alive: bool, k: ParticleSearchConsts, visits=None):
    """particle_search.cu k13_search for one particle on map mp [H, W]:
    returns (found, u, v, over). visits, if given, counts each cell a lane
    reads for an admitted test."""
    uc, vc, v_lo, v_hi, u_lo, u_hi, over = g
    H, W = k.H, k.W
    a, b2, c = F32(a), F32(2.0) * F32(b), F32(c)
    ns2 = F32(k.no_sigma * k.no_sigma)
    some = alive and u_hi > u_lo and v_hi > v_lo   # compared: the bounds of an empty region may lie 2^31 apart
    ncol = u_hi - u_lo if some else 0
    ncell = (v_hi - v_lo) * ncol if some else 0
    assert not some or (0 <= v_lo < v_hi <= H and 0 <= u_lo < u_hi <= W)
    keys, cnt, nan = [NONE] * 32, 0, False
    if ncell > 0:
        r = [wl // ncol for wl in range(32)]
        cc = [wl - r[wl] * ncol for wl in range(32)]
        dr = 32 // ncol
        dc = 32 - dr * ncol
        for e0 in range(0, ncell, UNROLL * 32):
            for j in range(UNROLL):
                for wl in range(32):
                    inn = e0 + wl + 32 * j < ncell
                    v, u = v_lo + r[wl], u_lo + cc[wl]
                    if inn:
                        urel, vrel = F32(wrap(u - uc)), F32(wrap(v - vc))
                        with np.errstate(all="ignore"):
                            adm = ((a * urel) * urel + (b2 * urel) * vrel) + (c * vrel) * vrel < ns2
                        if visits is not None:
                            visits[v, u] += 1
                        if adm:
                            val = mp[v, u]
                            cnt += 1
                            if np.isnan(val):
                                nan = True
                            else:
                                keys[wl] = min(keys[wl], score_key(val, u * H + v))
                    cc[wl] += dc
                    r[wl] += dr
                    if cc[wl] >= ncol:
                        cc[wl] -= ncol
                        r[wl] += 1
    key = min(keys)
    best, kb = MISS, -1
    if alive and nan:
        best = F32(np.nan)
    elif alive:
        best = F32(np.inf) if key == NONE else key_score(key)
        kb = -1 if key == NONE else (~key & 0xFFFFFFFF)
        every = k.side_u == W and k.side_v == H and cnt == H * W
        if not every and not best <= MISS:
            best, kb = MISS, -1
    found = alive and bool(best <= F32(k.corr_thresh2))
    return found, (kb // H if kb >= 0 else -1), (kb % H if kb >= 0 else H - 1), alive and over


def k13_mirror(maps, h, sinv, alive, k: ParticleSearchConsts):
    """Every particle of every slot: [N, P] arrays of (found, u, v, over)."""
    N, P = alive.shape
    out = np.zeros((4, N, P), np.int64)
    for n in range(N):
        for q in range(P):
            a, b, c = sinv[n, q, 0, 0], sinv[n, q, 0, 1], sinv[n, q, 1, 1]
            g = k13_geom(h[n, q, 0], h[n, q, 1], a, b, c, k)
            out[:, n, q] = k13_search(maps[n], g, a, b, c, bool(alive[n, q]), k)
    return out


def chol_linv_reg(S):
    """chol_linv.cuh chol_linv_reg in float32 numpy: column l of the
    trailing matrix in lane l (C[:, l]), an entry of column j read from lane
    j; from step r on, C[r, l] holds U[r][l]; row j of X formed right after
    step j, from column j of U (final by then)."""
    M = S.shape[0]
    C = S.astype(F32).copy()
    X = np.zeros((M, M), F32)
    with np.errstate(all="ignore"):
        for j in range(M):
            d = C[j, j]
            inv_sqrt = F32(1.0) / f32_sqrt(d)
            q = C[j, :] / d
            for r in range(j + 1, M):
                arj = C[r, j]
                for lane in range(j + 1, M):
                    C[r, lane] = C[r, lane] - arj * q[lane]
            C[j, :] = C[j, :] * inv_sqrt
            contrib = np.zeros(M, F32)
            if j > 0:
                contrib = C[0, j] * X[0, :]
                for r in range(1, j):
                    contrib = contrib + C[r, j] * X[r, :]
            X[j, :] = ((np.arange(M) == j).astype(F32) - contrib) / C[j, j]
    return X


def k2_passes(c: SearchConsts, cs: int, words: int):
    """search_feature's centre rows over the ranks of a cluster of cs and
    their passes, for the widest rectangle (every centre of the window):
    [(rank, r0, r1, words staged)]."""
    B, su, sv = c.boxsize, c.side_u, c.side_v
    spw = -(-su // 4) + 3
    pass_rows = max(words // spw - (B - 1), 1)
    out = []
    for rank in range(cs):
        ra, rb = sv * rank // cs, sv * (rank + 1) // cs
        for r0 in range(ra, rb, pass_rows):
            r1 = min(rb, r0 + pass_rows)
            out.append((rank, r0, r1, (r1 - r0 + B - 1) * spw))
    return out


def k2_stage(c: SearchConsts, cs: int, pass_rows: int = 0):
    """k2_launch's sizing (csrc/search.cu): (the stage's words, the one-pass
    words, the form: 0 one pass within 48 KB, 1 the pass form). The stage
    holds a CTA's centre rows of the widest rectangle (pass_rows of them
    where that is fewer) and the B - 1 rows below them, ceil(side_u / 4) +
    3 words a row, at most what the device allows."""
    spw = -(-c.side_u // 4) + 3
    cta_rows = -(-c.side_v // cs)
    one_pass = (cta_rows + c.boxsize - 1) * spw
    rows = min(pass_rows, cta_rows) if pass_rows > 0 else cta_rows
    words = min((rows + c.boxsize - 1) * spw, (OPTIN - K2_STATIC) // 4)
    return words, one_pass, int(words < one_pass or K2_STATIC + 4 * words > 48 * 1024)


def k6_stage(rh: int, rw: int, B: int, cs: int, band_rows: int = 0):
    """k6_shi_tomasi's sizing (csrc/shi_tomasi.cu): (staged, the column
    sums' words a row, the window rows a stage holds). The one-stage form
    where a CTA's band window fits its static arrays; else the gradient
    columns made odd and a CTA's band and its halo (band_rows of cells where
    that is fewer), at most what the device allows."""
    off = 1 + (B - 1) // 2
    wu = rw + 2 * off
    nb = -(-rh // cs)
    band = min(band_rows, nb) if band_rows > 0 else nb
    if band == nb and nb + 2 * off <= K6_ONE_WV and wu <= K6_ONE_WU:
        return False, K6_ONE_VS, nb + 2 * off
    vs = (wu - 2) | 1
    room = (OPTIN - K6_STATIC - 4 * 3 * K6_CHUNK * vs) // wu
    return True, vs, min(band + 2 * off, room)


def k6_stages(rh: int, B: int, cs: int, rows: int):
    """k6_kernel's rows of cells over the ranks, their stages of `rows`
    window rows and their chunks: [(rank, b0, b1, c0, c1)]."""
    off = 1 + (B - 1) // 2
    nb = -(-rh // cs)
    band = rows - 2 * off
    out = []
    for rank in range(cs):
        r0 = min(rh, rank * nb)
        r1 = min(rh, r0 + nb)
        for b0 in range(r0, r1, band):
            b1 = min(r1, b0 + band)
            for c0 in range(b0, b1, K6_CHUNK):
                out.append((rank, b0, b1, c0, min(b1, c0 + K6_CHUNK)))
    return out


# ---------------------------------------------------------------- (a) the geometry


def _consts(H=60, W=80, R=12, thr=0.4):
    return ParticleSearchConsts(H=H, W=W, win_radius=R, no_sigma=3.0, corr_thresh2=thr)


def _sinv(a, b, c):
    return np.array([[a, b], [b, c]], F32)


GEOM_CASES = {
    "seeded": None,
    "c_zero": ([30.0, 20.0], _sinv(0.05, 0.01, 0.0)),
    "negative_det": ([30.0, 20.0], _sinv(1.0, 2.0, 1.0)),
    "a_inf": ([30.0, 20.0], _sinv(np.inf, 0.0, 0.04)),
    "b_inf": ([30.0, 20.0], _sinv(0.05, np.inf, 0.04)),
    "c_neg_inf": ([30.0, 20.0], _sinv(0.05, 0.0, -np.inf)),
    "sinv_nan": ([30.0, 20.0], _sinv(np.nan, 0.01, 0.04)),
    "centre_2p31": ([2.0**31, 2.0**31], _sinv(0.05, 0.01, 0.04)),
    "centre_neg_2p31": ([-(2.0**31), -(2.0**31)], _sinv(0.05, 0.01, 0.04)),
    "centre_big": ([3e12, -3e12], _sinv(1e-30, 0.0, 1e-30)),
    "centre_near_2p31": ([2147483520.0, -2147483520.0], _sinv(1e-12, 0.0, 1e-12)),
    "centre_nan": ([np.nan, 20.0], _sinv(0.05, 0.01, 0.04)),
    "over_R": ([40.0, 30.0], _sinv(1e-4, 0.0, 1e-4)),
    "huge_half": ([40.0, 30.0], _sinv(1e-30, 0.0, 1e-30)),
    "tiny_half": ([40.2, 30.7], _sinv(400.0, 0.0, 400.0)),
}


def _geom_inputs(case: str, rng):
    P = 64
    h = np.stack([rng.uniform(-20, 100, P), rng.uniform(-20, 80, P)], -1).astype(F32)
    s = rng.uniform(0.3, 12.0, (P, 2))
    rho = rng.uniform(-0.9, 0.9, P)
    S = np.zeros((P, 2, 2))
    S[:, 0, 0], S[:, 1, 1] = s[:, 0] ** 2, s[:, 1] ** 2
    S[:, 0, 1] = S[:, 1, 0] = rho * s[:, 0] * s[:, 1]
    sinv = np.linalg.inv(S).astype(F32)
    if GEOM_CASES[case] is not None:
        hc, si = GEOM_CASES[case]
        h[::3] = np.array(hc, F32)
        sinv[::3] = si
    alive = rng.uniform(size=P) > 0.2
    return h[None, None], sinv[None, None], alive[None, None]


@pytest.mark.parametrize("case", list(GEOM_CASES))
def test_geometry_mirror_equals_region_geometry(case):
    rng = np.random.default_rng(list(GEOM_CASES).index(case))
    k = _consts()
    h, sinv, alive = _geom_inputs(case, rng)
    geo, _abc, over, _u0, _v0 = region_geometry(torch.tensor(h), torch.tensor(sinv), torch.tensor(alive), k)
    geo = geo.numpy()[0, 0]
    for q in range(h.shape[2]):
        g = k13_geom(h[0, 0, q, 0], h[0, 0, q, 1], sinv[0, 0, q, 0, 0], sinv[0, 0, q, 0, 1],
                     sinv[0, 0, q, 1, 1], k)
        assert g[:6] == tuple(int(x) for x in geo[q, :6]), (case, q, g, geo[q])
        assert g[6] == bool(over[0, 0, q])


def test_conversion_saturates_and_maps_nan_to_zero():
    assert [cvt_rzi(F32(x)) for x in (np.nan, np.inf, -np.inf, 2.0**31, -(2.0**31), 2147483520.0, -7.9, 7.9)] == [
        0, I32_MAX, I32_MIN, I32_MAX, I32_MIN, 2147483520, -7, 7]
    assert wrap(I32_MAX + 1) == I32_MIN and wrap(I32_MIN - 13) == I32_MAX - 12


# ---------------------------------------------------------------- (b) the search


def _search_case(case: str, rng):
    """(maps [N, H, W], h [N, P, 2], sinv [N, P, 2, 2], alive [N, P], consts)."""
    if case == "whole":
        H, W, R, P = 16, 24, 40, 12
    else:
        H, W, R, P = 40, 56, 9, 24
    k = _consts(H, W, R)
    N = 2
    maps = rng.uniform(0.05, 1.5, (N, H, W)).astype(F32)
    h = np.stack([rng.uniform(8, W - 8, (N, P)), rng.uniform(8, H - 8, (N, P))], -1).astype(F32)
    sinv = np.tile(_sinv(0.08, 0.01, 0.06), (N, P, 1, 1))
    alive = rng.uniform(size=(N, P)) > 0.15
    if case == "ties":
        maps[:, 10:30, 10:40] = F32(0.3)
        maps[0, 15, 20] = maps[0, 17, 22] = maps[0, 19, 21] = F32(0.01)
        h[0, :, 0], h[0, :, 1] = F32(21.3), F32(17.2)
    elif case == "perfect":
        maps[:, 18:22, 26:30] = F32(0.0)
        maps[1, 19, 27] = F32(-0.0)
        h[:, :, 0], h[:, :, 1] = F32(28.4), F32(20.1)
    elif case == "nan":
        maps[0, 20, 28] = np.nan
        maps[1, 5, 5] = np.nan        # outside every region
        h[0, ::2, 0], h[0, ::2, 1] = F32(28.0), F32(20.0)
    elif case == "big":
        maps[:] = F32(2e6)
        maps[0, 20, 28] = MISS         # a cell at exactly 1e6 ties with the window's other cells
        maps[1, 10:30, 10:40] = np.inf
        h[:, ::2, 0], h[:, ::2, 1] = F32(28.0), F32(20.0)
    elif case == "empty":
        h[:, ::2, 0] = F32(-500.0)     # regions cut off the map
        alive[:, 1::4] = False
        sinv[:, 2::5] = _sinv(1.0, 2.0, 1.0)   # NaN half-extents
    elif case == "far":   # regions whose bounds lie 2^31 apart (empty), a NaN centre (trunc -> 0)
        h[0, ::3] = (-1e12, 5.0)
        h[1, ::3] = (3e9, 3e9)
        h[0, 1::3] = (np.nan, 20.0)
        h[1, 1::3] = (-(2.0**31), 2.0**31)
        sinv[:, 2::3] = _sinv(1e-30, 0.0, 1e-30)   # saturated half-extents
    elif case == "whole":
        sinv[:] = _sinv(1e-6, 0.0, 1e-6)       # every cell admitted, half-extents above R
        maps[0] = rng.uniform(1.5e6, 3e6, (H, W)).astype(F32)   # best above 1e6 keeps its key
        maps[1] = rng.uniform(0.1, 1.0, (H, W)).astype(F32)
        sinv[1, ::2] = _sinv(0.5, 0.0, 0.5)    # a few cells: the 1e6 of the rest joins
        maps[1, :, :] += F32(2e6)
    return maps, h, sinv, alive, k


SEARCH_CASES = ("seeded", "ties", "perfect", "nan", "big", "empty", "far", "whole")


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_search_mirror_equals_plain(case):
    rng = np.random.default_rng(100 + SEARCH_CASES.index(case))
    maps, h, sinv, alive, k = _search_case(case, rng)
    want = particle_search_plain(torch.tensor(maps)[None], torch.tensor(h)[None], torch.tensor(sinv)[None],
                                 torch.tensor(alive)[None], k)
    got = k13_mirror(maps, h, sinv, alive, k)
    for name, g, w in zip(("found", "u", "v", "over"), got, want):
        np.testing.assert_array_equal(g, w.numpy()[0].astype(np.int64), err_msg=f"{case}: {name}")
    if case == "whole":
        assert bool(want[3].any())
        assert (want[1].numpy()[0, 0] >= 0).any()   # keys above 1e6 kept where every cell is admitted


@pytest.mark.parametrize("case", ["seeded", "ties", "whole"])
def test_row_walk_visits_every_region_cell_once(case):
    rng = np.random.default_rng(7)
    maps, h, sinv, alive, k = _search_case(case, rng)
    for q in range(h.shape[1]):
        a, b, c = sinv[0, q, 0, 0], sinv[0, q, 0, 1], sinv[0, q, 1, 1]
        g = k13_geom(h[0, q, 0], h[0, q, 1], a, b, c, k)
        visits = np.zeros((k.H, k.W), np.int64)
        k13_search(maps[0], g, a, b, c, True, k, visits)
        want = np.zeros_like(visits)
        _uc, _vc, v_lo, v_hi, u_lo, u_hi, _o = g
        if v_hi > v_lo and u_hi > u_lo:
            want[v_lo:v_hi, u_lo:u_hi] = 1
        np.testing.assert_array_equal(visits, want)


# ---------------------------------------------------------------- (c) the read box


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_read_box_holds_every_live_region(case):
    rng = np.random.default_rng(200 + SEARCH_CASES.index(case))
    _maps, h, sinv, alive, k = _search_case(case, rng)
    for n in range(h.shape[0]):
        geos = [k13_geom(h[n, q, 0], h[n, q, 1], sinv[n, q, 0, 0], sinv[n, q, 0, 1], sinv[n, q, 1, 1], k)
                for q in range(h.shape[1])]
        live = [g for q, g in enumerate(geos) if alive[n, q] and g[3] > g[2] and g[5] > g[4]]
        if not live:
            continue
        rd = (min(g[2] for g in live), max(g[3] for g in live), min(g[4] for g in live), max(g[5] for g in live))
        assert 0 <= rd[0] < rd[1] <= k.H and 0 <= rd[2] < rd[3] <= k.W
        for g in live:
            assert rd[0] <= g[2] and g[3] <= rd[1] and rd[2] <= g[4] and g[5] <= rd[3]


# ---------------------------------------------------------------- (d) the register factorisation


def _chol_case(kind: str, M: int, rng):
    A = rng.normal(size=(M, M))
    if kind == "spd":
        return (A @ A.T / M + np.eye(M) * 0.5).astype(F32)
    if kind == "near_singular":
        v = rng.normal(size=(M, 1))
        return (v @ v.T + np.eye(M) * 1e-6).astype(F32)
    if kind == "non_spd":   # a negative last pivot: sqrt of a negative, NaN from there on
        S = (A @ A.T / M + np.eye(M) * 0.5).astype(F32)
        S[M - 1, M - 1] = F32(-5.0)
        return S
    S = (A @ A.T / M + np.eye(M)).astype(F32)   # "inf": an infinite diagonal entry
    S[M // 2, M // 2] = np.inf
    return S


@pytest.mark.parametrize("kind", ["spd", "near_singular", "non_spd", "inf"])
@pytest.mark.parametrize("M", list(range(1, 33)))
def test_register_form_equals_chol_linv(kind, M):
    rng = np.random.default_rng(M * 7 + len(kind))
    S = _chol_case(kind, M, rng)
    got = chol_linv_reg(S)
    want = chol_linv(torch.tensor(S)).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (kind, M, np.argwhere(~same)[:4])
    if kind == "non_spd":
        assert np.isnan(want).any()


def test_register_sizes_cover_the_configurations(monkeypatch):
    """K14 and K3 ask the build for the register form at their M, every M
    <= 32 (the configurations' 2 NSEL among them), and for none above; the
    header's bound on CHOL_REG_M is REG_MAX_M."""
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.synthetic import HIRES_PARAMS
    from scenelib2_torch.kernels.measure import NOUT

    with open(os.path.join(CSRC, "chol_linv.cuh")) as f:
        assert f"CHOL_REG_M <= {REG_MAX_M}" in f.read()
    for M in range(1, 129):
        assert reg_defines(M) == ((("CHOL_REG_M", M),) if M <= 32 else ())

    class Asked(Exception):
        pass

    asked = []

    def function(name, symbol, argtypes, defines=()):
        asked.append((name, defines))
        raise Asked

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    meta = dict(device="meta")
    for p in (Params(), Params(**HIRES_PARAMS), Params(n_features_to_select=16)):
        M, MF = 2 * p.n_features_to_select, p.max_features
        D = 13 + 6 * MF
        with pytest.raises(Asked):
            chol_inv(torch.empty(3, M, M, **meta))
        NS = p.n_features_to_select
        args = [torch.empty(*s_, **meta) for s_ in ((D,), (D, D), (NOUT, NS), (NS, 2), (NS,), (NS,), (MF,), (MF,),
                                                      (MF,), (MF,), (MF,), (NS,), (NS,))]
        ekf_update.workspace_floats.cache_clear()
        with pytest.raises(Asked):
            ekf_update.joint_update(*args, ekf_update.UpdateConsts.from_params(p))
        assert asked[-2:] == [("chol_inv", (("CHOL_REG_M", M),)), ("ekf_update", (("CHOL_REG_M", M),))]


# ---------------------------------------------------------------- (e) passes and stages


SEARCH_SHAPES = {"r104": (240, 320, 104), "r110": (240, 320, 110), "whole320": (240, 320, 160),
                 "r32": (240, 320, 32), "r48_640": (480, 640, 48), "whole640": (480, 640, 320)}


@pytest.mark.parametrize("shape", list(SEARCH_SHAPES))
@pytest.mark.parametrize("grid", [10, 160, 640])
@pytest.mark.parametrize("forced", [False, True])
def test_k2_passes_cover_every_row_once(shape, grid, forced):
    H, W, R = SEARCH_SHAPES[shape]
    c = SearchConsts(H=H, W=W, boxsize=11, win_radius=R, no_sigma=3.0, corr_thresh2=0.4, corr_sigma_thresh=10.0)
    cs = cluster_size(grid, 132)
    words, one_pass, form = k2_stage(c, cs, 1 if forced else 0)
    assert words >= c.boxsize * (-(-c.side_u // 4) + 3)   # k2_launch's least stage: one centre row
    rows = np.zeros(c.side_v, np.int64)
    for _rank, r0, r1, staged in k2_passes(c, cs, words):
        rows[r0:r1] += 1
        assert staged <= words
        assert r1 + c.boxsize - 1 <= c.side_v + c.boxsize - 1   # window rows read
    assert (rows == 1).all()
    n_pass = len(k2_passes(c, cs, words))
    if not forced:
        # one pass a CTA but where a CTA's rows exceed the device (R = 320 at 640x480 on one CTA)
        assert (n_pass == cs) == (one_pass * 4 <= OPTIN - K2_STATIC)
        if R <= 103 or cs == 8:
            assert form == 0 and one_pass * 4 <= 48 * 1024 - K2_STATIC   # the one-pass form
    else:
        assert form == 1
    if shape == "whole640" and cs == 1:
        assert n_pass > 1


ST_SHAPES = {"320x240": (240, 320), "640x480": (480, 640)}
ST_REGIONS = {"w100": (100, 60), "w200": (200, 150), "whole": (10**4, 10**4), "std": (80, 60)}


@pytest.mark.parametrize("shape", list(ST_SHAPES))
@pytest.mark.parametrize("region", list(ST_REGIONS))
@pytest.mark.parametrize("n_lanes", [1, 16, 64])
@pytest.mark.parametrize("forced", [None, 13])
def test_k6_stages_cover_every_row_once(shape, region, n_lanes, forced):
    from scenelib2_torch.kernels.shi_tomasi import cluster_size as st_cluster

    H, W = ST_SHAPES[shape]
    B = 11
    off, rw, rh = st_region(H, W, B, *ST_REGIONS[region])
    cs = st_cluster(n_lanes, 132)
    # forced: 13 window rows a stage, one row of cells
    staged, vs, rows = k6_stage(rh, rw, B, cs, 0 if forced is None else forced - 2 * off)
    assert rows >= 2 * off + 1 and vs % 2 == 1 and vs >= rw + 2 * off - 2
    assert staged == (forced is not None or region != "std")   # the configurations' region: one stage
    if not staged:
        assert rows <= K6_ONE_WV and rw + 2 * off <= K6_ONE_WU
    cover = np.zeros(rh, np.int64)
    for _rank, b0, b1, c0, c1 in k6_stages(rh, B, cs, rows):
        cover[c0:c1] += 1
        assert b1 - b0 + 2 * off <= rows
        assert c0 - b0 + (c1 - c0) + 2 * off <= rows   # a chunk's gradient rows lie in the stage
    assert (cover == 1).all()


def test_k2_params_struct_is_the_kernels():
    """search.py's parameter struct has csrc/search.cu's K2Params fields in
    order (the launcher reads pass_rows and writes stage_words)."""
    from scenelib2_torch.kernels.search import _K2Params

    with open(os.path.join(CSRC, "search.cu")) as f:
        struct = re.search(r"struct K2Params \{(.*?)\};", f.read(), re.S).group(1)
    fields = re.findall(r"(\w+)[,;]", re.sub(r"//[^\n]*", "", struct))
    assert fields == [n for n, _t in _K2Params._fields_]
