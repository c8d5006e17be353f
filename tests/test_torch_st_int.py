"""The premises of K6's design (csrc/shi_tomasi.cu), held on the CPU through
Python mirrors of the kernel's steps, kept here (band_window, column_sums,
row_keys, merge_keys, pick; a change to shi_tomasi.cu's steps changes its
mirror here):

(a) the running 11-row sums of a band's gradient products and the running
    11-column sums of those, in int32, taken in the kernel's runs of rows
    and columns and its passes of K6_CHUNK rows, with the region's rows
    split into bands over a cluster of 1-8 CTAs, give the twin's pick
    bit for bit: random frames under hypothesis, flat frames (eigenvalue 0:
    no pick), a periodic texture whose maxima tie (the smallest scan key
    wins), regions clamped at each border and masks that exclude cells, at
    320x240 and 640x480;
(b) the 64-bit key (the eigenvalue's bits when it is > 0, then
    0xFFFFFFFF - (v W + u)), its maximum and the NaN flag decide as the
    twin's maximum and tie key on synthetic eigenvalue planes with NaN,
    +-0, -inf and only non-positive values;
(c) every sum stays below 2^23, so int32 holds it and the f32 conversion
    is exact;
(d) the parameter struct is the kernel's, the launcher's stage and
    column-sum sizes (stage_sizes, its mirror) hold any region up to the
    whole frame (a CTA's band staged in turns where it does not fit, the
    configurations' region in the one-stage form), and the cluster rule;
and the plain version against the TPU kernel at 640x480 (interpret mode).
"""

from __future__ import annotations

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from scenelib2_tpu.kernels.pallas_shi_tomasi import pallas_shi_tomasi_region
from scenelib2_torch.config import Params
from scenelib2_torch.kernels import shi_tomasi as k6
from scenelib2_torch.kernels.shi_tomasi import (
    INT_MAX, bytes_and_flops, clamp_region, cluster_size, region_geometry, shi_tomasi_plain,
    window_origin,
)

P_STD = Params()
B = P_STD.boxsize
RW, RH = P_STD.init_search_width, P_STD.init_search_height
SHAPES = {"320x240": (240, 320), "640x480": (480, 640)}
EV_RTOL = 1e-5    # against the TPU kernel: XLA's CPU f32 sqrt may be an ulp off
CU = os.path.join(os.path.dirname(k6.__file__), "csrc", "shi_tomasi.cu")


def _cu_define(name: str) -> int:
    with open(CU) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


THREADS, CHUNK, MAX_CLUSTER = _cu_define("K6_THREADS"), _cu_define("K6_CHUNK"), _cu_define("K6_MAX_CLUSTER")
ONE_WV, ONE_WU, ONE_VS = _cu_define("K6_ONE_WV"), _cu_define("K6_ONE_WU"), _cu_define("K6_ONE_VS")


def stage_sizes(rh: int, rw: int, cs: int):
    """k6_shi_tomasi's sizes (csrc/shi_tomasi.cu) with nothing forced and
    no device limit: (staged, words a row of the column sums, window rows a
    stage). The one-stage form's where a CTA's band window fits its static
    arrays, else the gradient columns made odd and a CTA's band and its
    halo."""
    off = 1 + (B - 1) // 2
    nb = -(-rh // cs)
    if nb + 2 * off <= ONE_WV and rw + 2 * off <= ONE_WU:
        return False, ONE_VS, nb + 2 * off
    return True, (rw + 2 * off - 2) | 1, nb + 2 * off


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- mirrors of the kernel's steps


def band_window(frame, u0: int, v0: int, off: int, rw: int, r0: int, r1: int):
    """The band's staged u8 rows: cells [r0, r1) read window rows [r0, r1 + 2 off)."""
    top = v0 - off + r0
    return frame[top : top + (r1 - r0) + 2 * off, u0 - off : u0 - off + rw + 2 * off].astype(np.int32)


def _products(win, g: int):
    """(gx2^2, gy2^2, gx2 gy2) along gradient row g of the staged window (int32)."""
    gx = win[g + 1, 2:] - win[g + 1, :-2]
    gy = win[g + 2, 1:-1] - win[g, 1:-1]
    return np.stack([gx * gx, gy * gy, gx * gy])


def column_sums(win, g0: int, nr: int):
    """The kernel's 11-row pass over one chunk: a thread a gradient column
    and a run of lv rows, a running sum down the run. [3, nr, gu] int32."""
    gu = win.shape[1] - 2
    runs = max(1, THREADS // gu)
    lv = -(-nr // runs)
    V = np.zeros((3, nr, gu), np.int32)
    for run in range(runs):
        rs, re_ = run * lv, min(nr, run * lv + lv)
        if rs >= re_:
            continue
        s = sum(_products(win, g0 + rs + dy) for dy in range(B))
        V[:, rs] = s
        for r in range(rs + 1, re_):
            s = s + _products(win, g0 + r + B - 1) - _products(win, g0 + r - 1)
            V[:, r] = s
    return V


def eigen(sxx, syy, sxy):
    """The twin's f32 operations on the int sums (numpy f32: one rounding an operation)."""
    f = np.float32
    A, C, Bq = sxx.astype(f) * f(0.25), syy.astype(f) * f(0.25), sxy.astype(f) * f(0.25)
    with np.errstate(invalid="ignore"):
        BB = np.sqrt((A + C) * (A + C) - f(4.0) * (A * C - Bq * Bq))
    return (A + C - BB) / f(2.0)


def cell_keys(ev, mask, uu, vv, W: int):
    """Each cell's 64-bit key (0 where not admitted or not > 0) and the NaN flag."""
    pos = mask & (ev > 0)
    hi = np.where(pos, ev.astype(np.float32).view(np.uint32), np.uint32(0)).astype(np.uint64)
    lo = (np.uint64(0xFFFFFFFF) - (vv.astype(np.int64) * W + uu).astype(np.uint64)).astype(np.uint64)
    keys = np.where(pos, (hi << np.uint64(32)) | lo, np.uint64(0))
    return keys, bool((mask & np.isnan(ev)).any())


def row_keys(V, c0: int, u0: int, v0: int, bounds, H: int, W: int, rw: int):
    """The kernel's 11-column pass over one chunk: a thread a row of cells
    and a run of lh columns, a running sum along the run; returns the
    chunk's largest key and NaN flag, and the sums (for the 2^23 check)."""
    nr = V.shape[1]
    off = 1 + (B - 1) // 2
    runs = max(1, THREADS // nr)
    lh = -(-rw // runs)
    S = np.zeros((3, nr, rw), np.int32)
    for run in range(runs):
        js, je = run * lh, min(rw, run * lh + lh)
        if js >= je:
            continue
        s = V[:, :, js : js + B].sum(axis=2, dtype=np.int32)
        S[:, :, js] = s
        for jj in range(js + 1, je):
            s = s + V[:, :, jj + B - 1] - V[:, :, jj - 1]
            S[:, :, jj] = s
    uu = u0 + np.arange(rw)[None, :]
    vv = v0 + c0 + np.arange(nr)[:, None]
    us, vs, uf, vf = (np.float32(b) for b in bounds)
    uuf, vvf = uu.astype(np.float32), vv.astype(np.float32)
    mask = ((uuf >= us) & (uuf < uf) & (vvf >= vs) & (vvf < vf) & (uu >= off) & (uu <= W - 1 - off)
            & (vv >= off) & (vv <= H - 1 - off))
    keys, nan = cell_keys(eigen(*S), mask, uu, vv, W)
    return keys.max(initial=np.uint64(0)), nan, S


def band_key(frame, bounds, cs: int, rank: int, region_w: int = RW, region_h: int = RH, rows=None):
    """One CTA of a cluster of cs: its band, staged in turns of `rows`
    window rows (by default stage_sizes': the whole band), its chunks, its
    key and flag."""
    H, W = frame.shape
    off, rw, rh = region_geometry(H, W, B, region_w, region_h)
    u0, v0 = (int(t) for t in window_origin(torch.tensor(int(bounds[0])), torch.tensor(int(bounds[1])),
                                            H, W, B, region_w, region_h))
    nb = -(-rh // cs)
    r0 = min(rh, rank * nb)
    r1 = min(rh, r0 + nb)
    band = (stage_sizes(rh, rw, cs)[2] if rows is None else rows) - 2 * off
    key, nan, top = np.uint64(0), False, 0
    for b0 in range(r0, r1, band):
        b1 = min(r1, b0 + band)
        win = band_window(frame, u0, v0, off, rw, b0, b1)
        for c0 in range(b0, b1, CHUNK):
            nr = min(CHUNK, b1 - c0)
            V = column_sums(win, c0 - b0, nr)
            k, n, S = row_keys(V, c0, u0, v0, bounds, H, W, rw)
            key, nan = max(key, k), nan or n
            top = max(top, int(np.abs(V).max()), int(np.abs(S).max()))
    return key, nan, top


def merge_keys(parts):
    """Rank 0's merge over the cluster: the largest key, any NaN flag."""
    return max(k for k, _n in parts), any(n for _k, n in parts)


def pick(key, nan: bool, ustart: int, vstart: int, W: int):
    """Rank 0's output from the merged key."""
    hi = int(key) >> 32
    if nan or hi == 0:
        return ustart, vstart, np.float32(0.0)
    k = 0xFFFFFFFF - (int(key) & 0xFFFFFFFF)
    return k % W, k // W, np.array([hi], np.uint32).view(np.float32)[0]


def kernel_mirror(frame, bounds, cs: int, region_w: int = RW, region_h: int = RH, rows=None):
    parts = [band_key(frame, bounds, cs, r, region_w, region_h, rows) for r in range(cs)]
    key, nan = merge_keys([(k, n) for k, n, _t in parts])
    return pick(key, nan, int(bounds[0]), int(bounds[1]), frame.shape[1]), max(t for _k, _n, t in parts)


def twin_select(ev, mask, uu, vv, ustart: int, vstart: int, W: int):
    """The selection lines of shi_tomasi_plain, on a given eigenvalue plane
    (test_twin_select_is_the_twins ties this copy to the twin)."""
    vals = torch.where(mask, ev, torch.full_like(ev, -torch.inf)).flatten()
    best = vals.amax()
    key = (vv * W + uu).flatten()
    tie = (vals == best) & mask.flatten()
    kbest = torch.where(tie, key, torch.full_like(key, INT_MAX)).amin()
    found = best > 0.0
    return (int(torch.where(found, kbest % W, torch.tensor(ustart))),
            int(torch.where(found, kbest // W, torch.tensor(vstart))),
            np.float32(torch.where(found, best, torch.zeros_like(best))))


# ---------------------------------------------------------------- scenes


def _bounds(u, v, uf, vf, H, W):
    return tuple(int(t) for t in clamp_region(*(torch.tensor(x, dtype=torch.int32) for x in (u, v, uf, vf)),
                                              W, H, B))


def _frame(kind: str, seed: int, H: int, W: int):
    g = np.random.default_rng(seed)
    if kind == "flat":
        return np.full((H, W), 117, np.uint8)
    if kind == "periodic":
        tile = g.integers(0, 256, (7, 9), dtype=np.uint8)
        return np.tile(tile, (H // 7 + 1, W // 9 + 1))[:H, :W].copy()
    if kind == "smooth":
        f = g.uniform(0, 255, (H // 4 + 1, W // 4 + 1))
        return np.kron(f, np.ones((4, 4)))[:H, :W].astype(np.uint8)
    return g.integers(0, 256, (H, W), dtype=np.uint8)


def _twin(frame, bounds):
    ub, vb, ev = shi_tomasi_plain(torch.tensor(frame), *(torch.tensor(b, dtype=torch.int32) for b in bounds),
                                  boxsize=B, region_w=RW, region_h=RH)
    return int(ub), int(vb), np.float32(ev)


def _same_pick(got, want):
    assert got[:2] == want[:2], (got, want)
    assert np.array([got[2]], np.float32).view(np.uint32)[0] == np.array([want[2]], np.float32).view(np.uint32)[0]


# ---------------------------------------------------------------- (a) sums, bands, chunks


@pytest.mark.parametrize("shape", list(SHAPES))
@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2**31 - 1), kind=st.sampled_from(["noise", "smooth", "periodic"]),
       cs=st.integers(1, 8), u=st.integers(-20, 700), v=st.integers(-20, 520),
       w=st.integers(1, 120), h=st.integers(1, 90))
def test_mirror_equals_twin(shape, seed, kind, cs, u, v, w, h):
    H, W = SHAPES[shape]
    frame = _frame(kind, seed, H, W)
    bounds = _bounds(u % W, v % H, u % W + w, v % H + h, H, W)
    got, top = kernel_mirror(frame, bounds, cs)
    _same_pick(got, _twin(frame, bounds))
    assert top < 2**23


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("scene", ["flat", "periodic_tie", "left", "right", "top", "bottom", "corner",
                                   "excluded", "two_blobs"])
def test_mirror_scenes(shape, scene):
    H, W = SHAPES[shape]
    kind = {"flat": "flat", "periodic_tie": "periodic"}.get(scene, "noise")
    frame = _frame(kind, 5, H, W)
    u, v = W // 3, H // 3
    at = {"left": (0, v), "right": (W - 30, v), "top": (u, 0), "bottom": (u, H - 20), "corner": (W - 3, H - 3)}
    if scene in at:
        u, v = at[scene]
    uf, vf = u + RW, v + RH
    if scene == "excluded":    # a region narrower than the window: its cells outside the bounds are masked
        uf, vf = u + 23, v + 17
    if scene == "two_blobs":   # two equal blobs on the same rows: the left one (smaller scan key) wins
        frame = np.full((H, W), 100, np.uint8)
        blob = np.random.default_rng(3).integers(0, 256, (15, 15), dtype=np.uint8)
        frame[v + 20 : v + 35, u + 10 : u + 25] = blob
        frame[v + 20 : v + 35, u + 45 : u + 60] = blob
    bounds = _bounds(u, v, uf, vf, H, W)
    want = _twin(frame, bounds)
    for cs in (1, 2, 3, 4, 8):
        _same_pick(kernel_mirror(frame, bounds, cs)[0], want)
    if scene == "flat":
        assert want == (bounds[0], bounds[1], 0.0)
    if scene == "periodic_tie":
        # the maximum recurs every period: the pick is the first in scan order
        assert want[2] > 0
    if scene == "two_blobs":
        assert want[0] < u + 35 and want[2] > 0


WIDE_REGIONS = {"w100": (100, 60), "w200": (200, 150), "whole": (10**4, 10**4)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("region", list(WIDE_REGIONS))
@pytest.mark.parametrize("rows", [None, 13, 40])
def test_mirror_wide_regions_in_stages(shape, region, rows):
    """Regions past the old 88 x 68 cap (init_search_width 100 and 200, the
    whole frame after the clamp: 308 x 228 and 628 x 468), a CTA's band
    staged whole or in turns of 13 and 40 window rows (one and 28 rows of
    cells), the gradient columns past the 512 threads taken in turn: the
    twin's pick bit for bit."""
    H, W = SHAPES[shape]
    rw_, rh_ = WIDE_REGIONS[region]
    _off, rw, rh = region_geometry(H, W, B, rw_, rh_)
    frame = _frame("noise", 11, H, W)
    for u, v in ((0, 0), (W // 5, H // 6)):
        bounds = _bounds(u, v, u + rw_, v + rh_, H, W)
        ub, vb, ev = shi_tomasi_plain(torch.tensor(frame), *(torch.tensor(b, dtype=torch.int32) for b in bounds),
                                      boxsize=B, region_w=rw_, region_h=rh_)
        for cs in (1, 8):
            got, top = kernel_mirror(frame, bounds, cs, rw_, rh_, rows)
            _same_pick(got, (int(ub), int(vb), np.float32(ev)))
            assert top < 2**23
    if region == "whole":
        assert (rw, rh) == (W - 12, H - 12)


# ---------------------------------------------------------------- (b) keys on synthetic planes


def _plane(kind: str, seed: int, rh: int = 12, rw: int = 16):
    g = np.random.default_rng(seed)
    ev = g.normal(0, 10, (rh, rw)).astype(np.float32)
    if kind == "nan":
        ev[g.integers(rh), g.integers(rw)] = np.nan
    elif kind == "zeros":
        ev[:] = np.where(g.uniform(size=ev.shape) < 0.5, np.float32(0.0), np.float32(-0.0))
    elif kind == "neg_inf":
        ev[:] = -np.inf
        ev[2, 3] = np.float32(-1.0)
    elif kind == "non_positive":
        ev = -np.abs(ev)
        ev[1, 1] = np.float32(-0.0)
    elif kind == "ties":
        ev = np.round(ev / 8).astype(np.float32) * 8
        ev[g.integers(rh), g.integers(rw)] = ev.max()
    elif kind == "tiny":
        ev[:] = np.float32(1e-45) * g.integers(0, 3, ev.shape)    # denormals and 0
    return ev


@pytest.mark.parametrize("kind", ["random", "nan", "zeros", "neg_inf", "non_positive", "ties", "tiny"])
@pytest.mark.parametrize("masked", [False, True])
def test_key_select_equals_twin_select(kind, masked):
    W = 320
    for seed in range(6):
        ev = _plane(kind, seed)
        rh, rw = ev.shape
        g = np.random.default_rng(100 + seed)
        mask = g.uniform(size=ev.shape) < 0.6 if masked else np.ones(ev.shape, bool)
        if kind == "nan" and masked:
            mask[np.isnan(ev)] = seed % 2 == 0    # a NaN outside the mask does not void the pick
        uu = 40 + np.arange(rw)[None, :] + np.zeros((rh, 1), np.int64)
        vv = 30 + np.arange(rh)[:, None] + np.zeros((1, rw), np.int64)
        keys, nan = cell_keys(ev, mask, uu, vv, W)
        # split into bands as a cluster would, then merge
        parts = [(keys[r : r + 3].max(initial=np.uint64(0)), False) for r in range(0, rh, 3)] + [(np.uint64(0), nan)]
        got = pick(*merge_keys(parts), 41, 31, W)
        want = twin_select(torch.tensor(ev), torch.tensor(mask), torch.tensor(uu, dtype=torch.int32),
                           torch.tensor(vv, dtype=torch.int32), 41, 31, W)
        _same_pick(got, want)
        if kind in ("zeros", "neg_inf", "non_positive"):
            assert got == (41, 31, 0.0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_twin_select_is_the_twins(shape):
    """twin_select on the mirror's eigenvalue plane gives shi_tomasi_plain's pick."""
    H, W = SHAPES[shape]
    for seed, kind in enumerate(["noise", "smooth", "periodic", "flat"]):
        frame = _frame(kind, seed, H, W)
        bounds = _bounds(W // 4, H // 5, W // 4 + RW, H // 5 + RH, H, W)
        off, rw, rh = region_geometry(H, W, B, RW, RH)
        u0, v0 = (int(t) for t in window_origin(torch.tensor(bounds[0]), torch.tensor(bounds[1]), H, W, B, RW, RH))
        win = band_window(frame, u0, v0, off, rw, 0, rh)
        V = column_sums(win, 0, rh)
        S = np.stack([sum(V[k][:, dx : dx + rw] for dx in range(B)) for k in range(3)])
        ev = eigen(*S)
        uu = u0 + np.arange(rw)[None, :] + np.zeros((rh, 1), np.int64)
        vv = v0 + np.arange(rh)[:, None] + np.zeros((1, rw), np.int64)
        us, vs, uf, vf = bounds
        mask = (uu >= us) & (uu < uf) & (vv >= vs) & (vv < vf)
        got = twin_select(torch.tensor(ev), torch.tensor(mask), torch.tensor(uu, dtype=torch.int32),
                          torch.tensor(vv, dtype=torch.int32), us, vs, W)
        _same_pick(got, _twin(frame, bounds))


# ---------------------------------------------------------------- (c), (d)


def test_sums_fit_int32_and_f32():
    """The largest sum a cell can take (all gradients +-255): below 2^23."""
    assert B * B * 255 * 255 < 2**23
    H, W = SHAPES["320x240"]
    # 2 x 2 checks: every doubled difference is +-255
    frame = ((np.arange(H)[:, None] // 2 + np.arange(W)[None, :] // 2) % 2 * 255).astype(np.uint8)
    _got, top = kernel_mirror(frame, _bounds(100, 80, 180, 140, H, W), 1)
    assert top < 2**23


def test_wrapper_limits_are_the_kernels():
    """The wrapper's parameters are the kernel's: the kernel's parameter
    struct has the wrapper's fields in order; the launcher's column sums
    hold every gradient column at an odd stride and its stage a CTA's band
    and its halo, for regions up to the whole frame; the configurations'
    region takes the one-stage form at every cluster size."""
    assert k6.MAX_CLUSTER == MAX_CLUSTER
    with open(CU) as f:
        src = f.read()
    struct = re.search(r"struct K6Params \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)[,;]", re.sub(r"//[^\n]*", "", struct))
    assert fields == [n for n, _t in k6._K6Params._fields_]
    assert "K6_MAX_WU" not in src and "K6_MAX_WV" not in src
    assert ONE_VS % 2 == 1 and ONE_VS >= ONE_WU - 2
    off = 1 + (B - 1) // 2
    for H, W in SHAPES.values():
        for region in ((RW, RH), (100, 60), (200, 150), (W, H)):
            _off, rw, rh = region_geometry(H, W, B, *region)
            assert 0 < rw <= W - 2 * off and 0 < rh <= H - 2 * off
            for cs in (1, 2, 4, 8):
                staged, vs, rows = stage_sizes(rh, rw, cs)
                assert vs % 2 == 1 and vs >= rw + 2 * off - 2
                assert rows == -(-rh // cs) + 2 * off
                assert staged == (region != (RW, RH))


def test_cluster_rule():
    for n_lanes in (1, 2, 16, 64, 65, 132, 500):
        cs = cluster_size(n_lanes, 132)
        cap = MAX_CLUSTER if n_lanes == 1 else MAX_CLUSTER // 2
        assert 1 <= cs <= cap and cs & (cs - 1) == 0
        assert n_lanes * cs <= 132 or cs == 1
        assert cs == cap or 2 * cs * n_lanes > 132
    assert (cluster_size(1, 132), cluster_size(16, 132), cluster_size(64, 132)) == (8, 4, 2)


def test_bound_counts_running_sums():
    """The bound's operations: the running sums' adds, fewer than the
    direct separable sums' 2(B - 1) a cell and product."""
    _n, ops = bytes_and_flops(B, RW, RH)
    g = (RH + B - 1) * (RW + B - 1)
    assert ops < 5 * g + 3 * 2 * (B - 1) * RW * RH + 12 * RW * RH
    assert ops >= 5 * g + 3 * 2 * RW * RH + 12 * RW * RH


# ---------------------------------------------------------------- the plain version against the TPU kernel


@pytest.mark.parametrize("case", ["noise", "smooth", "periodic", "flat", "corner"])
def test_plain_matches_pallas_640x480(case):
    H, W = SHAPES["640x480"]
    frame = _frame(case if case != "corner" else "noise", 9, H, W)
    u, v = (W - 40, H - 25) if case == "corner" else (300, 200)
    bounds = _bounds(u, v, u + RW, v + RH, H, W)
    ub, vb, ev = pallas_shi_tomasi_region(jnp.asarray(frame), *(jnp.int32(b) for b in bounds), boxsize=B,
                                          image_shape=(H, W), region_w=RW, region_h=RH, interpret=True)
    got = _twin(frame, bounds)
    assert got[:2] == (int(ub), int(vb)), case
    assert abs(float(got[2]) - float(ev)) <= EV_RTOL * max(abs(float(ev)), 1.0)
    if case == "flat":
        assert float(ev) == 0.0
    else:
        assert math.isfinite(float(ev)) and float(ev) > 0
