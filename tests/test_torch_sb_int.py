"""The premises of K4's and K11's design (csrc/search_bayes.cu, with
window_sums.cuh and bayes_tail.cuh), held on the CPU through Python mirrors
of the kernels' integer and ordering steps, kept here (int_sums, fused_tree,
row_walk, key_search; a change to one of those kernel steps changes its
mirror here):

(a) K4's int32 window and cross sums, taken in __dp4a's order over staged
    u8 words, equal score_block's float64-convolution sums exactly, and the
    scores formed from them equal score_block's bit for bit: seeded frames
    at 320x240 and 640x480, all-255 windows, flat patches, centres on the
    borders;
(b) the fused tree (register levels, shared levels down to 128 lanes, the
    last seven levels in a warp, several sums a pass) equals
    bayes.tree_sum bit for bit at widths 128 to 4,096 and every block size
    the kernels take: random values, zeros, denormals, +-inf and NaN;
(c) the row walk with no division visits every cell of a particle's box
    exactly once, and one 64-bit key a cell gives particle_search's (best,
    kbest) bit for bit: ties, perfect matches, MISS and NaN cells, empty
    boxes, NaN and +-inf half-widths;
(d) K4's band split covers every row of the read box exactly once for
    every cluster size, at heights 0, 1, odd and full, and the searches'
    interleaving every particle exactly once; the block and cluster sizes
    stay within what the kernels take;
(e) every cell that particle_search can read lies inside the read box that
    K4 scores and K11 stages (a dead particle's box outside the union box
    included), and K4's bound counts the read box's cells.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from scenelib2_torch.config import Params
from scenelib2_torch.eval.synthetic import HIRES_PARAMS
from scenelib2_torch.kernels.bayes import tree_sum, tree_width
from scenelib2_torch.kernels.particle import ROW_HH, ROW_HU, ROW_HV, ROW_HW, ROW_S00, ROW_S01, ROW_S11
from scenelib2_torch.kernels.search import nssd_corr_f32
from scenelib2_torch.kernels.search_bayes import (
    MAX_CLUSTER, MISS, SearchBayesConsts, _scan_region, band, block_threads, bytes_and_flops, cell_boxes,
    cluster_size, particle_search, read_box, score_block, search_bayes_plain, work_counts,
)
from scenelib2_torch.runtime.state import patch_row

STD = SearchBayesConsts.from_params(Params())
HIRES = SearchBayesConsts.from_params(dataclasses.replace(Params(), **HIRES_PARAMS))
SHAPES = {"320x240": STD, "640x480": HIRES}
RUN, NQ = 4, 3               # window_sums.cuh: WS_RUN centres a run, WS_NQ quads a patch row
WARP, LAST_SHARED = 32, 128  # bayes_tail.cuh tree_sums: every warp takes the last 128 lanes
BLOCKS = (128, 256, 512, 1024)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- mirrors of the kernels' steps


def int_sums(frame, pix, v0: int, v1: int, u0: int, u1: int):
    """K4's three sums (s1, s2, cross) int32 [v1 - v0, u1 - u0] at the
    centres [v0, v1) x [u0, u1) (search_bayes.cu k4_scores over
    window_sums.cuh run_sums): the window's pixel rows staged as u8 words
    from column u0 - half (0 outside the frame), for each patch row dy and
    quad t the four bytes 4t .. 4t + 3 past the centre's first column taken
    with the zero-padded patch quad (cross), with ones on the patch's
    columns (s1) and with themselves after the same mask (s2), as __dp4a
    takes them."""
    H, W = frame.shape
    B = pix.shape[0]
    half = (B - 1) // 2
    nr, ncols = v1 - v0, u1 - u0
    spw = -(-ncols // RUN) + 3
    staged = torch.zeros((nr + B - 1, 4 * spw), dtype=torch.int32)
    ys = torch.arange(v0 - half, v1 + half)
    xs = torch.arange(u0 - half, u0 - half + 4 * spw)
    iny, inx = (ys >= 0) & (ys < H), (xs >= 0) & (xs < W)
    staged[iny.nonzero()[:, 0][:, None], inx.nonzero()[:, 0][None, :]] = \
        frame.to(torch.int32)[ys[iny][:, None], xs[inx][None, :]]
    p = torch.nn.functional.pad(pix.to(torch.int32), (0, 4 * NQ - B))
    s1, s2, cross = (torch.zeros((nr, ncols), dtype=torch.int32) for _ in range(3))
    for dy in range(B):
        for t in range(NQ):
            for k in range(4):
                x = staged[dy : dy + nr, 4 * t + k : 4 * t + k + ncols]
                on = int(4 * t + k < B)
                cross += p[dy, 4 * t + k] * x
                s1 += on * x
                s2 += (on * x) * (on * x)
    return s1, s2, cross


def int_scores(frame, pix, v0, v1, u0, u1, c: SearchBayesConsts):
    """The scores K4 writes from int_sums: the penalized NSSD of the sums
    converted to f32 (exact), MISS at an invalid centre."""
    B = c.boxsize
    half = (B - 1) // 2
    s1, s2, cross = int_sums(frame, pix, v0, v1, u0, u1)
    row = patch_row(pix)
    n = torch.full((), float(B * B), dtype=torch.float32)
    corr, _sd0, sd1 = nssd_corr_f32(row[B * B], row[B * B + 1], s1.float(), s2.float(), cross.float(), n)
    corr = torch.where(sd1 < c.corr_sigma_thresh, corr + c.low_sigma_penalty, corr)
    vv = torch.arange(v0, v1)[:, None]
    uu = torch.arange(u0, u1)[None, :]
    valid = (uu >= half) & (uu <= c.W - 1 - half) & (vv >= half) & (vv <= c.H - 1 - half)
    return torch.where(valid, corr, torch.full_like(corr, MISS))


def fused_tree(vals, T: int):
    """bayes_tail.cuh tree_sums on one row of values [NP] f32 in a block of
    T threads: lane l = t + c T; levels s >= T add chunk c + s / T to chunk
    c in registers, levels min(width, T) / 2 .. 128 add in place in shared
    memory, then each warp takes levels 64 and 32 as (b[l] + b[l + 64]) +
    (b[l + 32] + b[l + 96]) and 16 .. 1 by __shfl_down_sync."""
    width = tree_width(vals.shape[0])
    lanes = torch.zeros(width, dtype=torch.float32)
    lanes[: vals.shape[0]] = vals
    if width > T:
        v = lanes.reshape(width // T, T).clone()
        h = v.shape[0] // 2
        while h >= 1:
            v[:h] = v[:h] + v[h : 2 * h]
            h //= 2
        buf = v[0].clone()
    else:
        buf = lanes.clone()
    s = buf.shape[0] // 2
    while s >= LAST_SHARED:
        buf[:s] = buf[:s] + buf[s : 2 * s]
        s //= 2
    x = (buf[0:32] + buf[64:96]) + (buf[32:64] + buf[96:128])
    for s in (16, 8, 4, 2, 1):
        down = torch.cat([x[s:], x[WARP - s :]])     # __shfl_down_sync: lanes past 31 keep their own value
        x = x + down
    return x[0]


def row_walk(ncol: int, ncell: int):
    """The cells e of a box of ncol columns that each lane of the warp
    visits: lane l starts at (r, c) = (l // ncol, l % ncol) and steps 32
    cells by (32 // ncol, 32 % ncol) with one carry, no division."""
    out = []
    if ncell <= 0:
        return out
    dr, dc = WARP // ncol, WARP % ncol
    for lane in range(WARP):
        r, c = lane // ncol, lane % ncol
        for _e in range(lane, ncell, WARP):
            out.append(r * ncol + c)
            c += dc
            r += dr
            if c >= ncol:
                c -= ncol
                r += 1
    return out


def score_key(score: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """nssd.cuh score_key: the order-preserving bits of the score (-0 as
    +0) above the complement of uv."""
    bits = (score.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    hi = np.where(bits & 0x80000000, ~bits, bits | 0x80000000).astype(np.uint64)
    return (hi << np.uint64(32)) | (~uv.astype(np.uint32)).astype(np.uint64)


def key_search(pred, g, region, scores_full, c: SearchBayesConsts):
    """K4's / K11's search of every particle over the full-frame scores
    [H, W] (search_bayes.cu search_share): its cell box walked row by row,
    the exact mask (whose bounds hold on every cell of the box), candidates
    below MISS, one unsigned minimum of 64-bit keys; returns (best [NP]
    f32, kbest [NP] f32)."""
    NP = pred.shape[1]
    r0, r1, c0, c1 = cell_boxes(g, *region)
    best = np.full(NP, MISS, np.float32)
    kbest = np.full(NP, -1.0, np.float32)
    for q in range(NP):
        ncol = int(c1[q] - c0[q])
        ncell = max(int(r1[q] - r0[q]), 0) * ncol if ncol > 0 else 0
        cells = row_walk(ncol, ncell)
        assert sorted(cells) == list(range(ncell))      # every cell of the box exactly once
        if not cells:
            continue
        e = torch.tensor(cells)
        v = r0[q] + e // ncol
        u = c0[q] + e % ncol
        vf, uf = v.float(), u.float()
        urel, vrel = uf - g["uc"][q], vf - g["vc"][q]
        a, b2, cc = pred[ROW_S00, q], 2.0 * pred[ROW_S01, q], pred[ROW_S11, q]
        quad = ((a * urel) * urel + (b2 * urel) * vrel) + (cc * vrel) * vrel
        inside = (vf >= g["vlo"][q]) & (vf < g["vhi"][q]) & (uf >= g["ulo"][q]) & (uf < g["uhi"][q])
        assert inside.all()                              # cell_box: no cell outside the bounds
        mask = inside & (quad < c.no_sigma * c.no_sigma)
        val = scores_full[v, u]
        cand = (mask & (val < MISS)).numpy()
        if not cand.any():
            continue
        keys = score_key(val.numpy()[cand], (u * c.H + v).numpy()[cand])
        m = keys.min()
        hi = np.uint32(m >> np.uint64(32))
        best[q] = np.array([hi & 0x7FFFFFFF if hi & 0x80000000 else ~hi], np.uint32).view(np.float32)[0]
        kbest[q] = np.float32(int(~np.uint32(m & np.uint64(0xFFFFFFFF))))
    return torch.from_numpy(best), torch.from_numpy(kbest)


def same_bits(a, b) -> bool:
    """Equal bit for bit, any NaN equal to any NaN."""
    a, b = a.float().contiguous(), b.float().contiguous()
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


# ---------------------------------------------------------------- (a) the integer sums


def _frame(kind: str, c: SearchBayesConsts, rng):
    if kind == "all255":
        return torch.full((c.H, c.W), 255, dtype=torch.uint8)
    return torch.tensor(rng.integers(0, 256, (c.H, c.W), dtype=np.uint8))


def _patch(kind: str, B: int, rng):
    if kind == "flat":
        return torch.full((B, B), 128, dtype=torch.uint8)
    if kind == "all255":
        return torch.full((B, B), 255, dtype=torch.uint8)
    return torch.tensor(rng.integers(0, 256, (B, B), dtype=np.uint8))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("frame_kind, patch_kind, where", [
    ("random", "random", "middle"),
    ("random", "random", "top_left"),
    ("random", "random", "bottom_right"),
    ("all255", "all255", "middle"),
    ("random", "flat", "middle"),
    ("all255", "flat", "top_left"),
])
def test_int_sums_equal_score_block(shape, frame_kind, patch_kind, where):
    c = SHAPES[shape]
    rng = np.random.default_rng(hash((shape, frame_kind, patch_kind, where)) % 2**32)
    frame = _frame(frame_kind, c, rng)
    pix = _patch(patch_kind, c.boxsize, rng)
    v0, v1, u0, u1 = {"middle": (c.H // 2 - 20, c.H // 2 + 23, c.W // 2 - 37, c.W // 2 + 2),
                      "top_left": (0, 9, 0, 13),
                      "bottom_right": (c.H - 11, c.H, c.W - 17, c.W)}[where]
    s1, s2, cross = int_sums(frame, pix, v0, v1, u0, u1)
    # the f64 convolutions' sums at the valid centres, exact integers
    B, half = c.boxsize, (c.boxsize - 1) // 2
    img = torch.nn.functional.pad(frame.double(), (half, half, half, half))[v0 : v1 + 2 * half, u0 : u1 + 2 * half]
    ones = torch.ones((1, 1, B, B), dtype=torch.float64)
    ref = [torch.nn.functional.conv2d(x[None, None], k)[0, 0] for x, k in (
        (img, ones), (img * img, ones), (img, pix.double().reshape(1, 1, B, B)))]
    vv = torch.arange(v0, v1)[:, None]
    uu = torch.arange(u0, u1)[None, :]
    valid = (uu >= half) & (uu <= c.W - 1 - half) & (vv >= half) & (vv <= c.H - 1 - half)
    assert valid.any()
    for got, want in zip((s1, s2, cross), ref):
        assert torch.equal(got[valid].double(), want[valid])
        assert torch.equal(got[valid].float(), want[valid].float())
    assert same_bits(int_scores(frame, pix, v0, v1, u0, u1, c),
                     score_block(frame, patch_row(pix), v0, v1, u0, u1, c))


# ---------------------------------------------------------------- (b) the fused tree


def _tree_values(kind: str, NP: int, rng):
    if kind == "zeros":
        v = np.zeros(NP, np.float32)
    elif kind == "denormal":
        v = (rng.integers(1, 1 << 20, NP) * np.float32(1e-45)).astype(np.float32)
        v[::3] *= -1
    else:
        v = (rng.normal(size=NP) * 10.0 ** rng.integers(-8, 8, NP)).astype(np.float32)
        if kind == "inf":
            v[rng.integers(0, NP)] = np.inf
            v[rng.integers(0, NP)] = -np.inf if NP > 1 else np.inf
        elif kind == "nan":
            v[rng.integers(0, NP)] = np.nan
    return torch.from_numpy(v)


@pytest.mark.parametrize("NP", [100, 128, 200, 256, 300, 500, 1024, 1100, 3000, 4096])
@pytest.mark.parametrize("kind", ["random", "zeros", "denormal", "inf", "nan"])
def test_fused_tree_equals_tree_sum(NP, kind):
    rng = np.random.default_rng(NP * 7 + len(kind))
    width = tree_width(NP)
    blocks = [T for T in BLOCKS if width <= 4 * T]
    assert blocks
    for _sum in range(4):        # the sums of one pass, side by side: each its own tree
        vals = _tree_values(kind, NP, rng)
        want = tree_sum(vals)
        for T in blocks:
            assert same_bits(fused_tree(vals, T), want), (NP, kind, T)


# ---------------------------------------------------------------- (c) the row walk and the key


def _particles(c: SearchBayesConsts, NP: int, rng, special: str, span=(0.3, 0.6)):
    """Prediction rows [8, NP] of particles spread along a line over the
    fraction `span` of the frame's width, with their 3-sigma half-extents,
    and the searchable flags."""
    pred = torch.zeros((8, NP), dtype=torch.float32)
    pred[ROW_HU] = torch.tensor(np.linspace(*span, NP) * c.W + rng.normal(0, 3, NP), dtype=torch.float32)
    pred[ROW_HV] = torch.tensor(np.linspace(0.4, 0.5, NP) * c.H + rng.normal(0, 3, NP), dtype=torch.float32)
    sd = rng.uniform(1.5, 6.0, (NP, 2))
    rho = rng.uniform(-0.8, 0.8, NP)
    det = (sd[:, 0] * sd[:, 1]) ** 2 * (1 - rho**2)
    a, b, cc = sd[:, 1] ** 2 / det, -rho * sd[:, 0] * sd[:, 1] / det, sd[:, 0] ** 2 / det
    pred[ROW_S00], pred[ROW_S01], pred[ROW_S11] = (torch.tensor(x, dtype=torch.float32) for x in (a, b, cc))
    pred[ROW_HW] = torch.floor(c.no_sigma / torch.sqrt(pred[ROW_S00] - pred[ROW_S01] ** 2 / pred[ROW_S11]))
    pred[ROW_HH] = torch.floor(c.no_sigma / torch.sqrt(pred[ROW_S11] - pred[ROW_S01] ** 2 / pred[ROW_S00]))
    searchable = torch.tensor(rng.uniform(size=NP) > 0.15)
    if special == "half_widths":
        pred[ROW_HW, 0], pred[ROW_HH, 1] = float("nan"), float("nan")
        pred[ROW_HW, 2], pred[ROW_HH, 2] = float("inf"), float("inf")
        pred[ROW_HW, 3] = -float("inf")
        pred[ROW_HW, 4], pred[ROW_HH, 4] = -3.0, -3.0            # an empty box
        pred[ROW_HU, 5] = float("nan")
        pred[ROW_HV, 6] = float("inf")
    return pred, searchable


def _scores(c: SearchBayesConsts, rng, kind: str):
    s = torch.tensor(rng.uniform(0.3, 2.0, (c.H, c.W)), dtype=torch.float32)
    if kind == "ties":
        s = torch.full((c.H, c.W), 0.75, dtype=torch.float32)
        s[::3] = 0.5
    elif kind == "perfect":
        s[rng.integers(0, c.H, 40), rng.integers(0, c.W, 40)] = 0.0
        s[::7, ::5] = 0.0
    elif kind == "miss":
        s[rng.uniform(size=(c.H, c.W)) < 0.5] = MISS
        s[::2, ::3] = float("inf")
        s[1::4, ::5] = 2.0e6
        s[::5, 1::3] = float("nan")
    return s


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("scores_kind, special", [
    ("random", ""), ("ties", ""), ("perfect", ""), ("miss", ""), ("random", "half_widths"),
    ("ties", "half_widths"),
])
def test_row_walk_key_search_equals_particle_search(shape, scores_kind, special):
    c = SHAPES[shape]
    rng = np.random.default_rng(hash((shape, scores_kind, special)) % 2**32)
    NP = 40
    pred, searchable = _particles(c, NP, rng, special)
    g, _over, region = _scan_region(pred, searchable, c)
    assert region[1] > region[0]
    full = _scores(c, rng, scores_kind)
    v_lo, v_hi, u_lo, u_hi = region
    want_best, want_kbest = particle_search(g, *region, full[v_lo:v_hi, u_lo:u_hi], c)
    best, kbest = key_search(pred, g, region, full, c)
    assert same_bits(best, want_best)
    assert same_bits(kbest, want_kbest)
    assert (want_kbest >= 0).any()


@pytest.mark.parametrize("ncol", [1, 2, 3, 5, 7, 16, 31, 32, 33, 64, 99, 200])
@pytest.mark.parametrize("nrow", [0, 1, 2, 13])
def test_row_walk_visits_every_cell_once(ncol, nrow):
    assert sorted(row_walk(ncol, nrow * ncol)) == list(range(nrow * ncol))


# ---------------------------------------------------------------- (d) the band split and the grid


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n_rows", [0, 1, 7, 42, 73, 240, 480])
def test_bands_cover_every_row_once(cluster, n_rows):
    rows = []
    for rank in range(cluster):
        a, b = band(n_rows, cluster, rank)
        assert 0 <= a <= b <= n_rows
        rows += range(a, b)
    assert rows == list(range(n_rows))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("warps", [4, 8, 16, 32])
@pytest.mark.parametrize("NP", [1, 100, 200, 300])
def test_searches_cover_every_particle_once(cluster, warps, NP):
    # search_bayes.cu search_share: CTA rank's warp w takes rank + cluster w, then every cluster x warps
    got = sorted(q for rank in range(cluster) for w in range(warps)
                 for q in range(rank + cluster * w, NP, cluster * warps))
    assert got == list(range(NP))


@pytest.mark.parametrize("NP", [1, 100, 128, 200, 300, 1024, 1100, 4096, 4097, 16384])
def test_block_threads_fit_the_kernel(NP):
    T = block_threads(NP)
    assert T & (T - 1) == 0 and 128 <= T <= 1024
    if NP <= 4096:
        assert tree_width(NP) <= 4 * T        # at most BT_MAX_CHUNKS particles a thread


@pytest.mark.parametrize("n_slots", [1, 2, 16, 64, 100, 1000])
def test_cluster_size_fits_the_sms(n_slots):
    cs = cluster_size(n_slots, 132)
    assert cs & (cs - 1) == 0 and 1 <= cs <= MAX_CLUSTER
    assert cs == 1 or n_slots * cs <= 132


# ---------------------------------------------------------------- (e) the read box


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("special", ["", "half_widths", "dead_outside"])
def test_every_read_cell_lies_in_the_read_box(shape, special):
    c = SHAPES[shape]
    rng = np.random.default_rng(hash((shape, special)) % 2**32)
    NP = 40
    pred, searchable = _particles(c, NP, rng, "half_widths" if special == "half_widths" else "",
                                  span=(0.3, 0.4) if special == "dead_outside" else (0.3, 0.6))
    if special == "dead_outside":
        # a dead particle 40 px right of the others: inside the region's chunks, outside the union box
        searchable[:] = True
        searchable[-1] = False
        pred[ROW_HU, -1] = pred[ROW_HU, :-1].max() + 40.0
    g, _over, region = _scan_region(pred, searchable, c)
    v0, v1, u0, u1 = read_box(g, *region)
    v_lo, v_hi, u_lo, u_hi = region
    assert v_lo <= v0 < v1 <= v_hi and u_lo <= u0 < u1 <= u_hi
    # below everything else outside the read box: a search that read there would find it
    full = torch.full((c.H, c.W), -1.0, dtype=torch.float32)
    full[v0:v1, u0:u1] = torch.tensor(rng.uniform(0.3, 2.0, (v1 - v0, u1 - u0)), dtype=torch.float32)
    best, _kbest = particle_search(g, *region, full[v_lo:v_hi, u_lo:u_hi], c)
    assert (best >= 0.0).all()
    # and every cell of every particle's box is in it
    r0, r1, c0, c1 = cell_boxes(g, *region)
    some = (r1 > r0) & (c1 > c0)
    assert ((r0[some] >= v0) & (r1[some] <= v1) & (c0[some] >= u0) & (c1[some] <= u1)).all()
    if special == "dead_outside":
        ne = searchable & (g["ulo"] < g["uhi"]) & (g["vlo"] < g["vhi"])
        assert u1 > int(g["uhi"][ne].max())     # the dead particle's box widens the read box


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bound_counts_the_read_box(shape):
    c = SHAPES[shape]
    p = Params() if shape == "320x240" else dataclasses.replace(Params(), **HIRES_PARAMS)
    rng = np.random.default_rng(3)
    MF, NP, B = 4, p.n_particles, c.boxsize
    # a slot whose ray projects inside the frame (scripts/ab_particle_kernels.py's recipe)
    q = np.array([1.0, *rng.normal(0, 0.02, 3)])
    d = 13
    M = rng.normal(size=(d, d))
    s = np.sqrt(np.r_[np.full(7, 1e-5), np.full(6, 1e-4)])
    C = s[:, None] * (np.eye(d) + 0.5 * M @ M.T / d) * s[None, :]
    h = np.array([*rng.normal(0, 0.06, 2), 1.0])
    f = dict(dtype=torch.float32)
    shared = torch.tensor(np.concatenate([rng.normal(0, 0.01, 3), q / np.linalg.norm(q), C[:7, :7].ravel()]), **f)
    slot = torch.tensor(np.concatenate([rng.normal(0, 0.1, 3), h / np.linalg.norm(h), C[:7, 7:].ravel(),
                                        C[7:, 7:].ravel()]), **f)
    frame = torch.tensor(rng.integers(0, 256, (c.H, c.W), dtype=np.uint8))
    args = (frame, torch.full((MF, NP), 1.0 / NP, **f), torch.tensor(np.tile(np.linspace(0.5, 5.0, NP), (MF, 1)), **f),
            torch.tensor(rng.uniform(size=(MF, NP)) > 0.1), torch.tensor([True]), torch.tensor([True]),
            torch.tensor([3], dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
            patch_row(frame[100 : 100 + B, 150 : 150 + B]), shared, slot, c)
    n_rows, n_cols, n_searched = work_counts(*args)
    # the read box of the same call, from its own steps
    out = search_bayes_plain(*args)
    from scenelib2_torch.kernels.search_bayes import _predict_and_scan
    _rows, _pred, _s, g, _o, region = _predict_and_scan(frame, args[1], args[2], args[3], args[4], args[7],
                                                        shared, slot, c)
    v0, v1, u0, u1 = read_box(g, *region)
    assert (n_rows, n_cols) == (v1 - v0, u1 - u0) and n_rows * n_cols > 0
    assert n_rows * n_cols <= (region[1] - region[0]) * (region[3] - region[2])
    nb, fl = bytes_and_flops(MF, NP, c.H, c.W, B, n_rows, n_cols, n_searched)
    nb0, fl0 = bytes_and_flops(MF, NP, c.H, c.W, B, 0, 0, n_searched)
    from scenelib2_torch.kernels.search import nssd_cell_ops
    assert fl - fl0 == n_rows * n_cols * nssd_cell_ops(B)
    assert nb - nb0 == min(c.H * c.W, (n_rows + B - 1) * (n_cols + B - 1))
    assert math.isfinite(float(out[2][0]))
