"""The premises of K2's and K8's design (csrc/search.cu), held on the CPU
through Python mirrors of the kernel's integer steps, kept here (box_rect,
int_window_sums, key_select, centre_i32; a change to search.cu's steps
changes its mirror here):

(a) the rectangle the kernel scores covers every cell that
    candidate_geometry admits, and lies inside the window and the valid
    centres: S^-1 near singular, NaN and infinite half-widths, centres on
    and past the frame's borders, garbage centres (NaN, +-inf, +-3e9, as K2
    and K8 convert them), at 320x240 and 640x480;
(b) the single pass over 64-bit keys gives _select_plain's (best, u, v),
    best bit for bit: noise, a periodic image whose scores tie, perfect
    matches (best a rounding residue near 0, ties of them), an all-255
    window;
(c) the int32 sums in __dp4a's order equal the twins' f32 sums exactly;
(d) K8's in-kernel centre conversion equals window_centre (XLA's int32
    conversion) on NaN, +-inf, +-3e9, -0.5, 0.5 and random values;
(e) the bound counts the window pixels under the admitted cells, within
    the rectangle;
(f) patch_row writes u8-valued pixels, which K2 packs by truncation.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from scenelib2_torch.config import Params
from scenelib2_torch.kernels.search import (
    NO_MATCH, SearchConsts, _select_plain, bytes_and_flops, bytes_and_flops_windows, candidate_geometry,
    cluster_size, half_widths, nssd_cell_ops, patch_sums, read_pixels, score_cells, search_window_origin,
    window_centre, window_sums,
)
from scenelib2_torch.runtime.state import patch_row

STD = SearchConsts.from_params(Params())
HIRES = dataclasses.replace(STD, H=480, W=640, win_radius=48)
SHAPES = {"320x240": STD, "640x480": HIRES}
B = STD.boxsize
HALF = (B - 1) // 2
BIG_HALF = float(1 << 22)    # a half-width at or above it spans the whole window (search.cu box_range)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- mirrors of the kernel's integer steps


def box_rect(u0, v0, uc, vc, sinv_abc, c: SearchConsts):
    """The rectangle of centres that csrc/search.cu scores for each feature
    (box_range): (ulo, uhi, vlo, vhi) int64 [K], absolute pixel coordinates,
    empty where lo > hi. Half-widths from candidate_geometry's f32
    operations; a NaN or negative one gives no cell, one at or above 2^22 the
    whole window; the range is cut to the window and the valid centres."""
    half = (c.boxsize - 1) // 2
    hw, hh = half_widths(sinv_abc, c)

    def axis(h, centre, lo0, hi0):
        lo0 = lo0.long()
        hi0 = hi0.long()
        r = torch.where(h >= 0.0, h, torch.zeros_like(h)).clamp(max=BIG_HALF).long()
        lo = torch.maximum(lo0, centre.long() - r)
        hi = torch.minimum(hi0, centre.long() + r)
        lo = torch.where(h >= BIG_HALF, lo0, lo)
        hi = torch.where(h >= BIG_HALF, hi0, hi)
        none = ~(h >= 0.0)
        return torch.where(none, torch.ones_like(lo), lo), torch.where(none, torch.zeros_like(hi), hi)

    ulo, uhi = axis(hw, uc, torch.clamp(u0, min=half), torch.clamp(u0 + c.side_u - 1, max=c.W - 1 - half))
    vlo, vhi = axis(hh, vc, torch.clamp(v0, min=half), torch.clamp(v0 + c.side_v - 1, max=c.H - 1 - half))
    return ulo, uhi, vlo, vhi


def int_window_sums(win, patch_pix, c: SearchConsts):
    """The kernel's three sums in int32, [K, side_v, side_u]: for each patch
    row, three u8 quads of the window (bytes 4t .. 4t + 3 past the cell) taken
    with the zero-padded patch quads (cross), with ones on the patch's
    columns (sum) and with themselves after the same mask (squares), as
    __dp4a takes them."""
    B = c.boxsize
    sv, su = c.side_v, c.side_u
    K = win.shape[0]
    w = torch.nn.functional.pad(win.to(torch.int32), (0, 4 * 3 - B))        # bytes past the window: 0
    pix = torch.nn.functional.pad(patch_pix.to(torch.int32).reshape(K, B, B), (0, 4 * 3 - B))
    sums = [torch.zeros((K, sv, su), dtype=torch.int32, device=win.device) for _ in range(3)]
    for dy in range(B):
        for t in range(3):
            quad = [torch.zeros_like(sums[0]) for _ in range(3)]
            for k in range(4):
                dx = 4 * t + k
                x = w[:, dy : dy + sv, dx : dx + su]
                on = int(dx < B)
                quad[0] += pix[:, dy, dx, None, None] * x
                quad[1] += on * x
                quad[2] += on * x * x
            for s, q in zip(sums, quad):
                s += q
    return sums[1], sums[2], sums[0]


def key_select(corr, mask, uu, vv, c: SearchConsts):
    """The kernel's one-pass selection: every admitted cell's 64-bit key (the
    order-preserving bits of its score above the complement of u*H + v),
    the unsigned minimum, decoded. Returns (best f32 [K], u, v int32 [K])."""
    K = corr.shape[0]
    bits = (corr.float() + 0.0).contiguous().view(torch.int32).cpu().numpy().astype(np.uint32)  # -0 -> +0
    hi = np.where(bits & 0x80000000, ~bits, bits | 0x80000000).astype(np.uint64)
    uv = np.broadcast_to((uu * c.H + vv).cpu().numpy(), corr.shape).astype(np.uint32)
    keys = (hi << np.uint64(32)) | (~uv).astype(np.uint64)
    keys = np.where(mask.cpu().numpy(), keys, np.uint64(0xFFFFFFFFFFFFFFFF)).reshape(K, -1).min(axis=1)
    best = np.full(K, NO_MATCH, np.float32)
    u = np.full(K, -1, np.int32)
    v = np.full(K, -1, np.int32)
    for k, m in enumerate(keys):
        if m == 0xFFFFFFFFFFFFFFFF:
            continue
        h = np.uint32(m >> np.uint64(32))
        score = np.array([h & 0x7FFFFFFF if h & 0x80000000 else ~h], np.uint32).view(np.float32)[0]
        if score <= NO_MATCH:
            best[k] = score
            kb = int(~np.uint32(m & np.uint64(0xFFFFFFFF)))
            u[k], v[k] = kb // c.H, kb % c.H
    return torch.from_numpy(best), torch.from_numpy(u), torch.from_numpy(v)


def centre_i32(h_centre):
    """K8's in-kernel centre (csrc/search.cu centre_i32): f = floor(h + 0.5)
    in f32; NaN -> 0; f >= 2^31 -> INT32_MAX; f <= -2^31 -> INT32_MIN; else
    f truncated (exact: an integer below 2^31). int32, the shape of h."""
    f = torch.floor(h_centre.float() + 0.5)
    lim = float(1 << 31)
    inside = ~f.isnan() & (f.abs() < lim)
    i = torch.where(inside, f, torch.zeros_like(f)).to(torch.int32)
    i = torch.where(f >= lim, torch.full_like(i, 2**31 - 1), i)
    return torch.where(f <= -lim, torch.full_like(i, -(2**31)), i)


# ---------------------------------------------------------------- (a) the rectangle

_SPECIAL_CENTRES = (float("nan"), float("inf"), -float("inf"), 3e9, -3e9, -0.5, 0.5)
_SPECIAL_ABC = (
    (1e-13, 0.0, 1e-13),        # half-widths ~9.5e6: above 2^22, the whole window
    (1.0, 0.5, 0.25),           # a - b^2/c = 0 = c - b^2/a: infinite half-widths
    (0.01, 0.1, 0.01),          # a - b^2/c < 0: NaN half-widths
    (0.0, 0.0, 0.02),           # a = 0: 0/0 in the half-height
    (4.0, 0.0, 4.0),            # half-width 1: a 3 x 3 box
    (1e-4, 0.0, 1e-4),          # half-width 300: beyond the window
    (-0.01, 0.0, 0.02),         # a negative: NaN
    (0.04, 0.0399, 0.04),       # near singular
)


def _centre(which: str, x: float, size: int) -> float:
    return {"inside": x * (size - 1), "low": -x * 60.0, "high": size - 1 + x * 60.0}[which]


@st.composite
def _features(draw):
    shape = draw(st.sampled_from(sorted(SHAPES)))
    c = SHAPES[shape]
    K = draw(st.integers(1, 4))
    h, abc = [], []
    for _ in range(K):
        centre = []
        for size in (c.W, c.H):
            if draw(st.booleans()):
                centre.append(draw(st.sampled_from(_SPECIAL_CENTRES)))
            else:
                which = draw(st.sampled_from(("inside", "low", "high")))
                centre.append(_centre(which, draw(st.floats(0.0, 1.0)), size))
        h.append(centre)
        if draw(st.booleans()):
            abc.append(draw(st.sampled_from(_SPECIAL_ABC)))
        else:
            sd = [draw(st.floats(0.05, 200.0)) for _ in range(2)]
            rho = draw(st.floats(-0.9999, 0.9999))
            cov = np.array([[sd[0] ** 2, rho * sd[0] * sd[1]], [rho * sd[0] * sd[1], sd[1] ** 2]])
            si = np.linalg.inv(cov)
            abc.append((si[0, 0], si[0, 1], si[1, 1]))
    return c, torch.tensor(h, dtype=torch.float32), torch.tensor(abc, dtype=torch.float32)


def _assert_rect_covers(c, u0, v0, uc, vc, abc):
    admit = candidate_geometry(u0, v0, uc, vc, abc, c)[0]
    ulo, uhi, vlo, vhi = box_rect(u0, v0, uc, vc, abc, c)
    for k in range(u0.shape[0]):
        cells = admit[k].nonzero()
        if ulo[k] > uhi[k] or vlo[k] > vhi[k]:
            assert cells.numel() == 0, f"feature {k}: admitted cells outside an empty rectangle"
            continue
        # inside the window and the valid centres: every staged pixel is in the frame
        assert int(u0[k]) <= ulo[k] and uhi[k] <= int(u0[k]) + c.side_u - 1
        assert int(v0[k]) <= vlo[k] and vhi[k] <= int(v0[k]) + c.side_v - 1
        assert HALF <= ulo[k] and uhi[k] <= c.W - 1 - HALF and HALF <= vlo[k] and vhi[k] <= c.H - 1 - HALF
        vv = cells[:, 0] + v0[k]
        uu = cells[:, 1] + u0[k]
        assert bool(((uu >= ulo[k]) & (uu <= uhi[k]) & (vv >= vlo[k]) & (vv <= vhi[k])).all()), (
            f"feature {k}: an admitted cell lies outside the rectangle")


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_features())
def test_rect_covers_every_admitted_cell(feats):
    c, h, abc = feats
    u0, v0, uc, vc = search_window_origin(h, c.win_radius, c.W, c.H, B)
    _assert_rect_covers(c, u0, v0, uc, vc, abc)                      # K2: the clamped centre
    kc = centre_i32(h)
    _assert_rect_covers(c, u0, v0, kc[:, 0], kc[:, 1], abc)           # K8: the saturated centre


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rect_of_special_half_widths(shape):
    """NaN half-widths give an empty rectangle; infinite ones and ones at or
    above 2^22 the whole window (cut to the valid centres); a finite one the
    box about the centre."""
    c = SHAPES[shape]
    abc = torch.tensor([_SPECIAL_ABC[2], _SPECIAL_ABC[1], _SPECIAL_ABC[0], _SPECIAL_ABC[4]], dtype=torch.float32)
    h = torch.tensor([[c.W / 2, c.H / 2]] * 3 + [[HALF, c.H - 1 - HALF]], dtype=torch.float32)
    u0, v0, uc, vc = search_window_origin(h, c.win_radius, c.W, c.H, B)
    ulo, uhi, vlo, vhi = box_rect(u0, v0, uc, vc, abc, c)
    assert ulo[0] > uhi[0] and vlo[0] > vhi[0]
    for k in (1, 2):
        assert (ulo[k], uhi[k]) == (u0[k], u0[k] + c.side_u - 1)
        assert (vlo[k], vhi[k]) == (v0[k], v0[k] + c.side_v - 1)
    # a 3 x 3 box about the bottom-left valid centre: 2 x 2 of it remain
    assert (int(ulo[3]), int(uhi[3]), int(vlo[3]), int(vhi[3])) == (HALF, HALF + 1, c.H - 2 - HALF, c.H - 1 - HALF)


def _union_pixels(admit: np.ndarray) -> int:
    """Window pixels under some admitted cell's B x B footprint, by an
    integral image: pixel (y, x) is read iff a cell in [y-B+1, y] x [x-B+1, x]
    is admitted."""
    K, sv, su = admit.shape
    pad = np.zeros((K, sv + 2 * (B - 1) + 1, su + 2 * (B - 1) + 1), np.int64)
    pad[:, B:B + sv, B:B + su] = admit
    ii = pad.cumsum(1).cumsum(2)
    wv, wu = sv + B - 1, su + B - 1
    y = np.arange(wv)[:, None] + B
    x = np.arange(wu)[None, :] + B
    under = ii[:, y, x] - ii[:, y - B, x] - ii[:, y, x - B] + ii[:, y - B, x - B]
    return int((under > 0).sum())


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_features())
def test_bound_reads_the_pixels_under_admitted_cells(feats):
    """The K2 / K8 bound's window bytes (search.read_pixels) are the pixels
    under the admitted cells: the integral-image count, at most the
    rectangle's (nv + B - 1) x (nu + B - 1) pixels a feature, none where
    nothing is admitted; the operations are the admitted cells'."""
    c, h, abc = feats
    u0, v0, uc, vc = search_window_origin(h, c.win_radius, c.W, c.H, B)
    admit = candidate_geometry(u0, v0, uc, vc, abc, c)[0]
    n = read_pixels(admit, B)
    assert n == _union_pixels(admit.numpy())
    ulo, uhi, vlo, vhi = box_rect(u0, v0, uc, vc, abc, c)
    rect = ((uhi - ulo + B).clamp(min=0) * (vhi - vlo + B).clamp(min=0) * (ulo <= uhi) * (vlo <= vhi)).sum()
    assert n <= int(rect)
    K = u0.shape[0]
    nb, nf = bytes_and_flops(K, c, admit)
    nbw, nfw = bytes_and_flops_windows(K, c, admit)
    assert nb - n == K * ((B * B + 2) * 4 + 29 + 14) and nbw - n == K * (B * B + 29 + 14)
    assert nf == nfw == int(admit.sum()) * nssd_cell_ops(B)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2 ** 32 - 1), st.integers(1, 3))
def test_patch_row_pixels_are_u8_integers(seed, lanes):
    """K2 packs the patch row's pixels into byte quads by truncation
    (__float2uint_rz), so patch_row must write every pixel as an integer in
    0..255: truncating its f32 pixels gives back the u8 patch, and they
    equal the f32 values the twin uses."""
    rng = np.random.default_rng(seed)
    patch = torch.from_numpy(rng.integers(0, 256, (lanes, 4, B, B), dtype=np.uint8))
    pix = patch_row(patch)[..., : B * B]
    assert pix.dtype == torch.float32
    assert bool(((pix >= 0) & (pix <= 255) & (pix == pix.trunc())).all())
    assert torch.equal(pix.to(torch.uint8).reshape(patch.shape), patch)


# ---------------------------------------------------------------- (b) one pass over 64-bit keys


def _search_case(name: str, c: SearchConsts, rng):
    """Windows, patches and geometry of 6 features on one frame: a patch cut
    at or near each centre, S^-1 of deviations 1-10.7 px."""
    H, W, K = c.H, c.W, 6
    if name == "periodic":
        tile = rng.integers(0, 256, (B, B), dtype=np.uint8)
        frame = np.tile(tile, (H // B + 1, W // B + 1))[:H, :W].copy()
    elif name == "all255":
        frame = np.full((H, W), 255, np.uint8)
    else:
        frame = rng.integers(0, 256, (H, W), dtype=np.uint8)
    h = np.stack([rng.uniform(60, W - 60, K), rng.uniform(60, H - 60, K)], 1)
    centres = [tuple(int(math.floor(x + 0.5)) for x in h[k]) for k in range(K)]
    planted = {}
    if name == "perfect_tie":
        # even features: a random patch planted at two cells of the window,
        # a tie of perfect matches (planted before any patch is cut)
        for k in range(0, K, 2):
            iu, iv = centres[k]
            planted[k] = rng.integers(0, 256, (B, B), dtype=np.uint8)
            for du, dv in ((-6, -2), (5, 4)):
                frame[iv + dv - HALF : iv + dv + HALF + 1, iu + du - HALF : iu + du + HALF + 1] = planted[k]
    patches = []
    for k in range(K):
        iu, iv = centres[k]
        du, dv = (0, 0) if name.startswith("perfect") else rng.integers(-4, 5, 2)
        cut = frame[iv + dv - HALF : iv + dv + HALF + 1, iu + du - HALF : iu + du + HALF + 1].copy()
        patches.append(planted.get(k, cut))
    sd = rng.uniform(1.0, 32 / 3, (K, 2))
    sd[::2] = 5.0
    cov = np.zeros((K, 2, 2))
    cov[:, 0, 0], cov[:, 1, 1] = sd[:, 0] ** 2, sd[:, 1] ** 2
    si = np.linalg.inv(cov)
    abc = torch.tensor(np.stack([si[:, 0, 0], si[:, 0, 1], si[:, 1, 1]], 1), dtype=torch.float32)
    ht = torch.tensor(h, dtype=torch.float32)
    u0, v0, uc, vc = search_window_origin(ht, c.win_radius, W, H, B)
    rows = (v0 - HALF).long()[:, None] + torch.arange(c.side_v + B - 1)[None]
    cols = (u0 - HALF).long()[:, None] + torch.arange(c.side_u + B - 1)[None]
    win = torch.tensor(frame)[rows[:, :, None], cols[:, None, :]]
    patches = torch.tensor(np.stack(patches))
    return win, patches, u0, v0, uc, vc, abc


_SELECT_CASES = ("noise", "periodic", "perfect", "perfect_tie", "all255")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", _SELECT_CASES)
def test_key_min_equals_select_plain(name, shape):
    c = SHAPES[shape]
    win, patches, u0, v0, uc, vc, abc = _search_case(name, c, np.random.default_rng(_SELECT_CASES.index(name)))
    K = u0.shape[0]
    sg0, sg0sq = patch_sums(patches)
    pix = patches.reshape(K, -1)
    active = torch.ones(K, dtype=torch.bool)
    _found, u, v, best, _over = _select_plain(win, pix, sg0, sg0sq, u0, v0, uc, vc, abc, active, c)
    corr, mask, uu, vv, _hw, _hh = score_cells(win, pix, sg0, sg0sq, u0, v0, uc, vc, abc, c)
    kbest, ku, kv = key_select(corr, mask, uu, vv, c)
    assert torch.equal(kbest.view(torch.int32), best.view(torch.int32))
    assert torch.equal(ku, u) and torch.equal(kv, v)
    if name == "all255":
        assert bool((best == NO_MATCH).all()) and bool((u == -1).all())   # zero variance: nothing admitted
    if name.startswith("perfect"):
        assert float(best.abs().max()) < 1e-5                              # rounding residues near 0
    if name == "perfect_tie":
        # the last of the two planted cells in u-outer / v-inner order wins
        assert bool((u[::2] - uc[::2] == 5).all()) and bool((v[::2] - vc[::2] == 4).all())
    if name == "periodic":
        # several cells of a window score the same: the tie is real
        tied = ((corr == best[:, None, None]) & mask).reshape(K, -1).sum(1)
        assert int(tied.max()) > 1


# ---------------------------------------------------------------- (c) integer sums


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", ("noise", "periodic", "all255"))
def test_int_sums_equal_the_f32_sums(name, shape):
    c = SHAPES[shape]
    win, patches, *_ = _search_case(name, c, np.random.default_rng(7))
    pix = patches.reshape(patches.shape[0], -1)
    want = window_sums(win, pix, c)
    got = int_window_sums(win, pix, c)
    assert max(int(g.max()) for g in got) < 2 ** 24
    for label, g, w in zip(("sum", "sum of squares", "cross"), got, want):
        assert g.dtype == torch.int32
        assert torch.equal(g.to(torch.float32), w), label
    if name == "all255":
        assert int(got[1].max()) == B * B * 255 ** 2 and int(got[2].max()) == B * B * 255 ** 2


# ---------------------------------------------------------------- (d) K8's centre


def test_centre_conversion_equals_window_centre():
    vals = [float("nan"), float("inf"), -float("inf"), 3e9, -3e9, -0.5, 0.5, -1.5, 2147483520.0, -2147483648.0,
            -2147483904.0, 1e-40, -0.0]
    rng = np.random.default_rng(3)
    vals += list(rng.uniform(-1e4, 1e4, 40)) + list(np.round(rng.uniform(-300, 300, 20)) + 0.5)
    h = torch.tensor(np.reshape(vals + vals[:1], (-1, 2)), dtype=torch.float32)
    uc, vc = window_centre(h)
    got = centre_i32(h)
    assert torch.equal(got[:, 0], uc) and torch.equal(got[:, 1], vc)
    assert got.dtype == torch.int32
    assert centre_i32(torch.tensor([float("nan"), 3e9, -3e9, -0.5, 0.5])).tolist() == [0, 2 ** 31 - 1, -(2 ** 31),
                                                                                         0, 1]


def test_cluster_size_spreads_small_grids_only():
    assert [cluster_size(K, 132) for K in (1, 10, 20, 64, 160, 640)] == [8, 8, 8, 4, 2, 1]
