"""K2: NSSD elliptical search of the selected features.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_search.py
(``pallas_elliptical_search_fused`` / ``_search_kernel_fused`` ->
``_search_body`` -> ``_score_and_select``, using
``pallas_score_map.py::nssd_corr_f32``). Stage 3 of the step (reference
monoslam.cpp:401-477, improc.cpp:55-134). For each of the K selected
features, over its (side x side) candidate centres in the window at
(u0, v0):

  exact integer 11x11 box sums of the image and its square, and the patch
  cross-correlation (all below 2^24, so exact in f32 in any order);
  the f32 NSSD of nssd_corr_f32, with its 0/1 zero-variance specials;
  the mask: inside the window, inside the ellipse's 3-sigma box and the
  ellipse itself, a valid patch centre, both standard deviations >= the
  threshold;
  the masked minimum, and among its ties the LAST in u-outer/v-inner scan
  order (the max of u*H + v, docs/PARITY.md); overflow when the box exceeds
  the window; found = active & best <= corr_thresh2.

The TPU kernel scores only the ellipse's row band in 32/48-row slabs, a
TPU economy with bit-identical results; here every candidate is considered.

Bound on an H100 at the std shapes (K=10, 75x75 windows of a 320x240 u8
frame): ~60 KB in and ~10 MFLOP of box sums and correlation, well under a
microsecond; the launch dominates. Design: one block per selected feature;
its window and patch in shared memory; threads stride over the candidates,
score only those inside the ellipse's box, and reduce the minimum and then
the tie key across the block. In the batch step every argument carries a
leading lane dimension (frame [B, H, W], the rest [B, K, ...]) and the
B x K features are one grid: one launch for all lanes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from scenelib2_torch.kernels import _build

NAME = "search"
NO_MATCH = 1e6


@dataclass(frozen=True)
class SearchConsts:
    H: int
    W: int
    boxsize: int
    win_radius: int
    no_sigma: float
    corr_thresh2: float
    corr_sigma_thresh: float

    @staticmethod
    def from_params(p) -> "SearchConsts":
        return SearchConsts(
            H=p.cam_height, W=p.cam_width, boxsize=p.boxsize,
            win_radius=p.search_win_radius, no_sigma=p.no_sigma,
            corr_thresh2=p.corr_thresh2, corr_sigma_thresh=p.corr_sigma_thresh,
        )

    @property
    def side_u(self) -> int:
        return min(2 * self.win_radius + 1, self.W - self.boxsize + 1)

    @property
    def side_v(self) -> int:
        return min(2 * self.win_radius + 1, self.H - self.boxsize + 1)


def search_window_origin(h_centre, R: int, W: int, H: int, boxsize: int):
    """Centre-window origins of the single-feature search (port of
    scenelib2_tpu/kernels/correlate.py:155-175 with round_half=True).
    Returns (u0, v0, uc, vc), int32 [K].

    The centre is floor(c + 0.5). u0 is clamped to [half, W - side - half]
    so the (side + boxsize - 1)^2 image window stays inside the image.
    Centres are clamped to +-2^20 before the integer cast so that a garbage
    centre of an unselected lane converts the same way on every device."""
    half = (boxsize - 1) // 2
    side_u = min(2 * R + 1, W - boxsize + 1)
    side_v = min(2 * R + 1, H - boxsize + 1)
    lim = float(1 << 20)
    hc = torch.nan_to_num(h_centre, nan=0.0).clamp(-lim, lim)
    c = torch.floor(hc + 0.5)
    uc = c[..., 0].to(torch.int32)
    vc = c[..., 1].to(torch.int32)
    u0 = torch.clamp(uc - R, half, W - side_u - half)
    v0 = torch.clamp(vc - R, half, H - side_v - half)
    return u0, v0, uc, vc


def nssd_corr_f32(sg0, sg0sq, sg1, sg1sq, cross, n):
    """f32 NSSD score, op for op as scenelib2_tpu/kernels/pallas_score_map.py
    ::nssd_corr_f32 (improc.cpp:55-134), incl. the 0/1 zero-variance
    specials. n is a 0-dim tensor (a Python divisor would become a
    reciprocal multiply on CUDA)."""
    g0bar = sg0 / n
    g1bar = sg1 / n
    varg0 = sg0sq / n - g0bar * g0bar
    varg1 = sg1sq / n - g1bar * g1bar
    sd0 = torch.sqrt(varg0)
    sd1 = torch.sqrt(varg1)
    one = torch.ones((), dtype=sg1.dtype, device=sg1.device)
    v1s = torch.where(varg1 == 0.0, one, varg1)
    s1 = torch.sqrt(v1s)
    v0s = torch.where(varg0 == 0.0, one, varg0)
    s0 = torch.sqrt(v0s)
    k = g0bar / s0 - g1bar / s1
    corr = (
        sg0sq / v0s + sg1sq / v1s + n * (k * k)
        - cross * 2.0 / (s0 * s1) - sg0 * 2.0 * k / s0 + sg1 * 2.0 * k / s1
    ) / n
    both_zero = (sd0 == 0.0) & (sd1 == 0.0)
    special = torch.where(both_zero, torch.zeros_like(corr), torch.ones_like(corr))
    corr = torch.where((sd0 != 0.0) & (sd1 != 0.0), corr, special)
    return corr, sd0, sd1


def candidate_geometry(u0, v0, uc, vc, sinv_abc, c: SearchConsts):
    """Per-candidate geometry of every window cell, [K, side_v, side_u]:
    returns (admit, uu, vv, halfwidth, halfheight) where admit is the part
    of the mask that needs no image data (inside the 3-sigma box and the
    ellipse, a valid patch centre)."""
    dev = u0.device
    f32 = torch.float32
    half = (c.boxsize - 1) // 2
    sv, su = c.side_v, c.side_u
    a = sinv_abc[:, 0, None, None]
    b = sinv_abc[:, 1, None, None]
    cc = sinv_abc[:, 2, None, None]
    uu = u0[:, None, None] + torch.arange(su, device=dev, dtype=torch.int32)[None, None, :]
    vv = v0[:, None, None] + torch.arange(sv, device=dev, dtype=torch.int32)[None, :, None]
    urel = (uu - uc[:, None, None]).to(f32)
    vrel = (vv - vc[:, None, None]).to(f32)
    ns = torch.tensor(c.no_sigma, dtype=f32, device=dev)
    halfwidth = torch.floor(ns / torch.sqrt(a - b * b / cc))
    halfheight = torch.floor(ns / torch.sqrt(cc - b * b / a))
    box = (torch.abs(urel) <= halfwidth) & (torch.abs(vrel) <= halfheight)
    ellipse = a * urel * urel + 2.0 * b * urel * vrel + cc * vrel * vrel < c.no_sigma * c.no_sigma
    centre_ok = (uu >= half) & (uu <= c.W - 1 - half) & (vv >= half) & (vv <= c.H - 1 - half)
    return box & ellipse & centre_ok, uu, vv, halfwidth, halfheight


def search_plain(frame, patch_rows, u0, v0, uc, vc, sinv_abc, active, c: SearchConsts):
    """Plain PyTorch K2. frame [H,W] u8; patch_rows [K,128] f32 (pixels |
    sum | sum of squares); u0, v0, uc, vc [K] i32; sinv_abc [K,3] f32
    (S^-1 entries a, b, c); active [K] bool.
    Returns (found [K] bool, u [K] i32, v [K] i32, best [K] f32, over [K] bool)."""
    dev = frame.device
    f32 = torch.float32
    B = c.boxsize
    half = (B - 1) // 2
    K = u0.shape[0]
    sv, su = c.side_v, c.side_u
    wv, wu = sv + B - 1, su + B - 1
    rows = (v0 - half).long()[:, None] + torch.arange(wv, device=dev)[None, :]
    cols = (u0 - half).long()[:, None] + torch.arange(wu, device=dev)[None, :]
    win = frame[rows[:, :, None], cols[:, None, :]].to(f32)          # [K, wv, wu]
    win2 = win * win
    sg1 = torch.zeros((K, sv, su), dtype=f32, device=dev)
    sg1sq = torch.zeros_like(sg1)
    cross = torch.zeros_like(sg1)
    for dy in range(B):
        for dx in range(B):
            w = win[:, dy : dy + sv, dx : dx + su]
            sg1 = sg1 + w
            sg1sq = sg1sq + win2[:, dy : dy + sv, dx : dx + su]
            cross = cross + patch_rows[:, dy * B + dx, None, None] * w
    sg0 = patch_rows[:, B * B, None, None]
    sg0sq = patch_rows[:, B * B + 1, None, None]
    n = torch.tensor(float(B * B), dtype=f32, device=dev)
    corr, sd0, sd1 = nssd_corr_f32(sg0, sg0sq, sg1, sg1sq, cross, n)

    admit, uu, vv, halfwidth, halfheight = candidate_geometry(u0, v0, uc, vc, sinv_abc, c)
    mask = admit & (sd1 >= c.corr_sigma_thresh) & (sd0 >= c.corr_sigma_thresh)
    vals = torch.where(mask, corr, torch.full_like(corr, NO_MATCH)).reshape(K, -1)
    best = vals.min(dim=1).values
    key = (uu * c.H + vv).expand(K, sv, su).reshape(K, -1)
    tie = (vals == best[:, None]) & mask.reshape(K, -1)
    kbest = torch.where(tie, key, torch.full_like(key, -1)).max(dim=1).values
    has = kbest >= 0
    u = torch.where(has, kbest // c.H, -1).to(torch.int32)
    v = torch.where(has, kbest % c.H, -1).to(torch.int32)
    over = ((halfwidth > float(su // 2)) | (halfheight > float(sv // 2))).reshape(K)
    thr = torch.tensor(c.corr_thresh2, dtype=f32, device=dev)
    found = active & (best <= thr)
    return found, u, v, best, over & active


class _K2Params(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("W", ctypes.c_int), ("B", ctypes.c_int),
        ("side_v", ctypes.c_int), ("side_u", ctypes.c_int), ("per_lane", ctypes.c_int),
        ("no_sigma", ctypes.c_float), ("no_sigma2", ctypes.c_float),
        ("corr_thresh2", ctypes.c_float), ("corr_sigma_thresh", ctypes.c_float),
    ]


# tensor pointers, ints, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.POINTER(_K2Params), ctypes.c_void_p]


def search(frame, patch_rows, u0, v0, uc, vc, sinv_abc, active, c: SearchConsts):
    """K2. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises). Same outputs as search_plain. With a lane dimension
    (frame [B, H, W], every other argument [B, K, ...]) the outputs are
    [B, K] and the kernel is launched once for all lanes."""
    if frame.dim() == 3:
        return _search_lanes(frame, patch_rows, u0, v0, uc, vc, sinv_abc, active, c)
    if frame.device.type == "cpu":
        return search_plain(frame, patch_rows, u0, v0, uc, vc, sinv_abc, active, c)
    return _launch(frame, patch_rows, u0, v0, uc, vc, sinv_abc, active, c, 1)


def _search_lanes(frame, patch_rows, u0, v0, uc, vc, sinv_abc, active, c: SearchConsts):
    Bn, K = u0.shape
    rest = (patch_rows, u0, v0, uc, vc, sinv_abc, active)
    if frame.device.type == "cpu":
        per_lane = [search_plain(frame[b], *(t[b] for t in rest), c) for b in range(Bn)]
        return tuple(torch.stack(o) for o in zip(*per_lane))
    flat = (t.reshape(Bn * K, *t.shape[2:]).contiguous() for t in rest)
    return tuple(o.reshape(Bn, K) for o in _launch(frame, *flat, c, Bn))


def _launch(frame, patch_rows, u0, v0, uc, vc, sinv_abc, active, c: SearchConsts, n_lanes: int):
    """Launch K2 over K features, K / n_lanes consecutive ones per frame of
    frame [n_lanes, H, W] (or [H, W] for one lane)."""
    K = u0.shape[0]
    if c.boxsize * c.boxsize + 2 > 128:
        raise ValueError("K2: the patch row holds at most 126 pixels")
    _build.check_tensor(frame, "frame", torch.uint8, (c.H, c.W) if frame.dim() == 2 else (n_lanes, c.H, c.W))
    _build.check_tensor(patch_rows, "patch_rows", torch.float32, (K, 128))
    for name, t in (("u0", u0), ("v0", v0), ("uc", uc), ("vc", vc)):
        _build.check_tensor(t, name, torch.int32, (K,))
    _build.check_tensor(sinv_abc, "sinv_abc", torch.float32, (K, 3))
    _build.check_tensor(active, "active", torch.bool, (K,))
    dev = frame.device
    found = torch.empty(K, dtype=torch.bool, device=dev)
    u = torch.empty(K, dtype=torch.int32, device=dev)
    v = torch.empty(K, dtype=torch.int32, device=dev)
    best = torch.empty(K, dtype=torch.float32, device=dev)
    over = torch.empty(K, dtype=torch.bool, device=dev)
    prm = _K2Params(
        H=c.H, W=c.W, B=c.boxsize, side_v=c.side_v, side_u=c.side_u, per_lane=max(K // n_lanes, 1),
        no_sigma=c.no_sigma, no_sigma2=c.no_sigma * c.no_sigma,
        corr_thresh2=c.corr_thresh2, corr_sigma_thresh=c.corr_sigma_thresh,
    )
    fn = _build.function(NAME, "k2_search", _ARGTYPES)
    err = fn(
        frame.data_ptr(), patch_rows.data_ptr(), u0.data_ptr(), v0.data_ptr(),
        uc.data_ptr(), vc.data_ptr(), sinv_abc.data_ptr(), active.data_ptr(),
        found.data_ptr(), u.data_ptr(), v.data_ptr(), best.data_ptr(), over.data_ptr(),
        K, ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "K2 search")
    _build.launches[NAME] += 1
    return found, u, v, best, over


def nssd_cell_ops(B: int) -> int:
    """Least operations of one scored cell: the cross sum with the patch
    (B*B multiply-adds), the window's sum and sum of squares as box sums
    taken separably (2(B-1) adds each), the pixel's square, and ~30
    operations of the NSSD."""
    return 2 * B * B + 2 * 2 * (B - 1) + 1 + 30


def bytes_and_flops(K: int, c: SearchConsts, n_scored: int) -> tuple[int, int]:
    """Least bytes (the K windows read once, patch rows and per-feature
    inputs, results written) and the operations that the n_scored candidates
    admitted by this call's geometry (candidate_geometry) need."""
    B = c.boxsize
    wv, wu = c.side_v + B - 1, c.side_u + B - 1
    nbytes = K * (wv * wu + 128 * 4 + 4 * 4 + 3 * 4 + 1) + K * (1 + 4 + 4 + 4 + 1)
    return nbytes, n_scored * nssd_cell_ops(B)
