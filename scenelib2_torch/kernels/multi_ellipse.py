"""K16: the multi-ellipse search of a particle cloud over one score map per
slot.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_search.py
(``pallas_multi_ellipse_search`` / ``_particle_kernel``, pallas_call at
pallas_search.py:618, kernel :491-562, wrapper :565-640), the older form of
the particle search that only the JAX package's tests call (the batch step's
SCENELIB2_BATCH_SB=0 route imports K13, pallas_particle_search.py, instead).
For every particle of every slot (reference
SearchMultipleOverlappingEllipses, search_multiple_overlapping_ellipses.cpp:
106-196):

  uc, vc = trunc(h) as f32, converted to int32 in the kernel (XLA: NaN -> 0,
    saturation; correlate.xla_i32);
  the half-extents floor(no_sigma / sqrt(a - b^2 / c)) and
    floor(no_sigma / sqrt(c - b^2 / a)) stay f32 and are compared as f32
    (a NaN admits no cell), unlike K13's int32 casts;
  the window of side side_u x side_v (side = min(2 R + 1, extent)) at
    u0 = clip(uc - side_u // 2, 0, W - side_u) (int32, wrapping), v0 alike;
  the TPU kernel reads an aligned band of the map, rows [va, va + band_v)
    (va = min(8 floor(v0 / 8), pad_h - band_v), band_v = side_v rounded up
    to 8, + 8) and columns [ua, ua + 256) (ua = min(128 floor(u0 / 128),
    pad_w - 256)); the admitted cells are those of the window inside the
    band, with u < W, |u - uc| <= hw, |v - vc| <= hh and
    (a urel) urel + ((2b) urel) vrel + (c vrel) vrel < no_sigma^2;
  best = the minimum over the band of the admitted cells' scores and the
    1e6 of every other cell (NaN if an admitted cell is NaN); key = the
    largest u*H + v among the admitted cells at the minimum, -1 if none;
  found = alive & best <= corr_thresh2; u = key // H, v = key % H (floor
    division: no cell gives u = -1, v = H - 1); overflow = alive & a
    half-extent above side // 2.

Dead particles are searched too (only found and overflow are gated by
alive), where K13 gives them no key.

Bound on an H100: the map cells under the particles' searched rectangles
read once (each slot's union) and ~12 operations per cell of each
particle's rectangle (the box and ellipse tests and the comparison):
microseconds at most. Design (csrc/multi_ellipse.cu, K13's with K16's
rules): the wrapper checks, allocates the outputs and launches once with
the inputs as they are; the kernel computes each particle's geometry,
ctas_a_slot CTAs of THREADS threads a slot stage the read box (the bounding box
of every particle's rectangle, dead particles' included) where it fits and
take every cluster-th particle, a warp a particle walking its rectangle
(window, band and u < W, cut by the 3-sigma box only where the cut is
exact) row by row, one 64-bit key a cell, and write found, u, v and
overflow. particle_rows, geometry and _outputs stay as the plain version's
code; work_counts and bytes_and_flops count the bound.
"""

from __future__ import annotations

import ctypes

import torch

from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.correlate import MISS, ellipse_mask, window_search, wrap_i32, xla_i32
from scenelib2_torch.kernels.search_bayes import cluster_size
NAME = "multi_ellipse"
THREADS = 512   # a CTA's threads (csrc/multi_ellipse.cu: 32 to 1,024)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_shape(win_radius: int, H: int, W: int) -> tuple[int, int, int, int, int]:
    """(side_u, side_v, pad_h, pad_w, band_v) of the TPU kernel
    (pallas_search.py:589-593, 517-521). Raises where its band does not fit
    the padded map (the TPU kernel's slice is refused there)."""
    side_u, side_v = min(2 * win_radius + 1, W), min(2 * win_radius + 1, H)
    pad_h, pad_w = _round_up(H, 8), max(_round_up(W, 128), 256)
    band_v = _round_up(side_v, 8) + 8
    if band_v > pad_h:
        raise ValueError(f"K16: the search band of {band_v} rows exceeds the {pad_h}-row padded map")
    return side_u, side_v, pad_h, pad_w, band_v


def particle_rows(h_centres, sinv, alive) -> torch.Tensor:
    """The TPU wrapper's per-particle rows [F, P, 6] f32: trunc(h) as f32,
    the S^-1 entries a, b, c and alive (pallas_search.py:600-611)."""
    f32 = torch.float32
    uc = torch.trunc(h_centres[..., 0]).to(f32)
    vc = torch.trunc(h_centres[..., 1]).to(f32)
    return torch.stack([uc, vc, sinv[..., 0, 0].to(f32), sinv[..., 0, 1].to(f32), sinv[..., 1, 1].to(f32),
                        alive.to(f32)], dim=-1)


def geometry(rows, win_radius: int, no_sigma: float, H: int, W: int) -> dict:
    """Per particle [F, P]: uc, vc (int64 holding XLA's int32), the f32
    half-extents hw, hh, the window origin u0, v0 and the band origin ua,
    va (int64), a, b, c (f32)."""
    side_u, side_v, pad_h, pad_w, band_v = band_shape(win_radius, H, W)
    uc, vc = xla_i32(rows[..., 0]), xla_i32(rows[..., 1])
    a, b, c = rows[..., 2], rows[..., 3], rows[..., 4]
    ns = torch.full((), no_sigma, dtype=torch.float32, device=rows.device)
    u0 = torch.clamp(wrap_i32(uc - side_u // 2), 0, W - side_u)
    v0 = torch.clamp(wrap_i32(vc - side_v // 2), 0, H - side_v)
    return dict(uc=uc, vc=vc, a=a, b=b, c=c,
                hw=torch.floor(ns / torch.sqrt(a - b * b / c)), hh=torch.floor(ns / torch.sqrt(c - b * b / a)),
                u0=u0, v0=v0, ua=torch.clamp(u0 // 128 * 128, max=pad_w - 256),
                va=torch.clamp(v0 // 8 * 8, max=pad_h - band_v))


def ctas_a_slot(n_slots: int, n_sms: int) -> int:
    """CTAs that share one slot's particles (a plain grid):
    search_bayes.cluster_size's rule with two CTAs of THREADS an SM, 4 over
    64 slots, 8 over 16 (PERF.md section 6: of 256, 512 and 1,024
    threads x 1-8 CTAs a slot these were the fastest at 64 x 100 and 16 x
    200 particles)."""
    return cluster_size(n_slots, 2 * n_sms)


def _outputs(best, key, over, alive, H: int, corr_thresh2: float):
    key = key.to(torch.int64)
    found = alive & (best <= corr_thresh2)
    u = torch.div(key, H, rounding_mode="floor").to(torch.int32)
    v = torch.remainder(key, H).to(torch.int32)
    return found, u, v, over & alive


def multi_ellipse_search_plain(corr_maps, h_centres, sinv, alive, win_radius: int = 16,
                               no_sigma: float = 3.0, corr_thresh2: float = 0.40):
    """Plain PyTorch K16. corr_maps [F, H, W] f32; h_centres [F, P, 2];
    sinv [F, P, 2, 2]; alive [F, P] bool. Returns (found, u, v, overflow),
    each [F, P] (u, v int32). Every admitted cell lies in the particle's
    window, so the search gathers the windows (correlate.window_search) and
    masks the band, the box and the ellipse."""
    Fn, H, W = corr_maps.shape
    side_u, side_v, _ph, _pw, band_v = band_shape(win_radius, H, W)
    g = geometry(particle_rows(h_centres, sinv, alive), win_radius, no_sigma, H, W)

    def e(t):
        return t[None, ..., None, None]

    def mask_fn(uu, vv):
        urel = wrap_i32(uu - e(g["uc"])).to(torch.float32)
        vrel = wrap_i32(vv - e(g["vc"])).to(torch.float32)
        band = (uu >= e(g["ua"])) & (uu < e(g["ua"]) + 256) & (vv >= e(g["va"])) & (vv < e(g["va"]) + band_v)
        box = (torch.abs(urel) <= e(g["hw"])) & (torch.abs(vrel) <= e(g["hh"]))
        ell = ellipse_mask(g["a"][None], g["b"][None], g["c"][None], g["uc"][None], g["vc"][None], uu, vv,
                           no_sigma)
        return band & (uu < W) & box & ell

    best, key = window_search(corr_maps[None], g["u0"][None], g["v0"][None], side_v, side_u, mask_fn)
    # the band always holds cells outside the mask, whose 1e6 enters the minimum
    best = torch.minimum(best[0], torch.full_like(best[0], MISS))
    over = (g["hw"] > float(side_u // 2)) | (g["hh"] > float(side_v // 2))
    return _outputs(best, key[0], over, alive, H, corr_thresh2)


class _K16Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("H", "W", "P", "side_u", "side_v", "pad_h", "pad_w", "band_v",
                                             "threads", "cluster", "stage")]
                + [(n, ctypes.c_float) for n in ("no_sigma", "no_sigma2", "corr_thresh2")])


# tensor pointers (maps, h_centres, sinv, alive; found, u, v, over), the
# slots, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.POINTER(_K16Params), ctypes.c_void_p]


def multi_ellipse_search(corr_maps, h_centres, sinv, alive, win_radius: int = 16, no_sigma: float = 3.0,
                         corr_thresh2: float = 0.40):
    """K16, with pallas_multi_ellipse_search's arguments in its order and
    its defaults. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise). Same outputs as multi_ellipse_search_plain: one
    launch for all slots and, on f32 inputs, no other tensor operation
    (other float types are converted first, h truncated before, as the TPU
    wrapper's rows take it)."""
    if corr_maps.device.type == "cpu":
        return multi_ellipse_search_plain(corr_maps, h_centres, sinv, alive, win_radius, no_sigma,
                                          corr_thresh2)
    Fn, H, W = corr_maps.shape
    P = alive.shape[-1]
    side_u, side_v, pad_h, pad_w, band_v = band_shape(win_radius, H, W)
    f32 = torch.float32
    if corr_maps.dtype != f32:
        corr_maps = corr_maps.to(f32)
    if h_centres.dtype != f32:
        h_centres = torch.trunc(h_centres).to(f32)
    if sinv.dtype != f32:
        sinv = sinv.to(f32)
    corr_maps, h_centres, sinv, alive = (t.contiguous() for t in (corr_maps, h_centres, sinv, alive))
    for t, name, dty, shp in ((corr_maps, "corr_maps", f32, (Fn, H, W)), (h_centres, "h_centres", f32, (Fn, P, 2)),
                              (sinv, "sinv", f32, (Fn, P, 2, 2)), (alive, "alive", torch.bool, (Fn, P))):
        _build.check_tensor(t, name, dty, shp)
    dev = corr_maps.device
    found = torch.empty((Fn, P), dtype=torch.bool, device=dev)
    u = torch.empty((Fn, P), dtype=torch.int32, device=dev)
    v = torch.empty((Fn, P), dtype=torch.int32, device=dev)
    over = torch.empty((Fn, P), dtype=torch.bool, device=dev)
    fn = _build.function(NAME, "k16_multi_ellipse", _ARGTYPES)
    prm = _K16Params(H=H, W=W, P=P, side_u=side_u, side_v=side_v, pad_h=pad_h, pad_w=pad_w, band_v=band_v,
                     threads=THREADS, cluster=ctas_a_slot(Fn, _build.n_sms(dev)), stage=0, no_sigma=no_sigma,
                     no_sigma2=no_sigma * no_sigma, corr_thresh2=corr_thresh2)
    err = fn(*(t.data_ptr() for t in (corr_maps, h_centres, sinv, alive, found, u, v, over)), Fn,
             ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K16 multi_ellipse")
    _build.launches[NAME] += 1
    return found, u, v, over


def work_counts(corr_maps, h_centres, sinv, alive, win_radius: int = 16,
                no_sigma: float = 3.0) -> tuple[int, int]:
    """The data-dependent work of one K16 call on these inputs: (map cells
    read, each slot's union of its particles' searched rectangles counted
    once; cells searched, the rectangles' cells summed over particles). A
    particle's rectangle is its window inside the band and its 3-sigma box."""
    Fn, H, W = corr_maps.shape
    side_u, side_v, _ph, _pw, band_v = band_shape(win_radius, H, W)
    g = {k: v.double().cpu() for k, v in geometry(
        particle_rows(h_centres, sinv, alive), win_radius, no_sigma, H, W).items()}

    def span(lo_i, hi_i, centre, half):
        lo = torch.maximum(lo_i, centre - half)
        hi = torch.minimum(hi_i, centre + half + 1)
        ok = ~(lo.isnan() | hi.isnan()) & (hi > lo)
        return torch.where(ok, lo, 0).long(), torch.where(ok, hi, 0).long()

    u_lo, u_hi = span(torch.maximum(g["u0"], g["ua"]),
                      torch.minimum(torch.minimum(g["u0"] + side_u, g["ua"] + 256), torch.tensor(float(W))),
                      g["uc"], g["hw"])
    v_lo, v_hi = span(torch.maximum(g["v0"], g["va"]), torch.minimum(g["v0"] + side_v, g["va"] + band_v),
                      g["vc"], g["hh"])
    some = (u_hi > u_lo) & (v_hi > v_lo)
    n_searched = int(((v_hi - v_lo) * (u_hi - u_lo))[some].sum())
    # the union per slot: +1 / -1 at each rectangle's corners, then a 2-D prefix sum
    slot = torch.arange(Fn)[:, None].expand_as(some)[some]
    cover = torch.zeros((Fn, H + 1, W + 1), dtype=torch.int32)
    for vv, uu, sign in ((v_lo, u_lo, 1), (v_lo, u_hi, -1), (v_hi, u_lo, -1), (v_hi, u_hi, 1)):
        cover.index_put_((slot, vv[some], uu[some]), torch.full(slot.shape, sign, dtype=torch.int32),
                         accumulate=True)
    return int((cover.cumsum(1).cumsum(2) > 0).sum()), n_searched


def bytes_and_flops(Fn: int, P: int, n_read: int, n_searched: int) -> tuple[int, int]:
    """Least bytes and operations of one K16 call with this run's data
    (work_counts): the n_read map cells read once, the particles' centres,
    S^-1 and alive in, found / u / v / overflow out; ~12 operations per
    searched cell and ~20 per particle (the half-extents and the window)."""
    return 4 * n_read + Fn * P * (8 + 16 + 1) + Fn * P * (1 + 4 + 4 + 1), 12 * n_searched + 20 * Fn * P
