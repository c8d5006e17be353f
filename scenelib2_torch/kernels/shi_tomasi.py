"""K6: Shi-Tomasi best-patch detection in the auto-init region.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_shi_tomasi.py
(``pallas_shi_tomasi_region`` / ``_st_kernel`` -> ``st_region_body``), the
patch pick of stage 7 (reference monoslam.cpp:1043-1205,
find_best_patch_in_image_window). Over the region window at (u0, v0) (the
region's start clamped so the (region + 2*off)-pixel window stays inside
the frame, off = 1 + half):

  doubled central-difference gradients gx2, gy2 (integer differences);
  11x11 box sums of gx2^2, gy2^2, gx2*gy2 (below 2^24, exact in f32 in any
  order);
  A, C, B = the sums / 4 and the smaller eigenvalue
  ev = (A + C - sqrt((A + C)^2 - 4 (A C - B^2))) / 2 in f32;
  the mask (inside [ustart, ufinish) x [vstart, vfinish) and the region);
  the maximum (NaN if any masked ev is NaN, as jnp.max) and among its ties
  the SMALLEST scan key v*W + u (the reference's first-in-scan-order pick);
  found = best > 0, else (ustart, vstart, 0).

Bound on an H100: a 72 x 92 u8 window in and ~2 MOP of box sums, far below
a microsecond; the launch dominates. Design: one block; the window as u8
and the two gradient planes as int16 in shared memory; one thread per
output cell sums its 121 gradient products in int32 (exact), evaluates the
eigenvalue, and two block reductions give the maximum and the tie key.
In the batch step the frame is [B, H, W] and the bounds [B]: one block per
lane, one launch for all lanes.
"""

from __future__ import annotations

import ctypes

import torch

from scenelib2_torch.kernels import _build

NAME = "shi_tomasi"
INT_MAX = 2**31 - 1


def clamp_region(ustart, vstart, ufinish, vfinish, width: int, height: int, boxsize: int):
    """Border clamping of the region (monoslam.cpp:1081-1091), on int tensors."""
    half = (boxsize - 1) // 2
    return (torch.clamp(ustart, min=half + 1), torch.clamp(vstart, min=half + 1),
            torch.clamp(ufinish, max=width - half - 1), torch.clamp(vfinish, max=height - half - 1))


def region_geometry(H: int, W: int, B: int, region_w: int, region_h: int):
    """(off, region_w, region_h) after the wrapper's clamp to the frame."""
    off = 1 + (B - 1) // 2
    return off, min(region_w, W - 2 * off), min(region_h, H - 2 * off)


def window_origin(ustart, vstart, H: int, W: int, B: int, region_w: int, region_h: int):
    """(u0, v0): the region's first output centre, clamped so that the
    window stays inside the frame (pallas_shi_tomasi.py:160-161)."""
    off, rw, rh = region_geometry(H, W, B, region_w, region_h)
    return torch.clamp(ustart, off, W - rw - off), torch.clamp(vstart, off, H - rh - off)


def shi_tomasi_plain(frame, ustart, vstart, ufinish, vfinish, *, boxsize: int,
                     region_w: int, region_h: int):
    """Plain PyTorch K6. frame [H, W] u8; the region bounds are [] int32
    tensors (already clamp_region'ed). Returns (ubest [] i32, vbest [] i32,
    evbest [] f32)."""
    H, W = frame.shape
    B = boxsize
    off, rw, rh = region_geometry(H, W, B, region_w, region_h)
    dev = frame.device
    u0, v0 = window_origin(ustart, vstart, H, W, B, region_w, region_h)
    rows = (v0 - off).long() + torch.arange(rh + 2 * off, device=dev)
    cols = (u0 - off).long() + torch.arange(rw + 2 * off, device=dev)
    w = frame[rows[:, None], cols[None, :]].to(torch.int32)           # [rh+2off, rw+2off]
    # gradients at interior point (i+1, j+1) of the window
    gx2 = w[1:-1, 2:] - w[1:-1, :-2]
    gy2 = w[2:, 1:-1] - w[:-2, 1:-1]

    def box(g):  # [rh+B-1, rw+B-1] -> [rh, rw] 11x11 sums, exact in int32
        acc = g[0:rh]
        for dy in range(1, B):
            acc = acc + g[dy : dy + rh]
        out = acc[:, 0:rw]
        for dx in range(1, B):
            out = out + acc[:, dx : dx + rw]
        return out.to(torch.float32)

    A = box(gx2 * gx2) * 0.25
    C = box(gy2 * gy2) * 0.25
    Bq = box(gx2 * gy2) * 0.25
    BB = torch.sqrt((A + C) * (A + C) - 4.0 * (A * C - Bq * Bq))
    ev = (A + C - BB) / torch.full((), 2.0, device=dev)

    uu = u0 + torch.arange(rw, device=dev, dtype=torch.int32)[None, :]
    vv = v0 + torch.arange(rh, device=dev, dtype=torch.int32)[:, None]
    uuf, vvf = uu.to(torch.float32), vv.to(torch.float32)
    mask = ((uuf >= ustart.to(torch.float32)) & (uuf < ufinish.to(torch.float32))
            & (vvf >= vstart.to(torch.float32)) & (vvf < vfinish.to(torch.float32))
            & (uu >= off) & (uu <= W - 1 - off) & (vv >= off) & (vv <= H - 1 - off))
    vals = torch.where(mask, ev, torch.full_like(ev, -torch.inf))
    best = vals.max()                                    # NaN if any masked ev is NaN
    key = vv * W + uu
    tie = (vals == best) & mask
    kbest = torch.where(tie, key, torch.full_like(key, INT_MAX)).min()
    found = best > 0.0
    ubest = torch.where(found, kbest % W, ustart).to(torch.int32)
    vbest = torch.where(found, kbest // W, vstart).to(torch.int32)
    evbest = torch.where(found, best, torch.zeros_like(best))
    return ubest, vbest, evbest


class _K6Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("H", "W", "B", "region_w", "region_h")]


# tensor pointers (frame, 4 bounds, 3 outputs), the lanes, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.POINTER(_K6Params), ctypes.c_void_p]


def shi_tomasi(frame, ustart, vstart, ufinish, vfinish, *, boxsize: int, region_w: int,
               region_h: int):
    """K6. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises). Same outputs as shi_tomasi_plain. With a lane
    dimension (frame [B, H, W], bounds [B]) the outputs are [B] and the
    kernel is launched once for all lanes."""
    kw = dict(boxsize=boxsize, region_w=region_w, region_h=region_h)
    lanes = frame.dim() == 3
    if frame.device.type == "cpu":
        if lanes:
            per_lane = [shi_tomasi_plain(frame[b], ustart[b], vstart[b], ufinish[b], vfinish[b], **kw)
                        for b in range(frame.shape[0])]
            return tuple(torch.stack(o) for o in zip(*per_lane))
        return shi_tomasi_plain(frame, ustart, vstart, ufinish, vfinish, **kw)
    H, W = frame.shape[-2:]
    shp = (frame.shape[0],) if lanes else ()
    off, rw, rh = region_geometry(H, W, boxsize, region_w, region_h)
    if not (0 < rw and 0 < rh and rw + 2 * off <= 100 and rh + 2 * off <= 80):
        raise ValueError(f"K6: unsupported region {rw}x{rh} (+{2 * off})")
    _build.check_tensor(frame, "frame", torch.uint8, (*shp, H, W))
    for name, t in (("ustart", ustart), ("vstart", vstart), ("ufinish", ufinish),
                    ("vfinish", vfinish)):
        _build.check_tensor(t, name, torch.int32, shp)
    dev = frame.device
    ubest = torch.empty(shp, dtype=torch.int32, device=dev)
    vbest = torch.empty(shp, dtype=torch.int32, device=dev)
    evbest = torch.empty(shp, dtype=torch.float32, device=dev)
    prm = _K6Params(H=H, W=W, B=boxsize, region_w=rw, region_h=rh)
    fn = _build.function(NAME, "k6_shi_tomasi", _ARGTYPES)
    err = fn(frame.data_ptr(), ustart.data_ptr(), vstart.data_ptr(), ufinish.data_ptr(),
             vfinish.data_ptr(), ubest.data_ptr(), vbest.data_ptr(), evbest.data_ptr(),
             frame.shape[0] if lanes else 1, ctypes.byref(prm),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K6 shi_tomasi")
    _build.launches[NAME] += 1
    return ubest, vbest, evbest


def bytes_and_flops(boxsize: int, region_w: int, region_h: int) -> tuple[int, int]:
    """Least bytes (the window read once, the bounds in, three results out)
    and operations of one K6 call: gradients, three 11x11 box sums per cell
    (taken separably: 2(B-1) adds each) and ~12 operations of the
    eigenvalue."""
    off = 1 + (boxsize - 1) // 2
    nbytes = (region_h + 2 * off) * (region_w + 2 * off) + 4 * 4 + 3 * 4
    g = (region_h + boxsize - 1) * (region_w + boxsize - 1)
    flops = 2 * g + 3 * g + 3 * 2 * (boxsize - 1) * region_h * region_w + 12 * region_h * region_w
    return nbytes, flops
