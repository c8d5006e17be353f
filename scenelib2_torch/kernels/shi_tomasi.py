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

Bound on an H100 (bytes_and_flops): a 72 x 92 u8 window in and ~0.2 M
operations of separable sums and eigenvalues, a fraction of a microsecond;
the launch and the chain of passes set the time. Design
(csrc/shi_tomasi.cu): the rows of cells split into bands over a cluster of
cluster_size(lanes, SMs) CTAs, each lane its own cluster; a CTA stages its
band's window rows as u8 (all at once where they fit the device's shared
memory, else in stages: any region; the launcher sizes them), takes the
11-row and then the 11-column sums of
the three gradient products in int32 (running sums, exact), and turns each
admitted cell into one 64-bit key (the eigenvalue's bits when it is > 0,
then 0xFFFFFFFF - (v*W + u)); one maximum over the block and the cluster
(distributed shared memory) gives the pick; a NaN eigenvalue sets a flag
that voids it. One launch for all lanes.

The JAX package's XLA form of the same pick,
find_best_patch_in_image_window (scenelib2_tpu/kernels/shi_tomasi.py:85-146),
which the batch step runs in place of the kernel when batch_pallas is False,
has the plain version's f32 operation order (integer gradients and box sums,
exact; A, C, B = the sums * 0.25; the eigenvalue as above), so that route
calls shi_tomasi_plain over its lanes (the CPU tests hold the two to the JAX
form on real frames). With x64 on, JAX's step runs that form in every
route (its f64 eigenvalue math: A, C, B and ev in f64 from the same exact
sums); shi_tomasi_plain(..., dtype=torch.float64) is that form.
"""

from __future__ import annotations

import ctypes

import torch

from scenelib2_torch.kernels import _build

NAME = "shi_tomasi"
INT_MAX = 2**31 - 1
MAX_CLUSTER = 8           # csrc/shi_tomasi.cu K6_MAX_CLUSTER (portable cluster size)


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
                     region_w: int, region_h: int, dtype=torch.float32):
    """Plain PyTorch K6. frame [..., H, W] u8; the region bounds are [...]
    int32 tensors (already clamp_region'ed), with any leading (lane)
    dimensions. Returns (ubest, vbest [...] i32, evbest [...] `dtype`):
    the eigenvalue math runs in `dtype` on the exact int32 box sums (f32 is
    K6's, f64 the JAX form's with x64 on)."""
    lead = frame.shape[:-2]
    H, W = frame.shape[-2:]
    frame = frame.reshape(-1, H, W)
    ustart, vstart, ufinish, vfinish = (t.reshape(-1) for t in (ustart, vstart, ufinish, vfinish))
    N = frame.shape[0]
    B = boxsize
    off, rw, rh = region_geometry(H, W, B, region_w, region_h)
    dev = frame.device
    u0, v0 = window_origin(ustart, vstart, H, W, B, region_w, region_h)
    rows = (v0.long() - off)[:, None, None] + torch.arange(rh + 2 * off, device=dev)[:, None]
    cols = (u0.long() - off)[:, None, None] + torch.arange(rw + 2 * off, device=dev)
    w = frame[torch.arange(N, device=dev)[:, None, None], rows, cols].to(torch.int32)  # [N, rh+2off, rw+2off]
    # gradients at interior point (i+1, j+1) of the window
    gx2 = w[:, 1:-1, 2:] - w[:, 1:-1, :-2]
    gy2 = w[:, 2:, 1:-1] - w[:, :-2, 1:-1]

    def box(g):  # [N, rh+B-1, rw+B-1] -> [N, rh, rw] 11x11 sums, exact in int32
        acc = g[:, 0:rh]
        for dy in range(1, B):
            acc = acc + g[:, dy : dy + rh]
        out = acc[:, :, 0:rw]
        for dx in range(1, B):
            out = out + acc[:, :, dx : dx + rw]
        return out.to(dtype)

    A = box(gx2 * gx2) * 0.25
    C = box(gy2 * gy2) * 0.25
    Bq = box(gx2 * gy2) * 0.25
    BB = torch.sqrt((A + C) * (A + C) - 4.0 * (A * C - Bq * Bq))
    ev = (A + C - BB) / torch.full((), 2.0, dtype=dtype, device=dev)

    def e(t):
        return t[:, None, None]

    uu = e(u0) + torch.arange(rw, device=dev, dtype=torch.int32)
    vv = e(v0) + torch.arange(rh, device=dev, dtype=torch.int32)[:, None]
    uuf, vvf = uu.to(torch.float32), vv.to(torch.float32)
    mask = ((uuf >= e(ustart).to(torch.float32)) & (uuf < e(ufinish).to(torch.float32))
            & (vvf >= e(vstart).to(torch.float32)) & (vvf < e(vfinish).to(torch.float32))
            & (uu >= off) & (uu <= W - 1 - off) & (vv >= off) & (vv <= H - 1 - off)).flatten(1)
    vals = torch.where(mask, ev.flatten(1), torch.full_like(ev.flatten(1), -torch.inf))
    best = vals.amax(dim=1)                              # NaN if any masked ev is NaN
    key = (vv * W + uu).flatten(1)
    tie = (vals == best[:, None]) & mask
    kbest = torch.where(tie, key, torch.full_like(key, INT_MAX)).amin(dim=1)
    found = best > 0.0
    ubest = torch.where(found, kbest % W, ustart).to(torch.int32)
    vbest = torch.where(found, kbest // W, vstart).to(torch.int32)
    evbest = torch.where(found, best, torch.zeros_like(best))
    return ubest.reshape(lead), vbest.reshape(lead), evbest.reshape(lead)


def cluster_size(n_lanes: int, n_sms: int) -> int:
    """CTAs that share one lane's region (a thread-block cluster, each a
    band of its rows of cells): the largest power of two with n_lanes x it
    at most the SMs, up to MAX_CLUSTER for one lane and half that over
    lanes: the single stream takes 8, batch-hires' 16 lanes 4, batch64's
    64 lanes 2 (the sizes that `scripts/ab_predict_st_kernels.py --grid`
    found fastest, PERF.md section 6)."""
    cap = MAX_CLUSTER if n_lanes == 1 else MAX_CLUSTER // 2
    cs = 1
    while cs < cap and 2 * cs * n_lanes <= n_sms:
        cs *= 2
    return cs


class _K6Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("H", "W", "B", "region_w", "region_h", "cluster", "band_rows",
                                            "vstride", "stage_rows")]


# tensor pointers (frame, 4 bounds, 3 outputs), the lanes, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.POINTER(_K6Params), ctypes.c_void_p]


def shi_tomasi(frame, ustart, vstart, ufinish, vfinish, *, boxsize: int, region_w: int,
               region_h: int):
    """K6. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises). Same outputs as shi_tomasi_plain. With a lane
    dimension (frame [B, H, W], bounds [B]) the outputs are [B] and the
    kernel is launched once for all lanes."""
    return _launch(frame, ustart, vstart, ufinish, vfinish, boxsize=boxsize, region_w=region_w,
                   region_h=region_h)


def _launch(frame, ustart, vstart, ufinish, vfinish, *, boxsize: int, region_w: int, region_h: int,
            rows: int = 0):
    """shi_tomasi; rows > 0 forces stages of at most that many rows of cells,
    which give the same bits (a check's hook; the step's calls leave it 0)."""
    kw = dict(boxsize=boxsize, region_w=region_w, region_h=region_h)
    lanes = frame.dim() == 3
    if frame.device.type == "cpu":
        return shi_tomasi_plain(frame, ustart, vstart, ufinish, vfinish, **kw)
    H, W = frame.shape[-2:]
    shp = (frame.shape[0],) if lanes else ()
    off, rw, rh = region_geometry(H, W, boxsize, region_w, region_h)
    if not (0 < rw and 0 < rh):
        raise ValueError(f"K6: empty region {rw}x{rh} in a {W}x{H} frame")
    _build.check_tensor(frame, "frame", torch.uint8, (*shp, H, W))
    for name, t in (("ustart", ustart), ("vstart", vstart), ("ufinish", ufinish),
                    ("vfinish", vfinish)):
        _build.check_tensor(t, name, torch.int32, shp)
    dev = frame.device
    ubest = torch.empty(shp, dtype=torch.int32, device=dev)
    vbest = torch.empty(shp, dtype=torch.int32, device=dev)
    evbest = torch.empty(shp, dtype=torch.float32, device=dev)
    fn = _build.function(NAME, "k6_shi_tomasi", _ARGTYPES)
    n_lanes = frame.shape[0] if lanes else 1
    prm = _K6Params(H=H, W=W, B=boxsize, region_w=rw, region_h=rh,
                    cluster=cluster_size(n_lanes, _build.n_sms(dev)), band_rows=rows)
    err = fn(frame.data_ptr(), ustart.data_ptr(), vstart.data_ptr(), ufinish.data_ptr(),
             vfinish.data_ptr(), ubest.data_ptr(), vbest.data_ptr(), evbest.data_ptr(),
             n_lanes, ctypes.byref(prm),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K6 shi_tomasi")
    _build.launches[NAME] += 1
    return ubest, vbest, evbest


def bytes_and_flops(boxsize: int, region_w: int, region_h: int) -> tuple[int, int]:
    """Least bytes (the window read once, the bounds in, three results out)
    and operations of one K6 call: the gradients and their three products,
    the three box sums taken separably as running sums (B - 1 adds to start
    a column or a row of cells, then an add and a subtract a step: fewer
    than 2(B - 1) adds a cell) and ~12 operations of the eigenvalue."""
    off = 1 + (boxsize - 1) // 2
    nbytes = (region_h + 2 * off) * (region_w + 2 * off) + 4 * 4 + 3 * 4
    gw = region_w + boxsize - 1
    g = (region_h + boxsize - 1) * gw
    column_sums = 3 * gw * (boxsize - 1 + 2 * (region_h - 1))
    row_sums = 3 * region_h * (boxsize - 1 + 2 * (region_w - 1))
    flops = 2 * g + 3 * g + column_sums + row_sums + 12 * region_h * region_w
    return nbytes, flops
